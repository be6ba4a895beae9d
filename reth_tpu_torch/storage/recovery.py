"""Startup recovery: reconcile, heal, and verify a crashed datadir.

A copy of the JAX package's ``storage/recovery.py`` on the port's modules,
with one keyword more and one departure:

- ``recover_on_startup(device="cuda")``: without a ``committer``, the stages
  that complete an interrupted unwind build theirs on ``device``
  (``default_stages(device=)``: kernel 1 on the card), and the head-root
  check rebuilds the tries on ``TrieCommitter(fused=True, device=device)``
  (the level kernels), so recovery runs on the card unless the caller asks
  for the CPU; the roots and branch nodes are the reference's either way;
- no catch-all swallows a kernel fault. Where the reference turns any
  exception of the unwind completion into a problem ("partial heal still
  helps") and any exception of the root check into "root verification
  crashed", the port re-raises a kernel fault (``ops/_build.is_kernel_fault``)
  and counts every other cause, by site, in ``report["fallbacks"]`` and in
  ``recovery_metrics``. ``_surface``'s telemetry catches stay: no kernel runs
  there.

Reference analogue: the storage-v2 startup invariants
(``rocksdb/invariants.rs`` → ``storage/settings.check_consistency``)
generalized into a full crash-recovery pass. The WAL (``storage/wal.py``)
already replayed surviving commit records and discarded any torn tail by the
time the node gets here; this module answers the remaining question — *is
what survived a consistent chain, and can we prove it before serving?*

Steps (all idempotent, all surfaced in one report):

1. **Image / manifest hygiene** — a quarantined pickle image
   (``MemDb.quarantined``) and WAL replay stats (records applied, torn
   bytes discarded, segments) flow into the report as ``degraded``
   markers.
2. **Static-file hygiene** — orphaned ``*.tmp`` jars from a crash
   before the atomic rename are deleted; every ``*.sf`` jar is verified
   against its own embedded sha256 AND against the digests pinned in
   the last checkpoint manifest; a mismatching jar is quarantined aside
   (the provider would otherwise serve bit rot as history).
3. **Checkpoint reconcile** — a canonical tip AHEAD of the ``Finish``
   stage checkpoint is the signature of an interrupted unwind (or a
   mid-pipeline crash): the unwind is *completed* through the stages'
   own unwind surgery and the orphaned canonical headers are dropped,
   exactly the direction ``check_consistency`` heals the split store.
4. **Head linkage walk** — parent-hash linkage of the recovered
   canonical chain is verified over the recent window; an inconsistent
   tip steps down to the highest linked block.
5. **Root verification** — the recovered head's state root is
   recomputed READ-ONLY through the committer
   (``trie/incremental.verify_state_root``) and compared bit-for-bit
   against the header before the node serves a byte.

Status: ``ok`` (nothing to do) | ``degraded`` (healed something —
quarantine, torn tail, completed unwind) | ``failed`` (the recovered
state is provably wrong or the durability promise was broken: root
mismatch, broken linkage that could not be healed, or mid-log WAL
corruption that dropped durably committed records). ``failed`` is
surfaced through ``recovery_status`` so a health engine can flip the node
to failing instead of serving a corrupt chain silently.
"""

from __future__ import annotations

import time
from pathlib import Path

import torch

from ..ops._build import is_kernel_fault
from .tables import Tables

# how far back the linkage walk re-checks parent hashes; deeper history
# was already verified by a previous boot or by sync itself
LINKAGE_WINDOW = 64

STATUS_LEVEL = {"ok": 0, "degraded": 1, "failed": 2}


def _worst(a: str, b: str) -> str:
    return a if STATUS_LEVEL[a] >= STATUS_LEVEL[b] else b


def recover_on_startup(factory, durability=None, committer=None,
                       static_dir: str | Path | None = None,
                       verify_root: bool = True,
                       device: str | torch.device = "cuda") -> dict:
    """Run the full recovery pass; returns the report dict (also pushed
    into ``recovery_*`` metrics and a ``storage::recovery`` event).
    Without a ``committer`` the unwind completion's stages build theirs on
    ``device`` and the root check runs on a fused committer there. A kernel fault raises out of the
    pass; ``report["fallbacks"]`` counts, by site, the other failures the
    reference's catch-alls absorb."""
    t0 = time.time()
    report: dict = {"status": "ok", "problems": [], "healed": [],
                    "quarantined": [], "replayed_records": 0,
                    "torn_bytes": 0, "root_verified": None,
                    "fallbacks": {}}

    # 1. WAL replay stats + quarantined images
    if durability is not None:
        rep = durability.replay_report()
        report["replayed_records"] = rep["records"]
        report["torn_bytes"] = rep["torn_bytes"]
        report["accepted_torn"] = rep["accepted_torn"]
        report["manifest_head"] = rep["manifest_head"]
        if rep["torn_bytes"]:
            report["status"] = _worst(report["status"], "degraded")
            report["healed"].append(
                f"discarded {rep['torn_bytes']} torn WAL tail bytes")
        if rep.get("lost_segments"):
            # mid-log corruption: the WAL quarantined whole segments of
            # durably committed records it could not apply in order —
            # this is a broken durability promise, not a healed crash
            # tail, so it escalates past "degraded" even though the
            # surviving prefix is self-consistent and its root verifies
            report["status"] = "failed"
            report["quarantined"].extend(rep["lost_segments"])
            report["problems"].append(
                f"mid-log WAL corruption: {len(rep['lost_segments'])} "
                f"segment(s) quarantined, durably committed records lost")
        for store in durability.stores:
            q = getattr(store.db, "quarantined", None)
            if q is not None:
                report["status"] = _worst(report["status"], "degraded")
                report["quarantined"].append(str(q))
    else:
        q = getattr(getattr(factory, "db", None), "quarantined", None)
        if q is not None:
            report["status"] = _worst(report["status"], "degraded")
            report["quarantined"].append(str(q))

    # 2. static-file hygiene
    manifest_jars = {}
    if durability is not None:
        m = durability.main.manifest() or {}
        manifest_jars = m.get("jars") or {}
    if static_dir is not None:
        _reconcile_jars(Path(static_dir), manifest_jars, report)

    # 3 + 4. checkpoint reconcile + linkage walk (one RW provider)
    _reconcile_chain(factory, committer, report, device)

    # 5. recovered head root recomputed through the committer
    if verify_root:
        _verify_head_root(factory, committer, report, device)

    report["wall_s"] = round(time.time() - t0, 3)
    _surface(report)
    return report


def _reconcile_jars(static_dir: Path, manifest_jars: dict, report: dict):
    if not static_dir.is_dir():
        return
    from .wal import jar_digest

    for tmp in sorted(static_dir.glob("*.tmp")):
        # a crash before the atomic rename: the producer's source rows
        # were never pruned (same transaction), so the half-written jar
        # is pure garbage — drop it and let the producer re-run
        tmp.unlink()
        report["status"] = _worst(report["status"], "degraded")
        report["healed"].append(f"removed orphan jar tmp {tmp.name}")
    for jar in sorted(static_dir.glob("*.sf")):
        digest = jar_digest(jar)
        pinned = manifest_jars.get(jar.name)
        bad = digest is None or (pinned is not None and digest != pinned)
        if not bad:
            # header digest matches the manifest (or is unpinned —
            # written after the last checkpoint); verify content bytes
            from .nippyjar import NippyJar

            try:
                j = NippyJar.open(jar)
                bad = not j.verify()
                j.close()
            except Exception:  # noqa: BLE001 - unreadable jar is bad
                bad = True
        if bad:
            dest = jar.with_suffix(jar.suffix + ".corrupt")
            k = 0
            while dest.exists():
                k += 1
                dest = jar.with_suffix(jar.suffix + f".corrupt-{k}")
            jar.replace(dest)
            report["status"] = _worst(report["status"], "degraded")
            report["quarantined"].append(str(dest))
            report["problems"].append(
                f"static-file jar {jar.name} failed digest verification")


# the stage checkpoints the engine's persistence path keeps in lockstep
# (engine/tree.py _advance_persistence saves all of them to the same top)
ENGINE_STAGES = (
    "SenderRecovery", "Execution", "AccountHashing", "StorageHashing",
    "MerkleExecute", "TransactionLookup", "IndexStorageHistory",
    "IndexAccountHistory", "Finish",
)

# durable unwind intent (engine/tree.py _unwind_persisted_to): written
# before the first per-stage unwind commit, cleared atomically with the
# canonical-header surgery — its presence at boot means a crash landed
# somewhere inside an unwind and names the exact target to finish at
UNWIND_MARKER_KEY = b"unwind_in_progress"


def _fallback(report: dict, site: str) -> None:
    """Count one catch-all that absorbed a failure that is no kernel fault."""
    report["fallbacks"][site] = report["fallbacks"].get(site, 0) + 1
    try:
        from ..metrics import recovery_metrics

        recovery_metrics.record_fallback(site)
    except Exception:  # noqa: BLE001 - telemetry never gates startup
        pass


def _complete_unwind(factory, committer, target: int, report: dict,
                     reason: str, device):
    try:
        from ..stages import Pipeline, default_stages

        Pipeline(factory, default_stages(committer=committer,
                                         device=device)).unwind(target)
    except Exception as e:  # noqa: BLE001 - partial heal still helps
        if is_kernel_fault(e):
            raise
        _fallback(report, "unwind")
        report["problems"].append(f"unwind completion failed: {e}")
    _drop_canonical_above(factory, target)
    with factory.provider_rw() as p:
        p.tx.delete(Tables.Metadata.name, UNWIND_MARKER_KEY)
    report["status"] = _worst(report["status"], "degraded")
    report["healed"].append(reason)


def _reconcile_chain(factory, committer, report: dict, device):
    with factory.provider() as p:
        tip = p.last_block_number()
        cps = {s: p.stage_checkpoint(s) for s in ENGINE_STAGES}
        raw_marker = p.tx.get(Tables.Metadata.name, UNWIND_MARKER_KEY)
    marker = int.from_bytes(raw_marker[:8], "big") if raw_marker else None
    if marker is not None and marker < tip:
        # crash mid-unwind: the marker names the target; the per-stage
        # unwind commits are idempotent, so finish the whole job
        _complete_unwind(factory, committer, marker, report,
                         f"completed interrupted unwind {tip} -> {marker}",
                         device)
        tip = marker
        with factory.provider() as p:
            cps = {s: p.stage_checkpoint(s) for s in ENGINE_STAGES}
    elif marker is not None:
        # marker without header surgery pending (crash after the unwind
        # finished semantically, e.g. before the same-commit delete ran
        # on an unwind-to-tip): just clear it
        with factory.provider_rw() as p:
            p.tx.delete(Tables.Metadata.name, UNWIND_MARKER_KEY)
    finish = cps["Finish"]
    report["stages_uniform"] = len(set(cps.values())) == 1
    if finish < tip:
        if report["stages_uniform"]:
            # every stage uniformly below the canonical tip: an
            # interrupted unwind whose marker was already cleared (or a
            # pre-marker datadir) — complete the canonical surgery
            _complete_unwind(factory, committer, finish, report,
                             f"completed interrupted unwind {tip} -> {finish}",
                             device)
            tip = finish
        else:
            # ragged checkpoints below the tip with NO unwind marker: a
            # mid-sync / mid-import restart — the pipeline owns that
            # progress, recovery must not destroy it; root verification
            # is skipped because the state tables legitimately lag the
            # header chain
            report["status"] = _worst(report["status"], "degraded")
            report["problems"].append(
                f"stage checkpoints behind canonical tip ({cps['Finish']} "
                f"< {tip}, ragged): resuming pipeline sync, state not "
                f"verifiable at tip")
    # linkage walk over the recent window
    with factory.provider() as p:
        consistent = _highest_linked(p, tip)
    if consistent < tip:
        _drop_canonical_above(factory, consistent)
        report["status"] = _worst(report["status"], "degraded")
        report["problems"].append(
            f"canonical linkage broken above {consistent} (tip was {tip})")
        report["healed"].append(f"truncated head {tip} -> {consistent}")
        tip = consistent
    with factory.provider() as p:
        report["head_number"] = tip
        h = p.canonical_hash(tip)
        report["head_hash"] = h.hex() if h else None


def _highest_linked(p, tip: int) -> int:
    """Highest block whose recent parent linkage holds."""
    while tip > 0:
        header = p.header_by_number(tip)
        h = p.canonical_hash(tip)
        if header is None or h is None or header.hash != h:
            tip -= 1
            continue
        ok = True
        n = tip
        child = header
        while n > max(0, tip - LINKAGE_WINDOW):
            parent = p.header_by_number(n - 1)
            if parent is None or parent.hash != child.parent_hash:
                ok = False
                break
            child = parent
            n -= 1
        if ok:
            return tip
        tip -= 1
    return 0


def _drop_canonical_above(factory, number: int):
    from .tables import be64

    with factory.provider_rw() as p:
        old_tip = p.last_block_number()
        for n in range(number + 1, old_tip + 1):
            bh = p.canonical_hash(n)
            p.tx.delete(Tables.CanonicalHeaders.name, be64(n))
            p.tx.delete(Tables.Headers.name, be64(n))
            if bh:
                p.tx.delete(Tables.HeaderNumbers.name, bh)


def _verify_head_root(factory, committer, report: dict, device):
    from ..trie.committer import TrieCommitter
    from ..trie.incremental import verify_state_root

    tip = report.get("head_number")
    if not tip or not report.get("stages_uniform", True):
        # genesis/empty store, or state tables legitimately mid-sync:
        # nothing provable at the tip
        report["root_verified"] = None
        return
    with factory.provider() as p:
        header = p.header_by_number(tip)
        if header is None:
            report["status"] = "failed"
            report["problems"].append(f"no header at recovered tip {tip}")
            report["root_verified"] = False
            return
        try:
            root, problems = verify_state_root(
                p, committer or TrieCommitter(fused=True, device=device), device=device)
        except Exception as e:  # noqa: BLE001 - a verifier crash is a failure
            if is_kernel_fault(e):
                raise
            _fallback(report, "verify")
            report["status"] = "failed"
            report["problems"].append(f"root verification crashed: {e}")
            report["root_verified"] = False
            return
    if root != header.state_root or problems:
        report["status"] = "failed"
        report["root_verified"] = False
        report["problems"].append(
            f"state root mismatch at {tip}: recomputed {root.hex()} "
            f"header {header.state_root.hex()}")
        report["problems"].extend(problems[:5])
    else:
        report["root_verified"] = True


def _surface(report: dict):
    """Metrics + events: the recovery_* surface the health engine and
    the dashboard consume."""
    try:
        from ..metrics import recovery_metrics

        recovery_metrics.record(report)
    except Exception:  # noqa: BLE001 - telemetry never gates startup
        pass
    try:
        from .. import tracing

        tracing.event("storage::recovery", "startup_recovery",
                      status=report["status"],
                      head=report.get("head_number"),
                      replayed=report.get("replayed_records"),
                      torn_bytes=report.get("torn_bytes"),
                      quarantined=len(report.get("quarantined", ())),
                      problems=len(report.get("problems", ())))
        if report["status"] == "failed":
            tracing.fault_event("RECOVERY_FAILED", target="storage::recovery",
                                problems=report["problems"][:3])
    except Exception:  # noqa: BLE001
        pass
