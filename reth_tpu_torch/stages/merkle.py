"""MerkleStage: state root from hashed tables, validated against headers.

A copy of the JAX package's ``stages/merkle.py`` on the port's committers,
with two departures kept on purpose:

- **The card by default.** With no committer the stages build
  ``TrieCommitter(device=device)`` (kernel 1 through ``KeccakDevice``), and
  the rebuild's ``TurboCommitter`` takes the committer's ``turbo_backend``
  when it has one, else ``"device"`` on the committer's device (kernels 2
  and 3), never the numpy twin by default.
- **No fallback on a device fault.** The rebuild falls back to the general
  committer only on ``ValueError``, the sweep's rejection of an input it
  cannot build; each such fallback counts in ``MerkleStage.fallbacks``. A
  ``RuntimeError`` (a launch fault, a failed sync, a failed build, an
  injected pipeline abort) raises out of ``execute``.

Reference analogue: `MerkleStage`
(crates/stages/stages/src/stages/merkle.rs:80): full rebuild above
`rebuild_threshold` (clear trie tables, recompute everything — the
PRIMARY TPU benchmark target), incremental below it via changesets +
prefix sets. Root must match the target header's state root
(merkle.rs:343-358, INVALID_STATE_ROOT_ERROR_MESSAGE analogue).

Resumable rebuild (reference `MerkleCheckpoint`,
crates/stages/types/src/checkpoints.rs:11 + merkle.rs:265-295): large
rebuilds run CHUNKED — each pipeline iteration commits a bounded batch
(storage tries by hashed-address range, then the account trie as 256
two-nibble-prefix subtries via the turbo committer's ``start_depth``) and
persists a progress blob; a crash at any point resumes from the last
committed chunk. The final stitch commits the top two levels over the
subtrie roots as opaque boundaries.
"""

from __future__ import annotations

import numpy as np
import torch

from ..primitives.nibbles import unpack_nibbles
from ..primitives.rlp import encode_int, rlp_encode
from ..primitives.types import EMPTY_ROOT_HASH
from ..storage import tables as T
from ..storage.provider import DatabaseProvider
from ..storage.tables import Tables
from ..trie.committer import BoundaryCollapse, TrieCommitter
from ..trie.incremental import (
    IncrementalStateRoot,
    full_state_root,
    full_state_root_turbo,
)
from ..trie.turbo import TurboCommitter
from .api import ExecInput, ExecOutput, Stage, StageError, UnwindInput

INVALID_STATE_ROOT = (
    "state root mismatch — this is a bug in execution/trie code or corrupt input"
)

_EMPTY_PREFIX = b"\x00" * 32  # progress marker: prefix holds no accounts


class MerkleStage(Stage):
    id = "MerkleExecute"

    def __init__(self, committer: TrieCommitter | None = None,
                 rebuild_threshold: int = 50_000, chunk_leaves: int = 500_000,
                 device: str | torch.device = "cuda"):
        committer = committer or TrieCommitter(device=device)
        # rebuild lane: below live/payload — a sync-time rebuild coalesces
        # with but never delays the tip (no-op without a hash service)
        self.committer = (committer.for_lane("rebuild")
                          if hasattr(committer, "for_lane") else committer)
        self.rebuild_threshold = rebuild_threshold
        self.chunk_leaves = chunk_leaves
        # the rebuild's card: the committer's own, else ``device``
        self.device = getattr(self.committer, "device", None) or device
        self.fallbacks = 0  # rebuilds the sweep rejected (ValueError)
        self._turbo = None  # cached: keeps the digest arena resident

    def _turbo_kw(self) -> dict:
        """The rebuild's TurboCommitter arguments: the committer's
        ``turbo_backend`` (``"device"`` when it sets none) on the stage's
        card, with its supervisor and hash service."""
        return dict(backend=getattr(self.committer, "turbo_backend", None) or "device",
                    supervisor=getattr(self.committer, "supervisor", None),
                    hash_service=getattr(self.committer, "hash_service", None),
                    device=self.device)

    def _turbo_committer(self):
        """One TurboCommitter per stage instance, so the resident digest
        arena (trie/turbo.DigestArena) survives across rebuild chunks
        instead of re-allocating per prefix pass."""
        if self._turbo is None:
            self._turbo = TurboCommitter(**self._turbo_kw())
        return self._turbo

    def _commit_subtries(self, jobs, start_depth: int = 0):
        """Commit (keys, values) subtrie jobs through the OVERLAPPED rebuild
        pipeline (trie/turbo.RebuildPipeline): pooled native sweeps feed a
        bounded queue, same-depth levels from different subtries pack into
        fused dispatches against the resident digest arena. Falls back to
        the general committer when the fast path rejects the input (native
        build unavailable / oversized values — the same degradation the
        single-shot path documents). A committer carrying a supervisor
        ("auto" route) hands it down so every chunk's device dispatches
        stay watchdog-bounded, and a mid-rebuild device trip drains the
        pipeline's queue onto the numpy twin without losing the chunk. Only
        the sweep's ``ValueError`` falls back (counted in ``fallbacks``); a
        device fault or an injected pipeline abort raises."""
        try:
            turbo = self._turbo_committer()
            return turbo.commit_hashed_pipelined(jobs, collect_branches=True,
                                                 start_depth=start_depth)
        except ValueError:
            self.fallbacks += 1
            py_jobs = [
                ([(unpack_nibbles(k.tobytes())[start_depth:], v)
                  for k, v in zip(keys, vals)], None)
                for keys, vals in jobs
            ]
            return self.committer.commit_many(py_jobs, collect_branches=True)

    def _full_rebuild(self, provider: DatabaseProvider) -> bytes:
        """Single-shot clean path: turbo (C++ sweep + device levels) with
        fallback to the general committer when the sweep rejects the input
        (``ValueError``, e.g. oversized values; counted in ``fallbacks``)."""
        try:
            return full_state_root_turbo(provider, **self._turbo_kw())
        except ValueError:
            self.fallbacks += 1
            return full_state_root(provider, self.committer)

    def execute(self, provider: DatabaseProvider, inp: ExecInput) -> ExecOutput:
        in_progress = provider.stage_progress(self.id) is not None
        needs_rebuild = (
            inp.checkpoint == 0 or inp.target - inp.checkpoint > self.rebuild_threshold
        )
        if in_progress or needs_rebuild:
            total = (provider.tx.entry_count(Tables.HashedAccounts.name)
                     + provider.tx.entry_count(Tables.HashedStorages.name))
            if in_progress or total > self.chunk_leaves:
                root = self._chunked_step(provider, inp.target)
                if root is None:
                    # chunk committed (with its progress blob) by the
                    # pipeline loop; checkpoint moves only on completion
                    return ExecOutput(checkpoint=inp.checkpoint, done=False)
            else:
                root = self._full_rebuild(provider)
        else:
            root = self._incremental(provider, inp.next_block, inp.target)
        header = provider.header_by_number(inp.target)
        if header is None:
            raise StageError(f"missing header {inp.target}", block=inp.target)
        if root != header.state_root:
            raise StageError(
                f"{INVALID_STATE_ROOT}: got {root.hex()} want "
                f"{header.state_root.hex()} at block {inp.target}",
                block=inp.target,
            )
        return ExecOutput(checkpoint=inp.target)

    # -- chunked resumable rebuild ------------------------------------------

    def _chunked_step(self, p: DatabaseProvider, target: int) -> bytes | None:
        """One bounded, committable unit of the full rebuild. Returns the
        state root when the rebuild completes, else None (more chunks).
        The progress blob is BOUND to the target block (bytes 1..9): a
        resume against a different target would stitch chunks computed
        from different states, so stale progress restarts the rebuild
        (reference MerkleCheckpoint target semantics)."""
        blob = p.stage_progress(self.id)
        tb = target.to_bytes(8, "big")
        if blob is not None and blob[1:9] != tb:
            blob = None  # stale: rebuild was for an older sync target
        if blob is None:
            p.clear_trie_tables()
            p.save_stage_progress(self.id, b"S" + tb)
            return None
        if blob[:1] == b"S":
            return self._storage_chunk(p, tb, blob[9:])
        return self._account_chunk(p, tb, blob[9:])

    def _storage_chunk(self, p: DatabaseProvider, tb: bytes, last_addr: bytes) -> None:
        """Commit storage tries for the next batch of hashed addresses."""
        cur = p.tx.cursor(Tables.HashedStorages.name)
        entry = cur.seek((last_addr + b"\x00") if last_addr else b"")
        # seek lands inside last_addr's dups when extending; skip them
        while entry is not None and entry[0] <= last_addr:
            entry = cur.next_no_dup()
        addrs: list[bytes] = []
        jobs = []
        leaves = 0
        while entry is not None and leaves < self.chunk_leaves:
            addr = entry[0]
            pairs = []
            for _, dup in p.tx.cursor(Tables.HashedStorages.name).walk_dup(addr):
                slot, value = T.decode_storage_entry(dup)
                pairs.append((slot, rlp_encode(encode_int(value))))
            addrs.append(addr)
            keys = np.frombuffer(b"".join(s for s, _ in pairs), dtype=np.uint8).reshape(-1, 32)
            jobs.append((keys, [v for _, v in pairs]))
            leaves += len(pairs)
            entry = cur.next_no_dup()
        if not addrs:  # storage phase complete
            p.save_stage_progress(self.id, b"A" + tb)
            return None
        results = self._commit_subtries(jobs)
        for addr, res in zip(addrs, results):
            for path, node in res.branch_nodes.items():
                p.put_storage_branch(addr, path, node)
            acct = p.hashed_account(addr)
            if acct is not None and acct.storage_root != res.root:
                p.put_hashed_account(addr, acct.with_(storage_root=res.root),
                                     preserve_storage_root=False)
        p.save_stage_progress(self.id, b"S" + tb + addrs[-1])
        return None

    def _account_chunk(self, p: DatabaseProvider, tb: bytes,
                       done_blob: bytes) -> bytes | None:
        """Commit the next batch of 2-nibble-prefix account subtries, or the
        final stitch when all 256 are done."""
        # entry layout: prefix byte | has-branches flag | 32-byte root
        done = {done_blob[i]: (done_blob[i + 1], done_blob[i + 2 : i + 34])
                for i in range(0, len(done_blob), 34)}
        new_entries = bytearray()
        leaves = 0
        prefix = 0
        # gather every prefix subtrie of this chunk FIRST, then commit them
        # through ONE overlapped pipeline pass: pooled native sweeps overlap
        # hashing, and same-depth levels from different prefixes share fused
        # dispatches instead of 256 tiny per-prefix commits
        chunk_jobs: list[tuple[int, "np.ndarray", list[bytes]]] = []
        while prefix < 256 and leaves < self.chunk_leaves:
            if prefix in done:
                prefix += 1
                continue
            keys, vals = [], []
            for k, v in p.tx.cursor(Tables.HashedAccounts.name).walk(bytes([prefix])):
                if k[0] != prefix:
                    break
                # normalisation: accounts without storage carry EMPTY_ROOT
                acct = T.decode_account(v)
                if (acct.storage_root != EMPTY_ROOT_HASH
                        and next(iter(p.tx.cursor(Tables.HashedStorages.name)
                                      .walk_dup(k)), None) is None):
                    acct = acct.with_(storage_root=EMPTY_ROOT_HASH)
                    p.put_hashed_account(k, acct, preserve_storage_root=False)
                    v = T.encode_account(acct)
                keys.append(k)
                vals.append(v)
            if not keys:
                done[prefix] = (0, _EMPTY_PREFIX)
                new_entries += bytes([prefix, 0]) + _EMPTY_PREFIX
                prefix += 1
                continue
            keys_np = np.frombuffer(b"".join(keys), dtype=np.uint8).reshape(-1, 32)
            chunk_jobs.append((prefix, keys_np, vals))
            leaves += len(keys)
            prefix += 1
        if chunk_jobs:
            results = self._commit_subtries(
                [(keys_np, vals) for _, keys_np, vals in chunk_jobs],
                start_depth=2)
            for (pfx, _keys_np, _vals), res in zip(chunk_jobs, results):
                pfx_nibbles = bytes([pfx >> 4, pfx & 0xF])
                for path, node in res.branch_nodes.items():
                    p.put_account_branch(pfx_nibbles + path, node)
                # progress records whether the subtrie holds branch nodes
                # (the stitch needs it for the parents' tree_mask):
                # flag byte + root
                done[pfx] = (1 if res.branch_nodes else 0, res.root)
                new_entries += (bytes([pfx, 1 if res.branch_nodes else 0])
                                + res.root)
        if len(done) < 256:
            p.save_stage_progress(self.id, b"A" + tb + done_blob + bytes(new_entries))
            return None
        # final stitch: subtrie roots as opaque boundaries under the top
        # two levels; BoundaryCollapse reveals the offending prefix's
        # leaves and retries (single-populated-prefix shapes)
        boundaries = {
            bytes([pf >> 4, pf & 0xF]): (root, flag)
            for pf, (flag, root) in done.items() if root != _EMPTY_PREFIX
        }
        extra_leaves: list = []
        while True:
            try:
                result = self.committer.commit(extra_leaves, boundaries or None,
                                               collect_branches=True)
                break
            except BoundaryCollapse as bc:
                reveal = [pf for pf in list(boundaries)
                          if pf[: len(bc.path)] == bc.path[: len(pf)]]
                if not reveal:
                    raise
                for pf in reveal:
                    boundaries.pop(pf)
                    b0 = (pf[0] << 4) | pf[1]
                    for k, v in p.tx.cursor(Tables.HashedAccounts.name).walk(bytes([b0])):
                        if k[0] != b0:
                            break
                        extra_leaves.append((unpack_nibbles(k), v))
        for path, node in result.branch_nodes.items():
            p.put_account_branch(path, node)
        root = result.root if boundaries or extra_leaves else EMPTY_ROOT_HASH
        p.save_stage_progress(self.id, None)
        return root

    def _incremental(self, provider: DatabaseProvider, start: int, end: int,
                     unwinding: bool = False) -> bytes:
        account_changes = provider.account_changes_in_range(start, end)
        changed_storages_plain = provider.storage_changes_in_range(start, end)
        # hash all changed keys in one batch
        addrs = sorted(set(account_changes) | set(changed_storages_plain.keys()))
        slot_pairs = [
            (a, s) for a, slots in changed_storages_plain.items() for s in slots
        ]
        digests = self.committer.hasher(addrs + [s for _, s in slot_pairs])
        haddr = dict(zip(addrs, digests[: len(addrs)]))
        changed_hashed_accounts = {haddr[a] for a in account_changes}
        changed_hashed_storages: dict[bytes, set[bytes]] = {}
        for (a, _s), hs in zip(slot_pairs, digests[len(addrs) :]):
            changed_hashed_storages.setdefault(haddr[a], set()).add(hs)
        if unwinding:
            # post-unwind existence = changeset prev-image (plain state is
            # reverted AFTER this stage in unwind order)
            wiped = {
                haddr[a]
                for a in changed_storages_plain
                if account_changes.get(a, provider.account(a)) is None
            }
        else:
            wiped = {
                haddr[a] for a in changed_storages_plain if provider.account(a) is None
            }
        inc = IncrementalStateRoot(provider, self.committer)
        return inc.compute(changed_hashed_accounts, changed_hashed_storages, wiped)

    def unwind(self, provider: DatabaseProvider, inp: UnwindInput) -> None:
        # no-op: the recompute happens in MerkleUnwindStage, which sits
        # BEFORE the hashing stages in forward order so that on unwind it
        # runs AFTER they have reverted the hashed tables (the reference's
        # MerkleUnwind/MerkleExecute placeholder split, id.rs:46-58).
        return None


class MerkleUnwindStage(Stage):
    """Placeholder stage owning the unwind-side trie recompute."""

    id = "MerkleUnwind"

    def __init__(self, committer: TrieCommitter | None = None,
                 device: str | torch.device = "cuda"):
        self.committer = committer or TrieCommitter(device=device)

    def execute(self, provider: DatabaseProvider, inp: ExecInput) -> ExecOutput:
        return ExecOutput(checkpoint=inp.target)  # forward no-op

    def unwind(self, provider: DatabaseProvider, inp: UnwindInput) -> None:
        # a crash-interrupted rebuild's partial progress is void on reorg
        provider.save_stage_progress(MerkleStage.id, None)
        if inp.unwind_to == 0:
            provider.clear_trie_tables()
            return
        stage = MerkleStage(self.committer)
        root = stage._incremental(provider, inp.unwind_to + 1, inp.checkpoint, unwinding=True)
        header = provider.header_by_number(inp.unwind_to)
        if header is not None and root != header.state_root:
            raise StageError(
                f"unwind {INVALID_STATE_ROOT}: got {root.hex()} at block {inp.unwind_to}",
                block=inp.unwind_to,
            )
