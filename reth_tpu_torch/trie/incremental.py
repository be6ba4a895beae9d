"""Incremental state root over the database — walker + prefix sets.

A copy of the JAX package's ``trie/incremental.py``, on the port's
committers: ``IncrementalStateRoot``, ``full_state_root`` and
``verify_state_root`` build ``TrieCommitter(device=device)`` when given no
committer (kernel 1 through ``KeccakDevice`` on the card by default), and
``full_state_root_turbo`` runs ``TurboCommitter(backend, device=device)``
(kernels 2 and 3 on the card by default). The same results as the
reference's, reached with less host work: a collapsed trie reveals every
collapsed boundary of one structure pass before its retry (the reference
reveals one a retry and gives up after ``MAX_REVEAL_RETRIES``), and
``_dedup_ranges`` looks prefixes up instead of comparing pairs.

Reference analogue: `DatabaseStateRoot::incremental_root_with_updates`
(crates/trie/db/src/state.rs:64), `TrieWalker` skipping unchanged subtries
via `PrefixSet` + stored branch nodes (crates/trie/trie/src/walker.rs:18,
crates/trie/common/src/prefix_set.rs). TPU-first reshaping: instead of a
streaming walk feeding a HashBuilder stack, the walker only *plans* —
splitting each trie into opaque boundaries (unchanged subtree hashes read
from stored branch nodes) and dirty leaf ranges (scanned from the hashed
tables) — then the level-batched committer rebuilds and hashes all dirty
regions of all tries in O(depth) device dispatches.

Storage-root invariant: ``HashedAccounts`` values carry the CURRENT
storage root (this module updates them before committing the account
trie), so account leaves are literal table values — a deliberate departure
from the reference, which recomputes storage roots inside the account walk.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import numpy as np
import torch

from ..primitives.nibbles import Nibbles, unpack_nibbles
from ..primitives.rlp import rlp_encode, encode_int
from ..primitives.types import EMPTY_ROOT_HASH
from ..storage import tables as T
from ..storage.provider import DatabaseProvider
from ..storage.tables import Tables
from .committer import BoundaryCollapse, TrieCommitter
from .turbo import TurboCommitter


def nibbles_range(path: Nibbles) -> tuple[bytes, bytes | None]:
    """32-byte key range [start, end) covered by a nibble-path prefix.

    ``end`` is None when the range extends to the end of the keyspace.
    """
    start_nibs = path + b"\x00" * (64 - len(path))
    start = bytes(
        (start_nibs[i] << 4) | start_nibs[i + 1] for i in range(0, 64, 2)
    )
    # end = increment of path|ffff...: equivalently increment path as number
    v = int.from_bytes(start, "big") + (1 << (4 * (64 - len(path))))
    if v >= 1 << 256:
        return start, None
    return start, v.to_bytes(32, "big")


class PrefixSet:
    """Sorted changed-key paths with subtree-containment queries.

    Reference analogue: `PrefixSet` (crates/trie/common/src/prefix_set.rs)
    — `contains(prefix)` answers "does any changed key live under this
    subtree?" via binary search over the sorted key list.
    """

    def __init__(self, keys: set[Nibbles] | list[Nibbles]):
        self._keys = sorted(set(keys))

    def __len__(self):
        return len(self._keys)

    def contains_children_of(self, prefix: Nibbles) -> bool:
        i = bisect.bisect_left(self._keys, prefix)
        return i < len(self._keys) and self._keys[i][: len(prefix)] == prefix


@dataclass
class SubtriePlan:
    """The walker's output for one trie: how to rebuild it.

    ``boundaries`` values are ``(subtree_hash, has_branch)`` tuples: the
    32-byte unchanged-subtree hash plus whether that subtree contains
    stored branch nodes (drives the rebuilt parent's exact ``tree_mask``;
    ``commit_many`` also accepts bare hashes, conservatively treated as
    branch-containing)."""

    boundaries: dict[Nibbles, tuple[bytes, bool]] = field(default_factory=dict)
    dirty_ranges: list[Nibbles] = field(default_factory=list)
    touched_branch_paths: list[Nibbles] = field(default_factory=list)


def plan_subtrie(get_branch, prefix_set: PrefixSet) -> SubtriePlan:
    """Walk stored branch nodes, splitting into boundaries + dirty ranges."""
    plan = SubtriePlan()
    stack: list[Nibbles] = [b""]
    while stack:
        path = stack.pop()
        stored = get_branch(path)
        if stored is None:
            # no stored structure here: rebuild the whole subtree from leaves
            plan.dirty_ranges.append(path)
            continue
        plan.touched_branch_paths.append(path)
        for nib in range(16):
            child = path + bytes([nib])
            child_exists = (stored.state_mask >> nib) & 1
            if prefix_set.contains_children_of(child):
                stack.append(child)
            elif child_exists:
                h = stored.child_hash(nib)
                if h is not None:
                    # carry the stored tree_mask bit so the rebuilt parent's
                    # tree_mask stays EXACT (a bare hash would be treated as
                    # branch-containing, conservatively over-setting bits —
                    # the sparse-trie export computes exact bits, and the two
                    # paths must produce byte-identical stored nodes)
                    plan.boundaries[child] = (
                        h, bool((stored.tree_mask >> nib) & 1))
                else:
                    # inline child (small subtree): cheap re-scan
                    plan.dirty_ranges.append(child)
            # else: no child, no changes — nothing there
    return plan


def reveal_boundary(plan: SubtriePlan, path: Nibbles) -> None:
    """Convert collapsed boundaries under ``path`` into dirty leaf ranges."""
    dropped = [p for p in plan.boundaries if p[: len(path)] == path or path[: len(p)] == p]
    if not dropped:
        raise AssertionError(f"collapse at {path.hex()} but no boundary covers it")
    for p in dropped:
        del plan.boundaries[p]
        plan.dirty_ranges.append(p)


class IncrementalStateRoot:
    """Computes the post-change state root + trie updates from the DB.

    Inputs are CHANGED hashed keys (post-image already written to
    HashedAccounts/HashedStorages by the hashing stages); `wiped` marks
    accounts whose storage was destroyed entirely (selfdestruct).
    """

    MAX_REVEAL_RETRIES = 64

    def __init__(self, provider: DatabaseProvider, committer: TrieCommitter | None = None,
                 device: str | torch.device = "cuda"):
        self.provider = provider
        self.committer = committer or TrieCommitter(device=device)

    # -- leaf scans ----------------------------------------------------------

    def _scan_account_leaves(self, ranges: list[Nibbles]) -> list[tuple[Nibbles, bytes]]:
        leaves = []
        cur = self.provider.tx.cursor(Tables.HashedAccounts.name)
        for r in _dedup_ranges(ranges):
            start, end = nibbles_range(r)
            it = cur.walk(start) if end is None else cur.walk_range(start, end)
            for key, value in it:
                leaves.append((unpack_nibbles(key), value))
        return leaves

    def _scan_storage_leaves(
        self, hashed_addr: bytes, ranges: list[Nibbles]
    ) -> list[tuple[Nibbles, bytes]]:
        leaves = []
        cur = self.provider.tx.cursor(Tables.HashedStorages.name)
        for r in _dedup_ranges(ranges):
            start, end = nibbles_range(r)
            for _, dup in cur.walk_dup(hashed_addr, start):
                slot, value = T.decode_storage_entry(dup)
                if end is not None and slot >= end:
                    break
                leaves.append((unpack_nibbles(slot), rlp_encode(encode_int(value))))
        return leaves

    # -- storage tries -------------------------------------------------------

    def _plan_storage(self, hashed_addr: bytes, changed_slots, wiped: bool) -> SubtriePlan | None:
        if wiped:
            plan = SubtriePlan()
            plan.dirty_ranges.append(b"")
            return plan
        prefix_set = PrefixSet([unpack_nibbles(s) for s in changed_slots])
        return plan_subtrie(
            lambda p: self.provider.storage_branch(hashed_addr, p), prefix_set
        )

    def _commit_with_reveals(self, jobs, scanners):
        """commit_many with per-trie boundary-collapse reveal retries.

        ``jobs``: list of SubtriePlan; ``scanners``: per-trie leaf scanner
        called with the dirty ranges. Returns list of TrieBuildResult. A
        trie that collapses reveals every collapsed boundary found by one
        structure pass (``TrieCommitter.collapses``) before its retry, so
        the results are the reference's, reached in two passes where the
        reference takes one a collapse (and gives up after
        ``MAX_REVEAL_RETRIES``).
        """
        results = [None] * len(jobs)
        pending = list(range(len(jobs)))
        for _ in range(self.MAX_REVEAL_RETRIES):
            batch = []
            for i in pending:
                plan = jobs[i]
                leaves = scanners[i](plan.dirty_ranges)
                batch.append((leaves, dict(plan.boundaries)))
            try:
                out = self.committer.commit_many(batch)
            except BoundaryCollapse:
                # retry one-by-one so the failing trie is isolated
                out = []
                still = []
                for (leaves, bounds), i in zip(batch, list(pending)):
                    try:
                        out.append(self.committer.commit_many([(leaves, bounds)])[0])
                    except BoundaryCollapse as c:
                        # every collapse of this trie at once: a reveal
                        # leaves the others as they were (the reference
                        # reveals one a retry, and stops after 64)
                        for path in self.committer.collapses(leaves, bounds) or [c.path]:
                            reveal_boundary(jobs[i], path)
                        out.append(None)
                        still.append(i)
                for i, r in zip(pending, out):
                    if r is not None:
                        results[i] = r
                pending = still
                if not pending:
                    break
                continue
            for i, r in zip(pending, out):
                results[i] = r
            pending = []
            break
        if pending:
            raise RuntimeError("boundary reveal did not converge")
        return results

    # -- main ----------------------------------------------------------------

    def compute(
        self,
        changed_accounts: set[bytes],
        changed_storages: dict[bytes, set[bytes]] | None = None,
        wiped_storages: set[bytes] | None = None,
        write_updates: bool = True,
    ) -> bytes:
        """Incremental root from changed hashed keys; writes trie updates.

        ``changed_accounts``: hashed addresses whose account record changed.
        ``changed_storages``: hashed address → changed hashed slots.
        ``wiped_storages``: hashed addresses whose storage was cleared.
        """
        p = self.provider
        changed_storages = dict(changed_storages or {})  # caller's dict untouched
        wiped_storages = wiped_storages or set()
        for a in wiped_storages:
            changed_storages.setdefault(a, set())

        # 1. storage roots for accounts with storage changes
        storage_addrs = list(changed_storages.keys())
        plans: list[SubtriePlan] = []
        for addr in storage_addrs:
            plans.append(
                self._plan_storage(addr, changed_storages[addr], addr in wiped_storages)
            )
        scanners = [
            (lambda ranges, a=addr: self._scan_storage_leaves(a, ranges))
            for addr in storage_addrs
        ]
        storage_results = self._commit_with_reveals(plans, scanners)

        # apply storage trie updates + HashedAccounts storage_root invariant
        account_prefix_paths = {unpack_nibbles(a) for a in changed_accounts}
        for addr, plan, res in zip(storage_addrs, plans, storage_results):
            if write_updates:
                self._apply_storage_updates(addr, plan, res)
            acct = p.hashed_account(addr)
            if acct is not None:
                if acct.storage_root != res.root:
                    p.put_hashed_account(addr, acct.with_(storage_root=res.root), preserve_storage_root=False)
            account_prefix_paths.add(unpack_nibbles(addr))

        # 2. account trie
        prefix_set = PrefixSet(account_prefix_paths)
        if not prefix_set._keys:
            # nothing changed at all: current root from stored structure
            return self._current_account_root()
        plan = plan_subtrie(p.account_branch, prefix_set)
        result = self._commit_with_reveals([plan], [self._scan_account_leaves])[0]
        if write_updates:
            self._apply_account_updates(plan, result)
        return result.root

    def _current_account_root(self) -> bytes:
        """Root with no changes: reconstruct from stored structure (or scan)."""
        if self.provider.account_branch(b"") is None:
            plan = SubtriePlan()
            plan.dirty_ranges.append(b"")
        else:
            plan = plan_subtrie(self.provider.account_branch, PrefixSet([]))
        res = self._commit_with_reveals([plan], [self._scan_account_leaves])[0]
        return res.root

    # -- update application --------------------------------------------------

    def _apply_account_updates(self, plan: SubtriePlan, result) -> None:
        p = self.provider
        for path in plan.touched_branch_paths:
            if path not in result.branch_nodes:
                p.delete_account_branch(path)
        for r in _dedup_ranges(plan.dirty_ranges):
            p.delete_account_branches_with_prefix(r)
        for path, node in result.branch_nodes.items():
            p.put_account_branch(path, node)

    def _apply_storage_updates(self, hashed_addr: bytes, plan: SubtriePlan, result) -> None:
        p = self.provider
        for path in plan.touched_branch_paths:
            if path not in result.branch_nodes:
                p.delete_storage_branch(hashed_addr, path)
        for r in _dedup_ranges(plan.dirty_ranges):
            p.delete_storage_branches_with_prefix(hashed_addr, r)
        for path, node in result.branch_nodes.items():
            p.put_storage_branch(hashed_addr, path, node)


def full_state_root(
    provider: DatabaseProvider, committer: TrieCommitter | None = None,
    device: str | torch.device = "cuda",
) -> bytes:
    """Full rebuild from the hashed tables (MerkleStage clean path).

    Reference analogue: `StateRoot::root_with_progress` after clearing the
    trie tables (crates/stages/stages/src/stages/merkle.rs:184-330). All
    storage tries commit in one shared-level batch, then the account trie.
    """
    committer = committer or TrieCommitter(device=device)
    p = provider
    p.clear_trie_tables()

    # storage roots for every account with storage, one batched commit
    addrs, jobs = _scan_all_storage_jobs(p)
    results = committer.commit_many(_nibble_jobs(jobs))
    for addr, res in zip(addrs, results):
        for path, node in res.branch_nodes.items():
            p.put_storage_branch(addr, path, node)
        acct = p.hashed_account(addr)
        if acct is not None and acct.storage_root != res.root:
            p.put_hashed_account(addr, acct.with_(storage_root=res.root), preserve_storage_root=False)

    # normalise: accounts with NO storage entries must carry EMPTY_ROOT_HASH
    with_storage = set(addrs)
    stale = []
    for k, v in p.tx.cursor(Tables.HashedAccounts.name).walk():
        if k not in with_storage:
            acct = T.decode_account(v)
            if acct.storage_root != EMPTY_ROOT_HASH:
                stale.append((k, acct))
    for k, acct in stale:
        p.put_hashed_account(k, acct.with_(storage_root=EMPTY_ROOT_HASH), preserve_storage_root=False)

    # account trie from all hashed accounts
    leaves = [
        (unpack_nibbles(k), v)
        for k, v in p.tx.cursor(Tables.HashedAccounts.name).walk()
    ]
    result = committer.commit(leaves)
    for path, node in result.branch_nodes.items():
        p.put_account_branch(path, node)
    return result.root


def full_state_root_turbo(provider: DatabaseProvider, backend: str = "device",
                          supervisor=None, hash_service=None,
                          mesh=None, device: str | torch.device = "cuda") -> bytes:
    """Full rebuild on the turbo path: C++ structure sweep + packed/bitmap
    device levels (trie/turbo.py) — zero per-node Python. Same semantics as
    :func:`full_state_root`; raises ``ValueError`` for inputs outside the
    secure-trie fast path (the MerkleStage falls back to the general
    committer). ``backend="auto"`` + ``supervisor`` route the device work
    through the watchdog/breaker (ops/supervisor.py). Reference analogue:
    the clean MerkleStage path
    (crates/stages/stages/src/stages/merkle.rs:184-330). ``device`` is the
    device backends' card (``"cpu"`` runs the kernels' plain versions);
    ``mesh``, a ``parallel.HashMesh``, shards the rebuild's level loop over
    its members (``TurboCommitter(mesh=)``, the mesh engines of
    ops/fused_commit.py)."""
    committer = TurboCommitter(backend=backend, supervisor=supervisor,
                               hash_service=hash_service, mesh=mesh, device=device)
    p = provider
    p.clear_trie_tables()

    addrs, jobs = _scan_all_storage_jobs(p)
    turbo_jobs = []
    for pairs in jobs:
        keys = (
            np.frombuffer(b"".join(s for s, _ in pairs), dtype=np.uint8).reshape(-1, 32)
            if pairs else np.zeros((0, 32), dtype=np.uint8)
        )
        turbo_jobs.append((keys, [v for _, v in pairs]))
    # storage tries ride the overlapped pipeline: pooled native sweeps +
    # cross-subtrie level packing (trie/turbo.RebuildPipeline); the single
    # account-trie job below stays on the serial fast path
    results = committer.commit_hashed_pipelined(turbo_jobs, collect_branches=True)
    for addr, res in zip(addrs, results):
        for path, node in res.branch_nodes.items():
            p.put_storage_branch(addr, path, node)
        acct = p.hashed_account(addr)
        if acct is not None and acct.storage_root != res.root:
            p.put_hashed_account(addr, acct.with_(storage_root=res.root),
                                 preserve_storage_root=False)

    with_storage = set(addrs)
    stale = []
    for k, v in p.tx.cursor(Tables.HashedAccounts.name).walk():
        if k not in with_storage:
            acct = T.decode_account(v)
            if acct.storage_root != EMPTY_ROOT_HASH:
                stale.append((k, acct))
    for k, acct in stale:
        p.put_hashed_account(k, acct.with_(storage_root=EMPTY_ROOT_HASH),
                             preserve_storage_root=False)

    akeys, avals = [], []
    for k, v in p.tx.cursor(Tables.HashedAccounts.name).walk():
        akeys.append(k)
        avals.append(v)
    keys_np = (
        np.frombuffer(b"".join(akeys), dtype=np.uint8).reshape(-1, 32)
        if akeys else np.zeros((0, 32), dtype=np.uint8)
    )
    result = committer.commit_hashed_many([(keys_np, avals)], collect_branches=True)[0]
    for path, node in result.branch_nodes.items():
        p.put_account_branch(path, node)
    return result.root


def _scan_all_storage_jobs(p: DatabaseProvider):
    """(addrs, per-addr raw (hashed-slot, value-RLP) lists) over the whole
    HashedStorages table — shared by the full rebuild (both committers) and
    the verifier so the scans can't drift."""
    cur = p.tx.cursor(Tables.HashedStorages.name)
    addrs: list[bytes] = []
    entry = cur.first()
    while entry is not None:
        addrs.append(entry[0])
        entry = cur.next_no_dup()
    jobs = []
    for addr in addrs:
        pairs = []
        for _, dup in p.tx.cursor(Tables.HashedStorages.name).walk_dup(addr):
            slot, value = T.decode_storage_entry(dup)
            pairs.append((slot, rlp_encode(encode_int(value))))
        jobs.append(pairs)
    return addrs, jobs


def _nibble_jobs(jobs):
    """Raw (slot, value) scan output -> the general committer's leaf jobs."""
    return [
        ([(unpack_nibbles(slot), v) for slot, v in pairs], None) for pairs in jobs
    ]


def verify_state_root(
    provider: DatabaseProvider, committer: TrieCommitter | None = None,
    device: str | torch.device = "cuda",
) -> tuple[bytes, list[str]]:
    """READ-ONLY full verification from the hashed leaf tables.

    Reference analogue: the trie `verify` iterator behind
    `reth db repair-trie`. Rebuilds every storage trie and the account
    trie from leaves and cross-checks EVERYTHING incremental computation
    later trusts: the cached ``storage_root`` field of each HashedAccounts
    value and every stored branch node (missing/extra/divergent). Returns
    ``(recomputed_root, problems)``; writes nothing.
    """
    committer = committer or TrieCommitter(device=device)
    p = provider
    problems: list[str] = []
    addrs, jobs = _scan_all_storage_jobs(p)
    results = committer.commit_many(_nibble_jobs(jobs), collect_branches=True)
    storage_roots = dict(zip(addrs, (r.root for r in results)))

    # stored storage-trie branch nodes vs recomputed
    for addr, res in zip(addrs, results):
        stored: dict[bytes, object] = {}
        for _, dup in p.tx.cursor(Tables.StoragesTrie.name).walk_dup(addr):
            path, node = T.decode_storage_trie_entry(dup)
            stored[path] = node
        _diff_branches(problems, f"storage trie {addr.hex()[:8]}", stored,
                       res.branch_nodes)

    account_leaves = []
    for k, v in p.tx.cursor(Tables.HashedAccounts.name).walk():
        acct = T.decode_account(v)
        want_sroot = storage_roots.get(k, EMPTY_ROOT_HASH)
        if acct.storage_root != want_sroot:
            problems.append(
                f"account {k.hex()[:8]}: cached storage_root "
                f"{acct.storage_root.hex()[:8]} != recomputed {want_sroot.hex()[:8]}"
            )
        account_leaves.append(
            (unpack_nibbles(k), T.encode_account(acct.with_(storage_root=want_sroot)))
        )
    result = committer.commit(account_leaves, collect_branches=True)
    stored_acct = {
        path: T.decode_branch_node(raw)
        for path, raw in p.tx.cursor(Tables.AccountsTrie.name).walk()
    }
    _diff_branches(problems, "account trie", stored_acct, result.branch_nodes)
    return result.root, problems


def _diff_branches(problems: list[str], what: str, stored: dict, recomputed: dict,
                   limit: int = 20) -> None:
    for path in recomputed:
        if len(problems) >= limit:
            return
        if path not in stored:
            problems.append(f"{what}: missing stored branch at {path.hex()}")
        elif stored[path] != recomputed[path]:
            problems.append(f"{what}: divergent branch at {path.hex()}")
    for path in stored:
        if len(problems) >= limit:
            return
        if path not in recomputed:
            problems.append(f"{what}: extra stored branch at {path.hex()}")


def _dedup_ranges(ranges: list[Nibbles]) -> list[Nibbles]:
    """Drop ranges fully covered by a shorter range in the list. The
    reference's output, found by looking each range's prefixes up among the
    kept ranges (at most 65 lengths) instead of comparing it with each kept
    range."""
    out: list[Nibbles] = []
    kept: set[Nibbles] = set()
    lengths: set[int] = set()
    for r in sorted(set(ranges), key=lambda x: (len(x), x)):
        if not any(r[:n] in kept for n in lengths):
            out.append(r)
            kept.add(r)
            lengths.add(len(r))
    return sorted(out)
