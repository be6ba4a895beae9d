"""EIP-1186 proofs and multiproofs over the database.

A copy of the JAX package's ``trie/proof.py`` on the port's storage and
committers. A proof is an incremental commit with the targets as the prefix
set: ``plan_subtrie`` turns everything off the targets' spines into opaque
boundaries, ``TrieCommitter.commit_many(proof_targets=)`` rebuilds only the
spines, hashing each depth in one batch of its hasher (kernel 1 through
``KeccakDevice`` on the card, by default), and the spine nodes' RLPs are the
proof. A multiproof is many targets in one commit, the storage tries batched
beside the account trie. ``ProofCalculator`` builds ``TrieCommitter(device=
device)`` when given no committer: the card unless the caller passes
``device="cpu"``.

``ProofWorkerPool`` shards a multiproof by storage trie over worker threads,
each with its own calculator on its own read view. A slot's value is read
with ``Tx.seek_dup``, which lands where the reference's cursor
``seek_by_key_subkey`` does.

Reference analogue: `ProofCalculator` (crates/trie/trie/src/proof_v2/
mod.rs:47), `StateProofProvider::proof/multiproof`
(crates/storage/storage-api/src/trie.rs:147-159), serving `eth_getProof`
(crates/rpc/rpc-eth-api/src/helpers/state.rs:155); the worker pool is
reth's ``proof_task.rs``.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import torch

from ..primitives.keccak import keccak256
from ..primitives.nibbles import Nibbles, decode_path, unpack_nibbles
from ..primitives.rlp import encode_int, rlp_decode, rlp_encode
from ..primitives.types import EMPTY_ROOT_HASH, Account
from ..storage import tables as T
from ..storage.provider import DatabaseProvider
from .committer import TrieCommitter
from .incremental import IncrementalStateRoot, PrefixSet, plan_subtrie


@dataclass
class StorageProof:
    key: bytes
    value: int
    proof: list[bytes]


@dataclass
class AccountProof:
    address: bytes
    account: Account | None
    proof: list[bytes]
    storage_root: bytes = EMPTY_ROOT_HASH
    storage_proofs: list[StorageProof] = field(default_factory=list)


class ProofCalculator:
    def __init__(self, provider: DatabaseProvider, committer: TrieCommitter | None = None,
                 device: str | torch.device = "cuda"):
        self.provider = provider
        # proof work rides the LOWEST-priority hash-service lane: with a
        # service its (often tiny) batches coalesce with everyone else's but
        # never delay the live tip; without one this is the committer itself
        committer = committer or TrieCommitter(device=device)
        self.committer = (committer.for_lane("proof")
                          if hasattr(committer, "for_lane") else committer)
        self._inc = IncrementalStateRoot(provider, self.committer)

    def account_proof(self, address: bytes, slots: list[bytes] = ()) -> AccountProof:
        return self.multiproof({address: list(slots)})[address]

    def multiproof(self, targets: dict[bytes, list[bytes]]) -> dict[bytes, AccountProof]:
        """Batched proofs for many accounts (+ their storage slots)."""
        addresses = list(targets.keys())
        all_slots = [s for slots in targets.values() for s in slots]
        digests = self.committer.hasher(addresses + all_slots)
        haddr = dict(zip(addresses, digests[: len(addresses)]))
        hslot_iter = iter(digests[len(addresses):])
        hslots = {a: [next(hslot_iter) for _ in targets[a]] for a in addresses}

        # plan + commit: account trie spine first
        acct_paths = {a: unpack_nibbles(haddr[a]) for a in addresses}
        plan = plan_subtrie(
            self.provider.account_branch, PrefixSet(list(acct_paths.values()))
        )
        jobs = [(self._inc._scan_account_leaves(plan.dirty_ranges), dict(plan.boundaries))]
        proof_target_lists = [list(acct_paths.values())]
        # storage tries for accounts that exist and have storage
        storage_jobs_meta = []  # addresses, in the order of their jobs
        for a in addresses:
            if not targets[a]:
                continue
            splan = plan_subtrie(
                lambda p, _a=haddr[a]: self.provider.storage_branch(_a, p),
                PrefixSet([unpack_nibbles(hs) for hs in hslots[a]]),
            )
            jobs.append((
                self._inc._scan_storage_leaves(haddr[a], splan.dirty_ranges),
                dict(splan.boundaries),
            ))
            proof_target_lists.append([unpack_nibbles(hs) for hs in hslots[a]])
            storage_jobs_meta.append(a)
        results = self.committer.commit_many(
            jobs, collect_branches=False, proof_targets=proof_target_lists
        )

        acct_result = results[0]
        out: dict[bytes, AccountProof] = {}
        for a in addresses:
            spine = _spine_nodes(acct_result.proof_nodes, acct_paths[a])
            acc = self.provider.hashed_account(haddr[a])
            out[a] = AccountProof(
                address=a,
                account=acc,
                proof=spine,
                storage_root=acc.storage_root if acc else EMPTY_ROOT_HASH,
            )
        for a, res in zip(storage_jobs_meta, results[1:]):
            ap = out[a]
            for slot, hs in zip(targets[a], hslots[a]):
                value = self._storage_value(haddr[a], hs)
                ap.storage_proofs.append(StorageProof(
                    key=slot, value=value,
                    proof=_spine_nodes(res.proof_nodes, unpack_nibbles(hs)),
                ))
        return out

    def spine_for_path(self, path: Nibbles) -> list[bytes]:
        """Account-trie spine through an arbitrary nibble path (used to
        reveal a blinded node: the path is padded to a full key so the
        spine passes through the blinded node)."""
        return self._spine_for_path(
            self.provider.account_branch, self._inc._scan_account_leaves, path)

    def storage_spine_for_path(self, hashed_addr: bytes,
                               path: Nibbles) -> list[bytes]:
        """Storage-trie spine through an arbitrary nibble path."""
        return self._spine_for_path(
            lambda p: self.provider.storage_branch(hashed_addr, p),
            lambda ranges: self._inc._scan_storage_leaves(hashed_addr, ranges),
            path)

    def _spine_for_path(self, branch_fn, leaf_scan, path: Nibbles) -> list[bytes]:
        full = bytes(path) + b"\x00" * (64 - len(path))
        plan = plan_subtrie(branch_fn, PrefixSet([full]))
        res = self.committer.commit_many(
            [(leaf_scan(plan.dirty_ranges), dict(plan.boundaries))],
            collect_branches=False, proof_targets=[[full]],
        )[0]
        return _spine_nodes(res.proof_nodes, full)

    def _storage_value(self, hashed_addr: bytes, hashed_slot: bytes) -> int:
        entry = self.provider.tx.seek_dup(T.Tables.HashedStorages.name, hashed_addr,
                                          hashed_slot)
        if entry is not None and entry[:32] == hashed_slot:
            return T.decode_storage_entry(entry)[1]
        return 0


class ProofWorkerPool:
    """Sharded multiproof fetch (reth's ``proof_task.rs`` worker pool) over
    the batched committer's proof path.

    A multiproof over many accounts serializes on ONE ``plan_subtrie`` walk
    per storage trie plus the account-trie walk; each storage trie's walk is
    independent, so the pool shards ``targets`` by storage trie (and splits
    very large single-trie slot lists) across ``workers`` threads. Every
    worker thread builds its OWN ``ProofCalculator`` via ``calc_factory``:
    cursor state lives on the provider's transaction, so workers never
    share one.

    Used by the live-tip ``SparseRootTask`` (async ``submit``: reveals
    overlap execution and other fetches) and by large synchronous requests
    (:meth:`multiproof`).
    """

    SLOT_SPLIT_MIN = 64  # single-account slot lists split above this

    def __init__(self, calc_factory, workers: int | None = None,
                 injector=None):
        from .sparse import SparseFaultInjector, sparse_worker_count

        self.calc_factory = calc_factory
        self.workers = sparse_worker_count(workers)
        self.injector = (injector if injector is not None
                         else SparseFaultInjector.from_env())
        self._local = threading.local()
        self._pool: ThreadPoolExecutor | None = None
        self._pool_lock = threading.Lock()
        self._depth = 0  # outstanding shard fetches (metrics gauge)
        self.fetches = 0
        self.shards_total = 0

    def _executor(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.workers,
                    thread_name_prefix="proof-worker")
            return self._pool

    def shutdown(self) -> None:
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    def _calc(self) -> ProofCalculator:
        calc = getattr(self._local, "calc", None)
        if calc is None:
            calc = self._local.calc = self.calc_factory()
        return calc

    # -- sharding -------------------------------------------------------------

    def _shards(self, targets: dict) -> list[dict]:
        """Split ``targets`` by storage trie: one (account, slot-chunk)
        unit per trie, big slot lists chopped first, then LPT-balanced
        into at most ``workers`` shards by walk cost (1 + slots)."""
        units: list[tuple[bytes, list]] = []
        for a, slots in targets.items():
            slots = list(slots)
            if len(slots) > self.SLOT_SPLIT_MIN:
                step = -(-len(slots) // self.workers)
                step = max(step, self.SLOT_SPLIT_MIN)
                for off in range(0, len(slots), step):
                    units.append((a, slots[off:off + step]))
            else:
                units.append((a, slots))
        n_shards = min(self.workers, len(units))
        if n_shards <= 1:
            return [dict(targets)] if targets else []
        bins: list[tuple[int, dict]] = [(0, {}) for _ in range(n_shards)]
        for a, slots in sorted(units, key=lambda u: -len(u[1])):
            idx = min(range(n_shards), key=lambda i: bins[i][0])
            cost, shard = bins[idx]
            if a in shard:
                shard[a] = shard[a] + slots
            else:
                shard[a] = slots
            bins[idx] = (cost + 1 + len(slots), shard)
        return [shard for _, shard in bins if shard]

    def _run_shard(self, shard: dict):
        from ..metrics import sparse_commit_metrics

        t0 = time.monotonic()
        try:
            if self.injector is not None:
                self.injector.on_proof_fetch()
            proofs = self._calc().multiproof(shard)
        finally:
            with self._pool_lock:
                self._depth -= 1
            sparse_commit_metrics.set_proof_depth(self._depth)
        return proofs, time.monotonic() - t0

    # -- API ------------------------------------------------------------------

    def submit(self, targets: dict) -> list:
        """Async sharded fetch: returns ``[(future, shard_targets)]``;
        each future resolves to ``(proofs_dict, wall_s)``."""
        from ..metrics import sparse_commit_metrics

        shards = self._shards(targets)
        self.fetches += 1
        self.shards_total += len(shards)
        with self._pool_lock:
            self._depth += len(shards)
        sparse_commit_metrics.set_proof_depth(self._depth)
        pool = self._executor()
        return [(pool.submit(self._run_shard, shard), shard)
                for shard in shards]

    def multiproof(self, targets: dict) -> dict[bytes, AccountProof]:
        """Synchronous sharded multiproof, merged back into one
        per-account result (storage proofs re-ordered to the request's
        slot order when a big account was split across shards)."""
        out: dict[bytes, AccountProof] = {}
        for fut, _shard in self.submit(targets):
            proofs, _wall = fut.result()
            for a, ap in proofs.items():
                have = out.get(a)
                if have is None:
                    out[a] = ap
                else:
                    have.storage_proofs.extend(ap.storage_proofs)
        for a, slots in targets.items():
            ap = out.get(a)
            if ap is not None and len(ap.storage_proofs) > 1:
                order = {s: i for i, s in enumerate(slots)}
                ap.storage_proofs.sort(
                    key=lambda sp: order.get(sp.key, len(order)))
        return out


def _spine_nodes(proof_nodes: dict[Nibbles, bytes], target: Nibbles) -> list[bytes]:
    """Root→leaf node RLPs whose paths prefix ``target`` (inline nodes are
    embedded in their parents per EIP-1186, so only hashed nodes appear —
    plus the root which is always included)."""
    spine = sorted(
        (p for p in proof_nodes if target[: len(p)] == p), key=len
    )
    out = []
    for p in spine:
        rlp = proof_nodes[p]
        if len(p) == 0 or len(rlp) >= 32:
            out.append(rlp)
    return out


# -- verification (tests + light-client style checks) -------------------------


def verify_account_proof(root: bytes, address: bytes, proof: AccountProof) -> bool:
    """Verify an EIP-1186 account proof against a state root."""
    value = proof.account.trie_encode() if proof.account else None
    ok, leaf = _verify_path(root, unpack_nibbles(keccak256(address)), proof.proof)
    if not ok:
        return False
    if value is None:
        return leaf is None
    return leaf == value


def verify_storage_proof(storage_root: bytes, sp: StorageProof) -> bool:
    hashed = keccak256(sp.key)
    ok, leaf = _verify_path(storage_root, unpack_nibbles(hashed), sp.proof)
    if not ok:
        return False
    if sp.value == 0:
        return leaf is None
    return leaf == rlp_encode(encode_int(sp.value))


def _verify_path(root: bytes, path: Nibbles, nodes: list[bytes]):
    """Walk ``nodes`` from the root following ``path``; returns
    (valid, leaf_value|None)."""
    if not nodes:
        return root == EMPTY_ROOT_HASH, None
    if keccak256(nodes[0]) != root:
        return False, None
    node_bytes = nodes[0]
    depth = 0
    idx = 0
    while True:
        node = rlp_decode(node_bytes)
        if len(node) == 17:  # branch
            if depth == len(path):
                return True, node[16] or None
            child = node[path[depth]]
            depth += 1
            if child == b"" or child == []:
                return True, None
            nxt = child
        elif len(node) == 2:
            nibs, is_leaf = decode_path(node[0])
            if is_leaf:
                if path[depth:] == nibs:
                    return True, node[1]
                return True, None
            if path[depth: depth + len(nibs)] != nibs:
                return True, None
            depth += len(nibs)
            nxt = node[1]
        else:
            return False, None
        # resolve the next node: hash ref → next proof element; inline → walk
        if isinstance(nxt, bytes) and len(nxt) == 32:
            idx += 1
            if idx >= len(nodes):
                return False, None
            if keccak256(nodes[idx]) != nxt:
                return False, None
            node_bytes = nodes[idx]
        else:
            # inline node embedded in the parent
            node_bytes = rlp_encode(nxt)
