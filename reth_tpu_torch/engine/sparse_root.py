"""Sparse-trie live-tip state-root strategy: the whole trie job overlaps
execution, not just key prehashing.

A copy of the JAX package's ``engine/sparse_root.py`` on the port's proofs,
sparse trie and hot-state plane. Execution streams the keys each
transaction touched into a background task; one worker thread per block
(a) batch-hashes the plain keys on the task's live-lane hasher (kernel 1
through ``KeccakDevice`` on the card by default; the digests later feed the
hashed-table writes) and (b) fetches multiproofs from the PARENT's read
view, on a ``ProofWorkerPool`` when a ``provider_factory`` is given, and
reveals them into the (possibly cross-block preserved) sparse trie.
``finish`` then applies the block's final state delta and rehashes only
the dirty subtrees through a ``ParallelSparseCommitter``: the classic
finish on the task's hasher (kernel 1), or with ``arena=`` the hot-state
delta finish (kernel 4, ``subtrie_levels``). With ``hot_cache=`` the
cross-block node cache unblinds paths before they become proof targets.

Two departures from the reference, with its results:

- the sparse committer runs on the committer's device
  (``TrieCommitter.device``): a caller's ``device="cpu"`` committer gets a
  CPU finish, and no CPU path runs unless the caller asked for one;
- ``_reveal`` hashes each distinct proof node of a burst once, in one batch
  of the task's hasher, and hands the account reveal and every storage
  reveal the node map the reference builds per reveal by hashing the same
  nodes on the host (``SparseTrie.reveal(by_hash=)``): the same tries and
  ``stamped`` counts, without hashing or copying the burst's account nodes
  once per storage owner.

Any failure to close (an unresolvable blind, a commit that raises) ends in
``SparseRootError``, which keeps the failure as its ``__cause__``. The
engine tree (``tree.py``) answers it by rerunning the block on the
incremental committer, as the reference does, unless that cause is a
kernel fault (``ops/_build.is_kernel_fault``), which it raises.

Reference analogue: `SparseTrieCacheTask` + the proof-worker pools
(crates/engine/tree/src/tree/state_root_strategy/sparse_trie.rs:126-259,
crates/trie/parallel/src/state_root_task.rs:20-100,
crates/trie/parallel/src/proof_task.rs:136) and chain-state's
`PreservedSparseTrie` (crates/chain-state/src/preserved_sparse_trie.rs:15).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import ChainMap

from .. import tracing
from ..trie.proof import ProofCalculator, ProofWorkerPool
from ..trie.sparse import (
    BlindedNodeError,
    ParallelSparseCommitter,
    SparseStateTrie,
    SparseTrie,
    export_branch_updates,
)
from .stateless import apply_output_to_trie


class _NodeMap(ChainMap):
    """A storage owner's proof nodes keyed by keccak, over the burst's
    account nodes, without copying them. Its length, which a stamping
    reveal adds to ``stamped``, is that of the merged map, counted from the
    owner's side only."""

    def __init__(self, own: dict, shared: dict):
        super().__init__(own, shared)
        self._len = len(shared) + sum(d not in shared for d in own)

    def __len__(self) -> int:
        return self._len


class SparseRootError(Exception):
    """The sparse path could not produce a root; its cause says why."""


class SparseRootTask:
    """One block's background sparse-trie state-root job."""

    MAX_REVEAL_RETRIES = 64

    def __init__(self, parent_provider, parent_root: bytes, preserved,
                 committer, parent_hash: bytes | None = None,
                 provider_factory=None, workers: int | None = None,
                 trace_ctx=None, seed_digests=None, hot_cache=None,
                 arena=None):
        # the live tip is the highest-priority hash-service lane: with a
        # service the task's batches coalesce with every other client's but
        # dispatch first; without one this is committer.hasher
        self.hasher = committer.for_lane("live").hasher \
            if hasattr(committer, "for_lane") else committer.hasher
        # a committer on the supervised route carries the device supervisor:
        # its hasher already watchdogs and fails over every device batch;
        # kept for observability
        self.supervisor = getattr(committer, "supervisor", None)
        self.calc = ProofCalculator(parent_provider, committer)
        # hot-state plane: the shared cross-block node cache serves blinded
        # paths before they become proof targets, and the shared digest
        # arena turns the fused finish into a delta upload
        self.hot_cache = hot_cache
        self.cache_unblinds = 0   # proof targets the cache absorbed
        self.proof_targets = 0    # targets that DID go to proof fetch
        self._touched_accounts: set[bytes] = set()
        self._touched_storage: dict[bytes, set[bytes]] = {}
        # parallel finish (cross-trie packed hashing + encode pool) on the
        # committer's device
        self.sparse_committer = ParallelSparseCommitter(workers=workers, arena=arena,
                                                        device=committer.device)
        # proof-worker pool: shards multiproof targets by storage trie
        # across N workers, each on a FRESH parent view from
        # ``provider_factory`` (cursor state is per transaction). Without a
        # factory, fetches stay on the single worker.
        self.proof_pool = None
        if provider_factory is not None \
                and self.sparse_committer.workers > 1:
            self.proof_pool = ProofWorkerPool(
                lambda: ProofCalculator(provider_factory(), committer),
                workers=self.sparse_committer.workers,
                injector=self.sparse_committer.injector)
        self._outstanding: list = []   # [(future, shard_targets)]
        self._fetching: set = set()    # in-flight reveal targets (dedupe)
        self.preserved = preserved
        self.reused = False
        st = preserved.take(parent_hash) if parent_hash is not None else None
        if st is not None and st.account_trie.root_hash == parent_root:
            self.trie = st
            self.reused = True
        else:
            self.trie = SparseStateTrie.anchored(parent_root)
        if hot_cache is not None:
            # reveal-ref stamping: revealed-but-unmutated nodes keep a
            # clean ref, so the delta finish never re-stages them (and
            # trie.stamped is the delta-fraction denominator)
            self.trie.set_stamping(True)
        self._queue: queue.Queue = queue.Queue()
        self._digests: dict[bytes, bytes] = {}
        if seed_digests:
            # digests of the touched keys hashed ahead of the task (the
            # reference's cross-block pipeline): _process skips re-hashing
            # them, proof fetch and reveal still run
            self._digests.update(seed_digests)
        self._sent: set = set()
        self._failed: Exception | None = None
        # cooperative cancellation: a forkchoice update reorging away from
        # this block sets it from ANOTHER thread; the worker stops at its
        # next batch boundary and finish() refuses to produce a root
        self.cancelled = False
        self.proof_batches = 0
        self.retries = 0  # the finish's commits that met a blinded node
        self.commit_stats: dict | None = None
        # per-block wall breakdown (the reference's sparse_trie.rs:259
        # logs the same splits)
        self.walls = {"hash": 0.0, "proof": 0.0, "reveal": 0.0,
                      "finish": 0.0, "worker_busy": 0.0}
        self.started_at = time.monotonic()
        self.finish_called_at: float | None = None
        # explicit trace handoff: the task is created on the block thread
        # (under the block's root span); the worker adopts the context so
        # its hash/proof/reveal spans land in the block's timeline
        self._ctx = (trace_ctx if trace_ctx is not None
                     else tracing.current_context())
        self._thread = threading.Thread(target=self._run_traced, daemon=True)
        self._thread.start()

    # -- execution-side hook (OnStateHook seam) -----------------------------

    def on_state_update(self, keys) -> None:
        """Queue newly touched keys: 20-byte addresses and
        ``(address, slot)`` pairs."""
        fresh = [k for k in keys if k not in self._sent]
        if not fresh:
            return
        self._sent.update(fresh)
        self._queue.put(fresh)

    # -- worker -------------------------------------------------------------

    def _run_traced(self) -> None:
        with tracing.use_context(self._ctx):
            self._run()

    def _run(self) -> None:
        while True:
            batch = self._queue.get()
            if self.cancelled:
                return  # no drain: in-flight proof shards die with pools
            if batch is None:
                if self._failed is None:
                    try:
                        self._reap(block=True)  # drain in-flight proof shards
                    except Exception as e:  # noqa: BLE001 — reported at finish()
                        self._failed = e
                return
            # coalesce everything already queued: each proof fetch
            # re-commits the upper trie spine, so ONE multiproof per burst
            # of transactions beats one per transaction; the stream still
            # overlaps execution
            done = False
            batch = list(batch)
            while True:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    done = True
                    break
                batch.extend(nxt)
            if self._failed is None:
                t0 = time.monotonic()
                try:
                    self._reap(block=done)
                    self._process(batch)
                    if done:
                        self._reap(block=True)
                except Exception as e:  # noqa: BLE001 — reported at finish()
                    self._failed = e
                self.walls["worker_busy"] += time.monotonic() - t0
            if done:
                return

    def _process(self, batch) -> None:
        addrs = [k for k in batch if isinstance(k, bytes)]
        pairs = [k for k in batch if not isinstance(k, bytes)]
        # ONE coalesced hash call for everything this burst needs: the
        # addresses, the pair-owner addresses and the slots
        plain = [k for k in addrs + [a for a, _ in pairs]
                 + [s for _, s in pairs] if k not in self._digests]
        if plain:
            t0 = time.monotonic()
            plain = list(dict.fromkeys(plain))
            with tracing.span("engine::sparse_root", "key_hash",
                              keys=len(plain)):
                for k, d in zip(plain, self.hasher(plain)):
                    self._digests[k] = bytes(d)
            self.walls["hash"] += time.monotonic() - t0
        # reveal only what the trie can't already read (a preserved trie
        # usually has last block's hot paths — the cross-block reuse),
        # deduped against targets already in flight on the proof pool
        targets: dict[bytes, list[bytes]] = {}
        for a in addrs:
            ha = self._digests[a]
            self._touched_accounts.add(ha)
            if ha in self._fetching:
                continue
            if self._needs_account_reveal(ha):
                if self._cache_reveal_account(ha):
                    self.cache_unblinds += 1
                    continue
                targets.setdefault(a, [])
                self._fetching.add(ha)
        for a, s in pairs:
            ha = self._digests[a]
            hs = self._digests[s]
            self._touched_accounts.add(ha)
            self._touched_storage.setdefault(ha, set()).add(hs)
            key = (ha, hs)
            if key in self._fetching:
                continue
            if self._needs_storage_reveal(*key):
                if self._cache_reveal_storage(ha, hs):
                    self.cache_unblinds += 1
                    continue
                targets.setdefault(a, []).append(s)
                self._fetching.add(key)
        if not targets:
            return
        self.proof_batches += 1
        self.proof_targets += len(targets) + sum(
            len(v) for v in targets.values())
        if self.proof_pool is not None:
            # sharded async fetch: workers walk independent storage tries
            # on their own parent views; reveals land when shards complete
            # (next loop turn or the pre-finish drain), so proof fetch
            # overlaps execution AND other fetches
            self._outstanding.extend(self.proof_pool.submit(targets))
            return
        t0 = time.monotonic()
        with tracing.span("engine::sparse_root", "proof.fetch",
                          targets=len(targets)):
            proofs = self.calc.multiproof(targets)
        self.walls["proof"] += time.monotonic() - t0
        self._reveal(proofs, targets)

    def _reap(self, block: bool) -> None:
        """Reveal completed proof shards; with ``block`` wait for all."""
        still = []
        for fut, shard in self._outstanding:
            if not block and not fut.done():
                still.append((fut, shard))
                continue
            proofs, wall = fut.result()  # raises a worker's failure here
            self.walls["proof"] += wall
            # attribute the shard's (concurrent, pool-side) proof wall to
            # the block trace; start is reconstructed from the wall
            tracing.record_span("engine::sparse_root", "proof.shard",
                                time.time() - wall, wall, ctx=self._ctx,
                                fields={"targets": len(shard)})
            self._reveal(proofs, shard)
        self._outstanding = still

    def _reveal(self, proofs, targets) -> None:
        t1 = time.monotonic()
        with tracing.span("engine::sparse_root", "reveal",
                          accounts=len(proofs)):
            nodes = []
            for ap in proofs.values():
                nodes.extend(ap.proof)
            snodes = {a: [n for sp in ap.storage_proofs for n in sp.proof]
                      for a, ap in proofs.items()}
            # every distinct node of the burst hashed once, in one batch
            distinct = list(dict.fromkeys(
                nodes + [n for ns in snodes.values() for n in ns]))
            digest_of = dict(zip(distinct, (bytes(d) for d in self.hasher(distinct)))) \
                if distinct else {}
            by_hash = {digest_of[n]: n for n in nodes}
            self.trie.account_trie.reveal(nodes, by_hash)
            for a, ap in proofs.items():
                if snodes[a] or targets.get(a):
                    # the map the reference hashes from ``nodes + snodes``,
                    # the owner's nodes laid over the burst's shared ones;
                    # reveal reads only the map, and the nodes it is given
                    # are empty just when the reference's would be
                    own = {digest_of[n]: n for n in snodes[a]}
                    self.trie.reveal_storage(self._digests[a], ap.storage_root,
                                             snodes[a] or nodes,
                                             _NodeMap(own, by_hash))
        self.walls["reveal"] += time.monotonic() - t1

    def _needs_account_reveal(self, hashed_addr: bytes) -> bool:
        try:
            self.trie.account_trie.get(hashed_addr)
            return False
        except BlindedNodeError:
            return True

    def _needs_storage_reveal(self, hashed_addr: bytes,
                              hashed_slot: bytes) -> bool:
        st = self.trie.storage_tries.get(hashed_addr)
        if st is None:
            return True  # storage root unknown until the account is read
        try:
            st.get(hashed_slot)
            return False
        except BlindedNodeError:
            return True

    # -- hot-state cache reveals (proof fetches the cache absorbs) -----------

    def _cache_reveal_account(self, hashed_addr: bytes) -> bool:
        """Unblind the account path purely from the cross-block node
        cache; True = no proof target needed for this key."""
        if self.hot_cache is None:
            return False
        from ..trie.hot_cache import ACCOUNT_OWNER

        return self.hot_cache.reveal_through(self.trie.account_trie,
                                             ACCOUNT_OWNER, hashed_addr)

    def _cache_reveal_storage(self, hashed_addr: bytes,
                              hashed_slot: bytes) -> bool:
        """Storage analogue, for a storage trie the task has already
        anchored. A storage trie not anchored yet goes to the proof fetch:
        the reference would anchor it at the account leaf's storage root,
        but its decode (``Account.decode``, which its account type lacks)
        always raises into its ``except``, so it never serves one; the port
        keeps that result, and with it the reference's ``cache_unblinds``
        and ``proof_targets``."""
        if self.hot_cache is None:
            return False
        st = self.trie.storage_tries.get(hashed_addr)
        if st is None:
            return False
        return self.hot_cache.reveal_through(st, hashed_addr, hashed_slot)

    # -- finalization --------------------------------------------------------

    def finish(self, out):
        """Apply the block's state delta and rehash dirty levels.
        Returns ``(root, digest_map, storage_roots)`` where ``digest_map``
        maps plain keys (addresses, slots) to keccak digests and
        ``storage_roots`` maps plain addresses to recomputed storage
        roots. Raises SparseRootError when the sparse path cannot close.
        Call :meth:`preserve` only after the root matched the header —
        preserving a trie mutated by an invalid block would poison the
        next block's anchor."""
        self.finish_called_at = time.monotonic()
        # overlap snapshot: only busy time BEFORE this point ran while the
        # EVM executed; drain batches inside finish() are latency, not overlap
        self._busy_at_finish = self.walls["worker_busy"]
        self._queue.put(None)
        self._thread.join()
        try:
            return self._finish_inner(out)
        finally:
            self._shutdown_pools()

    def _finish_inner(self, out):
        if self.cancelled:
            raise SparseRootError("cancelled by forkchoice reorg")
        if self._failed is not None:
            raise SparseRootError(f"worker failed: {self._failed}") \
                from self._failed
        # straggler digests (withdrawal targets, wiped accounts, ...)
        want = sorted(set(out.changes.accounts) | set(out.changes.storage)
                      | set(out.changes.wiped_storage))
        slot_keys = [s for _, slots in out.post_storage.items()
                     for s in slots]
        missing = [k for k in want + slot_keys if k not in self._digests]
        if missing:
            missing = list(dict.fromkeys(missing))
            for k, d in zip(missing, self.hasher(missing)):
                self._digests[k] = bytes(d)
        storage_roots: dict[bytes, bytes] = {}
        for _attempt in range(self.MAX_REVEAL_RETRIES):
            if self.cancelled:
                raise SparseRootError("cancelled by forkchoice reorg")
            try:
                # parallel commit: cross-trie packed dispatches + encode
                # pool; any failure inside it (a launch fault, a failed
                # build, the RETH_TPU_FAULT_SPARSE_ABORT drill) surfaces as
                # SparseRootError below, with the failure as its cause
                with tracing.span("engine::sparse_root", "sparse.finish",
                                  attempt=_attempt):
                    root = apply_output_to_trie(
                        self.trie, out, self.hasher,
                        storage_roots_out=storage_roots,
                        committer=self.sparse_committer, digests=self._digests)
                break
            except BlindedNodeError as e:
                self.retries += 1
                if self._cache_unblind(e):
                    self.cache_unblinds += 1
                    continue  # retry the commit without a spine fetch
                extra = (self.calc.storage_spine_for_path(e.owner, e.path)
                         if e.owner is not None
                         else self.calc.spine_for_path(e.path))
                if e.owner is not None:
                    st = self.trie.storage_tries.get(e.owner)
                    if st is None:
                        raise SparseRootError("blind in unknown storage trie") from e
                    st.reveal(extra)
                else:
                    self.trie.reveal_account(extra)
            except Exception as e:  # noqa: BLE001 — the cause travels with the error
                raise SparseRootError(f"parallel commit failed: {e}") from e
        else:
            raise SparseRootError("blinded-node reveal did not converge")
        self.commit_stats = self.sparse_committer.last
        self.walls["finish"] = time.monotonic() - self.finish_called_at
        return root, self._digests, storage_roots

    def _cache_unblind(self, e: BlindedNodeError) -> bool:
        """Serve a finish-side blind from the node cache (one validated
        node at the reported path); False = pay the spine fetch."""
        if self.hot_cache is None:
            return False
        if e.owner is not None:
            trie = self.trie.storage_tries.get(e.owner)
            owner = e.owner
        else:
            from ..trie.hot_cache import ACCOUNT_OWNER

            trie = self.trie.account_trie
            owner = ACCOUNT_OWNER
        if trie is None:
            return False
        path = bytes(e.path)
        h = trie.blind_hash_at(path)
        if h is None:
            return False
        rlp = self.hot_cache.lookup(owner, path, h)
        return rlp is not None and trie.reveal_at(path, rlp)

    def absorb_into_cache(self, out, digest_map=None) -> None:
        """Post-root-match population pass: push this block's freshly
        committed spines (changed keys) and revealed read paths (touched
        keys) into the shared node cache. Call next to :meth:`preserve`
        — absorbing a trie mutated by an INVALID block would poison
        sibling forks' reveals."""
        if self.hot_cache is None:
            return
        if digest_map is None:
            digest_map = self._digests
        changed = sorted(set(out.changes.accounts) | set(out.changes.storage)
                         | set(out.changes.wiped_storage))
        account_keys = [digest_map[a] for a in changed]
        storage_keys = {digest_map[a]: [digest_map[s] for s in slots]
                        for a, slots in out.post_storage.items()}
        wiped = [digest_map[a] for a in out.changes.wiped_storage]
        self.hot_cache.absorb_block(
            self.trie, account_keys, storage_keys, wiped_owners=wiped,
            touched_accounts=self._touched_accounts,
            touched_storage=self._touched_storage)

    def _shutdown_pools(self) -> None:
        self.sparse_committer.shutdown()
        if self.proof_pool is not None:
            self.proof_pool.shutdown()

    def overlap_metrics(self) -> dict:
        """Per-block breakdown: how much of the trie work overlapped
        execution. ``overlap_fraction`` = worker busy time that ran BEFORE
        finish() was called (i.e. while the EVM executed) over the
        execution window."""
        exec_wall = ((self.finish_called_at or time.monotonic())
                     - self.started_at)
        busy_during_exec = getattr(self, "_busy_at_finish",
                                   self.walls["worker_busy"])
        overlapped = min(busy_during_exec, exec_wall)
        out = {
            **{k: round(v, 6) for k, v in self.walls.items()},
            "exec_wall": round(exec_wall, 6),
            "overlap_fraction": round(overlapped / exec_wall, 4)
            if exec_wall > 0 else 0.0,
            # with the proof pool, "proof" sums per-shard busy time across
            # concurrent workers (can exceed wall clock)
            "proof_shards": (self.proof_pool.shards_total
                             if self.proof_pool is not None else 0),
            "sparse_workers": self.sparse_committer.workers,
            "proof_targets": self.proof_targets,
            "cache_unblinds": self.cache_unblinds,
        }
        if self.commit_stats is not None:
            out["commit"] = dict(self.commit_stats)
        if self.supervisor is not None:
            out["hasher_breaker"] = self.supervisor.breaker.state
        return out

    def preserve(self, block_hash: bytes) -> None:
        """Anchor the updated trie for the next payload (call after the
        computed root matched the block header)."""
        self.preserved.preserve(block_hash, self.trie)

    def export_updates(self, out, digest_map):
        """Stored-format branch updates for the overlay, straight from the
        sparse trie (reference: sparse trie TrieUpdates — no DB re-walk).
        Returns (account_updates, storage_updates) where each maps
        path -> BranchNode | None (None = delete)."""
        changed = sorted(set(out.changes.accounts) | set(out.changes.storage)
                         | set(out.changes.wiped_storage))
        acct_keys = [digest_map[a] for a in changed]
        account_updates = export_branch_updates(
            self.trie.account_trie, acct_keys, self.calc.provider.account_branch)
        storage_updates: dict[bytes, dict] = {}
        for a, slots in out.post_storage.items():
            ha = digest_map[a]
            st = self.trie.storage_tries.get(ha)
            if st is None:
                continue
            skeys = [digest_map[s] for s in slots]
            storage_updates[ha] = export_branch_updates(
                st, skeys,
                lambda p, _ha=ha: self.calc.provider.storage_branch(_ha, p))
        for a in out.changes.wiped_storage:
            ha = digest_map[a]
            if ha in storage_updates:
                continue  # wiped + recreated: already exported above
            st = self.trie.storage_tries.get(ha, SparseTrie())
            post = out.post_storage.get(a, {})
            skeys = [digest_map[s] for s in post]
            storage_updates[ha] = export_branch_updates(
                st, skeys, lambda p: None)
        return account_updates, storage_updates

    def abort(self) -> None:
        """Stop the worker without producing a root (execution failed)."""
        self._queue.put(None)
        self._thread.join()
        self._shutdown_pools()

    def cancel(self) -> None:
        """Non-blocking abort from ANOTHER thread (a forkchoice update
        reorging away from this block): flag the task, wake the worker.
        The block's thread still owns the blocking cleanup — its abort /
        finish path joins the worker and shuts the pools down."""
        self.cancelled = True
        self._queue.put(None)
