"""The engine tree: newPayload / forkchoiceUpdated / persistence.

A copy of the JAX package's ``engine/tree.py`` on the port's modules.
Its entry point runs on the card unless the caller passes ``device="cpu"``:
without a committer it builds ``TrieCommitter(device=device)``, and the
consensus checks and the default unwinder's stages take the same device.

Departures, each with the reference's results where the reference has one:

- no kernel fault becomes a slower route. A ``BuildError``, a kernel's
  ``LaunchError`` or a PyTorch CUDA error (``ops/_build.is_kernel_fault``
  along the ``__cause__`` chain) raises out of ``on_new_payload``: the
  hot-state arena is built outside any catch, and its epochs raise kernel
  faults instead of rerunning the commit classic (``trie/sparse.py``,
  for every owner of an arena); ``_start_sparse_root`` takes the pipelined route only for
  an unknown parent header; ``_sparse_root_or_fallback`` reruns the block
  on the incremental committer only for the reference's own causes (a
  reveal that does not converge, an unknown storage trie, the injected
  ``RETH_TPU_FAULT_SPARSE_ABORT``, a proof-worker failure that is no device
  fault), counted in ``sparse_fallbacks``;
- ``durability`` is None until a caller attaches a ``DurabilityManager``
  (``storage/wal.attach_wal`` over a ``MemDb``, then ``tree.durability =
  manager``, as the reference's node does). With one, every persistence
  advance and deep-reorg unwind is a checkpoint boundary
  (``_durability_boundary``); without one, it syncs a native store or
  flushes a ``MemDb`` that has a file. An unwind interrupted at the
  ``"unwind"`` crash point leaves ``UNWIND_MARKER_KEY`` on disk, and
  ``storage/recovery.recover_on_startup`` completes it at the next start.

Reference analogue: `EngineApiTreeHandler` (crates/engine/tree,
tree module) — `on_new_payload` (insert + validate + state root),
`on_forkchoice_updated`, `TreeState`, the orphan `BlockBuffer` and the
bounded `InvalidHeaderCache` (both in engine/block_buffer.py here), and
`advance_persistence` + `PersistenceHandle` (the persistence service).
The per-block state-root job — the reference's SparseTrieCacheTask
pipeline — is the batched incremental committer over the block's
overlay. Consensus-robustness behavior (orphan buffering/replay,
invalid-ancestor propagation, in-flight insert cancellation on
forkchoice reorgs, reorg-storm backoff) is documented in ARCHITECTURE
"Consensus robustness".
"""

from __future__ import annotations

import threading
import time as _time
from dataclasses import dataclass, field
from enum import Enum

from ..metrics import REGISTRY, tree_metrics
from .. import tracing
from ..chaos import crash_point

from ..consensus import ConsensusError, EthBeaconConsensus
from ..evm import BlockExecutor, EvmConfig
from ..evm.executor import InvalidTransaction, ProviderStateSource
from ..ops._build import is_kernel_fault
from ..primitives.types import Block
from ..stages.execution import write_execution_output
from ..storage.overlay import Layer, OverlayTx, apply_layer
from ..storage.provider import DatabaseProvider, ProviderFactory
from ..storage.tables import Tables
from ..trie.committer import TrieCommitter
from ..trie.incremental import IncrementalStateRoot


class PayloadStatusKind(Enum):
    VALID = "VALID"
    INVALID = "INVALID"
    SYNCING = "SYNCING"


@dataclass
class PayloadStatus:
    status: PayloadStatusKind
    latest_valid_hash: bytes | None = None
    validation_error: str | None = None


class PayloadCancelled(Exception):
    """An in-flight insert was cancelled by a competing
    forkchoiceUpdated reorging away from it; the payload reports
    SYNCING instead of finishing against a dead head."""


@dataclass
class _InFlightInsert:
    """The one insert currently racing forkchoice (engine handlers may
    run on different transport threads): its identity plus the hooks a
    reorging fcU uses to abort the speculative machinery."""

    block_hash: bytes
    parent_hash: bytes
    cancel: threading.Event = field(default_factory=threading.Event)
    sparse_task: object = None
    # commit window published to the cross-block pipeline once this
    # insert enters its state-root phase (engine/block_pipeline.py)
    commit_win: object = None


@dataclass
class ExecutedBlock:
    """A validated pending block: its full effect as one overlay layer."""

    block: Block
    senders: list[bytes]
    receipts: list
    layer: Layer
    parent_hash: bytes

    @property
    def hash(self) -> bytes:
        return self.block.hash

    @property
    def number(self) -> int:
        return self.block.header.number


class EngineTree:
    """In-memory tree of pending blocks above the persisted chain."""

    def __init__(
        self,
        factory: ProviderFactory,
        committer: TrieCommitter | None = None,
        consensus: EthBeaconConsensus | None = None,
        config: EvmConfig | None = None,
        persistence_threshold: int = 2,
        unwinder=None,
        invalid_block_hooks: list | None = None,
        bal_execution: bool = False,
        state_root_strategy: str = "sparse",
        sparse_workers: int | None = None,
        parallel_exec: bool = False,
        exec_workers: int | None = None,
        invalid_cache_size: int | None = None,
        block_buffer_size: int | None = None,
        block_buffer_ttl: float | None = None,
        pipeline_depth: int | None = None,
        hot_state: bool | None = None,
        device: str = "cuda",
    ):
        self.factory = factory
        self.device = device
        self.committer = committer or TrieCommitter(device=device)
        self.consensus = consensus or EthBeaconConsensus(self.committer,
                                                         device=device)
        self.config = config or EvmConfig()
        self.persistence_threshold = persistence_threshold
        # called with (block, reason, out=None, computed_root=None) whenever
        # a payload is rejected (reference InvalidBlockHook, witness.rs)
        self.invalid_block_hooks = list(invalid_block_hooks or [])
        # cross-block execution cache, anchored to the chain tip it was
        # warmed on (reference crates/engine/execution-cache SavedCache);
        # a payload extending a different parent resets it — stale reads
        # would be a consensus bug, so precision beats warmth
        from .execution_cache import ExecutionCache

        self.execution_cache = ExecutionCache()
        self._cache_anchor: bytes | None = None
        # parallel cache-warming pass before sequential execution (set
        # high to disable; reference gates prewarm similarly)
        self.prewarm_threshold = 4
        self.last_prewarm = None
        # Parallel execution has two schedulers. With a BAL hint
        # (bal_execution): the prewarm pass doubles as the speculative
        # access recording, then execute_block_bal schedules conflict-free
        # waves (reference payload_processor/bal/execute.rs). WITHOUT a
        # hint — every real newPayload — --parallel-exec routes through
        # the optimistic Block-STM-style scheduler (engine/optimistic.py):
        # single-wave native speculation + in-order read-set validation +
        # serial re-execution of invalidated ranks, with async storage
        # prefetch; it folds the prewarm pass into its speculative first
        # attempt. Fallback ladder: optimistic -> BAL wave -> serial.
        self.bal_execution = bal_execution
        self.last_bal_stats = None
        # --parallel-exec: optimistic scheduler on the no-BAL path
        self.parallel_exec = parallel_exec
        # scheduler speculation width (None = RETH_TPU_EXEC_WORKERS / auto)
        self.exec_workers = exec_workers
        self.last_exec = None  # per-block optimistic stats (tests/metrics)
        # live-tip state-root strategy: "sparse" overlaps the WHOLE trie
        # job with execution via a background proof-fetch + reveal task
        # (reference state_root_strategy/sparse_trie.rs); anything else
        # runs the prehash-only pipelined worker + incremental committer.
        # The sparse path falls back to the incremental committer on any
        # SparseRootError (reference engine-primitives config,
        # `state_root_fallback`).
        self.state_root_strategy = state_root_strategy
        # --sparse-workers: width of the sparse finish path's encode pool
        # AND the proof-worker pool (None = env/auto; 1 = pools off, the
        # cross-trie packed dispatch stays on)
        self.sparse_workers = sparse_workers
        from ..trie.sparse import PreservedSparseTrie

        self.preserved_trie = PreservedSparseTrie()
        self.last_sparse = None  # per-block strategy stats (tests/metrics)
        # blocks whose sparse root fell back to the incremental committer
        self.sparse_fallbacks = 0
        # hot-state plane (--hot-state / RETH_TPU_HOT_STATE):
        # a cross-block node/multiproof cache shared by every fork's
        # sparse task + the persistent device digest arena the fused
        # finish delta-uploads against. Both ride the same reorg
        # stand-downs as the preserved trie (deep unwind / reorg storm
        # -> wholesale invalidation).
        if hot_state is None:
            from ..trie.hot_cache import hot_state_enabled

            hot_state = hot_state_enabled()
        self.hot_cache = None
        self.hot_arena = None
        if hot_state:
            from ..trie.hot_cache import TrieNodeCache

            from ..ops.fused_commit import DigestArena

            self.hot_cache = TrieNodeCache.from_env()
            self.hot_arena = DigestArena.from_env()
        if unwinder is None:
            def unwinder(fac, target):
                from ..stages import Pipeline, default_stages

                Pipeline(fac, default_stages(committer=self.committer,
                                             device=device)).unwind(target)
        self.unwinder = unwinder
        # durability boundary (storage/wal.py DurabilityManager): when the
        # node attaches one, every persistence advance notifies it so WAL
        # checkpoints track the persistence threshold; without one, a
        # flush()-capable store is flushed at the same boundary — either
        # way durability no longer waits for graceful shutdown
        self.durability = None
        # HA fencing (fleet/election.py): a restarted old leader that
        # detects a higher leader epoch on a live peer feed sets this —
        # every write entry point (newPayload, forkchoiceUpdated)
        # refuses with the fencing reason instead of splitting the brain
        self.fenced = False
        self.fence_reason = ""
        self.blocks: dict[bytes, ExecutedBlock] = {}
        from .block_buffer import BlockBuffer, InvalidHeaderCache, ReorgTracker

        # bounded LRU of rejected payloads (--invalid-cache-size /
        # RETH_TPU_INVALID_CACHE): an invalid-payload flood plateaus at
        # the bound instead of leaking memory (reference
        # InvalidHeaderCache); dict-compatible for existing callers
        self.invalid = InvalidHeaderCache(invalid_cache_size)
        # blocks whose parent is unknown yet (reference BlockBuffer):
        # bounded + timeout-evicted, and buffered children replay the
        # moment the missing parent validates
        self.buffered = BlockBuffer(limit=block_buffer_size,
                                    ttl=block_buffer_ttl)
        # reorg-depth accounting: pathological forkchoice churn dumps
        # the flight recorder once and engages a backoff window during
        # which the speculative paths (sparse root, optimistic exec,
        # prewarm) stand down — they are exactly what the churn thrashes
        self.reorgs = ReorgTracker()
        # cross-block import pipeline (engine/block_pipeline.py): depth
        # >= 2 speculatively executes payload N+1 over N's uncommitted
        # overlay while N's state-root job runs on the device
        # (--pipeline-depth / RETH_TPU_PIPELINE_DEPTH; 1 = serial import)
        if pipeline_depth is None:
            import os

            try:
                pipeline_depth = int(
                    os.environ.get("RETH_TPU_PIPELINE_DEPTH", "1"))
            except ValueError:
                pipeline_depth = 1
        self.pipeline = None
        if pipeline_depth >= 2:
            from .block_pipeline import BlockPipeline

            self.pipeline = BlockPipeline(self, depth=pipeline_depth)
        # the insert currently in flight (engine transports may race a
        # forkchoiceUpdated against it); guarded by _inflight_lock
        self._inflight: _InFlightInsert | None = None
        self._inflight_lock = threading.Lock()
        with factory.provider() as p:
            n = p.last_block_number()
            h = p.canonical_hash(n)
        self.persisted_number = n
        self.persisted_hash = h
        self.head_hash: bytes = h  # canonical in-memory head
        self.canon_listeners: list = []  # CanonStateNotification sinks
        # fork-choice forwarding sinks (fleet HA: the witness feed ships
        # every head advance to the standby as an st_fcu record); called
        # with (number, head_hash) AFTER persistence advanced, so the
        # shipped WAL records for the head's durable prefix precede it
        self.fcu_listeners: list = []
        self._root_histogram = REGISTRY.histogram(
            "engine_state_root_duration_seconds",
            "per-block incremental state-root wall clock",
        )
        self._blocks_counter = REGISTRY.counter("engine_blocks_executed_total")

    # -- helpers --------------------------------------------------------------

    def _chain_layers(self, parent_hash: bytes) -> list[Layer] | None:
        """Overlay layers from the persisted root up to ``parent_hash``.

        Returns None when the parent is unknown (not persisted tip chain).
        """
        layers: list[Layer] = []
        h = parent_hash
        while h != self.persisted_hash:
            eb = self.blocks.get(h)
            if eb is None:
                return None
            layers.append(eb.layer)
            h = eb.parent_hash
        layers.reverse()
        return layers

    def block_by_hash(self, block_hash: bytes) -> Block | None:
        eb = self.blocks.get(block_hash)
        if eb is not None:
            return eb.block
        with self.factory.provider() as p:
            n = p.block_number(block_hash)
            return p.block_by_number(n) if n is not None else None

    def canonical_chain(self) -> list[bytes]:
        """In-memory canonical hashes, oldest first (persisted root excl.)."""
        out = []
        h = self.head_hash
        while h != self.persisted_hash:
            eb = self.blocks.get(h)
            if eb is None:
                break
            out.append(h)
            h = eb.parent_hash
        out.reverse()
        return out

    def overlay_provider(self, head: bytes | None = None) -> DatabaseProvider:
        """Read provider over the canonical in-memory state at ``head``.

        Raises KeyError when ``head`` is not a known tree block or the
        persisted root — never silently serves the wrong state.
        """
        target = head if head is not None else self.head_hash
        layers = self._chain_layers(target)
        if layers is None:
            raise KeyError(f"unknown head {target.hex()}")
        base = self.factory.db.tx()
        return DatabaseProvider(OverlayTx(base, layers), self.factory.static_files)

    # -- newPayload ------------------------------------------------------------

    def fence(self, reason: str) -> None:
        """Refuse all subsequent writes (HA epoch fencing): this node
        was superseded by a higher leader epoch while it was down."""
        self.fenced = True
        self.fence_reason = reason
        tracing.event("engine::tree", "fenced", reason=reason)

    def on_new_payload(self, block: Block) -> PayloadStatus:
        if self.fenced:
            return PayloadStatus(PayloadStatusKind.INVALID, None,
                                 f"fenced: {self.fence_reason}")
        h = block.hash
        if h in self.blocks:
            return PayloadStatus(PayloadStatusKind.VALID, h)
        reason = self.invalid.get(h)
        if reason is not None:
            return PayloadStatus(PayloadStatusKind.INVALID, None, reason)
        if block.header.parent_hash in self.invalid:
            self.invalid[h] = "invalid ancestor"
            self._invalidate_buffered_children(h)
            return PayloadStatus(PayloadStatusKind.INVALID, None, "invalid ancestor")
        # replay of an already-persisted canonical block → VALID
        with self.factory.provider() as p:
            if p.canonical_hash(block.header.number) == h:
                return PayloadStatus(PayloadStatusKind.VALID, h)
        parent_layers = self._chain_layers(block.header.parent_hash)
        if parent_layers is None and self.pipeline is not None:
            # parent may be the block currently committing: speculate —
            # execute this payload over the parent's uncommitted overlay
            # while its state-root dispatches run, adopt on VALID
            # (engine/block_pipeline.py); None means the pipeline didn't
            # handle it and the normal buffer/SYNCING path decides below
            st = self.pipeline.try_speculate(block)
            if st is not None:
                if st.status is PayloadStatusKind.VALID:
                    self._replay_buffered_children(h)
                elif st.status is PayloadStatusKind.INVALID:
                    self._invalidate_buffered_children(h)
                return st
            if block.header.parent_hash in self.invalid:
                # the parent was judged INVALID while we speculated
                self.invalid[h] = "invalid ancestor"
                self._invalidate_buffered_children(h)
                return PayloadStatus(PayloadStatusKind.INVALID, None,
                                     "invalid ancestor")
            if h in self.blocks:  # a buffered replay raced us in
                return PayloadStatus(PayloadStatusKind.VALID, h)
            parent_layers = self._chain_layers(block.header.parent_hash)
        if parent_layers is None:
            # parent unknown or below the persisted tip: buffer; the
            # parent arriving (below) or a later FCU to this branch
            # replays the buffered subtree (reference BlockBuffer)
            self.buffered.insert(block)
            return PayloadStatus(PayloadStatusKind.SYNCING)
        st = self._validate_and_insert(block, parent_layers)
        if st.status is PayloadStatusKind.VALID:
            self._replay_buffered_children(h)
        elif st.status is PayloadStatusKind.INVALID:
            self._invalidate_buffered_children(h)
        return st

    def _replay_buffered_children(self, parent_hash: bytes) -> None:
        """The missing parent just validated: replay its buffered
        children (recursing through on_new_payload, so grandchildren
        follow and an invalid child invalidates its own subtree)."""
        for child in self.buffered.take_children_of(parent_hash):
            tree_metrics.orphans_replayed()
            st = self.on_new_payload(child)
            if st.status is PayloadStatusKind.SYNCING:
                # replay interrupted (e.g. insert cancelled by a racing
                # fcU): keep the child for the next trigger
                self.buffered.insert(child)

    def _invalidate_buffered_children(self, parent_hash: bytes) -> None:
        """Invalid-ancestor propagation into the orphan buffer: children
        waiting on a block that just proved invalid are invalid too."""
        for child in self.buffered.take_children_of(parent_hash):
            self.invalid[child.hash] = "invalid ancestor"
            self._invalidate_buffered_children(child.hash)

    def _validate_and_insert(self, block: Block, parent_layers: list[Layer],
                             pre_executed=None) -> PayloadStatus:
        h = block.hash
        base = self.factory.db.tx()
        layer: Layer = {}
        overlay = DatabaseProvider(OverlayTx(base, parent_layers, layer))
        inflight = _InFlightInsert(h, block.header.parent_hash)
        with self._inflight_lock:
            self._inflight = inflight
        status = None
        try:
            # block-lifecycle trace root: trace_id = block hash; every
            # phase span below (and every queue/pool handoff that carries
            # the context) lands in this block's timeline
            with tracing.trace_block(h.hex(), number=block.header.number,
                                     txs=len(block.transactions)):
                with tracing.span("engine::tree", "validate"):
                    parent = self._header_of(block.header.parent_hash, overlay)
                    self.consensus.validate_header_against_parent(
                        block.header, parent)
                    self.consensus.validate_block_pre_execution(block)
                status, senders, receipts = self._execute_into_overlay(
                    block, overlay, parent_layers, inflight=inflight,
                    pre_executed=pre_executed)
        except (ConsensusError, InvalidTransaction) as e:
            self.invalid[h] = str(e)
            self._run_invalid_hooks(block, str(e))
            return PayloadStatus(PayloadStatusKind.INVALID, None, str(e))
        except PayloadCancelled:
            # a competing forkchoiceUpdated reorged away mid-insert: the
            # speculative work was aborted through the journaled paths;
            # the payload itself may be perfectly valid, so report
            # SYNCING (the CL re-sends if it still cares), never INVALID
            tracing.event("engine::tree", "payload_cancelled",
                          block=h.hex()[:16])
            return PayloadStatus(PayloadStatusKind.SYNCING)
        finally:
            with self._inflight_lock:
                if self._inflight is inflight:
                    self._inflight = None
            # non-VALID exit (exception, INVALID, cancel): close this
            # insert's commit window NOW so a speculating child aborts;
            # the VALID path closes below, AFTER the block is visible in
            # the tree (adoption needs it in ``blocks``)
            if (inflight.commit_win is not None and self.pipeline is not None
                    and (status is None
                         or status.status is not PayloadStatusKind.VALID)):
                self.pipeline.close_commit(inflight.commit_win, ok=False)
        if status.status is PayloadStatusKind.VALID:
            self.blocks[h] = ExecutedBlock(
                block=block, senders=senders, receipts=receipts,
                layer=layer, parent_hash=block.header.parent_hash,
            )
            self.buffered.pop(h, None)
            if inflight.commit_win is not None and self.pipeline is not None:
                self.pipeline.close_commit(inflight.commit_win, ok=True)
        return status

    def _header_of(self, block_hash: bytes, overlay: DatabaseProvider):
        eb = self.blocks.get(block_hash)
        if eb is not None:
            return eb.block.header
        n = overlay.block_number(block_hash)
        if n is None:
            raise ConsensusError("unknown parent")
        return overlay.header_by_number(n)

    def _execute_into_overlay(
        self, block: Block, overlay: DatabaseProvider,
        parent_layers: list[Layer] | None = None,
        inflight: _InFlightInsert | None = None,
        pre_executed=None,
    ) -> tuple[PayloadStatus, list[bytes], list]:
        """Execute + hash + root-check ``block``, writing into the overlay.

        Returns (status, senders, receipts); senders/receipts are empty on
        invalid payloads. With ``pre_executed`` (a SpeculationResult from
        the cross-block pipeline) execution is already done: its output
        feeds the SAME post-validation, overlay writes, and root checks a
        fresh execution would — adoption never skips a consensus check.
        """
        header = block.header
        n = header.number
        # execute (senders recovered here = SenderRecovery equivalent)
        from .execution_cache import CachedStateSource

        with tracing.span("engine::tree", "prepare"):
            # one hash computation for the whole function: Block.hash
            # re-encodes and keccaks the header on EVERY access (~ms) —
            # the block timeline made the three redundant recomputations
            # on this path visible
            block_hash = block.hash
            if pre_executed is not None:
                # adopt the speculation's warmed cache as the tree's
                # cross-block cache (it was warmed on exactly this
                # parent's state); finalize below advances its anchor
                self.execution_cache = pre_executed.cache
                self._cache_anchor = header.parent_hash
                source = executor = None
                hashes = {}
            else:
                if self._cache_anchor != header.parent_hash:
                    self.execution_cache = type(self.execution_cache)()  # reset
                    # the fresh cache is warmed with THIS parent's state:
                    # anchor it now, or a failed sibling would leave
                    # cache/anchor divergent
                    self._cache_anchor = header.parent_hash
                source = CachedStateSource(ProviderStateSource(overlay),
                                           self.execution_cache)
                executor = BlockExecutor(source, self.config)
                hashes = {}
                for k in range(max(0, n - 256), n):
                    bh = overlay.canonical_hash(k)
                    if bh:
                        hashes[k] = bh
        from ..primitives.types import recover_senders

        with tracing.span("engine::tree", "recover_senders",
                          txs=len(block.transactions)):
            senders = (pre_executed.senders if pre_executed is not None
                       else recover_senders(block.transactions))
        if any(s is None for s in senders):
            bad = next(i for i, s in enumerate(senders) if s is None)
            try:
                block.transactions[bad].recover_sender()
                reason = "recovery failed"
            except ValueError as e:
                reason = str(e)
            msg = f"bad signature: tx {bad}: {reason}"
            self.invalid[block_hash] = msg
            self._run_invalid_hooks(block, msg)
            return PayloadStatus(PayloadStatusKind.INVALID, None, msg), [], []
        # background state-root job overlapping execution: the sparse
        # strategy streams touched keys to a proof-fetch + reveal worker
        # so the whole trie job (hash, walk, reveal) overlaps the EVM
        # (reference the sparse-trie state-root strategy + the parallel
        # state-root task); the pipelined strategy overlaps key
        # prehash only (engine/pipelined_root.py). Created BEFORE prewarm
        # so the warming workers can seed its proof prefetch below.
        self.last_sparse = None
        sparse_task = None
        root_job = None
        # reorg-storm backoff: while a hostile CL churns forkchoice, the
        # speculative paths (preserved sparse trie, optimistic exec,
        # prewarm) are what every reorg invalidates — stand them down and
        # serve through the serial + pipelined/incremental paths instead
        speculate = not self.reorgs.in_backoff()
        block_ctx = tracing.current_context()  # the block's root span
        with tracing.span("engine::tree", "root_task_start"):
            if self.state_root_strategy == "sparse" and speculate:
                sparse_task = self._start_sparse_root(
                    block, parent_layers, trace_ctx=block_ctx,
                    # adoption seeds the key digests the speculative
                    # prehash already computed on the double-buffered
                    # sub-mesh — the task skips re-hashing them
                    seed_digests=(pre_executed.digests
                                  if pre_executed is not None else None))
            if sparse_task is None:
                from .pipelined_root import PipelinedStateRoot

                root_job = PipelinedStateRoot(self.committer.hasher)
        if inflight is not None:
            inflight.sparse_task = sparse_task
        state_hook = (sparse_task or root_job).on_state_update
        self.last_prewarm = None  # bind the pass to THIS block only
        self.last_exec = None
        # --parallel-exec without a BAL hint: the optimistic scheduler
        # (engine/optimistic.py) replaces BOTH the prewarm pass and the
        # serial canonical execution — its speculative first attempt IS
        # the prewarm run (reads warm the shared cache and stream to the
        # sparse task), and validation-clean speculation commits instead
        # of being discarded and re-executed.
        use_opt = (self.parallel_exec and not self.bal_execution and speculate
                   and pre_executed is None
                   and len(block.transactions) >= self.prewarm_threshold)
        # prewarm: execute txs in parallel against PARENT state first,
        # purely to populate the execution cache (reference
        # payload_processor/prewarm.rs); canonical execution below then
        # runs against warm caches
        if (len(block.transactions) >= self.prewarm_threshold and not use_opt
                and speculate and pre_executed is None):
            from ..evm.executor import blob_base_fee
            from ..evm.interpreter import BlockEnv
            from .prewarm import PrewarmTask

            env = BlockEnv(
                number=header.number, timestamp=header.timestamp,
                coinbase=header.beneficiary, gas_limit=header.gas_limit,
                base_fee=header.base_fee_per_gas or 0,
                prev_randao=header.mix_hash, chain_id=self.config.chain_id,
                blob_base_fee=blob_base_fee(
                    header.excess_blob_gas or 0,
                    self.config.blob_params_for(
                        header.number, header.timestamp).update_fraction),
            )
            self.last_prewarm = PrewarmTask(
                executor, env, record_accesses=self.bal_execution,
                # seed the sparse task's multiproof prefetch from the
                # warming workers' touched keys (key-only, independent of
                # BAL): proof fetch overlaps PREWARM, not just canonical
                # execution. on_state_update dedupes and the trie-reveal
                # path tolerates speculative extras, so racy worker-side
                # duplicates are harmless.
                key_sink=(sparse_task.on_state_update
                          if sparse_task is not None else None))
            # started, NOT joined: the canonical pass below overlaps the
            # warming workers (speculative reads only touch the shared
            # mutex-guarded cache; canonical writes stay in its journal).
            # In BAL mode the pass is joined first instead — its recorded
            # access sets become the wave schedule.
            self.last_prewarm.start(block.transactions, senders)

        def _abort_root_job():
            if sparse_task is not None:
                sparse_task.abort()
            else:
                root_job.finish([])

        def _cancel_guard():
            # cooperative cancellation boundary: a forkchoiceUpdated that
            # reorged away from this block set the in-flight event (and
            # non-blockingly cancelled the sparse task); abort the root
            # job through the journaled path instead of letting it finish
            # against a dead head
            if inflight is not None and inflight.cancel.is_set():
                _abort_root_job()
                raise PayloadCancelled(
                    "forkchoice reorged away from in-flight block")

        use_bal = (self.bal_execution and self.last_prewarm is not None
                   and self.last_prewarm.record_accesses)
        t_exec0 = _time.monotonic()
        try:
            if pre_executed is not None:
                # cross-block pipeline adoption: execution already ran
                # over this parent's uncommitted overlay while it was
                # committing; feed the root task its touched keys in one
                # burst (digests were seeded above) and reuse the output
                with tracing.span("engine::tree", "adopt_speculation",
                                  txs=len(block.transactions),
                                  keys=len(pre_executed.keys)):
                    state_hook(pre_executed.keys)
                    out = pre_executed.out
                    self.last_exec = pre_executed.stats
                    if pre_executed.stats is not None:
                        self._record_exec_metrics(
                            optimistic=pre_executed.stats)
            else:
                with tracing.span("engine::execute", "execute",
                                  txs=len(block.transactions), bal=use_bal,
                                  optimistic=use_opt):
                    if use_bal:
                        from .bal import BlockAccessList, execute_block_bal

                        self.last_prewarm.join()
                        hint = BlockAccessList(entries=[
                            self.last_prewarm.accesses[i]
                            for i in sorted(self.last_prewarm.accesses)])
                        out, self.last_bal_stats = execute_block_bal(
                            executor.source, block, senders, hint, self.config,
                            state_hook=state_hook, block_hashes=hashes)
                        self._record_exec_metrics(bal=self.last_bal_stats)
                    elif use_opt:
                        from .optimistic import ExecCancelled, execute_block_optimistic

                        try:
                            out, self.last_exec = execute_block_optimistic(
                                executor.source, block, senders, self.config,
                                max_workers=self.exec_workers,
                                state_hook=state_hook, block_hashes=hashes,
                                cancel_event=(inflight.cancel
                                              if inflight is not None else None))
                        except ExecCancelled as e:
                            # the scheduler stopped its waves mid-round; the
                            # BaseException handler below aborts the root job
                            raise PayloadCancelled(str(e)) from e
                        self._record_exec_metrics(optimistic=self.last_exec)
                    else:
                        out = executor.execute(block, senders, hashes,
                                               state_hook=state_hook)
        except BaseException:
            _abort_root_job()  # never leak the worker thread
            if self.last_prewarm is not None:
                self.last_prewarm.join()
            raise
        if self.last_prewarm is not None:
            self.last_prewarm.join()
        if self.pipeline is not None:
            self.pipeline.note_exec_wall(
                pre_executed.exec_end - pre_executed.exec_start
                if pre_executed is not None
                else _time.monotonic() - t_exec0)
        _cancel_guard()
        try:
            with tracing.span("engine::tree", "post_validate"):
                self.consensus.validate_block_post_execution(
                    block, out.receipts, out.gas_used, requests=out.requests)
        except ConsensusError as e:
            _abort_root_job()
            self.invalid[block_hash] = str(e)
            self._run_invalid_hooks(block, str(e), out)
            return PayloadStatus(PayloadStatusKind.INVALID, None, str(e)), [], []
        # body + execution output into the overlay layer
        with tracing.span("engine::tree", "write_overlay"):
            overlay.insert_header(header)
            overlay.insert_block_body(block)
            idx = overlay.block_body_indices(n)
            for i, s in enumerate(senders):
                overlay.put_sender(idx.first_tx_num + i, s)
            write_execution_output(overlay, n, idx.first_tx_num, out)
        # hashed-state delta + state root (the state-root job)
        _cancel_guard()
        if self.pipeline is not None and inflight is not None:
            # publish the commit window: from here to the root verdict
            # only hashed/trie tables are written, so the frozen layer
            # snapshot is this block's complete plain-state effect — a
            # child payload arriving now speculates over it
            # (engine/block_pipeline.py; closed in _validate_and_insert)
            inflight.commit_win = self.pipeline.open_commit(
                block, block_hash, parent_layers or [], overlay.tx.layer)
        t0 = _time.time()
        with tracing.span("engine::tree", "state_root",
                          strategy=("sparse" if sparse_task is not None
                                    else "pipelined")):
            if sparse_task is not None:
                root = self._sparse_root_or_fallback(overlay, out, sparse_task)
            else:
                root = self._state_root_job(overlay, out, root_job)
        self._root_histogram.record(_time.time() - t0)
        self._blocks_counter.increment()
        if root != header.state_root:
            msg = (
                f"state root mismatch: computed {root.hex()} header "
                f"{header.state_root.hex()}"
            )
            self.invalid[block_hash] = msg
            self._run_invalid_hooks(block, msg, out, computed_root=root)
            return PayloadStatus(PayloadStatusKind.INVALID, None, msg), [], []
        with tracing.span("engine::tree", "finalize"):
            if (sparse_task is not None
                    and self.last_sparse.get("strategy") == "sparse"):
                # preserve only AFTER the root matched: a trie mutated by
                # an invalid block would poison the next payload's anchor
                sparse_task.preserve(block_hash)
                # same rule for the shared node cache: absorb the block's
                # committed spines + revealed read paths only once valid
                try:
                    sparse_task.absorb_into_cache(out)
                except Exception as e:  # noqa: BLE001 — cache population must
                    if is_kernel_fault(e):  # never fail a validated payload,
                        raise               # but a kernel fault still raises
            # advance the execution cache: invalidate this block's writes
            # and anchor the warm cache on the new tip
            self.execution_cache.on_block_applied(out.changes)
            self._cache_anchor = block_hash
        return PayloadStatus(PayloadStatusKind.VALID, block_hash), senders, out.receipts

    def _record_exec_metrics(self, bal=None, optimistic=None):
        """Surface the parallel-execution stats (exec_bal_* / exec_parallel_*
        counters + the events line's exec[...] segment)."""
        try:
            from ..metrics import exec_metrics

            if bal is not None:
                exec_metrics.record_bal(bal)
            if optimistic is not None:
                exec_metrics.record_optimistic(optimistic)
        except Exception:  # noqa: BLE001 — metrics must never fail consensus
            pass

    def _run_invalid_hooks(self, block, reason, out=None, computed_root=None):
        for hook in self.invalid_block_hooks:
            try:
                hook(block, reason, out=out, computed_root=computed_root)
            except Exception:  # noqa: BLE001 — diagnostics must never kill consensus
                pass

    def _state_root_job(self, overlay: DatabaseProvider, out, root_job=None) -> bytes:
        """Hash the block's state delta and commit the trie incrementally.

        Reference analogue: the SparseTrieCacheTask pipeline
        (state updates → proof targets → sparse trie → root,
        crates/engine/tree/src/tree/state_root_strategy/sparse_trie.rs).
        With a ``root_job`` (PipelinedStateRoot) most key digests were
        already computed concurrently with execution; only stragglers
        (e.g. withdrawal targets) hash here.
        """
        changes = out.changes
        addrs = sorted(set(changes.accounts) | set(changes.storage) | set(changes.wiped_storage))
        slot_pairs = [(a, s) for a, slots in out.post_storage.items() for s in slots]
        if root_job is not None:
            slot_keys = [s for _, s in slot_pairs]
            digest_map = root_job.finish(addrs + slot_keys)
            haddr = {a: digest_map[a] for a in addrs}
            hslots = [digest_map[s] for s in slot_keys]
        else:
            digests = self.committer.hasher(addrs + [s for _, s in slot_pairs])
            haddr = dict(zip(addrs, digests[: len(addrs)]))
            hslots = digests[len(addrs) :]
        hslot = {s: hs for (_, s), hs in zip(slot_pairs, hslots)}
        changed_accts, changed_storages, wiped_hashed = \
            self._write_hashed_tables(overlay, out, haddr, hslot)
        inc = IncrementalStateRoot(overlay, self.committer)
        return inc.compute(changed_accts, changed_storages, wiped_hashed)

    def _write_hashed_tables(self, overlay: DatabaseProvider, out,
                             haddr, hslot):
        """Hashed-table writes shared by BOTH root strategies (the live-tip
        equivalent of the hashing stages) — one code path so the sparse and
        incremental strategies can never write different hashed state.
        Returns (changed_hashed_accounts, changed_hashed_storages,
        wiped_hashed) for the incremental committer."""
        changes = out.changes
        addrs = sorted(set(changes.accounts) | set(changes.storage)
                       | set(changes.wiped_storage))
        for a in addrs:
            if a in out.post_accounts:
                overlay.put_hashed_account(haddr[a], out.post_accounts[a])
        wiped_hashed = set()
        for a in changes.wiped_storage:
            wiped_hashed.add(haddr[a])
            overlay.clear_hashed_storage(haddr[a])
        changed_hashed_storages: dict[bytes, set[bytes]] = {}
        for a, slots in out.post_storage.items():
            for s, v in slots.items():
                overlay.put_hashed_storage(haddr[a], hslot[s], v)
                changed_hashed_storages.setdefault(haddr[a], set()).add(hslot[s])
        changed_hashed_accounts = {haddr[a] for a in changes.accounts}
        return changed_hashed_accounts, changed_hashed_storages, wiped_hashed

    def _start_sparse_root(self, block: Block, parent_layers,
                           trace_ctx=None, seed_digests=None):
        """Launch the background sparse-trie root task over the PARENT
        view (its proof worker reads concurrently with execution, so it
        gets its own transaction + overlay — never the in-progress layer).

        Reference analogue: spawning SparseTrieCacheTask per payload
        (crates/engine/tree, sparse-trie state-root strategy).
        """
        from .sparse_root import SparseRootTask

        if parent_layers is None:
            return None

        def parent_view() -> DatabaseProvider:
            # each proof worker gets its OWN transaction over the same
            # frozen parent layers: cursor state is per-tx, the layer
            # dicts are immutable once the parent validated
            return DatabaseProvider(
                OverlayTx(self.factory.db.tx(), parent_layers))

        parent_provider = parent_view()
        try:
            parent = self._header_of(block.header.parent_hash, parent_provider)
        except ConsensusError:
            # an unknown parent header: the pipelined+incremental path
            # covers it (the reference also takes it on any other startup
            # failure, which in the port would hide a kernel fault)
            return None
        return SparseRootTask(
            parent_provider, parent.state_root, self.preserved_trie,
            self.committer, parent_hash=block.header.parent_hash,
            provider_factory=parent_view, workers=self.sparse_workers,
            trace_ctx=trace_ctx, seed_digests=seed_digests,
            hot_cache=self.hot_cache, arena=self.hot_arena)

    def _sparse_root_or_fallback(self, overlay: DatabaseProvider, out,
                                 task) -> bytes:
        """Close the sparse root job; on any SparseRootError rerun the
        block's root with the incremental committer (reference
        `state_root_fallback` in the engine-primitives config).
        All overlay writes happen only after the sparse path fully
        succeeded, so the fallback starts from a clean layer."""
        from .sparse_root import SparseRootError

        try:
            root, digest_map, storage_roots = task.finish(out)
            acct_updates, storage_updates = task.export_updates(out, digest_map)
        except SparseRootError as e:
            if getattr(task, "cancelled", False):
                # a forkchoice reorg cancelled the task mid-finish: do
                # NOT fall back — the incremental committer would just
                # finish the same dead head's root the slow way
                raise PayloadCancelled(str(e)) from e
            if is_kernel_fault(e):
                raise  # a kernel fault is not the reference's fallback cause
            self.sparse_fallbacks += 1
            self.last_sparse = {"strategy": "fallback", "error": str(e)}
            return self._state_root_job(overlay, out, None)
        self.last_sparse = {
            "strategy": "sparse", "reused": task.reused,
            "proof_batches": task.proof_batches,
            **task.overlap_metrics(),
        }
        try:
            from ..metrics import REGISTRY

            m = self.last_sparse
            REGISTRY.counter("sparse_root_blocks_total").increment()
            REGISTRY.histogram("sparse_root_overlap_fraction").record(
                m["overlap_fraction"])
            REGISTRY.histogram("sparse_root_proof_seconds").record(m["proof"])
            REGISTRY.histogram("sparse_root_reveal_seconds").record(m["reveal"])
            REGISTRY.histogram("sparse_root_finish_seconds").record(m["finish"])
            from ..metrics import sparse_commit_metrics

            cs = m.get("commit")
            if cs:
                sparse_commit_metrics.record_block(
                    dispatches=cs.get("dispatches", 0),
                    finish_s=m["finish"])
        except Exception:  # noqa: BLE001 — metrics must never fail consensus
            pass
        self._write_sparse_output(overlay, out, digest_map, storage_roots,
                                  acct_updates, storage_updates)
        return root

    def _write_sparse_output(self, overlay: DatabaseProvider, out,
                             digest_map, storage_roots,
                             acct_updates, storage_updates) -> None:
        """Mirror the sparse job's results into the overlay layer: hashed
        tables (live-tip equivalent of the hashing stages) and stored
        branch nodes straight from the sparse trie — no DB re-walk
        (reference: sparse trie TrieUpdates application)."""
        changes = out.changes
        addrs = sorted(set(changes.accounts) | set(changes.storage)
                       | set(changes.wiped_storage))
        haddr = {a: digest_map[a] for a in addrs}
        self._write_hashed_tables(overlay, out, haddr, digest_map)
        # merkle-layer invariant: HashedAccounts carries the CURRENT root
        for a, sroot in storage_roots.items():
            acct = overlay.hashed_account(haddr[a])
            if acct is not None and acct.storage_root != sroot:
                overlay.put_hashed_account(
                    haddr[a], acct.with_(storage_root=sroot),
                    preserve_storage_root=False)
        # wiped storage tries: drop every stale stored branch first; the
        # recreated trie's updates (if any) follow below
        for a in changes.wiped_storage:
            overlay.delete_storage_branches_with_prefix(haddr[a], b"")
        for path, node in acct_updates.items():
            if node is None:
                overlay.delete_account_branch(path)
            else:
                overlay.put_account_branch(path, node)
        for ha, upd in storage_updates.items():
            for path, node in upd.items():
                if node is None:
                    overlay.delete_storage_branch(ha, path)
                else:
                    overlay.put_storage_branch(ha, path, node)

    # -- forkchoice ------------------------------------------------------------

    def on_forkchoice_updated(
        self, head: bytes, safe: bytes | None = None, finalized: bytes | None = None
    ) -> PayloadStatus:
        if self.fenced:
            return PayloadStatus(PayloadStatusKind.INVALID, None,
                                 f"fenced: {self.fence_reason}")
        reason = self.invalid.get(head)
        if reason is not None:
            return PayloadStatus(PayloadStatusKind.INVALID, None, reason)
        # a forkchoice that reorgs away from the insert currently in
        # flight aborts its speculative machinery (sparse root task,
        # proof-pool shards, optimistic waves) instead of racing it
        self._cancel_inflight_for(head)
        if self.pipeline is not None:
            # same ladder for the cross-block speculation: an fcU that
            # reorgs past the speculated block's parent aborts it
            self.pipeline.on_forkchoice(head)
        if head == self.persisted_hash:
            return self._set_head(head)
        if head in self.blocks and self._chain_layers(head) is not None:
            return self._set_head(head)
        # head may be an old persisted canonical block (CL rewind) or reach
        # the canonical chain below the persisted tip via buffered blocks —
        # both need the persisted chain unwound to the branch point.
        branch = self._find_persisted_branch_point(head)
        if branch is None:
            return PayloadStatus(PayloadStatusKind.SYNCING)
        branch_number, replay = branch
        if self.unwinder is None:
            return PayloadStatus(PayloadStatusKind.SYNCING)
        self._unwind_persisted_to(branch_number)
        for blk in replay:
            st = self.on_new_payload(blk)
            if st.status is not PayloadStatusKind.VALID:
                return st
        if head in self.blocks or head == self.persisted_hash:
            return self._set_head(head)
        return PayloadStatus(PayloadStatusKind.SYNCING)

    def _set_head(self, head: bytes) -> PayloadStatus:
        old_head = self.head_hash
        depth = self._reorg_depth(old_head, head)
        self.head_hash = head
        if depth > 0:
            self._record_reorg(depth)
        # persist first so listeners (pool maintenance, static-file
        # producer, pruner) observe the advanced persisted state
        self._advance_persistence()
        if old_head != head:
            self._notify_canon_change()
            if self.fcu_listeners:
                eb = self.blocks.get(head)
                number = (eb.number if eb is not None
                          else self.persisted_number)
                for listener in list(self.fcu_listeners):
                    try:
                        listener(number, head)
                    except Exception:  # noqa: BLE001 - sinks never gate
                        pass
        return PayloadStatus(PayloadStatusKind.VALID, head)

    # -- consensus robustness --------------------------------------------------

    def _cancel_inflight_for(self, head: bytes) -> None:
        """Cancel the in-flight insert when ``head`` reorgs away from it
        (i.e. the new head neither IS the in-flight block nor extends its
        parent chain). Non-blocking: sets the cooperative event and asks
        the sparse task to stop at its next batch boundary; the insert
        thread runs the journaled aborts and reports SYNCING."""
        with self._inflight_lock:
            inflight = self._inflight
        if inflight is None or head == inflight.block_hash:
            return
        if self._extends(head, inflight.parent_hash):
            return
        if inflight.cancel.is_set():
            return
        inflight.cancel.set()
        task = inflight.sparse_task
        if task is not None:
            task.cancel()
        tree_metrics.payload_cancelled()
        tracing.event("engine::tree", "inflight_cancelled",
                      block=inflight.block_hash.hex()[:16],
                      new_head=head.hex()[:16])

    def _extends(self, head: bytes, target: bytes) -> bool:
        """Is ``target`` on ``head``'s chain (head included)? Unknown
        heads answer True — an fcU that only returns SYNCING performed
        no reorg, so it must not cancel anything."""
        if target == head:
            return True
        h = head
        while h != self.persisted_hash:
            eb = self.blocks.get(h)
            if eb is None:
                break
            h = eb.parent_hash
            if h == target:
                return True
        if h == self.persisted_hash:
            # head roots in the persisted canonical chain: every
            # persisted canonical block at or below the tip is an ancestor
            if target == self.persisted_hash:
                return True
            with self.factory.provider() as p:
                n = p.block_number(target)
                return (n is not None and n <= self.persisted_number
                        and p.canonical_hash(n) == target)
        with self.factory.provider() as p:
            hn = p.block_number(head)
            if hn is None or p.canonical_hash(hn) != head:
                return True  # unknown head: no reorg happens
            tn = p.block_number(target)
            return (tn is not None and tn <= hn
                    and p.canonical_hash(tn) == target)

    def _reorg_depth(self, old_head: bytes, new_head: bytes) -> int:
        """Blocks abandoned off the old canonical chain by switching to
        ``new_head`` (0 when the new head extends the old one)."""
        if old_head == new_head:
            return 0
        on_new = {new_head, self.persisted_hash}
        h = new_head
        while h != self.persisted_hash:
            eb = self.blocks.get(h)
            if eb is None:
                break
            h = eb.parent_hash
            on_new.add(h)
        depth = 0
        h = old_head
        while h not in on_new:
            eb = self.blocks.get(h)
            if eb is None:
                break
            depth += 1
            h = eb.parent_hash
        return depth

    def _record_reorg(self, depth: int, deep: bool = False) -> None:
        tree_metrics.record_reorg(depth, deep=deep)
        if self.reorgs.record(depth):
            # pathological churn: dump the flight recorder once per
            # storm (rate-limited) and engage the speculation backoff
            tree_metrics.storm()
            tracing.fault_event("TREE_REORG_STORM", target="engine::tree",
                                depth=depth, reorgs=self.reorgs.reorgs,
                                max_depth=self.reorgs.max_depth)
            # the hot-state plane is speculative state too: churn is
            # exactly what thrashes it, so it stands down with the rest
            self._invalidate_hot_state("reorg_storm")
        self.reorgs.in_backoff()  # refresh the gauge

    def _invalidate_hot_state(self, reason: str) -> None:
        """Wholesale hot-state invalidation (deep reorg / reorg storm):
        validation-at-lookup already guarantees no stale node can serve,
        so this is about not paying churn-thrashed miss storms — and
        about the arena's leak invariant across unwinds."""
        if self.hot_cache is not None:
            self.hot_cache.clear(reason)
        if self.hot_arena is not None:
            self.hot_arena.invalidate(reason)

    def _find_persisted_branch_point(self, head: bytes):
        """If ``head`` connects to a persisted canonical block below the tip
        (directly or via buffered blocks), return (branch_number, replay
        chain oldest-first); else None."""
        replay: list[Block] = []
        h = head
        with self.factory.provider() as p:
            while True:
                n = p.block_number(h)
                if n is not None and p.canonical_hash(n) == h:
                    return (n, list(reversed(replay)))
                blk = self.buffered.get(h)
                if blk is None:
                    eb = self.blocks.get(h)
                    if eb is None:
                        return None
                    blk = eb.block
                replay.append(blk)
                h = blk.header.parent_hash

    def _unwind_persisted_to(self, number: int) -> None:
        """Unwind the persisted chain to ``number`` (reference: engine →
        backfill pipeline unwind on deep reorgs, stages pipeline)."""
        # durable unwind intent BEFORE the first stage commit: the
        # pipeline unwinds with one commit per stage, so a crash anywhere
        # inside leaves ragged checkpoints — the marker tells startup
        # recovery the exact target to finish the job at (cleared
        # atomically with the canonical surgery below)
        from ..storage.recovery import UNWIND_MARKER_KEY

        # reorg accounting BEFORE surgery: everything above the branch
        # point on the current canonical chain is being abandoned
        eb = self.blocks.get(self.head_hash)
        head_number = eb.number if eb is not None else self.persisted_number
        with self.factory.provider_rw() as p:
            p.tx.put(Tables.Metadata.name, UNWIND_MARKER_KEY,
                     number.to_bytes(8, "big"))
        self.unwinder(self.factory, number)
        # crash window drilled by chaos.py: the pipeline unwind committed
        # but the canonical-header surgery below did not — startup
        # recovery heals it by completing the unwind to the marker target
        # (storage/recovery.py)
        crash_point("unwind")
        # drop unwound canonical blocks' header index
        with self.factory.provider_rw() as p:
            old_tip = p.last_block_number()
            for n in range(number + 1, old_tip + 1):
                bh = p.canonical_hash(n)
                if bh:
                    p.tx.delete(Tables.CanonicalHeaders.name, (n).to_bytes(8, "big"))
                    p.tx.delete(Tables.Headers.name, (n).to_bytes(8, "big"))
                    p.tx.delete(Tables.HeaderNumbers.name, bh)
            p.tx.delete(Tables.Metadata.name, UNWIND_MARKER_KEY)
        with self.factory.provider() as p:
            self.persisted_number = number
            self.persisted_hash = p.canonical_hash(number)
        self.head_hash = self.persisted_hash
        # in-memory tree entries built on the old chain are now stale
        self.blocks.clear()
        self.preserved_trie.invalidate()
        self._invalidate_hot_state("deep_reorg")
        self._record_reorg(max(0, head_number - number), deep=True)
        # the unwound shape is a durability boundary too: a crash after a
        # reorg must never resurrect the unwound chain
        self._durability_boundary()

    def _notify_canon_change(self):
        chain = [self.blocks[h] for h in self.canonical_chain()]
        for listener in self.canon_listeners:
            try:
                listener(chain)
            except Exception:  # noqa: BLE001 — a telemetry/maintenance
                # listener must never fail consensus-critical
                # canonicalization (reference notifications are decoupled
                # channels for the same reason)
                continue

    # -- persistence -----------------------------------------------------------

    def _advance_persistence(self):
        """Persist canonical blocks deeper than the threshold, prune tree.

        Reference analogue: `advance_persistence` + the persistence thread
        (crates/engine/tree/src/persistence.rs): apply layers to the DB,
        move stage checkpoints, drop persisted/abandoned tree nodes.
        """
        chain = self.canonical_chain()
        if len(chain) <= self.persistence_threshold:
            return
        to_persist = chain[: len(chain) - self.persistence_threshold]
        with self.factory.provider_rw() as p:
            for h in to_persist:
                apply_layer(p.tx, self.blocks[h].layer)
            top = self.blocks[to_persist[-1]].number
            # history indices run at persistence time (the engine path skips
            # the pipeline, but changesets are in the layers)
            from ..stages import IndexAccountHistoryStage, IndexStorageHistoryStage
            from ..stages.api import ExecInput

            for stage_obj in (IndexStorageHistoryStage(), IndexAccountHistoryStage()):
                cp = p.stage_checkpoint(stage_obj.id)
                if cp < top:
                    stage_obj.execute(p, ExecInput(top, cp))
            for stage in ("SenderRecovery", "Execution", "MerkleUnwind",
                          "AccountHashing", "StorageHashing", "MerkleExecute",
                          "TransactionLookup", "IndexStorageHistory",
                          "IndexAccountHistory", "Finish"):
                p.save_stage_checkpoint(stage, top)
        # crash window drilled by chaos.py: the persistence transaction
        # committed (and, with a WAL, is fsync-durable) but none of the
        # in-memory bookkeeping below ran — restart must recover to the
        # just-persisted head
        crash_point("advance-persistence")
        last = self.blocks[to_persist[-1]]
        self.persisted_number = last.number
        self.persisted_hash = last.hash
        # prune: drop persisted blocks and stale forks below the new root
        for h in to_persist:
            self.blocks.pop(h, None)
        for h in [h for h, eb in self.blocks.items() if eb.number <= self.persisted_number]:
            self.blocks.pop(h, None)
        self._durability_boundary()

    def _durability_boundary(self):
        """Make everything persisted so far crash-durable.

        With a WAL attached (``self.durability``) commits are already
        fsync'd record-by-record; this notifies the manager so it can
        truncate the log via a checkpoint. Without one, a store exposing
        ``flush`` gets its image written here — durability then tracks
        the persistence threshold instead of process lifetime (the old
        behavior flushed only in ``Node.stop``).
        """
        if self.durability is not None:
            try:
                self.durability.on_persisted(self.persisted_number,
                                             self.persisted_hash)
                return
            except Exception:  # noqa: BLE001 - a failed checkpoint must not
                # fail consensus; per-commit WAL records still hold
                import traceback

                traceback.print_exc()
                return
        db = self.factory.db
        # native/paged engines: sync() is the cheap power-loss durability
        # point (fsync, no compaction); image-backed stores rewrite the
        # image — either way, prefer the light call when one exists
        op = getattr(db, "sync", None) or getattr(db, "flush", None)
        if op is not None:
            try:
                op()
            except Exception:  # noqa: BLE001 - durability best-effort here;
                # consensus state is already committed
                import traceback

                traceback.print_exc()
