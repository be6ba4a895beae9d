"""Cross-block import pipeline: execute block N+1 while block N commits.

A copy of the JAX package's ``engine/block_pipeline.py`` on the port's modules.
When the committer's hash service has a mesh (``HashService(mesh=)`` over a
``parallel.HashMesh``), the speculation takes a sub-mesh lease
(``pipeline_lease``) and prehashes on the leased members; without one it
prehashes on the proof lane (or the committer's hasher), as the reference
does. A failed prehash batch is counted
(``prehash_failed``) and its keys hash again at adoption on the same
device; a failed build of the native core raises.

The engine imports one block at a time; with the commit dispatches
collapsed into whole-subtrie kernels the remaining back-to-back wall is
the *serialization* of execution and commitment across the block
boundary.  This module overlaps them, two deep:

* When block N's insert reaches its state-root phase the tree publishes
  a **commit window** — N's identity plus a frozen snapshot of its
  uncommitted plain-state overlay layer (header/body/exec output; the
  commit phase itself only writes the *hashed*/trie tables, so the
  snapshot is complete for execution purposes the moment it is taken).
* If ``on_new_payload(N+1)`` arrives while that window is open, the
  transport thread does not buffer-and-SYNCING: it **speculates** —
  optimistic execution (engine/optimistic.py) of N+1 over a merged
  overlay of N's ancestors plus N's uncommitted write set, with the
  touched keys pre-hashed concurrently on a double-buffered sub-mesh
  (ops/hash_service.py ``pipeline_lease``) while N's commit dispatches
  keep the remaining devices.
* When N's window closes VALID, the speculative output is **adopted**:
  N+1 re-enters the normal insert path with its execution pre-done and
  its key digests pre-hashed, so only post-validation + its own commit
  remain.  Roots stay bit-identical to serial import by construction —
  nothing speculative is ever written; adoption feeds the standard
  root/consensus checks exactly as a fresh execution would.
* If N's root mismatches, N turns out INVALID, or an fcU reorgs past
  the speculation, the abort ladder (the tree's cooperative-cancellation
  substrate: cancel events → ``ExecCancelled`` at wave boundaries)
  discards the speculation and N+1 falls back to the normal
  buffer/replay path — it is never wrongly marked INVALID.

Reference analogue: reth's in-flight payload processing overlapping the
persistence service across blocks (crates/engine/tree), lifted to full
execute-while-commit as in the Reddio async-storage design
(arxiv 2503.04595), one level up the stack.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from .. import tracing
from ..metrics import block_pipeline_metrics
from ..ops._build import BuildError
from ..storage.overlay import Layer, OverlayTx
from ..storage.provider import DatabaseProvider


@dataclass
class CommitWindow:
    """Block N's commit-in-progress handle: identity + the frozen
    overlay snapshot a speculative child executes over."""

    block: object                      # primitives Block
    block_hash: bytes
    parent_hash: bytes
    number: int
    parent_layers: list[Layer]         # N's ancestors (frozen)
    exec_layer: Layer                  # N's plain-state writes (frozen copy)
    opened: float = field(default_factory=time.monotonic)
    closed: float | None = None
    ok: bool | None = None
    done: threading.Event = field(default_factory=threading.Event)

    @property
    def wall(self) -> float:
        end = self.closed if self.closed is not None else time.monotonic()
        return max(0.0, end - self.opened)


@dataclass
class _Speculation:
    """The one in-flight speculative execution (N+1 over N's window)."""

    block_hash: bytes
    parent_hash: bytes
    cancel: threading.Event = field(default_factory=threading.Event)
    abort_reason: str | None = None


@dataclass
class SpeculationResult:
    """A finished speculative execution, ready for adoption by the
    normal insert path once the parent's window closes VALID."""

    out: object                        # ExecutionOutput
    stats: object                      # optimistic scheduler stats (or None)
    senders: list[bytes]
    keys: list                         # touched keys, first-seen order
    digests: dict[bytes, bytes]        # pre-hashed key digests
    cache: object                      # warmed ExecutionCache
    exec_start: float = 0.0
    exec_end: float = 0.0


class _SpecPrehash:
    """Background key pre-hash for the speculative block: drains batches
    of touched keys and keccaks them on the double-buffered sub-mesh
    (when leased) or the proof lane, so the adopted sparse task starts
    with its digest map already populated."""

    def __init__(self, hasher, min_batch: int = 64):
        self._hasher = hasher
        self._min_batch = min_batch
        self._pending: list = []
        self._seen: set = set()
        self.digests: dict[bytes, bytes] = {}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._stop = False
        self._failed = False
        self.batches_failed = 0  # batches whose hash call raised
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, keys) -> None:
        if self._failed:
            return
        with self._cond:
            fresh = [k for k in keys if k not in self._seen]
            if not fresh:
                return
            self._seen.update(fresh)
            self._pending.extend(fresh)
            self._cond.notify()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._stop:
                    self._cond.wait()
                batch, self._pending = self._pending, []
                if not batch and self._stop:
                    return
            # flatten (addr, slot) pairs: both legs hash independently
            msgs: list[bytes] = []
            for k in batch:
                if isinstance(k, tuple):
                    msgs.extend(k)
                else:
                    msgs.append(k)
            msgs = [m for m in dict.fromkeys(msgs) if m not in self.digests]
            if msgs:
                try:
                    for m, d in zip(msgs, self._hasher(msgs)):
                        self.digests[m] = bytes(d)
                except Exception:  # noqa: BLE001 — prehash is best-effort:
                    # a failed batch just means the sparse task hashes
                    # those keys itself at adoption, on the same device;
                    # counted in BlockPipeline.prehash_failed
                    self.batches_failed += 1
                    self._failed = True
                    return

    def finish(self, timeout: float = 10.0) -> dict[bytes, bytes]:
        with self._cond:
            self._stop = True
            self._cond.notify()
        self._thread.join(timeout)
        return {} if self._failed else dict(self.digests)


class BlockPipeline:
    """Two-deep cross-block import pipeline attached to an EngineTree.

    The tree calls :meth:`open_commit` / :meth:`close_commit` around its
    state-root phase and :meth:`try_speculate` from ``on_new_payload``
    when a payload's parent is the block currently committing.
    """

    def __init__(self, tree, depth: int = 2, wait_s: float = 300.0):
        self.tree = tree
        # depth 1 = serial (the tree does not construct a pipeline then);
        # anything >= 2 currently means one speculation deep — the window
        # snapshot chains are not stacked further yet
        self.depth = max(2, int(depth))
        self.wait_s = wait_s
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._window: CommitWindow | None = None
        self._spec: _Speculation | None = None
        self._recent_closed: dict[bytes, bool] = {}
        # bench/test accounting (monotonic totals; metrics mirror them)
        self.speculations = 0
        self.adopted = 0
        self.aborted = 0
        self.abort_reasons: dict[str, int] = {}
        self.exec_wall_s = 0.0       # execution wall seen by the tree
        self.commit_wall_s = 0.0     # commit-window wall (open→close)
        self.overlap_wall_s = 0.0    # speculative exec inside a window
        self.last_overlap_fraction = 0.0
        self.leases_active = 0
        self.prehash_failed = 0      # speculative prehash batches that raised
        # commit-window observers beyond the tree itself: the continuous
        # block producer subscribes so N+1's candidate starts building the
        # moment N's window opens (called OUTSIDE the pipeline lock)
        self.open_listeners: list = []
        block_pipeline_metrics.set_depth(self.depth)

    # -- commit window (called from the insert thread) ----------------------

    def open_commit(self, block, block_hash: bytes,
                    parent_layers: list[Layer], layer: Layer) -> CommitWindow:
        """Publish block N's commit-in-progress: freeze a shallow copy of
        its overlay layer (taken synchronously on the insert thread,
        BEFORE the commit phase starts writing hashed/trie tables, so no
        concurrent mutation can race the copy)."""
        exec_layer: Layer = {t: dict(kv) for t, kv in layer.items()}
        win = CommitWindow(block=block, block_hash=block_hash,
                           parent_hash=block.header.parent_hash,
                           number=block.header.number,
                           parent_layers=list(parent_layers or []),
                           exec_layer=exec_layer)
        with self._cond:
            self._window = win
            self._cond.notify_all()
        block_pipeline_metrics.window_opened()
        for fn in list(self.open_listeners):
            try:
                fn(win)
            except Exception:  # noqa: BLE001 — an observer must never
                pass           # stall the insert thread
        return win

    def current_window(self):
        """The commit window currently open, or None."""
        with self._lock:
            return self._window

    def close_commit(self, win: CommitWindow, ok: bool) -> None:
        """Close N's window (idempotent; called on EVERY insert exit
        path). ``ok`` means N is VALID *and* visible in ``tree.blocks``
        — only then may a speculation be adopted on top of it."""
        with self._cond:
            if win.done.is_set():
                return
            win.ok = ok
            win.closed = time.monotonic()
            win.done.set()
            if self._window is win:
                self._window = None
            self._recent_closed[win.block_hash] = ok
            while len(self._recent_closed) > 16:
                self._recent_closed.pop(next(iter(self._recent_closed)))
            spec = self._spec
            self.commit_wall_s += win.wall
            self._cond.notify_all()
        if not ok and spec is not None and spec.parent_hash == win.block_hash:
            # N failed: stop the speculative waves at their next boundary
            # instead of letting them finish for a dead parent
            self._abort_spec(spec, "parent_invalid")
        block_pipeline_metrics.window_closed(ok, win.wall)

    def note_exec_wall(self, seconds: float) -> None:
        """The tree reports each block's execution wall (serial or
        speculative) so the bench can compare overlap against legs."""
        self.exec_wall_s += seconds

    # -- abort ladder -------------------------------------------------------

    def _abort_spec(self, spec: _Speculation, reason: str) -> None:
        if spec.abort_reason is None:
            spec.abort_reason = reason
        spec.cancel.set()

    def on_forkchoice(self, head: bytes) -> None:
        """A forkchoiceUpdated landed: if it reorgs past the in-flight
        speculation (the new head neither IS the speculated block, nor
        its committing parent, nor extends that parent), abort it
        cooperatively — ExecCancelled at the next wave boundary."""
        with self._lock:
            spec = self._spec
        if spec is None:
            return
        if head in (spec.block_hash, spec.parent_hash):
            return
        if self.tree._extends(head, spec.parent_hash):
            return
        self._abort_spec(spec, "fcu_reorg")
        tracing.event("engine::pipeline", "speculation_cancelled",
                      block=spec.block_hash.hex()[:16],
                      new_head=head.hex()[:16])

    # -- speculation (called from the payload transport thread) -------------

    def try_speculate(self, block) -> object | None:
        """Payload N+1 arrived while its parent N commits: execute it
        speculatively over N's uncommitted overlay, wait for N's window
        to close, and adopt the result through the normal insert path.

        Returns a PayloadStatus when the pipeline fully handled the
        payload, or None to fall back to the normal buffer/SYNCING path
        (never an INVALID of its own — only the normal path judges)."""
        tree = self.tree
        if tree.reorgs.in_backoff():
            return None  # reorg storm: speculation is what the churn thrashes
        with self._cond:
            win = self._window
            if (win is None or win.done.is_set()
                    or win.block_hash != block.header.parent_hash
                    or self._spec is not None):
                return None
            spec = _Speculation(block_hash=block.hash,
                                parent_hash=win.block_hash)
            self._spec = spec
        self.speculations += 1
        block_pipeline_metrics.speculation_started()
        tracing.event("engine::pipeline", "speculation_started",
                      block=spec.block_hash.hex()[:16],
                      parent=spec.parent_hash.hex()[:16])
        lease = self._acquire_lease()
        result = None
        try:
            result = self._speculate(block, win, spec, lease)
        finally:
            if lease is not None:
                lease.release()
                with self._lock:
                    self.leases_active -= 1
        if result is None:
            return self._finish_abort(spec)
        # wait for N's verdict; the speculative work is done, so this
        # wait is the residue of commit-minus-exec, not added latency
        win.done.wait(self.wait_s)
        if spec.cancel.is_set() or not win.done.is_set() or not win.ok:
            if not win.done.is_set():
                self._abort_spec(spec, "parent_timeout")
            elif spec.abort_reason is None:
                self._abort_spec(spec, "parent_invalid")
            return self._finish_abort(spec)
        parent_layers = tree._chain_layers(block.header.parent_hash)
        if parent_layers is None:
            self._abort_spec(spec, "parent_missing")
            return self._finish_abort(spec)
        # adopt: re-enter the normal insert with execution pre-done; all
        # consensus/root checks run exactly as a fresh execution's would.
        # The speculation slot clears FIRST — the adoption insert opens
        # its own commit window, and the NEXT payload must be able to
        # speculate over it (that chaining is the whole pipeline); fcU
        # aborts from here on ride the normal in-flight insert machinery
        with self._lock:
            self._spec = None
        st = tree._validate_and_insert(block, parent_layers,
                                       pre_executed=result)
        self.adopted += 1
        overlap = max(0.0, min(result.exec_end, win.closed)
                      - result.exec_start)
        frac = overlap / win.wall if win.wall > 1e-9 else 0.0
        self.overlap_wall_s += overlap
        self.last_overlap_fraction = frac
        block_pipeline_metrics.speculation_adopted(frac)
        tracing.event("engine::pipeline", "speculation_adopted",
                      block=spec.block_hash.hex()[:16],
                      overlap_fraction=round(frac, 3))
        return st

    def _finish_abort(self, spec: _Speculation):
        with self._lock:
            self._spec = None
        reason = spec.abort_reason or "exec_error"
        self.aborted += 1
        self.abort_reasons[reason] = self.abort_reasons.get(reason, 0) + 1
        block_pipeline_metrics.speculation_aborted(reason)
        tracing.event("engine::pipeline", "speculation_aborted",
                      block=spec.block_hash.hex()[:16], reason=reason)
        return None

    def _acquire_lease(self):
        """Double-buffer: carve a sub-mesh for the speculative side's
        prehash dispatches; the committing block's lanes re-form over the
        remaining devices. No mesh (or exhausted) → run without."""
        svc = getattr(self.tree.committer, "hash_service", None)
        if svc is None or getattr(svc, "mesh", None) is None:
            return None
        try:
            lease = svc.pipeline_lease()
        except Exception:  # noqa: BLE001 — the lease is an optimization
            return None
        if lease is not None:
            with self._lock:
                self.leases_active += 1
            block_pipeline_metrics.lease_taken(lease.devices)
        return lease

    def _speculate(self, block, win: CommitWindow, spec: _Speculation,
                   lease) -> SpeculationResult | None:
        """Execute ``block`` over its parent's uncommitted overlay.
        Returns None (with spec.abort_reason set) on any failure — the
        normal path re-runs and judges the payload then."""
        tree = self.tree
        header = block.header
        # the speculative stage starts HERE: prevalidation, sender
        # recovery, and overlay setup are all work the serial import
        # would do after N's commit — count them in the overlap
        t0 = time.monotonic()
        wall_t0 = time.time()  # span timestamps are wall-clock
        try:
            tree.consensus.validate_header_against_parent(
                header, win.block.header)
            tree.consensus.validate_block_pre_execution(block)
        except Exception:  # noqa: BLE001 — let the normal path report it
            self._abort_spec(spec, "prevalidate")
            return None
        from ..primitives.types import recover_senders

        senders = recover_senders(block.transactions)
        if any(s is None for s in senders):
            self._abort_spec(spec, "prevalidate")
            return None
        # merged overlay: N's ancestors + N's uncommitted-but-known
        # write set (the frozen snapshot), newest layer last
        layers = win.parent_layers + [win.exec_layer]
        overlay = DatabaseProvider(
            OverlayTx(tree.factory.db.tx(), layers))
        hashes = {}
        for k in range(max(0, header.number - 256), header.number):
            bh = overlay.canonical_hash(k)
            if bh:
                hashes[k] = bh
        from ..evm.executor import ProviderStateSource
        from .execution_cache import CachedStateSource, ExecutionCache

        cache = ExecutionCache()
        source = CachedStateSource(ProviderStateSource(overlay), cache)
        hasher = lease.hash if lease is not None else self._lane_hasher()
        prehash = _SpecPrehash(hasher)
        keys: list = []
        seen: set = set()

        def state_hook(batch):
            fresh = [k for k in batch if k not in seen]
            if not fresh:
                return
            seen.update(fresh)
            keys.extend(fresh)
            prehash.submit(fresh)

        try:
            out, stats = self._execute(block, senders, source, hashes,
                                       state_hook, spec)
        except _SpecAborted as e:
            self._abort_spec(spec, e.reason)
            prehash.finish(timeout=1.0)
            self.prehash_failed += prehash.batches_failed
            return None
        t1 = time.monotonic()
        digests = prehash.finish()
        self.prehash_failed += prehash.batches_failed
        # the speculative window as a span on N+1's (future) timeline:
        # debug_blockTimeline then shows it overlapping N's state_root.
        # The timeline must be pre-registered — this span lands before
        # N+1's own trace_block opens — and the span carries a synthetic
        # parent id so it never shadows the lifecycle root in summaries.
        tracing.ensure_timeline(block.hash.hex())
        tracing.record_span(
            "engine::pipeline", "speculate.exec", wall_t0, t1 - t0,
            ctx=tracing.TraceContext(block.hash.hex(), "speculation"),
            fields={"txs": len(block.transactions),
                    "parent": win.block_hash.hex()[:16]})
        return SpeculationResult(out=out, stats=stats, senders=senders,
                                 keys=keys, digests=digests, cache=cache,
                                 exec_start=t0, exec_end=t1)

    def _lane_hasher(self):
        committer = self.tree.committer
        if getattr(committer, "hash_service", None) is not None \
                and hasattr(committer, "for_lane"):
            return committer.for_lane("proof").hasher
        return committer.hasher

    def _execute(self, block, senders, source, hashes, state_hook, spec):
        """Run the speculative execution: the optimistic scheduler
        (its speculative first attempt doubles as the prewarm + key
        stream), serial executor for tiny blocks; the spec's cancel
        event aborts at wave boundaries."""
        tree = self.tree
        from .optimistic import ExecCancelled, execute_block_optimistic

        try:
            if len(block.transactions) >= 2:
                return execute_block_optimistic(
                    source, block, senders, tree.config,
                    max_workers=tree.exec_workers, state_hook=state_hook,
                    block_hashes=hashes, cancel_event=spec.cancel)
            from ..evm import BlockExecutor

            if spec.cancel.is_set():
                raise _SpecAborted(spec.abort_reason or "cancelled")
            out = BlockExecutor(source, tree.config).execute(
                block, senders, hashes, state_hook=state_hook)
            return out, None
        except ExecCancelled:
            raise _SpecAborted(spec.abort_reason or "cancelled") from None
        except _SpecAborted:
            raise
        except BuildError:
            raise  # a failed g++ build of the native core is a fault
        except Exception as e:  # noqa: BLE001 — a speculative failure is
            # never a verdict: the normal path re-executes and judges
            tracing.event("engine::pipeline", "speculation_exec_error",
                          error=str(e)[:120])
            raise _SpecAborted("exec_error") from e

    # -- driver support -----------------------------------------------------

    def wait_commit_open(self, block_hash: bytes, timeout: float = 30.0) -> bool:
        """Block until ``block_hash``'s commit window opens (True) or its
        insert already finished / the wait times out (False). Import
        drivers use this to land the next payload mid-commit."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                win = self._window
                if (win is not None and win.block_hash == block_hash
                        and not win.done.is_set()):
                    return True
                if (block_hash in self._recent_closed
                        or block_hash in self.tree.blocks
                        or self.tree.invalid.get(block_hash) is not None):
                    return False
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)

    def stats_snapshot(self) -> dict:
        with self._lock:
            return {
                "depth": self.depth,
                "speculations": self.speculations,
                "adopted": self.adopted,
                "aborted": self.aborted,
                "abort_reasons": dict(self.abort_reasons),
                "exec_wall_s": self.exec_wall_s,
                "commit_wall_s": self.commit_wall_s,
                "overlap_wall_s": self.overlap_wall_s,
                "overlap_fraction": (
                    self.overlap_wall_s / self.commit_wall_s
                    if self.commit_wall_s > 1e-9 else 0.0),
                "leases_active": self.leases_active,
                "prehash_failed": self.prehash_failed,
            }


class _SpecAborted(Exception):
    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def import_chain(tree, blocks, fcu: bool = True, overlap: bool = True,
                 wait_s: float = 30.0, payload_timeout: float = 120.0):
    """Back-to-back import driver: feed ``blocks`` into ``tree``.

    With ``overlap`` (and a pipeline attached), each block is submitted
    the moment its parent enters its commit window, so consecutive
    blocks overlap exec-with-commit; otherwise strictly serial.
    forkchoiceUpdated calls are issued in block order from the caller
    thread. Returns the list of PayloadStatus, one per block.
    """
    from concurrent.futures import ThreadPoolExecutor

    from .tree import PayloadStatusKind

    def _import_one(blk):
        deadline = time.monotonic() + payload_timeout
        st = tree.on_new_payload(blk)
        while st.status is PayloadStatusKind.SYNCING \
                and time.monotonic() <= deadline:
            # parent insert still in flight (or the speculation aborted
            # benignly): either the parent's thread replays the buffered
            # block itself, or — once it sits in the buffer with its
            # parent known — we resubmit; never both at once
            if blk.hash in tree.blocks:
                return tree.on_new_payload(blk)  # replay imported it
            if tree.invalid.get(blk.hash) is not None:
                return tree.on_new_payload(blk)
            if (tree.buffered.get(blk.hash) is not None
                    and blk.header.parent_hash in tree.blocks):
                st = tree.on_new_payload(blk)
                continue
            time.sleep(0.002)
        return st

    pipelined = overlap and getattr(tree, "pipeline", None) is not None
    statuses: list = []
    if not pipelined:
        for blk in blocks:
            st = _import_one(blk)
            statuses.append(st)
            if fcu and st.status is PayloadStatusKind.VALID:
                tree.on_forkchoice_updated(blk.hash)
        return statuses
    pool = ThreadPoolExecutor(max_workers=2,
                              thread_name_prefix="import-pipeline")
    futs: list = []
    fcu_idx = 0
    try:
        for i, blk in enumerate(blocks):
            if i > 0:
                # land this payload mid-commit of its parent (or, if the
                # parent never opened a window, after its insert)
                if not tree.pipeline.wait_commit_open(blocks[i - 1].hash,
                                                      wait_s):
                    futs[i - 1].result()
            futs.append(pool.submit(_import_one, blk))
            while fcu_idx < i and futs[fcu_idx].done():
                st = futs[fcu_idx].result()
                if fcu and st.status is PayloadStatusKind.VALID:
                    tree.on_forkchoice_updated(blocks[fcu_idx].hash)
                fcu_idx += 1
        for j, fut in enumerate(futs):
            st = fut.result()
            statuses.append(st)
            if fcu and j >= fcu_idx and st.status is PayloadStatusKind.VALID:
                tree.on_forkchoice_updated(blocks[j].hash)
        return statuses
    finally:
        pool.shutdown(wait=True)
