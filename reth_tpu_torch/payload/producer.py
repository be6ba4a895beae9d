"""Continuous block production: a standing hot candidate over the pool.

A copy of the JAX package's ``payload/producer.py`` on the port's engine tree
(``EngineTree.canon_listeners``), import pipeline
(``BlockPipeline.open_listeners``) and builder (``payload/builder.py``,
whose ``_seal`` roots the candidate on the card). One departure: no
catch-all swallows a kernel fault (``ops/_build.is_kernel_fault``). A
kernel fault on the producer's thread ends the thread and raises out of the
next ``take()``; a failed metrics record raises it where it happens. Any
other cause keeps the reference's fallback (drop the candidate, skip the
record) and is counted in ``producer_metrics.record_fallback``.

Reference analogue: the payload-builder service's improvement loop
(crates/payload/basic) fused with the pool's event listeners
(crates/transaction-pool/src/pool/events.rs) — but where the reference
re-runs `try_build` from scratch on every tick, this producer keeps ONE
hot candidate per parent and refreshes it *incrementally*:

- The greedy selection pass over ``pool.best_transactions`` is recorded
  as a **considered trace** — one ``(tx, verdict, sender)`` entry per
  stream position with verdicts ``sel`` / ``skip`` / ``invalid`` that
  mirror the serial builder's loop (builder.py) decision for decision.
- On a pool event (add / replace / drop / canon) the producer re-reads
  the best stream, finds the longest position-wise common prefix with
  the trace, and re-executes ONLY from the divergence point: the EVM
  state is restored from the nearest selected-rank **checkpoint**
  (a cheap structural fork of :class:`EvmState` — Accounts are replaced
  functionally, so shallow dict copies suffice), the known-good selected
  prefix beyond the checkpoint is replayed, and the greedy loop resumes
  on the new stream tail. A tx landing below every pooled tip costs one
  execution; a new best tx costs a rebuild — exactly the serial
  semantics, paid lazily.
- The candidate rides the import pipeline's **commit window**
  (engine/block_pipeline.py): when block N is committing, the producer
  builds N+1's candidate against N's frozen overlay layers so payload
  build overlaps state-root/commit — the producer-side twin of the
  cross-block import pipeline. Sealing waits for the window to close
  (the state-root job must anchor on committed layers); a failed window
  discards the candidate.

Invariant the whole design hangs on (asserted by the differential
tests, tests/test_torch_payload.py): at pool-sequence parity, ``candidate.selected``
is bit-identical to what one serial ``build_payload`` greedy pass over
the same pool would select.
"""

from __future__ import annotations

import threading
import time

from ..evm import BlockExecutor
from ..evm.executor import InvalidTransaction, ProviderStateSource
from ..evm.state import BlockChanges, EvmState
from ..metrics import producer_metrics
from ..ops._build import is_kernel_fault
from ..primitives.types import Receipt, Transaction
from ..storage.overlay import OverlayTx
from ..storage.provider import DatabaseProvider
from .builder import PayloadAttributes, _MiniOutput, _seal, payload_env


def _fork_state(state: EvmState) -> EvmState:
    """Independent copy of the cross-tx world state, safe to execute on.

    Account objects are immutable (replaced via ``with_()``), so account
    maps copy shallowly; per-address storage dicts mutate in place and
    need one level of copy. Per-tx fields (journal, warm sets, refund)
    are left fresh — forks are only taken at tx boundaries, where
    ``begin_tx`` would reset them anyway.
    """
    out = EvmState(state.source)
    out._accounts = dict(state._accounts)
    out._storage = {a: dict(s) for a, s in state._storage.items()}
    out._code = dict(state._code)
    out.changes = BlockChanges(
        accounts=dict(state.changes.accounts),
        storage={a: dict(s) for a, s in state.changes.storage.items()},
        wiped_storage=set(state.changes.wiped_storage),
        new_bytecodes=dict(state.changes.new_bytecodes),
    )
    out._touched = set(state._touched)
    out._selfdestructs = set(state._selfdestructs)
    out._pending_destructs = set(state._pending_destructs)
    out._logs = list(state._logs)
    return out


class _Considered:
    """One greedy-loop decision: how the pass treated one stream entry."""

    __slots__ = ("tx", "verdict", "sender")

    def __init__(self, tx: Transaction, verdict: str, sender: bytes | None):
        self.tx = tx
        self.verdict = verdict  # "sel" | "skip" | "invalid"
        self.sender = sender


class _Candidate:
    """Hot candidate for one (parent, attrs) slot."""

    def __init__(self, parent_hash, parent, attrs, gas_ceiling, overlay,
                 env, base_fee, cancun, excess_blob, blob_params, window):
        self.parent_hash = parent_hash
        self.parent = parent
        self.attrs = attrs
        self.gas_ceiling = gas_ceiling
        self.overlay = overlay
        self.env = env
        self.base_fee = base_fee
        self.cancun = cancun
        self.excess_blob = excess_blob
        self.blob_params = blob_params
        self.window = window              # CommitWindow riding, or None
        self.executor = None              # set by the producer
        self.state: EvmState | None = None
        self.considered: list[_Considered] = []
        self.selected: list[Transaction] = []
        self.receipts: list[Receipt] = []
        self.cum_gas = 0
        self.blob_gas = 0
        self.fees = 0
        self.pool_seq = -1                # pool.event_seq this trace matches
        # selected-rank -> (state fork, cum_gas, blob_gas, fees)
        self.checkpoints: dict[int, tuple] = {}
        self.built_at = time.monotonic()


class BlockProducer:
    """Standing producer thread maintaining the hot candidate.

    ``take()`` is the consumer API: the dev miner and the payload-job
    service call it to seal the current candidate (building synchronously
    on a cache miss), so a hot hit turns getPayload/mine into a pure
    seal — no execution on the critical path.
    """

    def __init__(self, tree, pool, lock=None, block_time: int = 12,
                 fee_recipient: bytes = b"\x00" * 20,
                 checkpoint_every: int = 16, interval: float = 0.05,
                 ride_windows: bool = True):
        self.tree = tree
        self.pool = pool
        self.block_time = max(1, int(block_time))
        self.fee_recipient = fee_recipient
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.interval = interval
        self.ride_windows = ride_windows
        self._lock = lock or threading.RLock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.candidate: _Candidate | None = None
        self._pinned: tuple[bytes, PayloadAttributes] | None = None
        # plain-assignment flag set from pool/canon listener threads (no
        # lock: lock-order with pool._lock must stay one-directional)
        self._stale_since: float | None = None
        # counters (mirrored into producer_metrics)
        self.refreshes = 0
        self.full_rebuilds = 0
        self.window_builds = 0
        self.reexec_ranks = 0
        self.exec_ranks = 0
        self.invalidated = 0
        self.hits = 0
        self.misses = 0
        self.sealed = 0
        self.errors = 0
        self.last_refresh_wall = 0.0
        # a kernel fault that ended the producer's thread: take() raises it
        self.fault: BaseException | None = None
        self.last_stats: dict = {}  # the last seal's walls (builder._seal)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self.pool.add_listener(self._on_pool_event)
        self.tree.canon_listeners.append(self._on_canon)
        if self.ride_windows and getattr(self.tree, "pipeline", None) is not None:
            self.tree.pipeline.open_listeners.append(self._on_window)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="block-producer")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.pool.remove_listener(self._on_pool_event)
        if self._on_canon in self.tree.canon_listeners:
            self.tree.canon_listeners.remove(self._on_canon)
        pipe = getattr(self.tree, "pipeline", None)
        if pipe is not None and self._on_window in pipe.open_listeners:
            pipe.open_listeners.remove(self._on_window)

    # listener callbacks run on foreign threads (pool lock / insert
    # thread held) — they only flag and wake, never take self._lock
    def _on_pool_event(self, ev: dict) -> None:
        if self._stale_since is None:
            self._stale_since = time.monotonic()
        self._wake.set()

    def _on_canon(self, chain) -> None:
        if self._stale_since is None:
            self._stale_since = time.monotonic()
        self._wake.set()

    def _on_window(self, win) -> None:
        self._wake.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.interval)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                with self._lock:
                    self._ensure_locked()
            except Exception as e:  # noqa: BLE001 — a poisoned candidate must
                # never kill the producer: drop it, rebuild next tick
                if is_kernel_fault(e):
                    self.fault = e
                    return
                self.errors += 1
                producer_metrics.record_fallback("producer_candidate")
                with self._lock:
                    self.candidate = None
                time.sleep(0.05)
            try:
                producer_metrics.set_staleness(self.staleness())
            except Exception as e:  # noqa: BLE001
                if is_kernel_fault(e):
                    self.fault = e
                    return
                producer_metrics.record_fallback("producer_staleness")

    # -- target selection ----------------------------------------------------

    def _target_window(self):
        if not self.ride_windows:
            return None
        pipe = getattr(self.tree, "pipeline", None)
        if pipe is None:
            return None
        win = pipe.current_window()
        if win is not None and not win.done.is_set():
            return win
        return None

    def _ensure_locked(self) -> None:
        cand = self.candidate
        # a window-parented candidate whose window resolved: adopt (parent
        # is canonical in-memory now) or discard (parent never lands)
        if cand is not None and cand.window is not None and cand.window.done.is_set():
            if cand.window.ok:
                cand.window = None
            else:
                cand = self.candidate = None
        win = self._target_window()
        parent_hash = win.block_hash if win is not None else self.tree.head_hash
        if cand is None or cand.parent_hash != parent_hash:
            self._rebuild_locked(parent_hash, win)
        else:
            self._refresh_locked()

    def _attrs_for(self, parent_hash: bytes, parent) -> PayloadAttributes:
        if self._pinned is not None and self._pinned[0] == parent_hash:
            return self._pinned[1]
        # same timestamp rule as the dev miner: strictly increasing
        return PayloadAttributes(
            timestamp=max(parent.timestamp + self.block_time,
                          parent.timestamp + 1),
            suggested_fee_recipient=self.fee_recipient,
        )

    def _rebuild_locked(self, parent_hash: bytes, win=None,
                        attrs: PayloadAttributes | None = None,
                        gas_ceiling: int | None = None) -> None:
        """Fresh candidate for ``parent_hash`` (greedy pass runs via the
        refresh path against an empty trace)."""
        if win is not None:
            # ride the commit window: N's frozen layers serve N+1's reads
            # while N's state root is still being committed
            parent = win.block.header
            overlay = DatabaseProvider(OverlayTx(
                self.tree.factory.db.tx(),
                list(win.parent_layers) + [win.exec_layer], {}))
            self.window_builds += 1
        else:
            overlay = self.tree.overlay_provider(parent_hash)
            parent = overlay.header_by_number(overlay.block_number(parent_hash))
        if attrs is None:
            attrs = self._attrs_for(parent_hash, parent)
        env, base_fee, cancun, excess_blob, blob_params = payload_env(
            self.tree, parent, attrs, gas_ceiling)
        cand = _Candidate(parent_hash, parent, attrs, gas_ceiling, overlay,
                          env, base_fee, cancun, excess_blob, blob_params,
                          win)
        cand.executor = BlockExecutor(ProviderStateSource(overlay),
                                      self.tree.config)
        cand.state = EvmState(cand.executor.source)
        cand.checkpoints[0] = (_fork_state(cand.state), 0, 0, 0)
        self.candidate = cand
        self.full_rebuilds += 1
        self._refresh_locked()

    # -- the incremental refresh ----------------------------------------------

    def _refresh_locked(self) -> None:
        cand = self.candidate
        pool = self.pool
        t0 = time.monotonic()
        with pool._lock:
            seq = pool.event_seq
            if seq == cand.pool_seq:
                self._stale_since = None
                return
            # anchor check: the pool's executable stream is computed
            # against the CANONICAL head's state. Refreshing a candidate
            # parented elsewhere (a commit landed between target
            # resolution and this refresh) would execute head-N+1 nonces
            # on head-N state and wrongly evict valid txs as invalid —
            # abort and let the run loop rebuild on the new parent. A
            # window-parented candidate is exempt: its overlay is AHEAD
            # of the pool's view, so spurious evictions there are
            # nonce-too-low txs the in-flight block already mined.
            if cand.window is None and self.tree.head_hash != cand.parent_hash:
                return
            stream = list(pool.best_transactions(cand.base_fee))
        # longest position-wise common prefix of stream vs trace. Entries
        # with verdict "invalid" never match (remove_invalid evicted them
        # from the pool), so an eviction truncates the trace there — which
        # is exactly serial semantics: a fresh pass would not see the
        # evicted tx, and its sender must NOT stay in failed_senders.
        considered = cand.considered
        j = 0
        while (j < len(stream) and j < len(considered)
               and stream[j].hash == considered[j].tx.hash):
            j += 1
        if j == len(stream) and j == len(considered):
            cand.pool_seq = seq
            self._stale_since = None
            # a rebuild (head change) resets ``selected`` without a
            # stream-changing refresh — re-anchor the ranks gauge here or
            # it keeps the previous candidate's count
            producer_metrics.sync_ranks(len(cand.selected))
            return
        self.refreshes += 1
        env, base_fee = cand.env, cand.base_fee
        executor = cand.executor
        # selected rank at the divergence point, then the nearest
        # checkpoint at-or-below it
        r = sum(1 for c in considered[:j] if c.verdict == "sel")
        ck = max(k for k in cand.checkpoints if k <= r)
        cand.checkpoints = {k: v for k, v in cand.checkpoints.items()
                            if k <= ck}
        st, cum_gas, blob_gas, total_fees = cand.checkpoints[ck]
        state = _fork_state(st)
        selected = cand.selected[:ck]
        receipts = cand.receipts[:ck]
        failed_senders = {c.sender for c in considered[:j]
                          if c.verdict == "invalid" and c.sender is not None}
        trace = considered[:j]
        # replay the known-good selected ranks between the checkpoint and
        # the divergence point (identical state in, identical receipts out)
        replay = [c for c in trace if c.verdict == "sel"][ck:]
        for c in replay:
            result = executor._execute_tx(state, env, c.tx, c.sender,
                                          env.gas_limit - cum_gas)
            cum_gas += result.gas_used
            blob_gas += c.tx.blob_gas()
            total_fees += result.gas_used * max(
                0, c.tx.effective_gas_price(base_fee) - base_fee)
            selected.append(c.tx)
            receipts.append(Receipt(
                tx_type=c.tx.tx_type, success=result.success,
                cumulative_gas_used=cum_gas, logs=result.receipt.logs))
            self.reexec_ranks += 1
            if len(selected) % self.checkpoint_every == 0:
                cand.checkpoints[len(selected)] = (
                    _fork_state(state), cum_gas, blob_gas, total_fees)
        # greedy continuation over the new stream tail — decision for
        # decision the serial loop in builder.build_payload
        own_events = 0
        for tx in stream[j:]:
            if cum_gas + tx.gas_limit > env.gas_limit:
                trace.append(_Considered(tx, "skip", None))
                continue
            if tx.blob_gas() and (
                not cand.cancun
                or blob_gas + tx.blob_gas() > cand.blob_params.max_gas
            ):
                trace.append(_Considered(tx, "skip", None))
                continue
            try:
                sender = tx.recover_sender()
                if sender in failed_senders:
                    trace.append(_Considered(tx, "skip", sender))
                    continue
                result = executor._execute_tx(state, env, tx, sender,
                                              env.gas_limit - cum_gas)
            except (InvalidTransaction, ValueError):
                try:
                    sender = tx.recover_sender()
                    failed_senders.add(sender)
                except ValueError:
                    sender = None
                with pool._lock:
                    s0 = pool.event_seq
                    pool.remove_invalid(tx.hash)
                    own_events += pool.event_seq - s0
                trace.append(_Considered(tx, "invalid", sender))
                self.invalidated += 1
                continue
            cum_gas += result.gas_used
            blob_gas += tx.blob_gas()
            total_fees += result.gas_used * max(
                0, tx.effective_gas_price(base_fee) - base_fee)
            selected.append(tx)
            receipts.append(Receipt(
                tx_type=tx.tx_type, success=result.success,
                cumulative_gas_used=cum_gas, logs=result.receipt.logs))
            trace.append(_Considered(tx, "sel", sender))
            self.exec_ranks += 1
            if len(selected) % self.checkpoint_every == 0:
                cand.checkpoints[len(selected)] = (
                    _fork_state(state), cum_gas, blob_gas, total_fees)
        cand.considered = trace
        cand.selected = selected
        cand.receipts = receipts
        cand.state = state
        cand.cum_gas = cum_gas
        cand.blob_gas = blob_gas
        cand.fees = total_fees
        # remove_invalid above bumped the seq; the trace accounts for those
        # evictions already (they are "invalid" entries), so fold exactly
        # OUR eviction events into the parity stamp — and no more: a
        # concurrent add landing mid-refresh must leave pool_seq behind
        # the live seq so the next pass picks it up instead of silently
        # skipping it until the next unrelated event
        cand.pool_seq = seq + own_events
        self._stale_since = None
        self.last_refresh_wall = time.monotonic() - t0
        try:
            producer_metrics.record_refresh(
                self.last_refresh_wall, ranks=len(selected),
                reexec=len(replay), fresh=len(stream) - j)
        except Exception as e:  # noqa: BLE001
            if is_kernel_fault(e):
                raise
            producer_metrics.record_fallback("producer_refresh_metrics")

    # -- consumption ----------------------------------------------------------

    def prepare(self, parent_hash: bytes, attrs: PayloadAttributes) -> None:
        """Pin explicit attributes for a parent (engine FCU-with-attrs
        path) and wake the producer to build toward them."""
        with self._lock:
            self._pinned = (parent_hash, attrs)
            cand = self.candidate
            if cand is not None and cand.parent_hash == parent_hash \
                    and cand.attrs != attrs:
                self.candidate = None
        self._wake.set()

    def take(self, parent_hash: bytes | None = None,
             attrs: PayloadAttributes | None = None,
             extra_data: bytes = b"", gas_ceiling: int | None = None,
             timeout: float = 30.0):
        """Seal the hot candidate for ``parent_hash`` (default: canonical
        head); returns ``(block, total_priority_fees)``. A matching hot
        candidate is refreshed to pool parity and sealed; anything else
        (cold start, different parent/attrs/gas ceiling) builds
        synchronously first. The candidate itself stays hot — sealing
        does not consume it. A kernel fault that ended the producer's
        thread raises here."""
        if self.fault is not None:
            raise self.fault
        with self._lock:
            want = parent_hash if parent_hash is not None else self.tree.head_hash
            if attrs is not None:
                self._pinned = (want, attrs)
            cand = self.candidate
            stale = (
                cand is None
                or cand.parent_hash != want
                or (attrs is not None and cand.attrs != attrs)
                or (gas_ceiling is not None and cand.gas_ceiling != gas_ceiling)
            )
            if not stale and cand.window is not None:
                # the state-root job in _seal anchors on committed layers:
                # wait out the window (its close is the pipelined commit
                # this candidate overlapped with)
                if not cand.window.done.wait(timeout):
                    raise TimeoutError("commit window did not close")
                if cand.window.ok:
                    cand.window = None
                else:
                    self.candidate = None
                    stale = True
            if stale:
                self.misses += 1
                self._rebuild_locked(want, None, attrs=attrs,
                                     gas_ceiling=gas_ceiling)
                cand = self.candidate
            else:
                self.hits += 1
                self._refresh_locked()
            return self._seal_locked(cand, extra_data)

    def _seal_locked(self, cand: _Candidate, extra_data: bytes):
        state = _fork_state(cand.state)
        for w in cand.attrs.withdrawals:
            if w.amount:
                state._capture_account_change(w.address)
                state.add_balance(w.address, w.amount * 10**9)
        post_accounts, post_storage = state.final_state()
        out = _MiniOutput(state.changes, post_accounts, post_storage,
                          list(cand.receipts))
        # re-anchor on the tree's own overlay: the frozen window overlay
        # served execution reads, but sealing needs the committed chain
        overlay = self.tree.overlay_provider(cand.parent_hash)
        self.last_stats = {}
        block, fees = _seal(self.tree, overlay, cand.parent_hash, cand.attrs,
                            cand.env, extra_data, list(cand.selected), out,
                            cand.cum_gas, cand.blob_gas, cand.excess_blob,
                            cand.cancun, cand.base_fee, cand.fees, self.last_stats)
        self.sealed += 1
        return block, fees

    # -- introspection ---------------------------------------------------------

    def staleness(self) -> float:
        """Seconds the hot candidate has lagged the pool (0 when in
        sync). Feeds the producer-staleness SLO."""
        since = self._stale_since
        return 0.0 if since is None else max(0.0, time.monotonic() - since)

    def snapshot(self) -> dict:
        cand = self.candidate
        return {
            "parent": cand.parent_hash.hex() if cand is not None else None,
            "ranks": len(cand.selected) if cand is not None else 0,
            "considered": len(cand.considered) if cand is not None else 0,
            "gas": cand.cum_gas if cand is not None else 0,
            "fees": cand.fees if cand is not None else 0,
            "window": bool(cand is not None and cand.window is not None),
            "pool_seq": cand.pool_seq if cand is not None else -1,
            "refreshes": self.refreshes,
            "full_rebuilds": self.full_rebuilds,
            "window_builds": self.window_builds,
            "exec_ranks": self.exec_ranks,
            "reexec_ranks": self.reexec_ranks,
            "invalidated": self.invalidated,
            "hits": self.hits,
            "misses": self.misses,
            "sealed": self.sealed,
            "errors": self.errors,
            "staleness_s": round(self.staleness(), 3),
            "last_refresh_wall_s": round(self.last_refresh_wall, 6),
        }
