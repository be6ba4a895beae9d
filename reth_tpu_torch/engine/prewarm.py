"""Prewarm: parallel optimistic execution to warm the state caches.

A copy of the JAX package's ``engine/prewarm.py`` on the port's modules.

Reference analogue: crates/engine/tree/src/tree/payload_processor/
prewarm.rs — before the sequential (canonical) execution of a new
payload, worker tasks execute every transaction INDEPENDENTLY against
the parent state. The results are discarded; the point is the side
effect: every account/storage/bytecode read lands in the shared
execution cache, so the sequential pass hits warm caches instead of
cold storage. Transactions that depend on earlier in-block writes
simply read parent-state values — still the right keys to warm (the
reference accepts the same approximation; its BAL-driven variant warms
the exact access list).

Workers execute against thread-local EvmStates over the SHARED
CachedStateSource; reads flow through the (mutex-guarded) cache,
speculative writes stay in the worker's journal and die with it.

With ``--parallel-exec`` this task does not run at all: the optimistic
scheduler (engine/optimistic.py) FOLDS the prewarm pass into its
speculative first attempts — the same recording execution warms the
cache and streams keys, but a validation-clean result commits directly
instead of being discarded and re-executed.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

from .. import tracing
from ..evm.state import EvmState


class PrewarmTask:
    """One prewarm pass for one payload."""

    def __init__(self, executor, env, max_workers: int = 4,
                 record_accesses: bool = False, key_sink=None):
        """``executor``: the BlockExecutor whose (cached) source the
        sequential pass will use; ``env``: the block's BlockEnv. With
        ``record_accesses`` each worker also records its tx's access sets
        — the BAL scheduling hint (reference: prewarm and BAL execution
        share the speculative pass).

        ``key_sink(keys)``: optional OnStateHook-shaped callable fed each
        worker's touched plain keys (20-byte addresses and
        ``(address, slot)`` pairs) AS WORKERS FINISH — a cheap key-only
        recording independent of the BAL machinery. Wired to the sparse
        state-root task's ``on_state_update`` so multiproof fetch
        overlaps prewarm instead of waiting for canonical execution
        (reference: the sparse strategy's prefetch off the prewarm pass).
        Keys are speculative: extra keys only pre-reveal trie paths the
        block may not touch, which never changes the computed root."""
        self.executor = executor
        self.env = env
        self.max_workers = max_workers
        self.record_accesses = record_accesses
        self.key_sink = key_sink
        self.accesses: dict[int, object] = {}  # tx index -> TxAccess
        self.warmed = 0
        self.failed = 0
        self.streamed_keys = 0  # keys handed to key_sink (tests/metrics)

    def _one(self, item) -> bool:
        # adopt the block's trace context in this pool worker (explicit
        # handoff: captured once in start(), reused by every worker)
        with tracing.use_context(self._ctx):
            with tracing.span("engine::prewarm", "prewarm.tx", idx=item[0]):
                return self._one_inner(item)

    def _one_inner(self, item) -> bool:
        i, tx, sender = item
        try:
            if self.record_accesses:
                from .bal import _extract_writes, make_recording_state

                # the recording executor routes the coinbase fee credit
                # through the delta seam — a plain executor would poison
                # every access set with a coinbase write/flag
                acc, ex, state = make_recording_state(
                    self.executor.source, self.env.coinbase, i,
                    self.executor.config)
                self.accesses[i] = acc  # dict: per-key writes race-free
            else:
                ex = self.executor
                state = EvmState(self.executor.source)  # thread-local journal
            # independent execution: later in-block txs see the PARENT
            # nonce, so align the journal's copy (the reference's prewarm
            # relaxes the same sequential-only checks); reads still flow
            # through (and warm) the shared cache
            if state.nonce(sender) != tx.nonce:
                state.set_nonce(sender, tx.nonce)
            ex._execute_tx(state, self.env, tx, sender, self.env.gas_limit)
            if self.record_accesses:
                _extract_writes(state, acc)
            self._stream_keys(state)
            return True
        except Exception:  # noqa: BLE001 — speculative: any failure is fine
            return False

    def _stream_keys(self, state) -> None:
        """Hand this worker's touched keys to the sink (key-only mode):
        every account and storage slot the journal read or wrote, in the
        executor's OnStateHook format. Failures never fail the worker —
        prefetch is an optimization, not a correctness seam."""
        if self.key_sink is None:
            return
        try:
            keys: list = list(getattr(state, "_accounts", {}))
            for addr, slots in getattr(state, "_storage", {}).items():
                keys.extend((addr, s) for s in slots)
            if keys:
                self.streamed_keys += len(keys)
                self.key_sink(keys)
        except Exception:  # noqa: BLE001 — speculative prefetch only
            pass

    def run(self, transactions, senders) -> int:
        """Execute all txs concurrently; returns how many completed.
        Counters come from the map results — workers share no mutable
        state, so nothing needs a lock."""
        self.start(transactions, senders)
        return self.join()

    def start(self, transactions, senders) -> None:
        """Kick the workers off WITHOUT waiting: the canonical sequential
        pass runs concurrently and benefits from whatever has already been
        warmed when it reaches each transaction (the reference's prewarm
        overlaps execution the same way — blocking first would serialize
        two full passes)."""
        self._pool = None
        self._futures = []
        self._ctx = tracing.current_context()
        self._t0 = time.time()
        if not transactions:
            return
        self._pool = ThreadPoolExecutor(max_workers=self.max_workers)
        self._futures = [self._pool.submit(self._one, (i, tx, s))
                         for i, (tx, s) in enumerate(zip(transactions, senders))]

    def join(self) -> int:
        """Collect results and release the workers."""
        if self._pool is None:
            return 0
        results = [f.result() for f in self._futures]
        self._pool.shutdown(wait=True)
        self._pool = None
        self.warmed = sum(results)
        self.failed = len(results) - self.warmed
        # the whole pass as one span under the block trace (start() ran on
        # the block thread; workers overlapped canonical execution)
        tracing.record_span("engine::prewarm", "prewarm", self._t0,
                            time.time() - self._t0, ctx=self._ctx,
                            fields={"warmed": self.warmed,
                                    "failed": self.failed,
                                    "streamed_keys": self.streamed_keys})
        return self.warmed
