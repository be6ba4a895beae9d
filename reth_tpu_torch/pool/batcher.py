"""Batched pool insertion + validation-task offload.

A copy of the JAX package's ``pool/batcher.py``, its senders recovered by the
port's native batch (``primitives/secp256k1.py ecrecover_batch`` over
``csrc/secp256k1.cpp``, built by g++). One departure: a kernel fault
(``ops/_build.is_kernel_fault``, such as the batch's failed ``BuildError``)
is no malformed transaction. The batch does not fall back to "invalid
signature" for it, and every future of the batch fails with the fault
itself instead of a ``PoolError``.

Reference analogue: `BatchTxProcessor` (crates/transaction-pool/src/
batcher.rs) — callers enqueue (tx, response channel) requests; a processor
drains the queue in batches to cut per-insert lock contention — and the
validation task pool (src/validate/task.rs) that moves validation work off
the caller's thread.

TPU-first collapse of the two: the expensive validation step is SENDER
RECOVERY, and this repo has a batched native secp256k1 backend
(primitives.types.recover_senders → one threaded C++ dispatch for the
whole batch). The batcher worker therefore drains up to ``max_batch``
requests, recovers every sender in ONE batched call, then inserts each tx
under a single lock acquisition per batch — callers just await futures.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future

from ..ops._build import is_kernel_fault
from ..primitives.types import Transaction, recover_senders
from .pool import PoolError


class PoolOverloaded(PoolError):
    """Admission queue is full — the firehose outran the insert worker.

    Carries ``retry_after_s`` so the RPC layer can map this onto the
    gateway's shed convention (``-32005`` + retry_after) instead of the
    generic ``-32000`` pool error. Bounding the queue here is what keeps a
    tx flood from growing memory without limit and from starving the
    gateway's engine lanes: the submit call fails fast instead of
    parking work forever.
    """

    def __init__(self, depth: int, retry_after_s: float):
        super().__init__(
            f"transaction pool overloaded ({depth} admissions queued)")
        self.retry_after_s = retry_after_s


class TxBatcher:
    """Worker-thread insertion batcher over a :class:`TransactionPool`."""

    def __init__(self, pool, max_batch: int = 128, max_queue: int = 8192,
                 retry_after_s: float = 0.5):
        self.pool = pool
        self.max_batch = max_batch
        self.max_queue = max_queue
        self.retry_after_s = retry_after_s
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self.batches = 0
        self.processed = 0
        self.sheds = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tx-batcher")
        self._thread.start()

    # -- submission ----------------------------------------------------------

    def submit(self, tx: Transaction) -> Future:
        """Enqueue a tx; the Future resolves to its hash or raises
        PoolError (PoolOverloaded when the admission queue is saturated)."""
        fut: Future = Future()
        if self._closed:
            fut.set_exception(PoolError("batcher closed"))
            return fut
        depth = self._q.qsize()
        if self.max_queue and depth >= self.max_queue:
            self.sheds += 1
            try:
                from ..metrics import pool_metrics

                pool_metrics.record_shed()
            except Exception:  # noqa: BLE001
                pass
            fut.set_exception(PoolOverloaded(depth, self.retry_after_s))
            return fut
        self._q.put((tx, fut))
        return fut

    def add_sync(self, tx: Transaction, timeout: float = 30.0) -> bytes:
        """Submit and wait — the drop-in replacement for
        ``pool.add_transaction`` on RPC threads."""
        return self.submit(tx).result(timeout)

    # -- worker --------------------------------------------------------------

    def _drain(self) -> list:
        batch = [self._q.get()]
        while len(batch) < self.max_batch:
            try:
                batch.append(self._q.get_nowait())
            except queue.Empty:
                break
        return batch

    def _run(self) -> None:
        while True:
            batch = self._drain()
            stop = any(tx is None for tx, _ in batch)  # close() sentinel
            try:
                self._process([(tx, fut) for tx, fut in batch
                               if tx is not None])
            except Exception as e:  # noqa: BLE001 — the worker must
                # survive ANY poison batch: fail these futures, keep
                # serving (a dead worker silently kills tx submission)
                err = e if is_kernel_fault(e) else PoolError(f"internal: {e}")
                for tx, fut in batch:
                    if tx is not None and not fut.done():
                        fut.set_exception(err)
            if stop:
                return

    def _process(self, batch: list) -> None:
        if not batch:
            return
        self.batches += 1
        try:
            senders = recover_senders([tx for tx, _ in batch])
        except Exception as e:  # noqa: BLE001 — one malformed tx must not
            # poison the whole batch; fall back to per-tx recovery
            if is_kernel_fault(e):
                raise
            senders = [None] * len(batch)
        with self.pool._lock:
            for (tx, fut), sender in zip(batch, senders):
                if fut.set_running_or_notify_cancel() is False:
                    continue
                try:
                    if sender is None:
                        raise PoolError("invalid signature: recovery failed")
                    fut.set_result(
                        self.pool.add_transaction(tx, sender=sender))
                except PoolError as e:
                    fut.set_exception(e)
                except Exception as e:  # noqa: BLE001 — a poison tx must
                    # fail ITS future, not kill the worker for everyone
                    fut.set_exception(PoolError(f"internal: {e}"))
                finally:
                    self.processed += 1

    def close(self) -> None:
        """Stop the worker after the queue drains."""
        if not self._closed:
            self._closed = True
            self._q.put((None, None))
            self._thread.join(timeout=10)
