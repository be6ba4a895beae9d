"""Pipelined live-tip state root: hash dirty keys WHILE the block executes.

A copy of the JAX package's ``engine/pipelined_root.py`` on the port's modules.
The engine tree hands it the committer's hasher: kernel 1 through
``KeccakDevice`` on the card by default. A batch whose hash call raises is
counted in ``batches_failed`` and its keys hash again in ``finish`` on the
same hasher, where a fault raises.

Reference analogue: the background state-root task fed by per-tx
`OnStateHook` updates (crates/trie/parallel/src/state_root_task.rs:20-100
+ crates/engine/tree/src/tree/state_root_strategy/sparse_trie.rs:126-259).
There, execution streams `EvmState` per transaction into a concurrently
running sparse-trie job. Here the streamed unit is the block's dirty KEY
set: a worker thread batch-hashes newly touched addresses/slots on the
device as they arrive, so by the time execution finishes, the keccak
digests the incremental root needs are already resident — the root
commit only hashes stragglers (e.g. withdrawal targets) and walks the
trie. The device hashes while the CPU interprets: the two real resources
of this design overlap instead of serializing.
"""

from __future__ import annotations

import queue
import threading
import time


class PipelinedStateRoot:
    """Streaming key-hash worker for one block's execution."""

    def __init__(self, hasher):
        self.hasher = hasher
        self._queue: queue.Queue = queue.Queue()
        self._digests: dict[bytes, bytes] = {}
        self._lock = threading.Lock()
        self._sent: set[bytes] = set()
        self.batches_hashed = 0
        self.batches_failed = 0
        self.hash_spans: list[tuple[float, float]] = []  # worker activity
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- execution-side hook (called after every transaction) ---------------

    def on_state_update(self, keys) -> None:
        """Queue newly touched plain keys — 20-byte addresses and
        ``(address, slot)`` pairs (slots are hashed standalone; the pair
        form exists for the sparse strategy, which needs the owner)."""
        flat = [k if isinstance(k, bytes) else k[1] for k in keys]
        fresh = [k for k in flat if k not in self._sent]
        if not fresh:
            return
        self._sent.update(fresh)
        self._queue.put(fresh)

    # -- worker --------------------------------------------------------------

    def _run(self) -> None:
        while True:
            batch = self._queue.get()
            if batch is None:
                return
            t0 = time.monotonic()
            try:
                digests = self.hasher(batch)
            except Exception:  # noqa: BLE001 — a dying worker would silently
                # serialize ALL hashing into finish(); with a supervised
                # hasher (ops/supervisor.py) failures route to the CPU and
                # never land here, but an unsupervised device hasher must
                # not take the stream down — the keys re-hash in finish()
                with self._lock:
                    self.batches_failed += 1
                continue
            with self._lock:
                for k, d in zip(batch, digests):
                    self._digests[k] = d
                self.batches_hashed += 1
                self.hash_spans.append((t0, time.monotonic()))

    # -- finalization --------------------------------------------------------

    def finish(self, all_keys) -> dict[bytes, bytes]:
        """Drain the worker and return digests for ``all_keys`` (stragglers
        the stream never saw are hashed here, in one batch)."""
        self._queue.put(None)
        self._thread.join()
        missing = [k for k in all_keys if k not in self._digests]
        if missing:
            for k, d in zip(missing, self.hasher(missing)):
                self._digests[k] = d
        return self._digests
