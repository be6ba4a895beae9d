"""ExEx (execution extensions): durable canonical-state notifications.

A copy of the JAX package's ``exex.py``: ``BackfillJob`` re-executes on the
port's ``BlockExecutor`` over its historical state provider.

Reference analogue: crates/exex — `ExExManager` fanning out
`CanonStateNotification`s with backpressure, a WAL so notifications
survive restarts (src/wal/), and `FinishedHeight` feedback that gates
pruning (src/lib.rs:17-24). Extensions register a handler; the manager
journals every notification before delivery and replays unacknowledged
ones on restart.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path


@dataclass
class CanonStateNotification:
    """A committed chain segment (hashes + numbers; state via provider)."""

    tip_number: int
    tip_hash: bytes
    blocks: list[tuple[int, bytes]]  # (number, hash) oldest first

    def to_json(self) -> dict:
        return {
            "tip_number": self.tip_number,
            "tip_hash": self.tip_hash.hex(),
            "blocks": [[n, h.hex()] for n, h in self.blocks],
        }

    @classmethod
    def from_json(cls, d: dict) -> "CanonStateNotification":
        return cls(
            d["tip_number"], bytes.fromhex(d["tip_hash"]),
            [(n, bytes.fromhex(h)) for n, h in d["blocks"]],
        )


class ExExHandle:
    def __init__(self, name: str, handler):
        self.name = name
        self.handler = handler
        self.finished_height = 0  # highest block fully processed
        # a backfilling ExEx pins finished_height at its backfill progress
        # so the pruner cannot outrun it (reference FinishedHeight gate,
        # exex/src/lib.rs:17-24)
        self.backfilling = False


class ExExManager:
    """Fan-out + WAL + finished-height aggregation."""

    def __init__(self, wal_dir: str | Path | None = None):
        import threading

        # serializes finished-height bookkeeping between live notify and
        # a concurrent backfill (the pruning gate must never observe a
        # torn backfilling/finished_height pair)
        self._lock = threading.Lock()
        self.handles: list[ExExHandle] = []
        self.wal_path = Path(wal_dir) / "exex_wal.jsonl" if wal_dir else None
        self._next_seq = 0
        if self.wal_path and self.wal_path.exists():
            # count existing records so sequence numbers keep increasing
            with open(self.wal_path) as f:
                for line in f:
                    rec = json.loads(line)
                    self._next_seq = max(self._next_seq, rec["seq"] + 1)

    def register(self, name: str, handler) -> ExExHandle:
        h = ExExHandle(name, handler)
        self.handles.append(h)
        return h

    def notify(self, notification: CanonStateNotification) -> None:
        seq = self._next_seq
        self._next_seq += 1
        if self.wal_path:
            with open(self.wal_path, "a") as f:
                f.write(json.dumps({"seq": seq, "n": notification.to_json()}) + "\n")
                f.flush()
        for h in self.handles:
            h.handler(notification)
            with self._lock:
                if not h.backfilling:
                    h.finished_height = max(h.finished_height,
                                            notification.tip_number)

    def backfill(self, handle: ExExHandle, factory, first: int, last: int,
                 **job_kw) -> int:
        """Catch a late-registered ExEx up over ``[first, last]``: the
        historical chunks re-execute and deliver to THAT handle only,
        while live notifications keep flowing to everyone else. The
        handle's finished_height tracks backfill progress, holding the
        pruning gate down until the backfill completes. Each delivered
        notification carries the chunk's re-executed
        ``BlockExecutionOutput``s as ``notification.outputs``."""
        with self._lock:
            handle.backfilling = True
            handle.finished_height = min(handle.finished_height, first - 1)
        delivered = 0
        try:
            for notification, outputs in BackfillJob(factory, first, last,
                                                     **job_kw):
                notification.outputs = outputs  # historical state changes
                handle.handler(notification)
                with self._lock:
                    handle.finished_height = notification.tip_number
                delivered += 1
        finally:
            with self._lock:
                handle.backfilling = False
        return delivered

    def finished_height(self) -> int:
        """Lowest height every extension has finished — the pruning gate."""
        if not self.handles:
            return 1 << 62
        return min(h.finished_height for h in self.handles)

    def replay(self, from_height: int = 0) -> int:
        """Redeliver WAL'd notifications above ``from_height`` (restart)."""
        if not self.wal_path or not self.wal_path.exists():
            return 0
        count = 0
        with open(self.wal_path) as f:
            for line in f:
                rec = json.loads(line)
                n = CanonStateNotification.from_json(rec["n"])
                if n.tip_number > from_height:
                    for h in self.handles:
                        h.handler(n)
                        h.finished_height = max(h.finished_height, n.tip_number)
                    count += 1
        return count

    def prune_wal(self, below_height: int) -> None:
        """Drop WAL records at or below a height every ExEx finished."""
        if not self.wal_path or not self.wal_path.exists():
            return
        kept = []
        with open(self.wal_path) as f:
            for line in f:
                rec = json.loads(line)
                if rec["n"]["tip_number"] > below_height:
                    kept.append(line)
        tmp = self.wal_path.with_suffix(".tmp")
        with open(tmp, "w") as f:
            f.writelines(kept)
        tmp.replace(self.wal_path)


class BackfillJob:
    """Historical-range re-execution feeding a late-registered ExEx.

    Reference analogue: `BackfillJob` (crates/exex/exex/src/backfill/job.rs)
    — iterate a block range, re-execute each block against HISTORICAL
    state, and yield committed chunks (here: a CanonStateNotification plus
    the real BlockExecutionOutputs) in batches bounded by
    ``batch_blocks``/``batch_gas`` (the ExecutionStageThresholds analogue).
    """

    def __init__(self, factory, first: int, last: int,
                 batch_blocks: int = 64, batch_gas: int = 500_000_000,
                 config=None):
        self.factory = factory
        self.first = first
        self.last = last
        self.batch_blocks = batch_blocks
        self.batch_gas = batch_gas
        self.config = config

    def __iter__(self):
        from .evm import BlockExecutor, EvmConfig
        from .evm.executor import ProviderStateSource
        from .storage.historical import HistoricalStateProvider

        cfg = self.config or EvmConfig()
        n = self.first
        while n <= self.last:
            blocks: list[tuple[int, bytes]] = []
            outputs = []
            gas = 0
            with self.factory.provider() as p:
                while n <= self.last and len(blocks) < self.batch_blocks \
                        and gas < self.batch_gas:
                    block = p.block_by_number(n)
                    if block is None:
                        raise ValueError(f"missing canonical block {n}")
                    parent_state = HistoricalStateProvider(p, n - 1)
                    executor = BlockExecutor(
                        ProviderStateSource(parent_state), cfg)
                    hashes = {}
                    for k in range(max(0, n - 256), n):
                        bh = p.canonical_hash(k)
                        if bh:
                            hashes[k] = bh
                    out = executor.execute(block, block_hashes=hashes)
                    blocks.append((n, block.hash))
                    outputs.append(out)
                    gas += out.gas_used
                    n += 1
            yield CanonStateNotification(
                tip_number=blocks[-1][0], tip_hash=blocks[-1][1],
                blocks=blocks,
            ), outputs
