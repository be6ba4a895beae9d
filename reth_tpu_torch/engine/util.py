"""Engine-message middleware: fault injection + capture/replay.

A copy of the JAX package's ``engine/util.py`` on the port's modules.

Reference analogue: crates/engine/util — the stream combinators reth
wraps around the consensus-engine channel: `EngineReorg` (inject
artificial reorgs every N payloads), `EngineSkip` (drop every Nth
FCU/newPayload), and `EngineStoreExt` (persist every message to disk
for later replay). Here the same seams wrap the EngineTree's call
surface, so tests and debugging sessions can exercise reorg/skip
behavior without a misbehaving CL.
"""

from __future__ import annotations

import json
import time
from pathlib import Path


class EngineFaultInjector:
    """Wraps an EngineTree-like target with skip/reorg fault policies.

    ``skip_fcu`` / ``skip_new_payload``: drop every Nth message (the
    reference's EngineSkip streams). ``reorg_frequency``: every Nth
    payload is first answered normally, then the PREVIOUS head is
    re-targeted, forcing the tree through its reorg path (EngineReorg).
    """

    def __init__(self, tree, skip_fcu: int = 0, skip_new_payload: int = 0,
                 reorg_frequency: int = 0):
        self.tree = tree
        self.skip_fcu = skip_fcu
        self.skip_new_payload = skip_new_payload
        self.reorg_frequency = reorg_frequency
        self.fcu_count = 0
        self.payload_count = 0
        self.skipped_fcu = 0
        self.skipped_payloads = 0
        self.injected_reorgs = 0
        self._prev_head: bytes | None = None

    def on_new_payload(self, block):
        self.payload_count += 1
        if self.skip_new_payload and self.payload_count % self.skip_new_payload == 0:
            self.skipped_payloads += 1
            from .tree import PayloadStatus, PayloadStatusKind

            return PayloadStatus(PayloadStatusKind.SYNCING)
        return self.tree.on_new_payload(block)

    def on_forkchoice_updated(self, head: bytes, *a, **kw):
        self.fcu_count += 1
        if self.skip_fcu and self.fcu_count % self.skip_fcu == 0:
            self.skipped_fcu += 1
            from .tree import PayloadStatus, PayloadStatusKind

            return PayloadStatus(PayloadStatusKind.SYNCING)
        prev = self._prev_head
        result = self.tree.on_forkchoice_updated(head, *a, **kw)
        if (self.reorg_frequency and prev is not None and prev != head
                and self.fcu_count % self.reorg_frequency == 0):
            # artificial reorg: walk back to the previous head, then forward
            self.injected_reorgs += 1
            self.tree.on_forkchoice_updated(prev)
            result = self.tree.on_forkchoice_updated(head, *a, **kw)
        self._prev_head = head
        return result

    def __getattr__(self, name):
        return getattr(self.tree, name)


class EngineMessageStore:
    """Persist every engine message as JSONL for later replay
    (reference `EngineStoreExt`/`engine-store`)."""

    def __init__(self, tree, path: str | Path):
        self.tree = tree
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def _record(self, kind: str, payload: dict):
        entry = {"ts": time.time(), "kind": kind, **payload}
        with self.path.open("a") as f:
            f.write(json.dumps(entry) + "\n")

    def on_new_payload(self, block):
        self._record("new_payload", {"block": block.encode().hex()})
        return self.tree.on_new_payload(block)

    def on_forkchoice_updated(self, head: bytes, *a, **kw):
        self._record("forkchoice_updated", {"head": head.hex()})
        return self.tree.on_forkchoice_updated(head, *a, **kw)

    def __getattr__(self, name):
        return getattr(self.tree, name)

    @classmethod
    def replay(cls, path: str | Path, tree) -> int:
        """Feed a recorded message stream into ``tree``; returns count."""
        from ..primitives.types import Block

        n = 0
        for line in Path(path).read_text().splitlines():
            msg = json.loads(line)
            if msg["kind"] == "new_payload":
                tree.on_new_payload(Block.decode(bytes.fromhex(msg["block"])))
            elif msg["kind"] == "forkchoice_updated":
                tree.on_forkchoice_updated(bytes.fromhex(msg["head"]))
            n += 1
        return n
