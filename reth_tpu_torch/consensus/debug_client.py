"""Debug consensus client: drive the engine from another node's RPC.

A copy of the JAX package's ``consensus/debug_client.py``. One departure: a
kernel fault (``ops/_build.is_kernel_fault``) in the follower loop is no
source hiccup. It ends the loop, is kept on the client (``fault``) and is
re-raised by ``stop()``; any other cause is skipped, as in the reference.

Reference analogue: crates/consensus/debug-client — `DebugConsensusClient`
polls an external block source (RPC or etherscan) and replays each block
into the local engine API (newPayload + forkchoiceUpdated), letting a
node follow a chain without a real CL attached.

The block source is pluggable: anything with
``block_by_number(n) -> Block | None`` and ``tip() -> int``. `RpcBlockSource`
implements it over plain JSON-RPC (debug_getRawBlock), so one reth-tpu
node can follow another.
"""

from __future__ import annotations

import json
import threading
import urllib.request

from ..ops._build import is_kernel_fault
from ..primitives.types import Block


class RpcBlockSource:
    """Fetch raw blocks from a node's public RPC."""

    def __init__(self, url: str, timeout: float = 10.0):
        self.url = url
        self.timeout = timeout

    def _rpc(self, method: str, params: list):
        req = urllib.request.Request(
            self.url,
            data=json.dumps({"jsonrpc": "2.0", "id": 1, "method": method,
                             "params": params}).encode(),
            headers={"Content-Type": "application/json"},
        )
        out = json.loads(urllib.request.urlopen(req, timeout=self.timeout).read())
        if "error" in out:
            raise RuntimeError(f"{method}: {out['error']}")
        return out["result"]

    def tip(self) -> int:
        return int(self._rpc("eth_blockNumber", []), 16)

    def block_by_number(self, n: int) -> Block | None:
        try:
            raw = self._rpc("debug_getRawBlock", [hex(n)])
        except RuntimeError:
            return None
        if raw is None:
            return None
        return Block.decode(bytes.fromhex(raw.removeprefix("0x")))


class DebugConsensusClient:
    """Poll a block source, replay new blocks into the local engine tree."""

    def __init__(self, tree, source, poll_interval: float = 1.0):
        self.tree = tree
        self.source = source
        self.poll_interval = poll_interval
        self.blocks_applied = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.fault: BaseException | None = None  # the kernel fault that ended the loop

    def run_once(self) -> int:
        """Apply every block past our head; returns how many were applied."""
        from ..engine.tree import PayloadStatusKind

        with self.tree.factory.provider() as p:
            local = p.last_block_number()
            # the tree may hold unpersisted canonical blocks past the DB tip
            entry = self.tree.blocks.get(self.tree.head_hash)
            if entry is not None:
                local = max(local, entry.block.header.number)
        remote = self.source.tip()
        applied = 0
        for n in range(local + 1, remote + 1):
            block = self.source.block_by_number(n)
            if block is None:
                break
            st = self.tree.on_new_payload(block)
            if st.status is not PayloadStatusKind.VALID:
                raise RuntimeError(
                    f"source block {n} rejected: {st.validation_error}")
            self.tree.on_forkchoice_updated(block.hash)
            applied += 1
            self.blocks_applied += 1
        return applied

    def start(self):
        def loop():
            while not self._stop.wait(self.poll_interval):
                try:
                    self.run_once()
                except Exception as e:  # noqa: BLE001 — source hiccups must not
                    # kill the follower loop; a kernel fault ends it
                    if is_kernel_fault(e):
                        self.fault = e
                        return
                    continue
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        if self.fault is not None:
            raise self.fault
