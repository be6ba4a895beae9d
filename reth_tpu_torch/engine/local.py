"""Dev-mode local miner: drives the FCU/payload loop without a CL.

A copy of the JAX package's ``engine/local.py`` on the port's builder and
engine tree. One departure: a kernel fault (``ops/_build.is_kernel_fault``)
in the producer's seal raises out of ``mine_block`` instead of falling back
to the serial build; any other cause falls back and is counted in
``producer_fallbacks``. ``last_stats`` holds the last build's walls
(selection, state root, ordered roots).

Reference analogue: `LocalMiner` (crates/engine/local/src/lib.rs) — in
dev mode the node mines its own blocks from the pool on an interval or
on demand.
"""

from __future__ import annotations

from ..consensus.validation import calc_next_base_fee
from ..metrics import producer_metrics
from ..ops._build import is_kernel_fault
from ..payload import PayloadAttributes, build_payload
from .tree import EngineTree, PayloadStatusKind


class LocalMiner:
    def __init__(self, tree: EngineTree, pool, block_time: int = 12,
                 producer=None):
        self.tree = tree
        self.pool = pool
        self.block_time = block_time
        # continuous-build mode: seal the producer's hot candidate instead
        # of running a fresh greedy build per block
        self.producer = producer
        self.producer_seals = 0
        self.serial_builds = 0
        self.producer_fallbacks = 0
        self.last_stats: dict = {}

    def mine_block(self, timestamp: int | None = None):
        """Build one block from the pool, submit it, make it canonical."""
        head = self.tree.head_hash
        overlay = self.tree.overlay_provider(head)
        parent = overlay.header_by_number(overlay.block_number(head))
        ts = timestamp if timestamp is not None else parent.timestamp + self.block_time
        # instant sealing can produce several blocks per wall-clock second;
        # consensus requires strictly increasing timestamps (geth dev mode
        # applies the same clamp)
        attrs = PayloadAttributes(timestamp=max(ts, parent.timestamp + 1))
        block = None
        if self.producer is not None:
            try:
                block, _fees = self.producer.take(head, attrs)
                self.producer_seals += 1
                self.last_stats = self.producer.last_stats
            except Exception as e:  # noqa: BLE001 — the serial build is always
                if is_kernel_fault(e):  # the fallback; mining must not fail
                    raise
                self.producer_fallbacks += 1
                producer_metrics.record_fallback("miner_producer")
                block = None
        if block is None:
            self.last_stats = {}
            block, _fees = build_payload(self.tree, self.pool, head, attrs,
                                         stats=self.last_stats)
            self.serial_builds += 1
        st = self.tree.on_new_payload(block)
        if st.status is not PayloadStatusKind.VALID:
            raise RuntimeError(f"self-mined block invalid: {st.validation_error}")
        self.tree.on_forkchoice_updated(block.hash)
        next_blob_fee = None
        if block.header.excess_blob_gas is not None:
            from ..evm.executor import blob_base_fee, next_excess_blob_gas

            params = self.tree.config.blob_params_for(
                block.header.number + 1, block.header.timestamp)
            next_blob_fee = blob_base_fee(next_excess_blob_gas(
                block.header.excess_blob_gas, block.header.blob_gas_used or 0,
                params.target_gas), params.update_fraction)
        self.pool.on_canonical_state_change(calc_next_base_fee(block.header),
                                            blob_base_fee=next_blob_fee)
        return block
