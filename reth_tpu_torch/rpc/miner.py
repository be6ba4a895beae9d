"""miner_ namespace: payload-building knobs.

A copy of the JAX package's ``rpc/miner.py``.

Reference analogue: `MinerApi` (crates/rpc/rpc/src/miner.rs) — extra-data
/ gas-price / gas-limit setters feeding the payload builder. On a
post-merge node these tune local block building (the dev miner and the
payload service), not PoW.
"""

from __future__ import annotations

from .convert import parse_qty
from .server import RpcError


class MinerApi:
    def __init__(self, payload_service=None, pool=None):
        self.payload_service = payload_service
        self.pool = pool
        self.extra_data = b""
        self.gas_ceiling: int | None = None

    def miner_setExtra(self, extra_hex):
        raw = bytes.fromhex(extra_hex.removeprefix("0x"))
        if len(raw) > 32:
            raise RpcError(-32602, "extra data exceeds 32 bytes")
        self.extra_data = raw
        if self.payload_service is not None:
            self.payload_service.extra_data = raw
        return True

    def miner_setGasPrice(self, price):
        """Minimum tip (1559) / gas price (legacy) for pool admission."""
        if self.pool is not None:
            self.pool.config.minimal_protocol_fee = parse_qty(price)
        return True

    def miner_setGasLimit(self, limit):
        self.gas_ceiling = parse_qty(limit)
        if self.payload_service is not None:
            self.payload_service.gas_ceiling = self.gas_ceiling
        return True
