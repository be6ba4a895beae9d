"""Gas price oracle: percentile of recent blocks' cheapest tips, cached.

A copy of the JAX package's ``rpc/gas_oracle.py``.

Reference analogue: `GasPriceOracle` (crates/rpc/rpc-eth-types/src/
gas_oracle.rs) — samples the lowest-priced transactions of the last N
blocks, takes a percentile, clamps, and caches per head block so RPC
storms don't re-walk the chain.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class GasOracleConfig:
    blocks: int = 20              # sample window
    percentile: int = 60          # reference default
    max_price: int = 500 * 10**9  # 500 gwei cap
    ignore_price: int = 2         # wei: ignore dust-priced txs
    default_tip: int = 10**9      # empty-chain fallback
    max_header_history: int = 1024


class GasPriceOracle:
    def __init__(self, config: GasOracleConfig | None = None):
        self.config = config or GasOracleConfig()
        self._cache: tuple[bytes, int] | None = None  # (head hash, tip)

    def suggest_tip_cap(self, provider) -> int:
        """Suggested priority fee; ``provider`` is a DatabaseProvider-like."""
        cfg = self.config
        tip_num = provider.last_block_number()
        head = provider.header_by_number(tip_num)
        if head is None:
            return cfg.default_tip
        if self._cache is not None and self._cache[0] == head.hash:
            return self._cache[1]
        samples: list[int] = []
        n = tip_num
        while n > 0 and len(samples) < cfg.blocks * 3 \
                and n > tip_num - cfg.blocks:
            h = provider.header_by_number(n)
            txs = provider.transactions_by_block(n) or []
            base = h.base_fee_per_gas or 0
            tips = sorted(
                t.effective_gas_price(base) - base for t in txs
            )
            # the reference takes up to 3 cheapest non-dust txs per block
            got = 0
            for t in tips:
                if t >= cfg.ignore_price:
                    samples.append(t)
                    got += 1
                    if got == 3:
                        break
            n -= 1
        if not samples:
            tip = cfg.default_tip
        else:
            from ..metrics import sample_percentile

            samples.sort()
            tip = sample_percentile(samples, cfg.percentile)
        tip = min(tip, cfg.max_price)
        self._cache = (head.hash, tip)
        return tip

    def suggest_gas_price(self, provider) -> int:
        """Legacy-style price: next base fee + suggested tip."""
        tip_num = provider.last_block_number()
        head = provider.header_by_number(tip_num)
        base = (head.base_fee_per_gas or 0) if head else 0
        return base + self.suggest_tip_cap(provider)
