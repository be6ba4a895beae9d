"""Consensus validation (post-merge Ethereum rules).

A copy of the JAX package's ``consensus/__init__.py``.

Reference analogue: `Consensus`/`FullConsensus`/`HeaderValidator` traits +
`EthBeaconConsensus` (crates/consensus/consensus/src/lib.rs,
crates/ethereum/consensus/src/lib.rs).
"""

from .validation import (
    ConsensusError,
    EthBeaconConsensus,
    calc_next_base_fee,
    validate_block_post_execution,
    validate_block_pre_execution,
    validate_header_against_parent,
)

__all__ = [
    "ConsensusError",
    "EthBeaconConsensus",
    "calc_next_base_fee",
    "validate_block_post_execution",
    "validate_block_pre_execution",
    "validate_header_against_parent",
]
