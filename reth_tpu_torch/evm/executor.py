"""A block's execution output.

A copy of the JAX package's ``evm/executor.py`` ``BlockExecutionOutput``
(reference `BlockExecutionOutput`, crates/evm/execution-types), the fields
the live tip reads: ``changes`` and the post-block ``post_accounts`` /
``post_storage``. ``receipts`` is an untyped list here. The block executor
that fills it is not ported yet (ROADMAP A item 7).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..primitives.types import Account
from .state import BlockChanges


@dataclass
class BlockExecutionOutput:
    """Everything downstream stages need (reference `BlockExecutionOutput`)."""

    receipts: list = field(default_factory=list)
    gas_used: int = 0
    changes: BlockChanges | None = None
    post_accounts: dict[bytes, Account | None] = field(default_factory=dict)
    post_storage: dict[bytes, dict[bytes, int]] = field(default_factory=dict)
    senders: list[bytes] = field(default_factory=list)
    # EIP-7685 execution requests (Prague+): type-prefixed payloads in
    # ascending type order, empty payloads excluded
    requests: list[bytes] = field(default_factory=list)
    # per-tx return data (eth_simulateV1 and tracing consumers)
    tx_outputs: list[bytes] = field(default_factory=list)
