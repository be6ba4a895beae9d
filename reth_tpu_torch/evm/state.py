"""A block's changeset capture: the previous-images of what it touched.

A copy of the JAX package's ``evm/state.py`` ``BlockChanges``, the part the
live tip reads. The journaled ``EvmState`` and the ``StateSource`` read
interface need the interpreter, which is not ported yet (ROADMAP A item 7).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..primitives.types import Account


@dataclass
class BlockChanges:
    """Previous-images of everything a block touched (changeset rows)."""

    accounts: dict[bytes, Account | None] = field(default_factory=dict)
    storage: dict[bytes, dict[bytes, int]] = field(default_factory=dict)
    wiped_storage: set[bytes] = field(default_factory=set)
    new_bytecodes: dict[bytes, bytes] = field(default_factory=dict)
