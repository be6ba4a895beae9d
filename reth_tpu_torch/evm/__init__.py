"""Block execution's output types: what the live tip reads from an executed
block.

Of the JAX package's ``evm`` only the two output dataclasses are ported,
``BlockChanges`` and ``BlockExecutionOutput``; the interpreter, the
journaled state and the block executor are not ported yet (ROADMAP A item
7).
"""

from .executor import BlockExecutionOutput
from .state import BlockChanges

__all__ = ["BlockChanges", "BlockExecutionOutput"]
