"""Block execution on the host: interpreter, journaled state, block executor.

A copy of the JAX package's ``evm``. Reference analogue: the revm v41
interpreter (external crate) plus reth's glue (crates/revm,
crates/evm/evm, crates/ethereum/evm). Execution stays on the host by
design: the card runs the state commitment, and this package produces the
state changes and receipts that feed the hashing and Merkle stages.
"""

from .executor import BlockExecutionOutput, BlockExecutor, EvmConfig
from .state import BlockChanges, EvmState

__all__ = [
    "EvmState",
    "BlockChanges",
    "BlockExecutor",
    "BlockExecutionOutput",
    "EvmConfig",
]
