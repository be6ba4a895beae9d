"""Transaction pool: validation, subpools, best-transaction ordering.

A copy of the JAX package's ``pool``: ``pool.py`` (the pool), ``blobstore.py``
(blob sidecars, on the port's ``primitives/kzg.py``) and ``batcher.py``
(batched admission, senders by the port's native batch,
``csrc/secp256k1.cpp``).

Reference analogue: crates/transaction-pool — the `TransactionPool` trait
(src/traits.rs:114), the pending/queued/basefee subpool state machine
(src/pool/), `BestTransactions` (src/pool/best.rs), validation
(src/validate/), and the canonical-state maintenance loop
(src/maintain.rs).
"""

from .pool import PoolConfig, PoolError, TransactionPool
from .batcher import PoolOverloaded, TxBatcher

__all__ = ["PoolConfig", "PoolError", "PoolOverloaded", "TransactionPool",
           "TxBatcher"]
