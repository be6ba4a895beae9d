"""SenderRecoveryStage: ecrecover for every tx in the range.

A copy of the JAX package's ``stages/sender_recovery.py``.

Reference analogue: `SenderRecoveryStage`
(crates/stages/stages/src/stages/sender_recovery.rs) — rayon-parallel
ecrecover into TransactionSenders. The whole commit range is one batch on
the native threaded C++ engine (``csrc/secp256k1.cpp`` via
``primitives.secp256k1.ecrecover_batch``); a failed build raises, and the
pure-Python ``recover_sender`` runs only to name an invalid signature's
reason.
"""

from __future__ import annotations

from ..primitives.types import recover_senders
from ..storage.provider import DatabaseProvider
from ..storage.tables import Tables, be64
from .api import ExecInput, ExecOutput, Stage, StageError, UnwindInput


class SenderRecoveryStage(Stage):
    id = "SenderRecovery"

    def __init__(self, max_blocks_per_commit: int = 5000):
        self.max_blocks = max_blocks_per_commit

    def execute(self, provider: DatabaseProvider, inp: ExecInput) -> ExecOutput:
        end = min(inp.target, inp.checkpoint + self.max_blocks)
        # gather the whole commit range, recover in ONE threaded batch
        txs = []
        slots = []  # (tx_num, block, index-in-block) aligned with txs
        for n in range(inp.next_block, end + 1):
            idx = provider.block_body_indices(n)
            if idx is None:
                raise StageError(f"missing body indices for block {n}", block=n)
            for i, tx in enumerate(provider.transactions_by_block(n) or []):
                txs.append(tx)
                slots.append((idx.first_tx_num + i, n, i))
        for tx, (tx_num, n, i), sender in zip(txs, slots, recover_senders(txs)):
            if sender is None:
                # re-run the single python path for the precise reason
                try:
                    tx.recover_sender()
                    reason = "recovery failed"
                except ValueError as e:
                    reason = str(e)
                raise StageError(
                    f"invalid signature in block {n} tx {i}: {reason}", block=n
                )
            provider.put_sender(tx_num, sender)
        return ExecOutput(checkpoint=end, done=end >= inp.target)

    def unwind(self, provider: DatabaseProvider, inp: UnwindInput) -> None:
        idx = provider.block_body_indices(inp.unwind_to)
        next_tx = idx.next_tx_num if idx else 0
        cur = provider.tx.cursor(Tables.TransactionSenders.name)
        doomed = [k for k, _ in cur.walk(be64(next_tx))]
        for k in doomed:
            provider.tx.delete(Tables.TransactionSenders.name, k)
