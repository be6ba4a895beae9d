"""TransactionLookupStage + FinishStage.

A copy of the JAX package's ``stages/tx_lookup.py``.

Reference analogue: `TransactionLookupStage`
(crates/stages/stages/src/stages/tx_lookup.rs) building
TransactionHashNumbers, and `FinishStage` marking the sync target reached.
"""

from __future__ import annotations

from ..storage.provider import DatabaseProvider
from ..storage.tables import Tables, be64
from .api import ExecInput, ExecOutput, Stage, UnwindInput


class TransactionLookupStage(Stage):
    id = "TransactionLookup"

    def execute(self, provider: DatabaseProvider, inp: ExecInput) -> ExecOutput:
        for n in range(inp.next_block, inp.target + 1):
            idx = provider.block_body_indices(n)
            if idx is None:
                continue
            txs = provider.transactions_by_block(n) or []
            for i, tx in enumerate(txs):
                provider.tx.put(
                    Tables.TransactionHashNumbers.name, tx.hash, be64(idx.first_tx_num + i)
                )
        return ExecOutput(checkpoint=inp.target)

    def unwind(self, provider: DatabaseProvider, inp: UnwindInput) -> None:
        for n in range(inp.unwind_to + 1, inp.checkpoint + 1):
            txs = provider.transactions_by_block(n) or []
            for tx in txs:
                provider.tx.delete(Tables.TransactionHashNumbers.name, tx.hash)
