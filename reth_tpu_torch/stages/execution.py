"""ExecutionStage: run blocks through the EVM, write state + changesets.

A copy of the JAX package's ``stages/execution.py``.

Reference analogue: `ExecutionStage`
(crates/stages/stages/src/stages/execution/), which executes a block
range with revm and writes changesets/receipts; unwind restores plain
state from the changesets (reverse order).

Execution runs on the host. Post-execution validation (receipts root, gas,
bloom, requests) runs on the consensus's committer: with no consensus the
stage builds ``EthBeaconConsensus(device=device)``, whose receipts roots
hash on kernel 1 on the card. A fault there is the ``StageError``'s cause.
"""

from __future__ import annotations

import torch

from ..consensus import EthBeaconConsensus
from ..evm import BlockExecutor, EvmConfig
from ..evm.executor import ProviderStateSource
from ..storage.provider import DatabaseProvider
from .api import ExecInput, ExecOutput, Stage, StageError, UnwindInput


class ExecutionStage(Stage):
    id = "Execution"

    def __init__(self, config: EvmConfig | None = None, consensus=None,
                 max_blocks_per_commit: int = 1000, device: str | torch.device = "cuda"):
        self.config = config or EvmConfig()
        self.consensus = consensus or EthBeaconConsensus(device=device)
        self.max_blocks = max_blocks_per_commit

    def execute(self, provider: DatabaseProvider, inp: ExecInput) -> ExecOutput:
        end = min(inp.target, inp.checkpoint + self.max_blocks)
        source = ProviderStateSource(provider)
        executor = BlockExecutor(source, self.config)
        block_hashes_cache: dict[int, bytes] = {}

        for n in range(inp.next_block, end + 1):
            block = provider.block_by_number(n)
            if block is None:
                raise StageError(f"missing block {n}", block=n)
            idx = provider.block_body_indices(n)
            senders = [provider.sender(t) for t in range(idx.first_tx_num, idx.next_tx_num)]
            if any(s is None for s in senders):
                raise StageError(f"missing senders for block {n}", block=n)
            # BLOCKHASH window
            for h in range(max(0, n - 256), n):
                if h not in block_hashes_cache:
                    bh = provider.canonical_hash(h)
                    if bh:
                        block_hashes_cache[h] = bh
            try:
                out = executor.execute(block, senders, block_hashes_cache)
            except Exception as e:
                raise StageError(f"execution failed at {n}: {e}", block=n) from e
            try:
                self.consensus.validate_block_post_execution(
                    block, out.receipts, out.gas_used, requests=out.requests
                )
            except Exception as e:
                raise StageError(f"post-execution validation failed at {n}: {e}",
                                 block=n) from e
            self._write_output(provider, n, idx.first_tx_num, out)
            block_hashes_cache[n] = block.hash
        return ExecOutput(checkpoint=end, done=end >= inp.target)

    def _write_output(self, provider: DatabaseProvider, block_num: int,
                      first_tx_num: int, out) -> None:
        write_execution_output(provider, block_num, first_tx_num, out)

    def unwind(self, provider: DatabaseProvider, inp: UnwindInput) -> None:
        """Restore plain state from changesets for blocks > unwind_to."""
        accounts = provider.account_changes_in_range(inp.unwind_to + 1, inp.checkpoint)
        storages = provider.storage_changes_in_range(inp.unwind_to + 1, inp.checkpoint)
        for addr, prev in accounts.items():
            provider.put_account(addr, prev)
        for addr, slots in storages.items():
            for slot, prev_val in slots.items():
                provider.put_storage(addr, slot, prev_val)
        provider.prune_changesets_above(inp.unwind_to)
        provider.prune_receipts_above(inp.unwind_to)


def write_execution_output(provider: DatabaseProvider, block_num: int,
                           first_tx_num: int, out) -> None:
    """Write a `BlockExecutionOutput`: plain state, changesets, receipts.

    Shared by the staged-sync ExecutionStage and the engine live-tip path
    (which targets an overlay transaction instead of the real DB)."""
    changes = out.changes
    # changesets: previous images (wiped storage records its whole map)
    for addr, prev in changes.accounts.items():
        provider.record_account_change(block_num, addr, prev)
    wiped_prev: dict[bytes, dict[bytes, int]] = {}
    for addr in changes.wiped_storage:
        wiped_prev[addr] = provider.account_storage(addr)
        for slot, prev_val in wiped_prev[addr].items():
            provider.record_storage_change(block_num, addr, slot, prev_val)
    for addr, slots in changes.storage.items():
        already = wiped_prev.get(addr, {})
        for slot, prev_val in slots.items():
            if slot not in already:
                provider.record_storage_change(block_num, addr, slot, prev_val)
    # plain state
    for addr in changes.wiped_storage:
        provider.clear_account_storage(addr)
    for addr, acc in out.post_accounts.items():
        provider.put_account(addr, acc)
    for addr, slots in out.post_storage.items():
        for slot, val in slots.items():
            provider.put_storage(addr, slot, val)
    for code_hash, code in changes.new_bytecodes.items():
        provider.put_bytecode(code_hash, code)
    # receipts
    for i, receipt in enumerate(out.receipts):
        provider.put_receipt(first_tx_num + i, receipt)
