"""eth_callBundle: simulate a bundle of signed transactions atop a block.

A copy of the JAX package's ``rpc/flashbots.py``. A builder submission's
ordered roots and post-state root hash on the tree's committer (kernel 1 on
the card). One departure: neither catch-all (a bundle's per-transaction
error, an ``Invalid`` submission) swallows a kernel fault
(``ops/_build.is_kernel_fault``); it re-raises. Any other cause is handled
as in the reference.

Reference analogue: `EthBundle` / `EthCallBundle` (crates/rpc/rpc/src/
eth/bundle.rs) — searcher tooling: execute raw txs sequentially against
the parent state (without touching the canonical chain), report per-tx
results, gas, and the coinbase payment summary.
"""

from __future__ import annotations

from ..evm import BlockExecutor
from ..evm.state import EvmState
from ..ops._build import is_kernel_fault
from ..primitives.keccak import keccak256
from ..primitives.types import Transaction
from .convert import data, parse_data, parse_qty, qty
from .server import RpcError

MAX_BUNDLE_TXS = 100


class BundleApi:
    def __init__(self, eth_api):
        self.eth = eth_api

    def eth_callBundle(self, bundle):
        txs_raw = bundle.get("txs") or []
        if not txs_raw:
            raise RpcError(-32602, "bundle missing txs")
        if len(txs_raw) > MAX_BUNDLE_TXS:
            raise RpcError(-32602, "bundle too large")
        state_tag = bundle.get("stateBlockNumber", "latest")
        p = self.eth._state_at(state_tag)
        env = self.eth._call_env(state_tag)
        # simulate as the NEXT block unless pinned
        if "blockNumber" in bundle:
            env.number = parse_qty(bundle["blockNumber"])
        else:
            env.number += 1
        if "timestamp" in bundle:
            env.timestamp = parse_qty(bundle["timestamp"])

        from ..evm.executor import ProviderStateSource

        executor = BlockExecutor(ProviderStateSource(p),
                                 self.eth.tree.config)
        state = EvmState(executor.source)
        coinbase_before = state.balance(env.coinbase)
        results = []
        total_gas = 0
        total_fees = 0
        gas_available = env.gas_limit
        for raw in txs_raw:
            tx = Transaction.decode(parse_data(raw))
            sender = tx.recover_sender()
            try:
                res = executor._execute_tx(state, env, tx, sender, gas_available)
            except Exception as e:  # noqa: BLE001 — invalid tx in bundle
                if is_kernel_fault(e):
                    raise
                results.append({"txHash": data(tx.hash), "error": str(e)})
                continue
            gas_available -= res.gas_used
            gas_price = tx.effective_gas_price(env.base_fee)
            total_gas += res.gas_used
            tip = (gas_price - env.base_fee) * res.gas_used
            total_fees += tip
            entry = {
                "txHash": data(tx.hash),
                "gasUsed": res.gas_used,
                "gasPrice": qty(gas_price),
                "fromAddress": data(sender),
                "toAddress": data(tx.to) if tx.to else None,
                "gasFees": qty(tip),
                "coinbaseDiff": qty(tip),
                "value": data(res.output),
            }
            if not res.success:
                entry["revert"] = data(res.output)
            results.append(entry)
        # the executor already credits priority fees to the coinbase, so the
        # balance delta IS the full diff (tips + direct transfers)
        coinbase_diff = state.balance(env.coinbase) - coinbase_before
        bundle_hash = keccak256(b"".join(
            Transaction.decode(parse_data(r)).hash for r in txs_raw))
        return {
            "bundleHash": data(bundle_hash),
            "bundleGasPrice": qty(total_fees // total_gas if total_gas else 0),
            "coinbaseDiff": qty(coinbase_diff),
            "ethSentToCoinbase": qty(max(0, coinbase_diff - total_fees)),
            "gasFees": qty(total_fees),
            "totalGasUsed": total_gas,
            "stateBlockNumber": env.number - 1,
            "results": results,
        }


class ValidationApi:
    """Builder-submission validation (reference crates/rpc/rpc/src/
    validation.rs): relays call this to check a builder's block BEFORE
    proposing it — full consensus + execution validation against the
    parent, plus the proposer-payment check, with no side effects on the
    canonical chain."""

    def __init__(self, eth_api):
        self.eth = eth_api

    def flashbots_validateBuilderSubmissionV3(self, request):
        from ..consensus import ConsensusError
        from ..evm import BlockExecutor
        from ..evm.executor import ProviderStateSource
        from .engine_api import payload_to_block

        payload = request.get("executionPayload") or request.get(
            "execution_payload")
        message = request.get("message") or {}
        if payload is None:
            raise RpcError(-32602, "missing executionPayload")
        block = payload_to_block(payload, self.eth.tree.committer)
        claimed_hash = payload.get("blockHash") or payload.get("block_hash")
        if claimed_hash is not None and parse_data(claimed_hash) != block.header.hash:
            return {"status": "Invalid",
                    "validationError": "block hash mismatch"}
        registered = message.get("gasLimit")
        if registered is not None and parse_qty(registered) != block.header.gas_limit:
            # reference enforces the registered gas limit is honored when
            # reachable; exact match keeps the check simple and strict
            return {"status": "Invalid",
                    "validationError": "gas limit does not match registered"}
        tree = self.eth.tree
        try:
            parent_provider = tree.overlay_provider(block.header.parent_hash)
        except KeyError:
            return {"status": "Invalid", "validationError": "unknown parent"}
        parent = parent_provider.header_by_number(block.header.number - 1)
        try:
            tree.consensus.validate_header_against_parent(block.header, parent)
            tree.consensus.validate_block_pre_execution(block)
        except ConsensusError as e:
            return {"status": "Invalid", "validationError": str(e)}
        fee_recipient = parse_data(message["feeRecipient"]) if \
            message.get("feeRecipient") else block.header.beneficiary
        balance_before = parent_provider.account(fee_recipient)
        balance_before = balance_before.balance if balance_before else 0
        src = ProviderStateSource(parent_provider)
        executor = BlockExecutor(src, tree.config)
        # BLOCKHASH window, same as the engine newPayload path — without it
        # a valid block reading BLOCKHASH(n-k) would execute differently
        # here and false-fail the state-root check below
        hashes = {}
        for k in range(max(0, block.header.number - 256), block.header.number):
            bh = parent_provider.canonical_hash(k)
            if bh:
                hashes[k] = bh
        try:
            senders = [tx.recover_sender() for tx in block.transactions]
            out = executor.execute(block, senders, hashes)
            tree.consensus.validate_block_post_execution(
                block, out.receipts, out.gas_used)
        except Exception as e:  # noqa: BLE001 — any failure = invalid submission
            if is_kernel_fault(e):
                raise
            return {"status": "Invalid", "validationError": str(e)}
        # post-state root: a builder block with a bogus state_root must be
        # rejected exactly like the engine newPayload path (tree.py) — the
        # scratch overlay is discarded, so validation stays side-effect-free
        scratch = tree.overlay_provider(block.header.parent_hash)
        computed_root = tree._state_root_job(scratch, out)
        if computed_root != block.header.state_root:
            return {"status": "Invalid",
                    "validationError":
                        f"state root mismatch: computed {computed_root.hex()} "
                        f"header {block.header.state_root.hex()}"}
        # proposer payment: balance delta of the fee recipient, or the
        # last transaction paying them directly (reference accepts both)
        after = out.post_accounts.get(fee_recipient)
        balance_after = (after.balance if after is not None
                         else balance_before)
        delta = balance_after - balance_before
        last_tx_payment = 0
        if block.transactions:
            last = block.transactions[-1]
            if last.to == fee_recipient and out.receipts[-1].success:
                last_tx_payment = last.value
        expected = parse_qty(message.get("value", "0x0"))
        paid = max(delta, last_tx_payment)
        if paid < expected:
            return {"status": "Invalid",
                    "validationError":
                        f"proposer payment {paid} below bid value {expected}"}
        return {"status": "Valid", "proposerPayment": qty(paid)}
