"""RPC type conversion: hex quantities, block/tx/receipt JSON shapes.

A copy of the JAX package's ``rpc/convert.py``.

Reference analogue: rpc-convert + alloy-rpc-types serialisation.
"""

from __future__ import annotations

from ..primitives.rlp import rlp_encode
from ..primitives.types import Block, Header, Receipt, Transaction


def qty(v: int) -> str:
    return hex(v)


def data(b: bytes) -> str:
    return "0x" + b.hex()


def parse_qty(s) -> int:
    if isinstance(s, int):
        return s
    return int(s, 16)


def parse_data(s: str) -> bytes:
    return bytes.fromhex(s[2:] if s.startswith("0x") else s)


def header_to_rpc(header: Header, include_hash: bool = True) -> dict:
    out = {
        "parentHash": data(header.parent_hash),
        "sha3Uncles": data(header.ommers_hash),
        "miner": data(header.beneficiary),
        "stateRoot": data(header.state_root),
        "transactionsRoot": data(header.transactions_root),
        "receiptsRoot": data(header.receipts_root),
        "logsBloom": data(header.logs_bloom),
        "difficulty": qty(header.difficulty),
        "number": qty(header.number),
        "gasLimit": qty(header.gas_limit),
        "gasUsed": qty(header.gas_used),
        "timestamp": qty(header.timestamp),
        "extraData": data(header.extra_data),
        "mixHash": data(header.mix_hash),
        "nonce": data(header.nonce),
    }
    if header.base_fee_per_gas is not None:
        out["baseFeePerGas"] = qty(header.base_fee_per_gas)
    if header.withdrawals_root is not None:
        out["withdrawalsRoot"] = data(header.withdrawals_root)
    if header.blob_gas_used is not None:
        out["blobGasUsed"] = qty(header.blob_gas_used)
    if header.excess_blob_gas is not None:
        out["excessBlobGas"] = qty(header.excess_blob_gas)
    if header.parent_beacon_block_root is not None:
        out["parentBeaconBlockRoot"] = data(header.parent_beacon_block_root)
    if include_hash:
        out["hash"] = data(header.hash)
    return out


def tx_to_rpc(tx: Transaction, block: Header | None = None, index: int | None = None,
              sender: bytes | None = None) -> dict:
    # legacy txs report the EIP-155 v; typed txs report yParity (v mirrors it)
    if tx.tx_type == 0:
        v = (tx.chain_id * 2 + 35 + tx.y_parity) if tx.chain_id is not None else (27 + tx.y_parity)
    else:
        v = tx.y_parity
    out = {
        "type": qty(tx.tx_type),
        "nonce": qty(tx.nonce),
        "gas": qty(tx.gas_limit),
        "value": qty(tx.value),
        "input": data(tx.data),
        "to": data(tx.to) if tx.to else None,
        "hash": data(tx.hash),
        "r": qty(tx.r),
        "s": qty(tx.s),
        "v": qty(v),
        "yParity": qty(tx.y_parity),
    }
    if tx.chain_id is not None:
        out["chainId"] = qty(tx.chain_id)
    if tx.tx_type >= 2:
        out["maxFeePerGas"] = qty(tx.max_fee_per_gas)
        out["maxPriorityFeePerGas"] = qty(tx.max_priority_fee_per_gas)
    else:
        out["gasPrice"] = qty(tx.gas_price)
    if block is not None:
        out["blockHash"] = data(block.hash)
        out["blockNumber"] = qty(block.number)
        out["transactionIndex"] = qty(index)
    else:  # pending: spec requires explicit nulls
        out["blockHash"] = None
        out["blockNumber"] = None
        out["transactionIndex"] = None
    if sender is None:
        try:
            sender = tx.recover_sender()
        except ValueError:
            sender = None
    if sender is not None:
        out["from"] = data(sender)
    return out


def block_to_rpc(block: Block, full_txs: bool = False, senders=None) -> dict:
    out = header_to_rpc(block.header)
    if full_txs:
        out["transactions"] = [
            tx_to_rpc(tx, block.header, i, senders[i] if senders else None)
            for i, tx in enumerate(block.transactions)
        ]
    else:
        out["transactions"] = [data(tx.hash) for tx in block.transactions]
    out["uncles"] = []
    out["size"] = qty(len(block.encode()))
    if block.withdrawals is not None:
        out["withdrawals"] = [
            {
                "index": qty(w.index),
                "validatorIndex": qty(w.validator_index),
                "address": data(w.address),
                "amount": qty(w.amount),
            }
            for w in block.withdrawals
        ]
    return out


def receipt_to_rpc(receipt: Receipt, tx: Transaction, header: Header, index: int,
                   prev_cumulative: int, sender: bytes | None, log_index_base: int) -> dict:
    contract_address = None
    if tx.to is None and sender is not None:
        from ..primitives.keccak import keccak256
        from ..primitives.rlp import encode_int

        contract_address = keccak256(rlp_encode([sender, encode_int(tx.nonce)]))[12:]
    return {
        "transactionHash": data(tx.hash),
        "transactionIndex": qty(index),
        "blockHash": data(header.hash),
        "blockNumber": qty(header.number),
        "from": data(sender) if sender else None,
        "to": data(tx.to) if tx.to else None,
        "cumulativeGasUsed": qty(receipt.cumulative_gas_used),
        "gasUsed": qty(receipt.cumulative_gas_used - prev_cumulative),
        "contractAddress": data(contract_address) if contract_address else None,
        "logs": [
            {
                "address": data(log.address),
                "topics": [data(t) for t in log.topics],
                "data": data(log.data),
                "blockNumber": qty(header.number),
                "blockHash": data(header.hash),
                "transactionHash": data(tx.hash),
                "transactionIndex": qty(index),
                "logIndex": qty(log_index_base + i),
                "removed": False,
            }
            for i, log in enumerate(receipt.logs)
        ],
        "logsBloom": data(receipt.bloom()),
        "type": qty(receipt.tx_type),
        "status": qty(1 if receipt.success else 0),
        "effectiveGasPrice": qty(tx.effective_gas_price(header.base_fee_per_gas)),
    }
