"""The engine_* namespace: the CL ↔ EL boundary.

A copy of the JAX package's ``rpc/engine_api.py`` on the port's engine tree
and payload service. A payload's ordered roots (transactions, withdrawals)
hash on the tree's committer, kernel 1 on the card; ``engine_newPayload``
roots the block through the tree (kernels 1 and 4 on its hot-state arena).

Reference analogue: crates/rpc/rpc-engine-api/src/engine_api.rs —
newPayloadV1-V3, forkchoiceUpdatedV1-V3, getPayloadV1-V3, capabilities.
Payload JSON ↔ Block conversion follows the ExecutionPayload schema.
"""

from __future__ import annotations

from ..engine.tree import EngineTree, PayloadStatusKind
from ..payload import PayloadAttributes, PayloadBuilderService
from ..primitives.types import Block, Header, Transaction, Withdrawal, EMPTY_OMMER_ROOT_HASH
from .convert import data, parse_data, parse_qty, qty
from .server import RpcError

CAPABILITIES = [
    "engine_newPayloadV1", "engine_newPayloadV2", "engine_newPayloadV3",
    "engine_newPayloadV4", "engine_newPayloadV5",
    "engine_getPayloadV4", "engine_getPayloadV5",
    "engine_getBlobsV1", "engine_getBlobsV2",
    "engine_forkchoiceUpdatedV1", "engine_forkchoiceUpdatedV2",
    "engine_forkchoiceUpdatedV3",
    "engine_getPayloadV1", "engine_getPayloadV2", "engine_getPayloadV3",
    "engine_getPayloadBodiesByHashV1", "engine_getPayloadBodiesByRangeV1",
    "engine_exchangeCapabilities", "engine_getClientVersionV1",
]


def payload_to_block(payload: dict, committer=None, device: str = "cuda") -> Block:
    """ExecutionPayloadV1/V2/V3 JSON → sealed Block.

    ``committer`` must be the node's TrieCommitter — constructing a default
    one here (``TrieCommitter(device=device)``, the card unless the caller
    asks for the CPU) would build a fresh device hasher per request.
    """
    withdrawals = None
    if "withdrawals" in payload and payload["withdrawals"] is not None:
        withdrawals = tuple(
            Withdrawal(
                parse_qty(w["index"]), parse_qty(w["validatorIndex"]),
                parse_data(w["address"]), parse_qty(w["amount"]),
            )
            for w in payload["withdrawals"]
        )
    txs = tuple(Transaction.decode(parse_data(t)) for t in payload["transactions"])
    from ..trie.state_root import ordered_trie_root
    from ..primitives.rlp import rlp_encode

    header = Header(
        parent_hash=parse_data(payload["parentHash"]),
        ommers_hash=EMPTY_OMMER_ROOT_HASH,
        beneficiary=parse_data(payload["feeRecipient"]),
        state_root=parse_data(payload["stateRoot"]),
        transactions_root=ordered_trie_root(
            [parse_data(t) for t in payload["transactions"]], committer, device
        ),
        receipts_root=parse_data(payload["receiptsRoot"]),
        logs_bloom=parse_data(payload["logsBloom"]),
        difficulty=0,
        number=parse_qty(payload["blockNumber"]),
        gas_limit=parse_qty(payload["gasLimit"]),
        gas_used=parse_qty(payload["gasUsed"]),
        timestamp=parse_qty(payload["timestamp"]),
        extra_data=parse_data(payload["extraData"]),
        mix_hash=parse_data(payload["prevRandao"]),
        nonce=b"\x00" * 8,
        base_fee_per_gas=parse_qty(payload["baseFeePerGas"]),
        withdrawals_root=(
            ordered_trie_root([rlp_encode(w.rlp_fields()) for w in withdrawals], committer,
                              device)
            if withdrawals is not None else None
        ),
        blob_gas_used=parse_qty(payload["blobGasUsed"]) if "blobGasUsed" in payload else None,
        excess_blob_gas=parse_qty(payload["excessBlobGas"]) if "excessBlobGas" in payload else None,
        parent_beacon_block_root=None,
    )
    return Block(header, txs, (), withdrawals)


def block_to_payload(block: Block) -> dict:
    h = block.header
    out = {
        "parentHash": data(h.parent_hash),
        "feeRecipient": data(h.beneficiary),
        "stateRoot": data(h.state_root),
        "receiptsRoot": data(h.receipts_root),
        "logsBloom": data(h.logs_bloom),
        "prevRandao": data(h.mix_hash),
        "blockNumber": qty(h.number),
        "gasLimit": qty(h.gas_limit),
        "gasUsed": qty(h.gas_used),
        "timestamp": qty(h.timestamp),
        "extraData": data(h.extra_data),
        "baseFeePerGas": qty(h.base_fee_per_gas or 0),
        "blockHash": data(h.hash),
        "transactions": [data(tx.encode()) for tx in block.transactions],
    }
    if block.withdrawals is not None:
        out["withdrawals"] = [
            {
                "index": qty(w.index), "validatorIndex": qty(w.validator_index),
                "address": data(w.address), "amount": qty(w.amount),
            }
            for w in block.withdrawals
        ]
    if h.blob_gas_used is not None:
        out["blobGasUsed"] = qty(h.blob_gas_used)
        out["excessBlobGas"] = qty(h.excess_blob_gas)
    return out


def compute_requests_hash(requests: list[bytes]) -> bytes:
    """EIP-7685: sha256 over the sha256 of each non-empty request item."""
    import hashlib

    acc = b"".join(
        hashlib.sha256(r).digest() for r in requests if len(r) > 1
    )
    return hashlib.sha256(acc).digest()


class EngineApi:
    def __init__(self, tree: EngineTree, payload_service: PayloadBuilderService | None = None,
                 pool=None):
        self.tree = tree
        self.payloads = payload_service
        self.pool = pool  # blob sidecars for getPayload bundles + getBlobs

    def _status_json(self, st) -> dict:
        return {
            "status": st.status.value,
            "latestValidHash": data(st.latest_valid_hash) if st.latest_valid_hash else None,
            "validationError": st.validation_error,
        }

    def engine_getClientVersionV1(self, client_version=None):
        """Client identification handshake (reference
        engine_getClientVersionV1, rpc-api/src/engine.rs)."""
        from .. import __version__

        return [{"code": "RT", "name": "reth-tpu", "version": __version__,
                 "commit": "00000000"}]

    def engine_exchangeCapabilities(self, caps=None):
        return CAPABILITIES

    def engine_newPayloadV1(self, payload):
        return self._new_payload(payload)

    def engine_newPayloadV2(self, payload):
        return self._new_payload(payload)

    def engine_newPayloadV3(self, payload, blob_hashes=None, parent_beacon_root=None):
        block = payload_to_block(payload, self.tree.committer)
        if parent_beacon_root is not None:
            header = Header(**{
                **block.header.__dict__,
                "parent_beacon_block_root": parse_data(parent_beacon_root),
            })
            block = Block(header, block.transactions, (), block.withdrawals)
        bad = self._check_blob_hashes(block, blob_hashes)
        if bad is not None:
            return bad
        return self._check_hash_and_insert(block, payload)

    def engine_newPayloadV4(self, payload, blob_hashes=None, parent_beacon_root=None,
                            execution_requests=None):
        """Prague: V3 + EIP-7685 execution requests (requests_hash header)."""
        block = payload_to_block(payload, self.tree.committer)
        extra = {}
        if parent_beacon_root is not None:
            extra["parent_beacon_block_root"] = parse_data(parent_beacon_root)
        requests = [parse_data(r) for r in (execution_requests or [])]
        extra["requests_hash"] = compute_requests_hash(requests)
        header = Header(**{**block.header.__dict__, **extra})
        block = Block(header, block.transactions, (), block.withdrawals)
        bad = self._check_blob_hashes(block, blob_hashes)
        if bad is not None:
            return bad
        return self._check_hash_and_insert(block, payload)

    def engine_newPayloadV5(self, payload, blob_hashes=None, parent_beacon_root=None,
                            execution_requests=None):
        return self.engine_newPayloadV4(payload, blob_hashes, parent_beacon_root,
                                        execution_requests)

    def _check_blob_hashes(self, block: Block, blob_hashes):
        """Cancun rule: the CL-provided versioned hashes must equal the
        concatenated blob hashes of the payload's type-3 txs, in order."""
        want = [h for tx in block.transactions for h in tx.blob_versioned_hashes]
        got = [parse_data(h) for h in (blob_hashes or [])]
        if want != got:
            return {
                "status": "INVALID",
                "latestValidHash": None,
                "validationError": "blob versioned hashes mismatch",
            }
        return None

    def _new_payload(self, payload):
        return self._check_hash_and_insert(
            payload_to_block(payload, self.tree.committer), payload
        )

    def _check_hash_and_insert(self, block: Block, payload: dict):
        want = parse_data(payload["blockHash"])
        if block.hash != want:
            return {
                "status": "INVALID",
                "latestValidHash": None,
                "validationError": "block hash mismatch",
            }
        return self._status_json(self.tree.on_new_payload(block))

    def engine_forkchoiceUpdatedV1(self, state, attrs=None):
        return self._fcu(state, attrs)

    def engine_forkchoiceUpdatedV2(self, state, attrs=None):
        return self._fcu(state, attrs)

    def engine_forkchoiceUpdatedV3(self, state, attrs=None):
        return self._fcu(state, attrs)

    def _fcu(self, state: dict, attrs):
        head = parse_data(state["headBlockHash"])
        safe = parse_data(state["safeBlockHash"]) if state.get("safeBlockHash") else None
        fin = parse_data(state["finalizedBlockHash"]) if state.get("finalizedBlockHash") else None
        st = self.tree.on_forkchoice_updated(head, safe, fin)
        resp = {"payloadStatus": self._status_json(st), "payloadId": None}
        if attrs is not None and st.status is PayloadStatusKind.VALID:
            if self.payloads is None:
                raise RpcError(-38003, "payload building not configured")
            withdrawals = tuple(
                Withdrawal(
                    parse_qty(w["index"]), parse_qty(w["validatorIndex"]),
                    parse_data(w["address"]), parse_qty(w["amount"]),
                )
                for w in attrs.get("withdrawals") or ()
            )
            pa = PayloadAttributes(
                timestamp=parse_qty(attrs["timestamp"]),
                prev_randao=parse_data(attrs["prevRandao"]),
                suggested_fee_recipient=parse_data(attrs["suggestedFeeRecipient"]),
                withdrawals=withdrawals,
                parent_beacon_block_root=(
                    parse_data(attrs["parentBeaconBlockRoot"])
                    if attrs.get("parentBeaconBlockRoot") else None
                ),
            )
            pid = self.payloads.new_payload_job(head, pa)
            resp["payloadId"] = data(pid)
        return resp

    def _body_json(self, block: Block | None):
        if block is None:
            return None
        out = {"transactions": [data(tx.encode()) for tx in block.transactions]}
        if block.withdrawals is not None:
            out["withdrawals"] = [
                {
                    "index": qty(w.index), "validatorIndex": qty(w.validator_index),
                    "address": data(w.address), "amount": qty(w.amount),
                }
                for w in block.withdrawals
            ]
        else:
            out["withdrawals"] = None
        return out

    def engine_getPayloadBodiesByHashV1(self, hashes):
        out = []
        for h in hashes:
            out.append(self._body_json(self.tree.block_by_hash(parse_data(h))))
        return out

    def engine_getPayloadBodiesByRangeV1(self, start, count):
        s, c = parse_qty(start), parse_qty(count)
        if s < 1 or c < 1:
            raise RpcError(-38004, "invalid params: start and count must be >= 1")
        out = []
        p = self.tree.overlay_provider()
        for n in range(s, s + min(c, 1024)):
            out.append(self._body_json(p.block_by_number(n)))
        return out

    def engine_getPayloadV1(self, payload_id):
        return self._get_payload(payload_id)["executionPayload"]

    def engine_getPayloadV2(self, payload_id):
        out = self._get_payload(payload_id)
        out.pop("_block", None)
        return out

    def engine_getPayloadV3(self, payload_id):
        out = self._get_payload(payload_id)
        out["blobsBundle"] = self._blobs_bundle(out.pop("_block"))
        out["shouldOverrideBuilder"] = False
        return out

    def engine_getPayloadV4(self, payload_id):
        out = self.engine_getPayloadV3(payload_id)
        out["executionRequests"] = []
        return out

    def engine_getPayloadV5(self, payload_id):
        return self.engine_getPayloadV4(payload_id)

    def _blobs_bundle(self, block) -> dict:
        """Sidecars of every included blob tx, concatenated in tx order.

        A payload whose blob tx lost its sidecar is unshippable — the CL
        would propose a block with mismatched blob counts and lose the
        slot — so that is an ERROR, never a silently short bundle."""
        blobs, commitments, proofs = [], [], []
        if block is not None:
            for tx in block.transactions:
                if tx.tx_type != 3:
                    continue
                sc = self.pool.get_blob_sidecar(tx.hash) if self.pool else None
                if sc is None:
                    raise RpcError(
                        -38001, f"blob sidecar unavailable for tx {tx.hash.hex()}"
                    )
                blobs += [data(b) for b in sc.blobs]
                commitments += [data(c) for c in sc.commitments]
                proofs += [data(p) for p in sc.proofs]
        return {"commitments": commitments, "proofs": proofs, "blobs": blobs}

    def engine_getBlobsV1(self, versioned_hashes):
        """BlobAndProofV1 (or null) per requested hash, from the pool store."""
        if self.pool is None:
            return [None] * len(versioned_hashes)
        found = self.pool.blob_store.by_versioned_hashes(
            [parse_data(h) for h in versioned_hashes]
        )
        return [
            None if f is None else {"blob": data(f[0]), "proof": data(f[1])}
            for f in found
        ]

    def engine_getBlobsV2(self, versioned_hashes):
        """Fulu shape: ALL requested blobs or null (no partial responses)."""
        out = self.engine_getBlobsV1(versioned_hashes)
        if any(f is None for f in out):
            return None
        return [{"blob": f["blob"], "proofs": [f["proof"]]} for f in out]

    def _get_payload(self, payload_id):
        if self.payloads is None:
            raise RpcError(-38003, "payload building not configured")
        block, fees = self.payloads.get_payload_with_fees(parse_data(payload_id))
        if block is None:
            raise RpcError(-38001, "unknown payload")
        return {
            "executionPayload": block_to_payload(block),
            "blockValue": qty(fees),
            "_block": block,  # internal: V3+ pop it for the blobs bundle
        }
