"""The port's debug_*, trace_*, ots_*, flashbots, miner_, txpool_, net_ and
web3_ namespaces (rpc/debug.py, otterscan.py, flashbots.py, miner.py,
net.py) against the JAX package's, on the CPU, tolerance zero.

On the same chain (tests/_torch_rpc_pkgs.py, blocks kept in memory so each
witness reads its parent's overlay) every response is held equal byte for
byte: the struct-log and call tracers over transactions, calls and blocks,
``debug_executionWitness`` (the reference's ``to_json()``; it also validates
statelessly to the header's root), the raw getters, every ots_ method of
tests/test_rpc_extras.py, ``eth_callBundle``, and
``flashbots_validateBuilderSubmissionV3`` on a payload built through the
engine API (valid; a short bid; a wrong block hash; a flipped state root,
re-sealed, "state root mismatch"), the miner's knobs and their effect on a
built payload, the pool's namespaces and net / web3. The port runs once on a
numpy-hashing committer and once on the card route's plain versions
(``TrieCommitter(device="cpu")``).

The departure: a kernel fault in the submission's execution or in a bundle's
transaction re-raises out of ``handle()`` (counted there), where any other
cause stays an ``Invalid`` submission or a per-transaction error, as in the
reference. ``debug_blockTimeline`` and ``debug_flightRecorder`` carry wall
clocks, so their shapes are checked on the port alone.
"""

from __future__ import annotations

import json

import pytest

from _torch_rpc_pkgs import RPORT, RPORT_CARD, SINK, RpcNode, both, result, wallets_builder
from reth_tpu.primitives.keccak import keccak256
from reth_tpu.primitives.rlp import encode_int, rlp_encode
from reth_tpu_torch import tracing as ptracing
from reth_tpu_torch.engine.witness import ExecutionWitness
from reth_tpu_torch.evm import EvmConfig, executor as pexecutor
from reth_tpu_torch.engine.stateless import StatelessChain
from reth_tpu_torch.ops._build import LaunchError
from reth_tpu_torch.primitives.types import Block, Header

STORE = bytes.fromhex("5f355f5500")  # sstore(0, cd[0])
INNER = bytes.fromhex("60075f5500")  # sstore(0, 7)
LOGGER = bytes.fromhex("60425f5fa100")


def initcode(rt: bytes) -> bytes:
    return bytes([0x60, len(rt), 0x60, 0x0B, 0x5F, 0x39, 0x60, len(rt), 0x5F, 0xF3, 0x00]) + rt


def created(sender: bytes, nonce: int) -> bytes:
    return keccak256(rlp_encode([sender, encode_int(nonce)]))[12:]


def h(b: bytes) -> str:
    return "0x" + b.hex()


def chain(n, alice, bob):
    """Blocks 1-3: contracts (a store, an inner store and an outer CALL to
    it, a logger, a failing deploy), calls into them, transfers."""
    store, inner, logger = (created(alice.address, i) for i in range(3))
    outer_rt = bytes.fromhex("5f5f5f5f5f73") + inner + bytes.fromhex("5af100")
    outer = created(alice.address, 3)
    txs = [alice.deploy(initcode(rt)) for rt in (STORE, INNER, LOGGER, outer_rt)]
    for tx in txs:
        n.send(tx)
    n.miner.mine_block()  # 1
    more = [alice.call(store, (0x77).to_bytes(32, "big")), alice.call(outer, b""),
            alice.call(logger, b""), bob.transfer(SINK, 12345),
            alice.deploy(bytes.fromhex("fe"), gas_limit=100_000)]
    for tx in more:
        n.send(tx)
    n.miner.mine_block()  # 2
    last = [bob.transfer(SINK, 1), alice.call(store, (0x99).to_bytes(32, "big"))]
    for tx in last:
        n.send(tx)
    n.miner.mine_block()  # 3
    return (store, inner, logger, outer), txs + more + last


def sc_debug(P):
    b, (alice, bob) = wallets_builder(P)
    with RpcNode(P, b, persistence_threshold=8) as n:
        (store, inner, logger, outer), txs = chain(n, alice, bob)
        A = h(alice.address)
        out = []
        for tx in txs:
            t = h(tx.hash)
            out += [n.call("debug_traceTransaction", t),
                    n.call("debug_traceTransaction", t, {"tracer": "callTracer"}),
                    n.call("debug_traceTransaction", t, {"enableMemory": True}),
                    n.call("trace_transaction", t), n.call("debug_getRawTransaction", t),
                    n.call("ots_traceTransaction", t), n.call("ots_getTransactionError", t),
                    n.call("ots_getInternalOperations", t)]
        out += [n.call("debug_traceTransaction", "0x" + "ab" * 32),
                n.call("debug_getRawTransaction", "0x" + "ab" * 32)]
        for tag in ("0x1", "0x2", "0x3", "latest"):
            out += [n.call("debug_traceBlockByNumber", tag),
                    n.call("debug_traceBlockByNumber", tag, {"tracer": "callTracer"}),
                    n.call("debug_getRawHeader", tag), n.call("debug_getRawBlock", tag),
                    n.call("ots_getBlockDetails", tag)]
        hashes = [result(n.call("eth_getBlockByNumber", hex(i), False))["hash"] for i in (1, 2)]
        out += [n.call("debug_traceBlockByHash", hashes[1], {"tracer": "callTracer"}),
                n.call("ots_getBlockDetailsByHash", hashes[0]),
                n.call("debug_getRawHeader", "0x63"), n.call("debug_getRawBlock", "0x63")]
        call = {"from": A, "to": h(store), "data": h((5).to_bytes(32, "big"))}
        out += [n.call("debug_traceCall", call, "latest", {}),
                n.call("debug_traceCall", call, "latest", {"tracer": "callTracer"}),
                n.call("debug_traceCall", {"from": A, "to": h(outer)}, "0x1", None)]
        for tag in ("0x1", "0x2", "0x3", "0x0", "0x63"):
            out.append(n.call("debug_executionWitness", tag))
        out += [n.call("ots_getApiLevel"), n.call("ots_hasCode", h(store), "latest"),
                n.call("ots_hasCode", h(SINK), "latest"), n.call("ots_hasCode", h(store), "0x0"),
                n.call("ots_getBlockTransactions", 2, 0, 3), n.call("ots_getBlockTransactions", 2, 1, 3),
                n.call("ots_searchTransactionsBefore", h(SINK), "0x0", 10),
                n.call("ots_searchTransactionsAfter", A, "0x1", 2),
                n.call("ots_getTransactionBySenderAndNonce", A, "0x1"),
                n.call("ots_getTransactionBySenderAndNonce", A, "0x63"),
                n.call("ots_getContractCreator", h(store)),
                n.call("ots_getContractCreator", h(SINK))]
        return out


def test_debug_and_otterscan_match_reference():
    got = both(sc_debug)
    first = json.loads(got[0])["result"]
    assert first["failed"] is False and first["structLogs"]


def sc_witness(P):
    """The card route's share of sc_debug: the witnesses (the proof lane) and
    the raw getters."""
    b, (alice, bob) = wallets_builder(P)
    with RpcNode(P, b, persistence_threshold=8) as n:
        chain(n, alice, bob)
        return [n.call(m, tag) for tag in ("0x1", "0x2", "0x3")
                for m in ("debug_executionWitness", "debug_getRawBlock")]


def test_execution_witness_matches_reference_on_the_card_route():
    both(sc_witness, port=RPORT_CARD)


def test_execution_witness_validates_statelessly():
    """debug_executionWitness over the server feeds StatelessChain, which
    reproduces the header's state root with no database."""
    b, (alice, bob) = wallets_builder(RPORT)
    with RpcNode(RPORT, b, persistence_threshold=8) as n:
        chain(n, alice, bob)
        for tag in ("0x1", "0x2", "0x3"):
            w = ExecutionWitness.from_json(result(n.call("debug_executionWitness", tag)))
            block = Block.decode(bytes.fromhex(result(n.call("debug_getRawBlock", tag))[2:]))
            num = int(tag, 16)
            parent = Header.decode(bytes.fromhex(
                result(n.call("debug_getRawHeader", hex(num - 1)))[2:]))
            sc = StatelessChain(config=EvmConfig(chain_id=1), device="cpu")
            assert sc.validate(block, w, parent) == block.header.state_root


# -- flashbots, the miner, the pool, net / web3 --------------------------------


def engine_payload(n, fee_recipient="0x" + "ee" * 20, ts=99):
    head = result(n.call("eth_getBlockByNumber", "latest", False))["hash"]
    fcu = n.engine_api.engine_forkchoiceUpdatedV2(
        {"headBlockHash": head, "safeBlockHash": head, "finalizedBlockHash": head},
        {"timestamp": hex(ts), "prevRandao": "0x" + "00" * 32,
         "suggestedFeeRecipient": fee_recipient, "withdrawals": []})
    return n.engine_api.engine_getPayloadV2(fcu["payloadId"])["executionPayload"]


def submission(payload, value="0x0", fee_recipient="0x" + "ee" * 20, gas_limit=None):
    msg = {"feeRecipient": fee_recipient, "value": value}
    if gas_limit is not None:
        msg["gasLimit"] = gas_limit
    return {"executionPayload": payload, "message": msg}


def sc_builder(P):
    b, (alice, bob) = wallets_builder(P)
    with RpcNode(P, b) as n:
        out = []
        t1, t2 = alice.transfer(SINK, 500), alice.transfer(SINK, 600)
        bad = bob.transfer(SINK, 10**30)
        bundle = {"txs": [h(t1.encode()), h(t2.encode())]}
        out += [n.call("eth_callBundle", bundle),
                n.call("eth_callBundle", {"txs": [h(t1.encode()), h(bad.encode())],
                                          "blockNumber": "0x5", "timestamp": "0x99"}),
                n.call("eth_callBundle", {"txs": []}),
                n.call("eth_callBundle", {"txs": ["0x00"] * 101}),
                n.call("eth_blockNumber"), n.call("eth_getBalance", h(SINK), "latest")]
        for tx in (t1, t2, bob.transfer(SINK, 321)):
            out.append(n.send(tx))
        out += [n.call("txpool_status"), n.call("txpool_content"), n.call("txpool_inspect"),
                n.call("txpool_contentFrom", h(alice.address)),
                n.call("txpool_contentFrom", h(SINK))]
        payload = engine_payload(n)
        out += [n.call("flashbots_validateBuilderSubmissionV3", submission(payload)),
                n.call("flashbots_validateBuilderSubmissionV3", submission(payload, hex(10**30))),
                n.call("flashbots_validateBuilderSubmissionV3",
                       submission(payload, gas_limit="0x1")),
                n.call("flashbots_validateBuilderSubmissionV3", {"message": {}}),
                n.call("flashbots_validateBuilderSubmissionV3",
                       submission(dict(payload, blockHash="0x" + "13" * 32)))]
        # a flipped state root, the claimed hash re-sealed so the root check must catch it
        flipped = dict(payload)
        root = bytearray(bytes.fromhex(payload["stateRoot"][2:]))
        root[0] ^= 0x01
        flipped["stateRoot"] = h(bytes(root))
        flipped["blockHash"] = h(P.engine_api.payload_to_block(flipped, n.tree.committer).hash)
        out.append(n.call("flashbots_validateBuilderSubmissionV3", submission(flipped)))
        unknown_parent = dict(payload, parentHash="0x" + "44" * 32)
        unknown_parent["blockHash"] = h(P.engine_api.payload_to_block(
            unknown_parent, n.tree.committer).hash)
        out.append(n.call("flashbots_validateBuilderSubmissionV3", submission(unknown_parent)))
        # the miner's knobs, then a payload built with them
        out += [n.call("miner_setExtra", h(b"tpu!")), n.call("miner_setExtra", h(b"x" * 33)),
                n.call("miner_setGasPrice", hex(2 * 10**9)),
                n.call("miner_setGasLimit", hex(20_000_000))]
        out.append(n.send(alice.transfer(SINK, 1, max_priority_fee_per_gas=10**9)))
        built = engine_payload(n, ts=100)
        out.append(json.dumps([built["extraData"], built["gasLimit"],
                               len(built["transactions"])]).encode())
        out += [n.call("net_version"), n.call("net_listening"), n.call("net_peerCount"),
                n.call("web3_clientVersion"), n.call("web3_sha3", "0x68656c6c6f")]
        return out


def test_flashbots_miner_txpool_and_net_match_reference():
    got = both(sc_builder)
    verdicts = [json.loads(got[i])["result"] for i in (14, 15, 16, 18, 19, 20)]
    assert verdicts[0]["status"] == "Valid"
    assert verdicts[1]["status"] == "Invalid" and "payment" in verdicts[1]["validationError"]
    assert "registered" in verdicts[2]["validationError"]
    assert json.loads(got[17])["error"]["code"] == -32602
    assert "block hash mismatch" in verdicts[3]["validationError"]
    assert verdicts[4]["validationError"].startswith("state root mismatch")
    assert verdicts[5]["validationError"] == "unknown parent"


def test_flashbots_match_reference_on_the_card_route():
    both(sc_builder, port=RPORT_CARD)


def _fault(*_a, **_kw):
    raise LaunchError("keccak256_absorb: an illegal memory access was encountered")


def test_flashbots_kernel_fault_reraises(monkeypatch):
    """A kernel fault in the submission's post-execution checks or in a
    bundle's transaction re-raises out of handle() and is counted; a
    ValueError there stays an Invalid submission or a per-tx error."""
    b, (alice, _bob) = wallets_builder(RPORT)
    with RpcNode(RPORT, b) as n:
        n.send(alice.transfer(SINK, 5))
        payload = engine_payload(n)
        bundle = {"txs": [h(alice.transfer(SINK, 6).encode())]}
        consensus = n.tree.consensus
        real = consensus.validate_block_post_execution
        monkeypatch.setattr(consensus, "validate_block_post_execution",
                            lambda *a, **k: (_ for _ in ()).throw(ValueError("bad receipts")))
        res = result(n.call("flashbots_validateBuilderSubmissionV3", submission(payload)))
        assert res == {"status": "Invalid", "validationError": "bad receipts"}
        monkeypatch.setattr(consensus, "validate_block_post_execution", _fault)
        with pytest.raises(LaunchError):
            n.call("flashbots_validateBuilderSubmissionV3", submission(payload))
        monkeypatch.setattr(consensus, "validate_block_post_execution", real)
        monkeypatch.setattr(pexecutor.BlockExecutor, "_execute_tx",
                            lambda *a, **k: (_ for _ in ()).throw(ValueError("nope")))
        assert result(n.call("eth_callBundle", bundle))["results"][0]["error"] == "nope"
        monkeypatch.setattr(pexecutor.BlockExecutor, "_execute_tx", _fault)
        with pytest.raises(LaunchError):
            n.call("eth_callBundle", bundle)
        assert n.rpc.kernel_faults == 2
        monkeypatch.undo()
        assert result(n.call("flashbots_validateBuilderSubmissionV3",
                             submission(payload)))["status"] == "Valid"


def test_block_timeline_and_flight_recorder_shapes(tmp_path, monkeypatch):
    monkeypatch.setenv("RETH_TPU_FLIGHT_DIR", str(tmp_path))
    b, (alice, _bob) = wallets_builder(RPORT)
    was_on = ptracing.trace_enabled()
    with RpcNode(RPORT, b) as n:
        ptracing.set_trace_enabled(False)
        off = json.loads(n.call("debug_blockTimeline"))["error"]
        assert off["code"] == -32000 and "disabled" in off["message"]
        ptracing.set_trace_enabled(True)
        try:
            n.send(alice.transfer(SINK, 5))
            block = n.miner.mine_block()
            latest = result(n.call("debug_blockTimeline"))
            by_tag = result(n.call("debug_blockTimeline", "0x1"))
            by_hash = result(n.call("debug_blockTimeline", h(block.hash)))
            missing = json.loads(n.call("debug_blockTimeline", "0x" + "12" * 32))["error"]
        finally:
            ptracing.set_trace_enabled(was_on)
        assert latest["traceId"] == by_tag["traceId"] == by_hash["traceId"] == block.hash.hex()
        assert latest["spans"] and "summary" in latest
        assert missing["code"] == -32000
        ptracing.event("rpc::test", "marker", n=1)
        snap = result(n.call("debug_flightRecorder", "snapshot", 4))
        assert set(snap) == {"records", "recorded", "dumps"} and len(snap["records"]) <= 4
        dump = result(n.call("debug_flightRecorder", "dump"))
        assert dump["path"].startswith(str(tmp_path)) and dump["path"] in dump["dumps"]
