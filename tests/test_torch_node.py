"""The port's ``Node`` (``reth_tpu_torch/node/node.py``) against the JAX
package's, over real HTTP: tests/test_rpc_e2e.py's calls on both nodes,
response bytes equal (payload ids aside), tolerance zero. The reference node
runs on its numpy committer; the port's on ``device="cpu"`` (its card route's
plain versions). Also the restart of a paged datadir (``Node.recovery``
reports equal), JWT from the datadir, ``enable_admin``, and the options that
wait for later slices (``NotImplementedError``). The dev miner's instant
sealing through ``python -m`` is in tests/test_torch_node_aux.py."""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import pytest
from _torch_node_pkgs import NPORT, NREF, ALICE, Account, ChainBuilder, Wallet, both, http, \
    ref_committer, request, result

from reth_tpu.primitives.keccak import keccak256
from reth_tpu.primitives.rlp import encode_int, rlp_encode
from reth_tpu.rpc.convert import data, parse_data, parse_qty

ROOT = Path(__file__).resolve().parent.parent
ALICE_W = Wallet(ALICE)
BUILDER = ChainBuilder({ALICE_W.address: Account(balance=10**21)}, committer=ref_committer())
GENESIS_HASH = "0x" + BUILDER.genesis.hash.hex()


class Live:
    """P's dev node on ``BUILDER``'s genesis with both servers started: each
    call goes over HTTP and returns the raw response body."""

    def __init__(self, P, **cfg_kw):
        self.P = P
        cfg_kw.setdefault("dev", True)
        cfg = P.NodeConfig(genesis_header=P.header(BUILDER.genesis),
                           genesis_alloc=P.alloc(BUILDER.accounts_at_genesis), **cfg_kw)
        self.n = P.node(cfg)
        self.n.start_rpc()
        self.wallet = Wallet(ALICE)  # a fresh nonce count each run

    def call(self, method: str, *params) -> bytes:
        return http(self.n.rpc.port, request(method, *params))[1]

    def auth(self, method: str, *params) -> bytes:
        return http(self.n.authrpc.port, request(method, *params))[1]

    def send(self, tx) -> bytes:
        return self.call("eth_sendRawTransaction", data(tx.encode()))

    def mine(self):
        return self.n.miner.mine_block()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.n.stop()


def on_node(scenario, **cfg_kw):
    """``scenario(live)`` on a fresh node of each package, held equal."""
    def run(P):
        with Live(P, **cfg_kw) as live:
            return scenario(live)
    return both(run)


def deploy_code(live, code: bytes, nonce: int) -> bytes:
    init = bytes([0x60, len(code), 0x60, 0x0B, 0x5F, 0x39, 0x60, len(code), 0x5F, 0xF3,
                  0x00]) + code
    live.send(live.wallet.deploy(init))
    return keccak256(rlp_encode([live.wallet.address, encode_int(nonce)]))[12:]


def test_eth_basics_over_http():
    got = on_node(lambda live: [
        live.call("eth_chainId"), live.call("eth_blockNumber"),
        live.call("eth_getBalance", data(ALICE_W.address), "latest"),
        live.call("web3_clientVersion"), live.call("net_version"),
        live.call("eth_getBlockByNumber", "0x0", False)])
    assert result(got[0]) == "0x1" and parse_qty(result(got[2])) == 10**21
    assert result(got[3]).startswith("reth-tpu/")


def test_send_tx_mine_and_receipt():
    bob = b"\x0b" * 20

    def scenario(live):
        tx = live.wallet.transfer(bob, 12345)
        out = [live.send(tx), live.call("txpool_status"),
               live.call("eth_getTransactionCount", data(ALICE_W.address), "pending")]
        live.mine()
        return out + [live.call("eth_blockNumber"),
                      live.call("eth_getBalance", data(bob), "latest"),
                      live.call("eth_getTransactionReceipt", data(tx.hash)),
                      live.call("eth_getTransactionByHash", data(tx.hash)),
                      live.call("eth_getBlockByNumber", "0x1", True)]

    got = on_node(scenario)
    assert result(got[3]) == "0x1" and parse_qty(result(got[4])) == 12345
    assert result(got[5])["status"] == "0x1"


def _attrs(ts: str, recipient: str) -> dict:
    return {"timestamp": ts, "prevRandao": "0x" + "00" * 32,
            "suggestedFeeRecipient": recipient, "withdrawals": []}


def _fcu(head: str, safe: str = GENESIS_HASH) -> dict:
    return {"headBlockHash": head, "safeBlockHash": safe, "finalizedBlockHash": GENESIS_HASH}


def test_engine_api_drives_chain():
    """A consensus client's round: fcU with attributes, getPayload,
    newPayload, fcU."""
    def scenario(live):
        out = [live.send(live.wallet.transfer(b"\x0c" * 20, 777))]
        fcu = live.auth("engine_forkchoiceUpdatedV2", _fcu(GENESIS_HASH),
                        _attrs("0xc", "0x" + "aa" * 20))
        payload = result(live.auth("engine_getPayloadV2", result(fcu)["payloadId"]))
        out += [fcu, json.dumps(payload).encode()]
        payload = payload["executionPayload"]
        out += [live.auth("engine_newPayloadV2", payload),
                live.auth("engine_forkchoiceUpdatedV2", _fcu(payload["blockHash"])),
                live.call("eth_getBalance", "0x" + "0c" * 20, "latest"),
                live.auth("engine_exchangeCapabilities", [])]
        return out

    got = on_node(scenario)
    assert result(got[3])["status"] == "VALID" and parse_qty(result(got[5])) == 777


def test_eth_call_and_logs():
    code = bytes.fromhex("60425f5fa100")  # LOG1 with topic 0x42

    def scenario(live):
        out = [live.call("eth_call", {"from": data(ALICE_W.address), "to": "0x" + "0d" * 20,
                                      "value": "0x1"}, "latest")]
        contract = deploy_code(live, code, 0)
        live.mine()
        live.send(live.wallet.call(contract, b""))
        live.mine()
        return out + [live.call("eth_getLogs", {"fromBlock": "0x0", "toBlock": "latest",
                                                "address": data(contract)})]

    got = on_node(scenario)
    assert result(got[0]) == "0x" and len(result(got[1])) == 1


def test_contract_address_pending_shape_and_receipts():
    def scenario(live):
        deploy = live.wallet.deploy(bytes([0x60, 1, 0x60, 0x0B, 0x5F, 0x39, 0x60, 1, 0x5F, 0xF3,
                                           0x00, 0x00]))
        live.send(deploy)
        pending = live.wallet.transfer(b"\x0e" * 20, 5)
        live.send(pending)
        out = [live.call("eth_getTransactionByHash", data(pending.hash))]
        live.mine()
        return out + [live.call("eth_getTransactionReceipt", data(deploy.hash)),
                      live.call("eth_getBlockReceipts", "0x1"),
                      live.call("eth_getTransactionByBlockNumberAndIndex", "0x1", "0x1"),
                      live.call("eth_getTransactionByBlockNumberAndIndex", "0x1", "0x5"),
                      live.call("eth_getBlockReceipts", "0x0"), live.call("eth_accounts")]

    got = on_node(scenario)
    assert result(got[0])["blockHash"] is None
    want = keccak256(rlp_encode([ALICE_W.address, encode_int(0)]))[12:]
    assert result(got[1])["contractAddress"] == data(want)


def test_pool_maintained_in_cl_driven_mode():
    """Transactions leave the pool when blocks arrive over the engine API."""
    def scenario(live):
        live.send(live.wallet.transfer(b"\x0f" * 20, 9))
        fcu = result(live.auth("engine_forkchoiceUpdatedV2", _fcu(GENESIS_HASH),
                               _attrs("0xc", "0x" + "aa" * 20)))
        payload = result(live.auth("engine_getPayloadV2", fcu["payloadId"]))["executionPayload"]
        return [live.auth("engine_newPayloadV2", payload),
                live.auth("engine_forkchoiceUpdatedV2", _fcu(payload["blockHash"])),
                live.call("txpool_status")]

    assert result(on_node(scenario)[2])["pending"] == "0x0"


def test_eth_get_proof():
    def scenario(live):
        live.send(live.wallet.transfer(b"\x0b" * 20, 3))
        live.mine()
        return [live.call("eth_getProof", data(ALICE_W.address), [], "latest"),
                live.call("eth_getProof", "0x" + "0b" * 20, ["0x0"], "latest"),
                live.call("eth_getBlockByNumber", "latest", False)]

    from reth_tpu.primitives.types import Account as JAccount
    from reth_tpu.trie.proof import AccountProof, verify_account_proof

    got = on_node(scenario)
    proof, root = result(got[0]), parse_data(result(got[2])["stateRoot"])
    acc = JAccount(nonce=parse_qty(proof["nonce"]), balance=parse_qty(proof["balance"]),
                   storage_root=parse_data(proof["storageHash"]),
                   code_hash=parse_data(proof["codeHash"]))
    assert verify_account_proof(root, ALICE_W.address, AccountProof(
        ALICE_W.address, acc, [parse_data(x) for x in proof["accountProof"]]))


def test_traces_and_raw_accessors():
    """debug_traceTransaction (struct logs, callTracer), trace_transaction,
    the raw accessors and the payload bodies."""
    inner = bytes.fromhex("60075f5500")  # sstore(0, 7)
    store = bytes.fromhex("5f355f5500")  # sstore(0, calldata[0])

    def scenario(live):
        inner_addr = deploy_code(live, inner, 0)
        outer = bytes.fromhex("5f5f5f5f5f73") + inner_addr + bytes.fromhex("5af100")
        outer_addr = deploy_code(live, outer, 1)
        store_addr = deploy_code(live, store, 2)
        live.mine()
        call_tx = live.wallet.call(outer_addr, b"")
        store_tx = live.wallet.call(store_addr, (0x77).to_bytes(32, "big"))
        live.send(call_tx)
        live.send(store_tx)
        blk = live.mine()
        return [live.call("debug_traceTransaction", data(store_tx.hash)),
                live.call("debug_traceTransaction", data(call_tx.hash), {"tracer": "callTracer"}),
                live.call("trace_transaction", data(call_tx.hash)),
                live.call("eth_getStorageAt", data(inner_addr), "0x0", "latest"),
                live.call("debug_getRawHeader", "0x1"),
                live.call("debug_getRawTransaction", data(store_tx.hash)),
                live.call("debug_getRawBlock", "0x2"),
                live.auth("engine_getPayloadBodiesByHashV1", [data(blk.hash), "0x" + "77" * 32]),
                live.auth("engine_getPayloadBodiesByRangeV1", "0x1", "0x3"),
                live.auth("engine_getPayloadBodiesByRangeV1", "0x0", "0x1")]

    got = on_node(scenario)
    ops = [entry["op"] for entry in result(got[0])["structLogs"]]
    assert ops == ["PUSH0", "CALLDATALOAD", "PUSH0", "SSTORE", "STOP"]
    assert parse_qty(result(got[3])) == 7 and "error" in json.loads(got[9])


def test_fee_history_and_error_shapes():
    def scenario(live):
        live.send(live.wallet.transfer(b"\x0b" * 20, 1))
        live.mine()
        live.mine()
        return [live.call("eth_feeHistory", "0x2", "latest", [50]),
                live.call("eth_notAMethod"),
                live.send(Wallet(0x9999).transfer(b"\x01" * 20, 10**18))]

    got = on_node(scenario)
    assert result(got[0])["oldestBlock"] == "0x1"
    assert "not found" in json.loads(got[1])["error"]["message"]
    assert "insufficient funds" in json.loads(got[2])["error"]["message"]


def test_debug_execution_witness():
    def scenario(live):
        live.send(live.wallet.transfer(b"\x0b" * 20, 777))
        live.mine()
        return [live.call("debug_executionWitness", "0x1"),
                live.call("debug_getRawBlock", "0x1"), live.call("debug_getRawHeader", "0x0")]

    from reth_tpu.engine.stateless import StatelessChain
    from reth_tpu.engine.witness import ExecutionWitness
    from reth_tpu.evm import EvmConfig
    from reth_tpu.primitives.types import Block, Header

    got = on_node(scenario)
    block = Block.decode(parse_data(result(got[1])))
    root = StatelessChain(config=EvmConfig(chain_id=1)).validate(
        block, ExecutionWitness.from_json(result(got[0])),
        Header.decode(parse_data(result(got[2]))))
    assert root == block.header.state_root


def test_flashbots_builder_submissions():
    """A payload of the node's own payload service validates; a bid above the
    block's payment, a wrong block hash and a wrong state root (re-sealed)
    are each Invalid."""
    def scenario(live):
        live.send(live.wallet.transfer(b"\x0b" * 20, 321))
        head = result(live.call("eth_getBlockByNumber", "latest", False))["hash"]
        fcu = live.n.engine_api.engine_forkchoiceUpdatedV2(
            {"headBlockHash": head, "safeBlockHash": head, "finalizedBlockHash": head},
            _attrs("0x63", "0x" + "ee" * 20))
        payload = live.n.engine_api.engine_getPayloadV2(fcu["payloadId"])["executionPayload"]
        msg = {"feeRecipient": "0x" + "ee" * 20, "value": "0x0"}
        out = [live.call("flashbots_validateBuilderSubmissionV3",
                         {"executionPayload": payload, "message": msg}),
               live.call("flashbots_validateBuilderSubmissionV3",
                         {"executionPayload": payload,
                          "message": dict(msg, value=hex(10**30))})]
        bogus = dict(payload, blockHash="0x" + "13" * 32)
        out.append(live.call("flashbots_validateBuilderSubmissionV3",
                             {"executionPayload": bogus, "message": msg}))
        tampered = dict(payload, stateRoot="0x" + "37" * 32)
        engine_api = sys.modules[type(live.n.engine_api).__module__]
        resealed = engine_api.payload_to_block(tampered, live.n.tree.committer)
        tampered["blockHash"] = "0x" + resealed.header.hash.hex()
        out.append(live.call("flashbots_validateBuilderSubmissionV3",
                             {"executionPayload": tampered, "message": msg}))
        return out

    got = on_node(scenario)
    assert result(got[0])["status"] == "Valid"
    assert "payment" in result(got[1])["validationError"]
    assert "block hash mismatch" in result(got[2])["validationError"]
    assert "state root mismatch" in result(got[3])["validationError"]


def test_enable_admin():
    def scenario(live):
        return [live.call("admin_nodeInfo"), live.call("admin_peers")]

    off = on_node(scenario)
    on = on_node(scenario, enable_admin=True)
    assert "error" in json.loads(off[0]) and "result" in json.loads(on[0])


def test_jwt_from_the_datadir(tmp_path):
    """Without ``--dev`` the engine port takes the secret the node writes to
    ``<datadir>/jwt.hex``: a call without a token is refused, one with a
    token of that secret answered."""
    def scenario(P):
        d = tmp_path / P.name
        with Live(P, dev=False, datadir=str(d)) as live:
            secret = bytes.fromhex((d / "jwt.hex").read_text().strip().removeprefix("0x"))
            body = request("engine_exchangeCapabilities", [])
            return [http(live.n.authrpc.port, body),
                    http(live.n.authrpc.port, body, P.jwt.encode_jwt(os.urandom(32))),
                    http(live.n.authrpc.port, body, P.jwt.encode_jwt(secret)),
                    live.call("eth_chainId")]

    got = both(scenario)
    assert got[0][0] == 401 and got[1][0] == 401 and got[2][0] == 200


def test_restart_of_a_paged_datadir(tmp_path):
    """A dev node on the default paged store mines three blocks and stops;
    the node started again on the datadir (no genesis) recovers it: the
    recovery reports equal (walls aside; the port's counts no fallback), its
    root verified, its head the persisted block and that block equal."""
    def scenario(P):
        d = tmp_path / P.name
        with Live(P, datadir=str(d)) as live:
            for i in range(3):
                live.send(live.wallet.transfer(b"\x0b" * 20, 10 + i))
                live.mine()
            persisted = live.n.tree.persisted_number
            head = live.call("eth_getBlockByNumber", hex(persisted), False)
        cfg = P.NodeConfig(datadir=str(d))
        n = P.node(cfg)
        try:
            n.start_rpc()
            report = dict(n.recovery)
            report.pop("wall_s")
            if P is NPORT:
                assert report.pop("fallbacks") == {}
            again = http(n.rpc.port, request("eth_getBlockByNumber", "latest", False))[1]
            backend = type(n.factory.db).__name__
        finally:
            n.stop()
        return [head, again, backend, json.dumps(report, sort_keys=True, default=str)]

    got = both(scenario)
    # the blocks above the persistence threshold were in memory only
    assert got[0] == got[1] and got[2] == "PagedDb"
    assert parse_qty(result(got[1])["number"]) == 1
    report = json.loads(got[3])
    assert report["status"] == "ok" and report["root_verified"] is True


def test_options_that_wait_for_later_slices(capsys):
    """``--health`` (ROADMAP.md A item 1), ``--fleet``, ``--ha-peer-feed`` and
    the replica / standby roles (item 2) raise, and so do their NodeConfig
    fields."""
    from reth_tpu_torch.cli import main
    from reth_tpu_torch.node import Node, NodeConfig

    base = ["node", "--dev", "--device", "cpu", "--http-port", "0", "--authrpc-port", "0",
            "--disable-p2p"]
    for extra, item in ((["--health"], "item 1"), (["--fleet"], "item 2"),
                        (["--ha-peer-feed", "127.0.0.1:1"], "item 2"),
                        (["--role", "replica", "--feed", "127.0.0.1:1"], "item 2"),
                        (["--role", "standby", "--feed", "127.0.0.1:1"], "item 2")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md A {item}"):
            main(base + extra)
    for kw, item in ((dict(health=True), "item 1"), (dict(fleet=True), "item 2"),
                     (dict(ha_peer_feeds=("127.0.0.1:1",)), "item 2")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md A {item}"):
            Node(NodeConfig(dev=True, **kw), device="cpu")
