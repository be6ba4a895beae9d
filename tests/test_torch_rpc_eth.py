"""The port's eth_* namespace (rpc/eth.py, state_cache.py, gas_oracle.py,
convert.py) against the JAX package's, on the CPU, tolerance zero.

Both packages' servers are wired as the reference's node wires them
(tests/_torch_rpc_pkgs.py) over the same genesis, and fed the same signed
transactions through ``eth_sendRawTransaction``; the dev-mode miner seals the
same blocks. Every eth_* method's JSON response is held equal byte for byte
to the reference's: the chain's meta, state at the tip and in history
(``HistoricalStateProvider`` over the engine's persisted and in-memory
blocks, and tests/test_history.py's cases), ``eth_getProof`` at 3 slots and
at 80 (above ``SLOT_SPLIT_MIN``, so through ``ProofWorkerPool``), blocks,
transactions, receipts, logs, the fee history and the oracle, ``eth_call`` /
``estimateGas`` / ``createAccessList`` (a reverting call included), every
``eth_simulateV1`` case of tests/test_rpc_extras.py, and the errors. The
port runs once on a numpy-hashing committer and once on the card route's
plain versions (``TrieCommitter(device="cpu")``). A pruned history horizon
refuses reads below it as the reference does, and every proof verifies
against the block's state root.
"""

from __future__ import annotations

import json

from _torch_rpc_pkgs import RPORT, RPORT_CARD, RREF, SINK, RpcNode, both, result, wallets_builder
from reth_tpu.primitives.keccak import keccak256
from reth_tpu.primitives.rlp import encode_int, rlp_encode
from reth_tpu_torch.primitives.types import Account
from reth_tpu_torch.prune import PruneMode, PruneModes, Pruner
from reth_tpu_torch.trie.proof import AccountProof, StorageProof, verify_account_proof, \
    verify_storage_proof

STORE = bytes.fromhex("6020355f355500")  # sstore(cd[0], cd[32]); stop
LOGGER = bytes.fromhex("60425f5fa100")  # log1(topic 0x42); stop
REVERTER = bytes.fromhex("600554505f5ffd")  # sload(5); revert


def initcode(rt: bytes) -> bytes:
    return bytes([0x60, len(rt), 0x60, 0x0B, 0x5F, 0x39, 0x60, len(rt), 0x5F, 0xF3]) + b"\x00" + rt


def created(sender: bytes, nonce: int) -> bytes:
    return keccak256(rlp_encode([sender, encode_int(nonce)]))[12:]


def h(b: bytes) -> str:
    return "0x" + b.hex()


def word(n: int) -> bytes:
    return n.to_bytes(32, "big")


def build_chain(n, alice, bob):
    """Blocks 1-4: three contracts, four stores, a log, transfers; one
    transaction left pending. Returns (contracts, mined tx hashes, pending)."""
    store, logger, reverter = (created(alice.address, i) for i in range(3))
    mined = []
    for rt in (STORE, LOGGER, REVERTER):
        tx = alice.deploy(initcode(rt))
        n.send(tx)
        mined.append(tx.hash)
    n.miner.mine_block()  # 1
    for k, v in ((1, 2), (5, 9), (7, 1)):
        tx = alice.call(store, word(k) + word(v))
        n.send(tx)
        mined.append(tx.hash)
    tx = bob.transfer(SINK, 777)
    n.send(tx)
    mined.append(tx.hash)
    n.miner.mine_block()  # 2
    for tx in (alice.call(logger, b""), bob.transfer(SINK, 5), alice.call(store, word(3) + word(4))):
        n.send(tx)
        mined.append(tx.hash)
    n.miner.mine_block()  # 3
    n.miner.mine_block()  # 4, empty
    pending = alice.transfer(SINK, 1)
    n.send(pending)
    return (store, logger, reverter), mined, pending


def proof_slots(store: int) -> list[str]:
    """80 slots of the storage contract: the four it wrote, 76 absent."""
    return [hex(k) for k in (1, 5, 7, 3)] + [hex(1000 + i) for i in range(76)]


SIMULATE = [
    {"blockStateCalls": [
        {"stateOverrides": {"0x" + "aa" * 20: {"balance": hex(10**18)}},
         "calls": [{"from": "0x" + "aa" * 20, "to": "0x" + "bb" * 20, "value": "0x5"}]},
        {"blockOverrides": {"time": "0x77777777"},
         "calls": [{"from": "0x" + "aa" * 20, "to": "0x" + "bb" * 20, "value": "0x2"}]}]},
    {"returnFullTransactions": True, "blockStateCalls": [
        {"stateOverrides": {"0x" + "aa" * 20: {"balance": hex(10**18)}},
         "calls": [{"from": "0x" + "aa" * 20, "to": "0x" + "bb" * 20, "value": "0x5"}]},
        {"blockOverrides": {"number": "0x9"}, "calls": []}]},
    {"validation": True, "blockStateCalls": [
        {"stateOverrides": {"0x" + "aa" * 20: {"balance": hex(10**18), "nonce": "0x7"}},
         "calls": [{"from": "0x" + "aa" * 20, "to": "0x" + "bb" * 20, "value": "0x1",
                    "nonce": "0x0", "maxFeePerGas": hex(10**10)}]}]},
    {"blockStateCalls": []},
    {"blockStateCalls": [{"calls": [{"from": "0x" + "aa" * 20, "to": "0x" + "bb" * 20,
                                     "value": hex(10**30)}]}]},
]


def simulate_cases(A, store, logger, reverter):
    """tests/test_rpc_extras.py's eth_simulateV1 cases, then calls into the
    chain's contracts (a store, a log, two reverts; validation with fees)."""
    return SIMULATE + [
        {"blockStateCalls": [{"calls": [
            {"from": A, "to": h(store), "data": h(word(8) + word(3))},
            {"from": A, "to": h(logger)}, {"from": A, "to": h(reverter)},
            {"from": A, "to": h(reverter)}]}]},
        {"returnFullTransactions": True, "validation": True, "blockStateCalls": [
            {"calls": [{"from": A, "to": h(store), "data": h(word(1) + word(1)),
                        "maxFeePerGas": hex(10**11)}]},
            {"blockOverrides": {"feeRecipient": "0x" + "ee" * 20},
             "calls": [{"from": A, "to": h(SINK), "value": "0x9",
                        "maxFeePerGas": hex(10**11)}]}]},
    ]


N_CALLS = 69  # the fixed calls of sc_eth before its simulations


def sc_eth(P, persistence_threshold=2):
    b, (alice, bob) = wallets_builder(P)
    with RpcNode(P, b, persistence_threshold=persistence_threshold) as n:
        (store, logger, reverter), mined, pending = build_chain(n, alice, bob)
        A, S, SK = h(alice.address), h(store), h(SINK)
        calls = [
            ("eth_chainId",), ("eth_blockNumber",), ("eth_syncing",), ("eth_accounts",),
            ("eth_gasPrice",), ("eth_maxPriorityFeePerGas",), ("eth_blobBaseFee",),
            ("eth_blobBaseFee", "0x1"),
            ("eth_feeHistory", "0x3", "latest", [25, 75]), ("eth_feeHistory", "0x2", "0x2"),
            ("eth_feeHistory", "0x0", "latest"), ("eth_feeHistory", "0x1", "0x63"),
            ("eth_getAccount", A, "latest"), ("eth_getAccount", S, "latest"),
            ("eth_getAccount", h(b"\x77" * 20), "latest"), ("eth_getAccount", A, "0x1"),
            ("eth_getBalance", SK, "latest"), ("eth_getBalance", SK, "0x2"),
            ("eth_getBalance", SK, "0x1"), ("eth_getBalance", SK, "earliest"),
            ("eth_getBalance", SK, "0x63"),
            ("eth_getTransactionCount", A, "latest"), ("eth_getTransactionCount", A, "pending"),
            ("eth_getTransactionCount", A, "0x1"),
            ("eth_getCode", S, "latest"), ("eth_getCode", S, "0x0"), ("eth_getCode", SK),
            ("eth_getStorageAt", S, "0x5", "latest"), ("eth_getStorageAt", S, "0x3", "0x2"),
            ("eth_getStorageAt", S, "0x3", "0x3"), ("eth_getStorageAt", S, "0x1", "0x1"),
            ("eth_getProof", A, [], "latest"), ("eth_getProof", S, ["0x1", "0x5", "0x63"], "latest"),
            ("eth_getProof", S, proof_slots(store), "latest"),
            ("eth_getProof", h(b"\x66" * 20), ["0x1"], "latest"),
            ("eth_getProof", S, ["0x1"], "0x1"),
            ("eth_getBlockByNumber", "latest", False), ("eth_getBlockByNumber", "0x2", True),
            ("eth_getBlockByNumber", "0x0", False), ("eth_getBlockByNumber", "0xdeadbeef", False),
            ("eth_getBlockByNumber", "earliest", True), ("eth_getBlockByNumber", "pending", False),
            ("eth_getBlockByHash", "0x" + "cd" * 32, False),
            ("eth_getBlockTransactionCountByNumber", "0x2"),
            ("eth_getBlockTransactionCountByNumber", "latest"),
            ("eth_getBlockReceipts", "0x2"), ("eth_getBlockReceipts", "0x3"),
            ("eth_getBlockReceipts", "0x0"), ("eth_getBlockReceipts", "0x63"),
            ("eth_getTransactionByBlockNumberAndIndex", "0x2", "0x3"),
            ("eth_getTransactionByBlockNumberAndIndex", "0x2", "0x9"),
            ("eth_getTransactionByHash", h(pending.hash)),
            ("eth_getTransactionByHash", "0x" + "ab" * 32),
            ("eth_getTransactionReceipt", "0x" + "ab" * 32),
            ("eth_call", {"from": A, "to": SK, "value": "0x1"}, "latest"),
            ("eth_call", {"from": A, "to": S, "data": h(word(9) + word(9))}),
            ("eth_call", {"from": A, "to": h(reverter)}, "latest"),
            ("eth_call", {"from": A, "to": S, "data": h(word(9) + word(9))}, "0x1"),
            ("eth_estimateGas", {"from": A, "to": S, "data": h(word(8) + word(3))}),
            ("eth_estimateGas", {"from": A, "to": SK, "value": "0x1"}, "latest"),
            ("eth_estimateGas", {"from": A, "to": h(reverter)}),
            ("eth_createAccessList", {"from": A, "to": S, "data": h(word(7) + word(1))}, "latest"),
            ("eth_createAccessList", {"from": A, "to": h(reverter)}, "latest"),
            ("eth_getLogs", {"fromBlock": "0x0", "toBlock": "latest", "address": h(logger)}),
            ("eth_getLogs", {"fromBlock": "0x1", "toBlock": "0x3", "topics": [h(word(0x42))]}),
            ("eth_getLogs", {"fromBlock": "0x1", "toBlock": "0x2"}),
            ("eth_getLogs", {"blockHash": "0x" + "cd" * 32}),
            ("eth_getBalance",), ("eth_sendRawTransaction", "0xzz"),
        ]
        out = [n.call(*c) for c in calls]
        out += [n.call("eth_simulateV1", c, "latest") for c in simulate_cases(A, store, logger,
                                                                               reverter)]
        out.append(n.call("eth_simulateV1", SIMULATE[0], "0x2"))
        blocks = [result(n.call("eth_getBlockByNumber", hex(i), False)) for i in range(1, 4)]
        out += [n.call("eth_getBlockByHash", bl["hash"], True) for bl in blocks]
        out += [n.call("eth_getTransactionByHash", h(t)) for t in mined]
        out += [n.call("eth_getTransactionReceipt", h(t)) for t in mined]
        out += [n.call("eth_getLogs", {"blockHash": blocks[2]["hash"]})]
        # rejections: a stale nonce, an unfunded sender; then a fresh one
        out.append(n.send(alice.sign_tx(alice.transfer(SINK, 1), bump_nonce=False)))
        poor = type(alice)(0x9999)
        out.append(n.send(poor.transfer(SINK, 10**18)))
        out.append(n.send(bob.transfer(SINK, 3)))
        out.append(n.call("eth_getTransactionCount", h(bob.address), "pending"))
        return out


def test_every_eth_method_matches_reference():
    got = both(sc_eth)
    assert all(b'"jsonrpc": "2.0"' in r for r in got)
    sims = [json.loads(r) for r in got[N_CALLS:N_CALLS + len(SIMULATE) + 3]]
    assert len(sims[0]["result"]) == 2
    assert all(c["status"] == "0x1" for bl in sims[0]["result"] for c in bl["calls"])
    assert int(sims[0]["result"][1]["timestamp"], 16) == 0x77777777
    blocks = sims[1]["result"]
    assert [int(bl["number"], 16) for bl in blocks] == list(range(5, 10))
    assert all(cur["parentHash"] == prev["hash"] for prev, cur in zip(blocks, blocks[1:]))
    assert blocks[1]["stateRoot"] == blocks[0]["stateRoot"] != "0x" + "00" * 32
    assert "nonce" in sims[2]["error"]["message"]


def test_eth_methods_match_reference_on_the_card_route():
    both(sc_eth, port=RPORT_CARD)


def _account_proof(resp: dict, address: bytes) -> AccountProof:
    return AccountProof(
        address=address,
        account=Account(nonce=int(resp["nonce"], 16), balance=int(resp["balance"], 16),
                        storage_root=bytes.fromhex(resp["storageHash"][2:]),
                        code_hash=bytes.fromhex(resp["codeHash"][2:])),
        proof=[bytes.fromhex(x[2:]) for x in resp["accountProof"]],
        storage_root=bytes.fromhex(resp["storageHash"][2:]),
        storage_proofs=[StorageProof(bytes.fromhex(sp["key"][2:]), int(sp["value"], 16),
                                     [bytes.fromhex(x[2:]) for x in sp["proof"]])
                        for sp in resp["storageProof"]])


def test_proofs_verify_and_split_across_the_pool(monkeypatch):
    """3 slots on ProofCalculator, 80 on ProofWorkerPool (counted); each
    verifies against the tip's state root and equals the direct call."""
    P = RPORT
    b, (alice, bob) = wallets_builder(P)
    pools = []
    real = P.proof.ProofWorkerPool

    class Counting(real):
        def __init__(self, *a, **kw):
            pools.append(1)
            super().__init__(*a, **kw)

    monkeypatch.setattr(P.proof, "ProofWorkerPool", Counting)
    with RpcNode(P, b) as n:
        (store, _logger, _r), _mined, _pending = build_chain(n, alice, bob)
        root = bytes.fromhex(result(n.call("eth_getBlockByNumber", "latest", False))
                             ["stateRoot"][2:])
        for slots, want_pools in ((["0x1", "0x5", "0x63"], 0), (proof_slots(store), 1)):
            before = len(pools)
            resp = result(n.call("eth_getProof", h(store), slots, "latest"))
            assert len(pools) - before == want_pools
            ap = _account_proof(resp, store)
            assert verify_account_proof(root, store, ap)
            for sp in ap.storage_proofs:
                assert verify_storage_proof(ap.storage_root, sp)
            direct = P.proof.ProofCalculator(n.tree.overlay_provider(), n.tree.committer) \
                .account_proof(store, [word(int(s, 16)) for s in slots])
            assert [sp.proof for sp in direct.storage_proofs] == \
                [sp.proof for sp in ap.storage_proofs]
            assert direct.proof == ap.proof
        assert [int(sp["value"], 16) for sp in resp["storageProof"][:4]] == [2, 9, 1, 4]


# -- history: tests/test_history.py's engine cases and the pruned horizon ------


def sc_history(P):
    """Blocks persisted by the engine are indexed; the in-memory window is
    served from the changeset tail; a pruned horizon refuses reads below it."""
    b, (alice, bob) = wallets_builder(P)
    with RpcNode(P, b, persistence_threshold=2) as n:
        for i in range(5):
            n.send(alice.transfer(SINK, 100 + i))
            n.miner.mine_block()
        out = [repr(n.tree.persisted_number).encode()]
        out += [n.call("eth_getBalance", h(SINK), hex(i)) for i in range(7)]
        out += [n.call("eth_getTransactionCount", h(alice.address), hex(i)) for i in (1, 3, 5)]
        modes = PruneModes(account_history=PruneMode(before=3),
                           storage_history=PruneMode(before=3))
        if P is RREF:
            from reth_tpu.prune import PruneMode as JMode, PruneModes as JModes, Pruner as JPruner

            modes = JModes(account_history=JMode(before=3), storage_history=JMode(before=3))
            pruner = JPruner(n.factory, modes)
        else:
            pruner = Pruner(n.factory, modes)
        progress = pruner.run(n.tree.persisted_number)
        out.append(repr([(p.segment, p.pruned, p.done) for p in progress]).encode())
        out += [n.call("eth_getBalance", h(SINK), hex(i)) for i in range(6)]
        out += [n.call("eth_getStorageAt", h(SINK), "0x0", hex(i)) for i in (1, 2, 3)]
        out.append(n.call("eth_getAccount", h(SINK), "0x1"))
        out.append(n.call("eth_getProof", h(SINK), [], "0x2"))
        return out


def test_history_and_pruned_horizon_match_reference():
    got = both(sc_history)
    assert got[0] == b"3"
    assert [int(json.loads(r)["result"], 16) for r in got[2:7]] == [100, 201, 303, 406, 510]
    assert b"unknown block 6" in got[7]
    after = [json.loads(r) for r in got[12:18]]
    assert all("pruned below 3" in a["error"]["message"] for a in after[:3])
    assert [a["result"] for a in after[3:]] == [hex(303), hex(406), hex(510)]
