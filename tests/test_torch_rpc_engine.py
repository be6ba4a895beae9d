"""The port's engine_* namespace (rpc/engine_api.py) and its debug consensus
client (consensus/debug_client.py) against the JAX package's, on the CPU,
tolerance zero.

Both packages' auth servers (tests/_torch_rpc_pkgs.py) drive the same blocks
as a consensus client would: forkchoiceUpdated V1-V3 with payload attributes,
getPayload V1-V5 on the built payload (equal built blocks at pool parity;
payload ids are random in both packages, so they are left out),
newPayload V1-V5 (valid, a wrong block hash, mismatched blob hashes,
execution requests, which this pre-Prague chain's headers cannot carry), forkchoiceUpdated to the new head, the payload bodies
by hash and range, getBlobs V1/V2 from the pool's blob store, the
capabilities and the client version, and ``compute_requests_hash``. Every
response is held equal byte for byte; the card route's tree runs its
hot-state arena (kernels 1 and 4's plain versions). Over HTTP the auth
server refuses a request without its JWT (401).

``DebugConsensusClient`` follows a source node over HTTP
(``RpcBlockSource``) to the source's head on both packages. The departure: a
kernel fault in the follower loop ends the loop, is kept on the client and
re-raised by ``stop()``; any other cause is skipped, as in the reference.
"""

from __future__ import annotations

import hashlib
import json
import time

import pytest

from _torch_rpc_pkgs import (
    RPORT,
    RPORT_CARD,
    RREF,
    SINK,
    RpcNode,
    both,
    http,
    request,
    result,
    wallets_builder,
)
from reth_tpu_torch.ops._build import LaunchError

SECRET = bytes(range(32))


def h(b: bytes) -> str:
    return "0x" + b.hex()


def strip_ids(raw: bytes) -> bytes:
    """A forkchoiceUpdated response with its (random) payload id masked."""
    out = json.loads(raw)
    res = out.get("result")
    if isinstance(res, dict) and res.get("payloadId") is not None:
        res["payloadId"] = "<id>"
    return json.dumps(out).encode()


def attrs(ts: int, v3: bool = False) -> dict:
    a = {"timestamp": hex(ts), "prevRandao": "0x" + "11" * 32,
         "suggestedFeeRecipient": "0x" + "ee" * 20, "withdrawals": []}
    if v3:
        a["parentBeaconBlockRoot"] = "0x" + "22" * 32
    return a


def fcs(head: str, safe: str | None = None) -> dict:
    return {"headBlockHash": head, "safeBlockHash": safe or head,
            "finalizedBlockHash": safe or head}


def build_via_engine(n, version: int, ts: int, out: list):
    """fcU(attrs) -> getPayloadV<version> on the tip: the payload JSON."""
    head = result(n.auth("eth_getBlockByNumber", "latest", False))["hash"]
    fcu_v = min(version, 3)
    raw = n.auth(f"engine_forkchoiceUpdatedV{fcu_v}", fcs(head), attrs(ts))
    out.append(strip_ids(raw))
    pid = result(raw)["payloadId"]
    got = n.auth(f"engine_getPayloadV{version}", pid)
    out.append(got)
    res = result(got)
    return res if version == 1 else res["executionPayload"]


def sc_engine(P):
    b, (alice, bob) = wallets_builder(P)
    with RpcNode(P, b, hot_state=P is RPORT_CARD or None) as n:
        out = [n.auth("engine_exchangeCapabilities", []), n.auth("engine_getClientVersionV1", {})]
        genesis = result(n.auth("eth_getBlockByNumber", "0x0", False))["hash"]
        for version in (1, 2, 3, 4, 5):
            n.send(alice.transfer(SINK, 100 + version))
            n.send(bob.transfer(SINK, 200 + version))
            payload = build_via_engine(n, version, 12 * version, out)
            if version <= 2:
                st = n.auth(f"engine_newPayloadV{version}", payload)
            elif version == 3:
                st = n.auth("engine_newPayloadV3", payload, [], None)
            else:
                st = n.auth(f"engine_newPayloadV{version}", payload, [], None, [])
            out.append(st)
            out.append(strip_ids(n.auth("engine_forkchoiceUpdatedV2", fcs(payload["blockHash"],
                                                                          genesis))))
        head = result(n.auth("eth_getBlockByNumber", "latest", False))
        # rejections: a wrong block hash, mismatched blob hashes, an unknown head,
        # an unknown payload, attributes on a non-canonical head
        n.send(alice.transfer(SINK, 7))
        payload = build_via_engine(n, 2, 99, out)
        bad = dict(payload, blockHash="0x" + "13" * 32)
        out.append(n.auth("engine_newPayloadV2", bad))
        out.append(n.auth("engine_newPayloadV3", payload, ["0x01" + "00" * 31], None))
        out.append(n.auth("engine_newPayloadV4", payload, [], "0x" + "22" * 32,
                          ["0x00" + "ab" * 8, "0x01"]))
        out.append(strip_ids(n.auth("engine_forkchoiceUpdatedV1", fcs("0x" + "77" * 32))))
        out.append(n.auth("engine_getPayloadV2", "0x" + "00" * 8))
        out.append(n.auth("engine_getPayloadV1", "0x0102030405060708"))
        # V3 attributes with a beacon root on a pre-Cancun chain: the build fails
        raw = n.auth("engine_forkchoiceUpdatedV3", fcs(head["hash"]), attrs(100, v3=True))
        out.append(strip_ids(raw))
        out.append(n.auth("engine_getPayloadV3", result(raw)["payloadId"]))
        # bodies
        hashes = [result(n.auth("eth_getBlockByNumber", hex(i), False))["hash"]
                  for i in range(int(head["number"], 16) + 1)]
        out.append(n.auth("engine_getPayloadBodiesByHashV1", hashes + ["0x" + "77" * 32]))
        out.append(n.auth("engine_getPayloadBodiesByRangeV1", "0x1", "0x8"))
        out.append(n.auth("engine_getPayloadBodiesByRangeV1", "0x0", "0x1"))
        out.append(n.auth("engine_getPayloadBodiesByRangeV1", "0x2", "0x0"))
        # blobs from the pool's store: a sidecar put there directly
        blob, commitment, proof = b"\x01" * 64, b"\xc0" + b"\x02" * 47, b"\xc0" + b"\x03" * 47
        n.pool.blob_store.insert(b"\x99" * 32, P.BlobSidecar((blob,), (commitment,), (proof,)))
        vh = h(b"\x01" + hashlib.sha256(commitment).digest()[1:])
        out.append(n.auth("engine_getBlobsV1", [vh, "0x01" + "ff" * 31]))
        out.append(n.auth("engine_getBlobsV1", [vh]))
        out.append(n.auth("engine_getBlobsV2", [vh]))
        out.append(n.auth("engine_getBlobsV2", [vh, "0x01" + "ff" * 31]))
        out.append(n.call("eth_getBlockByNumber", "latest", True))
        out.append(json.dumps([head["number"], n.tree.head_hash.hex()]).encode())
        return out


def test_engine_api_matches_reference():
    got = both(sc_engine)
    assert [json.loads(got[i])["result"]["status"] for i in (4, 8, 12)] == ["VALID"] * 3
    # V4 / V5 set a requests hash the pre-Prague chain's header cannot carry
    assert b"non-contiguous optional header fields" in got[16]
    assert [json.loads(got[i])["result"]["validationError"] for i in (24, 25)] == \
        ["block hash mismatch", "blob versioned hashes mismatch"]
    assert json.loads(got[-2])["result"]["number"] == "0x3"


def test_engine_api_matches_reference_on_the_card_route():
    both(sc_engine, port=RPORT_CARD)


@pytest.mark.parametrize("requests", [[], [b""], [b"\x00"], [b"\x00" + b"\xab" * 8],
                                      [b"\x00\x01", b"\x01" + b"\xcd" * 40, b"\x02"]])
def test_compute_requests_hash_matches_reference(requests):
    assert RPORT.engine_api.compute_requests_hash(requests) == \
        RREF.engine_api.compute_requests_hash(requests)


def sc_payload_to_block(P):
    b, (alice, _bob) = wallets_builder(P)
    with RpcNode(P, b) as n:
        n.send(alice.transfer(SINK, 5))
        out = []
        payload = build_via_engine(n, 2, 12, out)
        block = P.engine_api.payload_to_block(payload, n.tree.committer)
        with_w = dict(payload, withdrawals=[{"index": "0x1", "validatorIndex": "0x2",
                                             "address": "0x" + "aa" * 20, "amount": "0x3"}])
        blk_w = P.engine_api.payload_to_block(with_w, n.tree.committer)
        back = P.engine_api.block_to_payload(block)
        return [block.encode(), blk_w.encode(), json.dumps(back).encode(),
                json.dumps(P.engine_api.block_to_payload(blk_w)).encode()]


def test_payload_to_block_matches_reference():
    both(sc_payload_to_block)


def test_engine_over_http_requires_the_token():
    b, (alice, _bob) = wallets_builder(RPORT)
    with RpcNode(RPORT, b, jwt_secret=SECRET) as n:
        _pub, auth = n.start()
        token = RPORT.jwt.encode_jwt(SECRET)
        body = request("engine_exchangeCapabilities", [])
        status, raw = http(auth, body)
        assert status == 401 and "unauthorized" in json.loads(raw)["error"]["message"]
        status, raw = http(auth, body, token)
        assert status == 200 and "engine_newPayloadV3" in json.loads(raw)["result"]
        n.send(alice.transfer(SINK, 9))
        head = result(n.auth("eth_getBlockByNumber", "latest", False))["hash"]
        status, raw = http(auth, request("engine_forkchoiceUpdatedV2", fcs(head), attrs(12)), token)
        pid = json.loads(raw)["result"]["payloadId"]
        status, raw = http(auth, request("engine_getPayloadV2", pid), token)
        payload = json.loads(raw)["result"]["executionPayload"]
        status, raw = http(auth, request("engine_newPayloadV2", payload), token)
        assert json.loads(raw)["result"]["status"] == "VALID"
        assert n.authrpc.kernel_faults == 0 and n.rpc.kernel_faults == 0


# -- the debug consensus client ---------------------------------------------------


def _mined_source(P, blocks: int):
    b, (alice, bob) = wallets_builder(P)
    src = RpcNode(P, b)
    for i in range(blocks):
        src.send(alice.transfer(SINK, 10 + i))
        src.send(bob.transfer(SINK, 20 + i))
        src.miner.mine_block()
    return src, b


def sc_follow(P):
    src, b = _mined_source(P, 3)
    follower = RpcNode(P, b)
    try:
        port, _auth = src.start()
        source = P.debug_client.RpcBlockSource(f"http://127.0.0.1:{port}/")
        client = P.debug_client.DebugConsensusClient(follower.tree, source, poll_interval=0.01)
        applied = client.run_once()
        out = [repr((applied, client.blocks_applied, source.tip())).encode(),
               follower.tree.head_hash, src.tree.head_hash,
               follower.call("eth_getBlockByNumber", "latest", True)]
        # the loop picks up a block mined later, then stops
        src.send(_alice_next(src))
        src.miner.mine_block()
        client.start()
        for _ in range(2000):
            if client.blocks_applied == 4:
                break
            time.sleep(0.005)
        client.stop()
        out += [repr(client.blocks_applied).encode(), follower.tree.head_hash,
                src.tree.head_hash, repr(source.block_by_number(99)).encode()]
        return out
    finally:
        follower.stop()
        src.stop()


def _alice_next(node):
    """alice's next transfer, signed at her nonce on ``node``'s tip."""
    from _torch_rpc_pkgs import Wallet

    w = Wallet(0xA11CE)
    w.nonce = int(result(node.call("eth_getTransactionCount", "0x" + w.address.hex(),
                                   "latest")), 16)
    return w.transfer(SINK, 31)


def test_debug_client_follows_a_source_like_reference():
    got = both(sc_follow)
    assert got[0] == b"(3, 3, 3)" and got[1] == got[2]
    assert got[4] == b"4" and got[5] == got[6]


@pytest.mark.parametrize("fault", [LaunchError("keccak256_absorb: launch failed"),
                                   RuntimeError("CUDA error: an illegal memory access")])
def test_debug_client_kernel_fault_ends_the_loop(fault):
    src, b = _mined_source(RPORT, 2)
    follower = RpcNode(RPORT, b)
    try:
        port, _auth = src.start()
        source = RPORT.debug_client.RpcBlockSource(f"http://127.0.0.1:{port}/")
        client = RPORT.debug_client.DebugConsensusClient(follower.tree, source,
                                                         poll_interval=0.01)
        calls = []

        def faulty(block):
            calls.append(block.header.number)
            raise fault

        follower.tree.on_new_payload = faulty
        client.start()
        client._thread.join(timeout=60)
        assert not client._thread.is_alive() and client.fault is fault
        with pytest.raises(type(fault)):
            client.stop()
        assert calls == [1]
    finally:
        follower.stop()
        src.stop()


@pytest.mark.parametrize("P", [RREF, RPORT], ids=["reference", "port"])
def test_debug_client_skips_other_faults(P):
    src, b = _mined_source(P, 2)
    follower = RpcNode(P, b)
    try:
        port, _auth = src.start()
        source = P.debug_client.RpcBlockSource(f"http://127.0.0.1:{port}/")
        client = P.debug_client.DebugConsensusClient(follower.tree, source, poll_interval=0.01)
        real = follower.tree.on_new_payload
        calls = []

        def flaky(block):
            calls.append(block.header.number)
            if len(calls) <= 2:
                raise ValueError("source hiccup")
            return real(block)

        follower.tree.on_new_payload = flaky
        client.start()
        for _ in range(4000):
            if client.blocks_applied == 2:
                break
            time.sleep(0.005)
        client.stop()
        assert client.blocks_applied == 2 and calls[:3] == [1, 1, 1]
        assert follower.tree.head_hash == src.tree.head_hash
    finally:
        follower.stop()
        src.stop()
