"""The port's networking (net/: wire, ECIES, RLPx, snappy, the swarm, the
sessions, reputation, the downloaders; stages/headers_bodies.py;
rpc/admin.py) against the JAX package's, on the CPU.

The cases of tests/test_net.py (but the launched node's, which waits for the
node), test_rlpx.py, test_downloaders.py, test_reputation_hooks.py and the
admin half of test_ws_admin.py run on the port; beyond them:
- interop over TCP both ways: the ECIES handshake, RLPx frames and snappy
  between the two packages, a port client syncing from a reference
  ``NetworkManager`` and a reference client from a port one, the synced
  tables equal row for row;
- equal bytes: the same message gives the same ``wire.encode_message`` and
  ``snappy.compress`` bytes in both packages;
- a kernel fault (a monkeypatched launch error) at each departure site of
  this layer (the swarm's serve loop, the body windows, ``admin_addPeer``)
  raises, and any other error keeps the reference's outcome.
The port's clients root on its card route on the CPU (``P.committer()``).
Only ephemeral ports; every server is stopped.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import socket
import threading
import time

import pytest

from _torch_net_pkgs import NPORT, NREF, SINK, builder, fresh, synced, tables
from reth_tpu_torch.ops._build import LaunchError

PAIRS = [(c, s) for c in (NREF, NPORT) for s in (NREF, NPORT)]
A_PRIV = 0x1111111111111111111111111111111111111111111111111111111111111111
B_PRIV = 0x2222222222222222222222222222222222222222222222222222222222222222
SERVER_KEY = {"reference": 0xA11CE5, "port": 0xB0B5}


def launch_fault(*_args):
    raise LaunchError("keccak256_absorb: CUDA error 700 at launch")


def plain_fault(*_args):
    raise ValueError("not a kernel fault")


def _wait(cond, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


@pytest.fixture(scope="module")
def chains():
    """Each package's node synced to block 8 of the same chain."""
    out = {P.name: synced(P) for P in (NREF, NPORT)}
    assert out["reference"][1].tip.hash == out["port"][1].tip.hash
    return out


class Net:
    """A started server of package S over its synced node, and what a client
    of package C needs to dial it."""

    def __init__(self, chains, S, **kw):
        self.S = S
        self.factory, self.builder = chains[S.name]
        self.status = S.Status(network_id=1, head=self.builder.tip.hash,
                               genesis=self.builder.genesis.hash)
        self.server = S.NetworkManager(self.factory, self.status,
                                       node_priv=SERVER_KEY[S.name], **S.kw, **kw)
        self.port = self.server.start()

    def genesis_status(self, C):
        b = self.builder
        return C.Status(network_id=1, head=b.genesis.hash, genesis=b.genesis.hash)

    def dial(self, C, status=None, **kw):
        return C.PeerConnection.connect("127.0.0.1", self.port, status or self.status_for(C),
                                        C.pub(self.server.node_priv), **kw)

    def status_for(self, C):
        b = self.builder
        return C.Status(network_id=1, head=b.tip.hash, genesis=b.genesis.hash)

    def stop(self):
        self.server.stop()


@pytest.fixture()
def net(chains):
    """The port's server (the reference's testnet fixture)."""
    n = Net(chains, NPORT)
    yield n
    n.stop()


# -- wire codecs: equal bytes --------------------------------------------------


def _messages(P, header):
    w = P.wire
    return [
        P.Status(68, 1, 0, b"\x01" * 32, b"\x02" * 32, (b"\xaa\xbb\xcc\xdd", 0)),
        P.Status(version=69, network_id=7, genesis=b"\x09" * 32, head=b"\x08" * 32,
                 fork_id=(b"\xaa\xbb\xcc\xdd", 123), earliest=4, latest=99),
        w.GetBlockHeaders(7, 100, 10, 0, True),
        w.GetBlockHeaders(8, b"\x03" * 32, 1),
        w.BlockHeaders(7, [header]),
        w.GetBlockBodies(9, [b"\x04" * 32]),
        w.BlockBodies(9, [w.BlockBody((), (), ())]),
        w.GetReceipts(1, [b"\x05" * 32]),
        w.ReceiptsMsg(1, [[b"rc1", b"rc2"], []]),
        w.NewPooledTxHashes(b"\x02", [120], [b"\x06" * 32]),
        w.NewBlockHashes([(b"\x07" * 32, 5)]),
        w.BlockRangeUpdate(1, 2, b"\x03" * 32),
    ]


def test_wire_messages_roundtrip_to_equal_bytes(chains):
    """Each message encodes to the reference's bytes and decodes back to itself
    in the port; each package decodes the other's frames."""
    ref_msgs = _messages(NREF, chains["reference"][1].genesis)
    port_msgs = _messages(NPORT, chains["port"][1].genesis)
    for rm, pm in zip(ref_msgs, port_msgs):
        frame = NPORT.wire.encode_message(pm)
        assert frame == NREF.wire.encode_message(rm), type(pm).__name__
        assert NPORT.wire.decode_message(frame[4:]) == pm
        assert NREF.wire.decode_message(frame[4:]) == rm
    blk = chains["port"][1].blocks[3]
    body = NPORT.wire.BlockBodies(5, [NPORT.wire.BlockBody(blk.transactions, blk.ommers,
                                                           blk.withdrawals)])
    frame = NPORT.wire.encode_message(body)
    ref_blk = chains["reference"][1].blocks[3]
    assert frame == NREF.wire.encode_message(NREF.wire.BlockBodies(5, [NREF.wire.BlockBody(
        ref_blk.transactions, ref_blk.ommers, ref_blk.withdrawals)]))
    assert NPORT.wire.decode_message(frame[4:]) == body


# -- sessions over TCP, both ways -----------------------------------------------


def sc_requests(C, net):
    """Headers by number and by hash (reversed), bodies and receipts."""
    peer = net.dial(C)
    try:
        b = net.builder
        headers = peer.get_headers(1, 5)
        rev = peer.get_headers(b.blocks[4].hash, 3, reverse=True)
        bodies = peer.get_bodies([b.blocks[2].hash])
        receipts = peer.get_receipts([b.blocks[2].hash])
        return (peer.status.head, [h.hash for h in headers], [h.number for h in rev],
                [[t.hash for t in body.transactions] for body in bodies],
                [list(map(bytes, r)) for r in receipts], peer.session.snappy_enabled,
                peer.eth_version, peer.snap_enabled)
    finally:
        peer.close()


def test_handshake_and_requests_across_packages(chains):
    """ECIES, RLPx frames and snappy are wire-compatible: each package's client
    gets the same answers from each package's server."""
    servers = {S.name: Net(chains, S) for S in (NREF, NPORT)}
    try:
        traces = {(C.name, S.name): sc_requests(C, servers[S.name]) for C, S in PAIRS}
    finally:
        for s in servers.values():
            s.stop()
    first = traces[("reference", "reference")]
    b = chains["port"][1]
    assert first[0] == b.tip.hash and first[1][0] == b.blocks[1].hash
    assert first[2] == [4, 3, 2] and len(first[3][0]) == 1 and len(first[4][0]) == 1
    assert first[5] is True
    for key, trace in traces.items():
        assert trace == first, key


def test_genesis_mismatch_rejected(net):
    with pytest.raises(NPORT.PeerError):
        net.dial(NPORT, NPORT.Status(network_id=1, genesis=b"\x66" * 32))


def test_full_sync_from_peer(net):
    """The legacy flow (bulk download, import, the given pipeline) reproduces
    the server's tables row for row."""
    client = fresh(NPORT, net.builder)
    peer = net.dial(NPORT, net.genesis_status(NPORT))
    try:
        pipeline = NPORT.Pipeline(client, NPORT.stages())
        assert NPORT.downloader.sync_from_peer(client, peer, pipeline, NPORT.consensus(),
                                               **NPORT.kw) == 8
        with client.provider() as p:
            assert p.stage_checkpoint("Finish") == 8
            assert p.header_by_number(8).state_root == net.builder.tip.state_root
            assert p.account(SINK).balance == sum(100 + i for i in range(8))
        assert tables(client) == tables(net.factory)
        # idempotent: a second sync is a no-op
        assert NPORT.downloader.sync_from_peer(client, peer, pipeline, **NPORT.kw) == 8
    finally:
        peer.close()


@pytest.mark.parametrize("C,S", [(NPORT, NREF), (NREF, NPORT)],
                         ids=["port-from-reference", "reference-from-port"])
def test_online_sync_across_packages(chains, C, S):
    """The online stages (no pipeline argument) over an encrypted session to a
    server of the other package: the synced tables equal the server's, row for
    row, but the download stages' checkpoints."""
    server = Net(chains, S)
    try:
        client = fresh(C, server.builder)
        peer = server.dial(C, server.genesis_status(C))
        try:
            kw = dict(committer=C.committer(), **C.kw)
            assert C.downloader.sync_from_peer(client, peer, **kw) == 8
        finally:
            peer.close()
    finally:
        server.stop()
    with client.provider() as p:
        assert [p.stage_checkpoint(s) for s in ("Headers", "Bodies", "Finish")] == [8, 8, 8]
    skip = ("StageCheckpoints", "StageCheckpointProgresses")
    assert tables(client, skip) == tables(server.factory, skip)
    other = chains[C.name][0]
    assert tables(client, skip) == tables(other, skip)


def test_online_pipeline_sync_unwind_and_resync(net):
    """Headers and Bodies as pipeline stages (reference OnlineStages): sync,
    unwind to 6 through the online set, sync again."""
    client = fresh(NPORT, net.builder)
    peer = net.dial(NPORT, net.genesis_status(NPORT))
    try:
        assert NPORT.downloader.sync_from_peer(client, peer, committer=NPORT.committer(),
                                               **NPORT.kw) == 8
        synced_tables = tables(client)
        requeued = NPORT.downloader.BodiesDownloader.requeued_total
        pipeline = NPORT.Pipeline(client, NPORT.online_stages(
            peer, committer=NPORT.committer(), **NPORT.kw))
        pipeline.unwind(6)
        with client.provider() as p:
            assert p.stage_checkpoint("Headers") == 6
            assert p.header_by_number(8) is None
            assert p.canonical_hash(7) is None
        pipeline.run(8)
        with client.provider() as p:
            assert p.header_by_number(8).state_root == net.builder.tip.state_root
        assert tables(client) == synced_tables
        assert NPORT.downloader.BodiesDownloader.requeued_total == requeued
    finally:
        peer.close()


def test_online_sync_with_two_peers(net):
    client = fresh(NPORT, net.builder)
    st = net.genesis_status(NPORT)
    peer1, peer2 = net.dial(NPORT, st), net.dial(NPORT, st)
    try:
        assert NPORT.downloader.sync_from_peer(client, peer1, committer=NPORT.committer(),
                                               extra_peers=(peer2,), **NPORT.kw) == 8
        with client.provider() as p:
            assert p.stage_checkpoint("Finish") == 8
            assert p.header_by_number(8).state_root == net.builder.tip.state_root
    finally:
        peer1.close()
        peer2.close()


def test_tx_broadcast_into_pool(net):
    from reth_tpu_torch.engine import EngineTree
    from reth_tpu_torch.pool import TransactionPool

    tree = EngineTree(net.factory, committer=NPORT.np(), device="cpu")
    pool = TransactionPool(lambda: tree.overlay_provider())
    pool.base_fee = 10**9
    net.server.pool = pool
    alice = NPORT.Wallet(0xA11CE)
    alice.nonce = 8  # after 8 mined transactions
    tx = alice.transfer(b"\x0c" * 20, 5)
    peer = net.dial(NPORT)
    try:
        peer.send(NPORT.wire.TransactionsMsg([tx]))
        assert _wait(lambda: pool.contains(tx.hash), 5.0)
    finally:
        peer.close()


def test_enode_dial_and_discovery_assisted_sync(net):
    """discv4 bootstrap and bond, then dial the discovered record's enode over
    encrypted RLPx with snappy on, and sync over it."""
    d_server = NPORT.discv4.Discv4(net.server.node_priv, tcp_port=net.port)
    d_server.start()
    client = fresh(NPORT, net.builder)
    client_net = NPORT.NetworkManager(client, net.genesis_status(NPORT), **NPORT.kw)
    d_client = NPORT.discv4.Discv4(client_net.node_priv)
    d_client.start()
    try:
        d_client.bootstrap([d_server.enode()])
        assert _wait(lambda: getattr(d_client.table.by_id.get(d_server.node_id),
                                     "bonded", False)), "bonding with the bootnode failed"
        rec = d_client.table.by_id[d_server.node_id]
        peer = client_net.connect_to(rec.enode())
        assert peer.session.snappy_enabled
        pipeline = NPORT.Pipeline(client, NPORT.stages())
        assert NPORT.downloader.sync_from_peer(client, peer, pipeline, NPORT.consensus(),
                                               **NPORT.kw) == 8
        with client.provider() as p:
            assert p.header_by_number(8).state_root == net.builder.tip.state_root
        peer.close()
    finally:
        d_server.stop()
        d_client.stop()


def test_fork_id_filter_rejects_incompatible_peer(net):
    from reth_tpu_torch.chainspec import MAINNET, dev_spec

    b = net.builder
    net.server.chain_spec = dev_spec(chain_id=1, genesis_hash=b.genesis.hash)
    net.server.head_position = (8, b.tip.timestamp)
    ok_fid = net.server.chain_spec.fork_id(8, b.tip.timestamp)
    good = NPORT.Status(network_id=1, head=b.genesis.hash, genesis=b.genesis.hash,
                        fork_id=ok_fid)
    net.dial(NPORT, good).close()
    bad = NPORT.Status(network_id=1, head=b.genesis.hash, genesis=b.genesis.hash,
                       fork_id=(bytes.fromhex("668db0af"), 0))
    with pytest.raises((NPORT.PeerError, OSError)):
        net.dial(NPORT, bad).get_headers(1, 1)
    with pytest.raises(NPORT.PeerError):
        net.dial(NPORT, bad, fork_filter=lambda fid: MAINNET.validate_fork_id(fid, 7_987_396))


def test_eth69_negotiation_and_block_range(net):
    st69 = dataclasses.replace(net.status, earliest=0, latest=8)
    peer = net.dial(NPORT, st69)
    try:
        assert peer.eth_version == 69 and peer.status.version == 69
        assert peer.snap_enabled and peer.snap_offset == 0x10 + 18
        assert [h.number for h in peer.get_headers(1, 3)] == [1, 2, 3]
        peer.send(NPORT.wire.BlockRangeUpdate(0, 8, net.builder.tip.hash))
        assert _wait(lambda: bool(net.server.peers and net.server.peers[-1].block_range), 5)
        assert net.server.peers[-1].block_range == (0, 8, net.builder.tip.hash)
    finally:
        peer.close()


def test_session_manager_caps_and_events(net):
    server = net.server
    server.sessions.max_inbound = 2
    events = []
    server.sessions.listeners.append(lambda ev, s: events.append((ev, s.direction)))
    st = net.genesis_status(NPORT)
    p1, p2 = net.dial(NPORT, st), net.dial(NPORT, st)
    assert _wait(lambda: len(server.sessions.active("inbound")) == 2, 5)
    assert ("established", "inbound") in events
    with pytest.raises((NPORT.PeerError, OSError)):
        net.dial(NPORT, st, timeout=3)
    assert len(server.sessions.active("inbound")) == 2
    p1.get_headers(1, 2)
    assert sum(s.messages_in for s in server.sessions.active()) >= 1
    p1.close()
    assert _wait(lambda: len(server.sessions.active("inbound")) == 1, 5)
    assert ("closed", "inbound") in events
    counts = server.sessions.counts()
    assert counts["established_total"] >= 2 and counts["closed_total"] >= 1
    net.dial(NPORT, st).close()
    p2.close()


def test_outbound_session_released_on_close(net):
    dialer = NPORT.NetworkManager(NPORT.Factory(NPORT.MemDb()), net.genesis_status(NPORT),
                                  max_outbound=2, **NPORT.kw)
    for _ in range(5):
        p = dialer.connect_to(net.server.enode)
        assert len(dialer.sessions.active("outbound")) == 1
        p.close()
        assert len(dialer.sessions.active("outbound")) == 0
    assert dialer.sessions.counts()["closed_total"] >= 5


def test_swarm_soak_flat_thread_count(net):
    """30 inbound sessions served by the one loop thread."""
    peers = []
    try:
        for i in range(30):
            peers.append(net.dial(NPORT, node_priv=0xB000 + i))
        assert _wait(lambda: len(net.server.peers) == 30)
        baseline = threading.active_count()
        for p in peers:
            headers = p.get_headers(0, 2)
            assert headers and headers[0].hash == net.builder.genesis.hash
        for p in peers:
            assert p.get_headers(1, 1)
        assert threading.active_count() <= baseline
        assert net.server.swarm._thread.is_alive()
    finally:
        for p in peers:
            p.close()


# -- the departure: a kernel fault in the swarm's serve loop --------------------


@pytest.mark.parametrize("fault", [launch_fault, plain_fault], ids=["kernel", "other"])
def test_swarm_serve_fault(net, fault):
    """A snap request whose proof hashing fails: the peer is dropped either way
    (the reference's outcome); a kernel fault is also kept on the manager and
    raised by ``stop()``."""
    from reth_tpu_torch.trie.committer import TrieCommitter

    server = net.server
    server._snap = NPORT.snap.SnapServer(net.factory, committer=TrieCommitter(
        hasher=fault, device="cpu"))
    peer = net.dial(NPORT, node_priv=0xC1)
    try:
        with pytest.raises((NPORT.PeerError, OSError)):
            peer.get_account_range(net.builder.tip.state_root, b"\x00" * 32, b"\xff" * 32)
    finally:
        peer.close()
    assert _wait(lambda: not server.peers, 5)
    assert server.peers_manager.reputation(NPORT.rlpx.node_id(0xC1)) == 0  # not penalized
    if fault is launch_fault:
        assert server.kernel_faults == 1
        with pytest.raises(LaunchError, match="CUDA error 700"):
            server.stop()
        server.kernel_fault = None  # the fixture stops it again
    else:
        assert server.kernel_faults == 0 and server.kernel_fault is None


# -- ECIES and RLPx: the port against the reference -----------------------------


def test_streaming_keccak_matches_oneshot():
    data = bytes(range(256)) * 3
    for P in (NPORT, NREF):
        k = P.keccak.Keccak256()
        for i in range(0, len(data), 37):
            k.update(data[i:i + 37])
        assert k.digest() == P.keccak.keccak256(data)
    k2 = NPORT.keccak.Keccak256(data)
    r2 = NREF.keccak.Keccak256(data)
    assert k2.digest() == r2.digest()
    k2.update(b"more")
    r2.update(b"more")
    assert k2.digest() == r2.digest() == NREF.keccak.keccak256(data + b"more")
    assert k2.copy().update(b"x").digest() == NREF.keccak.keccak256(data + b"morex")


@pytest.mark.parametrize("payload", [
    b"", b"a", b"hello world", bytes(range(256)), b"ab" * 5000,
    b"".join(__import__("hashlib").sha256(bytes([i])).digest() for i in range(94)),
    b"\x00" * 100000,
], ids=["empty", "one", "text", "range", "repeat", "random", "zeros"])
def test_snappy_roundtrip_equal_bytes(payload):
    c = NPORT.snappy.compress(payload)
    assert c == NREF.snappy.compress(payload)
    assert NPORT.snappy.decompress(c) == payload


def test_snappy_vectors_and_malformed():
    s = NPORT.snappy
    assert len(s.compress(b"reth-tpu " * 1000)) < 9000 // 4
    assert s.decompress(bytes([5, 4 << 2]) + b"abcde") == b"abcde"
    assert s.decompress(bytes([8, 0]) + b"a" + bytes([1 | (3 << 2), 1])) == b"a" * 8
    with pytest.raises(s.SnappyError):
        s.decompress(bytes([10, 4 << 2]) + b"abcde")
    with pytest.raises(s.SnappyError):
        s.decompress(bytes([4, 2 | (3 << 2), 9, 0]))


@pytest.mark.parametrize("E,D", [(NPORT, NPORT), (NPORT, NREF), (NREF, NPORT)],
                         ids=["port", "port-to-reference", "reference-to-port"])
def test_ecies_roundtrip_and_tamper(E, D):
    msg = b"secret handshake payload"
    ct = E.ecies.encrypt(E.pub(B_PRIV), msg, shared_mac_data=b"\x01\x02")
    assert D.ecies.decrypt(B_PRIV, ct, shared_mac_data=b"\x01\x02") == msg
    with pytest.raises(D.ecies.EciesError):
        D.ecies.decrypt(B_PRIV, ct, shared_mac_data=b"\x01\x03")
    bad = bytearray(ct)
    bad[100] ^= 1
    with pytest.raises(D.ecies.EciesError):
        D.ecies.decrypt(B_PRIV, bytes(bad))
    with pytest.raises(D.ecies.EciesError):
        D.ecies.decrypt(A_PRIV, ct)


@pytest.mark.parametrize("I,R", [(NPORT, NPORT), (NPORT, NREF), (NREF, NPORT)],
                         ids=["port", "port-initiates", "reference-initiates"])
def test_handshake_both_sides_derive_same_keys(I, R):
    init, resp = I.ecies.Handshake(A_PRIV), R.ecies.Handshake(B_PRIV)
    ack, s_resp = resp.on_auth(init.auth(I.pub(B_PRIV)))
    s_init = init.finalize_initiator(ack)
    assert (s_init.aes, s_init.mac) == (s_resp.aes, s_resp.mac)
    assert s_init.egress_mac.digest() == s_resp.ingress_mac.digest()
    assert s_init.ingress_mac.digest() == s_resp.egress_mac.digest()
    assert resp.remote_pub == R.pub(A_PRIV)


def test_handshake_rejects_wrong_recipient():
    auth = NPORT.ecies.Handshake(A_PRIV).auth(NPORT.pub(B_PRIV))
    with pytest.raises(NPORT.ecies.EciesError):
        NPORT.ecies.Handshake(0x3333).on_auth(auth)


def _session_pair(I, R):
    a, b = socket.socketpair()
    out = {}
    t = threading.Thread(target=lambda: out.__setitem__("resp", R.rlpx.respond(b, B_PRIV)))
    t.start()
    out["init"] = I.rlpx.initiate(a, A_PRIV, I.pub(B_PRIV))
    t.join(timeout=30)
    return out["init"], out["resp"]


SESSION_PAIRS = pytest.mark.parametrize("I,R", [(NPORT, NPORT), (NPORT, NREF),
                                                (NREF, NPORT)],
                                        ids=["port", "port-initiates", "reference-initiates"])


@SESSION_PAIRS
def test_rlpx_frames_bidirectional(I, R):
    s1, s2 = _session_pair(I, R)
    rng = random.Random(5)
    try:
        s1.send_frame(b"\x80hello over rlpx")
        assert s2.recv_frame() == b"\x80hello over rlpx"
        s2.send_frame(b"\x80reply")
        assert s1.recv_frame() == b"\x80reply"
        for i in range(20):
            payload = bytes(rng.randrange(256) for _ in range(1 + i * 37))
            s1.send_frame(payload)
            assert s2.recv_frame() == payload
            s2.send_frame(payload[::-1])
            assert s1.recv_frame() == payload[::-1]
    finally:
        s1.close()
        s2.close()


def test_rlpx_tampered_frame_rejected():
    s1, s2 = _session_pair(NPORT, NPORT)
    raw_sock = s1.sock
    s1.send_frame(b"\x80data")
    assert s2.sock.recv(65536, socket.MSG_PEEK)
    data = bytearray(s2.sock.recv(65536))
    data[20] ^= 1
    r, w = socket.socketpair()
    w.sendall(bytes(data))
    s2.sock = r
    with pytest.raises(NPORT.rlpx.RlpxError):
        s2.recv_frame()
    raw_sock.close()


@SESSION_PAIRS
def test_rlpx_hello_and_snappy_messages(I, R):
    s1, s2 = _session_pair(I, R)
    result = {}
    t = threading.Thread(target=lambda: result.__setitem__(
        "hello", s2.hello(B_PRIV, "reth-tpu/test-b", [("eth", 68)])))
    t.start()
    remote = s1.hello(A_PRIV, "reth-tpu/test-a", [("eth", 68)], port=30303)
    t.join(timeout=30)
    try:
        assert remote["client_id"] == "reth-tpu/test-b" and remote["caps"] == [("eth", 68)]
        assert result["hello"]["port"] == 30303
        assert result["hello"]["node_id"] == I.rlpx.node_id(A_PRIV) == R.rlpx.node_id(A_PRIV)
        assert s1.snappy_enabled and s2.snappy_enabled
        body = b"\xaa" * 10_000 + os.urandom(300)
        s1.send_msg(0x10, body)
        assert s2.recv_msg() == (0x10, body)
        s2.send_msg(0x11, body[::-1])
        assert s1.recv_msg() == (0x11, body[::-1])
    finally:
        s1.close()
        s2.close()


# -- reputation and the invalid-block hook --------------------------------------


def test_reputation_penalties_ban_and_expiry():
    rep = NPORT.reputation
    for P in (NPORT, NREF):
        pm = P.reputation.PeersManager(ban_seconds=9999)
        nid = b"\x01" * 64
        assert not pm.is_banned(nid)
        for _ in range(3):
            pm.reputation_change(nid, "bad_block")
        assert pm.reputation(nid) <= P.reputation.BANNED_REPUTATION and pm.is_banned(nid)
        pm.unban(nid)
        assert not pm.is_banned(nid) and pm.reputation(nid) == 0
    pm = rep.PeersManager(ban_seconds=0.0)
    pm.ban(b"\x02" * 64)
    assert not pm.is_banned(b"\x02" * 64) and pm.reputation(b"\x02" * 64) == 0
    pm = rep.PeersManager()
    pm.reputation_change(b"\x03" * 64, "timeout")
    pm.reputation_change(b"\x03" * 64, "good")
    assert pm.reputation(b"\x03" * 64) > -4_00
    assert rep.REPUTATION_CHANGE == NREF.reputation.REPUTATION_CHANGE


def test_invalid_block_hook_writes_the_reference_witness(tmp_path):
    from reth_tpu.engine import EngineTree as JTree
    from reth_tpu.engine.invalid_hooks import InvalidBlockWitnessHook as JHook
    from reth_tpu_torch.engine import EngineTree
    from reth_tpu_torch.engine.invalid_hooks import InvalidBlockWitnessHook

    witnesses = []
    for P, Tree, Hook, kw in ((NREF, JTree, JHook, {}),
                              (NPORT, EngineTree, InvalidBlockWitnessHook, NPORT.kw)):
        bld = builder(P, 1, wallet=0xA11CE, to=b"\x22" * 20)
        good = bld.blocks[1]
        factory = fresh(P, bld)
        out = tmp_path / P.name
        tree = Tree(factory, committer=P.np(), consensus=P.consensus(np=True),
                     invalid_block_hooks=[Hook(out)], **kw)
        bad_header = P.types.Header(**{**good.header.__dict__, "state_root": b"\x66" * 32})
        bad = P.types.Block(bad_header, good.transactions, (), good.withdrawals)
        assert tree.on_new_payload(bad).status.name == "INVALID"
        files = list(out.glob("*.json"))
        assert len(files) == 1
        witnesses.append(json.loads(files[0].read_text()))
    ref, port = witnesses
    assert "state root mismatch" in port["reason"] and port["postAccounts"]
    assert port == ref


# -- downloaders ---------------------------------------------------------------


class _Body:
    def __init__(self, block):
        self.transactions, self.ommers, self.withdrawals = (
            block.transactions, block.ommers, block.withdrawals)


class MockPeer:
    """A header/body server over a built chain (PeerConnection's shape)."""

    def __init__(self, bld, shuffle_delay=False, tamper_header=None, lie_bodies=False):
        self.by_hash = {b.hash: b for b in bld.blocks}
        self.by_number = {b.header.number: b for b in bld.blocks}
        self.shuffle_delay, self.tamper_header, self.lie_bodies = (
            shuffle_delay, tamper_header, lie_bodies)
        self.requests = 0

    def get_headers(self, start, limit, reverse=False, skip=0):
        from reth_tpu_torch.primitives.types import Header

        self.requests += 1
        blk = (self.by_hash if isinstance(start, bytes) else self.by_number).get(start)
        out = []
        while blk is not None and len(out) < limit:
            h = blk.header
            if self.tamper_header is not None and h.number == self.tamper_header:
                h = Header(**{**h.__dict__, "gas_used": h.gas_used + 1})
            out.append(h)
            blk = self.by_number.get(h.number - 1 if reverse else h.number + 1)
        return out

    def get_bodies(self, hashes):
        self.requests += 1
        if self.shuffle_delay:
            time.sleep(random.random() * 0.02)
        if self.lie_bodies:
            return [_Body(self.by_number[max(0, self.by_hash[h].header.number - 1)])
                    for h in hashes]
        return [_Body(self.by_hash[h]) for h in hashes]


@pytest.fixture(scope="module")
def chain24():
    return builder(NPORT, 24)


def test_reverse_headers_from_tip_hash(chain24):
    peer = MockPeer(chain24)
    dl = NPORT.downloader
    headers = dl.download_headers_reverse(peer, chain24.tip.hash, 0, batch=7)
    assert [h.number for h in headers] == list(range(1, 25))
    assert headers[-1].hash == chain24.tip.hash
    assert [h.number for h in dl.download_headers_reverse(peer, chain24.tip.hash, 10,
                                                          batch=7)] == list(range(11, 25))
    with pytest.raises(NPORT.PeerError, match="hash-link"):
        dl.download_headers_reverse(MockPeer(chain24, tamper_header=6), chain24.tip.hash, 0,
                                    batch=5)


def test_bodies_windows_out_of_order_two_peers(chain24):
    headers = [b.header for b in chain24.blocks[1:]]
    dl = NPORT.downloader.BodiesDownloader(
        [MockPeer(chain24, shuffle_delay=True), MockPeer(chain24, shuffle_delay=True)],
        window=4, consensus=NPORT.consensus(np=True))
    blocks = dl.download(headers)
    assert [b.hash for b in blocks] == [b.hash for b in chain24.blocks[1:]]
    assert len(dl.stats) == 2 and all(v > 0 for v in dl.stats.values())
    assert dl.requeued == 0


def test_bodies_lying_peer_penalized_and_requeued(chain24):
    headers = [b.header for b in chain24.blocks[1:17]]
    liar, honest = MockPeer(chain24, lie_bodies=True), MockPeer(chain24)
    reports = []
    dl = NPORT.downloader.BodiesDownloader(
        [liar, honest], window=4, reporter=lambda peer, kind: reports.append((peer, kind)),
        consensus=NPORT.consensus(np=True))
    blocks = dl.download(headers)
    assert [b.header.number for b in blocks] == list(range(1, 17))
    assert reports and all(p is liar for p, _ in reports)
    assert dl.stats.get(1, 0) == 4 and dl.requeued == len(reports)
    bad = NPORT.downloader.BodiesDownloader([MockPeer(chain24, lie_bodies=True)], window=4,
                                            consensus=NPORT.consensus(np=True))
    with pytest.raises(NPORT.PeerError, match="unserved"):
        bad.download(headers[:8])


@pytest.mark.parametrize("fault", [launch_fault, plain_fault], ids=["kernel", "other"])
def test_bodies_window_fault(chain24, fault):
    """A body root that fails to hash: a kernel fault stops every worker and
    raises once they are joined, with no peer penalized and no window
    re-queued; any other error penalizes the peer and re-queues its window, as
    the reference does with the same error."""
    from reth_tpu.consensus import EthBeaconConsensus as JConsensus
    from reth_tpu.net.downloader import BodiesDownloader as JBodies
    from reth_tpu.trie.committer import TrieCommitter as JCommitter
    from reth_tpu_torch.trie.committer import TrieCommitter

    headers = [b.header for b in chain24.blocks[1:9]]
    reports = []
    dl = NPORT.downloader.BodiesDownloader(
        [MockPeer(chain24), MockPeer(chain24)], window=2,
        reporter=lambda peer, kind: reports.append(kind),
        consensus=NPORT.Consensus(TrieCommitter(hasher=fault, device="cpu"), device="cpu"))
    if fault is launch_fault:
        with pytest.raises(LaunchError):
            dl.download(headers)
        assert (reports, dl.requeued) == ([], 0)
        return
    ref_reports = []
    ref = JBodies([MockPeer(chain24), MockPeer(chain24)], window=2,
                  reporter=lambda peer, kind: ref_reports.append(kind),
                  consensus=JConsensus(JCommitter(hasher=fault)))
    with pytest.raises(NPORT.PeerError, match="unserved"):
        dl.download(headers)
    with pytest.raises(NREF.PeerError, match="unserved"):
        ref.download(headers)
    assert reports == ref_reports == ["bad_message", "bad_message"]
    assert dl.requeued == 2


def test_full_block_client(chain24):
    fbc = NPORT.downloader.FullBlockClient
    client = fbc(MockPeer(chain24), NPORT.consensus(), **NPORT.kw)
    target = chain24.blocks[7]
    assert client.get_full_block(target.hash).hash == target.hash
    rng = client.get_full_block_range(target.hash, 4)
    assert [b.hash for b in rng] == [chain24.blocks[n].hash for n in (7, 6, 5, 4)]
    liar = MockPeer(chain24, lie_bodies=True)
    with pytest.raises(NPORT.PeerError, match="failed validation"):
        fbc(liar, NPORT.consensus(), **NPORT.kw).get_full_block(chain24.blocks[4].hash)
    assert liar.requests >= 3


def test_full_block_client_mid_list_omission_and_corrupt_body(chain24):
    fbc = NPORT.downloader.FullBlockClient

    class HolePeer(MockPeer):
        def __init__(self, bld, missing):
            super().__init__(bld)
            self.missing = missing

        def get_bodies(self, hashes):
            self.requests += 1
            return [_Body(self.by_hash[h]) for h in hashes
                    if self.by_hash[h].header.number != self.missing]

    with pytest.raises(NPORT.PeerError, match="1 bodies failed"):
        fbc(HolePeer(chain24, 4), NPORT.consensus(np=True), **NPORT.kw).get_full_block_range(
            chain24.blocks[6].hash, 5)

    class FlakyPeer(HolePeer):
        def get_bodies(self, hashes):
            if self.requests >= 2:
                self.missing = -1
            return super().get_bodies(hashes)

    rng = fbc(FlakyPeer(chain24, 4), NPORT.consensus(np=True), **NPORT.kw).get_full_block_range(
        chain24.blocks[6].hash, 5)
    assert [b.header.number for b in rng] == [6, 5, 4, 3, 2]

    class OneCorrupt(MockPeer):
        corrupted = False

        def get_bodies(self, hashes):
            self.requests += 1
            out = [_Body(self.by_hash[h]) for h in hashes]
            if not self.corrupted and len(out) >= 3:
                out[1] = _Body(self.by_number[1])
                self.corrupted = True
            return out

    rng = fbc(OneCorrupt(chain24), NPORT.consensus(np=True), **NPORT.kw).get_full_block_range(
        chain24.blocks[7].hash, 5)
    assert [b.hash for b in rng] == [chain24.blocks[n].hash for n in (7, 6, 5, 4, 3)]


# -- admin_* --------------------------------------------------------------------


def sc_admin(P):
    """nodeInfo and peers of a fixed-key manager before and after it dials a
    second one, then removePeer and a malformed addPeer; ports masked."""
    status = P.Status(network_id=1, genesis=b"\x11" * 32)
    a = P.NetworkManager(P.Factory(P.MemDb()), status, node_priv=0xAA1, **P.kw)
    b = P.NetworkManager(P.Factory(P.MemDb()), status, node_priv=0xBB2, **P.kw)
    a.start()
    b.start()
    try:
        api = P.admin.AdminApi(a, None, chain_id=1)
        info = api.admin_nodeInfo()
        assert info["enode"] == a.enode and info["ports"]["listener"] == a.port
        assert info["listenAddr"] == f"127.0.0.1:{a.port}"
        info = dict(info, enode=a.enode.rsplit(":", 1)[0], listenAddr=None,
                    ports=dict(info["ports"], listener=None))
        out = [info, api.admin_peers(), api.admin_addPeer(b.enode), api.admin_peers()]
        out.append(api.admin_removePeer(b.enode))
        out.append(api.admin_peers())
        out.append(api.admin_addPeer("enode://zz@nope"))
        return out
    finally:
        a.stop()
        b.stop()


def test_admin_namespace_over_live_managers():
    port, ref = sc_admin(NPORT), sc_admin(NREF)
    assert port[2] and port[3][0]["caps"] == ["eth/68", "eth/69", "snap/1"]
    assert port[4] and port[5] == [] and port[6] is False
    assert port == ref


@pytest.mark.parametrize("fault", [launch_fault, OSError], ids=["kernel", "other"])
def test_admin_add_peer_fault(fault):
    """A dial failure is ``false`` as in the reference; a kernel fault raises."""
    network = NPORT.NetworkManager(NPORT.Factory(NPORT.MemDb()),
                                   NPORT.Status(network_id=1, genesis=b"\x11" * 32),
                                   **NPORT.kw)

    def connect_to(enode):
        raise fault("dial failed") if fault is OSError else LaunchError("CUDA error 700")

    network.connect_to = connect_to
    api = NPORT.admin.AdminApi(network, None)
    enode = "enode://" + "00" * 64 + "@127.0.0.1:1"
    if fault is OSError:
        assert api.admin_addPeer(enode) is False
    else:
        with pytest.raises(LaunchError):
            api.admin_addPeer(enode)
