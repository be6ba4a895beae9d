"""The port's snap/1 (net/snap.py) against the JAX package's, on the CPU.

The cases of tests/test_snap.py run on the port over its encrypted testnet.
Beyond them, on one chain synced by both packages (300 genesis accounts, a
contract with 40 storage slots and its code): every codec message encodes to
the reference's bytes; the two ``SnapServer``s give equal responses, byte for
byte, to account ranges from many origins and budgets (the end of the
keyspace among them), storage ranges in windows and budgets, byte codes and
trie nodes, the port's proving on its card route on the CPU
(``SnapServer(device="cpu")``: kernel 1's plain version) and the
reference's on its numpy hasher; each range verifies in both packages; a port
client reads a reference server's ranges and the other way round.
"""

from __future__ import annotations

import dataclasses

import pytest

from _torch_net_pkgs import NPORT, NREF, synced

CODE = bytes.fromhex("6001600155")  # writes storage on every call
CONTRACT = b"\x0c" * 20
N_EXTRA, N_SLOTS = 300, 40
FULL = (b"\x00" * 32, b"\xff" * 32)


def _chain(P):
    k = P.keccak.keccak256
    extra = {k(i.to_bytes(4, "big"))[:20]: P.Account(nonce=i % 3, balance=10**15 + i)
             for i in range(N_EXTRA)}
    extra[CONTRACT] = P.Account(balance=1, code_hash=k(CODE))
    storage = {CONTRACT: {k(b"slot" + bytes([i]))[::-1]: i + 1 for i in range(N_SLOTS)}}
    return synced(P, 4, codes={k(CODE): CODE}, extra=extra, storage=storage)


@pytest.fixture(scope="module")
def nodes():
    out = {}
    for P in (NREF, NPORT):
        factory, b = _chain(P)
        server = P.snap.SnapServer(factory, **P.kw)
        out[P.name] = (factory, b, server)
    assert out["port"][1].tip.hash == out["reference"][1].tip.hash
    return out


@pytest.fixture(scope="module")
def snap_net(nodes):
    """The port's and the reference's managers serving their node, and a port
    peer of each."""
    started = {}
    for P in (NREF, NPORT):
        factory, b, _ = nodes[P.name]
        status = P.Status(network_id=1, head=b.tip.hash, genesis=b.genesis.hash)
        server = P.NetworkManager(factory, status, node_priv=0x51A9, **P.kw)
        port = server.start()
        peer = NPORT.PeerConnection.connect("127.0.0.1", port, NPORT.Status(
            network_id=1, head=b.tip.hash, genesis=b.genesis.hash), NPORT.pub(0x51A9))
        started[P.name] = (server, peer)
    yield started, nodes["port"][0], nodes["port"][1].tip.state_root
    for server, peer in started.values():
        peer.close()
        server.stop()
    for server, _ in started.values():
        assert getattr(server, "kernel_faults", 0) == 0


def test_slim_account_roundtrip():
    for P in (NPORT, NREF):
        acc = P.Account(nonce=3, balance=10**18)
        slim = P.snap.slim_account(acc)
        back = P.snap.unslim_account(slim)
        assert (back.nonce, back.balance) == (3, 10**18)
        assert (back.storage_root, back.code_hash) == (acc.storage_root, acc.code_hash)
    assert NPORT.snap.slim_account(NPORT.Account(nonce=3, balance=10**18)) == \
        NREF.snap.slim_account(NREF.Account(nonce=3, balance=10**18))


def _codec_msgs(P):
    s = P.snap
    return [
        s.GetAccountRange(1, b"\x01" * 32, b"\x00" * 32, b"\xff" * 32, 1000),
        s.AccountRange(1, [(b"\x02" * 32, b"\x80")], [b"proofnode"]),
        s.GetStorageRanges(2, b"\x01" * 32, [b"\x03" * 32], b"", b"", 500),
        s.StorageRanges(2, [[(b"\x04" * 32, b"\x05")]], []),
        s.GetByteCodes(3, [b"\x06" * 32], 100),
        s.ByteCodes(3, [b"\x60\x01"]),
        s.GetTrieNodes(4, b"\x01" * 32, [[b"\x07"], [b"\x08", b"\x09"]], 50),
        s.TrieNodes(4, [b"node"]),
    ]


def test_snap_codec_roundtrips_to_equal_bytes():
    for pm, rm in zip(_codec_msgs(NPORT), _codec_msgs(NREF)):
        mid, payload = NPORT.snap.encode_snap(pm)
        assert (mid, payload) == NREF.snap.encode_snap(rm), type(pm).__name__
        assert NPORT.snap.decode_snap(mid, payload) == pm
        assert NREF.snap.decode_snap(mid, payload) == rm


def _key(n: int) -> bytes:
    return n.to_bytes(32, "big")


def sc_serve(P, node):
    """Every kind of snap request to P's server: the responses' bytes."""
    factory, b, server = node
    s, k = P.snap, P.keccak.keccak256
    root = b.tip.state_root
    with factory.provider() as p:
        keys = [kk for kk, _ in p.tx.cursor("HashedAccounts").walk()]
        code_hash = p.account(CONTRACT).code_hash
    out = []
    origins = [b"\x00" * 32, _key(1 << 255), keys[len(keys) // 3], keys[-1],
               _key(int.from_bytes(keys[-1], "big") + 1)]
    for i, origin in enumerate(origins):
        for budget in (1, 1 << 20):
            out.append(server.account_range(s.GetAccountRange(i, root, origin, FULL[1],
                                                              budget)))
    out.append(server.account_range(s.GetAccountRange(9, root, keys[5], keys[40], 1 << 20)))
    out.append(server.account_range(s.GetAccountRange(9, b"\x77" * 32, *FULL, 1 << 20)))
    ha = k(CONTRACT)
    with factory.provider() as p:
        slots = [v[:32] for _, v in p.tx.cursor("HashedStorages").walk(ha)][:N_SLOTS]
    for origin, limit, budget in ((b"", b"", 1 << 20), (b"", b"", 300),
                                  (slots[7], slots[30], 1 << 20), (slots[7], b"", 100)):
        out.append(server.storage_ranges(s.GetStorageRanges(3, root, [ha, keys[0]], origin,
                                                            limit, budget)))
    out.append(server.storage_ranges(s.GetStorageRanges(3, root, [keys[1], ha], b"", b"",
                                                        1 << 20)))
    out.append(server.byte_codes(s.GetByteCodes(4, [code_hash, b"\x01" * 32, code_hash],
                                                1 << 20)))
    out.append(server.trie_nodes(s.GetTrieNodes(5, root, [[b""], [b"\x12"], [ha, b"",
                                                                             b"\x30"]],
                                                1 << 20)))
    checks = [s.verify_account_range(root, origins[i // 2], r)
              for i, r in enumerate(out[:10])]
    return [s.encode_snap(r) for r in out], checks


def test_snap_servers_answer_equal(nodes):
    """The port's server (its card route on the CPU) answers every request with
    the reference's bytes; every range verifies in both packages."""
    port, port_checks = sc_serve(NPORT, nodes["port"])
    ref, ref_checks = sc_serve(NREF, nodes["reference"])
    assert len(port) == len(ref)
    for i, (pm, rm) in enumerate(zip(port, ref)):
        assert pm == rm, f"response {i} differs"
    assert port_checks == ref_checks and all(port_checks)


def test_account_range_with_proofs(snap_net):
    started, factory, root = snap_net
    peer = started["port"][1]
    assert peer.snap_enabled
    rng = peer.get_account_range(root, *FULL)
    keys = [h for h, _ in rng.accounts]
    assert len(keys) >= N_EXTRA and keys == sorted(keys) and rng.proof
    assert NPORT.snap.verify_account_range(root, b"\x00" * 32, rng)
    stale = peer.get_account_range(b"\x77" * 32, *FULL)
    assert stale.accounts == [] and stale.proof == []
    tampered = NPORT.snap.AccountRange(rng.request_id, rng.accounts[:-1] + [
        (rng.accounts[-1][0], NPORT.snap.slim_account(NPORT.Account(balance=7)))], rng.proof)
    assert not NPORT.snap.verify_account_range(root, b"\x00" * 32, tampered)
    assert not NREF.snap.verify_account_range(root, b"\x00" * 32, tampered)


def test_account_range_pagination(snap_net):
    started, factory, root = snap_net
    peer = started["port"][1]
    first = peer.get_account_range(root, *FULL, response_bytes=1)
    assert len(first.accounts) == 1
    last = first.accounts[-1][0]
    nxt = peer.get_account_range(root, _key(int.from_bytes(last, "big") + 1), FULL[1],
                                 response_bytes=2000)
    assert nxt.accounts and nxt.accounts[0][0] > last
    assert NPORT.snap.verify_account_range(root, _key(int.from_bytes(last, "big") + 1), nxt)


def test_storage_ranges_and_bytecodes(snap_net):
    started, factory, root = snap_net
    peer = started["port"][1]
    ha = NPORT.keccak.keccak256(CONTRACT)
    with factory.provider() as p:
        acc = p.account(CONTRACT)
    rng = peer.get_storage_ranges(root, [ha])
    assert len(rng.slots) == 1 and len(rng.slots[0]) == N_SLOTS
    codes = peer.get_byte_codes([acc.code_hash])
    assert codes.codes == [CODE] and NPORT.keccak.keccak256(codes.codes[0]) == acc.code_hash


def test_trie_nodes_healing(snap_net):
    started, factory, root = snap_net
    nodes = started["port"][1].get_trie_nodes(root, [[b""]])
    assert nodes.nodes and NPORT.keccak.keccak256(nodes.nodes[0]) == root


def test_port_client_reads_both_servers_alike(snap_net):
    """The same requests over the wire to the reference's and the port's
    server: equal responses."""
    started, factory, root = snap_net
    ha = NPORT.keccak.keccak256(CONTRACT)
    got = {}
    for name, (_, peer) in started.items():
        got[name] = [peer.get_account_range(root, _key(3 << 252), FULL[1],
                                            response_bytes=4000),
                     peer.get_storage_ranges(root, [ha]), peer.get_trie_nodes(root, [[b"\x05"]])]
    assert got["port"][0].accounts and got["port"][1].slots[0] and got["port"][2].nodes
    for pm, rm in zip(got["port"], got["reference"]):  # the peers' request ids differ
        assert NPORT.snap.encode_snap(dataclasses.replace(pm, request_id=0)) == \
            NPORT.snap.encode_snap(dataclasses.replace(rm, request_id=0))
