"""The port's discovery (net/discv4.py, discv5.py, enr.py, dnsdisc.py, nat.py)
against the JAX package's, on the CPU.

The cases of tests/test_discv4.py, test_discv5.py and test_dnsdisc.py run on
the port. Beyond them: packets, records and DNS trees encode to the
reference's bytes; a port node and a reference node bond over discv4 and
handshake over discv5 (AES-GCM and the masking CTR on the port's own AES)
and find each other; each package resolves the other's ENR tree.
"""

from __future__ import annotations

import time

import pytest

from _torch_net_pkgs import NPORT, NREF

PRIV_A = 0xEEF77ACB6C6A6EEBC5B363A475AC583EC7ECCDB42B6481424C60F59AA326547F
PRIV_B = 0x66FB62BFBD66B9177A138C1E5CDDBE4F7C30C343E94E68DF8769459CB1CDE628
TREE_KEY = 0x58D23B55BC9CDCE1F18C2500F40FF4AB411BF7437BEDBC55AF4E6289B29244AA
MIXES = pytest.mark.parametrize("A,B", [(NPORT, NPORT), (NPORT, NREF), (NREF, NPORT)],
                                ids=["port", "port-with-reference", "reference-with-port"])


def _wait(cond, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.03)
    return False


def _nid(P, priv: int) -> bytes:
    return P.secp.pubkey_to_bytes(P.pub(priv))


# -- discv4 ---------------------------------------------------------------------


def test_discv4_packet_roundtrip_equal_bytes_and_auth():
    from reth_tpu_torch.primitives.rlp import encode_int

    d = NPORT.discv4  # the packet's signature is RFC 6979: deterministic

    pkt = d.encode_packet(0x123456, 0x01, [encode_int(4), b"x"])
    assert pkt == NREF.discv4.encode_packet(0x123456, 0x01, [encode_int(4), b"x"])
    _h, node, ptype, fields = d.decode_packet(pkt)
    assert node == _nid(NPORT, 0x123456) and ptype == 0x01
    assert fields[0] == b"\x04" and fields[1] == b"x"
    bad = bytearray(pkt)
    bad[40] ^= 1
    with pytest.raises(d.DiscError):
        d.decode_packet(bytes(bad))


def test_kademlia_table_closest_matches_reference():
    got = {}
    for P in (NPORT, NREF):
        table = P.discv4.KademliaTable(_nid(P, 1))
        for i in range(2, 60):
            table.add(P.discv4.NodeRecord(_nid(P, i), "127.0.0.1", 1000 + i, 1000 + i))
        closest = table.closest(_nid(P, 5), 8)
        got[P.name] = (len(table), [r.node_id for r in closest])
    assert got["port"] == got["reference"] and len(got["port"][1]) == 8
    k = NPORT.keccak.keccak256
    target = int.from_bytes(k(_nid(NPORT, 5)), "big")
    assert got["port"][1][0] == min(got["port"][1], key=lambda n: target ^ int.from_bytes(
        k(n), "big"))


@MIXES
def test_discv4_bonding_and_discovery(A, B):
    """a and c know only the bootnode b; lookups through b let them find each
    other (a and c of package A, b of package B)."""
    nodes = [A.discv4.Discv4(0xD1, host="127.0.0.1"), B.discv4.Discv4(0xD2, host="127.0.0.1"),
             A.discv4.Discv4(0xD3, host="127.0.0.1")]
    for n in nodes:
        n.start()
    a, b, c = nodes
    try:
        a.bootstrap([b.enode()])
        c.bootstrap([b.enode()])
        assert _wait(lambda: any(r.bonded for r in a.table.by_id.values()))
        assert _wait(lambda: any(r.bonded for r in c.table.by_id.values()))
        a.lookup()
        c.lookup()
        assert _wait(lambda: c.node_id in a.table.by_id), "a never discovered c"
        assert _wait(lambda: a.node_id in c.table.by_id), "c never discovered a"
        rec = a.table.by_id[c.node_id]
        assert rec.udp_port == c.port and rec.enode().startswith("enode://")
    finally:
        for n in nodes:
            n.stop()


def test_discv4_findnode_requires_bond():
    a, b = NPORT.discv4.Discv4(0xD4, host="127.0.0.1"), NPORT.discv4.Discv4(
        0xD5, host="127.0.0.1")
    a.start()
    b.start()
    try:
        a.find_node(NPORT.discv4.NodeRecord(b.node_id, "127.0.0.1", b.port, b.port), a.node_id)
        time.sleep(0.5)
        assert b.node_id not in a.table.by_id or not a.table.by_id[b.node_id].bonded
    finally:
        a.stop()
        b.stop()


# -- ENR and discv5 -------------------------------------------------------------------


def test_compress_roundtrip():
    s = NPORT.secp
    for priv in (PRIV_A, PRIV_B, 1, 2, s.random_priv()):
        pub = s.pubkey_from_priv(priv)
        c = s.compress_pubkey(pub)
        assert len(c) == 33 and c[0] in (2, 3) and s.decompress_pubkey(c) == pub
        assert c == NREF.secp.compress_pubkey(pub)


def test_enr_roundtrip_equal_bytes_and_verify():
    e = NPORT.enr
    rec = e.make_enr(PRIV_A, ip="127.0.0.1", udp=30303, tcp=30303, seq=7)
    raw = rec.encode()
    assert raw == NREF.enr.make_enr(PRIV_A, ip="127.0.0.1", udp=30303, tcp=30303,
                                    seq=7).encode()
    back = e.Enr.decode(raw)
    assert (back.seq, back.ip, back.udp_port) == (7, "127.0.0.1", 30303)
    assert back.node_id == e.node_id_from_pubkey(NPORT.pub(PRIV_A))
    assert e.Enr.from_base64(rec.to_base64()).encode() == raw
    assert NREF.enr.Enr.from_base64(rec.to_base64()).encode() == raw
    bad = e.make_enr(PRIV_A, ip="127.0.0.1", udp=30303)
    bad.pairs["udp"] = b"\x01\x02"
    with pytest.raises(e.EnrError):
        e.Enr.decode(bad.encode())


def test_packet_mask_roundtrip_across_packages():
    """The masking AES-CTR of one package is undone by the other's."""
    for M, U in ((NPORT, NPORT), (NPORT, NREF), (NREF, NPORT)):
        dest_id = M.enr.node_id_from_pubkey(M.pub(PRIV_B))
        header = M.discv5._header(M.discv5.FLAG_ORDINARY, b"\x01" * 12, b"\xaa" * 32)
        pkt = M.discv5.mask_packet(dest_id, header, b"payload")
        _iv, flag, nonce, authdata, message = U.discv5.unmask_packet(dest_id, pkt)
        assert (flag, nonce, authdata, message) == (
            U.discv5.FLAG_ORDINARY, b"\x01" * 12, b"\xaa" * 32, b"payload")
        other = U.enr.node_id_from_pubkey(U.pub(PRIV_A))
        with pytest.raises(Exception):
            U.discv5.unmask_packet(other, pkt)


def test_session_key_agreement_both_sides():
    d, s = NPORT.discv5, NPORT.secp
    a_pub, b_pub = s.pubkey_from_priv(PRIV_A), s.pubkey_from_priv(PRIV_B)
    a_id, b_id = NPORT.enr.node_id_from_pubkey(a_pub), NPORT.enr.node_id_from_pubkey(b_pub)
    challenge = b"\x05" * 63
    eph_priv = 0x1234567
    eph_pub = s.pubkey_from_priv(eph_priv)
    ia, ra = d.derive_session_keys(challenge, eph_priv, None, None, b_pub, a_id, b_id)
    ib, rb = d.derive_session_keys(challenge, None, eph_pub, PRIV_B, None, a_id, b_id)
    assert (ia, ra) == (ib, rb) == NREF.discv5.derive_session_keys(
        challenge, eph_priv, None, None, b_pub, a_id, b_id)
    sig = d.id_sign(PRIV_A, challenge, s.compress_pubkey(eph_pub), b_id)
    assert sig == NREF.discv5.id_sign(PRIV_A, challenge, s.compress_pubkey(eph_pub), b_id)
    assert d.id_verify(a_pub, sig, challenge, s.compress_pubkey(eph_pub), b_id)
    assert not d.id_verify(b_pub, sig, challenge, s.compress_pubkey(eph_pub), b_id)
    assert not d.id_verify(a_pub, sig, b"\x06" * 63, s.compress_pubkey(eph_pub), b_id)


@MIXES
def test_discv5_handshake_and_findnode(A, B):
    """A ping from a to b runs WHOAREYOU and the handshake (AES-GCM) both ways
    across the packages; b then answers FINDNODE by distance."""
    a, b = A.discv5.Discv5(PRIV_A), B.discv5.Discv5(PRIV_B)
    a.start()
    b.start()
    try:
        c_enr = B.enr.make_enr(0xC0C0, ip="127.0.0.1", udp=9, tcp=9)
        b.table.add(c_enr)
        a.table.add(A.enr.Enr.decode(b.enr.encode()))
        a.ping(a.table.by_id[b.node_id])
        assert _wait(lambda: b.node_id in a.sessions and a.node_id in b.sessions, 5)
        assert _wait(lambda: a.node_id in b.table.by_id, 5)
        assert b.table.by_id[a.node_id].udp_port == a.port
        rec_b = a.table.by_id[b.node_id]
        d = A.discv5.RoutingTable.distance(b.node_id, c_enr.node_id)
        assert any(e.node_id == c_enr.node_id for e in a.find_node(rec_b, [d], wait=5.0))
        assert any(e.node_id == b.node_id for e in a.find_node(rec_b, [0], wait=5.0))
    finally:
        a.stop()
        b.stop()


def test_discv5_lookup_discovers_via_bootstrap():
    d = NPORT.discv5
    nodes = [d.Discv5(0x5EED + i) for i in range(4)]
    for n in nodes:
        n.start()
    try:
        boot = nodes[0]
        for n in nodes[1:]:
            n.bootstrap([boot.enr.to_base64()])
        assert _wait(lambda: all(boot.node_id in n.sessions for n in nodes[1:]), 5)
        assert _wait(lambda: len(boot.table) >= 3, 5)
        newcomer, others = nodes[1], nodes[2:]
        dists = sorted({d.RoutingTable.distance(boot.node_id, n.node_id) for n in others})
        got = newcomer.find_node(boot.enr, dists, wait=5.0)
        assert {n.node_id for n in others} <= {e.node_id for e in got}
        newcomer.lookup(rounds=1, wait=0.5)
        assert boot.node_id in newcomer.table.by_id
    finally:
        for n in nodes:
            n.stop()


# -- DNS discovery --------------------------------------------------------------


def _make_enrs(P, n, base_port=30000):
    return [P.enr.make_enr(0x1000 + base_port + i, ip="127.0.0.1", udp=base_port + i,
                           tcp=base_port + i) for i in range(n)]


def test_dns_tree_equal_records_and_resolved_across():
    """Each package builds the same signed records; each resolves the other's."""
    trees = {}
    for P in (NPORT, NREF):
        trees[P.name] = P.dnsdisc.EnrTree(TREE_KEY, seq=3).build("nodes.example.org",
                                                                 _make_enrs(P, 30))
    assert trees["port"] == trees["reference"]
    want = {e.node_id for e in _make_enrs(NPORT, 30)}
    for P, records in ((NPORT, trees["reference"]), (NREF, trees["port"])):
        got = P.dnsdisc.DnsResolver(records.get).resolve_tree(
            P.dnsdisc.link_url(P.pub(TREE_KEY), "nodes.example.org"))
        assert {e.node_id for e in got} == want


def test_dns_root_signature_verified():
    dd = NPORT.dnsdisc
    records = dd.EnrTree(TREE_KEY).build("nodes.example.org", _make_enrs(NPORT, 2))
    with pytest.raises(dd.DnsDiscError):
        dd.DnsResolver(records.get).resolve_tree(dd.link_url(NPORT.pub(0xBEEF),
                                                             "nodes.example.org"))


def test_dns_poisoned_record_skipped():
    dd = NPORT.dnsdisc
    enrs = _make_enrs(NPORT, 3)
    records = dd.EnrTree(TREE_KEY).build("nodes.example.org", enrs)
    leaf = next(k for k, v in records.items() if v.startswith("enr:") and "." in k)
    records[leaf] = enrs[0].to_base64() + "x"
    got = dd.DnsResolver(records.get).resolve_tree(dd.link_url(NPORT.pub(TREE_KEY),
                                                               "nodes.example.org"))
    assert len(got) == 2


def test_dns_linked_trees_followed_and_link_roundtrip():
    dd = NPORT.dnsdisc
    enrs_a, enrs_b = _make_enrs(NPORT, 2), _make_enrs(NPORT, 2, 31000)
    key_b = 0xB0B0
    rec_b = dd.EnrTree(key_b).build("b.example.org", enrs_b)
    rec_a = dd.EnrTree(TREE_KEY).build("a.example.org", enrs_a,
                                       links=[dd.link_url(NPORT.pub(key_b), "b.example.org")])
    table = {**rec_a, **rec_b}
    got = dd.DnsResolver(table.get).resolve_tree(dd.link_url(NPORT.pub(TREE_KEY),
                                                             "a.example.org"))
    assert {e.node_id for e in got} == {e.node_id for e in enrs_a + enrs_b}
    url = dd.link_url(NPORT.pub(TREE_KEY), "nodes.example.org")
    assert url == NREF.dnsdisc.link_url(NREF.pub(TREE_KEY), "nodes.example.org")
    assert dd.parse_link(url) == (NPORT.pub(TREE_KEY), "nodes.example.org")


def test_nat_resolution_matches_reference():
    """Parsing and the advertised address from an explicit bind host (no
    probing socket is opened)."""
    from reth_tpu.net import nat as jnat
    from reth_tpu_torch.net import nat as pnat

    def outcome(mod, spec):
        try:
            r = mod.NatResolver.parse(spec)
            return ("ok", r.strategy, r.explicit, r.fallback_reason, r.external_ip("127.0.0.1"))
        except Exception as e:  # noqa: BLE001 — the outcome is the observation
            return ("err", type(e).__name__, str(e))

    for spec in ("none", "any", "upnp", "extip:203.0.113.7", "extip:nope", "bogus"):
        assert outcome(pnat, spec) == outcome(jnat, spec), spec
