"""Peer sessions: RLPx-encrypted transport + status handshake + requests.

Reference analogue: crates/net/network session machinery
(src/session/mod.rs) over crates/net/ecies + eth-wire: every session runs
the ECIES auth/ack handshake, the p2p Hello (snappy from v5), then the
eth/68 Status exchange before any request traffic. Request/response
correlation uses eth/66-style request ids.
"""

from __future__ import annotations

import itertools
import socket
import threading

from ..primitives.secp256k1 import random_priv as random_node_key
from . import rlpx, wire
from .rlpx import BASE_PROTOCOL_OFFSET, DISCONNECT_ID, PING_ID, PONG_ID, RlpxSession
from .wire import Status

CLIENT_ID = "reth-tpu/0.2"
ETH_CAPS = [("eth", 68), ("eth", 69), ("snap", 1)]
# capability message-id spaces are assigned alphabetically after the base
# protocol; the NEGOTIATED eth version sets the span (eth/68: 17 ids,
# eth/69 adds BlockRangeUpdate: 18), snap/1 follows (devp2p rule) —
# always use the per-session `PeerConnection.snap_offset`
ETH_MSG_COUNT = {68: 17, 69: 18}


def _negotiate_eth(caps) -> int | None:
    """Highest shared eth version (devp2p: advertise all, shared max wins)."""
    ours = {v for name, v in ETH_CAPS if name == "eth"}
    shared = [v for name, v in caps if name == "eth" and v in ours]
    return max(shared) if shared else None


class PeerError(Exception):
    pass


class PeerDisconnected(PeerError):
    """Graceful devp2p Disconnect — not a protocol violation."""


class PeerConnection:
    """One established encrypted peer session (RLPx + Hello + Status)."""

    def __init__(self, session: RlpxSession, status: Status):
        self.session = session
        self.status = status  # the REMOTE peer's status
        caps = (session.remote_hello or {}).get("caps", [])
        self.eth_version = _negotiate_eth(caps)
        self.snap_enabled = any(name == "snap" and v >= 1 for name, v in caps)
        self.snap_offset = (BASE_PROTOCOL_OFFSET
                            + ETH_MSG_COUNT.get(self.eth_version, 17))
        self.block_range: tuple[int, int, bytes] | None = None  # eth/69
        self._req_ids = itertools.count(1)
        self._lock = threading.Lock()
        # unsolicited gossip received while awaiting a response (drained by
        # the owner; bounded so a chatty peer cannot balloon memory)
        self.gossip: list = []
        self.MAX_GOSSIP_BUFFER = 1024

    @property
    def node_id(self) -> bytes:
        return self.session.remote_node_id

    # -- message transport ------------------------------------------------------

    def send(self, msg) -> None:
        mid, payload = wire.encode_eth(msg)
        with self._lock:
            self.session.send_msg(BASE_PROTOCOL_OFFSET + mid, payload)

    def send_snap(self, msg) -> None:
        from . import snap as snap_mod

        mid, payload = snap_mod.encode_snap(msg)
        with self._lock:
            self.session.send_msg(self.snap_offset + mid, payload)

    def _dispatch(self, mid: int, body: bytes):
        """One (mid, body) -> decoded message, or None when it was a p2p
        housekeeping frame handled inline (ping/pong)."""
        if self.snap_enabled and mid >= self.snap_offset:
            from . import snap as snap_mod

            return snap_mod.decode_snap(mid - self.snap_offset, body)
        if mid >= BASE_PROTOCOL_OFFSET:
            return wire.decode_eth(mid - BASE_PROTOCOL_OFFSET, body)
        if mid == PING_ID:
            with self._lock:
                self.session.send_msg(PONG_ID, b"\xc0")
            return None
        if mid == PONG_ID:
            return None
        if mid == DISCONNECT_ID:
            raise PeerDisconnected("peer disconnected")
        raise PeerError(f"unexpected p2p message {mid:#x}")

    def recv(self):
        """Next eth/snap message; p2p pings are answered inline, disconnects
        surface as PeerError."""
        while True:
            mid, body = self.session.recv_msg()
            msg = self._dispatch(mid, body)
            if msg is not None:
                return msg

    def feed(self, data: bytes) -> list:
        """Swarm receive path: buffered ciphertext in, decoded messages
        out (non-blocking; p2p housekeeping handled inline)."""
        msgs = []
        for frame in self.session.feed_frames(data):
            msg = self._dispatch(*self.session.parse_frame(frame))
            if msg is not None:
                msgs.append(msg)
        return msgs

    # -- handshake -------------------------------------------------------------

    @classmethod
    def _finish_handshake(cls, session: RlpxSession, node_priv: int,
                          our_status: Status, fork_filter=None) -> "PeerConnection":
        session.hello(node_priv, CLIENT_ID, ETH_CAPS)
        version = _negotiate_eth(session.remote_hello["caps"])
        if version is None:
            session.disconnect()
            raise PeerError("peer lacks eth/68 capability")
        import dataclasses

        our_status = dataclasses.replace(our_status, version=version)
        mid, payload = wire.encode_eth(our_status)
        session.send_msg(BASE_PROTOCOL_OFFSET + mid, payload)
        rmid, rbody = session.recv_msg()
        if rmid != BASE_PROTOCOL_OFFSET + wire.MessageId.STATUS:
            session.disconnect()
            raise PeerError("expected status handshake")
        remote = wire.decode_eth(wire.MessageId.STATUS, rbody)
        try:
            if remote.version != version:
                # message-id spaces derive from the negotiated version: a
                # mismatched Status would silently desync the multiplexing
                raise PeerError(
                    f"status version {remote.version} != negotiated {version}")
            _validate_status(our_status, remote, fork_filter)
        except PeerError:
            session.disconnect()
            raise
        return cls(session, remote)

    @classmethod
    def connect(cls, host: str, port: int, our_status: Status,
                remote_pub: tuple[int, int], node_priv: int | None = None,
                timeout: float = 10.0, fork_filter=None) -> "PeerConnection":
        """Dial a peer (its public key comes from discovery / the enode)."""
        key = node_priv or random_node_key()
        sock = socket.create_connection((host, port), timeout=timeout)
        try:
            session = rlpx.initiate(sock, key, remote_pub)
            return cls._finish_handshake(session, key, our_status, fork_filter)
        except Exception:
            sock.close()
            raise

    @classmethod
    def accept(cls, sock: socket.socket, our_status: Status,
               node_priv: int, fork_filter=None) -> "PeerConnection":
        session = rlpx.respond(sock, node_priv)
        return cls._finish_handshake(session, node_priv, our_status, fork_filter)

    # -- typed requests (HeadersClient / BodiesClient analogues) ---------------

    def _await_response(self, kind, rid: int, max_frames: int = 256):
        """Receive until the matching (type, request_id) response arrives;
        interleaved gossip is buffered, not treated as a protocol error."""
        for _ in range(max_frames):
            msg = self.recv()
            if isinstance(msg, kind) and msg.request_id == rid:
                return msg
            if isinstance(msg, wire.BlockRangeUpdate):
                self.block_range = (msg.earliest, msg.latest, msg.latest_hash)
                continue
            if isinstance(msg, (wire.TransactionsMsg, wire.NewPooledTxHashes,
                                wire.NewBlockHashes)):
                if len(self.gossip) < self.MAX_GOSSIP_BUFFER:
                    self.gossip.append(msg)
                continue
            raise PeerError(f"unexpected {type(msg).__name__} awaiting {kind.__name__}")
        raise PeerError("response never arrived")

    def get_headers(self, start, limit: int, reverse: bool = False,
                    skip: int = 0) -> list:
        rid = next(self._req_ids)
        self.send(wire.GetBlockHeaders(rid, start, limit, skip, reverse))
        return self._await_response(wire.BlockHeaders, rid).headers

    def get_bodies(self, hashes: list[bytes]) -> list:
        rid = next(self._req_ids)
        self.send(wire.GetBlockBodies(rid, hashes))
        return self._await_response(wire.BlockBodies, rid).bodies

    def get_receipts(self, hashes: list[bytes]) -> list[list[bytes]]:
        rid = next(self._req_ids)
        self.send(wire.GetReceipts(rid, hashes))
        return self._await_response(wire.ReceiptsMsg, rid).receipts

    # -- snap/1 requests (state-range client) ----------------------------------

    def _snap_request(self, req, resp_cls):
        if not self.snap_enabled:
            raise PeerError("peer does not support snap/1")
        self.send_snap(req)
        return self._await_response(resp_cls, req.request_id)

    def get_account_range(self, root: bytes, origin: bytes, limit: bytes,
                          response_bytes: int | None = None):
        from . import snap as s

        req = s.GetAccountRange(next(self._req_ids), root, origin, limit,
                                response_bytes or s.SOFT_RESPONSE_LIMIT)
        return self._snap_request(req, s.AccountRange)

    def get_storage_ranges(self, root: bytes, account_hashes: list[bytes],
                           origin: bytes = b"", limit: bytes = b""):
        from . import snap as s

        req = s.GetStorageRanges(next(self._req_ids), root, account_hashes,
                                 origin, limit)
        return self._snap_request(req, s.StorageRanges)

    def get_byte_codes(self, hashes: list[bytes]):
        from . import snap as s

        return self._snap_request(
            s.GetByteCodes(next(self._req_ids), hashes), s.ByteCodes)

    def get_trie_nodes(self, root: bytes, paths: list[list[bytes]]):
        from . import snap as s

        return self._snap_request(
            s.GetTrieNodes(next(self._req_ids), root, paths), s.TrieNodes)

    def close(self):
        self.session.close()
        for fn in getattr(self, "_on_close", ()):
            try:
                fn()
            except Exception:  # noqa: BLE001 — bookkeeping must not
                # block socket teardown
                pass
        self._on_close = ()


def _validate_status(ours: Status, theirs: Status, fork_filter=None) -> None:
    if theirs.network_id != ours.network_id:
        raise PeerError(f"network id mismatch: {theirs.network_id}")
    if theirs.genesis != ours.genesis:
        raise PeerError("genesis mismatch")
    if fork_filter is not None:
        # EIP-2124: reject peers whose fork history is incompatible
        try:
            fork_filter(theirs.fork_id)
        except ValueError as e:
            raise PeerError(f"incompatible fork id: {e}") from None
