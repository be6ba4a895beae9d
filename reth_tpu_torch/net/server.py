"""NetworkManager: listen, serve eth requests, track peers.

A copy of the JAX package's ``net/server.py``. The snap/1 server it builds
proves ranges on ``TrieCommitter(device=device)``, kernel 1 on the card
unless ``device="cpu"``. A kernel fault while serving a peer drops that peer
as any other serving error does, and is kept here (``kernel_fault``, the
first; ``kernel_faults``, the count) and raised again by ``stop()``.

Reference analogue: crates/net/network — `NetworkManager`
(src/manager.rs:108) + `EthRequestHandler` serving headers/bodies/
receipts from the provider (src/eth_requests.rs), and tx broadcast
hooks (src/transactions/). Inbound sessions are served by the ONE
event-loop swarm thread (`net/swarm.py`, reference src/swarm.rs);
handshakes run on transient threads only.
"""

from __future__ import annotations

import socket
import threading

from ..primitives.secp256k1 import pubkey_from_bytes
from . import wire
from .p2p import PeerConnection, PeerDisconnected, PeerError, random_node_key
from .rlpx import node_id as rlpx_node_id
from .wire import Status

MAX_HEADERS_SERVE = 1024
MAX_BODIES_SERVE = 256


def parse_enode(url: str) -> tuple[tuple[int, int], str, int]:
    """enode://<128-hex node id>@host:port -> (pubkey, host, port)."""
    if not url.startswith("enode://"):
        raise ValueError("not an enode url")
    ident, _, addr = url[8:].partition("@")
    host, _, port = addr.partition(":")
    return pubkey_from_bytes(bytes.fromhex(ident)), host, int(port or "30303")


class NetworkManager:
    def __init__(self, factory, status: Status, pool=None, host: str = "127.0.0.1",
                 port: int = 0, node_priv: int | None = None,
                 chain_spec=None, head_position: tuple[int, int] = (0, 0),
                 max_inbound: int = 30, max_outbound: int = 100,
                 provider_fn=None, device="cuda"):
        self.factory = factory
        self.device = device
        # kernel faults met while serving (net/swarm.py): the first is
        # raised again by stop()
        self.kernel_faults = 0
        self.kernel_fault: BaseException | None = None
        self._fault_lock = threading.Lock()
        # request serving reads THIS view: a node passes its engine-tree
        # overlay provider so peers can fetch the announced in-memory tip
        # (blocks above the persistence threshold live in the tree, not
        # the DB — serving only persisted state would advertise a head
        # nobody can download)
        self._provider_fn = provider_fn or factory.provider
        self.status = status
        self.pool = pool
        self.host = host
        self.advertised_host: str | None = None  # NAT-resolved external IP
        self.port = port
        self.node_priv = node_priv or random_node_key()
        # EIP-2124 ForkFilter: reject peers on an incompatible fork during
        # the Status handshake (reference: alloy ForkFilter used by
        # crates/net/network session setup)
        self.chain_spec = chain_spec
        self.head_position = head_position
        self.peers: list[PeerConnection] = []
        from .reputation import PeersManager
        from .sessions import SessionManager

        self.peers_manager = PeersManager()
        # session lifecycle + caps + events (reference SessionManager in
        # the Swarm, src/session/mod.rs): capacity reserves BEFORE the
        # handshake, transitions fan out to listeners
        self.sessions = SessionManager(max_inbound=max_inbound,
                                       max_outbound=max_outbound)
        self._listener: socket.socket | None = None
        self._stop = threading.Event()

    def _snap_server(self):
        if getattr(self, "_snap", None) is None:
            from .snap import SnapServer

            self._snap = SnapServer(self.factory, device=self.device)
        return self._snap

    def _fork_filter(self, remote_fork_id: tuple[bytes, int]) -> None:
        if self.chain_spec is not None:
            self.chain_spec.validate_fork_id(remote_fork_id, *self.head_position)

    @property
    def enode(self) -> str:
        host = self.advertised_host or self.host
        return (f"enode://{rlpx_node_id(self.node_priv).hex()}"
                f"@{host}:{self.port}")

    def connect_to(self, enode_url: str, timeout: float = 10.0) -> PeerConnection:
        """Dial a peer by enode URL (encrypted RLPx session)."""
        pub, host, port = parse_enode(enode_url)
        from ..primitives.secp256k1 import pubkey_to_bytes

        if self.peers_manager.is_banned(pubkey_to_bytes(pub)):
            raise PeerError("peer is banned")
        session = self.sessions.reserve("outbound")
        try:
            peer = PeerConnection.connect(host, port, self.status, pub,
                                          node_priv=self.node_priv,
                                          timeout=timeout,
                                          fork_filter=self._fork_filter)
        except BaseException:
            self.sessions.close(session, "handshake failed")
            raise
        self.sessions.activate(session, peer)
        peer._session_slot = session
        # outbound peers have no serve loop here: closing the connection
        # must release the session slot AND drop the peer from the live
        # list (discovery dedup + broadcasts iterate it)
        def _closed(peer=peer, session=session):
            self.sessions.close(session, "closed")
            try:
                self.peers.remove(peer)
            except ValueError:
                pass

        peer._on_close = (_closed,)
        self.peers.append(peer)
        return peer

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> int:
        from .swarm import Swarm

        self._listener = socket.create_server((self.host, self.port))
        self.port = self._listener.getsockname()[1]
        # ONE event loop owns the listener and every established inbound
        # session (reference swarm, src/swarm.rs); handshakes run on
        # transient threads only
        self.swarm = Swarm(self, self._listener)
        self.swarm.start()
        return self.port

    def keep_fault(self, err: BaseException) -> None:
        """Count a kernel fault met while serving; keep the first."""
        with self._fault_lock:
            self.kernel_faults += 1
            if self.kernel_fault is None:
                self.kernel_fault = err

    def stop(self):
        """Stop serving; raise the first kernel fault met while serving."""
        self._stop.set()
        if getattr(self, "swarm", None) is not None:
            self.swarm.stop()
        if self._listener:
            self._listener.close()
        for p in list(self.peers):  # close releases session slots
            p.close()
        if self.kernel_fault is not None:
            raise self.kernel_fault

    def _handle(self, peer: PeerConnection, msg):
        from . import snap as snap_mod

        if isinstance(msg, snap_mod.GetAccountRange):
            peer.send_snap(self._snap_server().account_range(msg))
            return
        if isinstance(msg, snap_mod.GetStorageRanges):
            peer.send_snap(self._snap_server().storage_ranges(msg))
            return
        if isinstance(msg, snap_mod.GetByteCodes):
            peer.send_snap(self._snap_server().byte_codes(msg))
            return
        if isinstance(msg, snap_mod.GetTrieNodes):
            peer.send_snap(self._snap_server().trie_nodes(msg))
            return
        if isinstance(msg, wire.GetBlockHeaders):
            peer.send(wire.BlockHeaders(msg.request_id, self._headers_for(msg)))
        elif isinstance(msg, wire.GetBlockBodies):
            peer.send(wire.BlockBodies(msg.request_id, self._bodies_for(msg.hashes)))
        elif isinstance(msg, wire.GetReceipts):
            peer.send(wire.ReceiptsMsg(msg.request_id, self._receipts_for(msg.hashes)))
        elif isinstance(msg, wire.BlockRangeUpdate):
            peer.block_range = (msg.earliest, msg.latest, msg.latest_hash)
        elif isinstance(msg, wire.TransactionsMsg) and self.pool is not None:
            from ..pool import PoolError

            for tx in msg.transactions:
                try:
                    self.pool.add_transaction(tx)
                except PoolError:
                    pass
        # other gossip ignored for now

    def _headers_for(self, req: wire.GetBlockHeaders):
        with self._provider_fn() as p:
            if isinstance(req.start, bytes):
                start = p.block_number(req.start)
                if start is None:
                    return []
            else:
                start = req.start
            step = -(1 + req.skip) if req.reverse else (1 + req.skip)
            out = []
            n = start
            for _ in range(min(req.limit, MAX_HEADERS_SERVE)):
                h = p.header_by_number(n)
                if h is None:
                    break
                out.append(h)
                n += step
                if n < 0:
                    break
            return out

    def _bodies_for(self, hashes):
        from .wire import BlockBody

        out = []
        with self._provider_fn() as p:
            for h in hashes[:MAX_BODIES_SERVE]:
                n = p.block_number(h)
                if n is None:
                    continue
                block = p.block_by_number(n)
                out.append(BlockBody(block.transactions, block.ommers, block.withdrawals))
        return out

    def _receipts_for(self, hashes):
        from ..storage import tables as T

        out = []
        with self._provider_fn() as p:
            for h in hashes[:MAX_BODIES_SERVE]:
                n = p.block_number(h)
                if n is None:
                    continue
                idx = p.block_body_indices(n)
                rs = []
                if idx:
                    for t in range(idx.first_tx_num, idx.next_tx_num):
                        r = p.receipt(t)
                        if r is not None:
                            rs.append(T.encode_receipt(r))
                out.append(rs)
        return out

    # -- broadcast -------------------------------------------------------------

    def broadcast_transactions(self, txs):
        for peer in list(self.peers):
            try:
                peer.send(wire.TransactionsMsg(list(txs)))
            except (PeerError, OSError):
                pass

    def announce_block_range(self, earliest: int, latest: int,
                             latest_hash: bytes):
        """eth/69 BlockRangeUpdate to every v69 peer (replaces TD gossip)."""
        for peer in list(self.peers):
            if peer.eth_version < 69:
                continue
            try:
                peer.send(wire.BlockRangeUpdate(earliest, latest, latest_hash))
            except (PeerError, OSError):
                pass
