"""Single-event-loop peer swarm.

Reference analogue: `NetworkManager`'s polled `Swarm`
(crates/net/network/src/manager.rs:108, src/swarm.rs) — ONE task polls
the listener and every established session; per-session work never owns
a thread. Here: one `selectors` loop thread owns the accept socket and
every established inbound session's socket. Handshakes (ECIES + hello +
status: multi-round, blocking, attacker-paced) run on short-lived
threads bounded by the SessionManager's pending-capacity reservation,
then hand the established socket to the loop. Steady state is ONE
thread regardless of peer count.

Sends from any thread (request responses, broadcasts) encrypt under the
peer's lock into a bounded per-peer outbox; the loop flushes outboxes on
socket writability and a self-pipe wakes it for cross-thread enqueues.
A peer whose outbox overflows is disconnected — backpressure by
eviction, like the reference's session command channels.

A copy of the JAX package's ``net/swarm.py``. Serving a request can launch
kernel 1 (snap range proofs): a kernel fault there drops the peer as any
other serving error does, and is kept on the manager
(``NetworkManager.keep_fault``), whose ``stop()`` raises it.
"""

from __future__ import annotations

import selectors
import socket
import threading

from ..ops._build import is_kernel_fault

MAX_OUTBOX = 4 * 1024 * 1024  # per-peer pending egress cap
RECV_CHUNK = 1 << 16


class Swarm:
    def __init__(self, manager, listener: socket.socket):
        self.manager = manager
        self.listener = listener
        self.selector = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        # the writer must NEVER block: wake() runs under peer._lock, and
        # a blocked wake deadlocks against the loop's outbox flush
        self._wake_w.setblocking(False)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._peers: dict[int, object] = {}  # fd -> PeerConnection
        self._lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        self.listener.setblocking(False)
        self.selector.register(self.listener, selectors.EVENT_READ, "accept")
        self.selector.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="net-swarm")
        self._thread.start()

    def stop(self):
        self._stop.set()
        self.wake()
        if self._thread is not None:
            self._thread.join(timeout=5)
        try:
            self.selector.close()
        except OSError:
            pass
        self._wake_r.close()
        self._wake_w.close()

    def wake(self):
        try:
            self._wake_w.send(b"\x00")
        except (BlockingIOError, OSError):
            pass  # pipe full = a wakeup is already pending

    # -- peer registration -------------------------------------------------

    def register_peer(self, peer) -> None:
        """Adopt an ESTABLISHED session into the loop (called from the
        transient handshake thread)."""
        sock = peer.session.sock
        sock.setblocking(False)
        outbox = bytearray()
        peer._swarm_outbox = outbox

        def sink(data, peer=peer, outbox=outbox):
            # runs under peer._lock (send_frame callers hold it): encrypt
            # order == outbox order
            if len(outbox) + len(data) > MAX_OUTBOX:
                peer._swarm_overflow = True
            else:
                outbox += data
            self.wake()

        peer.session._send_sink = sink
        peer._swarm_overflow = False
        peer._swarm_fd = sock.fileno()
        with self._lock:
            self._peers[peer._swarm_fd] = peer
        self.selector.register(sock, selectors.EVENT_READ, "peer")
        self.wake()

    def _drop_peer(self, peer, reason: str, penalize: bool = False):
        m = self.manager
        sock = peer.session.sock
        try:
            self.selector.unregister(sock)
        except (KeyError, ValueError, OSError):
            pass
        with self._lock:
            self._peers.pop(peer._swarm_fd, None)
        if penalize:
            m.peers_manager.reputation_change(peer.node_id, "bad_message")
        slot = getattr(peer, "_session_slot", None)
        if slot is not None:
            m.sessions.close(slot, reason)
        peer.close()
        try:
            m.peers.remove(peer)
        except ValueError:
            pass

    # -- the loop ----------------------------------------------------------

    def _loop(self):
        from .p2p import PeerDisconnected, PeerError

        while not self._stop.is_set():
            try:
                events = self.selector.select(timeout=0.5)
            except OSError:
                return
            for key, mask in events:
                if key.data == "accept":
                    self._accept()
                    continue
                if key.data == "wake":
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                    continue
                peer = self._peers.get(key.fd)
                if peer is None:
                    try:
                        self.selector.unregister(key.fileobj)
                    except (KeyError, ValueError, OSError):
                        pass
                    continue
                if mask & selectors.EVENT_READ:
                    self._readable(peer)
            # flush every pending outbox (sends are small; a full socket
            # buffer leaves the remainder for the next pass)
            self._flush_outboxes()

    def _accept(self):
        from .sessions import SessionLimitExceeded

        while True:
            try:
                sock, _addr = self.listener.accept()
            except (BlockingIOError, OSError):
                return
            try:
                slot = self.manager.sessions.reserve("inbound")
            except SessionLimitExceeded:
                sock.close()  # at capacity: refuse BEFORE any handshake
                continue
            # the handshake is multi-round and attacker-paced: run it on a
            # transient thread (bounded by the session reservation), then
            # adopt the established session into the loop
            threading.Thread(target=self._handshake, args=(sock, slot),
                             daemon=True).start()

    def _handshake(self, sock: socket.socket, slot):
        from .p2p import PeerConnection

        m = self.manager
        sock.setblocking(True)
        sock.settimeout(15)
        try:
            peer = PeerConnection.accept(sock, m.status, m.node_priv,
                                         fork_filter=m._fork_filter)
        except Exception:  # noqa: BLE001 — handshake parses attacker-
            # controlled bytes; ANY failure must drop the peer only
            m.sessions.close(slot, "handshake failed")
            sock.close()
            return
        if m.peers_manager.is_banned(peer.node_id):
            m.sessions.close(slot, "banned")
            peer.session.disconnect(0x05)
            peer.close()
            return
        sock.settimeout(None)
        m.sessions.activate(slot, peer)
        peer._session_slot = slot
        peer._swarm_fd = sock.fileno()
        m.peers.append(peer)
        self.register_peer(peer)

    def _readable(self, peer):
        from .p2p import PeerDisconnected, PeerError

        m = self.manager
        try:
            data = peer.session.sock.recv(RECV_CHUNK)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._drop_peer(peer, "stream error")
            return
        if not data:
            self._drop_peer(peer, "disconnected")
            return
        slot = getattr(peer, "_session_slot", None)
        try:
            msgs = peer.feed(data)
        except PeerDisconnected:
            self._drop_peer(peer, "disconnected")
            return
        except PeerError:
            self._drop_peer(peer, "protocol violation", penalize=True)
            return
        except Exception:  # noqa: BLE001 — malformed frame: drop the peer
            self._drop_peer(peer, "stream error")
            return
        for msg in msgs:
            if slot is not None:
                slot.messages_in += 1
            try:
                m._handle(peer, msg)
            except PeerError:
                self._drop_peer(peer, "protocol violation", penalize=True)
                return
            except Exception as e:  # noqa: BLE001 — serving must not kill the loop
                if is_kernel_fault(e):
                    m.keep_fault(e)
                self._drop_peer(peer, "stream error")
                return
        if getattr(peer, "_swarm_overflow", False):
            self._drop_peer(peer, "send backpressure")

    def _set_write_interest(self, peer, on: bool):
        events = selectors.EVENT_READ | (selectors.EVENT_WRITE if on else 0)
        try:
            self.selector.modify(peer.session.sock, events, "peer")
        except (KeyError, ValueError, OSError):
            pass

    def _flush_outboxes(self):
        with self._lock:
            peers = list(self._peers.values())
        for peer in peers:
            # an overflowed egress stream is DESYNCED (a frame was dropped
            # after the CTR/MAC state advanced): evict unconditionally
            if getattr(peer, "_swarm_overflow", False):
                self._drop_peer(peer, "send backpressure")
                continue
            outbox = getattr(peer, "_swarm_outbox", None)
            if not outbox:
                continue
            drop_reason = None
            with peer._lock:
                try:
                    mv = memoryview(outbox)
                    sent = peer.session.sock.send(mv)
                    mv.release()
                    del outbox[:sent]
                except (BlockingIOError, InterruptedError):
                    pass
                except OSError:
                    drop_reason = "stream error"
            if drop_reason:
                self._drop_peer(peer, drop_reason)
            else:
                # a pending remainder wakes the loop the moment the socket
                # drains (true flush-on-writability, not timeout polling)
                self._set_write_interest(peer, bool(outbox))
