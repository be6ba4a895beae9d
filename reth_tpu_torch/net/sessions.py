"""Session manager: peer-session lifecycle, caps, and event routing.

Reference analogue: crates/net/network — `SessionManager`
(src/session/mod.rs) inside the `Swarm` (src/swarm.rs) driven by
`NetworkManager` (src/manager.rs:108). There, every connection moves
through pending-handshake → active → closed under a central manager that
enforces inbound/outbound caps, stamps sessions with identity and
counters, and publishes `SessionEvent`s the rest of the node consumes
(peer discovery feedback, metrics, tx propagation targets).

The transport here stays thread-per-peer (idiomatic Python I/O); this
layer owns the ARCHITECTURE: capacity reservation happens before the
handshake (so a flood cannot exhaust handshake resources), activation
binds the session to its RLPx identity, closure records the reason, and
every transition fans out to registered listeners.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from enum import Enum


class SessionState(Enum):
    PENDING = "pending"        # reserved; handshake in progress
    ACTIVE = "active"          # authenticated, serving requests
    CLOSED = "closed"


@dataclass
class Session:
    direction: str                      # "inbound" | "outbound"
    state: SessionState = SessionState.PENDING
    peer: object = None                 # PeerConnection once active
    node_id: bytes | None = None
    established_at: float = 0.0
    closed_at: float = 0.0
    close_reason: str | None = None
    messages_in: int = 0
    messages_out: int = 0

    @property
    def uptime(self) -> float:
        if not self.established_at:
            return 0.0  # closed before activation (failed handshake)
        end = self.closed_at or time.monotonic()
        return max(0.0, end - self.established_at)


class SessionLimitExceeded(Exception):
    """No capacity for a new session in the requested direction."""


class SessionManager:
    """Tracks every session from reservation to closure."""

    def __init__(self, max_inbound: int = 30, max_outbound: int = 100):
        self.max_inbound = max_inbound
        self.max_outbound = max_outbound
        self._lock = threading.Lock()
        self.sessions: list[Session] = []
        self.listeners: list = []       # callables(event: str, session)
        self.total_established = 0
        self.total_closed = 0

    # -- lifecycle -------------------------------------------------------------

    def reserve(self, direction: str) -> Session:
        """Claim capacity BEFORE the handshake (reference: incoming
        connections count against the cap from accept time, so a dial
        flood cannot starve the handshake path). Raises
        SessionLimitExceeded at the cap."""
        cap = self.max_inbound if direction == "inbound" else self.max_outbound
        with self._lock:
            live = sum(1 for s in self.sessions
                       if s.direction == direction
                       and s.state is not SessionState.CLOSED)
            if live >= cap:
                raise SessionLimitExceeded(
                    f"{direction} session limit {cap} reached")
            s = Session(direction=direction)
            self.sessions.append(s)
            return s

    def activate(self, session: Session, peer) -> None:
        """Handshake completed: bind identity, publish Established."""
        with self._lock:
            session.peer = peer
            session.node_id = getattr(peer, "node_id", None)
            session.state = SessionState.ACTIVE
            session.established_at = time.monotonic()
            self.total_established += 1
        self._emit("established", session)

    def close(self, session: Session, reason: str = "disconnected") -> None:
        with self._lock:
            if session.state is SessionState.CLOSED:
                return
            session.state = SessionState.CLOSED
            session.closed_at = time.monotonic()
            session.close_reason = reason
            session.peer = None  # do not pin the connection object
            self.total_closed += 1
        self._emit("closed", session)
        self.prune_closed()

    def prune_closed(self, keep: int = 256) -> None:
        """Bound the closed-session history (diagnostics window)."""
        with self._lock:
            closed = [s for s in self.sessions
                      if s.state is SessionState.CLOSED]
            if len(closed) > keep:
                doomed = set(map(id, closed[:-keep]))
                self.sessions = [s for s in self.sessions
                                 if id(s) not in doomed]

    # -- queries ---------------------------------------------------------------

    def active(self, direction: str | None = None) -> list[Session]:
        with self._lock:
            return [s for s in self.sessions
                    if s.state is SessionState.ACTIVE
                    and (direction is None or s.direction == direction)]

    def counts(self) -> dict:
        with self._lock:
            out = {"inbound": 0, "outbound": 0, "pending": 0}
            for s in self.sessions:
                if s.state is SessionState.ACTIVE:
                    out[s.direction] += 1
                elif s.state is SessionState.PENDING:
                    out["pending"] += 1
            out["established_total"] = self.total_established
            out["closed_total"] = self.total_closed
            return out

    # -- events ----------------------------------------------------------------

    def _emit(self, event: str, session: Session) -> None:
        for fn in list(self.listeners):
            try:
                fn(event, session)
            except Exception:  # noqa: BLE001 — a listener must never
                # break session management
                continue
