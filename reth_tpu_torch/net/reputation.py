"""Peer reputation + ban list.

Reference analogue: the reputation weights and ban handling in
crates/net/network/src/peers.rs + crates/net/banlist. Every peer carries
a score; protocol violations apply weighted penalties, and crossing the
ban threshold drops the session and refuses reconnects until the ban
expires. Scores decay back toward zero so transient flakiness heals.
"""

from __future__ import annotations

import time

BANNED_REPUTATION = -50_00
DEFAULT_BAN_SECONDS = 30 * 60

# penalty weights (shape mirrors the reference's ReputationChangeKind)
REPUTATION_CHANGE = {
    "bad_message": -16_00,       # undecodable / protocol-violating message
    "bad_block": -25_00,         # invalid block or header chain
    "bad_transactions": -8_00,
    "timeout": -4_00,
    "failed_to_connect": -2_00,
    "dropped": -1_00,
    "good": 5_00,                # useful response
}

_DECAY_PER_SECOND = 10  # points recovered per second toward zero


class PeerRecord:
    __slots__ = ("reputation", "banned_until", "_last")

    def __init__(self):
        self.reputation = 0
        self.banned_until = 0.0
        self._last = time.monotonic()

    def _decay(self) -> None:
        now = time.monotonic()
        points = int((now - self._last) * _DECAY_PER_SECOND)
        if points <= 0:
            return  # keep _last: fractional credit accumulates across calls
        self._last += points / _DECAY_PER_SECOND
        if self.reputation < 0:
            self.reputation = min(0, self.reputation + points)


class PeersManager:
    """Reputation accounting keyed by node id (64-byte pubkey)."""

    def __init__(self, ban_seconds: float = DEFAULT_BAN_SECONDS):
        self.ban_seconds = ban_seconds
        self.peers: dict[bytes, PeerRecord] = {}

    def _rec(self, node_id: bytes) -> PeerRecord:
        rec = self.peers.get(node_id)
        if rec is None:
            rec = self.peers[node_id] = PeerRecord()
        rec._decay()
        return rec

    def reputation_change(self, node_id: bytes, kind: str) -> int:
        """Apply a weighted change; bans the peer past the threshold.
        Returns the new reputation."""
        rec = self._rec(node_id)
        rec.reputation += REPUTATION_CHANGE.get(kind, -1_00)
        if rec.reputation <= BANNED_REPUTATION:
            rec.banned_until = time.monotonic() + self.ban_seconds
        return rec.reputation

    def ban(self, node_id: bytes, seconds: float | None = None) -> None:
        rec = self._rec(node_id)
        rec.banned_until = time.monotonic() + (
            seconds if seconds is not None else self.ban_seconds
        )
        rec.reputation = BANNED_REPUTATION

    def unban(self, node_id: bytes) -> None:
        rec = self._rec(node_id)
        rec.banned_until = 0.0
        rec.reputation = 0

    def is_banned(self, node_id: bytes) -> bool:
        rec = self.peers.get(node_id)
        if rec is None:
            return False
        if rec.banned_until and time.monotonic() >= rec.banned_until:
            rec.banned_until = 0.0
            rec.reputation = 0  # ban served
        return bool(rec.banned_until)

    def reputation(self, node_id: bytes) -> int:
        return self._rec(node_id).reputation
