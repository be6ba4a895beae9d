"""Broadcast event channels (EventSender/EventStream analogue).

A copy of the JAX package's ``events.py``; it runs no device work.

Reference analogue: crates/tokio-util's `EventSender`/`EventStream` — a
bounded broadcast channel node components use to publish lifecycle events
(pipeline progress, canon changes, network events) to any number of late
subscribers without blocking the producer.

Semantics matched to the reference: sends never block (slow subscribers
drop their OLDEST queued events — lagging consumers skip ahead, they do
not stall consensus), subscribing is cheap, and a closed sender wakes all
streams with end-of-stream.
"""

from __future__ import annotations

import threading
from collections import deque


class EventStream:
    """One subscriber's view: iterate, or poll with ``next(timeout)``."""

    def __init__(self, sender: "EventSender", maxlen: int):
        self._buf: deque = deque(maxlen=maxlen)
        self._cond = threading.Condition()
        self._closed = False
        self._sender = sender
        self.dropped = 0  # events lost to lag (oldest-first)

    def _push(self, event) -> None:
        with self._cond:
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(event)
            self._cond.notify()

    def _close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def next(self, timeout: float | None = None):
        """The next event, or None on close/timeout."""
        with self._cond:
            if not self._buf and not self._closed:
                self._cond.wait(timeout)
            if self._buf:
                return self._buf.popleft()
            return None

    def __iter__(self):
        while True:
            ev = self.next()
            if ev is None and self._closed:
                return
            if ev is not None:
                yield ev

    def unsubscribe(self) -> None:
        self._sender._remove(self)


class EventSender:
    """Fan-out sender; ``new_listener()`` returns an independent stream."""

    def __init__(self, buffer: int = 256):
        self._buffer = buffer
        self._streams: list[EventStream] = []
        self._lock = threading.Lock()
        self._closed = False

    def new_listener(self) -> EventStream:
        s = EventStream(self, self._buffer)
        with self._lock:
            if self._closed:
                s._close()
            else:
                self._streams.append(s)
        return s

    def notify(self, event) -> None:
        with self._lock:
            streams = list(self._streams)
        for s in streams:
            s._push(event)

    def _remove(self, stream: EventStream) -> None:
        with self._lock:
            if stream in self._streams:
                self._streams.remove(stream)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            streams, self._streams = self._streams, []
        for s in streams:
            s._close()
