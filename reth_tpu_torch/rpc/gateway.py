"""RPC serving gateway: admission control, in-flight request coalescing,
and head-invalidated response caching.

A copy of the JAX package's ``rpc/gateway.py``. The fleet router (``fleet=``)
is not ported yet: the port's servers pass ``fleet=None``.

Until now every request reaching a transport (HTTP ``RpcServer``,
``WsRpcServer``, ``IpcRpcServer``) dispatched straight into its handler:
a burst of identical ``eth_call``/``eth_getLogs``/``eth_getProof``
requests recomputed the same answer N times, heavy ``debug_*`` traces
competed head-to-head with Engine-API traffic, and overload had nowhere
to shed. This module is the request-level twin of the device-side
``ops/hash_service.py``: the same decouple-arrival-from-execution shape
the async-storage parallel-EVM work (Reddio, arxiv 2503.04595) argues
for, applied to the serving path instead of the hashing path. Every
transport routes dispatch through ONE gateway (they all funnel through
``RpcServer.handle``), so the front door absorbs the traffic while the
handlers run at whatever rate the node allows.

Shape:

- **Admission control** (:data:`CLASSES`): requests classify into
  priority classes ``engine`` (the consensus client) > ``read`` (eth/net
  reads) > ``tx`` (submission) > ``debug`` (traces & friends). Each
  class has a concurrency limit and a bounded wait queue; a global limit
  caps total in-flight handlers. A full class queue sheds the request
  with JSON-RPC error ``-32005`` carrying ``retry_after`` data instead
  of letting queues grow without bound (the reference rate-limit
  convention). Waiters older than ``age_promote_s`` are granted FIRST
  regardless of class — the anti-starvation rule borrowed from
  ``ops/hash_service.py`` — so saturating engine traffic cannot starve a
  debug client forever.
- **In-flight coalescing**: identical read requests — canonicalized
  ``(method, params, head)`` — waiting on one computation share a single
  future; the leader executes once and every follower receives the SAME
  result object, bit-identical on the wire. Followers never occupy an
  admission slot: coalescing happens before admission, so a burst of N
  duplicates costs one slot and one execution.
- **Head-invalidated response cache**: a bounded LRU keyed by
  ``(method, params, head_hash)`` for the pure-read methods
  (``eth_call``, ``eth_estimateGas``, ``eth_getLogs``, ``eth_getProof``,
  ``eth_getBlockBy*``). Keys embed the canonical head, so a stale entry
  can never be served for a new head; on canonical-head change (a hook
  off ``engine/tree.py``'s canon listeners) the cache is additionally
  cleared wholesale so dead-head entries do not squat the LRU. Composes
  with (does not replace) ``rpc/state_cache.py``, which caches by
  immutable block hash underneath the handlers.
- **Fleet mode** (``fleet=`` the JAX package's ``fleet/ring.py
  FleetRouter``, wired by ``--fleet``; not ported yet): the coalescing leader of a pure
  read routes through a consistent-hash ring of stateless read replicas
  keyed by the SAME canonical ``(method, params, head)`` key — identical
  reads land on the same replica and therefore in its response cache;
  a replica that errs or cannot answer from its witness window fails
  over to the next ring position and finally to the local handler, so
  fleet membership is invisible to clients. ``fleet_*`` admin methods
  classify into the ``engine`` class: registration and draining must
  never starve behind a ``debug_traceBlock`` re-execution.
- **Fault injection** (:class:`GatewayFaultInjector`):
  ``RETH_TPU_FAULT_GATEWAY_STALL`` (seconds added to every execution —
  the overload drill that backs requests up into the bounded queues)
  and ``RETH_TPU_FAULT_GATEWAY_SHED`` (shed every Nth admission — the
  client-visible ``-32005`` drill without real overload).
- **Observability**: ``gateway_*`` metrics (per-class request counts,
  queue depth, running gauge, shed count, wait/service histograms,
  coalesce factor, cache hit rate) plus a ``gateway[...]`` events-
  dashboard fragment via :meth:`snapshot`.

Wiring: ``--rpc-gateway`` (cli.py) / ``[rpc] gateway`` (reth.toml) build
one gateway in ``node/node.py`` shared by the public AND auth servers
(one admission domain: engine traffic outranks public debug traffic),
and hang its invalidation hook on the engine tree's canon listeners.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict, deque

from .. import tracing
from .server import RpcError

# priority order, highest first — index IS the priority
CLASSES = ("engine", "read", "tx", "debug")
_CLASS_INDEX = {name: i for i, name in enumerate(CLASSES)}

# JSON-RPC "limit exceeded" (the de-facto overload/rate-limit code)
OVERLOADED = -32005

# pure reads: coalescable + cacheable against the canonical head
DEFAULT_COALESCE = frozenset({
    "eth_call", "eth_estimateGas", "eth_getLogs", "eth_getProof",
    "eth_getBlockByNumber", "eth_getBlockByHash",
})

_TX_METHODS = frozenset({
    "eth_sendRawTransaction", "eth_sendTransaction",
    "eth_sendRawTransactionSync",
})

# monitoring probes (health.py surfaces): cheap snapshot reads a fleet
# gateway polls to route around sick replicas — admitted as reads, never
# queued behind a debug_traceBlock re-execution in the 2-slot debug class
# (a health check that times out BECAUSE the node is busy reports the
# node dead exactly when it matters that it is not)
_MONITORING_METHODS = frozenset({
    "debug_healthCheck", "debug_sloStatus", "debug_metricsHistory",
    "debug_fleetMetrics",
})


def classify(method: str) -> str:
    """Map a JSON-RPC method name onto its admission class."""
    if method.startswith("engine_"):
        return "engine"
    if method.startswith("fleet_"):
        # fleet-admin / feed-control (fleet/ring.py FleetAdminApi +
        # replica fleet_status probes): ring membership changes and
        # draining are control-plane traffic — in the 2-slot debug class
        # they would starve behind a debug_traceBlock re-execution
        # exactly when a sick replica needs shedding
        return "engine"
    if method in _TX_METHODS:
        return "tx"
    if method in _MONITORING_METHODS:
        return "read"
    if method.startswith("producer_"):
        # continuous-build control/introspection (payload/producer.py):
        # operator plane like fleet_, must not queue behind debug work
        return "engine"
    if method.startswith("txpool_"):
        # pool INSPECTION is a read (pending view, nonces, content) —
        # only the submit methods above ride the shed-first tx class;
        # pinned explicitly so the write-path PR cannot accidentally
        # reclassify reads as sheddable
        return "read"
    if method.startswith(("debug_", "trace_", "ots_", "flashbots_")):
        return "debug"
    return "read"


class GatewayFaultInjector:
    """Overload/shed fault policies for the gateway, in the style of
    ``ops/hash_service.py``'s ServiceFaultInjector.

    ``stall``: fixed seconds added to every admitted execution — backs
    requests up into the bounded class queues (overload drill).
    ``shed_every``: every Nth admission is shed with ``-32005`` BEFORE
    reaching a handler (client-visible shed drill without overload).

    Env form (:meth:`from_env`): ``RETH_TPU_FAULT_GATEWAY_STALL`` /
    ``RETH_TPU_FAULT_GATEWAY_SHED``.
    """

    def __init__(self, stall: float = 0.0, shed_every: int = 0):
        self.stall = stall
        self.shed_every = shed_every
        self.admissions = 0
        self.forced_sheds = 0
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls, env=None) -> "GatewayFaultInjector | None":
        env = os.environ if env is None else env
        stall = float(env.get("RETH_TPU_FAULT_GATEWAY_STALL", "0") or 0)
        shed = int(env.get("RETH_TPU_FAULT_GATEWAY_SHED", "0") or 0)
        if not (stall or shed):
            return None
        return cls(stall=stall, shed_every=shed)

    def active(self) -> bool:
        return bool(self.stall or self.shed_every)

    def on_admit(self) -> bool:
        """Called at admission; True = shed this request (drill)."""
        if not self.shed_every:
            return False
        with self._lock:
            self.admissions += 1
            if self.admissions % self.shed_every == 0:
                self.forced_sheds += 1
                tracing.fault_event("RETH_TPU_FAULT_GATEWAY_SHED",
                                    target="rpc::gateway",
                                    admission=self.admissions)
                return True
        return False

    def on_execute(self) -> None:
        """Called before the handler runs (stall drill)."""
        if self.stall:
            tracing.fault_event("RETH_TPU_FAULT_GATEWAY_STALL",
                                target="rpc::gateway", stall_s=self.stall)
            time.sleep(self.stall)


class _Waiter:
    __slots__ = ("cls", "enqueued_at", "granted", "shed")

    def __init__(self, cls: str):
        self.cls = cls
        self.enqueued_at = time.monotonic()
        self.granted = False
        self.shed = False


class _InFlight:
    """One leader computation, fanned out to followers bit-identically."""

    __slots__ = ("event", "result", "error", "followers")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.error: BaseException | None = None
        self.followers = 0


class RpcGateway:
    """One gateway per node, shared by every transport and RPC server.

    ``head_supplier``: callable returning the canonical head hash —
    bound into coalescing/cache keys so no response can cross a head
    boundary. ``class_limits`` / ``queue_caps`` map class -> int;
    ``max_concurrent`` caps total in-flight handlers across classes.
    ``cache_size`` = 0 disables the response cache (coalescing stays on).
    """

    def __init__(self, head_supplier=None, *,
                 max_concurrent: int | None = None,
                 class_limits: dict | None = None,
                 queue_caps: dict | None = None,
                 age_promote_s: float | None = None,
                 cache_size: int | None = None,
                 coalesce_methods=None,
                 retry_after_s: float = 1.0,
                 injector: GatewayFaultInjector | None = None,
                 fleet=None,
                 registry=None):
        env = os.environ
        self.head_supplier = head_supplier
        self.max_concurrent = int(
            max_concurrent or env.get("RETH_TPU_GATEWAY_CONCURRENCY", 0) or 32)
        limits = {"engine": 8, "read": 16, "tx": 8, "debug": 2}
        limits.update(class_limits or {})
        self.class_limits = limits
        cap = int(queue_caps.pop("default", 0) if isinstance(queue_caps, dict)
                  else 0) or int(env.get("RETH_TPU_GATEWAY_QUEUE_CAP", 0) or 64)
        caps = {c: cap for c in CLASSES}
        caps.update(queue_caps or {})
        self.queue_caps = caps
        self.age_promote_s = float(
            age_promote_s if age_promote_s is not None
            else env.get("RETH_TPU_GATEWAY_AGE_PROMOTE", "0.25"))
        self.cache_size = int(
            cache_size if cache_size is not None
            else env.get("RETH_TPU_GATEWAY_CACHE", 0) or 1024)
        self.coalesce_methods = (frozenset(coalesce_methods)
                                 if coalesce_methods is not None
                                 else DEFAULT_COALESCE)
        self.retry_after_s = retry_after_s
        self.injector = (injector if injector is not None
                         else GatewayFaultInjector.from_env())
        # fleet mode (fleet/ring.py FleetRouter): pure reads route to a
        # consistent-hash ring of stateless replicas keyed by the SAME
        # (method, params, head) cache key — identical reads land on the
        # same replica and its response cache; failures ladder replica →
        # ring neighbor → the local handler. None = serve locally.
        self.fleet = fleet

        from ..metrics import GatewayMetrics

        self.metrics = GatewayMetrics(registry)
        self._cond = threading.Condition()
        self._running = {c: 0 for c in CLASSES}
        self._waiting: dict[str, deque[_Waiter]] = {c: deque() for c in CLASSES}
        self._inflight: dict[tuple, _InFlight] = {}
        self._cache: OrderedDict[tuple, object] = OrderedDict()
        self._cache_lock = threading.Lock()
        # counters surfaced via snapshot() (metrics hold the full detail)
        self.requests = 0
        self.sheds = 0
        self.coalesced = 0
        self.executions = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.invalidations = 0

    # -- dispatch seam (called by RpcServer._handle_one) --------------------

    def call(self, method: str, params, invoke):
        """Route one request: cache -> coalesce -> admission -> execute.

        ``invoke`` is the zero-arg closure that runs the handler under
        the server's locking rules; its result (or RpcError) is returned
        or re-raised exactly as the ungated path would.
        """
        cls = classify(method)
        self.requests += 1
        self.metrics.record_request(cls)
        key = self._key(method, params)
        if key is not None:
            hit, value = self._cache_get(key)
            if hit:
                return value
            entry, leader = self._join_or_lead(key)
            if not leader:
                # follower: share the in-flight computation bit-identically
                self.coalesced += 1
                self.metrics.record_coalesced(cls)
                entry.event.wait()
                if entry.error is not None:
                    raise entry.error
                return entry.result
            exec_fn = invoke
            if self.fleet is not None:
                exec_fn = (lambda m=method, p=params, k=key:
                           self.fleet.route(m, p, k, invoke))
            try:
                result = self._admit_and_run(cls, method, exec_fn)
            except BaseException as e:
                entry.error = e
                raise
            else:
                entry.result = result
                self._cache_put(key, result)
                return result
            finally:
                with self._cond:
                    self._inflight.pop(key, None)
                entry.event.set()
        return self._admit_and_run(cls, method, invoke)

    # -- admission ----------------------------------------------------------

    def _admit_and_run(self, cls: str, method: str, invoke):
        t0 = time.monotonic()
        if self.injector is not None and self.injector.on_admit():
            self._shed(cls, "fault injection")
        self._admit(cls)
        wait_s = time.monotonic() - t0
        self.metrics.record_wait(cls, wait_s)
        t1 = time.monotonic()
        try:
            if self.injector is not None:
                self.injector.on_execute()
            self.executions += 1
            # gateway admission + handler execution under one span: an
            # engine_newPayload's block trace starts INSIDE invoke(), so
            # this span is the "gateway admission" prefix of its timeline
            with tracing.span("rpc::gateway", "gateway.execute",
                              method=method, cls=cls,
                              wait_ms=round(wait_s * 1e3, 3)):
                return invoke()
        finally:
            self.metrics.record_service(cls, time.monotonic() - t1)
            self._release(cls)

    def _shed(self, cls: str, why: str):
        self.sheds += 1
        self.metrics.record_shed(cls)
        tracing.event("rpc::gateway", "shed", cls=cls, why=why)
        raise RpcError(
            OVERLOADED,
            f"{cls} lane overloaded ({why}); retry after "
            f"{self.retry_after_s:g}s",
            data={"class": cls, "retry_after": self.retry_after_s})

    def _can_start_locked(self, cls: str) -> bool:
        return (sum(self._running.values()) < self.max_concurrent
                and self._running[cls] < self.class_limits[cls])

    def _admit(self, cls: str) -> None:
        with self._cond:
            if not self._waiting[cls] and self._can_start_locked(cls):
                self._running[cls] += 1
                self.metrics.set_running(cls, self._running[cls])
                return
            if len(self._waiting[cls]) >= self.queue_caps[cls]:
                self._shed(cls, f"queue full "
                                f"({len(self._waiting[cls])}/"
                                f"{self.queue_caps[cls]} waiting)")
            w = _Waiter(cls)
            self._waiting[cls].append(w)
            self.metrics.set_queue_depth(cls, len(self._waiting[cls]))
            self._grant_locked()
            while not w.granted:
                self._cond.wait()

    def _release(self, cls: str) -> None:
        with self._cond:
            self._running[cls] -= 1
            self.metrics.set_running(cls, self._running[cls])
            self._grant_locked()

    def _grant_locked(self) -> None:
        """Grant as many waiters as capacity allows: aged waiters first
        (FIFO across classes — the anti-starvation rule), then class
        priority order, FIFO within a class."""
        while True:
            now = time.monotonic()
            pick = None
            aged = [q[0] for q in self._waiting.values()
                    if q and now - q[0].enqueued_at >= self.age_promote_s]
            if aged:
                cand = min(aged, key=lambda w: w.enqueued_at)
                if self._can_start_locked(cand.cls):
                    pick = cand
            if pick is None:
                for c in CLASSES:
                    q = self._waiting[c]
                    if q and self._can_start_locked(c):
                        pick = q[0]
                        break
            if pick is None:
                return
            self._waiting[pick.cls].popleft()
            self.metrics.set_queue_depth(pick.cls,
                                         len(self._waiting[pick.cls]))
            self._running[pick.cls] += 1
            self.metrics.set_running(pick.cls, self._running[pick.cls])
            pick.granted = True
            self._cond.notify_all()

    # -- coalescing + cache -------------------------------------------------

    def _key(self, method: str, params) -> tuple | None:
        """Canonical coalescing/cache key, or None when the request is
        not a pure head-scoped read (or params defy canonicalization)."""
        if method not in self.coalesce_methods:
            return None
        try:
            pkey = json.dumps(params, sort_keys=True, separators=(",", ":"))
        except (TypeError, ValueError):
            return None
        head = self.head_supplier() if self.head_supplier is not None else b""
        return (method, pkey, head)

    def _join_or_lead(self, key) -> tuple[_InFlight, bool]:
        with self._cond:
            entry = self._inflight.get(key)
            if entry is not None:
                entry.followers += 1
                return entry, False
            entry = _InFlight()
            self._inflight[key] = entry
            return entry, True

    def _cache_get(self, key) -> tuple[bool, object]:
        if self.cache_size <= 0:
            return False, None
        with self._cache_lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                self.cache_hits += 1
                self.metrics.record_cache(hit=True)
                return True, self._cache[key]
        self.cache_misses += 1
        self.metrics.record_cache(hit=False)
        return False, None

    def _cache_put(self, key, value) -> None:
        if self.cache_size <= 0:
            return
        with self._cache_lock:
            self._cache[key] = value
            self._cache.move_to_end(key)
            while len(self._cache) > self.cache_size:
                self._cache.popitem(last=False)

    def on_head_change(self, chain=None) -> None:
        """Canonical-head hook (engine/tree.py canon listener): the keys
        embed the head hash, so stale reads were already unreachable —
        this clears the dead-head entries wholesale so they cannot squat
        the LRU. Signature matches the canon-listener protocol."""
        with self._cache_lock:
            n = len(self._cache)
            self._cache.clear()
        self.invalidations += 1
        self.metrics.record_invalidation(n)

    # -- observability ------------------------------------------------------

    def coalesce_factor(self) -> float:
        """Requests served per execution on the coalescable path
        (lifetime): >1 means duplicate bursts actually shared work."""
        served = self.coalesced + self.cache_hits + self.executions
        return served / self.executions if self.executions else 0.0

    def cache_hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    def snapshot(self) -> dict:
        """State for the events dashboard line and bench/test triage."""
        with self._cond:
            waiting = {c: len(self._waiting[c]) for c in CLASSES}
            running = dict(self._running)
        return {
            "requests": self.requests,
            "waiting": waiting,
            "waiting_total": sum(waiting.values()),
            "running": running,
            "running_total": sum(running.values()),
            "sheds": self.sheds,
            "coalesced": self.coalesced,
            "executions": self.executions,
            "coalesce_factor": round(self.coalesce_factor(), 2),
            "cache_hits": self.cache_hits,
            "cache_hit_rate": round(self.cache_hit_rate(), 3),
            "invalidations": self.invalidations,
            "fault_injection": (self.injector.active()
                                if self.injector is not None else False),
            **({"fleet": self.fleet.snapshot()}
               if self.fleet is not None else {}),
        }
