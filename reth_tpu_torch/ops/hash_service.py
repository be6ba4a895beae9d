"""The shared hash service: priority lanes, continuous batching, backpressure
and the rebuild's exclusive lease, for every keccak client of one card.

Port of the JAX package's ``ops/hash_service.py``, with the same lanes,
policies, counters and env knobs. One dispatcher thread owns one backend
and multiplexes every client over it:

- **Priority lanes** (:data:`LANES`): ``live`` (the live-tip state root) >
  ``payload`` (payload building) > ``rebuild`` (the Merkle rebuild) >
  ``proof`` (proofs and RPC). Clients submit asynchronous requests
  (:meth:`HashService.submit` → :class:`HashFuture`) or call through a
  lane-bound :class:`HashClient`, which satisfies the ``hasher`` protocol
  (``list[bytes] -> list[bytes]``).
- **Continuous batching**: the dispatcher gathers requests until
  ``fill_target`` messages are queued or the oldest has waited ``window_s``
  (``RETH_TPU_SERVICE_WINDOW``), then hashes them in ONE backend call
  (kernel 1 through ``KeccakDevice`` by default) and scatters the digests
  back. A lone request dispatches at once.
- **Backpressure**: each lane holds at most ``lane_capacity`` messages
  (``RETH_TPU_SERVICE_LANE_CAP``); a full lane blocks the submitter, or
  raises :class:`LaneOverloaded` with ``block=False``.
- **Aging**: a request older than ``age_promote_s``
  (``RETH_TPU_SERVICE_AGE_PROMOTE``) is drained first, FIFO, so a busy
  live lane cannot starve the proof lane.
- **Exclusive lease** (:meth:`HashService.lease`,
  :meth:`HashService.lease_backend`): a rebuild commit streams its windows
  straight at its own engine while coalesced dispatching pauses; queued
  requests older than ``lease_bypass_s`` (``RETH_TPU_SERVICE_LEASE_BYPASS``)
  are hashed on the numpy twin meanwhile. The dispatcher and the rebuild
  launch on the same card and the same default stream; the lease is what
  keeps their launches apart.
- **Window requests** (:meth:`HashService.submit_window`,
  :meth:`HashClient.commit_window`): a pre-packed k-level window runs as
  one ``SubtrieFusedEngine`` commit, ``subtrie_levels`` levels a launch of
  kernel 4, on the dispatcher thread.
- **Failure policy**: under a supervisor (``supervisor=``, or a
  ``SupervisedHasher`` backend) a fault in a launch, a copy or a sync (a
  ``RuntimeError``, an injected service wedge among them,
  :class:`ServiceFaultInjector`) replays the whole in-flight batch on the
  numpy twin, so every future completes exactly once. Without one, a
  dispatch that raises fails its futures with the error, and the caller
  sees it: no work leaves the card silently. A failed build
  (``ops/_build.py BuildError``) is never replayed: on the card the
  constructor loads kernels 1 and 4 before the dispatcher starts, so a
  build failure raises to the caller, and one that still surfaces at a
  dispatch fails its futures.

- **Member mesh** (``mesh=``, a ``parallel/mesh.py`` HashMesh): the
  service owns a mesh instead of one backend. The partition-rule table
  (``HashMesh.spec_for``) decides how each coalesced dispatch shards: large
  batches over the live members (``MeshKeccak``, kernel 1 a member), scalar
  and small ones on one member. The exclusive lease becomes a **sub-mesh
  lease** (``lease(devices=k)``, default ``rebuild_devices``,
  ``RETH_TPU_MESH_REBUILD_DEVICES`` or half the mesh): the rebuild claims k
  members from the roster's tail (``rebuild_mesh()``) while the lanes keep
  dispatching on the rest, with no pause and no bypass onto the twin.
  ``pipeline_lease()`` carves the import pipeline's double-buffer sub-mesh.
  Per-member breakers (``breaker_board=``, ``ops/supervisor.py
  DeviceBreakerBoard``) shed a member that an injected wedge names
  (``device_injector=``, ``RETH_TPU_FAULT_DEVICE_WEDGE``) and the same batch
  replays on the survivors; the numpy twin replays it only once every
  member has tripped (``MeshExhausted``). A real kernel fault is not shed:
  it fails the batch's futures, as without a mesh.

Each lane's queue waits are kept (:meth:`HashService.lane_waits`: count,
p50, p99) beside the ``hash_service_*`` metrics.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from contextlib import contextmanager

import numpy as np
import torch

from .. import tracing
from ..device import resolve
from ..metrics import HashServiceMetrics
from ..parallel.mesh import MeshExhausted, MeshKeccak
from ._build import BuildError, is_kernel_fault
from .keccak import _next_tier

# priority order, highest first: the index is the priority
LANES = ("live", "payload", "rebuild", "proof")
_LANE_INDEX = {name: i for i, name in enumerate(LANES)}

# per-lane p99 queue-wait budgets (seconds), the reference's
DEFAULT_WAIT_BUDGETS = {"live": 0.25, "payload": 0.5, "rebuild": 2.0, "proof": 1.0}
# p99 budget for one coalesced dispatch's wall
DEFAULT_DISPATCH_BUDGET_S = 0.15
# queue waits kept per lane for lane_waits()
_WAITS_KEPT = 1 << 16


class HashServiceError(RuntimeError):
    """Base class for service-level failures."""


class LaneOverloaded(HashServiceError):
    """A bounded lane is full and the submitter asked not to block."""


class ServiceStopped(HashServiceError):
    """The service was stopped while this request was queued."""


class InjectedServiceWedge(HashServiceError):
    """Service fault injection wedged this coalesced dispatch
    (RETH_TPU_FAULT_SERVICE_WEDGE_EVERY): drills the replay path."""


class ServiceFaultInjector:
    """Overload and stall fault policies of the service.

    ``wedge_every``: every Nth coalesced dispatch raises
    :class:`InjectedServiceWedge` before it touches the backend; under a
    supervisor the batch completes through the numpy-twin replay, without
    one its futures fail with the wedge. ``stall``: seconds added to
    every dispatch (backs requests up into the bounded lanes).
    ``queue_cap``: overrides every lane's capacity in messages. Env form
    (:meth:`from_env`): ``RETH_TPU_FAULT_SERVICE_WEDGE_EVERY`` /
    ``RETH_TPU_FAULT_SERVICE_STALL`` / ``RETH_TPU_FAULT_SERVICE_QUEUE_CAP``."""

    def __init__(self, wedge_every: int = 0, stall: float = 0.0, queue_cap: int = 0):
        self.wedge_every = wedge_every
        self.stall = stall
        self.queue_cap = queue_cap
        self.dispatches = 0
        self.wedged = 0
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls, env=None) -> "ServiceFaultInjector | None":
        env = os.environ if env is None else env
        wedge = int(env.get("RETH_TPU_FAULT_SERVICE_WEDGE_EVERY", "0") or 0)
        stall = float(env.get("RETH_TPU_FAULT_SERVICE_STALL", "0") or 0)
        cap = int(env.get("RETH_TPU_FAULT_SERVICE_QUEUE_CAP", "0") or 0)
        if not (wedge or stall or cap):
            return None
        return cls(wedge_every=wedge, stall=stall, queue_cap=cap)

    def active(self) -> bool:
        return bool(self.wedge_every or self.stall or self.queue_cap)

    def on_dispatch(self) -> None:
        """Called before every coalesced dispatch touches the backend."""
        with self._lock:
            self.dispatches += 1
            n = self.dispatches
        if self.stall:
            tracing.fault_event("RETH_TPU_FAULT_SERVICE_STALL", target="ops::hash_service",
                                dispatch=n, stall_s=self.stall)
            time.sleep(self.stall)
        if self.wedge_every and n % self.wedge_every == 0:
            with self._lock:
                self.wedged += 1
            tracing.fault_event("RETH_TPU_FAULT_SERVICE_WEDGE_EVERY",
                                target="ops::hash_service", dispatch=n)
            raise InjectedServiceWedge(f"injected service wedge on dispatch #{n} "
                                       f"(every {self.wedge_every})")


class HashFuture:
    """Completion handle of one request: completes exactly once, with the
    digests or with an exception."""

    __slots__ = ("_event", "_result", "_error", "completions")

    def __init__(self):
        self._event = threading.Event()
        self._result: list[bytes] | None = None
        self._error: BaseException | None = None
        self.completions = 0  # must end at exactly 1

    def _complete(self, result=None, error=None) -> None:
        self.completions += 1
        if self.completions > 1:  # pragma: no cover - invariant guard
            raise AssertionError("HashFuture completed twice")
        self._result, self._error = result, error
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> list[bytes]:
        if not self._event.wait(timeout):
            raise TimeoutError("hash service request timed out")
        if self._error is not None:
            raise self._error
        return self._result


class _Request:
    __slots__ = ("lane", "msgs", "future", "enqueued_at", "ctx", "wall_at")

    window = None  # a plain hash request (window requests override)

    def __init__(self, lane: str, msgs: list[bytes]):
        self.lane = lane
        self.msgs = msgs
        self.future = HashFuture()
        self.enqueued_at = time.monotonic()
        # the submitter's trace context rides the request across the queue
        self.ctx = tracing.current_context()
        self.wall_at = time.time()


class _WindowRequest:
    """One multi-level request: a pre-packed k-level window (the
    ``dispatch_packed`` / ``dispatch_branch`` arguments per level) that the
    dispatcher runs as one k-level engine commit; completes with the digest
    buffer, or the ``fetch`` slots of it."""

    __slots__ = ("lane", "window", "max_slots", "fetch", "rows", "future",
                 "enqueued_at", "ctx", "wall_at")

    def __init__(self, lane: str, window: list[dict], max_slots: int, fetch=None):
        self.lane = lane
        self.window = window
        self.max_slots = max_slots
        self.fetch = fetch
        self.rows = sum(len(lv["slots"]) for lv in window)
        self.future = HashFuture()
        self.enqueued_at = time.monotonic()
        self.ctx = tracing.current_context()
        self.wall_at = time.time()


def _req_msgs(r) -> int:
    """A request's size in the lane's accounting (messages, or window rows)."""
    return r.rows if r.window is not None else len(r.msgs)


class HashClient:
    """Lane-bound callable satisfying the ``hasher`` protocol
    (``list[bytes] -> list[bytes]``): a drop-in for
    ``KeccakDevice.hash_batch``, ``keccak256_batch_np`` or
    ``SupervisedHasher``."""

    __slots__ = ("service", "lane")

    def __init__(self, service: "HashService", lane: str):
        if lane not in _LANE_INDEX:
            raise ValueError(f"unknown lane {lane!r} (have {LANES})")
        self.service = service
        self.lane = lane

    def __call__(self, msgs: list[bytes]) -> list[bytes]:
        return self.service.hash(self.lane, list(msgs))

    def submit(self, msgs: list[bytes]) -> HashFuture:
        return self.service.submit(self.lane, list(msgs))

    def commit_window(self, window: list[dict], max_slots: int, fetch=None):
        """A k-level window (one dict per level, deepest first) through ONE
        k-level engine commit on the service; returns the digest buffer, or
        the ``fetch`` slots of it."""
        return self.service.submit_window(self.lane, window, max_slots, fetch=fetch).result()

    def map_chunks(self, chunks) -> list[bytes]:
        """Submit every chunk as its own request (continuous batching fuses
        them back into full dispatches), then gather the digests in order."""
        futs = [self.submit(list(c)) for c in chunks]
        out: list[bytes] = []
        for f in futs:
            out.extend(f.result())
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"HashClient(lane={self.lane!r})"


class PipelineLease:
    """A double-buffered sub-mesh held by the cross-block import pipeline:
    the speculative block's key prehash runs on the leased members (the
    service's sharded hasher) while the committing block's lanes keep the
    rest. ``release()`` is idempotent."""

    def __init__(self, service: "HashService", sub):
        self._service = service
        self._sub = sub
        self.devices = len(sub.indices)
        self.released = False

    def hash(self, msgs: list[bytes]) -> list[bytes]:
        if self.released:  # a late straggler batch: the twin, never racy
            return self._service._cpu(msgs)
        return self._service._mesh_hasher.hash_sharded(msgs, self._sub.mesh)

    def release(self) -> None:
        if self.released:
            return
        self.released = True
        self._sub.release()


class LeasedTurboBackend:
    """Array-protocol proxy that holds the service's lease (exclusive, or a
    sub-mesh lease on a meshed service) for one turbo commit, from ``begin``
    to the terminal ``finish`` / ``fetch_slots``.
    The rebuild streams its windows straight at the inner engine while the
    coalesced lanes pause. ``factory`` builds the engine once the lease is
    held."""

    def __init__(self, service: "HashService", inner=None, factory=None):
        if inner is None and factory is None:
            raise ValueError("LeasedTurboBackend needs inner or factory")
        self._service = service
        self._inner = inner
        self._factory = factory
        self._lease = None

    @property
    def effective_kind(self) -> str:
        return getattr(self._inner, "effective_kind", "device")

    @property
    def failed_over(self) -> bool:
        return getattr(self._inner, "failed_over", False)

    def begin(self, max_slots: int) -> None:
        if self._lease is None:
            self._lease = self._service.lease(what="rebuild")
            self._lease.__enter__()
        if self._inner is None:
            self._inner = self._factory()
        self._inner.begin(max_slots)

    def release(self) -> None:
        """Drop the lease. Idempotent: the terminal fetch calls it, and the
        committers call it from a ``finally`` so an aborted commit can never
        wedge the coalesced lanes."""
        if self._lease is not None:
            lease, self._lease = self._lease, None
            lease.__exit__(None, None, None)

    _release = release

    def ensure(self, max_slots: int) -> None:
        self._inner.ensure(max_slots)

    def alloc_slot(self) -> int:
        return self._inner.alloc_slot()

    def dispatch_level(self, bucket) -> None:
        self._inner.dispatch_level(bucket)

    def dispatch_packed(self, flat, row_off, row_len, slots, holes, b_tier):
        self._inner.dispatch_packed(flat, row_off, row_len, slots, holes, b_tier)

    def dispatch_branch(self, masks, slots, children) -> None:
        self._inner.dispatch_branch(masks, slots, children)

    def flush_window(self) -> None:
        flush = getattr(self._inner, "flush_window", None)
        if flush is not None:
            flush()

    def fetch_slots(self, slots):
        try:
            return self._inner.fetch_slots(slots)
        finally:
            self._release()

    def finish(self):
        try:
            return self._inner.finish()
        finally:
            self._release()


class HashService:
    """Background hash service on ``device``: one backend, many clients,
    continuous batching (see the module docstring).

    ``backend``: the batch hasher (``list[bytes] -> list[bytes]``); when
    None, a ``SupervisedHasher`` over ``supervisor``, else
    ``KeccakDevice(min_tier, block_tier=4)`` on ``device``. ``cpu_hasher``:
    the twin of the lease bypass, and of the replay, which only a
    supervised service makes (see the failure policy in the module
    docstring). Window requests run through
    ``SubtrieFusedEngine(k=subtrie_levels)`` on ``device``, gated by
    ``warmup``. On the card, kernels 1 and 4 are built (where missing) and
    loaded before the dispatcher starts, so a failed build raises here.

    ``mesh``: a ``parallel/mesh.py`` HashMesh: coalesced dispatches route
    through ``MeshKeccak`` by the partition rules, window requests through
    ``SubtrieMeshEngine``, and ``lease`` is a sub-mesh lease of
    ``rebuild_devices`` members. ``breaker_board`` (default a
    ``DeviceBreakerBoard`` over the mesh) and ``device_injector`` (default
    ``FaultInjector.from_env()``) drive the per-member shedding."""

    def __init__(self, backend=None, supervisor=None, *,
                 cpu_hasher=None,
                 window_s: float | None = None,
                 fill_target: int | None = None,
                 max_batch: int | None = None,
                 lane_capacity: int | None = None,
                 age_promote_s: float | None = None,
                 lease_bypass_s: float | None = None,
                 min_tier: int = 1024,
                 injector: ServiceFaultInjector | None = None,
                 mesh=None, breaker_board=None, device_injector=None,
                 rebuild_devices: int | None = None, warmup=None,
                 subtrie_levels: int | None = None, registry=None,
                 device: str | torch.device = "cuda"):
        self.device = resolve(device)
        env = os.environ
        # window requests: k levels a launch, from RETH_TPU_SUBTRIE_LEVELS as
        # the reference reads it (unset: its default "0" is taken before the
        # "or 8", so one level a launch; set it or pass subtrie_levels)
        if subtrie_levels is None:
            subtrie_levels = int(env.get("RETH_TPU_SUBTRIE_LEVELS", "0") or 8)
        self.subtrie_levels = max(1, int(subtrie_levels))
        self.warmup = warmup
        self.window_dispatches = 0
        self.supervisor = supervisor
        if self.device.type == "cuda":
            from .supervisor import load_kernels

            load_kernels(self.device)  # kernels 1 and 4; a failed build raises here
        if backend is None:
            if supervisor is not None:
                from .supervisor import SupervisedHasher

                backend = SupervisedHasher(supervisor, min_tier=min_tier, device=self.device)
            else:
                from .keccak import KeccakDevice

                backend = KeccakDevice(min_tier=min_tier, block_tier=4,
                                       device=self.device).hash_batch
        self._backend = backend
        from .supervisor import SupervisedHasher

        # faults replay on the twin only where a supervisor accounts for them
        self.replays_faults = supervisor is not None or isinstance(backend, SupervisedHasher)
        if cpu_hasher is None:
            from ..primitives.keccak import keccak256_batch_np

            cpu_hasher = keccak256_batch_np
        self._cpu = cpu_hasher
        self.window_s = float(window_s if window_s is not None
                              else env.get("RETH_TPU_SERVICE_WINDOW", "0.002"))
        self.fill_target = int(fill_target or env.get("RETH_TPU_SERVICE_FILL", 0) or min_tier)
        self.max_batch = int(max_batch or 8 * self.fill_target)
        self.injector = injector if injector is not None else ServiceFaultInjector.from_env()
        cap = int(lane_capacity or env.get("RETH_TPU_SERVICE_LANE_CAP", 0) or 262144)
        if self.injector is not None and self.injector.queue_cap:
            cap = self.injector.queue_cap
        self.lane_capacity = cap
        self.age_promote_s = float(age_promote_s if age_promote_s is not None
                                   else env.get("RETH_TPU_SERVICE_AGE_PROMOTE", "0.05"))
        self.lease_bypass_s = float(lease_bypass_s if lease_bypass_s is not None
                                    else env.get("RETH_TPU_SERVICE_LEASE_BYPASS", "0.02"))
        self.min_tier = min_tier
        self.metrics = HashServiceMetrics(registry)
        # the member mesh: partition-rule routing, per-member breakers,
        # sub-mesh leases
        self.mesh = mesh
        self._mesh_hasher = None
        self.breaker_board = breaker_board
        self.device_injector = device_injector
        self.rebuild_devices = rebuild_devices
        if mesh is not None:
            self._mesh_hasher = MeshKeccak(mesh, min_tier=min_tier, block_tier=4, warmup=warmup)
            if breaker_board is None:
                from .supervisor import DeviceBreakerBoard

                self.breaker_board = DeviceBreakerBoard(mesh)
            if device_injector is None:
                from .supervisor import FaultInjector

                self.device_injector = FaultInjector.from_env()
            if rebuild_devices is None:
                self.rebuild_devices = int(env.get("RETH_TPU_MESH_REBUILD_DEVICES", 0)
                                           or max(1, mesh.n_devices // 2))
        self._submesh = None  # the sub-mesh lease a rebuild holds
        self._cond = threading.Condition()
        self._queues: dict[str, list] = {lane: [] for lane in LANES}
        self._queued_msgs: dict[str, int] = {lane: 0 for lane in LANES}
        self._waits = {lane: collections.deque(maxlen=_WAITS_KEPT) for lane in LANES}
        self._stopping = False
        self._leased = False
        self._lease_what: str | None = None
        self._dispatching = False
        # counters surfaced by snapshot() (the metrics hold the detail)
        self.dispatches = 0
        self.coalesced_requests = 0
        self.hashed_msgs = 0
        self.replays = 0
        self.rejects = 0
        self.leases = 0
        self.lease_bypasses = 0
        self.build_failures = 0
        self.failed_dispatches = 0  # unsupervised faults raised to the callers
        self.submesh_leases = 0
        self.pipeline_leases = 0
        self.mesh_sharded = 0
        self.mesh_single = 0
        self.mesh_replays = 0
        self._thread = threading.Thread(target=self._run, daemon=True, name="hash-service")
        self._thread.start()

    # -- shared instance (one service per process) ----------------------------

    _shared: "HashService | None" = None
    _shared_lock = threading.Lock()

    @classmethod
    def shared(cls, **kw) -> "HashService":
        with cls._shared_lock:
            if cls._shared is None:
                cls._shared = cls(**kw)
            return cls._shared

    @classmethod
    def reset_shared(cls) -> None:
        with cls._shared_lock:
            svc, cls._shared = cls._shared, None
        if svc is not None:
            svc.stop()

    # -- client API -------------------------------------------------------------

    def client(self, lane: str) -> HashClient:
        return HashClient(self, lane)

    def _enqueue(self, req, n: int, block: bool, timeout: float | None) -> HashFuture:
        """Queue ``req`` (``n`` messages of its lane's capacity), waiting for
        room unless ``block`` is False. A request larger than the lane is
        admitted alone."""
        lane = req.lane
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                if self._stopping:
                    raise ServiceStopped("hash service is stopping")
                room = self.lane_capacity - self._queued_msgs[lane]
                if n <= room or not self._queues[lane]:
                    break
                if not block:
                    self.rejects += 1
                    self.metrics.record_reject(lane)
                    raise LaneOverloaded(f"lane {lane!r} is full "
                                         f"({self._queued_msgs[lane]}/{self.lane_capacity} msgs)")
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    self.rejects += 1
                    self.metrics.record_reject(lane)
                    raise LaneOverloaded(f"lane {lane!r} still full after {timeout}s")
                self._cond.wait(remaining)
            self._queues[lane].append(req)
            self._queued_msgs[lane] += n
            self.metrics.record_submit(lane, n)
            self.metrics.set_queue_depth(lane, self._queued_msgs[lane])
            self._cond.notify_all()
        return req.future

    def submit(self, lane: str, msgs: list[bytes], *, block: bool = True,
               timeout: float | None = None) -> HashFuture:
        """Queue one request on ``lane``. A full lane blocks the caller
        (bounded-queue backpressure) unless ``block=False``, which raises
        :class:`LaneOverloaded`."""
        if lane not in _LANE_INDEX:
            raise ValueError(f"unknown lane {lane!r} (have {LANES})")
        req = _Request(lane, msgs)
        if not msgs:
            req.future._complete(result=[])
            return req.future
        return self._enqueue(req, len(msgs), block, timeout)

    def hash(self, lane: str, msgs: list[bytes]) -> list[bytes]:
        """Submit and wait: the ``hasher`` protocol's path."""
        return self.submit(lane, msgs).result()

    def submit_window(self, lane: str, window: list[dict], max_slots: int, *, fetch=None,
                      block: bool = True, timeout: float | None = None) -> HashFuture:
        """Queue one k-level window on ``lane``: level dicts, deepest first
        (``{"flat", "row_off", "row_len", "slots", "holes", "b_tier"}`` or
        ``{"kind": "branch", "masks", "slots", "children"}``). The
        dispatcher runs it alone through a k-level engine and completes the
        future with the digest buffer (or the ``fetch`` slots); it takes
        ``rows`` messages of the lane's capacity."""
        if lane not in _LANE_INDEX:
            raise ValueError(f"unknown lane {lane!r} (have {LANES})")
        req = _WindowRequest(lane, window, max_slots, fetch=fetch)
        if not window:
            req.future._complete(result=[])
            return req.future
        return self._enqueue(req, req.rows, block, timeout)

    # -- exclusive lease ----------------------------------------------------------

    @contextmanager
    def lease(self, what: str = "rebuild", devices: int | None = None):
        """Device lease for a rebuild commit.

        **Exclusive** (no mesh, or a mesh that cannot spare ``devices``
        members and keep one): coalesced dispatching pauses until release
        (an in-flight dispatch drains first); queued requests that age past
        ``lease_bypass_s`` are hashed on the numpy twin meanwhile.

        **Sub-mesh** (a mesh; ``devices`` defaults to ``rebuild_devices``):
        the rebuild claims ``devices`` members (``rebuild_mesh()`` names
        them to its engine factory) while coalesced dispatching goes on over
        the live members left: nothing pauses, nothing bypasses."""
        if devices is None and self.mesh is not None:
            devices = self.rebuild_devices
        if self.mesh is not None and devices:
            t0 = time.monotonic()
            sub = None
            with self._cond:
                while self._leased or self._submesh is not None:
                    self._cond.wait()
                try:
                    sub = self.mesh.lease_submesh(devices, what=what)
                except MeshExhausted:
                    pass  # too few live members: the exclusive lease below
                else:
                    self._submesh = sub
                    self._lease_what = what
                    self.leases += 1
                    self.submesh_leases += 1
            if sub is not None:
                self.metrics.record_lease(time.monotonic() - t0)
                try:
                    yield self
                finally:
                    with self._cond:
                        sub.release()
                        self._submesh = None
                        self._lease_what = None
                        self._cond.notify_all()
                return
        t0 = time.monotonic()
        with self._cond:
            while self._leased or self._submesh is not None or self._dispatching:
                self._cond.wait()
            self._leased = True
            self._lease_what = what
            self.leases += 1
        self.metrics.record_lease(time.monotonic() - t0)
        try:
            yield self
        finally:
            with self._cond:
                self._leased = False
                self._lease_what = None
                self._cond.notify_all()

    def rebuild_mesh(self):
        """The ``Mesh`` leased to the rebuild now (None outside a sub-mesh
        lease): what ``TurboCommitter``'s engine factory forms over."""
        sub = self._submesh
        return sub.mesh if sub is not None else None

    def lease_backend(self, inner=None, *, factory=None) -> LeasedTurboBackend:
        """Wrap a turbo engine (or its ``factory``, called once the lease is
        held) so one commit holds the lease from ``begin`` to its terminal
        fetch."""
        return LeasedTurboBackend(self, inner, factory=factory)

    def pipeline_lease(self, devices: int | None = None):
        """The import pipeline's double-buffer sub-mesh: ``devices`` members
        (default half the mesh) for the speculative block's key prehash,
        taken at once or not at all (None: no mesh, or too few live
        members to leave the commit side one). Never pauses the lanes."""
        if self.mesh is None or self._mesh_hasher is None:
            return None
        k = int(devices) if devices else max(1, self.mesh.n_devices // 2)
        try:
            sub = self.mesh.lease_submesh(k, what="pipeline")
        except MeshExhausted:
            return None
        self.pipeline_leases += 1
        return PipelineLease(self, sub)

    # -- dispatcher ---------------------------------------------------------------

    def _total_queued(self) -> int:
        return sum(self._queued_msgs.values())

    def _drain_locked(self, now: float) -> list:
        """The next coalesced batch (the caller holds the lock): aged
        requests first (FIFO), then lanes in priority order, whole requests,
        up to ``max_batch`` messages (at least one request). A window
        request dispatches alone."""
        aged = [r for lane in LANES for r in self._queues[lane]
                if now - r.enqueued_at >= self.age_promote_s]
        aged.sort(key=lambda r: r.enqueued_at)
        aged_ids = {id(r) for r in aged}
        order = aged + [r for lane in LANES for r in self._queues[lane] if id(r) not in aged_ids]
        batch: list = []
        total = 0
        if order and order[0].window is not None:
            batch = [order[0]]
        else:
            for r in order:
                if r.window is not None:
                    continue  # the next round leads with it
                if batch and total + len(r.msgs) > self.max_batch:
                    break
                batch.append(r)
                total += len(r.msgs)
        taken = {id(r) for r in batch}
        for lane in LANES:
            kept = [r for r in self._queues[lane] if id(r) not in taken]
            if len(kept) != len(self._queues[lane]):
                removed = sum(_req_msgs(r) for r in self._queues[lane] if id(r) in taken)
                self._queues[lane] = kept
                self._queued_msgs[lane] -= removed
                self.metrics.set_queue_depth(lane, self._queued_msgs[lane])
        if batch:
            self._cond.notify_all()  # wake submitters blocked on capacity
        return batch

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._stopping and self._total_queued() == 0:
                    self._cond.wait()
                if self._stopping and self._total_queued() == 0:
                    return
                # coalescing window: gather until the fill target or the
                # oldest request's deadline
                while not self._stopping:
                    now = time.monotonic()
                    oldest = min(r.enqueued_at for lane in LANES for r in self._queues[lane])
                    if self._leased:
                        # leased: requests that outwait the grace period go
                        # to the numpy twin
                        wait = (oldest + self.lease_bypass_s) - now
                        if wait <= 0:
                            batch = self._drain_locked(now)
                            bypass = True
                            break
                        self._cond.wait(wait)
                        continue
                    deadline = oldest + self.window_s
                    pending = sum(len(q) for q in self._queues.values())
                    # a lone request dispatches at once; the window gathers
                    # only once a second one is pending
                    if (pending == 1 or self._total_queued() >= self.fill_target
                            or now >= deadline):
                        batch = self._drain_locked(now)
                        bypass = False
                        break
                    self._cond.wait(deadline - now)
                else:
                    # stopping: drain what is left (on the twin if leased)
                    batch = self._drain_locked(time.monotonic())
                    bypass = self._leased
                if not batch:
                    continue
                self._dispatching = not bypass
            try:
                self._dispatch(batch, bypass)
            finally:
                if not bypass:
                    with self._cond:
                        self._dispatching = False
                        self._cond.notify_all()

    def _mesh_dispatch(self, msgs: list[bytes], lane: str) -> list[bytes]:
        """One coalesced batch over the mesh, with partial-mesh degradation:
        the partition rules pick the sharded or the one-member route; a
        failed dispatch feeds the per-member breakers (an attributed wedge
        sheds its member at once) and the SAME batch replays on the shrunken
        mesh (hashing is stateless, so the replay is bit-identical). Raises
        :class:`MeshExhausted` when no member is left (the caller's numpy
        replay is the final rung), and a real kernel fault at once."""
        board = self.breaker_board
        program = "keccak.scalar" if len(msgs) == 1 else "keccak.masked"
        attempts = 0
        while True:
            if board is not None:
                board.poll()  # cooled-down members rejoin (trial by fire)
            spec, mesh = self.mesh.spec_for(lane, program, len(msgs))
            if mesh is None:
                raise MeshExhausted("no live mesh device (all breakers open or leased)")
            indices = mesh.indices
            try:
                if self.device_injector is not None:
                    self.device_injector.on_mesh_dispatch(indices)
                out = self._mesh_hasher.hash_sharded(msgs, mesh)
            except BaseException as e:  # noqa: BLE001 — shed and replayed, or raised
                if is_kernel_fault(e):
                    raise
                attempts += 1
                idx = getattr(e, "device_index", None)
                if board is None or attempts > self.mesh.n_devices + 1:
                    raise
                if idx is not None:
                    board.record_failure(idx, attributed=True)
                else:
                    # no attribution: every participant is suspect (thresholded)
                    for i in indices:
                        board.record_failure(i)
                self.mesh_replays += 1
                self.mesh.metrics.record_replay()
                tracing.event("ops::hash_service", "mesh_replay", msgs=len(msgs), shed=idx,
                              error=type(e).__name__, live=self.mesh.healthy_count)
                continue
            if board is not None:
                board.record_success(indices)
            if len(spec) and len(indices) > 1:
                self.mesh_sharded += 1
                self.mesh.metrics.record_sharded()
            else:
                self.mesh_single += 1
                self.mesh.metrics.record_single()
            return out

    def _window_engine(self, lane: str = "live", rows: int = 0):
        """The k-level engine of one window dispatch: on the service's
        device, or with a mesh over the members the partition rules pick for
        ("fused.subtrie", ``rows``)."""
        from .fused_commit import SubtrieFusedEngine, SubtrieMeshEngine

        if self.mesh is not None:
            if self.breaker_board is not None:
                self.breaker_board.poll()
            _spec, mesh = self.mesh.spec_for(lane, "fused.subtrie", rows)
            if mesh is None:
                raise MeshExhausted("no live mesh device (all breakers open or leased)")
            return SubtrieMeshEngine(mesh, min_tier=self.min_tier, k=self.subtrie_levels,
                                     warmup=self.warmup)
        return SubtrieFusedEngine(min_tier=self.min_tier, k=self.subtrie_levels,
                                  warmup=self.warmup, device=self.device)

    @staticmethod
    def _run_window_on(engine, req: _WindowRequest):
        engine.begin(req.max_slots)
        for lv in req.window:
            if lv.get("kind") == "branch":
                engine.dispatch_branch(lv["masks"], lv["slots"], lv["children"])
            else:
                engine.dispatch_packed(lv["flat"], lv["row_off"], lv["row_len"], lv["slots"],
                                       lv.get("holes"), lv["b_tier"])
        if req.fetch is not None:
            return engine.fetch_slots(np.asarray(req.fetch, dtype=np.int64))
        return engine.finish()

    def _replayable(self, err: BaseException) -> bool:
        """A fault the twin replays: an exhausted mesh (its final rung), or a
        launch, copy or sync fault (a ``RuntimeError``, not a build failure)
        on a supervised service."""
        if isinstance(err, MeshExhausted):
            return True
        return (self.replays_faults and isinstance(err, RuntimeError)
                and not isinstance(err, BuildError))

    def _fail(self, requests: list, err: BaseException) -> None:
        """Fail the futures with ``err``, no replay: a build failure, or a
        fault that is not replayable."""
        if isinstance(err, BuildError):
            self.build_failures += 1
        else:
            self.failed_dispatches += 1
        tracing.event("ops::hash_service", "dispatch_failed", requests=len(requests),
                      error=f"{type(err).__name__}: {str(err)[:200]}")
        for r in requests:
            r.future._complete(error=err)

    def _record_waits(self, requests: list, t0: float) -> None:
        for r in requests:
            wait = t0 - r.enqueued_at
            self.metrics.record_wait(r.lane, wait)
            self._waits[r.lane].append(wait)

    def _dispatch_window(self, req: _WindowRequest, bypass: bool) -> None:
        """One window as one k-level engine commit. Bypass (leased) and a
        replayable fault land on the numpy twin: the replay is exact, the
        future completes once. Any other fault fails the future."""
        t0 = time.monotonic()
        self._record_waits([req], t0)
        replayed = False
        replay_err = None
        digests = None
        if not bypass:
            try:
                if self.injector is not None:
                    self.injector.on_dispatch()
                digests = self._run_window_on(self._window_engine(req.lane, req.rows), req)
            except BaseException as e:  # noqa: BLE001 — replayed or raised to the caller
                if not self._replayable(e):
                    self._fail([req], e)
                    return
                replayed = True
                replay_err = type(e).__name__
                self.replays += 1
                self.metrics.record_replay()
        else:
            self.lease_bypasses += 1
            self.metrics.record_lease_bypass()
        if digests is None:
            from ..trie.turbo import _NumpyBackend

            try:
                digests = self._run_window_on(_NumpyBackend(), req)
            except BaseException as e:  # pragma: no cover - twin failure
                req.future._complete(error=e)
                raise
        service_s = time.monotonic() - t0
        req.future._complete(result=digests)
        if replayed:
            tracing.event("ops::hash_service", "window_replay", levels=len(req.window),
                          rows=req.rows, error=replay_err)
        self.dispatches += 1
        self.window_dispatches += 1
        self.coalesced_requests += 1
        self.hashed_msgs += req.rows
        now_wall = time.time()
        if req.ctx is not None:
            tracing.record_span("ops::hash_service", "hashsvc.window", req.wall_at,
                                now_wall - req.wall_at, ctx=req.ctx,
                                fields={"lane": req.lane, "levels": len(req.window),
                                        "rows": req.rows,
                                        "service_ms": round(service_s * 1e3, 3),
                                        "replayed": replayed, "bypass": bypass})
        tracing.record_span("ops::hash_service",
                            "hashsvc.replay" if replayed
                            else ("hashsvc.bypass" if bypass else "hashsvc.dispatch"),
                            now_wall - service_s, service_s,
                            fields={"requests": 1, "msgs": req.rows, "levels": len(req.window)})
        self.metrics.record_dispatch(requests=1, msgs=req.rows, occupancy=1.0,
                                     service_s=service_s, replayed=replayed)

    def _dispatch(self, batch: list, bypass: bool) -> None:
        """ONE backend call for the whole coalesced batch; the digests are
        scattered back through the futures. A replayable fault replays the
        entire batch on the numpy twin; any other error fails the batch's
        futures."""
        if len(batch) == 1 and batch[0].window is not None:
            self._dispatch_window(batch[0], bypass)
            return
        msgs: list[bytes] = []
        for r in batch:
            msgs.extend(r.msgs)
        t0 = time.monotonic()
        self._record_waits(batch, t0)
        replayed = False
        replay_err = None
        try:
            if bypass:
                self.lease_bypasses += 1
                self.metrics.record_lease_bypass()
                digests = self._cpu(msgs)
            else:
                if self.injector is not None:
                    self.injector.on_dispatch()
                if self.mesh is not None:
                    digests = self._mesh_dispatch(msgs, batch[0].lane)
                else:
                    digests = self._backend(msgs)
        except BaseException as first_error:  # noqa: BLE001 — replayed or raised to the callers
            if bypass or not self._replayable(first_error):
                self._fail(batch, first_error)
                return
            replayed = True
            replay_err = type(first_error).__name__
            self.replays += 1
            self.metrics.record_replay()
            try:
                digests = self._cpu(msgs)
            except BaseException as e:  # pragma: no cover - twin failure
                for r in batch:
                    r.future._complete(error=e)
                raise first_error
        service_s = time.monotonic() - t0
        if replayed:
            tracing.event("ops::hash_service", "replay", requests=len(batch), msgs=len(msgs),
                          error=replay_err)
        off = 0
        now_wall = time.time()
        for r in batch:
            r.future._complete(result=digests[off:off + len(r.msgs)])
            off += len(r.msgs)
            # per-request attribution under the submitter's trace
            if r.ctx is not None:
                tracing.record_span("ops::hash_service", "hashsvc.request", r.wall_at,
                                    now_wall - r.wall_at, ctx=r.ctx,
                                    fields={"lane": r.lane, "msgs": len(r.msgs),
                                            "wait_ms": round((t0 - r.enqueued_at) * 1e3, 3),
                                            "service_ms": round(service_s * 1e3, 3),
                                            "coalesced_with": len(batch),
                                            "replayed": replayed, "bypass": bypass})
        self.dispatches += 1
        self.coalesced_requests += len(batch)
        self.hashed_msgs += len(msgs)
        occupancy = len(msgs) / _next_tier(len(msgs), max(1, self.min_tier))
        tracing.record_span("ops::hash_service",
                            "hashsvc.replay" if replayed
                            else ("hashsvc.bypass" if bypass else "hashsvc.dispatch"),
                            now_wall - service_s, service_s,
                            fields={"requests": len(batch), "msgs": len(msgs),
                                    "occupancy": round(occupancy, 4)})
        self.metrics.record_dispatch(requests=len(batch), msgs=len(msgs), occupancy=occupancy,
                                     service_s=service_s, replayed=replayed)

    # -- lifecycle / observability --------------------------------------------------

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the dispatcher and join its thread (before the process tears
        CUDA down). ``drain=True`` completes everything still queued first;
        ``drain=False`` fails pending futures with :class:`ServiceStopped`."""
        with self._cond:
            self._stopping = True
            if not drain:
                for lane in LANES:
                    for r in self._queues[lane]:
                        r.future._complete(error=ServiceStopped("hash service stopped"))
                    self._queues[lane].clear()
                    self._queued_msgs[lane] = 0
                    self.metrics.set_queue_depth(lane, 0)
            self._cond.notify_all()
        self._thread.join(timeout)

    def coalesce_factor(self) -> float:
        """Requests per dispatch (lifetime average): > 1 means small client
        batches really fused."""
        return self.coalesced_requests / self.dispatches if self.dispatches else 0.0

    def lane_waits(self) -> dict:
        """Each lane's queue waits so far (the last 65,536): count, p50 and
        p99 in milliseconds."""
        out = {}
        for lane in LANES:
            w = np.array(self._waits[lane], dtype=np.float64)
            out[lane] = {"n": int(w.size),
                         "p50_ms": round(float(np.percentile(w, 50)) * 1e3, 3) if w.size else None,
                         "p99_ms": round(float(np.percentile(w, 99)) * 1e3, 3) if w.size else None}
        return out

    def snapshot(self) -> dict:
        """State for dashboards and triage."""
        with self._cond:
            queued = dict(self._queued_msgs)
            leased = self._lease_what
            sub = self._submesh
        out = {
            "queued": queued,
            "queued_total": sum(queued.values()),
            "dispatches": self.dispatches,
            "window_dispatches": self.window_dispatches,
            "coalesce_factor": round(self.coalesce_factor(), 2),
            "hashed_msgs": self.hashed_msgs,
            "replays": self.replays,
            "rejects": self.rejects,
            "leases": self.leases,
            "lease_bypasses": self.lease_bypasses,
            "leased_by": leased,
            "fault_injection": self.injector.active() if self.injector is not None else False,
        }
        if self.mesh is not None:
            out["mesh"] = {**self.mesh.snapshot(), "sharded_dispatches": self.mesh_sharded,
                           "single_dispatches": self.mesh_single,
                           "mesh_replays": self.mesh_replays,
                           "submesh_leases": self.submesh_leases,
                           "submesh_held": list(sub.indices) if sub is not None else None,
                           "pipeline_leases": self.pipeline_leases}
            if self.device_injector is not None:
                out["fault_injection"] = out["fault_injection"] or self.device_injector.active()
        return out
