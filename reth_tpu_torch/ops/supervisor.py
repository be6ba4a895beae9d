"""Device supervisor: the health probe, the circuit breaker, watchdog-bounded
device calls and the mid-commit failover onto the CPU twin.

Port of the JAX package's ``ops/supervisor.py`` (the ``--hasher auto``
route), with the same policies, counters and fault knobs:

- **Health probe** (:func:`probe_device`): a child process that loads kernel
  1's library and hashes ``keccak256(b"")`` through ``KeccakDevice`` on the
  card under a hard wall-clock budget. A wedged card wedges the child, never
  the caller, and the child gets a CUDA context of its own.
- **Circuit breaker** (:class:`CircuitBreaker`): closed, open, half-open,
  with exponential backoff; while open, hashing routes to the numpy twin
  (``trie/turbo._NumpyBackend``, ``keccak256_batch_np``).
- **Watchdog** (:meth:`DeviceSupervisor.run_guarded`): every device call
  runs in a worker thread under a budget; a trip abandons the thread and
  fails over.
- **Journaled failover** (:class:`SupervisedBackend`): each call's host
  arguments are journaled, and a failed call replays the journal on the
  numpy twin, so the commit resumes on the CPU at the same level boundary
  and still produces its root. :class:`SupervisedHasher` re-runs a failed
  batch on the numpy hasher.
- **Fault injection** (:class:`FaultInjector`): the six
  ``RETH_TPU_FAULT_*`` knobs of the reference, parsed as it parses them.
- **Warm-up gate** (``ops/warmup.py``): a ``WarmupManager`` built with
  ``supervisor=`` attaches itself as ``DeviceSupervisor.warmup``; a
  supervised fused commit stays on the twin until every menu shape is warm
  (:meth:`DeviceSupervisor.warmup_allows_device`), ``SupervisedHasher``'s
  ``KeccakDevice`` routes each un-warm bucket to the host, and a half-open
  probe that closes the breaker re-runs the FAILED shapes.

Two facts of CUDA shape the port:

- The build is not a device fault. Each supervised path loads its kernel
  libraries (:func:`load_kernels`) before its first guarded call, outside
  the watchdog, so a missing ``nvcc`` or a failed build raises to the
  caller; only faults in a launch, copy or sync feed the breaker.
- A device fault can poison the process's CUDA context. The CPU twin
  touches no CUDA tensor, and the half-open probe runs in a child, which
  has a fresh context: it can close the breaker while the parent's context
  is still dead, and the next device commit then trips again (the
  reference's breaker policy, kept as it is).

The member mesh (``parallel/mesh.py``) has its own middle rung:
:class:`DeviceBreakerBoard`, one breaker a member, and
``FaultInjector.on_mesh_dispatch`` (``RETH_TPU_FAULT_DEVICE_WEDGE``), which
wedges a named member so that the meshed hash service sheds it and replays
the batch on the survivors. A real kernel fault on the mesh
(``_build.is_kernel_fault``) is not shed: it raises, as everywhere else in
the port. On a roster that names one card more than once every member
shares that card's CUDA context, where a fault is sticky, so shedding one
member would only hide it.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

import torch

from .. import tracing
from ..device import resolve
from ..metrics import SupervisorMetrics
from . import _build

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# keccak256(b"")
EMPTY_DIGEST_HEX = "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"

# the child: the port on sys.path (the node may run from anywhere), kernel 1's
# library loaded (never built: the parent builds it before probing), one
# message hashed on the card and checked against its known digest
PROBE_CODE = (
    "import sys\n"
    f"sys.path.insert(0, {str(_build.PKG_DIR.parent)!r})\n"
    "import torch\n"
    "from reth_tpu_torch.ops import _build\n"
    "from reth_tpu_torch.ops.keccak import KeccakDevice\n"
    "dev = KeccakDevice(device='cuda')\n"
    "if not _build.library_path(_build.CUDA_SRC_DIR / 'keccak.cu').exists():\n"
    "    sys.exit('keccak.cu is not built: the probe loads kernel 1, it does not build it')\n"
    "digest = dev.hash_batch([b''])[0]\n"
    "torch.cuda.synchronize()\n"
    f"if digest.hex() != {EMPTY_DIGEST_HEX!r}:\n"
    "    sys.exit('kernel 1 hashed b\"\" to ' + digest.hex())\n"
    "print('PROBE_OK', 'cuda', torch.cuda.get_device_name(0), flush=True)\n"
)


def load_kernels(device, sources=_build.KERNEL_SOURCES) -> None:
    """Build (where missing, one ``nvcc`` per source, all at once) and load
    the kernel libraries ``sources`` that the device route on ``device``
    launches. The supervised paths call this before their first guarded
    call, so a failed build raises here instead of feeding the breaker. On
    the CPU the kernels' plain versions run and nothing is loaded."""
    if torch.device(device).type != "cuda":
        return
    _build.build([_build.CUDA_SRC_DIR / s for s in sources])
    for s in sources:
        _build.load_kernel(s)


class DeviceDispatchError(RuntimeError):
    """A supervised device call failed or exceeded its watchdog budget."""


class InjectedWedge(DeviceDispatchError):
    """Fault injection wedged this dispatch (RETH_TPU_FAULT_WEDGE_EVERY)."""


class InjectedDeviceWedge(DeviceDispatchError):
    """Fault injection wedged one mesh member (RETH_TPU_FAULT_DEVICE_WEDGE);
    carries its roster index, so the per-member breaker can attribute the
    failure and shrink the mesh around it."""

    def __init__(self, device_index: int, msg: str):
        super().__init__(msg)
        self.device_index = device_index


class InjectedPipelineAbort(RuntimeError):
    """Fault injection killed the rebuild pipeline at a window boundary
    (RETH_TPU_FAULT_PIPELINE_ABORT). Not a DeviceDispatchError: it aborts
    the whole commit instead of failing over."""


class ProbeResult:
    __slots__ = ("ok", "latency", "diag")

    def __init__(self, ok: bool, latency: float, diag: str | None = None):
        self.ok = ok
        self.latency = latency
        self.diag = diag

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "ok" if self.ok else f"FAIL ({self.diag})"
        return f"ProbeResult({state}, {self.latency:.3f}s)"


def probe_device(budget: float | None = None, *, code: str = PROBE_CODE,
                 injector: "FaultInjector | None" = None,
                 cache_dir: str | None = None) -> ProbeResult:
    """One fail-fast health probe: run ``code`` in a child process under a
    hard wall-clock ``budget`` (default ``RETH_TPU_PROBE_TIMEOUT``, 120 s).
    Returns a :class:`ProbeResult`; never raises and never blocks past the
    budget. ``cache_dir`` (warm-up's compile-cache check) makes the child
    load its kernel libraries from that directory (``ops/warmup.py
    CompileCache``), so a directory that does not load fails the child."""
    if cache_dir is not None:
        code = ("import sys\n"
                f"sys.path.insert(0, {str(_build.PKG_DIR.parent)!r})\n"
                "from reth_tpu_torch.ops import _build\n"
                f"_build.set_kernel_dir({str(cache_dir)!r})\n" + code)
    if budget is None:
        budget = float(os.environ.get("RETH_TPU_PROBE_TIMEOUT", "120"))
    t0 = time.monotonic()
    if injector is not None and not injector.on_probe():
        tracing.fault_event("RETH_TPU_FAULT_PROBE_FAIL", target="ops::supervisor")
        return ProbeResult(False, time.monotonic() - t0,
                           "injected probe failure (RETH_TPU_FAULT_PROBE_FAIL)")
    try:
        r = subprocess.run([sys.executable, "-u", "-c", code],
                           capture_output=True, text=True, timeout=budget)
    except subprocess.TimeoutExpired:
        diag = f"device probe exceeded {budget}s (wedged card?)"
        tracing.event("ops::supervisor", "probe", ok=False,
                      latency_s=round(time.monotonic() - t0, 3), diag=diag)
        return ProbeResult(False, time.monotonic() - t0, diag)
    except OSError as e:  # pragma: no cover - exec failure
        return ProbeResult(False, time.monotonic() - t0, f"probe spawn failed: {e}")
    latency = time.monotonic() - t0
    if r.returncode == 0 and "PROBE_OK" in r.stdout:
        tracing.event("ops::supervisor", "probe", ok=True, latency_s=round(latency, 3))
        return ProbeResult(True, latency)
    tail = (r.stderr or r.stdout).strip().splitlines()[-1:] or ["no output"]
    diag = f"device probe failed rc={r.returncode}: {tail[0][:300]}"
    tracing.event("ops::supervisor", "probe", ok=False, latency_s=round(latency, 3), diag=diag)
    return ProbeResult(False, latency, diag)


def probe_device_retrying(budget: float | None = None, attempts: int | None = None,
                          gap: float | None = None, *,
                          injector: "FaultInjector | None" = None,
                          on_attempt=None) -> ProbeResult:
    """:func:`probe_device` up to ``attempts`` times (``RETH_TPU_PROBE_ATTEMPTS``,
    4), ``gap`` seconds apart (``RETH_TPU_PROBE_GAP``, 45); ``on_attempt(i,
    attempts)`` is called before each."""
    if attempts is None:
        attempts = int(os.environ.get("RETH_TPU_PROBE_ATTEMPTS", "4"))
    if gap is None:
        gap = float(os.environ.get("RETH_TPU_PROBE_GAP", "45"))
    result = ProbeResult(False, 0.0, "no probe attempts ran")
    for i in range(1, max(attempts, 1) + 1):
        if on_attempt is not None:
            on_attempt(i, attempts)
        result = probe_device(budget, injector=injector)
        if result.ok:
            return result
        if i < attempts:
            time.sleep(gap)
    return result


class FaultInjector:
    """Dispatch and probe fault policies.

    ``wedge_every``: every Nth supervised device call raises
    :class:`InjectedWedge` (a watchdog trip); 1 wedges every call.
    ``delay``: seconds added to every call inside its worker thread; above
    the watchdog budget it drives the real timeout path. ``probe_fail``: the
    first N probes fail (negative: every probe). ``pipeline_abort``: the Nth
    rebuild window raises :class:`InjectedPipelineAbort`. ``compile_wedge``:
    the first N warm-up steps (negative: every one) sleep well past their
    watchdog budget (:meth:`on_compile`), the warm-up retry and breaker
    drill. ``device_wedge``: a set of mesh member (roster) indices; any mesh
    dispatch whose live members still include one of them raises
    :class:`InjectedDeviceWedge`, attributed to it (:meth:`on_mesh_dispatch`),
    the per-member breaker and shrunken-mesh replay drill; wedging every
    index drills the final numpy rung.

    Env form (:meth:`from_env`): ``RETH_TPU_FAULT_WEDGE_EVERY`` /
    ``RETH_TPU_FAULT_DELAY`` / ``RETH_TPU_FAULT_PROBE_FAIL`` /
    ``RETH_TPU_FAULT_PIPELINE_ABORT`` / ``RETH_TPU_FAULT_COMPILE_WEDGE`` /
    ``RETH_TPU_FAULT_DEVICE_WEDGE`` (comma-separated device indices).
    """

    def __init__(self, wedge_every: int = 0, delay: float = 0.0, probe_fail: int = 0,
                 pipeline_abort: int = 0, compile_wedge: int = 0, device_wedge=()):
        self.wedge_every = wedge_every
        self.delay = delay
        self.probe_fail = probe_fail
        self.pipeline_abort = pipeline_abort
        self.compile_wedge = compile_wedge
        self.device_wedge = frozenset(int(i) for i in device_wedge)
        self.dispatch_count = 0
        self.wedged = 0
        self.probes_failed = 0
        self.windows = 0
        self.compiles_wedged = 0
        self.devices_wedged = 0
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls, env=None) -> "FaultInjector | None":
        """Build from the env knobs; None when no fault policy is set."""
        env = os.environ if env is None else env
        wedge = int(env.get("RETH_TPU_FAULT_WEDGE_EVERY", "0") or 0)
        delay = float(env.get("RETH_TPU_FAULT_DELAY", "0") or 0)
        probe = int(env.get("RETH_TPU_FAULT_PROBE_FAIL", "0") or 0)
        pabort = int(env.get("RETH_TPU_FAULT_PIPELINE_ABORT", "0") or 0)
        cwedge = int(env.get("RETH_TPU_FAULT_COMPILE_WEDGE", "0") or 0)
        raw = env.get("RETH_TPU_FAULT_DEVICE_WEDGE", "") or ""
        dwedge = tuple(int(x) for x in raw.split(",") if x.strip())
        if not (wedge or delay or probe or pabort or cwedge or dwedge):
            return None
        return cls(wedge_every=wedge, delay=delay, probe_fail=probe, pipeline_abort=pabort,
                   compile_wedge=cwedge, device_wedge=dwedge)

    def active(self) -> bool:
        return bool(self.wedge_every or self.delay or self.probe_fail or self.pipeline_abort
                    or self.compile_wedge or self.device_wedge)

    def on_mesh_dispatch(self, device_indices) -> None:
        """Called before every mesh dispatch with its live members' roster
        indices. If a wedged member still takes part, the dispatch fails,
        attributed to that member."""
        if not self.device_wedge:
            return
        hit = sorted(self.device_wedge.intersection(device_indices))
        if not hit:
            return
        with self._lock:
            self.devices_wedged += 1
        tracing.fault_event("RETH_TPU_FAULT_DEVICE_WEDGE", target="parallel::mesh",
                            device=hit[0], live=list(device_indices))
        raise InjectedDeviceWedge(hit[0], f"injected wedge on mesh device {hit[0]} "
                                          f"(live mesh {list(device_indices)})")

    def on_compile(self, budget: float) -> None:
        """Called inside every warm-up step's worker thread. A wedged step
        sleeps well past the caller's watchdog ``budget`` in the (abandoned)
        worker, so the real join-timeout path runs."""
        with self._lock:
            if self.compile_wedge == 0:
                return
            if self.compile_wedge > 0:
                self.compile_wedge -= 1
            self.compiles_wedged += 1
        tracing.fault_event("RETH_TPU_FAULT_COMPILE_WEDGE", target="ops::warmup",
                            compile=self.compiles_wedged)
        time.sleep(min(budget * 3 + 1, budget + 60))

    def on_pipeline_window(self) -> None:
        """Called by the rebuild pipeline before it dispatches each packed
        window; the Nth call aborts the commit."""
        if not self.pipeline_abort:
            return
        with self._lock:
            self.windows += 1
            n = self.windows
        if n == self.pipeline_abort:
            tracing.fault_event("RETH_TPU_FAULT_PIPELINE_ABORT", target="trie::pipeline",
                                window=n)
            raise InjectedPipelineAbort(
                f"injected pipeline abort at window #{n} "
                f"(RETH_TPU_FAULT_PIPELINE_ABORT={self.pipeline_abort})")

    def on_dispatch(self) -> None:
        """Called before every supervised device call, in its worker thread."""
        with self._lock:
            self.dispatch_count += 1
            n = self.dispatch_count
        if self.delay:
            time.sleep(self.delay)
        if self.wedge_every and n % self.wedge_every == 0:
            with self._lock:
                self.wedged += 1
            tracing.fault_event("RETH_TPU_FAULT_WEDGE_EVERY", target="ops::supervisor",
                                dispatch=n)
            raise InjectedWedge(f"injected wedge on dispatch #{n} (every {self.wedge_every})")

    def on_probe(self) -> bool:
        """True: let the probe run; False: an injected probe failure."""
        with self._lock:
            if self.probe_fail < 0:
                self.probes_failed += 1
                return False
            if self.probes_failed < self.probe_fail:
                self.probes_failed += 1
                return False
        return True


class CircuitBreaker:
    """closed → open → half-open breaker with exponential backoff.

    While CLOSED, failures accumulate; at ``failure_threshold`` consecutive
    failures the breaker OPENS for ``reset_timeout`` seconds (doubling per
    re-trip up to ``max_reset_timeout``). Once the cooldown elapses the
    breaker is HALF_OPEN: one trial (a health probe) decides — success
    closes it and resets the backoff, failure re-opens it with the doubled
    backoff.
    """

    def __init__(self, failure_threshold: int = 3, reset_timeout: float = 30.0,
                 max_reset_timeout: float = 600.0, clock=time.monotonic):
        self.failure_threshold = max(1, failure_threshold)
        self.base_reset_timeout = reset_timeout
        self.max_reset_timeout = max_reset_timeout
        self._clock = clock
        self._lock = threading.Lock()
        self.state = CLOSED
        self.failures = 0          # consecutive, while closed
        self.trips = 0             # times the breaker opened
        self._timeout = reset_timeout
        self._open_until = 0.0
        self.transitions: list[str] = [CLOSED]  # state history

    def _set_state(self, state: str) -> None:
        if state != self.state:
            prev, self.state = self.state, state
            self.transitions.append(state)
            if state == OPEN:
                # the device route just went dark: snapshot the flight recorder
                tracing.fault_event("breaker_open", target="ops::supervisor", state=state,
                                    previous=prev, trips=self.trips)
            else:
                tracing.event("ops::supervisor", "breaker", state=state, previous=prev,
                              trips=self.trips)

    def allow(self) -> bool:
        """May a device call proceed now? OPEN past its cooldown moves to
        HALF_OPEN (the caller then runs a trial probe)."""
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN and self._clock() >= self._open_until:
                self._set_state(HALF_OPEN)
            return self.state == HALF_OPEN

    def record_failure(self) -> bool:
        """Count one failure; True when this call opened the breaker (a
        HALF_OPEN failure re-opens with the doubled backoff)."""
        with self._lock:
            if self.state == HALF_OPEN:
                self.trips += 1
                self._timeout = min(self._timeout * 2, self.max_reset_timeout)
                self._open_until = self._clock() + self._timeout
                self._set_state(OPEN)
                return True
            self.failures += 1
            if self.state == CLOSED and self.failures >= self.failure_threshold:
                self.trips += 1
                self._open_until = self._clock() + self._timeout
                self._set_state(OPEN)
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self.failures = 0
            if self.state != CLOSED:
                self._timeout = self.base_reset_timeout
                self._set_state(CLOSED)

    def force_open(self) -> None:
        """Open at once (the startup probe failed: no point counting)."""
        with self._lock:
            if self.state != OPEN:
                self.trips += 1
                self._open_until = self._clock() + self._timeout
                self._set_state(OPEN)


class DeviceBreakerBoard:
    """Per-member circuit breakers over a ``parallel/mesh.py`` HashMesh: the
    middle rung of the ladder (member, shrunken mesh, numpy twin). One
    :class:`CircuitBreaker` a member; a trip sheds that member from the
    mesh's health mask (the in-flight batch replays on the survivors)
    instead of sending the whole node to the twin, which only happens once
    every member has tripped (:meth:`exhausted`).

    Recovery is trial by fire, as in the reference: :meth:`poll` re-admits a
    member whose open cooldown elapsed (half-open); the next clean dispatch
    that includes it closes its breaker, the next attributed failure
    re-opens it with doubled backoff. Defaults come from
    ``RETH_TPU_DEVICE_BREAKER_TRIPS`` (3) and ``RETH_TPU_DEVICE_BREAKER_RESET``
    (30 s)."""

    def __init__(self, mesh, failure_threshold: int | None = None,
                 reset_timeout: float | None = None, clock=time.monotonic):
        if failure_threshold is None:
            failure_threshold = int(os.environ.get("RETH_TPU_DEVICE_BREAKER_TRIPS", "3"))
        if reset_timeout is None:
            reset_timeout = float(os.environ.get("RETH_TPU_DEVICE_BREAKER_RESET", "30"))
        self.mesh = mesh
        self.breakers = [CircuitBreaker(failure_threshold=failure_threshold,
                                        reset_timeout=reset_timeout, clock=clock)
                         for _ in range(mesh.n_devices)]
        self.trips = 0

    def record_failure(self, idx: int, attributed: bool = False) -> bool:
        """Count one failure against member ``idx``: an ATTRIBUTED one (the
        error names the member, as an injected wedge does) opens its breaker
        at once, an unattributed one counts toward the threshold. True when
        this call shed the member."""
        b = self.breakers[idx]
        if attributed:
            b.force_open()
        else:
            b.record_failure()
        if b.state == OPEN and self.mesh.is_healthy(idx):
            self.trips += 1
            return self.mesh.mark_unhealthy(
                idx, reason="attributed wedge" if attributed else "unattributed dispatch failures")
        return False

    def record_success(self, indices) -> None:
        """A dispatch over ``indices`` completed: clear their failure counts
        and close any half-open breaker that just passed its trial."""
        for i in indices:
            self.breakers[i].record_success()

    def poll(self) -> int:
        """Re-admit members whose open cooldown elapsed; returns how many
        rejoined. Called before each mesh dispatch, so recovery needs no
        thread of its own."""
        rejoined = 0
        for i, b in enumerate(self.breakers):
            if not self.mesh.is_healthy(i) and b.allow():
                if self.mesh.mark_healthy(i):
                    rejoined += 1
        return rejoined

    def exhausted(self) -> bool:
        """No member is healthy: the caller takes the final rung."""
        return self.mesh.healthy_count == 0

    def snapshot(self) -> dict:
        states = [b.state for b in self.breakers]
        return {"devices": len(states), "open": sum(1 for s in states if s == OPEN),
                "half_open": sum(1 for s in states if s == HALF_OPEN), "trips": self.trips,
                "states": states}


class DeviceSupervisor:
    """Owns every device call on the state-commitment path.

    ``route()`` answers "device" or "numpy" for now, consulting the breaker
    and, once an open breaker's cooldown has elapsed, running one half-open
    probe whose outcome closes or re-opens it. ``run_guarded(fn, *args)``
    runs a device call in a worker thread under ``dispatch_budget`` seconds
    (``RETH_TPU_DISPATCH_BUDGET``, 120); a timeout abandons the thread and
    raises :class:`DeviceDispatchError` after informing the breaker. The
    breaker's defaults come from ``RETH_TPU_BREAKER_TRIPS`` (3) and
    ``RETH_TPU_BREAKER_RESET`` (30 s)."""

    def __init__(self, dispatch_budget: float | None = None, probe_budget: float | None = None,
                 breaker: CircuitBreaker | None = None, injector: FaultInjector | None = None,
                 probe_fn=None, registry=None):
        if dispatch_budget is None:
            dispatch_budget = float(os.environ.get("RETH_TPU_DISPATCH_BUDGET", "120"))
        self.dispatch_budget = dispatch_budget
        self.probe_budget = probe_budget
        self.breaker = breaker or CircuitBreaker(
            failure_threshold=int(os.environ.get("RETH_TPU_BREAKER_TRIPS", "3")),
            reset_timeout=float(os.environ.get("RETH_TPU_BREAKER_RESET", "30")))
        self.injector = injector if injector is not None else FaultInjector.from_env()
        self._probe_fn = probe_fn or probe_device
        self.metrics = SupervisorMetrics(registry)
        self.failovers = 0
        self.dispatch_timeouts = 0
        self.dispatch_errors = 0
        self.guarded_calls = 0  # worker threads started by run_guarded
        self.last_probe: ProbeResult | None = None
        self._probe_lock = threading.Lock()
        # the warm-up manager (ops/warmup.py) attaches itself here, so the
        # committers reach its per-shape states through their supervisor
        self.warmup = None
        self._publish()

    # -- shared instance (one supervisor per process) ------------------------

    _shared: "DeviceSupervisor | None" = None
    _shared_lock = threading.Lock()

    @classmethod
    def shared(cls) -> "DeviceSupervisor":
        with cls._shared_lock:
            if cls._shared is None:
                cls._shared = cls()
            return cls._shared

    @classmethod
    def reset_shared(cls) -> None:
        with cls._shared_lock:
            cls._shared = None

    # -- probes --------------------------------------------------------------

    def _probe(self) -> ProbeResult:
        result = self._probe_fn(self.probe_budget, injector=self.injector)
        self.last_probe = result
        self.metrics.record_probe(result.ok, result.latency)
        return result

    def startup(self) -> bool:
        """Startup health probe (``--hasher auto``): an unhealthy card opens
        the breaker at once, so the node starts on the CPU route. Where a
        card is present, the kernel libraries are built and loaded first,
        so the probe's child only loads kernel 1."""
        if torch.cuda.is_available():
            load_kernels("cuda")
        result = self._probe()
        if result.ok:
            self.breaker.record_success()
        else:
            self.breaker.force_open()
            self.metrics.record_trip()
        self._publish()
        return result.ok

    # -- routing -------------------------------------------------------------

    def route(self) -> str:
        """"device" | "numpy": where hashing should run now. A HALF_OPEN
        breaker runs one trial probe inline; its outcome decides the route
        and the breaker's next state."""
        if not self.breaker.allow():
            self._publish()
            return "numpy"
        if self.breaker.state == HALF_OPEN:
            with self._probe_lock:
                # another thread's probe may have closed or re-opened it
                if self.breaker.state == HALF_OPEN:
                    if self._probe().ok:
                        self.breaker.record_success()
                        if self.warmup is not None:
                            # the card is back: promote FAILED shapes
                            self.warmup.on_device_recovered()
                    else:
                        self.breaker.record_failure()
                        self.metrics.record_trip()
            self._publish()
            return "device" if self.breaker.state == CLOSED else "numpy"
        return "device"

    def allows_device(self) -> bool:
        return self.route() == "device"

    def warmup_allows_device(self) -> bool:
        """The commit-level warm-up gate: a fused commit's resident digest
        buffer cannot change backends at a shape boundary, so the whole
        commit stays on the twin until every menu shape is warm. True
        without a warm-up manager."""
        return self.warmup is None or self.warmup.device_ready()

    # -- watchdog-bounded dispatch -------------------------------------------

    def run_guarded(self, fn, *args, what: str = "dispatch", budget: float | None = None):
        """Run ``fn(*args)`` in a worker thread named ``supervised-<what>``
        under the wall-clock ``budget``. On timeout the thread is abandoned
        (a stuck device call cannot be cancelled) and
        :class:`DeviceDispatchError` is raised; an exception from ``fn`` is
        re-raised wrapped. Both count as breaker failures."""
        if budget is None:
            budget = self.dispatch_budget
        try:
            box: list = [None, None]  # [result, exception]
            injector = self.injector

            def _call():
                try:
                    if injector is not None:
                        # inside the worker, so an injected delay above the
                        # budget drives the real join-timeout path
                        injector.on_dispatch()
                    box[0] = fn(*args)
                except BaseException as e:  # noqa: BLE001 — re-raised by the caller below
                    box[1] = e

            t = threading.Thread(target=_call, daemon=True, name=f"supervised-{what}")
            self.guarded_calls += 1
            t.start()
            t.join(budget)
            if t.is_alive():
                self.dispatch_timeouts += 1
                self.metrics.record_timeout()
                tracing.fault_event("watchdog_timeout", target="ops::supervisor", what=what,
                                    budget_s=budget)
                raise DeviceDispatchError(f"device {what} exceeded {budget}s watchdog budget")
            if box[1] is not None:
                raise DeviceDispatchError(f"device {what} failed: {box[1]}") from box[1]
        except DeviceDispatchError:
            self.dispatch_errors += 1
            if self.breaker.record_failure():
                self.metrics.record_trip()
            self._publish()
            raise
        self.breaker.record_success()
        return box[0]

    def record_failover(self) -> None:
        self.failovers += 1
        self.metrics.record_failover()
        self._publish()

    # -- observability --------------------------------------------------------

    def snapshot(self) -> dict:
        """State for dashboards and triage."""
        lp = self.last_probe
        return {
            "breaker": self.breaker.state,
            "trips": self.breaker.trips,
            "failures": self.breaker.failures,
            "failovers": self.failovers,
            "dispatch_timeouts": self.dispatch_timeouts,
            "dispatch_errors": self.dispatch_errors,
            "probe_ok": None if lp is None else lp.ok,
            "probe_latency": None if lp is None else round(lp.latency, 3),
            "fault_injection": self.injector.active() if self.injector is not None else False,
            "warmup": None if self.warmup is None else self.warmup.overall_state(),
        }

    def _publish(self) -> None:
        self.metrics.set_state(self.breaker.state)


class SupervisedBackend:
    """The turbo array protocol over a device engine under the watchdog, with
    journaled mid-commit failover.

    Every call's arguments are host numpy arrays, so the backend journals
    ``(method, args)`` as it forwards them (references, not copies: the
    callers hand each array over once and do not write it afterwards). When
    a device call trips the watchdog, or the device route is already
    broken, a fresh ``_NumpyBackend`` replays the journal and the commit
    resumes on the CPU at the current level boundary. Terminal calls
    (``finish`` / ``fetch_slots``) are guarded too: the staging engines
    launch and sync only there.

    ``device_factory`` makes the engine on ``device``; that device's kernel
    libraries are loaded before the first guarded call (see
    :func:`load_kernels`). ``arena`` is the twin's host ``DigestArena``
    (``trie/turbo.py``), as in the reference; the device hot-state arena
    (``ops/fused_commit.py DigestArena``) belongs to the sparse finish's
    ``ParallelSparseCommitter(arena=...)``, not here."""

    def __init__(self, supervisor: DeviceSupervisor, device_factory, arena=None,
                 device="cuda"):
        from ..trie.turbo import DigestArena

        if arena is not None and not isinstance(arena, DigestArena):
            raise TypeError("SupervisedBackend(arena=...) takes the numpy twin's host "
                            "DigestArena (trie/turbo.py); the device hot-state arena "
                            "(ops/fused_commit.py) goes to ParallelSparseCommitter(arena=...)")
        self.sup = supervisor
        self._factory = device_factory
        self._arena = arena
        self.device = resolve(device)
        self._loaded = False
        self._journal: list[tuple[str, tuple]] = []
        self._device = None
        self._cpu = None
        self.failed_over = False

    @property
    def effective_kind(self) -> str:
        return "numpy" if self._cpu is not None else "device"

    def _failover(self, mid_commit: bool) -> None:
        from ..trie.turbo import _NumpyBackend

        self._device = None
        self._cpu = _NumpyBackend(arena=self._arena)
        if mid_commit and not self.failed_over:
            self.failed_over = True
            self.sup.record_failover()
        for name, args in self._journal:
            getattr(self._cpu, name)(*args)

    def _call(self, name: str, *args):
        if self._device is not None:
            try:
                out = self.sup.run_guarded(getattr(self._device, name), *args, what=name)
                self._journal.append((name, args))
                return out
            except DeviceDispatchError:
                # replay the journal: the commit resumes here on the CPU twin
                self._failover(mid_commit=True)
        elif self._cpu is None:
            # the breaker was open before the commit began: CPU routing,
            # not a mid-commit failover
            self._failover(mid_commit=False)
        self._journal.append((name, args))
        return getattr(self._cpu, name)(*args)

    # -- array protocol (turbo backends, FusedLevelEngine callers) ------------

    def begin(self, max_slots: int) -> None:
        if not self._loaded:
            load_kernels(self.device, ("fused_level.cu",))
            self._loaded = True
        self._journal = []
        self._device, self._cpu = None, None
        self.failed_over = False
        # the warm-up gate first (no probe): a commit that starts while the
        # menu warms runs on the twin, degraded serving and not a failover
        if self.sup.warmup_allows_device() and self.sup.route() == "device":
            try:
                self._device = self.sup.run_guarded(self._factory, what="engine init")
            except DeviceDispatchError:
                # headed for the device and fell over before any level ran:
                # still a failover
                self._failover(mid_commit=True)
        self._call("begin", max_slots)

    def alloc_slot(self) -> int:
        """Host-side counter on whichever twin is live; journaled so a
        replayed twin's counter stays in step (no watchdog: it never
        touches the device)."""
        self._journal.append(("alloc_slot", ()))
        live = self._device if self._device is not None else self._cpu
        return live.alloc_slot()

    def ensure(self, max_slots: int) -> None:
        """Digest-buffer growth (pipelined rebuild): guarded and journaled,
        so a replayed twin grows to the same capacity before the later
        dispatches land."""
        self._call("ensure", max_slots)

    def dispatch_level(self, bucket):
        """The committer's bucket protocol (``TrieCommitter(fused=True)``)."""
        self._call("dispatch_level", bucket)

    def dispatch_packed(self, flat, row_off, row_len, slots, holes, b_tier):
        self._call("dispatch_packed", flat, row_off, row_len, slots, holes, b_tier)

    def dispatch_branch(self, masks, slots, children):
        self._call("dispatch_branch", masks, slots, children)

    def flush_window(self):
        """Window boundary: a k-level engine launches its staged chunks here
        (guarded and journaled like any device call); engines without the
        hook defer to the terminal fetch."""
        if self._device is not None and not hasattr(self._device, "flush_window"):
            return
        self._call("flush_window")

    def fetch_slots(self, slots):
        return self._call("fetch_slots", slots)

    def finish(self):
        return self._call("finish")


class SupervisedHasher:
    """``hash_batch`` protocol: kernel 1 through ``KeccakDevice`` on
    ``device`` under the watchdog, the numpy hasher (``keccak256_batch_np``)
    on failure or while the breaker is open. Hashing is stateless, so a
    failed batch simply runs again on the CPU. Kernel 1's library is loaded
    before the first guarded call. The warm-up manager (``warmup``, else the
    one attached to the supervisor when the device hasher is built) routes
    each un-warm bucket to the host."""

    def __init__(self, supervisor: DeviceSupervisor, device_hasher=None, cpu_hasher=None,
                 min_tier: int = 1024, warmup=None, device="cuda"):
        self.sup = supervisor
        self._device = device_hasher
        self._min_tier = min_tier
        self._warmup = warmup
        self.device = resolve(device)
        self._loaded = False
        if cpu_hasher is None:
            from ..primitives.keccak import keccak256_batch_np

            cpu_hasher = keccak256_batch_np
        self._cpu = cpu_hasher

    def _device_hasher(self):
        if self._device is None:
            from .keccak import KeccakDevice

            warmup = self._warmup if self._warmup is not None else self.sup.warmup
            self._device = KeccakDevice(min_tier=self._min_tier, block_tier=4, warmup=warmup,
                                        device=self.device).hash_batch
        return self._device

    def __call__(self, msgs):
        if not self._loaded:
            load_kernels(self.device, ("keccak.cu",))
            self._loaded = True
        if self.sup.route() == "device":
            try:
                return self.sup.run_guarded(self._device_hasher(), msgs, what="hash_batch")
            except DeviceDispatchError:
                pass
        return self._cpu(msgs)
