"""Metrics registry of the port: counters, gauges and histograms with a
Prometheus text rendering, and the state commitment's three metric groups.

Port of the part of the JAX package's ``metrics.py`` that the rebuild, the
sparse finish and the device supervisor report through, under the same
metric names: ``TrieMetrics`` (one record per commit), ``PipelineMetrics``
(the pipelined rebuild's stage times, windows and queue),
``SparseCommitMetrics`` (the live-tip finish), ``FusedCommitMetrics`` (the
fused engines' launches and the k-level engine's fault ladder),
``SupervisorMetrics`` (the breaker, failovers, watchdog timeouts and
probes), ``HotStateMetrics`` (the hot-state plane's node cache and
device digest arena), ``HashServiceMetrics`` (the shared hash service's
lanes), ``WarmupMetrics`` (the warm-up manager's menu and compile
cache), ``MeshMetrics`` (the member mesh's topology, shrinks, leases and
partition split), and the engine's three: ``ExecMetrics`` (the optimistic scheduler
and the BAL wave executor), ``EngineTreeMetrics`` (the invalid-header
cache, the orphan buffer, reorgs and cancelled inserts) and
``BlockPipelineMetrics`` (the cross-block import pipeline), and block
production's two: ``PoolMetrics`` (pool events, admission sheds) and
``ProducerMetrics`` (the continuous producer's refreshes, and the payload
path's catch-all fallbacks, which the reference does not count), and
storage's ``WalMetrics`` (``wal_metrics``, also ``recovery_metrics``: WAL
appends and checkpoints, startup replay, recovery's status, and its
catch-all fallbacks, which the reference does not count either), and
the RPC's: ``GatewayMetrics`` (the serving gateway's admission, coalescing
and cache), ``update_process_metrics`` (the process and build-identity
gauges a ``/metrics`` scrape refreshes; the build's labels name torch where
the reference's name jax) and ``sample_percentile`` (the gas oracle's). The
module-level instances record into the process-wide ``REGISTRY``, as in the
reference.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

# sub-millisecond decades for device-dispatch timings
SUB_MS_BUCKETS = (0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025,
                  0.005, 0.02, 0.1, 0.5, 2, 10)


@dataclass
class Counter:
    name: str
    help: str = ""
    value: float = 0.0
    # constant labels, rendered as name{k="v",...}: one Counter per label set
    labels: dict | None = None
    # float += is a read-modify-write: concurrent increments need the lock
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    def increment(self, amount: float = 1.0):
        with self._lock:
            self.value += amount


@dataclass
class Gauge:
    name: str
    help: str = ""
    value: float = 0.0
    labels: dict | None = None
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    def set(self, value: float):
        with self._lock:
            self.value = value


@dataclass
class Histogram:
    """Fixed-bucket histogram (Prometheus cumulative buckets)."""

    name: str
    help: str = ""
    buckets: tuple[float, ...] = (0.001, 0.01, 0.1, 0.5, 1, 5, 30, 120)
    counts: list[int] = field(default_factory=list)
    total: float = 0.0
    n: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    def __post_init__(self):
        if not self.counts:
            self.counts = [0] * (len(self.buckets) + 1)

    def record(self, value: float):
        with self._lock:
            self.total += value
            self.n += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1

    def snapshot(self) -> tuple[list[int], float, int]:
        """Consistent (per-bucket counts, total, n) copy."""
        with self._lock:
            return list(self.counts), self.total, self.n


def sample_percentile(sorted_samples, pct: int):
    """Nearest-rank percentile over an already-sorted sample list (the
    gas-oracle shape: small lists, integer percentile)."""
    if not sorted_samples:
        return None
    idx = min(len(sorted_samples) - 1, len(sorted_samples) * pct // 100)
    return sorted_samples[idx]


def _label_str(labels: dict) -> str:
    return ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _register(self, name: str, kind, factory):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is None:
                existing = self._metrics[name] = factory()
            elif not isinstance(existing, kind):
                raise TypeError(f"metric {name!r} already registered as {type(existing).__name__}")
            return existing

    def counter(self, name: str, help: str = "", labels: dict | None = None) -> Counter:
        # a labeled counter registers under its full labeled key, so one
        # family holds many series
        key = name if not labels else f"{name}{{{_label_str(labels)}}}"
        return self._register(key, Counter, lambda: Counter(name, help, labels=labels))

    def gauge(self, name: str, help: str = "", labels: dict | None = None) -> Gauge:
        g = self._register(name, Gauge, lambda: Gauge(name, help, labels=labels))
        if labels is not None:
            g.labels = labels
        return g

    def histogram(self, name: str, help: str = "", **kw) -> Histogram:
        h = self._register(name, Histogram, lambda: Histogram(name, help, **kw))
        if kw.get("buckets") and h.buckets != kw["buckets"]:
            raise ValueError(f"metric {name!r} registered with different buckets")
        return h

    def items(self) -> list[tuple[str, object]]:
        """Stable (name, metric) snapshot; the metrics are live objects."""
        with self._lock:
            return sorted(self._metrics.items())

    def render(self) -> str:
        """Prometheus text exposition format."""
        lines = []
        typed: set[str] = set()  # one TYPE line per labeled family
        for name, m in self.items():
            if isinstance(m, Counter):
                if m.name not in typed:
                    typed.add(m.name)
                    lines.append(f"# TYPE {m.name} counter")
                lines.append(f"{m.name}{{{_label_str(m.labels)}}} {m.value}" if m.labels
                             else f"{name} {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name}{{{_label_str(m.labels)}}} {m.value}" if m.labels
                             else f"{name} {m.value}")
            elif isinstance(m, Histogram):
                lines.append(f"# TYPE {name} histogram")
                counts, total, n = m.snapshot()
                cum = 0
                for b, c in zip(m.buckets, counts):
                    cum += c
                    lines.append(f'{name}_bucket{{le="{b}"}} {cum}')
                lines.append(f'{name}_bucket{{le="+Inf"}} {n}')
                lines.append(f"{name}_sum {total}")
                lines.append(f"{name}_count {n}")
        return "\n".join(lines) + "\n"


# the process-wide registry
REGISTRY = MetricsRegistry()

_PROC_START = None
_BUILD_INFO: dict | None = None


def build_info() -> dict:
    """Node-identity labels: package version, git revision (when the repo
    is available), torch version, and the device backend. Computed once."""
    global _BUILD_INFO
    if _BUILD_INFO is not None:
        return _BUILD_INFO
    import os

    from . import __version__

    info = {"version": __version__}
    try:
        import subprocess

        r = subprocess.run(
            ["git", "-C", os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5)
        if r.returncode == 0 and r.stdout.strip():
            info["git"] = r.stdout.strip()
    except Exception:  # noqa: BLE001 — identity is best-effort
        pass
    import torch

    info["torch"] = torch.__version__
    info["backend"] = "cuda" if torch.cuda.is_available() else "cpu"
    _BUILD_INFO = info
    return info


def update_process_metrics(registry: MetricsRegistry | None = None) -> None:
    """Process-level gauges from /proc/self (reference crates/node/metrics
    process collector: RSS, CPU time, fds, threads, uptime). Called at
    scrape time by the /metrics endpoint; silently a no-op off-Linux."""
    global _PROC_START
    reg = registry or REGISTRY
    import os
    import time as _t

    if _PROC_START is None:
        _PROC_START = _t.time()
    reg.gauge("process_uptime_seconds").set(round(_t.time() - _PROC_START, 1))
    reg.gauge("reth_tpu_build_info",
              "node build identity: version/git/torch/backend",
              labels=build_info()).set(1)
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        reg.gauge("process_resident_memory_bytes").set(
            pages * os.sysconf("SC_PAGE_SIZE"))
        with open("/proc/self/stat") as f:
            parts = f.read().rsplit(")", 1)[1].split()
        tck = os.sysconf("SC_CLK_TCK")
        # fields (post-comm): utime=11 stime=12 num_threads=17 (0-based)
        reg.gauge("process_cpu_seconds_total").set(
            round((int(parts[11]) + int(parts[12])) / tck, 2))
        reg.gauge("process_threads").set(int(parts[17]))
        reg.gauge("process_open_fds").set(len(os.listdir("/proc/self/fd")))
    except (OSError, IndexError, ValueError):
        pass


class TrieMetrics:
    """Per-commit stats of the state commitment: node and leaf counts,
    levels, host-to-device wire bytes and wall time, split by backend."""

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry or REGISTRY
        self._nodes = {k: reg.counter(f"trie_commit_nodes_total_{k}") for k in ("device", "numpy")}
        self._leaves = reg.counter("trie_commit_leaves_total")
        self._wire = reg.counter("trie_commit_wire_bytes_total")
        self._commits = reg.counter("trie_commits_total")
        self._seconds = reg.histogram("trie_commit_duration_seconds", buckets=SUB_MS_BUCKETS)
        self._levels = reg.histogram("trie_commit_levels", buckets=(2, 4, 6, 8, 10, 12, 16))
        self.last: dict | None = None  # the most recent commit

    def record_commit(self, backend: str, nodes: int, levels: int, leaves: int,
                      wire_bytes: int, seconds: float) -> None:
        self._nodes.get(backend, self._nodes["numpy"]).increment(nodes)
        self._leaves.increment(leaves)
        self._wire.increment(wire_bytes)
        self._commits.increment()
        self._seconds.record(seconds)
        self._levels.record(levels)
        self.last = {"backend": backend, "nodes": nodes, "levels": levels,
                     "leaves": leaves, "wire_bytes": wire_bytes, "seconds": round(seconds, 4)}


trie_metrics = TrieMetrics()


class PipelineMetrics:
    """The pipelined rebuild (``trie/turbo.py RebuildPipeline``): per-stage
    walls (sweep, pack, dispatch, fetch), the bounded queue's depth, the
    sweep pool's occupancy, windows, and windows drained onto the CPU twin
    after a supervised backend failed over."""

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry or REGISTRY
        self._stage_s = {k: reg.counter(f"trie_pipeline_{k}_seconds_total")
                         for k in ("sweep", "pack", "dispatch", "fetch")}
        self._runs = reg.counter("trie_pipeline_runs_total")
        self._windows = reg.counter("trie_pipeline_windows_total",
                                    "cross-subtrie packed dispatch windows")
        self._subtries = reg.counter("trie_pipeline_subtries_total")
        self._drains = reg.counter("trie_pipeline_queue_drains_total",
                                   "windows hashed on the CPU twin after a mid-rebuild failover")
        self._qdepth = reg.gauge("trie_pipeline_queue_depth", "swept groups waiting for hashing")
        self._busy = reg.gauge("trie_pipeline_pool_busy", "native sweeps currently running")
        self.last: dict | None = None  # the most recent run

    def set_queue_depth(self, n: int) -> None:
        self._qdepth.set(n)

    def set_pool_busy(self, n: int) -> None:
        self._busy.set(n)

    def record_run(self, *, jobs: int, groups: int, windows: int, queue_peak: int,
                   drained_windows: int, backend, wall_s: float, sweep: float, pack: float,
                   dispatch: float, fetch: float) -> None:
        self._runs.increment()
        self._windows.increment(windows)
        self._subtries.increment(jobs)
        self._drains.increment(drained_windows)
        for k, v in (("sweep", sweep), ("pack", pack), ("dispatch", dispatch), ("fetch", fetch)):
            self._stage_s[k].increment(round(v, 6))
        self.last = {
            "jobs": jobs, "groups": groups, "windows": windows,
            "queue_peak": queue_peak, "drained_windows": drained_windows,
            "backend": backend, "wall_s": round(wall_s, 4),
            "sweep_s": round(sweep, 4), "pack_s": round(pack, 4),
            "dispatch_s": round(dispatch, 4), "fetch_s": round(fetch, 4),
        }


pipeline_metrics = PipelineMetrics()


class SparseCommitMetrics:
    """The live-tip sparse finish (``trie/sparse.py
    ParallelSparseCommitter``): levels packed across tries, hash dispatches,
    hashed nodes, encode-pool chunks and occupancy, and the finish wall."""

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry or REGISTRY
        self._commits = reg.counter("sparse_commit_commits_total", "parallel packed commits run")
        self._levels = reg.counter("sparse_commit_levels_packed_total",
                                   "global depth levels packed across tries")
        self._dispatches = reg.counter("sparse_commit_dispatches_total",
                                       "fused hash dispatches issued (one per packed depth)")
        self._hashed = reg.counter("sparse_commit_hashed_nodes_total")
        self._chunks = reg.counter("sparse_commit_encode_chunks_total",
                                   "lower-subtrie RLP encode chunks fanned across the pool")
        self._streamed = reg.counter("sparse_commit_streamed_chunks_total",
                                     "encode chunks streamed to the hash service's live lane")
        self._encode_busy = reg.gauge("sparse_commit_encode_pool_busy",
                                      "encode chunks currently in flight on the pool")
        self._proof_depth = reg.gauge("sparse_commit_proof_worker_depth",
                                      "sharded multiproof fetches currently outstanding")
        self._disp_per_block = reg.histogram("sparse_commit_dispatches_per_block",
                                             buckets=(2, 4, 6, 8, 12, 16, 24, 32))
        self._finish = reg.histogram("sparse_commit_finish_seconds",
                                     "live-tip sparse finish() wall clock", buckets=SUB_MS_BUCKETS)
        self.last: dict | None = None  # the most recent commit's stats

    def record_commit(self, stats: dict) -> None:
        self._commits.increment()
        self._levels.increment(stats.get("levels", 0))
        self._dispatches.increment(stats.get("dispatches", 0))
        self._hashed.increment(stats.get("hashed", 0))
        self._chunks.increment(stats.get("encode_chunks", 0))
        self._streamed.increment(stats.get("streamed", 0))
        self.last = dict(stats)

    def record_block(self, dispatches: int, finish_s: float) -> None:
        self._disp_per_block.record(dispatches)
        self._finish.record(finish_s)
        if self.last is not None:
            self.last["finish_s"] = round(finish_s, 4)

    def set_encode_busy(self, n: int) -> None:
        self._encode_busy.set(n)

    def set_proof_depth(self, n: int) -> None:
        self._proof_depth.set(n)


sparse_commit_metrics = SparseCommitMetrics()


class FusedCommitMetrics:
    """Fused-engine launch accounting (``ops/fused_commit.py``): launches
    issued, the trie levels each carried, launches per k-level commit, and
    the k-level engine's fallbacks down its fault ladder. ``last`` holds the
    most recent k-level commit, with the rung (``mode``: fused, perlevel or
    cpu) that produced its digests."""

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry or REGISTRY
        self._dispatches = reg.counter("fused_dispatches_total",
                                       "fused committer device dispatches issued")
        self._levels = reg.counter("fused_levels_total", "trie levels carried by fused dispatches")
        self._levels_per = reg.histogram("fused_levels_per_dispatch",
                                         "trie levels fused into one device dispatch",
                                         buckets=(1, 2, 4, 8, 16, 32, 64))
        self._per_block = reg.histogram("fused_dispatches_per_block",
                                        "device dispatches one k-level fused commit issued",
                                        buckets=(1, 2, 4, 8, 16, 24, 32, 64, 128))
        self._fallbacks = reg.counter("fused_subtrie_fallbacks_total",
                                      "k-level chunks degraded to the per-level or CPU path")
        self.last: dict | None = None  # the most recent k-level commit

    def record_dispatch(self, levels: int) -> None:
        self._dispatches.increment()
        self._levels.increment(levels)
        self._levels_per.record(levels)

    def record_fallback(self) -> None:
        self._fallbacks.increment()

    def record_commit(self, *, dispatches: int, levels: int, k: int, mode: str) -> None:
        """One k-level commit finished: ``dispatches`` launches carried
        ``levels`` staged levels on rung ``mode``."""
        self._per_block.record(dispatches)
        self.last = {"k": k, "dispatches": dispatches, "levels": levels, "mode": mode}


fused_metrics = FusedCommitMetrics()


class SupervisorMetrics:
    """The device supervisor (``ops/supervisor.py``): breaker state and
    trips, mid-commit failovers, watchdog timeouts, and the health probes'
    outcomes and latency. Each ``DeviceSupervisor`` makes its own, on the
    registry it is given (``REGISTRY`` by default)."""

    # breaker state encoding for the gauge (alerting-friendly ordering)
    _STATES = {"closed": 0.0, "half_open": 1.0, "open": 2.0}

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry or REGISTRY
        self._state = reg.gauge("hasher_supervisor_breaker_state",
                                "circuit breaker state: 0 closed, 1 half-open, 2 open")
        self._trips = reg.counter("hasher_supervisor_breaker_trips_total",
                                  "times the breaker opened (device route disabled)")
        self._failovers = reg.counter("hasher_supervisor_failovers_total",
                                      "mid-commit failovers replayed onto the CPU backend")
        self._timeouts = reg.counter("hasher_supervisor_dispatch_timeouts_total",
                                     "device dispatches that exceeded the watchdog budget")
        self._probes = reg.counter("hasher_supervisor_probes_total")
        self._probe_failures = reg.counter("hasher_supervisor_probe_failures_total")
        self._probe_seconds = reg.histogram("hasher_supervisor_probe_duration_seconds",
                                            buckets=(0.1, 0.5, 1, 2, 5, 15, 60, 120))

    def set_state(self, state: str) -> None:
        self._state.set(self._STATES.get(state, 2.0))

    def record_trip(self) -> None:
        self._trips.increment()

    def record_failover(self) -> None:
        self._failovers.increment()

    def record_timeout(self) -> None:
        self._timeouts.increment()

    def record_probe(self, ok: bool, latency: float) -> None:
        self._probes.increment()
        if not ok:
            self._probe_failures.increment()
        self._probe_seconds.record(latency)


class HotStateMetrics:
    """The hot-state plane (``trie/hot_cache.py TrieNodeCache`` and
    ``ops/fused_commit.py DigestArena``), in two families:

    - ``hotstate_cache_*``: the node cache's hits, misses and evictions, and
      the stale and poison drops of its node-hash validation; the hit rate
      is what the reference's health rule watches.
    - ``hotstate_arena_*``: resident digest rows, delta and full-upload
      epochs, evictions, faults, and per commit the delta-upload fraction
      (staged rows over staged plus reveal-stamped rows) and the bytes
      staged to the device.

    The cache and the arena report lifetime totals; the counters move by
    the increments."""

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry or REGISTRY
        self._hits = reg.counter("hotstate_cache_hits_total",
                                 "node-cache lookups served (hash-validated)")
        self._misses = reg.counter("hotstate_cache_misses_total",
                                   "node-cache lookups that paid a proof fetch")
        self._stale = reg.counter("hotstate_cache_stale_drops_total",
                                  "entries dropped because keccak(rlp) != expected hash")
        self._poison = reg.counter("hotstate_cache_poison_caught_total",
                                   "injected poisons caught by node-hash validation")
        self._cache_evictions = reg.counter("hotstate_cache_evictions_total",
                                            "LRU bound evictions")
        self._clears = reg.counter("hotstate_cache_clears_total",
                                   "wholesale invalidations (deep reorg / storm / injector)")
        self._entries = reg.gauge("hotstate_cache_entries", "node-cache resident entries")
        self._hit_rate = reg.gauge("hotstate_cache_hit_rate",
                                   "rolling lifetime hit rate (health SLO floor input)")
        self._rows = reg.gauge("hotstate_arena_resident_rows",
                               "digest rows resident in the cross-block device arena")
        self._leaked = reg.gauge("hotstate_arena_leaked_rows",
                                 "allocated-but-unaccounted rows (invariant: 0)")
        self._delta_epochs = reg.counter("hotstate_arena_delta_epochs_total",
                                         "commits that delta-uploaded against resident rows")
        self._full_epochs = reg.counter("hotstate_arena_full_epochs_total",
                                        "commits that took the full-upload rung")
        self._arena_evictions = reg.counter("hotstate_arena_evictions_total",
                                            "wholesale arena evictions (bound / fault / reorg)")
        self._faults = reg.counter("hotstate_arena_faults_total",
                                   "delta epochs that died and fell back to full upload")
        self._delta_fraction = reg.histogram(
            "hotstate_delta_upload_fraction", "staged rows / (staged + reveal-stamped) per commit",
            buckets=(0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0))
        self._h2d = reg.histogram(
            "hotstate_h2d_bytes_per_commit", "bytes staged to the device per sparse finish",
            buckets=(1 << 12, 1 << 14, 1 << 16, 1 << 18, 1 << 20, 1 << 22, 1 << 24))
        self.last: dict | None = None  # the most recent snapshots
        self._cache_prev: dict = {}
        self._arena_prev: dict = {}

    @staticmethod
    def _delta(prev: dict, cur: dict, key: str) -> int:
        d = cur.get(key, 0) - prev.get(key, 0)
        return d if d > 0 else 0

    def record_cache(self, stats: dict) -> None:
        p = self._cache_prev
        self._hits.increment(self._delta(p, stats, "hits"))
        self._misses.increment(self._delta(p, stats, "misses"))
        self._stale.increment(self._delta(p, stats, "stale_drops"))
        self._poison.increment(self._delta(p, stats, "poison_caught"))
        self._cache_evictions.increment(self._delta(p, stats, "evictions"))
        self._clears.increment(self._delta(p, stats, "clears"))
        self._entries.set(stats.get("entries", 0))
        total = stats.get("hits", 0) + stats.get("misses", 0)
        rate = (stats.get("hits", 0) / total) if total else 0.0
        self._hit_rate.set(round(rate, 4))
        self._cache_prev = dict(stats)
        self.last = {**(self.last or {}), "cache": dict(stats), "hit_rate": round(rate, 4)}

    def record_arena(self, snap: dict, *, delta_fraction: float, staged_rows: int,
                     stamped_rows: int, h2d_bytes: int, fresh: bool) -> None:
        p = self._arena_prev
        self._arena_evictions.increment(self._delta(p, snap, "evictions"))
        self._faults.increment(self._delta(p, snap, "faults"))
        self._delta_epochs.increment(self._delta(p, snap, "delta_epochs"))
        self._full_epochs.increment(self._delta(p, snap, "full_epochs"))
        self._rows.set(snap.get("resident_rows", 0))
        self._leaked.set(snap.get("leaked_rows", 0))
        self._delta_fraction.record(delta_fraction)
        self._h2d.record(h2d_bytes)
        self._arena_prev = dict(snap)
        self.last = {**(self.last or {}), "arena": dict(snap),
                     "delta_fraction": round(delta_fraction, 4), "staged_rows": staged_rows,
                     "stamped_rows": stamped_rows, "h2d_bytes": h2d_bytes, "fresh": fresh}


hotstate_metrics = HotStateMetrics()


class HashServiceMetrics:
    """The shared hash service (``ops/hash_service.py``): per-lane queue
    depth and request counts, the coalesce factor (requests fused per
    dispatch), batch occupancy (messages over the batch tier), wait and
    service-time histograms, and the failure-path counters (numpy-twin
    replays, backpressure rejects, lease bypasses). Each ``HashService``
    makes its own, on the registry it is given (``REGISTRY`` by default)."""

    _LANES = ("live", "payload", "rebuild", "proof")

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry or REGISTRY
        self._requests = {lane: reg.counter(f"hash_service_requests_total_{lane}",
                                            f"requests submitted on the {lane} lane")
                          for lane in self._LANES}
        self._msgs = {lane: reg.counter(f"hash_service_msgs_total_{lane}",
                                        f"messages submitted on the {lane} lane")
                      for lane in self._LANES}
        self._qdepth = {lane: reg.gauge(f"hash_service_queue_depth_{lane}",
                                        f"messages waiting on the {lane} lane")
                        for lane in self._LANES}
        self._rejects = {lane: reg.counter(f"hash_service_rejects_total_{lane}",
                                           f"backpressure rejections on the {lane} lane")
                         for lane in self._LANES}
        self._dispatches = reg.counter("hash_service_dispatches_total",
                                       "coalesced backend dispatches issued")
        self._coalesced = reg.counter("hash_service_coalesced_requests_total",
                                      "requests fused into coalesced dispatches")
        self._hashed = reg.counter("hash_service_hashed_msgs_total", "messages hashed")
        self._coalesce_factor = reg.gauge(
            "hash_service_coalesce_factor",
            "requests per dispatch, lifetime average (>1 = batching works)")
        self._occupancy = reg.gauge("hash_service_batch_occupancy",
                                    "last dispatch: messages / padded batch tier")
        self._replays = reg.counter("hash_service_replays_total",
                                    "coalesced batches replayed on the numpy twin after a failure")
        self._lease_bypasses = reg.counter("hash_service_lease_bypass_total",
                                           "coalesced batches hashed on the CPU twin while leased")
        self._leases = reg.counter("hash_service_leases_total")
        self._lease_wait = reg.histogram("hash_service_lease_wait_seconds",
                                         buckets=(0.0001, 0.001, 0.01, 0.1, 0.5, 1, 5, 30))
        self._wait = {lane: reg.histogram(f"hash_service_wait_seconds_{lane}",
                                          f"queue wait before dispatch, {lane} lane",
                                          buckets=SUB_MS_BUCKETS)
                      for lane in self._LANES}
        self._service = reg.histogram("hash_service_service_seconds",
                                      "coalesced dispatch wall time", buckets=SUB_MS_BUCKETS)

    def record_submit(self, lane: str, n_msgs: int) -> None:
        self._requests[lane].increment()
        self._msgs[lane].increment(n_msgs)

    def set_queue_depth(self, lane: str, n_msgs: int) -> None:
        self._qdepth[lane].set(n_msgs)

    def record_reject(self, lane: str) -> None:
        self._rejects[lane].increment()

    def record_wait(self, lane: str, seconds: float) -> None:
        self._wait[lane].record(seconds)

    def record_dispatch(self, *, requests: int, msgs: int, occupancy: float,
                        service_s: float, replayed: bool) -> None:
        self._dispatches.increment()
        self._coalesced.increment(requests)
        self._hashed.increment(msgs)
        self._coalesce_factor.set(round(self._coalesced.value / self._dispatches.value, 3))
        self._occupancy.set(round(occupancy, 4))
        self._service.record(service_s)

    def record_replay(self) -> None:
        self._replays.increment()

    def record_lease(self, wait_s: float) -> None:
        self._leases.increment()
        self._lease_wait.record(wait_s)

    def record_lease_bypass(self) -> None:
        self._lease_bypasses.increment()


class WarmupMetrics:
    """The warm-up manager (``ops/warmup.py``): menu progress (shapes warm
    and failed out of those declared), per-shape warm-up walls, watchdog
    wedges and backoff retries, compile-cache hits, misses and quarantines,
    and how many buckets degraded serving routed to the CPU twin. Each
    ``WarmupManager`` makes its own, on the registry it is given."""

    _STATES = {"off": 0.0, "pending": 1.0, "warming": 2.0, "warm": 3.0, "degraded": 4.0}

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry or REGISTRY
        self._state = reg.gauge("warmup_state", "0 off, 1 pending, 2 warming, 3 warm, 4 degraded")
        self._total = reg.gauge("warmup_shapes_total", "declared menu shapes")
        self._warm = reg.gauge("warmup_shapes_warm", "menu shapes compiled and promoted")
        self._failed = reg.gauge("warmup_shapes_failed",
                                 "menu shapes that exhausted their compile retries")
        self._compiles = reg.counter("warmup_compiles_total", "successful AOT shape compiles")
        self._compile_s = reg.counter("warmup_compile_seconds_total",
                                      "wall spent in successful warm-up compiles")
        self._compile_hist = reg.histogram("warmup_compile_seconds", "per-shape AOT compile wall",
                                           buckets=(0.05, 0.25, 1, 5, 15, 60, 240, 1200))
        self._retries = reg.counter("warmup_retries_total",
                                    "compile retries after a wedge/failure")
        self._wedges = reg.counter("warmup_wedges_total",
                                   "compiles that exceeded the watchdog budget or raised")
        self._cpu_routed = reg.counter("warmup_cpu_routed_total",
                                       "dispatch buckets served on the CPU twin while un-warm")
        self._cache_hits = reg.counter("warmup_cache_hits_total",
                                       "shape compiles satisfied by the persistent cache")
        self._cache_misses = reg.counter("warmup_cache_misses_total",
                                         "shape compiles that wrote new persistent-cache entries")
        self._cache_entries = reg.gauge("warmup_cache_entries",
                                        "persistent-cache entries found at validation")
        self._quarantines = reg.counter("warmup_cache_quarantines_total",
                                        "corrupt cache directories quarantined and rebuilt")

    def set_state(self, state: str) -> None:
        self._state.set(self._STATES.get(state, 0.0))

    def set_progress(self, *, total: int, warm: int, failed: int) -> None:
        self._total.set(total)
        self._warm.set(warm)
        self._failed.set(failed)

    def record_compile(self, wall_s: float, cache_hit: bool | None) -> None:
        self._compiles.increment()
        self._compile_s.increment(round(wall_s, 6))
        self._compile_hist.record(wall_s)
        if cache_hit is True:
            self._cache_hits.increment()
        elif cache_hit is False:
            self._cache_misses.increment()

    def record_retry(self) -> None:
        self._retries.increment()

    def record_wedge(self) -> None:
        self._wedges.increment()

    def record_cpu_routed(self, n: int = 1) -> None:
        self._cpu_routed.increment(n)

    def record_quarantine(self) -> None:
        self._quarantines.increment()

    def set_cache_entries(self, n: int) -> None:
        self._cache_entries.set(n)


class MeshMetrics:
    """The member mesh (``parallel/mesh.py`` and the meshed hash service):
    topology (members in the roster, healthy, leased), the per-member
    breakers' shrinks and recoveries, replays on a shrunken mesh, sub-mesh
    leases, and the partition-rule split of coalesced dispatches (sharded
    over the live members or kept on one). Names as in the reference."""

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry or REGISTRY
        self._total = reg.gauge("mesh_devices_total", "devices in the hashing mesh roster")
        self._healthy = reg.gauge("mesh_devices_healthy", "mesh devices passing their breaker")
        self._unhealthy = reg.gauge("mesh_devices_unhealthy",
                                    "mesh devices shed by per-device breakers (SLO input)")
        self._leased = reg.gauge("mesh_devices_leased",
                                 "devices currently claimed by a sub-mesh lease (rebuild)")
        self._shrinks = reg.counter("mesh_shrinks_total",
                                    "times a breaker trip removed a device from the live mesh")
        self._recoveries = reg.counter("mesh_recoveries_total",
                                       "devices re-admitted after their breaker cooldown")
        self._submesh_leases = reg.counter(
            "mesh_submesh_leases_total", "sub-mesh leases granted (rebuild claims k of n devices)")
        self._sharded = reg.counter("mesh_sharded_dispatches_total",
                                    "coalesced dispatches batch-sharded across the mesh")
        self._single = reg.counter("mesh_single_dispatches_total",
                                   "scalar/sub-threshold dispatches kept on one device")
        self._replays = reg.counter("mesh_replays_total",
                                    "in-flight batches replayed on a shrunken mesh after a trip")

    def set_topology(self, *, total: int, healthy: int, leased: int) -> None:
        self._total.set(total)
        self._healthy.set(healthy)
        self._unhealthy.set(total - healthy)
        self._leased.set(leased)

    def record_shrink(self) -> None:
        self._shrinks.increment()

    def record_recovery(self) -> None:
        self._recoveries.increment()

    def record_submesh_lease(self) -> None:
        self._submesh_leases.increment()

    def record_sharded(self) -> None:
        self._sharded.increment()

    def record_single(self) -> None:
        self._single.increment()

    def record_replay(self) -> None:
        self._replays.increment()


class ExecMetrics:
    """Parallel-execution observability: the optimistic scheduler
    (engine/optimistic.py — exec_parallel_*) and the BAL wave executor
    (engine/bal.py — exec_bal_*, previously computed but only stashed on
    ``EngineTree.last_bal_stats``). One place to compare BAL-hinted vs
    optimistic scheduling efficiency in production: how many ranks ran
    native/parallel, how many invalidated and re-ran serially, how many
    keys the async storage layer prefetched, and whether a block fell
    all the way back to the serial executor."""

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry or REGISTRY
        self._blocks = reg.counter(
            "exec_parallel_blocks_total",
            "blocks executed by the optimistic scheduler")
        self._rounds = reg.counter(
            "exec_parallel_rounds_total", "native speculation rounds run")
        self._native = reg.counter(
            "exec_parallel_native_txs_total",
            "ranks committed from the native wave core")
        self._python = reg.counter(
            "exec_parallel_python_txs_total",
            "ranks committed through the Python interpreter")
        self._speculative = reg.counter(
            "exec_parallel_speculative_commits_total",
            "ranks whose validation-clean speculation committed directly")
        self._serial_rerun = reg.counter(
            "exec_parallel_serial_reruns_total",
            "invalidated ranks re-executed against the merged view")
        self._conflicts = reg.counter(
            "exec_parallel_conflicts_total",
            "native ranks demoted to an in-core serial re-run")
        self._misses = reg.counter(
            "exec_parallel_misses_total",
            "native rounds stopped by a snapshot miss")
        self._prefetched = reg.counter(
            "exec_parallel_prefetched_keys_total",
            "keys the async storage layer fetched in the background")
        self._fallbacks = reg.counter(
            "exec_parallel_fallbacks_total",
            "blocks that fell back to the serial executor")
        self._wall = reg.histogram(
            "exec_parallel_wall_seconds",
            "optimistic scheduler wall clock per block")
        self._bal_waves = reg.counter("exec_bal_waves_total")
        self._bal_parallel = reg.counter(
            "exec_bal_parallel_txs_total",
            "txs committed from conflict-free waves")
        self._bal_serial = reg.counter(
            "exec_bal_serial_txs_total",
            "txs demoted to serial re-execution")
        self._bal_native = reg.counter(
            "exec_bal_native_txs_total", "txs executed by the native core")
        self.last: dict | None = None      # optimistic, for the events line
        self.last_bal: dict | None = None  # BAL, for the events line

    def record_optimistic(self, stats: dict) -> None:
        self._blocks.increment()
        self._rounds.increment(stats.get("rounds", 0))
        self._native.increment(stats.get("native", 0))
        self._python.increment(stats.get("python", 0))
        self._speculative.increment(stats.get("speculative", 0))
        self._serial_rerun.increment(stats.get("serial_rerun", 0))
        self._conflicts.increment(stats.get("conflicts", 0))
        self._misses.increment(stats.get("misses", 0))
        self._prefetched.increment(stats.get("prefetched", 0))
        if stats.get("fallback"):
            self._fallbacks.increment()
        if "wall_s" in stats:
            self._wall.record(stats["wall_s"])
        self.last = dict(stats)

    def record_bal(self, stats: dict) -> None:
        self._bal_waves.increment(stats.get("waves", 0))
        self._bal_parallel.increment(stats.get("parallel", 0))
        self._bal_serial.increment(stats.get("serial", 0))
        self._bal_native.increment(stats.get("native", 0))
        self.last_bal = dict(stats)


exec_metrics = ExecMetrics()


class EngineTreeMetrics:
    """Consensus-robustness observability for the engine tree
    (engine/tree.py + engine/block_buffer.py): invalid-header cache
    occupancy vs its bound (an invalid-payload flood must plateau, not
    grow), orphan-buffer depth and evictions, reorg cadence/depth, storm
    detections with their backoff state, and in-flight inserts cancelled
    by a competing forkchoiceUpdated — the numbers that say whether a
    hostile CL is actually hurting the node."""

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry or REGISTRY
        self._invalid = reg.gauge(
            "tree_invalid_cached",
            "invalid-header cache entries (bounded LRU)")
        self._invalid_evictions = reg.counter(
            "tree_invalid_evictions_total",
            "invalid-cache entries evicted at the bound")
        self._orphans = reg.gauge(
            "tree_orphans_buffered",
            "blocks buffered awaiting an unknown parent")
        self._orphan_evictions = reg.counter(
            "tree_orphan_evictions_total",
            "buffered orphans evicted (bound or TTL)")
        self._orphan_replays = reg.counter(
            "tree_orphan_replays_total",
            "buffered children replayed when their parent arrived")
        self._reorgs = reg.counter("tree_reorgs_total")
        self._deep_reorgs = reg.counter(
            "tree_deep_reorgs_total",
            "reorgs that unwound the persisted chain")
        self._depth = reg.histogram(
            "tree_reorg_depth", "blocks abandoned per reorg",
            buckets=(1, 2, 3, 5, 8, 13, 21, 34))
        self._storms = reg.counter(
            "tree_reorg_storms_total",
            "reorg-storm detections (flight recorder dumped)")
        self._backoff = reg.gauge(
            "tree_reorg_backoff_active",
            "1 while reorg-storm backoff disables speculation")
        self._cancelled = reg.counter(
            "tree_payloads_cancelled_total",
            "in-flight inserts aborted by a forkchoice reorg")
        # events-line fragment state (node/events.py tree[...])
        self.last: dict = {}

    def set_invalid(self, n: int, cap: int) -> None:
        self._invalid.set(n)
        self.last["invalid"] = n
        self.last["invalid_cap"] = cap

    def invalid_evicted(self) -> None:
        self._invalid_evictions.increment()
        self.last["invalid_evicted"] = self.last.get("invalid_evicted", 0) + 1

    def set_orphans(self, n: int) -> None:
        self._orphans.set(n)
        self.last["orphans"] = n

    def orphan_evicted(self) -> None:
        self._orphan_evictions.increment()
        self.last["orphans_evicted"] = self.last.get("orphans_evicted", 0) + 1

    def orphans_replayed(self, n: int = 1) -> None:
        self._orphan_replays.increment(n)
        self.last["replayed"] = self.last.get("replayed", 0) + n

    def record_reorg(self, depth: int, deep: bool = False) -> None:
        self._reorgs.increment()
        if deep:
            self._deep_reorgs.increment()
        self._depth.record(depth)
        self.last["reorgs"] = self.last.get("reorgs", 0) + 1
        self.last["max_depth"] = max(self.last.get("max_depth", 0), depth)

    def storm(self) -> None:
        self._storms.increment()
        self.last["storms"] = self.last.get("storms", 0) + 1

    def set_backoff(self, active: bool) -> None:
        self._backoff.set(1 if active else 0)
        self.last["backoff"] = bool(active)

    def payload_cancelled(self) -> None:
        self._cancelled.increment()
        self.last["cancelled"] = self.last.get("cancelled", 0) + 1


tree_metrics = EngineTreeMetrics()


class BlockPipelineMetrics:
    """Cross-block import pipeline observability
    (engine/block_pipeline.py): speculations started/adopted/aborted
    (aborts labeled by ladder rung), commit-window cadence, the measured
    exec-inside-commit overlap fraction, and double-buffer sub-mesh
    leases — the numbers that say whether back-to-back import is
    actually overlapping exec with commit and why speculations die."""

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry or REGISTRY
        self._reg = reg
        self._depth = reg.gauge(
            "block_pipeline_depth", "configured import pipeline depth")
        self._started = reg.counter(
            "block_pipeline_speculations_total",
            "speculative next-block executions started")
        self._adopted = reg.counter(
            "block_pipeline_committed_total",
            "speculations adopted after the parent committed VALID")
        self._aborted = reg.counter(
            "block_pipeline_aborted_total",
            "speculations discarded (any abort-ladder rung)")
        self._abort_reason: dict[str, Counter] = {}
        self._windows = reg.counter(
            "block_pipeline_commit_windows_total",
            "commit windows published by the insert path")
        self._window_wall = reg.histogram(
            "block_pipeline_commit_window_seconds",
            "commit-window wall clock (open to close)")
        self._overlap = reg.histogram(
            "block_pipeline_overlap_fraction",
            "speculative exec wall inside the parent's commit window")
        self._leases = reg.counter(
            "block_pipeline_submesh_leases_total",
            "double-buffer sub-mesh leases taken for speculation")
        # events-line fragment state (node/events.py pipe[...])
        self.last: dict = {}

    def set_depth(self, depth: int) -> None:
        self._depth.set(depth)
        self.last["depth"] = depth

    def window_opened(self) -> None:
        self._windows.increment()

    def window_closed(self, ok: bool, wall: float) -> None:
        self._window_wall.record(wall)

    def speculation_started(self) -> None:
        self._started.increment()
        self.last["spec"] = self.last.get("spec", 0) + 1

    def speculation_adopted(self, overlap_fraction: float) -> None:
        self._adopted.increment()
        self._overlap.record(overlap_fraction)
        self.last["adopted"] = self.last.get("adopted", 0) + 1
        self.last["overlap"] = overlap_fraction

    def speculation_aborted(self, reason: str) -> None:
        self._aborted.increment()
        c = self._abort_reason.get(reason)
        if c is None:
            c = self._reg.counter(
                "block_pipeline_aborted_reason_total",
                "speculations discarded, by abort-ladder rung",
                labels={"reason": reason})
            self._abort_reason[reason] = c
        c.increment()
        self.last["aborted"] = self.last.get("aborted", 0) + 1
        self.last["last_abort"] = reason

    def lease_taken(self, devices: int) -> None:
        self._leases.increment()
        self.last["lease_devices"] = devices


block_pipeline_metrics = BlockPipelineMetrics()


class PoolMetrics:
    """Write-path firehose observability (pool/pool.py +
    pool/batcher.py): pool events by kind (admissions, replacements,
    drops labeled by reason), admission-queue sheds (the -32005
    backpressure ladder firing), and the pt_* records shipped to the
    fleet — the numbers that say whether the firehose is being absorbed
    or shed, and whether replicas are hearing about it."""

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry or REGISTRY
        self._reg = reg
        self._events: dict[tuple, Counter] = {}
        self._sheds = reg.counter(
            "pool_admission_sheds_total",
            "tx submissions refused -32005 (admission queue saturated)")
        self._shipped = reg.counter(
            "pool_feed_records_total",
            "pt_* pool records shipped to feed subscribers")
        self._feed_drops = reg.counter(
            "pool_feed_dropped_total",
            "pt_* records dropped at a saturated subscriber queue")
        # events-line fragment state (node/events.py pool[...])
        self.last: dict = {}

    def on_event(self, kind: str, reason: str | None = None) -> None:
        key = (kind, reason or "")
        c = self._events.get(key)
        if c is None:
            c = self._events[key] = self._reg.counter(
                "pool_events_total",
                "pool events by kind (add/replace/drop/canon) and "
                "drop reason",
                labels={"kind": kind, "reason": reason or ""})
        c.increment()
        if kind != "canon":
            self.last[kind] = self.last.get(kind, 0) + 1

    def record_shed(self) -> None:
        self._sheds.increment()
        self.last["sheds"] = self.last.get("sheds", 0) + 1

    def record_shipped(self, n: int = 1) -> None:
        self._shipped.increment(n)
        self.last["shipped"] = self.last.get("shipped", 0) + n

    def record_feed_drop(self, n: int = 1) -> None:
        self._feed_drops.increment(n)
        self.last["feed_drops"] = self.last.get("feed_drops", 0) + n

    def shed_total(self) -> int:
        return int(self.last.get("sheds", 0))


pool_metrics = PoolMetrics()


class ProducerMetrics:
    """Continuous block production observability (payload/producer.py):
    refresh cadence and wall, ranks executed fresh vs replayed from a
    checkpoint, candidate size, and staleness — the numbers that say
    whether the hot candidate is actually incremental (reexec ≪ ranks)
    and keeping up with the firehose."""

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry or REGISTRY
        self._refreshes = reg.counter(
            "producer_refreshes_total",
            "incremental candidate refreshes (full rebuilds included)")
        self._refresh_wall = reg.histogram(
            "producer_refresh_seconds",
            "one incremental refresh: restore + replay + greedy tail",
            buckets=SUB_MS_BUCKETS)
        self._fresh = reg.counter(
            "producer_ranks_executed_total",
            "candidate ranks executed against new stream entries")
        self._reexec = reg.counter(
            "producer_ranks_replayed_total",
            "known-good selected ranks replayed from a checkpoint")
        self._ranks = reg.gauge(
            "producer_candidate_ranks", "txs in the hot candidate")
        self._staleness = reg.gauge(
            "producer_staleness_seconds",
            "how long the hot candidate has lagged the pool (SLO input)")
        # events-line fragment state (node/events.py build[...])
        self.last: dict = {}
        self._reg = reg
        self._fallback_counters: dict[str, Counter] = {}
        # site -> fallbacks taken (builder, payload job, producer, miner)
        self.fallbacks: dict[str, int] = {}

    def record_refresh(self, wall_s: float, ranks: int, reexec: int,
                       fresh: int) -> None:
        self._refreshes.increment()
        self._refresh_wall.record(wall_s)
        if fresh > 0:
            self._fresh.increment(fresh)
        if reexec > 0:
            self._reexec.increment(reexec)
        self._ranks.set(ranks)
        self.last["refreshes"] = self.last.get("refreshes", 0) + 1
        self.last["ranks"] = ranks
        self.last["reexec"] = self.last.get("reexec", 0) + reexec
        self.last["fresh"] = self.last.get("fresh", 0) + fresh
        self.last["wall_s"] = wall_s

    def sync_ranks(self, ranks: int) -> None:
        self._ranks.set(ranks)
        self.last["ranks"] = ranks

    def set_staleness(self, seconds: float) -> None:
        self._staleness.set(seconds)
        self.last["staleness_s"] = seconds

    def record_fallback(self, site: str) -> None:
        """One catch-all of the payload path took the reference's fallback
        for a cause that is no kernel fault (a kernel fault raises there)."""
        c = self._fallback_counters.get(site)
        if c is None:
            c = self._fallback_counters[site] = self._reg.counter(
                "payload_fallbacks_total",
                "payload-path catch-alls that took the reference's fallback, by site",
                labels={"site": site})
        c.increment()
        self.fallbacks[site] = self.fallbacks.get(site, 0) + 1

    def fallback_total(self) -> int:
        return sum(self.fallbacks.values())


producer_metrics = ProducerMetrics()


class WalMetrics:
    """Write-ahead-log + startup-recovery observability (storage/wal.py,
    storage/recovery.py): append/checkpoint cadence, segment size, torn
    bytes discarded on replay, quarantined images/jars, and the
    recovery_status gauge the health engine's durability rule watches —
    the numbers that say whether a kill -9 right now would lose more
    than the persistence threshold."""

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry or REGISTRY
        self._appends = reg.counter(
            "wal_appends_total", "fsync'd commit records appended")
        self._bytes = reg.counter(
            "wal_bytes_written_total", "record bytes appended (framed)")
        self._checkpoints = reg.counter(
            "wal_checkpoints_total", "image+manifest checkpoints taken")
        self._segment_bytes = reg.gauge(
            "wal_segment_bytes", "bytes in the live WAL segment")
        self._gen = reg.gauge("wal_generation", "current WAL generation")
        self._replayed = reg.counter(
            "recovery_wal_records_replayed_total",
            "commit records applied during startup replay")
        self._torn = reg.counter(
            "recovery_torn_bytes_total",
            "torn WAL tail bytes discarded during startup replay")
        self._quarantined = reg.counter(
            "recovery_quarantined_total",
            "corrupt images/jars quarantined aside at startup")
        self._status = reg.gauge(
            "recovery_status",
            "last startup recovery: 0 ok, 1 degraded (healed), 2 failed")
        self._problems = reg.gauge(
            "recovery_problems", "problems reported by the last recovery")
        self._mgr = None
        self.last_recovery: dict | None = None  # events line fragment
        self._reg = reg
        self._fallback_counters: dict[str, Counter] = {}
        # site -> failures recovery's catch-alls absorbed ("unwind", "verify")
        self.fallbacks: dict[str, int] = {}

    def attach(self, manager) -> None:
        """Bind the live DurabilityManager so the sampler-facing gauges
        track it (called from storage/wal.py on attach)."""
        self._mgr = manager
        s = manager.snapshot()
        self._gen.set(s["gen"])
        self._segment_bytes.set(s["segment_bytes"])
        self._replayed.increment(s["replayed"])
        self._torn.increment(s["torn_bytes"])

    def record_append(self, nbytes: int, segment_bytes: int) -> None:
        self._appends.increment()
        self._bytes.increment(nbytes)
        self._segment_bytes.set(segment_bytes)

    def record_checkpoint(self, manager) -> None:
        self._checkpoints.increment()
        s = manager.snapshot()
        self._gen.set(s["gen"])
        self._segment_bytes.set(s["segment_bytes"])

    def record(self, report: dict) -> None:
        """Push one startup-recovery report (storage/recovery.py)."""
        level = {"ok": 0, "degraded": 1, "failed": 2}.get(
            report.get("status", "ok"), 2)
        self._status.set(level)
        self._problems.set(len(report.get("problems", ())))
        self._quarantined.increment(len(report.get("quarantined", ())))
        self.last_recovery = {
            "status": report.get("status"),
            "head": report.get("head_number"),
            "replayed": report.get("replayed_records", 0),
            "torn_bytes": report.get("torn_bytes", 0),
            "quarantined": len(report.get("quarantined", ())),
            "healed": len(report.get("healed", ())),
            "root_verified": report.get("root_verified"),
            "wall_s": report.get("wall_s"),
        }

    def record_fallback(self, site: str) -> None:
        """One of recovery's catch-alls absorbed a failure that is no kernel
        fault (a kernel fault raises there); the reference does not count
        these."""
        c = self._fallback_counters.get(site)
        if c is None:
            c = self._fallback_counters[site] = self._reg.counter(
                "recovery_fallbacks_total",
                "startup-recovery catch-alls that absorbed a failure, by site",
                labels={"site": site})
        c.increment()
        self.fallbacks[site] = self.fallbacks.get(site, 0) + 1

    def fallback_total(self) -> int:
        return sum(self.fallbacks.values())


wal_metrics = WalMetrics()
recovery_metrics = wal_metrics  # one surface: recovery_* lives beside wal_*


class GatewayMetrics:
    """RPC serving gateway observability (rpc/gateway.py): per-class
    request counts, queue depth, running handlers, shed counts, and
    wait/service histograms, plus the coalescing/caching counters — what
    an operator needs to see that duplicate read bursts actually share
    work and where admission is queueing or shedding."""

    _CLASSES = ("engine", "read", "tx", "debug")

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry or REGISTRY
        self._requests = {c: reg.counter(
            f"gateway_requests_total_{c}",
            f"requests admitted to the {c} class") for c in self._CLASSES}
        self._qdepth = {c: reg.gauge(
            f"gateway_queue_depth_{c}",
            f"requests waiting for a {c} slot") for c in self._CLASSES}
        self._running = {c: reg.gauge(
            f"gateway_running_{c}",
            f"handlers currently executing in the {c} class")
            for c in self._CLASSES}
        self._sheds = {c: reg.counter(
            f"gateway_sheds_total_{c}",
            f"requests shed with -32005 from the {c} class")
            for c in self._CLASSES}
        self._coalesced = {c: reg.counter(
            f"gateway_coalesced_total_{c}",
            f"{c} requests that shared an in-flight computation")
            for c in self._CLASSES}
        self._executions = reg.counter(
            "gateway_executions_total", "handler executions actually run")
        self._coalesce_factor = reg.gauge(
            "gateway_coalesce_factor",
            "coalescable requests served per execution (>1 = sharing works)")
        self._cache_hits = reg.counter("gateway_cache_hits_total")
        self._cache_misses = reg.counter("gateway_cache_misses_total")
        self._cache_hit_rate = reg.gauge(
            "gateway_cache_hit_rate", "response-cache hit fraction")
        self._invalidations = reg.counter(
            "gateway_cache_invalidations_total",
            "wholesale cache clears on canonical-head change")
        self._invalidated = reg.counter(
            "gateway_cache_invalidated_entries_total")
        self._wait = {c: reg.histogram(
            f"gateway_wait_seconds_{c}",
            f"admission wait before dispatch, {c} class",
            buckets=SUB_MS_BUCKETS)
            for c in self._CLASSES}
        self._service = {c: reg.histogram(
            f"gateway_service_seconds_{c}",
            f"handler execution wall time, {c} class",
            buckets=SUB_MS_BUCKETS)
            for c in self._CLASSES}

    def record_request(self, cls: str) -> None:
        self._requests[cls].increment()

    def set_queue_depth(self, cls: str, n: int) -> None:
        self._qdepth[cls].set(n)

    def set_running(self, cls: str, n: int) -> None:
        self._running[cls].set(n)

    def record_shed(self, cls: str) -> None:
        self._sheds[cls].increment()

    def record_coalesced(self, cls: str) -> None:
        self._coalesced[cls].increment()
        self._update_factor()

    def record_wait(self, cls: str, seconds: float) -> None:
        self._wait[cls].record(seconds)

    def record_service(self, cls: str, seconds: float) -> None:
        self._service[cls].record(seconds)
        self._executions.increment()
        self._update_factor()

    def _update_factor(self) -> None:
        ex = self._executions.value
        if ex:
            served = (ex + self._cache_hits.value
                      + sum(c.value for c in self._coalesced.values()))
            self._coalesce_factor.set(round(served / ex, 3))

    def record_cache(self, *, hit: bool) -> None:
        (self._cache_hits if hit else self._cache_misses).increment()
        total = self._cache_hits.value + self._cache_misses.value
        self._cache_hit_rate.set(round(self._cache_hits.value / total, 4))

    def record_invalidation(self, entries: int) -> None:
        self._invalidations.increment()
        self._invalidated.increment(entries)
