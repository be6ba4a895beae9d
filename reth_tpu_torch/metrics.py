"""Metrics registry of the port: counters, gauges and histograms with a
Prometheus text rendering, and the state commitment's three metric groups.

Port of the part of the JAX package's ``metrics.py`` that the rebuild, the
sparse finish and the device supervisor report through, under the same
metric names: ``TrieMetrics`` (one record per commit), ``PipelineMetrics``
(the pipelined rebuild's stage times, windows and queue),
``SparseCommitMetrics`` (the live-tip finish), ``FusedCommitMetrics`` (the
fused engines' launches and the k-level engine's fault ladder),
``SupervisorMetrics`` (the breaker, failovers, watchdog timeouts and
probes) and ``HotStateMetrics`` (the hot-state plane's node cache and
device digest arena). The module-level instances record into the process-wide
``REGISTRY``, as in the reference. The node's process and build-identity
gauges are not ported.
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
