"""The port's metrics and tracing (reth_tpu_torch/metrics.py, tracing.py) and
the rebuild's and the sparse finish's reports through them, against the JAX
package's under JAX_PLATFORMS=cpu: after the same rebuild and the same
sparse commits both registries move the same metrics by the same non-time
values; a fault drill leaves the same flight-recorder record; the rebuild
reports the same stage keys, windows and spans."""

from __future__ import annotations

import threading

import numpy as np
import pytest

from _torch_helpers import job, prefix_jobs, sparse_block, sparse_state
from reth_tpu import metrics as jmetrics
from reth_tpu import tracing as jtracing
from reth_tpu.primitives.keccak import keccak256_batch_np as jhash
from reth_tpu.trie import sparse as js
from reth_tpu.trie import turbo as jturbo
from reth_tpu_torch import metrics as pmetrics
from reth_tpu_torch import tracing as ptracing
from reth_tpu_torch.primitives.keccak import keccak256_batch_np as phash
from reth_tpu_torch.trie import sparse as ts
from reth_tpu_torch.trie import turbo as tturbo


_GROUPS = (("trie_metrics", "TrieMetrics"), ("pipeline_metrics", "PipelineMetrics"),
           ("sparse_commit_metrics", "SparseCommitMetrics"))


@pytest.fixture
def registries(monkeypatch):
    """Fresh registries behind both packages' three metric groups for one
    test, so nothing else in the process moves them."""
    regs = jmetrics.MetricsRegistry(), pmetrics.MetricsRegistry()
    for name, cls in _GROUPS:
        monkeypatch.setattr(jmetrics, name, getattr(jmetrics, cls)(regs[0]))
        group = getattr(pmetrics, cls)(regs[1])
        for mod in (pmetrics, tturbo, ts):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, group)
    return regs


def _values(registry) -> dict:
    """Each metric's value: counters and gauges as numbers, histograms as
    (per-bucket counts, n); time metrics (names with "seconds") as their
    observation count only."""
    out = {}
    for name, m in registry.items():
        if hasattr(m, "buckets"):
            counts, _total, n = m.snapshot()
            out[name] = n if "seconds" in name else (tuple(counts), n)
        elif "seconds" not in name:
            out[name] = m.value
    return out


def _drive(turbo, sparse, hasher, **kw):
    """The same rebuilds (serial, and pipelined one sweep a window) and the
    same sparse commits (a classic and a fused finish) in either package."""
    dev = turbo.TurboCommitter(backend="device", min_tier=64, **kw)
    dev.commit_hashed_many([job(30 + 7 * i, seed=i) for i in range(4)], True)
    dev.commit_hashed_pipelined(prefix_jobs(200, seed=3), True, 2, pack_window=1,
                                jobs_per_sweep=16)
    st, owners, keys = sparse_state(sparse, 12)
    for k in (0, 8):
        c = sparse.ParallelSparseCommitter(workers=4, subtrie_levels=k, **kw)
        if sparse is js:  # the port launches exact row counts, no floors
            c.SUBTRIE_ROW_FLOOR = c.SUBTRIE_HOLE_FLOOR = 64
        st.root(hasher, committer=c)
        sparse_block(st, owners, keys, seed=13 + k)


def test_registries_move_the_same_metrics_by_the_same_values(registries):
    reg_j, reg_p = registries
    _drive(jturbo, js, jhash)
    _drive(tturbo, ts, phash, device="cpu")
    want, got = _values(reg_j), _values(reg_p)
    assert got == want
    assert {name for name, _ in reg_p.items()} == {name for name, _ in reg_j.items()}
    assert got["trie_commits_total"] == 2 and got["sparse_commit_commits_total"] == 2
    assert got["trie_commit_nodes_total_device"] > 0 and got["trie_pipeline_windows_total"] > 0
    assert pmetrics.trie_metrics.last["backend"] == "device"
    for key in ("nodes", "levels", "leaves", "wire_bytes", "backend"):
        assert pmetrics.trie_metrics.last[key] == jmetrics.trie_metrics.last[key]
    assert reg_p.render().count("# TYPE") == reg_j.render().count("# TYPE")


@pytest.mark.parametrize("pack_window,jobs_per_sweep", [(1, 4), (1, 64), (3, 64)])
def test_rebuild_reports_stages_windows_and_spans(registries, pack_window, jobs_per_sweep):
    """The pipelined rebuild on the numpy twin: the same stage keys and the
    same windows (with one sweep a window, windows are the sweep groups),
    and the same trie::pipeline spans when tracing is on."""
    jobs = prefix_jobs(300, seed=8)
    knobs = dict(pack_window=pack_window, jobs_per_sweep=jobs_per_sweep, sweep_workers=1)
    out = []
    for mod, met, trc in ((jturbo, jmetrics, jtracing), (tturbo, pmetrics, ptracing)):
        was_on = trc.trace_enabled()
        trc.set_trace_enabled(True)
        try:
            trc.flight_recorder().clear()
            pipe = mod.RebuildPipeline(mod._NumpyBackend(), **knobs)
            res = pipe.run(jobs, True, 2)
        finally:
            trc.set_trace_enabled(was_on)
        spans = [(r["target"], r["name"], sorted(r["fields"]))
                 for r in trc.flight_snapshot() if r["target"] == "trie::pipeline"]
        out.append((pipe, dict(met.pipeline_metrics.last), spans, [r.root for r in res]))
    (jp, jlast, jspans, jroots), (pp, plast, pspans, proots) = out
    assert proots == jroots
    assert set(plast) == set(jlast)
    assert {k: plast[k] for k in ("jobs", "groups", "drained_windows", "backend")} == \
        {k: jlast[k] for k in ("jobs", "groups", "drained_windows", "backend")}
    assert plast["backend"] == "numpy"
    if pack_window == 1:
        assert pp.windows == jp.windows == plast["windows"] == jlast["windows"] == plast["groups"]
    assert pp.wire_bytes == jp.wire_bytes > 0
    for pipe, spans in ((jp, jspans), (pp, pspans)):
        assert [s[1] for s in spans].count("rebuild.window") == pipe.windows
    assert [s for s in pspans if s[1] == "rebuild"] == [s for s in jspans if s[1] == "rebuild"]
    assert {s[:2] for s in pspans} == {("trie::pipeline", "rebuild"),
                                       ("trie::pipeline", "rebuild.window")}


def test_sparse_abort_drill_leaves_the_same_record(tmp_path, monkeypatch):
    """RETH_TPU_FAULT_SPARSE_ABORT fires fault_event: the same event record
    in the flight recorder and the same dump header keys and reason."""
    monkeypatch.setenv("RETH_TPU_FLIGHT_DIR", str(tmp_path))
    recs, headers = [], []
    for mod, trc, hasher in ((js, jtracing, jhash), (ts, ptracing, phash)):
        trc.reset_fault_dump_limits()
        t = mod.SparseTrie()
        t.update(b"\x11" * 32, b"v1" * 20)
        kw = {} if mod is js else {"device": "cpu"}
        c = mod.ParallelSparseCommitter(workers=1, injector=mod.SparseFaultInjector(abort_at=1),
                                        **kw)
        with pytest.raises(mod.InjectedSparseAbort):
            c.commit([t], hasher)
        rec = [r for r in trc.flight_snapshot() if r["name"] == "RETH_TPU_FAULT_SPARSE_ABORT"][-1]
        recs.append({k: v for k, v in rec.items() if k not in ("ts", "thread")})
        dump = trc.flight_recorder().dumps[-1]
        assert "SPARSE_ABORT" in dump and dump.startswith(str(tmp_path))
        header, records = trc.load_flight_dump(dump)
        assert any(r["name"] == "RETH_TPU_FAULT_SPARSE_ABORT" for r in records)
        headers.append((sorted(header), header["reason"], header["kind"],
                        header["correlation_id"] is not None))
    assert recs[1] == recs[0]
    assert recs[0]["fields"] == {"dispatch": 1} and recs[0]["kind"] == "event"
    assert headers[1] == headers[0]


def test_span_nesting_and_context_handoff_match_reference():
    """span / use_context / record_span build the same parent links."""
    shapes = []
    for trc in (jtracing, ptracing):
        was_on = trc.trace_enabled()
        trc.set_trace_enabled(True)
        try:
            trc.flight_recorder().clear()
            with trc.span("trie::sparse", "outer", n=1):
                ctx = trc.current_context()
                with trc.span("trie::sparse", "inner"):
                    pass
            with trc.use_context(ctx):
                trc.record_span("trie::sparse", "handed", 0.0, 0.001, ctx=trc.current_context(),
                                fields={"chunks": 2})
            trc.event("trie::sparse", "ping", x=3)
            recs = [r for r in trc.flight_snapshot()
                    if r["thread"] == threading.current_thread().name]
        finally:
            trc.set_trace_enabled(was_on)
        ids = {r["span"]: r["name"] for r in recs if r["span"] is not None}
        shapes.append([(r["kind"], r["name"], ids.get(r["parent"]), r["fields"]) for r in recs])
    assert shapes[1] == shapes[0]
    assert ptracing.current_context() is None


def test_registry_renders_prometheus_text():
    reg = pmetrics.MetricsRegistry()
    ref = jmetrics.MetricsRegistry()
    for r in (reg, ref):
        r.counter("a_total").increment(3)
        r.counter("b_total", labels={"x": "1"}).increment()
        r.gauge("g").set(2)
        r.histogram("h_seconds", buckets=(0.1, 1)).record(0.5)
    assert reg.render() == ref.render()
    with pytest.raises(TypeError):
        reg.gauge("a_total")
    with pytest.raises(ValueError):
        reg.histogram("h_seconds", buckets=(0.2,))
    assert np.isclose(reg.histogram("h_seconds").snapshot()[1], 0.5)


def _hotstate_values(reg) -> dict:
    return {name: (type(m).__name__, m.help, m.snapshot() if hasattr(m, "buckets") else m.value)
            for name, m in reg.items()}


def test_hotstate_metrics_match_reference(monkeypatch):
    """HotStateMetrics: the same hotstate_* names, types, help and values
    after the same cache and arena records, and then after the same arena
    commits and cache absorbs of both packages (fresh registries, patched
    in where each package records)."""
    from reth_tpu.ops import fused_commit as jfc
    from reth_tpu.trie import hot_cache as jhc
    from reth_tpu_torch.ops import fused_commit as pfc
    from reth_tpu_torch.trie import hot_cache as phc

    regs = jmetrics.MetricsRegistry(), pmetrics.MetricsRegistry()
    groups = jmetrics.HotStateMetrics(regs[0]), pmetrics.HotStateMetrics(regs[1])
    monkeypatch.setattr(jmetrics, "hotstate_metrics", groups[0])
    monkeypatch.setattr(pmetrics, "hotstate_metrics", groups[1])
    monkeypatch.setattr(ts, "hotstate_metrics", groups[1])
    stats = [{"entries": 4, "hits": 10, "misses": 2, "stale_drops": 1, "poison_caught": 0,
              "evictions": 0, "puts": 9, "clears": 0},
             {"entries": 5, "hits": 14, "misses": 3, "stale_drops": 1, "poison_caught": 2,
              "evictions": 1, "puts": 12, "clears": 1}]
    for g in groups:
        for s in stats:
            g.record_cache(s)
        g.record_arena({"resident_rows": 7, "leaked_rows": 0, "evictions": 1, "faults": 1,
                        "delta_epochs": 3, "full_epochs": 2}, delta_fraction=0.3,
                       staged_rows=3, stamped_rows=7, h2d_bytes=5000, fresh=False)
    assert _hotstate_values(regs[1]) == _hotstate_values(regs[0])
    assert groups[1].last == groups[0].last
    assert groups[1].last["hit_rate"] == pytest.approx(14 / 17, abs=1e-3)
    assert {n for n, _ in regs[1].items()} >= {
        "hotstate_cache_hits_total", "hotstate_cache_entries", "hotstate_arena_resident_rows",
        "hotstate_delta_upload_fraction", "hotstate_h2d_bytes_per_commit"}

    for sparse, hc, fc, hasher, kw in ((js, jhc, jfc, jhash, {}), (ts, phc, pfc, phash,
                                                                   {"device": "cpu"})):
        st, owners, keys = sparse_state(sparse, 31, tries=4, slots=12)
        c = sparse.ParallelSparseCommitter(workers=1, arena=fc.DigestArena(), **kw)
        if sparse is js:
            c.SUBTRIE_ROW_FLOOR = c.SUBTRIE_HOLE_FLOOR = 64
        cache = hc.TrieNodeCache(injector=None)
        for block in range(3):
            if block:
                sparse_block(st, owners, keys, seed=40 + block)
            st.root(hasher, committer=c)
            cache.absorb_block(st, owners, {o: keys[o] for o in owners})
    want, got = _hotstate_values(regs[0]), _hotstate_values(regs[1])
    # the staged layout is the port's own (64-bit indices, staged row
    # offsets), so the bytes staged per commit differ from the reference's
    assert {k: v for k, v in got.items() if k != "hotstate_h2d_bytes_per_commit"} == \
        {k: v for k, v in want.items() if k != "hotstate_h2d_bytes_per_commit"}
    assert got["hotstate_h2d_bytes_per_commit"][2][2] == want["hotstate_h2d_bytes_per_commit"][2][2]
    assert got["hotstate_arena_delta_epochs_total"][2] == 2 + 3


# -- the RPC's helpers ---------------------------------------------------------


@pytest.mark.parametrize("wire", [
    None, "garbage", 7, {}, {"t": "ab" * 32, "s": 5, "r": "node", "p": 1}, {"t": "abc"},
    {"s": 9}, {"t": ""}, {"t": 3}, {"s": "9"}, {"t": None, "s": None}, {"t": "x", "s": None},
])
def test_context_from_wire_matches_reference(wire):
    want, got = jtracing.context_from_wire(wire), ptracing.context_from_wire(wire)
    assert (got is None) == (want is None)
    if want is not None:
        assert (got.trace_id, got.span_id) == (want.trace_id, want.span_id)


def test_recent_traces_matches_reference():
    """The same block traces, oldest first, bounded as the reference's. The
    traces made here are dropped after, as are the ones they evicted kept:
    each package's timelines are process-wide, and a later test may look a
    trace id up (``tests/test_observability.py`` expects none at 0)."""
    seen = []
    for trc in (jtracing, ptracing):
        was_on = trc.trace_enabled()
        trc.set_trace_enabled(True)
        with trc._TL_LOCK:
            kept = (trc._TIMELINES.copy(), trc._SUMMARIES.copy())
        try:
            before = trc.recent_traces()
            ids = [f"{i:064x}" for i in range(3)] + [f"{1:064x}"]
            for tid in ids:
                with trc.trace_block(tid, number=1):
                    pass
            after = trc.recent_traces()
        finally:
            trc.set_trace_enabled(was_on)
            with trc._TL_LOCK:
                for table, old in zip((trc._TIMELINES, trc._SUMMARIES), kept):
                    table.clear()
                    table.update(old)
        seen.append(([t for t in after if t in ids], after[-3:], len(after) <= 64,
                     set(after) <= set(before) | set(ids)))
    assert seen[1] == seen[0]
    assert seen[0][0] == [f"{0:064x}", f"{2:064x}", f"{1:064x}"]


@pytest.mark.parametrize("samples,pct", [([], 50), ([5], 0), ([5], 100), ([1, 2, 3, 4], 60),
                                         (list(range(100)), 99), ([3, 3, 9], 50)])
def test_sample_percentile_matches_reference(samples, pct):
    assert pmetrics.sample_percentile(samples, pct) == jmetrics.sample_percentile(samples, pct)


def test_update_process_metrics_sets_the_reference_gauges():
    """The same gauges after one scrape; the build identity's labels name
    torch where the reference's name jax."""
    regs = jmetrics.MetricsRegistry(), pmetrics.MetricsRegistry()
    jmetrics.update_process_metrics(regs[0])
    pmetrics.update_process_metrics(regs[1])
    names = [sorted(n.split("{")[0] for n, _ in r.items()) for r in regs]
    assert names[1] == names[0]
    assert "process_resident_memory_bytes" in names[1]
    info = dict(regs[1].items())["reth_tpu_build_info"]
    ref_info = dict(regs[0].items())["reth_tpu_build_info"]
    assert info.value == ref_info.value == 1
    assert set(info.labels) - {"torch"} == set(ref_info.labels) - {"jax"}
    assert info.labels["version"] == ref_info.labels["version"]
    assert info.labels["backend"] in ("cpu", "cuda") and "torch" in info.labels
    assert regs[1].render().count("# TYPE") == regs[0].render().count("# TYPE")


def test_gateway_metrics_match_reference():
    """GatewayMetrics: the same gateway_* names, types, help and values
    after the same records (time histograms by their counts)."""
    regs = jmetrics.MetricsRegistry(), pmetrics.MetricsRegistry()
    groups = jmetrics.GatewayMetrics(regs[0]), pmetrics.GatewayMetrics(regs[1])
    for g in groups:
        for cls in ("engine", "read", "read", "tx", "debug"):
            g.record_request(cls)
            g.record_wait(cls, 0.001)
            g.record_service(cls, 0.002)
        g.set_queue_depth("read", 3)
        g.set_running("debug", 1)
        g.record_shed("tx")
        g.record_coalesced("read")
        g.record_cache(hit=True)
        g.record_cache(hit=False)
        g.record_cache(hit=True)
        g.record_invalidation(5)
    helps = [{n: (type(m).__name__, m.help) for n, m in r.items()} for r in regs]
    assert helps[1] == helps[0]
    assert _values(regs[1]) == _values(regs[0])
    # the factor moves on executions and coalesced joins: (5 + 1) / 5
    assert _values(regs[1])["gateway_coalesce_factor"] == pytest.approx(1.2)
