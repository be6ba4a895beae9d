"""The port's device supervisor (reth_tpu_torch/ops/supervisor.py), its
supervised backends and the k-level engine's fault ladder, against the JAX
package's under JAX_PLATFORMS=cpu.

The reference's "device" engines run its JAX programs on the CPU; the port's
run with device="cpu" (its kernels' plain versions). The same call sequences
give the same breaker states, trips, failovers and counters; the same
supervised commits, with the same injected faults, give the same roots,
branch nodes, failovers, effective backend and journal length at the
failover; the k-level ladder ends on the same rung with the same digests.
Tolerance zero throughout. Commits are serial where the order of guarded
calls must be deterministic.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from _torch_helpers import branches, job, prefix_jobs
from reth_tpu import metrics as jmetrics
from reth_tpu.ops import fused_commit as jfc
from reth_tpu.ops import supervisor as jsup
from reth_tpu.primitives.keccak import keccak256_batch_np as jhash
from reth_tpu.trie import committer as jcommitter
from reth_tpu.trie import turbo as jturbo
from reth_tpu_torch import metrics as pmetrics
from reth_tpu_torch.ops import fused_commit as pfc
from reth_tpu_torch.ops import supervisor as psup
from reth_tpu_torch.primitives.keccak import keccak256_batch_np as phash
from reth_tpu_torch.primitives.types import Account
from reth_tpu_torch.trie import committer as pcommitter
from reth_tpu_torch.trie import state_root as psr
from reth_tpu_torch.trie import turbo as pturbo

# (supervisor module, turbo module, committer module, metrics module, kwargs
# that put the package's device engines on the CPU)
PKGS = {"jax": (jsup, jturbo, jcommitter, jmetrics, {}),
        "port": (psup, pturbo, pcommitter, pmetrics, {"device": "cpu"})}


def _fake_probe(sup_mod, outcomes=()):
    """Probe stand-in: pops ``outcomes``, then healthy; still consults the
    injector, so probe_fail works."""
    remaining = list(outcomes)

    def probe(budget, injector=None):
        ok = remaining.pop(0) if remaining else True
        if injector is not None and not injector.on_probe():
            ok = False
        return sup_mod.ProbeResult(ok, 0.001, None if ok else "fake probe failure")

    return probe


def _supervisor(pkg, clock=None, threshold=3, reset=30.0, **kw):
    sup_mod, _, _, met, _ = PKGS[pkg]
    kw.setdefault("probe_fn", _fake_probe(sup_mod))
    kw.setdefault("registry", met.MetricsRegistry())
    kw.setdefault("dispatch_budget", 120.0)
    breaker = sup_mod.CircuitBreaker(failure_threshold=threshold, reset_timeout=reset,
                                     **({"clock": clock} if clock else {}))
    return sup_mod.DeviceSupervisor(breaker=breaker, **kw)


def _state(sup) -> dict:
    snap = sup.snapshot()
    return {k: snap[k] for k in ("breaker", "trips", "failures", "failovers",
                                 "dispatch_timeouts", "dispatch_errors", "fault_injection")}


def _commits():
    """Two serial commits' jobs: storage-like tries, then prefix subtries."""
    return [([job(25 + 11 * i, seed=i) for i in range(5)], 0),
            (prefix_jobs(250, seed=9), 2)]


def _record_failovers(monkeypatch, sup_mod) -> list:
    """Journal length of every SupervisedBackend failover, in order."""
    seen = []
    orig = sup_mod.SupervisedBackend._failover

    def failover(self, mid_commit):
        seen.append((len(self._journal), mid_commit))
        return orig(self, mid_commit)

    monkeypatch.setattr(sup_mod.SupervisedBackend, "_failover", failover)
    return seen


# -- breaker and injector ------------------------------------------------------

BREAKER_SCRIPTS = {
    "trip-halfopen-fail-backoff-close": (
        "fail", "fail", "allow", "t9.9", "allow", "t10", "allow", "fail", "t29.9", "allow",
        "t30", "allow", "ok", "fail", "fail", "t40", "allow"),
    "success-resets-count": ("fail", "fail", "ok", "fail", "fail", "allow"),
    "force-open-then-recover": ("force", "allow", "force", "t30", "allow", "ok", "allow"),
    "backoff-caps": tuple(x for i in range(6) for x in ("fail", f"t{1000 * (i + 1)}", "allow")),
}


@pytest.mark.parametrize("script", list(BREAKER_SCRIPTS))
def test_breaker_parity(script):
    """The same calls on both packages' breakers (threshold 2, 10 s reset,
    40 s cap) give the same answers, states, trips, failures and history."""
    trace = {}
    for pkg in PKGS:
        now = [0.0]
        br = PKGS[pkg][0].CircuitBreaker(failure_threshold=2, reset_timeout=10.0,
                                         max_reset_timeout=40.0, clock=lambda: now[0])
        out = []
        for op in BREAKER_SCRIPTS[script]:
            if op.startswith("t"):
                now[0] = float(op[1:])
                continue
            ret = {"fail": br.record_failure, "ok": br.record_success, "allow": br.allow,
                   "force": br.force_open}[op]()
            out.append((op, ret, br.state, br.trips, br.failures))
        trace[pkg] = (out, br.transitions)
    assert trace["port"] == trace["jax"]


ENV_CASES = {
    "none": {},
    "wedge": {"RETH_TPU_FAULT_WEDGE_EVERY": "3"},
    "delay": {"RETH_TPU_FAULT_DELAY": "0.25"},
    "probe": {"RETH_TPU_FAULT_PROBE_FAIL": "-1"},
    "pipeline": {"RETH_TPU_FAULT_PIPELINE_ABORT": "4"},
    "compile": {"RETH_TPU_FAULT_COMPILE_WEDGE": "2"},
    "device": {"RETH_TPU_FAULT_DEVICE_WEDGE": "0, 3,5"},
    "empty-values": {"RETH_TPU_FAULT_WEDGE_EVERY": "", "RETH_TPU_FAULT_DELAY": ""},
}
_INJ_FIELDS = ("wedge_every", "delay", "probe_fail", "pipeline_abort", "compile_wedge",
               "device_wedge")


@pytest.mark.parametrize("case", list(ENV_CASES))
def test_fault_injector_from_env_parity(case):
    got = {pkg: PKGS[pkg][0].FaultInjector.from_env(ENV_CASES[case]) for pkg in PKGS}
    if got["jax"] is None:
        assert got["port"] is None
        return
    for f in _INJ_FIELDS:
        assert getattr(got["port"], f) == getattr(got["jax"], f), f
    assert got["port"].active() == got["jax"].active()


INJECTOR_DRILLS = {
    "wedge-every-3": ({"wedge_every": 3}, ("dispatch",) * 8),
    "probe-fail-2": ({"probe_fail": 2}, ("probe",) * 4),
    "probe-fail-forever": ({"probe_fail": -1}, ("probe",) * 3),
    "pipeline-abort-3": ({"pipeline_abort": 3}, ("window",) * 5),
}


@pytest.mark.parametrize("drill", list(INJECTOR_DRILLS))
def test_fault_injector_call_sequences_parity(drill):
    kw, calls = INJECTOR_DRILLS[drill]
    trace = {}
    for pkg in PKGS:
        sup_mod = PKGS[pkg][0]
        inj = sup_mod.FaultInjector(**kw)
        out = []
        for c in calls:
            try:
                ret = {"dispatch": inj.on_dispatch, "probe": inj.on_probe,
                       "window": inj.on_pipeline_window}[c]()
                out.append((c, ret))
            except (sup_mod.InjectedWedge, sup_mod.InjectedPipelineAbort) as e:
                out.append((c, type(e).__name__))
        trace[pkg] = (out, inj.dispatch_count, inj.wedged, inj.probes_failed, inj.windows)
    assert trace["port"] == trace["jax"]


# -- the probe -----------------------------------------------------------------


@pytest.mark.parametrize("mode", ["rc", "timeout", "injected"])
def test_probe_failure_modes(mode):
    """A child that exits non-zero, a child past its budget, and an injected
    failure that starts no child: each a failed result with its diagnosis,
    never an exception."""
    t0 = time.monotonic()
    if mode == "rc":
        r = psup.probe_device(budget=60, code="import sys; sys.exit(3)")
        assert "rc=3" in r.diag
    elif mode == "timeout":
        r = psup.probe_device(budget=0.5, code="import time; time.sleep(30)")
        assert "exceeded" in r.diag and time.monotonic() - t0 < 10
    else:
        r = psup.probe_device(budget=60, injector=psup.FaultInjector(probe_fail=1))
        assert "injected" in r.diag and time.monotonic() - t0 < 1.0
    assert not r.ok and r.latency > 0


def test_default_probe_without_a_card_fails_within_budget():
    """The real child (torch, the port, kernel 1 on the card) on a machine
    without a card: a failed result with the child's reason, inside the
    budget, not an exception."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present (tests/test_torch_cuda.py probes it)")
    r = psup.probe_device(budget=120)
    assert not r.ok and r.latency < 120
    assert "rc=1" in r.diag and "CUDA" in r.diag


def test_probe_with_an_empty_cache_dir_fails_in_the_child(tmp_path):
    """Warm-up's compile-cache check: the child loads kernel 1 from the
    directory it is given. An empty directory (or a host without a card)
    fails the child: a failed result, not an exception."""
    r = psup.probe_device(budget=120, cache_dir=str(tmp_path))
    assert not r.ok and r.latency < 120
    assert "rc=1" in r.diag


# -- the watchdog ----------------------------------------------------------------


@pytest.mark.parametrize("pkg", list(PKGS))
@pytest.mark.parametrize("case", ["timeout", "raises", "delay"])
def test_run_guarded(pkg, case):
    """A real timeout, a wrapped exception and an injected delay above the
    budget each raise DeviceDispatchError and feed the breaker, on both
    packages alike."""
    sup_mod = PKGS[pkg][0]
    if case == "timeout":
        sup = _supervisor(pkg)
        with pytest.raises(sup_mod.DeviceDispatchError, match="watchdog"):
            sup.run_guarded(time.sleep, 2.0, what="sleepy", budget=0.05)
        assert (sup.dispatch_timeouts, sup.breaker.failures) == (1, 1)
    elif case == "raises":
        sup = _supervisor(pkg, threshold=2)

        def boom():
            raise RuntimeError("launch failed")

        for _ in range(2):
            with pytest.raises(sup_mod.DeviceDispatchError, match="launch failed"):
                sup.run_guarded(boom)
        assert sup.breaker.state == "open" and sup.route() == "numpy"
        assert sup.dispatch_timeouts == 0 and sup.dispatch_errors == 2
    else:
        sup = _supervisor(pkg, injector=sup_mod.FaultInjector(delay=0.3), dispatch_budget=0.05)
        with pytest.raises(sup_mod.DeviceDispatchError, match="watchdog"):
            sup.run_guarded(lambda: "never", what="delayed")
        assert sup.dispatch_timeouts == 1
    if pkg == "port":
        assert sup.guarded_calls == (2 if case == "raises" else 1)


# -- supervised turbo commits ------------------------------------------------------


def _auto_run(pkg, monkeypatch, wedge, sync=None):
    """Both commits of ``_commits()`` through TurboCommitter(backend="auto")
    serially, faults per ``wedge`` (None: a counting injector). Returns the
    per-commit results, backend, supervisor state and failover journal
    lengths, and the number of guarded calls."""
    sup_mod, turbo_mod, _, met, kw = PKGS[pkg]
    seen = _record_failovers(monkeypatch, sup_mod)
    sup = _supervisor(pkg, injector=sup_mod.FaultInjector(wedge_every=wedge or 0))
    auto = turbo_mod.TurboCommitter(backend="auto", min_tier=64, supervisor=sup, **kw)
    out = []
    for jobs, depth in _commits():
        res = auto.commit_hashed_many(jobs, True, depth)
        out.append(([r.root for r in res], [branches(r.branch_nodes) for r in res],
                    met.trie_metrics.last["backend"], _state(sup), list(seen)))
    return out, sup.injector.dispatch_count


def test_supervised_commits_count_the_same_guarded_calls(monkeypatch):
    """Clean runs: device routes, no failover, the same number of guarded
    calls (engine init, begin, every level's two dispatches, the fetch)."""
    got, n_port = _auto_run("port", monkeypatch, None)
    want, n_jax = _auto_run("jax", monkeypatch, None)
    assert got == want and n_port == n_jax > 3
    assert [c[2] for c in got] == ["device", "device"]


@pytest.mark.parametrize("where", ["every", "second", "mid", "terminal"])
def test_supervised_commit_fails_over_like_the_reference(monkeypatch, where):
    """wedge_every 1, 2, half the first commit's guarded calls, and exactly
    its last call (the terminal fetch, where a staging engine first meets
    the card): the same roots, branch nodes, effective backend, failovers,
    breaker state and journal length at each failover as the reference."""
    calls = _auto_run("port", monkeypatch, None)[1] // 2  # one commit's calls
    wedge = {"every": 1, "second": 2, "mid": calls // 2, "terminal": calls}[where]
    got, _ = _auto_run("port", monkeypatch, wedge)
    want, _ = _auto_run("jax", monkeypatch, wedge)
    assert got == want
    twin = pturbo.TurboCommitter(backend="numpy")
    for (jobs, depth), commit in zip(_commits(), got):
        res = twin.commit_hashed_many(jobs, True, depth)
        assert commit[0] == [r.root for r in res]
    assert got[0][2] == "numpy" and got[0][3]["failovers"] >= 1
    if where == "terminal":
        # every guarded call journaled but the engine's construction and the fetch
        assert got[0][4] == [(calls - 2, True)]


@pytest.mark.parametrize("pkg", list(PKGS))
def test_pipelined_commit_drains_onto_the_twin(pkg):
    """wedge_every=3 trips the first window's ensure: one failover, every
    window then dispatched inline on the twin, roots equal the twin's."""
    sup_mod, turbo_mod, _, met, kw = PKGS[pkg]
    jobs = prefix_jobs(300, seed=21)
    want = [r.root for r in pturbo.TurboCommitter(backend="numpy").commit_hashed_many(jobs, True, 2)]
    sup = _supervisor(pkg, injector=sup_mod.FaultInjector(wedge_every=3))
    auto = turbo_mod.TurboCommitter(backend="auto", min_tier=64, supervisor=sup, **kw)
    got = auto.commit_hashed_pipelined(jobs, True, 2, jobs_per_sweep=4)
    assert [r.root for r in got] == want
    assert sup.failovers == 1 and sup.injector.wedged == 1
    last = met.pipeline_metrics.last
    assert last["backend"] == "numpy" and last["drained_windows"] == last["windows"] > 1


@pytest.mark.parametrize("pkg", list(PKGS))
def test_open_breaker_routes_without_failover_then_recovers(pkg):
    sup_mod, turbo_mod, _, met, kw = PKGS[pkg]
    now = [0.0]
    sup = _supervisor(pkg, clock=lambda: now[0], threshold=1, reset=300.0)
    sup.breaker.force_open()
    jobs, depth = _commits()[0]
    want = [r.root for r in pturbo.TurboCommitter(backend="numpy").commit_hashed_many(jobs)]
    auto = turbo_mod.TurboCommitter(backend="auto", min_tier=64, supervisor=sup, **kw)
    assert [r.root for r in auto.commit_hashed_many(jobs)] == want
    assert sup.failovers == 0 and met.trie_metrics.last["backend"] == "numpy"
    now[0] = 300.0
    assert sup.route() == "device" and sup.breaker.transitions[-3:] == ["open", "half_open",
                                                                        "closed"]
    assert [r.root for r in auto.commit_hashed_many(jobs)] == want
    assert met.trie_metrics.last["backend"] == "device" and sup.failovers == 0


# -- TrieCommitter(supervisor=) ----------------------------------------------------


def _plain_state(seed: int):
    rng = np.random.default_rng(seed)
    accounts, storages = {}, {}
    for i in range(60):
        addr = bytes(rng.integers(0, 256, size=20, dtype=np.uint8))
        accounts[addr] = Account(nonce=i, balance=int(rng.integers(0, 10**9)))
        if i % 3 == 0:
            storages[addr] = {bytes(rng.integers(0, 256, size=32, dtype=np.uint8)):
                              int(rng.integers(1, 10**6)) for _ in range(1 + i % 7)}
    return accounts, storages


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("wedge", [0, 1, 4])
def test_supervised_state_root_matches_reference(fused, wedge):
    import importlib

    from reth_tpu.primitives.types import Account as JAccount

    jsr = importlib.import_module("reth_tpu.trie.state_root")
    accounts, storages = _plain_state(5)
    out = {}
    for pkg in PKGS:
        sup_mod, _, com, _, kw = PKGS[pkg]
        sup = _supervisor(pkg, injector=sup_mod.FaultInjector(wedge_every=wedge),
                          threshold=100)
        # the fused committer needs an explicit hasher for its key hashing
        hasher = (jhash if pkg == "jax" else phash) if fused else None
        c = com.TrieCommitter(fused=fused, min_tier=8, supervisor=sup, hasher=hasher, **kw)
        if pkg == "jax":
            accts = {a: JAccount(nonce=x.nonce, balance=x.balance) for a, x in accounts.items()}
            root, det = jsr.state_root(accts, storages, committer=c)
        else:
            root, det = psr.state_root(accounts, storages, committer=c)
        out[pkg] = (root, branches(det["branch_nodes"]), det["storage_roots"], _state(sup))
    assert out["port"] == out["jax"]
    twin = psr.state_root(accounts, storages,
                          committer=pcommitter.TrieCommitter(hasher=phash))
    assert out["port"][0] == twin[0]
    assert (out["port"][3]["dispatch_errors"] > 0) == bool(wedge)


# -- the k-level engine's ladder -----------------------------------------------------


def _levels():
    return pturbo.sweep_levels(prefix_jobs(400, seed=11), collect_branches=True, start_depth=2)


def _drive_engine(eng, levels, flush_every):
    eng.begin(max([int(lv.row_slot.max()) for lv in levels if len(lv.row_slot)]
                  + [int(lv.bmp_slot.max()) for lv in levels if len(lv.bmp_slot)]))
    for i, lv in enumerate(levels):
        eng.dispatch_packed(lv.flat, lv.row_off, lv.row_len, lv.row_slot, lv.holes, lv.b_tier)
        eng.dispatch_branch(lv.masks, lv.bmp_slot, lv.children)
        if flush_every and (i + 1) % flush_every == 0:
            eng.flush_window()
    return eng.finish()


def _fused_counts(met) -> tuple:
    fm = met.fused_metrics
    return fm._dispatches.value, fm._levels.value, fm._fallbacks.value


@pytest.mark.parametrize("flush_every", [0, 3])
@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("fault", ["wedge", "abort"])
def test_subtrie_ladder_matches_reference(fault, k, flush_every):
    """A wedged chunk replays per level, an aborted one lands on the numpy
    twin: the same final rung, fallbacks, launches and digests as the
    reference engine; the fused_metrics series move alike. The port's engine
    is built as the supervised route builds it, with its ladder armed."""
    levels = _levels()
    # at k=8 the unflushed plan is one chunk: fault the first, else the second
    kw = {"wedge_at" if fault == "wedge" else "abort_at": 2 if k == 2 else 1}
    out = {}
    for pkg, fc, met in (("jax", jfc, jmetrics), ("port", pfc, pmetrics)):
        inj = fc.SubtrieFaultInjector(**kw)
        eng = (jfc.SubtrieFusedEngine(min_tier=8, k=k, row_floor=32, hole_floor=32, injector=inj)
               if pkg == "jax" else pfc.SubtrieFusedEngine(min_tier=8, k=k, injector=inj,
                                                           ladder=True, device="cpu"))
        before = _fused_counts(met)
        buf = _drive_engine(eng, levels, flush_every)
        delta = tuple(a - b for a, b in zip(_fused_counts(met), before))
        out[pkg] = (buf, dict(met.fused_metrics.last), delta, eng.dispatches,
                    eng.levels_staged, inj.chunks, inj.wedges, inj.aborts)
    (got, *rest_p), (want, *rest_j) = out["port"], out["jax"]
    assert np.array_equal(got[1:], want[1:len(got)])
    assert rest_p == rest_j
    assert rest_p[0]["mode"] == ("perlevel" if fault == "wedge" else "cpu")
    assert rest_p[1][2] == (1 if fault == "wedge" else 2)  # fallbacks
    clean = _drive_engine(pfc.SubtrieFusedEngine(min_tier=8, k=k, device="cpu"), levels,
                          flush_every)
    assert np.array_equal(got, clean)


@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("fault", ["wedge", "abort"])
def test_subtrie_ladder_under_the_supervisor(monkeypatch, fault, k):
    """auto at subtrie_levels=k with a chunk wedged or aborted: the engine's
    own ladder absorbs it on the reference's rung (no supervisor failover,
    the device route stays), roots equal the reference's."""
    knob = "WEDGE" if fault == "wedge" else "ABORT"
    monkeypatch.setenv(f"RETH_TPU_FAULT_SUBTRIE_{knob}", "1")
    jobs = prefix_jobs(300, seed=17)
    roots = {}
    for pkg in PKGS:
        _, turbo_mod, _, met, kw = PKGS[pkg]
        sup = _supervisor(pkg)
        auto = turbo_mod.TurboCommitter(backend="auto", min_tier=64, supervisor=sup,
                                        subtrie_levels=k, **kw)
        roots[pkg] = [r.root for r in auto.commit_hashed_many(jobs, True, 2)]
        assert sup.failovers == 0 and met.trie_metrics.last["backend"] == "device"
        assert met.fused_metrics.last["mode"] == ("perlevel" if fault == "wedge" else "cpu")
    assert roots["port"] == roots["jax"]


def test_failed_launch_takes_the_ladder_only_under_the_supervisor(monkeypatch):
    """A launch that keeps failing (a poisoned context): on "device" the
    error leaves the commit after one attempt; on "auto" the k-level engine
    tries the chunk, one per-level replay, then lands on the numpy twin
    with the twin's roots and no supervisor failover."""
    jobs = prefix_jobs(300, seed=17)
    want = [r.root for r in pturbo.TurboCommitter(backend="numpy").commit_hashed_many(
        jobs, True, 2)]
    calls = []

    def failing(*args):
        calls.append(args)
        raise RuntimeError("subtrie_levels: CUDA error 719 at launch")

    monkeypatch.setattr(pfc, "subtrie_levels", failing)
    plain = pturbo.TurboCommitter(backend="device", min_tier=64, subtrie_levels=8,
                                  device="cpu")
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        plain.commit_hashed_many(jobs, True, 2)
    assert len(calls) == 1
    calls.clear()
    sup = _supervisor("port")
    auto = pturbo.TurboCommitter(backend="auto", min_tier=64, supervisor=sup, subtrie_levels=8,
                                 device="cpu")
    got = [r.root for r in auto.commit_hashed_many(jobs[:1], True, 2)]
    assert got == want[:1]
    assert pmetrics.fused_metrics.last["mode"] == "cpu" and len(calls) == 2
    assert sup.failovers == 0 and sup.breaker.failures == 0


@pytest.mark.parametrize("fault", ["wedge_at", "abort_at"])
def test_unsupervised_subtrie_engine_raises_injected_faults(fault):
    """Without the ladder an injected chunk fault leaves the engine as it
    is: no replay, no numpy rung, nothing journaled."""
    inj = pfc.SubtrieFaultInjector(**{fault: 1})
    eng = pfc.SubtrieFusedEngine(min_tier=8, k=8, injector=inj, device="cpu")
    err = pfc.InjectedSubtrieWedge if fault == "wedge_at" else pfc.InjectedSubtrieAbort
    with pytest.raises(err):
        _drive_engine(eng, _levels(), 0)
    assert eng.mode == "fused" and eng.dispatches == 0 and not eng._journal
    assert inj.chunks == 1


# -- pipeline abort ------------------------------------------------------------------


def _pipeline_threads() -> list:
    return [t for t in threading.enumerate()
            if t.name.startswith(("trie-sweep", "trie-hash", "supervised-"))]


@pytest.mark.parametrize("pkg", list(PKGS))
def test_pipeline_abort_at_the_same_window(pkg):
    """RETH_TPU_FAULT_PIPELINE_ABORT=2 through the supervisor's injector:
    the rebuild raises at window 2 and leaves no thread behind; the next
    commit on the same committer is right."""
    sup_mod, turbo_mod, _, _, kw = PKGS[pkg]
    jobs = prefix_jobs(300, seed=23)
    want = [r.root for r in pturbo.TurboCommitter(backend="numpy").commit_hashed_many(jobs, True, 2)]
    sup = _supervisor(pkg, injector=sup_mod.FaultInjector(pipeline_abort=2))
    auto = turbo_mod.TurboCommitter(backend="auto", min_tier=64, supervisor=sup, **kw)
    with pytest.raises(sup_mod.InjectedPipelineAbort, match="window #2"):
        auto.commit_hashed_pipelined(jobs, True, 2, jobs_per_sweep=4)
    assert sup.injector.windows == 2 and sup.failovers == 0
    for t in _pipeline_threads():
        t.join(timeout=30)
    assert _pipeline_threads() == []
    got = auto.commit_hashed_pipelined(jobs, True, 2, jobs_per_sweep=4)
    assert [r.root for r in got] == want


# -- metrics ----------------------------------------------------------------------


def _registry_values(registry) -> dict:
    """Counters and gauges by value, histograms by observation count."""
    out = {}
    for name, m in registry.items():
        out[name] = m.snapshot()[2] if hasattr(m, "buckets") else m.value
    return out


def test_supervisor_metrics_match_reference_after_a_drill():
    """Every dispatch wedged with a one-failure breaker, then a failed and a
    healthy half-open probe: both registries hold the same series and
    values, and the snapshots agree."""
    vals, snaps = {}, {}
    for pkg in PKGS:
        sup_mod, turbo_mod, _, met, kw = PKGS[pkg]
        reg = met.MetricsRegistry()
        now = [0.0]
        sup = _supervisor(pkg, clock=lambda: now[0], threshold=1, registry=reg,
                          injector=sup_mod.FaultInjector(wedge_every=1, probe_fail=1))
        auto = turbo_mod.TurboCommitter(backend="auto", min_tier=64, supervisor=sup, **kw)
        auto.commit_hashed_many(*_commits()[0][:1])
        now[0] = 30.0
        assert sup.route() == "numpy"   # injected probe failure: re-opens, 60 s backoff
        now[0] = 90.0
        sup.injector.wedge_every = 0
        assert sup.route() == "device"
        vals[pkg], snaps[pkg] = _registry_values(reg), _state(sup)
    assert vals["port"] == vals["jax"]
    assert snaps["port"] == snaps["jax"]
    assert vals["port"]["hasher_supervisor_failovers_total"] == 1
    assert vals["port"]["hasher_supervisor_breaker_trips_total"] == 2
    assert vals["port"]["hasher_supervisor_probes_total"] == 2


# -- the build is not a device fault ---------------------------------------------


@pytest.mark.parametrize("path", ["backend", "hasher"])
def test_failed_build_raises_instead_of_failing_over(monkeypatch, path):
    def no_nvcc(device, sources=()):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA "
                           "toolkit is installed")

    monkeypatch.setattr(psup, "load_kernels", no_nvcc)
    sup = _supervisor("port")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        if path == "backend":
            pturbo.TurboCommitter(backend="auto", min_tier=64, supervisor=sup,
                                  device="cpu").commit_hashed_many(*_commits()[0][:1])
        else:
            pcommitter.TrieCommitter(supervisor=sup, device="cpu").commit(
                [(bytes(i % 16 for i in range(64)), b"\x01")])
    assert sup.failovers == 0 and sup.breaker.failures == 0 and sup.dispatch_errors == 0
    assert sup.guarded_calls == 0


def test_supervised_seams_take_their_objects():
    """The warm-up, hash-service and mesh seams take their objects, and a
    device arena handed to SupervisedBackend is the wrong type; the mesh
    under the supervised route builds its mesh engine over the live
    members, as the reference does."""
    sup = _supervisor("port")
    with pytest.raises(TypeError, match="hot-state"):
        psup.SupervisedBackend(sup, lambda: None, arena=object(), device="cpu")
    manager, service = object(), object()
    assert psup.SupervisedHasher(sup, warmup=manager, device="cpu")._warmup is manager
    assert pturbo.TurboCommitter(backend="auto", supervisor=sup, device="cpu",
                                 hash_service=service).hash_service is service
    assert pcommitter.TrieCommitter(supervisor=sup, device="cpu",
                                    warmup=manager).hasher._warmup is manager
    from reth_tpu_torch.parallel import HashMesh

    hm = HashMesh(["cpu"] * 3, registry=pmetrics.MetricsRegistry())
    hm.mark_unhealthy(1)
    for k, engine in ((0, pfc.FusedMeshEngine), (8, pfc.SubtrieMeshEngine)):
        c = pturbo.TurboCommitter(backend="auto", supervisor=sup, device="cpu", mesh=hm,
                                  subtrie_levels=k)
        made = c._device_engine(ladder=True)
        assert type(made) is engine and made.mesh.indices == (0, 2)
    fused = pcommitter.TrieCommitter(fused=True, supervisor=sup, device="cpu", mesh=hm)
    assert isinstance(fused._engine, psup.SupervisedBackend)


@pytest.mark.parametrize("knob", [{"compile_wedge": 2}, {"device_wedge": (0, 3)},
                                  {"RETH_TPU_FAULT_COMPILE_WEDGE": "-1"},
                                  {"RETH_TPU_FAULT_DEVICE_WEDGE": "1"}])
def test_fault_knobs_arm_the_supervisors_injector_like_reference(monkeypatch, knob):
    """Both packages' supervisors start with the knob, and their injectors
    carry it: the compile wedge to the warm-up steps, the device wedge to
    every mesh dispatch, which fails attributed to the wedged member while it
    takes part (the mesh's drill, FaultInjector.on_mesh_dispatch)."""
    ((name, value),) = knob.items()
    if name.startswith("RETH_"):
        monkeypatch.setenv(name, value)
    sups = {}
    for pkg, mod, reg in (("jax", jsup, jmetrics.MetricsRegistry),
                          ("port", psup, pmetrics.MetricsRegistry)):
        inj = None if name.startswith("RETH_") else mod.FaultInjector(**knob)
        sups[pkg] = mod.DeviceSupervisor(injector=inj, registry=reg())
    j, p = sups["jax"].injector, sups["port"].injector
    assert (p.compile_wedge, p.device_wedge) == (j.compile_wedge, j.device_wedge)
    assert p.active() and j.active()
    if "device_wedge" not in name.lower():
        return
    wedged = min(p.device_wedge)
    for members in ((0, 1, 2, 3), tuple(i for i in range(4) if i not in p.device_wedge)):
        got = []
        for inj, err in ((j, jsup.InjectedDeviceWedge), (p, psup.InjectedDeviceWedge)):
            try:
                inj.on_mesh_dispatch(members)
                got.append(None)
            except err as e:
                got.append(e.device_index)
        assert got[0] == got[1] == (wedged if wedged in members else None)
    assert p.devices_wedged == j.devices_wedged == 1
