"""The port's shared hash service (reth_tpu_torch/ops/hash_service.py) against
the JAX package's ops/hash_service.py under JAX_PLATFORMS=cpu.

Both services run numpy backends, so a test can hold the port's digests and
its deterministic counters (dispatches, coalesced requests, replays,
rejects, leases, bypasses) equal to the reference's on the same inputs:
a lone request, a mixed-lane burst under a lease, the replay count under
wedge_every, rejects under backpressure. Window requests run the port's
SubtrieFusedEngine on device="cpu" (kernel 4's plain version) against the
JAX engine; the sparse finish streams on the live lane and hands its fused
window to commit_window in both packages; a leased TurboCommitter rebuild
runs the port's MegaFusedEngine on the CPU. Tolerance zero: digests, digest
buffers (from slot 1: the JAX engine writes its dummy slot 0), roots and
BranchNodes (field for field) are equal byte for byte."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from _torch_helpers import branches, job, sparse_block, sparse_state
from reth_tpu.metrics import MetricsRegistry as JRegistry
from reth_tpu.ops import hash_service as jhs
from reth_tpu.primitives.keccak import keccak256_batch_np as jhash
from reth_tpu.trie import sparse as js
from reth_tpu.trie.turbo import TurboCommitter as JTurboCommitter
from reth_tpu_torch import metrics as pmetrics
from reth_tpu_torch.ops import _build
from reth_tpu_torch.ops import hash_service as phs
from reth_tpu_torch.ops import supervisor as psup
from reth_tpu_torch.primitives.keccak import keccak256, keccak256_batch_np
from reth_tpu_torch.primitives.nibbles import unpack_nibbles
from reth_tpu_torch.primitives.rlp import rlp_encode
from reth_tpu_torch.trie import sparse as ts
from reth_tpu_torch.trie.committer import TrieCommitter
from reth_tpu_torch.trie.turbo import TurboCommitter, _NumpyBackend

PKGS = {"jax": (jhs, JRegistry, jhash), "port": (phs, pmetrics.MetricsRegistry,
                                                 keccak256_batch_np)}
COUNTERS = ("dispatches", "coalesced_requests", "hashed_msgs", "replays", "rejects", "leases",
            "lease_bypasses", "window_dispatches")
STATS = ("tries", "levels", "dispatches", "hashed", "encode_chunks", "pooled_levels", "streamed")


def _svc(pkg="port", **kw):
    mod, reg, hasher = PKGS[pkg]
    kw.setdefault("backend", hasher)
    kw.setdefault("registry", reg())
    kw.setdefault("min_tier", 8)
    if pkg == "port":
        kw.setdefault("device", "cpu")
    return mod.HashService(**kw)


def _supervised(pkg: str) -> dict:
    """The port replays a fault on the twin only under a supervisor (the
    reference replays unsupervised): the keyword that arms the replay."""
    if pkg == "jax":
        return {}
    return {"supervisor": psup.DeviceSupervisor(
        probe_fn=lambda budget, injector=None: psup.ProbeResult(True, 0.001),
        registry=pmetrics.MetricsRegistry())}


def _counters(svc) -> dict:
    return {k: getattr(svc, k) for k in COUNTERS}


def _msgs(seed: int, n: int, lo: int = 1, hi: int = 300) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(rng.integers(lo, hi)), dtype=np.uint8).tobytes()
            for _ in range(n)]


@pytest.fixture
def svc():
    s = _svc()
    yield s
    s.stop()


# -- core correctness ---------------------------------------------------------------


def test_single_request_roundtrip():
    """A lone request: the same digests and the same counters as the
    reference's (one dispatch of one request)."""
    msgs = _msgs(1, 10)
    out, counts = [], []
    for pkg in PKGS:
        s = _svc(pkg)
        out.append(s.client("live")(msgs))
        s.stop()
        counts.append(_counters(s))
    assert out[0] == out[1] == [keccak256(m) for m in msgs]
    assert counts[0] == counts[1]
    assert counts[1]["dispatches"] == counts[1]["coalesced_requests"] == 1


def test_lone_request_skips_coalescing_window():
    s = _svc(window_s=0.25)
    t0 = time.monotonic()
    s.client("live")([b"solo"])
    elapsed = time.monotonic() - t0
    s.stop()
    assert elapsed < 0.2, f"lone request waited the window ({elapsed:.3f}s)"


def test_empty_request_fast_path(svc):
    assert svc.client("proof")([]) == []
    assert svc.submit_window("live", [], 0).result() == []
    assert svc.dispatches == 0


def test_lane_names_validated(svc):
    assert phs.LANES == jhs.LANES and phs.DEFAULT_WAIT_BUDGETS == jhs.DEFAULT_WAIT_BUDGETS
    with pytest.raises(ValueError):
        svc.client("turbo-boost")
    with pytest.raises(ValueError):
        svc.submit("nope", [b"x"])
    with pytest.raises(ValueError):
        svc.submit_window("nope", [{"slots": [1]}], 1)


def test_multithreaded_stress_bit_identical_and_coalesced():
    """Sixteen clients on the four lanes, six small batches each: digests
    equal to direct hashing, far fewer dispatches than requests, and the
    metrics and lane waits say so."""
    reg = pmetrics.MetricsRegistry()
    s = _svc(registry=reg, window_s=0.004, fill_target=512)
    results: dict = {}
    errors: list = []

    def client_thread(i: int):
        client = s.client(phs.LANES[i % len(phs.LANES)])
        try:
            for j in range(6):
                msgs = _msgs(100 * i + j, 7)
                results[(i, j)] = (msgs, client(msgs))
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client_thread, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    s.stop()
    assert not errors and len(results) == 96
    for msgs, digests in results.values():
        assert digests == keccak256_batch_np(msgs)
    assert s.dispatches < 96 and s.coalesce_factor() > 1.0
    rendered = reg.render()

    def sample(name: str) -> float:
        return float(next(ln for ln in rendered.splitlines() if ln.startswith(name + " ")).split()[1])

    assert sample("hash_service_coalesce_factor") > 1.0
    assert 0.0 < sample("hash_service_batch_occupancy") <= 1.0
    for lane in phs.LANES:
        assert f"hash_service_queue_depth_{lane} 0" in rendered
    waits = s.lane_waits()
    assert sum(w["n"] for w in waits.values()) == 96
    assert all(w["p50_ms"] <= w["p99_ms"] for w in waits.values())


def test_metric_names_match_the_reference():
    regs = [JRegistry(), pmetrics.MetricsRegistry()]
    for pkg, reg in zip(PKGS, regs):
        _svc(pkg, registry=reg).stop()
    assert sorted(n for n, _ in regs[1].items()) == sorted(n for n, _ in regs[0].items())


def test_mixed_lane_burst_single_dispatch():
    """Requests queued under a lease drain as ONE dispatch on release, in
    priority order; the counters equal the reference's."""
    seen = {p: [] for p in PKGS}
    counts = []
    for pkg, (_m, _r, hasher) in PKGS.items():
        def backend(msgs, pkg=pkg, hasher=hasher):
            seen[pkg].append(list(msgs))
            return hasher(msgs)

        s = _svc(pkg, backend=backend, window_s=0.01, lease_bypass_s=10.0)
        futs = {}
        with s.lease("hold"):
            for lane, payload in (("proof", b"p"), ("live", b"l"), ("rebuild", b"r"),
                                  ("payload", b"b")):
                futs[lane] = s.submit(lane, [payload])
                time.sleep(0.002)
        out = {lane: f.result(5.0) for lane, f in futs.items()}
        s.stop()
        assert out == {lane: [keccak256(p)] for lane, p in
                       (("proof", b"p"), ("live", b"l"), ("rebuild", b"r"), ("payload", b"b"))}
        counts.append(_counters(s))
    assert seen["port"] == seen["jax"] == [[b"l", b"b", b"r", b"p"]]
    assert counts[0] == counts[1]


def test_aging_promotes_starved_lane():
    seen: list = []

    def backend(msgs):
        seen.append(list(msgs))
        return keccak256_batch_np(msgs)

    s = _svc(backend=backend, window_s=0.05, age_promote_s=0.01, lease_bypass_s=10.0)
    with s.lease("hold"):
        f_proof = s.submit("proof", [b"old"])
        time.sleep(0.03)
        f_live = s.submit("live", [b"new"])
    f_proof.result(5.0), f_live.result(5.0)
    s.stop()
    assert seen[0][0] == b"old"


# -- backpressure ---------------------------------------------------------------------


def test_backpressure_rejects_when_asked_not_to_block():
    counts = []
    for pkg in PKGS:
        s = _svc(pkg, lane_capacity=4, window_s=0.5, lease_bypass_s=10.0)
        with s.lease("hold"):
            s.submit("proof", [b"a"] * 4)
            with pytest.raises(PKGS[pkg][0].LaneOverloaded):
                s.submit("proof", [b"b"], block=False)
            f = s.submit("live", [b"c"], block=False)
        assert f.result(5.0) == [keccak256(b"c")]
        s.stop()
        counts.append(_counters(s))
    assert counts[0] == counts[1] and counts[1]["rejects"] == 1


def test_backpressure_blocks_then_completes():
    s = _svc(lane_capacity=8, window_s=0.001)
    done: list = []

    def submitter():
        for i in range(30):
            done.append(s.client("rebuild")([b"%d" % i] * 4))

    t = threading.Thread(target=submitter)
    t.start()
    t.join(timeout=30)
    alive = t.is_alive()
    s.stop()
    assert not alive
    assert done == [[keccak256(b"%d" % i)] * 4 for i in range(30)]


def test_backpressure_timeout():
    counts = []
    for pkg in PKGS:
        s = _svc(pkg, lane_capacity=2, window_s=0.5, lease_bypass_s=10.0)
        with s.lease("hold"):
            s.submit("proof", [b"a", b"b"])
            with pytest.raises(PKGS[pkg][0].LaneOverloaded):
                s.submit("proof", [b"c"], timeout=0.05)
        s.stop()
        counts.append(_counters(s))
    assert counts[0] == counts[1]


def test_oversized_request_admitted_alone():
    s = _svc(lane_capacity=4, window_s=0.001)
    msgs = [b"%d" % i for i in range(64)]
    assert s.client("rebuild")(msgs) == [keccak256(m) for m in msgs]
    s.stop()


# -- the exclusive lease -----------------------------------------------------------------


def test_lease_pauses_device_dispatch_and_bypasses_aged():
    counts = []
    for pkg, (_m, _r, hasher) in PKGS.items():
        calls: list = []

        def backend(msgs, calls=calls, hasher=hasher):
            calls.append(len(msgs))
            return hasher(msgs)

        s = _svc(pkg, backend=backend, window_s=0.002, lease_bypass_s=0.01)
        with s.lease("rebuild"):
            assert s.snapshot()["leased_by"] == "rebuild"
            assert s.submit("live", [b"tip"]).result(5.0) == [keccak256(b"tip")]
            assert calls == []  # completed while leased, on the twin
        s.stop()
        counts.append(_counters(s))
    assert counts[0] == counts[1]
    assert (counts[1]["lease_bypasses"], counts[1]["leases"]) == (1, 1)


def _jobs(n=400, seed=7):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    keys = np.unique(keys.view("S32").ravel()).view(np.uint8).reshape(-1, 32)
    vals = [rlp_encode(bytes(rng.integers(0, 256, size=1 + i % 29, dtype=np.uint8)))
            for i in range(len(keys))]
    half = len(keys) // 2
    return [(keys[:half], vals[:half]), (keys[half:], vals[half:])]


def test_lease_backend_wraps_turbo_commit():
    """TurboCommitter(hash_service=) holds the lease for each device commit
    and drops it on an aborted one; the numpy backend takes none. Roots
    equal the reference's."""
    jobs = _jobs()
    want = [r.root for r in JTurboCommitter(backend="numpy").commit_hashed_many(jobs)]
    s = _svc(window_s=0.001)
    leased = TurboCommitter(backend="numpy", hash_service=s)
    assert [r.root for r in leased.commit_hashed_many(jobs)] == want
    assert s.leases == 0
    dev = TurboCommitter(backend="device", hash_service=s, device="cpu")
    assert [r.root for r in dev.commit_hashed_many(jobs)] == want  # MegaFusedEngine, plain
    assert s.leases == 1
    with s._cond:
        assert not s._leased
    dev.supervisor = type("S", (), {"injector": psup.FaultInjector(pipeline_abort=1)})()
    with pytest.raises(psup.InjectedPipelineAbort):
        dev.commit_hashed_pipelined(jobs, pack_window=1, sweep_workers=1, leaves_per_sweep=64)
    with s._cond:
        assert not s._leased
    assert s.leases == 2
    # a commit that fails mid-way drops the lease too
    dev.supervisor = None
    dev._device_engine = lambda: _FailingEngine()
    with pytest.raises(RuntimeError, match="launch failed"):
        dev.commit_hashed_many(jobs)
    with s._cond:
        assert not s._leased
    assert s.client("live")([b"post"]) == [keccak256(b"post")]
    s.stop()


class _FailingEngine(_NumpyBackend):
    def dispatch_branch(self, masks, slots, children):
        raise RuntimeError("launch failed")


@pytest.mark.parametrize("pipelined", [False, True])
def test_leased_rebuild_matches_reference(pipelined):
    """A leased rebuild on the port's default engine (MegaFusedEngine, the
    level kernels' plain versions): roots and BranchNodes equal to the
    reference's numpy rebuild, one lease per commit, while a live client
    keeps submitting (its requests complete, on the twin when they age)."""
    jobs = [job(300, seed=s) for s in range(3)]
    ref = JTurboCommitter(backend="numpy")
    s = _svc(window_s=0.001, lease_bypass_s=0.005)
    port = TurboCommitter(backend="device", hash_service=s, device="cpu")
    stop = threading.Event()
    live_out: list = []

    def live():
        i = 0
        while not stop.is_set():
            msgs = [b"live-%d" % i]
            live_out.append((msgs, s.client("live")(msgs)))
            i += 1

    t = threading.Thread(target=live)
    t.start()
    try:
        for _ in range(2):
            if pipelined:
                got = port.commit_hashed_pipelined(jobs, collect_branches=True)
                want = ref.commit_hashed_pipelined(jobs, collect_branches=True)
            else:
                got = port.commit_hashed_many(jobs, collect_branches=True)
                want = ref.commit_hashed_many(jobs, collect_branches=True)
            assert [r.root for r in got] == [r.root for r in want]
            assert [branches(r.branch_nodes) for r in got] == \
                [branches(r.branch_nodes) for r in want]
    finally:
        stop.set()
        t.join()
    s.stop()
    assert s.leases == 2 and s.replays == 0
    assert live_out and all(d == keccak256_batch_np(m) for m, d in live_out)


# -- failover and fault injection ---------------------------------------------------------


def _wedged_burst(pkg: str, **kw):
    """wedge_every=1 on a burst of 12 requests queued under a lease: one
    coalesced dispatch, which wedges before it reaches the backend."""
    mod, _r, hasher = PKGS[pkg]
    calls: list = []

    def backend(msgs):  # pragma: no cover - never runs
        calls.append(len(msgs))
        return hasher(msgs)

    inj = mod.ServiceFaultInjector(wedge_every=1)
    s = _svc(pkg, backend=backend, injector=inj, window_s=0.002, lease_bypass_s=10.0, **kw)
    with s.lease("hold"):
        futs = [s.submit(phs.LANES[i % 4], [b"w%d" % i, b"v%d" % i]) for i in range(12)]
    for f in futs:
        f._event.wait(10.0)
    s.stop()
    assert [f.completions for f in futs] == [1] * 12 and calls == []
    return s, futs, inj


def test_injected_wedge_replays_on_twin_every_future_completes():
    """Under a supervisor the one coalesced dispatch wedges and replays on
    the twin, every future completes once, and the counters equal the
    reference's. Without one, every future raises the wedge and nothing is
    replayed."""
    counts = []
    for pkg in PKGS:
        s, futs, inj = _wedged_burst(pkg, **_supervised(pkg))
        outs = [f.result(0) for f in futs]
        assert outs == [[keccak256(b"w%d" % i), keccak256(b"v%d" % i)] for i in range(12)]
        counts.append((_counters(s), inj.wedged))
    assert counts[0] == counts[1]
    assert counts[1][0]["replays"] == 1 and counts[1][1] == 1
    s, futs, inj = _wedged_burst("port")
    for f in futs:
        with pytest.raises(phs.InjectedServiceWedge):
            f.result(0)
    assert (s.replays, s.failed_dispatches, s.dispatches, inj.wedged) == (0, 1, 0, 1)


@pytest.mark.parametrize("every", [2, 3])
def test_wedge_every_replay_count_matches_reference(every):
    """Sequential requests: every Nth dispatch wedges; the supervised port's
    replay count is the reference's. Unsupervised, the wedged requests raise
    and the others hash."""
    counts = []
    for pkg, (mod, _r, _h) in PKGS.items():
        s = _svc(pkg, injector=mod.ServiceFaultInjector(wedge_every=every), **_supervised(pkg))
        for i in range(7):
            assert s.client("payload")([b"s%d" % i]) == [keccak256(b"s%d" % i)]
        s.stop()
        counts.append(_counters(s))
    assert counts[0] == counts[1] and counts[1]["replays"] == 7 // every
    s = _svc(injector=phs.ServiceFaultInjector(wedge_every=every))
    raised = []
    for i in range(7):
        try:
            assert s.client("payload")([b"s%d" % i]) == [keccak256(b"s%d" % i)]
        except phs.InjectedServiceWedge:
            raised.append(i + 1)
    s.stop()
    assert raised == [n for n in range(1, 8) if n % every == 0]
    assert (s.replays, s.failed_dispatches, s.dispatches) == (0, 7 // every, 7 - 7 // every)


def test_supervised_backend_mid_dispatch_trip_fails_over():
    sup = psup.DeviceSupervisor(dispatch_budget=30.0, injector=psup.FaultInjector(wedge_every=1),
                                probe_fn=lambda budget, injector=None: psup.ProbeResult(True, 0.001),
                                registry=pmetrics.MetricsRegistry())
    hasher = psup.SupervisedHasher(sup, device_hasher=keccak256_batch_np, device="cpu")
    s = _svc(backend=hasher, supervisor=sup, window_s=0.002)
    msgs = _msgs(3, 40)
    futs = [s.submit("live", msgs[i:i + 4]) for i in range(0, 40, 4)]
    outs = [f.result(15.0) for f in futs]
    s.stop()
    assert [d for out in outs for d in out] == [keccak256(m) for m in msgs]
    assert [f.completions for f in futs] == [1] * 10
    assert sup.dispatch_errors >= 1


def test_default_backend_is_kernel_1_or_the_supervised_hasher():
    from reth_tpu_torch.ops.keccak import KeccakDevice

    s = phs.HashService(registry=pmetrics.MetricsRegistry(), device="cpu")
    dev = s._backend.__self__
    assert isinstance(dev, KeccakDevice)
    assert (dev.device, dev.min_tier, dev.block_tier) == (torch.device("cpu"), 1024, 4)
    assert s.client("live")([b"x"]) == [keccak256(b"x")] and dev.uploads == 2
    s.stop()
    sup = psup.DeviceSupervisor(probe_fn=lambda budget, injector=None: psup.ProbeResult(True, 0),
                                registry=pmetrics.MetricsRegistry())
    s = phs.HashService(supervisor=sup, registry=pmetrics.MetricsRegistry(), device="cpu")
    assert isinstance(s._backend, psup.SupervisedHasher)
    s.stop()


def test_fault_injector_from_env(monkeypatch):
    monkeypatch.setenv("RETH_TPU_FAULT_SERVICE_WEDGE_EVERY", "3")
    monkeypatch.setenv("RETH_TPU_FAULT_SERVICE_STALL", "0.001")
    monkeypatch.setenv("RETH_TPU_FAULT_SERVICE_QUEUE_CAP", "16")
    inj = phs.ServiceFaultInjector.from_env()
    assert inj is not None and inj.active()
    assert (inj.wedge_every, inj.stall, inj.queue_cap) == (3, 0.001, 16)
    s = _svc(injector=inj)
    assert s.lane_capacity == 16
    assert s.client("proof")([b"a", b"b", b"c"]) == [keccak256(m) for m in (b"a", b"b", b"c")]
    s.stop()
    for knob in ("WEDGE_EVERY", "STALL", "QUEUE_CAP"):
        monkeypatch.delenv(f"RETH_TPU_FAULT_SERVICE_{knob}")
    assert phs.ServiceFaultInjector.from_env() is None


def test_env_knobs_match_the_reference(monkeypatch):
    for knob, value in (("WINDOW", "0.007"), ("FILL", "96"), ("LANE_CAP", "640"),
                        ("AGE_PROMOTE", "0.3"), ("LEASE_BYPASS", "0.04")):
        monkeypatch.setenv(f"RETH_TPU_SERVICE_{knob}", value)
    got = []
    for pkg in PKGS:
        s = _svc(pkg)
        s.stop()
        got.append((s.window_s, s.fill_target, s.max_batch, s.lane_capacity, s.age_promote_s,
                    s.lease_bypass_s, s.subtrie_levels))
    # RETH_TPU_SUBTRIE_LEVELS unset: the reference's expression gives one
    # level a launch (its default string "0" is taken before the "or 8")
    assert got[0] == got[1] == (0.007, 96, 768, 640, 0.3, 0.04, 1)
    monkeypatch.setenv("RETH_TPU_SUBTRIE_LEVELS", "4")
    services = [_svc(pkg) for pkg in PKGS]
    for s in services:
        s.stop()
    assert [s.subtrie_levels for s in services] == [4, 4]


def test_overload_stall_drill_backs_up_then_drains():
    reg = pmetrics.MetricsRegistry()
    s = _svc(registry=reg, injector=phs.ServiceFaultInjector(stall=0.01), window_s=0.001,
             lane_capacity=64)
    futs = [s.submit("payload", [b"s%d" % i]) for i in range(20)]
    outs = [f.result(30.0) for f in futs]
    s.stop()
    assert outs == [[keccak256(b"s%d" % i)] for i in range(20)]
    assert "hash_service_queue_depth_payload 0" in reg.render()


def test_build_failure_is_never_replayed(monkeypatch):
    """A build failure is not a device fault: at a dispatch it fails the
    batch's futures without a replay; on the card the constructor loads the
    kernels before the dispatcher starts, so a failed build raises there."""
    def broken(msgs):
        raise _build.BuildError("building keccak.cu failed")

    for kw in ({}, _supervised("port")):
        s = _svc(backend=broken, **kw)
        fut = s.submit("live", [b"x"])
        with pytest.raises(_build.BuildError):
            fut.result(5.0)
        assert s.client("proof")([]) == []
        s.stop()
        assert (s.replays, s.build_failures, fut.completions) == (0, 1, 1)

    loaded = []

    def failed_build(device, sources=_build.KERNEL_SOURCES):
        loaded.append((str(device), tuple(sources)))
        raise _build.BuildError("building fused_level.cu failed")

    monkeypatch.setattr(phs, "resolve", lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(psup, "load_kernels", failed_build)
    threads = threading.active_count()
    with pytest.raises(_build.BuildError):
        phs.HashService(backend=keccak256_batch_np, registry=pmetrics.MetricsRegistry())
    assert loaded == [("cuda:0", ("keccak.cu", "fused_level.cu"))]
    assert threading.active_count() == threads  # no dispatcher was started


@pytest.mark.parametrize("supervised", [False, True])
def test_only_launch_faults_replay_and_only_under_a_supervisor(supervised):
    """A backend fault is a RuntimeError (a launch, copy or sync): a
    supervised service replays it on the twin, an unsupervised one fails
    the futures with it. Any other error (here a TypeError) is a bug, not
    a device fault, and fails the futures on both."""
    errors = iter([RuntimeError("launch failed"), TypeError("bad argument")])

    def faulty(msgs):
        raise next(errors)

    s = _svc(backend=faulty, **(_supervised("port") if supervised else {}))
    first = s.submit("live", [b"x"])
    first._event.wait(5.0)
    second = s.submit("live", [b"y"])
    with pytest.raises(TypeError):
        second.result(5.0)
    if supervised:
        assert first.result(0) == [keccak256(b"x")]
    else:
        with pytest.raises(RuntimeError, match="launch failed"):
            first.result(0)
    s.stop()
    assert (s.replays, s.failed_dispatches) == ((1, 1) if supervised else (0, 2))
    assert s.replays_faults is supervised


def test_mesh_seams_take_their_objects_like_reference():
    """The service's mesh arguments are ported: without a mesh the lease is
    exclusive and the mesh seams answer None; with one, the defaults are the
    reference's (a DeviceBreakerBoard over the mesh, half the mesh leased to
    a rebuild) and the snapshot grows the reference's "mesh" keys."""
    import jax

    from reth_tpu.parallel.mesh import HashMesh as JHashMesh
    from reth_tpu_torch.parallel import HashMesh

    for pkg in ("jax", "port"):
        s = _svc(pkg)
        assert s.pipeline_lease() is None and s.rebuild_mesh() is None
        assert "mesh" not in s.snapshot()
        s.stop()
    board, inj = object(), psup.FaultInjector(device_wedge=(1,))
    meshed = {"jax": _svc("jax", mesh=JHashMesh(jax.devices()[:4], registry=JRegistry())),
              "port": _svc(mesh=HashMesh(["cpu"] * 4, registry=pmetrics.MetricsRegistry()))}
    try:
        assert isinstance(meshed["port"].breaker_board, psup.DeviceBreakerBoard)
        assert meshed["port"].rebuild_devices == meshed["jax"].rebuild_devices == 2
        assert (sorted(meshed["port"].snapshot()["mesh"])
                == sorted(meshed["jax"].snapshot()["mesh"]))
    finally:
        for s in meshed.values():
            s.stop()
    s = _svc(mesh=HashMesh(["cpu"] * 2, registry=pmetrics.MetricsRegistry()),
             breaker_board=board, device_injector=inj, rebuild_devices=1)
    assert (s.breaker_board, s.device_injector, s.rebuild_devices) == (board, inj, 1)
    s.stop()


# -- lifecycle ----------------------------------------------------------------------------


def test_stop_drains_pending_requests():
    s = _svc(window_s=0.2, lease_bypass_s=10.0)
    with s.lease("hold"):
        futs = [s.submit("proof", [b"d%d" % i]) for i in range(5)]
    s.stop(drain=True)
    assert [f.result(1.0) for f in futs] == [[keccak256(b"d%d" % i)] for i in range(5)]
    assert not s._thread.is_alive()


def test_stop_without_drain_fails_pending():
    s = _svc(window_s=10.0, lease_bypass_s=30.0)
    with s.lease("hold"):
        fut = s.submit("proof", [b"x"])
        s.stop(drain=False)
    with pytest.raises(phs.ServiceStopped):
        fut.result(1.0)
    with pytest.raises(phs.ServiceStopped):
        s.submit("proof", [b"y"])


def test_snapshot_shape():
    snaps = []
    for pkg in PKGS:
        s = _svc(pkg)
        s.client("live")([b"x"])
        snaps.append(s.snapshot())
        s.stop()
    assert snaps[0] == snaps[1]
    assert snaps[1]["dispatches"] == 1 and snaps[1]["queued_total"] == 0
    assert set(snaps[1]["queued"]) == set(phs.LANES) and snaps[1]["fault_injection"] is False


def test_shared_instance():
    a = phs.HashService.shared(backend=keccak256_batch_np, registry=pmetrics.MetricsRegistry(),
                               device="cpu")
    assert phs.HashService.shared() is a
    phs.HashService.reset_shared()
    assert not a._thread.is_alive()


# -- clients: the committer's lanes, windows, the sparse finish ------------------------------


def test_for_lane_binds_committer_clients():
    s = _svc()
    committer = TrieCommitter(hasher=keccak256_batch_np, device="cpu")
    committer.hash_service = s
    committer.hasher = s.client("live")
    proof = committer.for_lane("proof")
    assert proof is not committer and proof.hasher.lane == "proof" and proof.hash_service is s
    plain = TrieCommitter(hasher=keccak256_batch_np, device="cpu")
    assert plain.for_lane("proof") is plain
    fused = TrieCommitter(fused=True, device="cpu")
    fused.hash_service = s
    assert fused.for_lane("live") is fused
    leaves = [(bytes([i]) * 64, rlp_encode(b"v%d" % i)) for i in range(16)]
    assert committer.commit(leaves).root == proof.commit(leaves).root == \
        plain.commit(leaves).root
    assert s.dispatches >= 2
    s.stop()


def _window_levels():
    rows = [b"\x11" * 45, b"\x22" * 50]
    lv1 = {"flat": np.frombuffer(b"".join(rows), np.uint8),
           "row_off": np.array([0, 45], np.uint32), "row_len": np.array([45, 50], np.uint32),
           "slots": np.array([1, 2], np.int32), "holes": None, "b_tier": 1}
    parent = b"\xc1" * 6 + b"\xa0" + b"\x00" * 32
    lv2 = {"flat": np.frombuffer(parent, np.uint8), "row_off": np.array([0], np.uint32),
           "row_len": np.array([len(parent)], np.uint32), "slots": np.array([3], np.int32),
           "holes": np.array([[0], [7], [2]], np.int32), "b_tier": 1}
    want = {1: keccak256(rows[0]), 2: keccak256(rows[1]),
            3: keccak256(parent[:7] + keccak256(rows[1]))}
    return [lv1, lv2], want


def _sparse_window(seed: int, k: int = 8):
    """The fused finish's window of a seeded sparse state, packed by the
    port's committer (its templates equal the reference's)."""
    import itertools

    st, _owners, _keys = sparse_state(ts, seed)
    c = ts.ParallelSparseCommitter(subtrie_levels=k, device="cpu")
    tries = [t for t in st.storage_tries.values()] + [st.account_trie]
    live = list(enumerate(tries))
    stats = {"levels": 0}
    schedule, slot_of = c._templates(live, stats, itertools.count(1).__next__)
    return c._pack_schedule(schedule, slot_of), len(slot_of)


@pytest.mark.parametrize("case", ["small", "sparse"])
def test_window_request_buffers_match_jax_engine(case):
    """A window request on the live lane runs one k-level engine commit; the
    digest buffer equals the JAX service's (its SubtrieFusedEngine) from
    slot 1, and the fetch form returns exactly those rows."""
    if case == "small":
        window, max_slots = _window_levels()[0], 3
    else:
        window, max_slots = _sparse_window(5)
    bufs, fetched, counts = [], [], []
    for pkg in PKGS:
        s = _svc(pkg, min_tier=16, subtrie_levels=8)
        client = s.client("live")
        bufs.append(client.commit_window(window, max_slots))
        fetched.append(client.commit_window(window, max_slots, fetch=[max_slots, 1]))
        assert s.client("proof")([b"abc"])[0] == keccak256(b"abc")
        s.stop()
        counts.append(_counters(s))
    assert bufs[1][1:max_slots + 1].tobytes() == bufs[0][1:max_slots + 1].tobytes()
    assert fetched[1].tobytes() == fetched[0].tobytes() == \
        bufs[1][[max_slots, 1]].tobytes()
    if case == "small":
        for slot, h in _window_levels()[1].items():
            assert bufs[1][slot].tobytes() == h
    assert counts[0] == counts[1] and counts[1]["window_dispatches"] == 2


def test_window_wedge_replays_on_numpy():
    """A wedged window replays on the numpy engine under a supervisor, as
    the reference's does; unsupervised, its future raises the wedge."""
    bufs, counts = [], []
    window, _want = _window_levels()
    for pkg, (mod, _r, _h) in PKGS.items():
        s = _svc(pkg, min_tier=16, subtrie_levels=8,
                 injector=mod.ServiceFaultInjector(wedge_every=1), **_supervised(pkg))
        fut = s.submit_window("live", window, 3)
        bufs.append(fut.result(timeout=30))
        assert fut.completions == 1
        s.stop()
        counts.append(_counters(s))
    assert bufs[1][1:4].tobytes() == bufs[0][1:4].tobytes()
    assert counts[0] == counts[1] and counts[1]["replays"] == 1
    s = _svc(min_tier=16, subtrie_levels=8, injector=phs.ServiceFaultInjector(wedge_every=1))
    fut = s.submit_window("live", window, 3)
    with pytest.raises(phs.InjectedServiceWedge):
        fut.result(timeout=30)
    s.stop()
    assert (fut.completions, s.replays, s.failed_dispatches) == (1, 0, 1)


def test_window_engine_on_the_services_device():
    s = _svc(subtrie_levels=4, min_tier=1024)
    eng = s._window_engine()
    assert (eng.k, eng.min_tier, eng.warmup, eng.device) == (4, 1024, None, torch.device("cpu"))
    s.stop()


def _fields(updates):
    return {p: None if b is None else next(iter(branches({p: b}).values()))
            for p, b in updates.items()}


def _stored(mod_committer, hasher, leaves):
    res = mod_committer(hasher=hasher).commit(sorted((unpack_nibbles(k), v)
                                                    for k, v in leaves.items()))
    return dict(res.branch_nodes)


@pytest.mark.parametrize("k", [0, 8])
def test_sparse_finish_on_the_live_lane_matches_reference(k):
    """The sparse finish with the service's live-lane client in both
    packages: k = 0 streams the pooled depths' encode chunks through
    submit(), k = 8 hands the fused window to commit_window(). Roots, the
    account trie's export_branch_updates and the non-timing stats equal the
    reference's, over a baseline and two blocks."""
    from reth_tpu.trie import TrieCommitter as JTrieCommitter

    (sj, owners, keys) = sparse_state(js, 41, tries=32, slots=24)
    (sp, _, _) = sparse_state(ts, 41, tries=32, slots=24)
    services = [_svc("jax"), _svc("port")]
    jc = js.ParallelSparseCommitter(workers=4, split_depth=2, subtrie_levels=k)
    jc.SUBTRIE_ROW_FLOOR = jc.SUBTRIE_HOLE_FLOOR = 64
    pc = ts.ParallelSparseCommitter(workers=4, split_depth=2, subtrie_levels=k, device="cpu")
    try:
        pre = {ha: b"account-leaf-" + ha for ha in owners}
        stored = _stored(JTrieCommitter, jhash, pre)
        for block in range(3):
            if block:
                sparse_block(sj, owners, keys, seed=900 + block)
                sparse_block(sp, owners, keys, seed=900 + block)
            rj = sj.root(services[0].client("live"), committer=jc)
            rp = sp.root(services[1].client("live"), committer=pc)
            assert rp == rj == sp.root(keccak256_batch_np)
            assert {x: pc.last[x] for x in STATS} == {x: jc.last[x] for x in STATS}
            assert pc.last["streamed"] > 0
            assert pc.last.get("subtrie_k") == jc.last.get("subtrie_k")
            exp_j = js.export_branch_updates(sj.account_trie, owners, stored.get)
            exp_p = ts.export_branch_updates(sp.account_trie, owners, stored.get)
            assert _fields(exp_p) == _fields(exp_j)
        if k:
            assert services[1].window_dispatches == services[0].window_dispatches == 3
        else:
            assert services[1].window_dispatches == 0 and services[1].dispatches > 0
    finally:
        for s in services:
            s.stop()
        pc.shutdown()
        jc.shutdown()


def test_live_lane_client_skips_the_arena():
    """With arena= a hasher that has commit_window skips the delta finish,
    as in the reference: the arena sees no epoch."""
    from reth_tpu_torch.ops.fused_commit import DigestArena

    st, _o, _k = sparse_state(ts, 7, tries=6, slots=16)
    twin, _o2, _k2 = sparse_state(ts, 7, tries=6, slots=16)
    s = _svc(min_tier=16)
    arena = DigestArena()
    c = ts.ParallelSparseCommitter(arena=arena, subtrie_levels=8, device="cpu")
    try:
        assert st.root(s.client("live"), committer=c) == twin.root(keccak256_batch_np)
        snap = arena.snapshot()
        assert snap["full_epochs"] == snap["delta_epochs"] == 0 and s.window_dispatches == 1
        assert s.client("live").map_chunks([[b"a"], [b"b", b"c"]]) == \
            keccak256_batch_np([b"a", b"b", b"c"])
    finally:
        s.stop()
        c.shutdown()


def test_entry_points_need_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        phs.HashService(backend=keccak256_batch_np, registry=pmetrics.MetricsRegistry())
