"""The port's warm-up (reth_tpu_torch/ops/warmup.py) against the JAX package's
ops/warmup.py under JAX_PLATFORMS=cpu: the menu, the tier ceilings, the
versioned compile cache, the lifecycle drills (compile wedge retried, wedged
for good with the breaker tripping, promotion after a half-open probe,
deferral while the breaker is open, the re-entrancy guard) and degraded
serving through the dispatch front-ends.

Where the reference's behaviour is deterministic, both managers run the same
scripted builder and the port's states, counters and snapshot must equal
the reference's, less directory paths, walls and the port's own
``loaded_elsewhere`` cache field. Digests are compared byte for byte
(tolerance zero). The port runs on device="cpu" (no nvcc: a scripted or a
g++-built stand-in takes the compiler's place where a test needs libraries
on disk). Budgets stay at or under 0.5 s."""

from __future__ import annotations

import subprocess
import threading
import time

import numpy as np
import pytest
import torch

from reth_tpu.metrics import MetricsRegistry as JRegistry
from reth_tpu.ops import supervisor as jsup
from reth_tpu.ops import warmup as jw
from reth_tpu.ops.fused_commit import FusedLevelEngine as JFusedLevelEngine
from reth_tpu.ops.fused_commit import SubtrieFusedEngine as JSubtrieFusedEngine
from reth_tpu.ops.fused_commit import _Bucket as JBucket
from reth_tpu.ops.keccak_jax import KeccakDevice as JKeccakDevice
from reth_tpu.ops.keccak_jax import _next_tier as j_next_tier
from reth_tpu_torch import metrics as pmetrics
from reth_tpu_torch.ops import _build
from reth_tpu_torch.ops import fused_commit as pfc
from reth_tpu_torch.ops import keccak as pk
from reth_tpu_torch.ops import supervisor as psup
from reth_tpu_torch.ops import warmup as pw
from reth_tpu_torch.primitives.keccak import keccak256, keccak256_batch_np
from reth_tpu_torch.primitives.nibbles import unpack_nibbles
from reth_tpu_torch.primitives.rlp import rlp_encode
from reth_tpu_torch.trie.committer import TrieCommitter

PKGS = {"jax": (jw, jsup, JRegistry), "port": (pw, psup, pmetrics.MetricsRegistry)}
SHAPES = [("keccak.masked", 4, 8), ("keccak.masked", 8, 8)]


def _supervisor(pkg, **kw):
    _w, sup, reg = PKGS[pkg]
    kw.setdefault("dispatch_budget", 120.0)
    kw.setdefault("probe_fn", lambda budget, injector=None, **k: sup.ProbeResult(True, 0.001))
    kw.setdefault("registry", reg())
    return sup.DeviceSupervisor(**kw)


def _mgr(pkg, menu=None, builder=None, **kw):
    w, _sup, reg = PKGS[pkg]
    kw.setdefault("registry", reg())
    kw.setdefault("budget", 0.25)
    kw.setdefault("attempts", 2)
    kw.setdefault("backoff", 0.0)
    kw.setdefault("verify_cache", False)
    kw.setdefault("enable_cache", False)
    if pkg == "port":
        kw.setdefault("device", "cpu")
    if menu is None:
        menu = SHAPES
    if builder is None:
        builder = lambda shape: None  # noqa: E731
    return w.WarmupManager(menu=[w.MenuShape(*s) for s in menu], builder=builder, **kw)


def _both(**kw):
    return _mgr("jax", **kw), _mgr("port", **kw)


def _snap(mgr) -> dict:
    """A snapshot less paths, walls and the port's loaded_elsewhere field."""
    snap = mgr.snapshot()
    snap.pop("compile_wall_s")
    snap["cache"] = {k: v for k, v in snap["cache"].items()
                     if k not in ("dir", "loaded_elsewhere")}
    return snap


def _counters(mgr) -> tuple:
    return (dict(mgr.states), mgr.retries, mgr.wedges, mgr.cpu_routed, mgr.cache_hits,
            mgr.cache_misses)


def _msgs(n, size=40, seed=0):
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(0, 256, size, dtype=np.uint8)) for _ in range(n)]


# -- the shape menu and the ceilings ---------------------------------------------


@pytest.mark.parametrize("kw", [{}, dict(include_fused=False), dict(min_tier=256, block_tier=2),
                                dict(max_batch_tier=4096, max_block_tier=16),
                                dict(subtrie_ks=(1, 4, 8)), dict(mesh_sizes=(1,))])
def test_default_menu_grid(kw):
    """The port declares the reference's menu: the same shapes in the same
    order for the same arguments."""
    port = pw.default_menu(**kw)
    assert [s.key() for s in port] == [s.key() for s in jw.default_menu(**kw)]
    assert [str(s) for s in port] == [str(s) for s in jw.default_menu(**kw)]
    keys = [s.key() for s in pw.default_menu()]
    assert len(keys) == len(set(keys))
    for t in (1024, 2048, 4096, 8192, 16384):
        assert ("keccak.masked", 4, t, 1) in keys
    for bt in (8, 16, 32):
        assert ("keccak.masked", bt, 1024, 1) in keys
    assert ("fused.plain", 4, 1024, 1) in keys and ("fused.splice", 4, 1024, 1) in keys
    assert ("fused.subtrie", 8, 2048, 1) in keys


@pytest.mark.parametrize("mesh_sizes", [(8,), (6,), (2, 3)])
def test_mesh_menu_matches_reference(mesh_sizes, tmp_path):
    """The mesh's menu variants (test_warmup.py:110): the reference's shapes,
    keys and "@m{n}" names; build_warmup(mesh_size=) declares them and keys
    the compile cache by the mesh size as the reference does."""
    port = pw.default_menu(min_tier=1024, mesh_sizes=mesh_sizes)
    assert [s.key() for s in port] == [s.key() for s in jw.default_menu(
        min_tier=1024, mesh_sizes=mesh_sizes)]
    assert [str(s) for s in port] == [str(s) for s in jw.default_menu(
        min_tier=1024, mesh_sizes=mesh_sizes)]
    m = mesh_sizes[-1]
    assert all(s.batch_tier % s.mesh_size == 0 for s in port)
    mgr = pw.build_warmup(mesh_size=m, device="cpu", registry=pmetrics.MetricsRegistry())
    ref = jw.build_warmup(mesh_size=m, registry=JRegistry())
    assert sorted(mgr.states) == sorted(ref.states)
    cache = pw.CompileCache(tmp_path, mesh_size=m)
    assert cache.dir.name.endswith(f"-m{m}") and cache.dir != pw.CompileCache(tmp_path).dir
    assert jw.CompileCache(tmp_path, mesh_size=m).dir.name.endswith(f"-m{m}")


def test_mesh_shapes_warm_over_the_roster():
    """A manager over mesh shapes warms them over its HashMesh roster (two
    "cpu" members here), each shape's launch the mesh front-end's; without
    a roster large enough a mesh shape fails, as the reference's does when
    too few devices are found, and the route stays on the host."""
    from reth_tpu_torch.parallel import HashMesh

    menu = [("keccak.masked", 4, 16, 2), ("fused.plain", 4, 16, 2), ("fused.splice", 4, 16, 2),
            ("fused.subtrie", 8, 2048, 2)]
    hm = HashMesh(["cpu"] * 2, registry=pmetrics.MetricsRegistry())
    mgr = pw.WarmupManager(menu=[pw.MenuShape(*s) for s in menu], mesh=hm, device="cpu",
                           budget=60, attempts=1, verify_cache=False, enable_cache=False,
                           registry=pmetrics.MetricsRegistry())
    snap = mgr.run()
    assert snap["state"] == "warm" and snap["warm"] == 4
    assert "keccak.masked:4x16@m2" in snap["shapes"]
    assert mgr.route_bucket("keccak.masked", 4, 16, 2)
    small = pw.WarmupManager(menu=[pw.MenuShape("keccak.masked", 4, 24, 3)],
                             mesh=hm, device="cpu", budget=60, attempts=1, backoff=0.0,
                             verify_cache=False, enable_cache=False,
                             registry=pmetrics.MetricsRegistry())
    assert small.run()["failed"] == 1 and small.wedges == 1
    assert not small.route_bucket("keccak.masked", 4, 24, 3)
    with pytest.raises(ValueError, match="needs 3 devices, found 2"):
        pw.build_shape(pw.MenuShape("keccak.masked", 4, 24, 3), device="cpu", mesh=hm)


@pytest.mark.parametrize("args", [(5, 8), (100, 8), (100_000, 8, 1024), (100, 8, 1024),
                                  (1024, 1024), (1025, 1024, 16384)])
def test_next_tier_clamps_to_menu_ceiling(args):
    assert pk._next_tier(*args) == j_next_tier(*args)


def test_max_batch_tier_normalized_onto_ladder():
    for kw in (dict(min_tier=8, max_batch_tier=100), dict(min_tier=8, max_batch_tier=16),
               dict(min_tier=1024)):
        assert pk.KeccakDevice(device="cpu", **kw).max_batch_tier == \
            JKeccakDevice(**kw).max_batch_tier


def test_oversized_batch_chunked_at_menu_ceiling():
    dev = pk.KeccakDevice(min_tier=8, max_batch_tier=16, device="cpu")
    msgs = _msgs(50)
    assert dev.hash_batch(msgs) == keccak256_batch_np(msgs)
    assert dev.uploads == 2 * 4  # 50 messages in chunks of 16: four launches
    assert dev.host_hashed == 0


def test_block_ceiling_routes_to_host_bucket():
    """Messages above the menu's block ceiling (32 rate blocks) are off the
    menu. While a manager warms, their bucket is hashed on the host and
    counted, as the reference hashes them (it does so always: XLA compiles
    one program per shape). Without a manager, or once the menu is warm,
    they run on the kernel, which takes any block count. The digests equal
    the JAX KeccakDevice's throughout, and the bucket keys up to the ceiling
    are the reference's."""
    big = bytes(40 * 136 - 5)  # 40 rate blocks > the ceiling 32
    small = _msgs(3)
    msgs = [small[0], big, small[1], big + b"!", small[2]]
    expect = keccak256_batch_np(msgs)
    ref = JKeccakDevice(min_tier=8, block_tier=4)
    port = pk.KeccakDevice(min_tier=8, block_tier=4, device="cpu")
    assert [port._bucket_key(nb) for nb in range(1, 33)] == \
        [ref._bucket_key(nb) for nb in range(1, 33)]
    assert port._bucket_key(40) == 64
    assert port.hash_batch(msgs) == ref.hash_batch(msgs) == expect
    assert (port.host_hashed, port.uploads) == (0, 4)  # both buckets launched
    assert JKeccakDevice.MAX_BLOCK_TIER == pw.DEFAULT_MAX_BLOCK_TIER == 32
    assert ("keccak.masked", 32, 1024, 1) in [s.key() for s in pw.default_menu()]
    assert all(s.block_tier <= 32 for s in pw.default_menu() if s.program.startswith("keccak"))
    jm, pm = _both(menu=[("keccak.masked", 4, 8)])
    jm._active = pm._active = True
    jm.states[("keccak.masked", 4, 8, 1)] = pm.states[("keccak.masked", 4, 8, 1)] = pw.WARM
    jdev = JKeccakDevice(min_tier=8, block_tier=4, warmup=jm)
    pdev = pk.KeccakDevice(min_tier=8, block_tier=4, warmup=pm, device="cpu")
    steps = []
    for stage in ("warming", "warm"):
        if stage == "warm":
            jm.run()
            pm.run()
        assert pdev.hash_batch(msgs) == jdev.hash_batch(msgs) == expect
        steps.append((pdev.host_hashed, pdev.uploads, pm.cpu_routed, jm.cpu_routed))
    # warming: the small bucket (a WARM shape) launched, the off-menu one on
    # the host (counted in cpu_routed; the reference's host bucket is not)
    assert steps == [(2, 2, 1, 0), (2, 6, 1, 0)]


def test_fused_block_tier_ceiling_raises():
    """A level of more than MAX_BLOCK_TIER (64) rate blocks raises ValueError
    in every engine, as in the reference."""
    assert pfc.FusedLevelEngine.MAX_BLOCK_TIER == JFusedLevelEngine.MAX_BLOCK_TIER == 64
    giant = bytes(70 * 136 - 10)  # 70 rate blocks
    engines = [JFusedLevelEngine(min_tier=8), pfc.FusedLevelEngine(min_tier=8, device="cpu")]
    for eng, bucket_cls in zip(engines, (JBucket, pfc._Bucket)):
        eng.begin(4)
        bucket = bucket_cls()
        bucket.add(giant, 70, 1, [])
        with pytest.raises(ValueError, match="block-tier ceiling"):
            eng.dispatch_level(bucket)
    for eng in engines + [pfc.MegaFusedEngine(min_tier=8, device="cpu"),
                          pfc.SubtrieFusedEngine(min_tier=8, k=8, device="cpu")]:
        eng.begin(4)
        with pytest.raises(ValueError, match="block-tier ceiling"):
            eng.dispatch_packed(np.zeros(16, np.uint8), np.zeros(1, np.uint32),
                                np.full(1, 8, np.uint32), np.ones(1, np.int32), None, 128)
    eng = pfc.FusedLevelEngine(min_tier=8, device="cpu")  # 64 itself is on the menu
    eng.begin(4)
    eng.dispatch_packed(np.zeros(16, np.uint8), np.zeros(1, np.int64), np.full(1, 8, np.int32),
                        np.ones(1, np.int64), None, 64)


# -- the compile cache ------------------------------------------------------------


def test_kernel_source_digest_versions_cache_dir(tmp_path):
    a, b = tmp_path / "a.cu", tmp_path / "b.cu"
    a.write_text("kernel v1")
    b.write_text("kernel v1")
    d1 = pw.kernel_source_digest([a])
    assert d1 == pw.kernel_source_digest([a])
    a.write_text("kernel v2")
    assert pw.kernel_source_digest([a]) != d1
    assert pw.kernel_source_digest([b]) == d1
    cc1 = pw.CompileCache(tmp_path / "cache", sources=[a])
    cc2 = pw.CompileCache(tmp_path / "cache", sources=[b])
    assert cc1.dir != cc2.dir and cc1.dir.parent == cc2.dir.parent
    assert cc1.dir.name == f"cuda-{cc1.digest}"


def test_default_digest_covers_the_kernel_sources_and_the_toolkit(monkeypatch):
    srcs = sorted(_build.CUDA_SRC_DIR.glob("*.cu")) + sorted(_build.CUDA_SRC_DIR.glob("*.cuh"))
    assert {p.name for p in srcs} >= {"keccak.cu", "fused_level.cu"}
    base = pw.kernel_source_digest()
    assert base == pw.kernel_source_digest(srcs)
    monkeypatch.setattr(_build, "toolkit_version", lambda: "Cuda compilation tools, release 99")
    assert pw.kernel_source_digest() != base
    monkeypatch.undo()
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    assert pw.kernel_source_digest() != base


def _caches(tmp_path):
    return (jw.CompileCache(tmp_path / "jax", sources=[]),
            pw.CompileCache(tmp_path / "port", sources=[]))


def test_cache_validate_healthy_preserves_entries(tmp_path):
    reports = []
    for cc in _caches(tmp_path):
        cc.dir.mkdir(parents=True)
        (cc.dir / "entry-1").write_bytes(b"x" * 64)
        (cc.dir / "entry-2").write_bytes(b"y" * 64)
        reports.append((cc.validate(), cc.entry_count(), cc.summary()["mode"]))
    assert reports[0] == reports[1] == ({"entries": 2, "corrupt": 0, "quarantined": False},
                                        2, "off")


def test_cache_corruption_quarantines_and_rebuilds(tmp_path):
    for cc in _caches(tmp_path):
        cc.dir.mkdir(parents=True)
        (cc.dir / "good").write_bytes(b"x" * 64)
        (cc.dir / "truncated").write_bytes(b"")
        rep = cc.validate()
        assert rep == {"entries": 0, "corrupt": 1, "quarantined": True}
        assert cc.dir.is_dir() and cc.entry_count() == 0
        quarantined = list(cc.dir.parent.glob("*.quarantine-*"))
        assert len(quarantined) == 1 and (quarantined[0] / "good").read_bytes() == b"x" * 64
        (cc.dir / "bad").write_bytes(b"")
        assert cc.validate()["quarantined"]
        assert len(list(cc.dir.parent.glob("*.quarantine-*"))) == 2
        assert cc.quarantined == 2


_STUB_C = "\n".join(f'extern "C" int {sym}(void) {{ return 0; }}'
                    for syms in pw.ENTRY_SYMBOLS.values() for sym in syms)


def _stub_library(path, source=_STUB_C):
    """A shared library exporting the kernel libraries' entry symbols,
    built with g++ (the stand-in for nvcc on a host without the toolkit)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    src = path.with_suffix(".cpp")
    src.write_text(source)
    subprocess.run(["g++", "-shared", "-fPIC", str(src), "-o", str(path)], check=True)
    src.unlink()


def _stub_compiler(calls):
    def compile_(sources, build_dir):
        calls.append([s.name for s in sources])
        out = [_build.library_path(s, build_dir) for s in sources]
        for path in out:
            _stub_library(path)
        return out
    return compile_


def test_cache_quarantines_a_library_that_does_not_load(tmp_path):
    """A truncated library, or one without its entry symbols, is corrupt;
    libraries that open with their symbols are kept."""
    cc = pw.CompileCache(tmp_path, sources=[])
    good = [_build.library_path(_build.CUDA_SRC_DIR / s, cc.dir)
            for s in ("keccak.cu", "fused_level.cu")]
    for path in good:
        _stub_library(path)
    (cc.dir / (good[0].name + ".log")).write_text("")  # an empty build log is no entry
    assert cc.validate() == {"entries": 2, "corrupt": 0, "quarantined": False}
    data = good[0].read_bytes()
    good[0].write_bytes(data[:len(data) // 3])  # truncated
    assert cc.validate() == {"entries": 0, "corrupt": 1, "quarantined": True}
    assert cc.entry_count() == 0 and not good[1].exists()
    _stub_library(good[1], 'extern "C" int packed_level(void) { return 0; }')
    assert cc.validate()["quarantined"]  # lacks branch_level and subtrie_levels


def test_cache_enable_disable_round_trip(tmp_path):
    cc = pw.CompileCache(tmp_path, sources=[])
    cc.validate()
    try:
        assert cc.enable()
        assert _build.kernel_dir() == cc.dir
        assert _build.library_path(_build.CUDA_SRC_DIR / "keccak.cu").parent == cc.dir
        assert _build.library_path(_build.PKG_DIR / "csrc" / "triebuild.cpp").parent == \
            _build.BUILD_DIR  # the host sweep is not a kernel library
        assert cc.summary()["mode"] == "cold"
    finally:
        cc.disable()
    assert _build.kernel_dir() == _build.BUILD_DIR and not cc.enabled


def test_probe_code_loads_from_the_cache_directory(monkeypatch, tmp_path):
    """probe_device(cache_dir=) hands the child a kernel directory before
    the probe's own code runs."""
    seen = {}

    def fake_run(cmd, **kw):
        seen["code"] = cmd[-1]
        return subprocess.CompletedProcess(cmd, 0, "PROBE_OK cuda test\n", "")

    monkeypatch.setattr(psup.subprocess, "run", fake_run)
    assert psup.probe_device(5, cache_dir=str(tmp_path)).ok
    code = seen["code"]
    assert f"_build.set_kernel_dir({str(tmp_path)!r})" in code
    assert code.index("set_kernel_dir") < code.index("KeccakDevice(")
    assert "jax" not in code


# -- the manager's lifecycle ------------------------------------------------------


def test_happy_path_all_shapes_warm():
    built = {"jax": [], "port": []}
    mgrs = {p: _mgr(p, builder=built[p].append) for p in PKGS}
    for p, mgr in mgrs.items():
        assert mgr.overall_state() == "off"
        snap = mgr.run()
        assert [s.key() for s in built[p]] == [s.key() for s in mgr.menu]
        assert snap["state"] == "warm" and snap["warm"] == snap["total"] == 2
        assert mgr.device_ready() and mgr.route_bucket("keccak.masked", 4, 8)
        assert mgr.route_bucket("keccak.masked", 64, 8)  # fully warm: off-menu allowed
    assert _snap(mgrs["port"]) == _snap(mgrs["jax"])
    assert _counters(mgrs["port"]) == _counters(mgrs["jax"])


def test_no_gating_before_start():
    for mgr in _both():
        assert mgr.device_ready()
        assert mgr.route_bucket("keccak.masked", 4, 8) and mgr.route_bucket("anything", 1, 1)
        assert mgr.cpu_routed == 0


def test_degraded_routing_while_warming():
    out = []
    for mgr in _both():
        mgr._active = True
        seq = [mgr.device_ready(), mgr.route_bucket("keccak.masked", 4, 8)]
        mgr.states[("keccak.masked", 4, 8, 1)] = pw.WARM
        seq += [mgr.route_bucket("keccak.masked", 4, 8), mgr.route_bucket("keccak.masked", 8, 8),
                mgr.cpu_routed, mgr.overall_state()]
        out.append(seq)
    assert out[0] == out[1] == [False, False, True, False, 2, "warming"]


def test_background_start_and_wait():
    slow = threading.Event()
    mgr = _mgr("port", builder=lambda shape: slow.wait(2.0))
    mgr.start()
    assert not mgr.device_ready()
    slow.set()
    assert mgr.wait(5.0) and mgr.device_ready()
    mgr.start()  # idempotent once done
    assert mgr.wait(5.0) and mgr.device_ready()


def test_compile_wedge_drill_budget_retry_then_warm():
    """RETH_TPU_FAULT_COMPILE_WEDGE=1: the first step wedges past its 0.1 s
    budget (the real join timeout), the retry warms the shape."""
    results = []
    for p, (_w, sup, _r) in PKGS.items():
        inj = sup.FaultInjector(compile_wedge=1)
        mgr = _mgr(p, menu=SHAPES[:1], injector=inj, budget=0.1, attempts=3)
        t0 = time.monotonic()
        snap = mgr.run()
        assert time.monotonic() - t0 < 1.5
        results.append((_snap(mgr), _counters(mgr), inj.compiles_wedged, inj.compile_wedge))
        assert snap["state"] == "warm"
    assert results[0] == results[1]
    assert results[1][1][1:3] == (1, 1)  # one retry, one wedge


def _wedged_forever(p):
    _w, sup, _r = PKGS[p]
    inj = sup.FaultInjector(compile_wedge=-1)
    breaker = sup.CircuitBreaker(failure_threshold=2, reset_timeout=0.05)
    supervisor = _supervisor(p, breaker=breaker, injector=inj)
    mgr = _mgr(p, menu=SHAPES[:1], supervisor=supervisor, injector=inj, budget=0.05, attempts=2)
    return inj, breaker, supervisor, mgr


def test_compile_wedge_forever_trips_breaker_and_degrades():
    results = []
    for p in PKGS:
        _inj, breaker, sup, mgr = _wedged_forever(p)
        assert sup.warmup is mgr
        snap = mgr.run()
        results.append((_snap(mgr), _counters(mgr), breaker.state, breaker.trips,
                        mgr.device_ready(), sup.warmup_allows_device(),
                        mgr.route_bucket("keccak.masked", 4, 8)))
        assert snap["state"] == "degraded"
    assert results[0] == results[1]
    assert results[1][2] == psup.OPEN


def test_promotion_after_fault_clears_via_half_open_probe():
    results = []
    for p in PKGS:
        inj, breaker, sup, mgr = _wedged_forever(p)
        mgr.run()
        assert breaker.state == psup.OPEN and not mgr.device_ready()
        with inj._lock:
            inj.compile_wedge = 0  # the wedge clears
        time.sleep(0.06)  # past the cooldown: the next route half-opens
        assert sup.allows_device()  # the probe closes it and promotes
        for _ in range(300):
            if mgr.device_ready():
                break
            time.sleep(0.01)
        results.append((mgr.device_ready(), dict(mgr.states), breaker.state,
                        sup.warmup_allows_device(), sup.snapshot()["warmup"]))
    assert results[0] == results[1] == (True, {("keccak.masked", 4, 8, 1): pw.WARM},
                                        psup.CLOSED, True, "warm")


def test_breaker_open_defers_without_burning_attempts():
    results = []
    for p in PKGS:
        sup = _supervisor(p)
        sup.breaker.force_open()

        def builder(shape):  # pragma: no cover - must not run
            raise AssertionError("launched while the breaker is open")

        mgr = _mgr(p, menu=SHAPES[:1], supervisor=sup, builder=builder)
        mgr.run()
        results.append((_snap(mgr), _counters(mgr)))
    assert results[0] == results[1]
    assert results[1][0]["state"] == "degraded" and results[1][1][2] == 0


def test_retry_failed_reentrancy_guard():
    results = []
    for p in PKGS:
        calls = []
        mgr = _mgr(p, menu=SHAPES[:1], builder=calls.append, attempts=1)
        mgr._active = True
        mgr.states[("keccak.masked", 4, 8, 1)] = pw.FAILED
        with mgr._lock:
            mgr._retrying = True
        guarded = mgr.retry_failed()
        with mgr._lock:
            mgr._retrying = False
        results.append((guarded, mgr.retry_failed(), len(calls), dict(mgr.states)))
    assert results[0] == results[1] == (0, 1, 1, {("keccak.masked", 4, 8, 1): pw.WARM})


def test_fault_injector_env_and_active():
    for _w, sup, _r in PKGS.values():
        inj = sup.FaultInjector.from_env({"RETH_TPU_FAULT_COMPILE_WEDGE": "2"})
        assert inj is not None and inj.compile_wedge == 2 and inj.active()
        t0 = time.monotonic()
        inj.on_compile(0.01)
        inj.on_compile(0.01)
        assert inj.compiles_wedged == 2 and inj.compile_wedge == 0
        inj.on_compile(0.01)  # spent: no wedge
        assert inj.compiles_wedged == 2 and time.monotonic() - t0 < 5
    assert psup.FaultInjector.from_env({}) is None


def test_env_knobs_set_budget_attempts_backoff(monkeypatch):
    monkeypatch.setenv("RETH_TPU_WARMUP_BUDGET", "0.5")
    monkeypatch.setenv("RETH_TPU_WARMUP_ATTEMPTS", "0")
    monkeypatch.setenv("RETH_TPU_WARMUP_BACKOFF", "0")
    got = []
    for p, (w, _s, reg) in PKGS.items():
        kw = {"device": "cpu"} if p == "port" else {}
        mgr = w.WarmupManager(menu=[], registry=reg(), **kw)
        got.append((mgr.budget, mgr.attempts, mgr.backoff))
    assert got[0] == got[1] == (0.5, 1, 0.0)


def test_build_failure_raises_from_run_and_parks_nothing():
    """A failed build is no device fault: run() raises it, no shape is
    FAILED, nothing is retried or wedged, gating is lifted; in the
    background, wait() raises it."""
    def failing(sources, build_dir):
        raise _build.BuildError("building keccak.cu failed: nvcc exited 1")

    launched = []
    mgr = _mgr("port", compiler=failing, builder=launched.append)
    with pytest.raises(_build.BuildError):
        mgr.run()
    assert launched == [] and mgr.wedges == mgr.retries == 0
    assert set(mgr.states.values()) == {pw.COLD} and mgr.overall_state() == "off"
    assert mgr.device_ready() and mgr.builds == 0
    bg = _mgr("port", compiler=failing)
    bg.start()
    with pytest.raises(_build.BuildError):
        bg.wait(5.0)


def test_real_steps_launch_each_kernel_on_its_plain_version():
    """The default builder on the CPU: each program's kernel runs once, as
    its plain version, at exactly the shape (small tiers here)."""
    menu = [("keccak.masked", 4, 8), ("keccak.exact", 2, 8), ("fused.plain", 4, 8),
            ("fused.splice", 4, 8), ("fused.subtrie", 8, 64)]
    mgr = pw.WarmupManager(menu=[pw.MenuShape(*s) for s in menu], budget=30, attempts=1,
                           backoff=0, registry=pmetrics.MetricsRegistry(), device="cpu")
    snap = mgr.run()
    assert snap["state"] == "warm" and snap["warm"] == 5 and mgr.wedges == 0
    with pytest.raises(ValueError, match="unknown menu program"):
        pw.build_shape(pw.MenuShape("keccak.bogus", 4, 8), device="cpu")


# -- degraded serving through the front-ends ----------------------------------------


def test_keccak_device_degraded_buckets_bit_identical():
    """Under the same scripted managers the port's KeccakDevice and the
    JAX one route the same buckets to the host and give the same digests."""
    msgs = _msgs(5) + [bytes(300)]  # one bucket: the shared 4-block tier
    jm, pm = _both(menu=[("keccak.masked", 4, 8)])
    jdev = JKeccakDevice(min_tier=8, block_tier=4, warmup=jm)
    pdev = pk.KeccakDevice(min_tier=8, block_tier=4, warmup=pm, device="cpu")
    expect = keccak256_batch_np(msgs)
    steps = []
    for stage in ("off", "warming", "promoted"):
        if stage == "warming":
            jm._active = pm._active = True
        if stage == "promoted":
            jm.states[("keccak.masked", 4, 8, 1)] = pm.states[("keccak.masked", 4, 8, 1)] = pw.WARM
        assert pdev.hash_batch(msgs) == jdev.hash_batch(msgs) == expect
        steps.append((jm.cpu_routed, pm.cpu_routed, pdev.host_hashed))
    assert steps == [(0, 0, 0), (1, 1, 6), (1, 1, 6)]


def test_exact_buckets_route_by_their_kind():
    """Without a shared block tier, small buckets are "keccak.exact" shapes."""
    jm, pm = _both(menu=[("keccak.exact", 1, 8)])
    jm._active = pm._active = True
    msgs = [b"a", b"b", bytes(200)]
    jdev = JKeccakDevice(min_tier=8, warmup=jm)
    pdev = pk.KeccakDevice(min_tier=8, warmup=pm, device="cpu")
    jm.states[("keccak.exact", 1, 8, 1)] = pm.states[("keccak.exact", 1, 8, 1)] = pw.WARM
    assert pdev.hash_batch(msgs) == jdev.hash_batch(msgs) == keccak256_batch_np(msgs)
    assert pm.cpu_routed == jm.cpu_routed == 1 and pdev.host_hashed == 1


def test_supervised_hasher_picks_up_attached_warmup():
    sup = _supervisor("port")
    mgr = _mgr("port", supervisor=sup)
    committer = TrieCommitter(supervisor=sup, device="cpu")
    committer.attach_warmup(mgr)
    assert committer.warmup is mgr and committer.hasher._warmup is mgr
    msgs = _msgs(4)
    mgr._active = True
    assert committer.hasher(msgs) == keccak256_batch_np(msgs)
    assert mgr.cpu_routed >= 1
    # a hasher built without an explicit manager finds the supervisor's
    plain = psup.SupervisedHasher(sup, device="cpu")
    before = mgr.cpu_routed
    assert plain(msgs) == keccak256_batch_np(msgs) and mgr.cpu_routed == before + 1


def test_attach_warmup_reaches_plain_keccak_device():
    committer = TrieCommitter(min_tier=8, device="cpu")
    mgr = _mgr("port")
    committer.attach_warmup(mgr)
    assert committer.hasher.__self__.warmup is mgr
    TrieCommitter(hasher=keccak256_batch_np, device="cpu").attach_warmup(mgr)  # no front-end


def test_supervised_backend_fused_commit_gated_until_warm():
    leaves = [(unpack_nibbles(keccak256(bytes([i]))), rlp_encode(b"v%d" % i)) for i in range(40)]
    expect = TrieCommitter(hasher=keccak256_batch_np, device="cpu").commit(leaves).root
    sup = _supervisor("port")
    mgr = _mgr("port", supervisor=sup)
    mgr._active = True
    committer = TrieCommitter(fused=True, min_tier=16, supervisor=sup, device="cpu")
    assert committer.commit(leaves).root == expect
    assert committer._engine.effective_kind == "numpy"  # degraded, not a failover
    assert sup.failovers == 0
    mgr.run()
    assert committer.commit(leaves).root == expect
    assert committer._engine.effective_kind == "device"


def _subtrie_window():
    rows = [b"\x11" * 45, b"\x22" * 50]
    parent = b"\xc1" * 6 + b"\xa0" + b"\x00" * 32
    return [(np.frombuffer(b"".join(rows), np.uint8), np.array([0, 45], np.uint32),
             np.array([45, 50], np.uint32), np.array([1, 2], np.int32), None, 1),
            (np.frombuffer(parent, np.uint8), np.array([0], np.uint32),
             np.array([len(parent)], np.uint32), np.array([3], np.int32),
             np.array([[0], [7], [2]], np.int32), 1)]


def test_subtrie_engine_runs_an_unwarm_k_shape_one_level_a_launch():
    """An active manager without the (fused.subtrie, k, 2048) shape warm
    sends each flush one level a launch, as the reference's engine does; the
    buffers equal from slot 1 (the JAX engine writes its dummy slot 0). The
    port keys the shape on DEFAULT_SUBTRIE_TIER, the row floor of the
    reference's default engine."""
    shape = ("fused.subtrie", 8, pw.DEFAULT_SUBTRIE_TIER)
    out = []
    for warm in (False, True):
        jm, pm = _both(menu=[shape])
        jm._active = pm._active = True
        if warm:
            jm.states[shape + (1,)] = pm.states[shape + (1,)] = pw.WARM
        engines = [JSubtrieFusedEngine(min_tier=16, k=8, warmup=jm),
                   pfc.SubtrieFusedEngine(min_tier=16, k=8, warmup=pm, device="cpu")]
        bufs = []
        for eng in engines:
            eng.begin(3)
            for level in _subtrie_window():
                eng.dispatch_packed(*level)
            bufs.append(eng.finish())
        assert bufs[1][1:4].tobytes() == bufs[0][1:4].tobytes()
        assert bufs[1][3].tobytes() == keccak256(b"\xc1" * 6 + b"\xa0" + keccak256(b"\x22" * 50))
        out.append((engines[0].dispatches, engines[1].dispatches, jm.cpu_routed, pm.cpu_routed))
    assert out == [(2, 2, 1, 1), (1, 1, 0, 0)]


# -- observability and the constructor ------------------------------------------------


def test_metrics_and_snapshot_surface(tmp_path):
    regs = {"jax": JRegistry(), "port": pmetrics.MetricsRegistry()}
    mgrs = {p: _mgr(p, registry=regs[p],
                    cache=PKGS[p][0].CompileCache(tmp_path / p, sources=[])) for p in PKGS}
    for p, mgr in mgrs.items():
        snap = mgr.run()
        out = regs[p].render()
        for line in ("# TYPE warmup_state gauge", "warmup_shapes_total 2",
                     "warmup_shapes_warm 2", "warmup_compiles_total 2.0",
                     "warmup_compile_seconds_bucket"):
            assert line in out
        assert snap["shapes"] == {"keccak.masked:4x8": pw.WARM, "keccak.masked:8x8": pw.WARM}
        assert snap["compiling"] is None and snap["cache"]["mode"] == "off"
    assert _snap(mgrs["port"]) == _snap(mgrs["jax"])
    assert mgrs["port"].snapshot()["cache"]["loaded_elsewhere"] >= 0
    names = lambda r: sorted(n for n, _ in r.items())  # noqa: E731
    assert names(regs["port"]) == names(regs["jax"])


def test_supervisor_snapshot_carries_warmup_state():
    for p in PKGS:
        sup = _supervisor(p)
        assert sup.snapshot()["warmup"] is None
        mgr = _mgr(p, supervisor=sup)
        assert sup.snapshot()["warmup"] == "off"
        mgr.run()
        assert sup.snapshot()["warmup"] == "warm"


def test_build_warmup_constructor(tmp_path):
    sup = _supervisor("port")
    mgr = pw.build_warmup(supervisor=sup, cache_dir=tmp_path / "cc",
                          registry=pmetrics.MetricsRegistry(),
                          menu=[pw.MenuShape("keccak.masked", 4, 8)],
                          builder=lambda s: None, verify_cache=False, device="cpu")
    assert mgr.sup is sup and sup.warmup is mgr
    assert mgr.cache is not None and mgr.cache.base == tmp_path / "cc"
    assert pw.build_warmup(registry=pmetrics.MetricsRegistry(), device="cpu").cache is None
    assert [s.key() for s in pw.build_warmup(registry=pmetrics.MetricsRegistry(),
                                             device="cpu").menu] == \
        [s.key() for s in jw.default_menu()]


def test_restart_with_populated_cache_reports_hits(tmp_path):
    """A second start against the same cache directory: the first run built
    every library (misses equal the shapes), the restart finds them all
    (hits equal the shapes) and builds nothing. The reference's managers,
    under the same script, report the same counters and snapshot."""
    menu = [("keccak.masked", 4, 8), ("keccak.masked", 8, 8)]
    # the reference: its scripted builder writes one cache entry per shape
    jcc = jw.CompileCache(tmp_path / "jax", sources=[])
    entries = {"n": 0}

    def jbuilder(shape):
        if entries["n"] < 2:
            (jcc.dir / f"entry-{entries['n']}").write_bytes(b"x" * 32)
            entries["n"] += 1

    jcc.validate()
    jcc.enabled = True  # unit scope: skip the jax config global
    j1 = _mgr("jax", menu=menu, cache=jcc, builder=jbuilder).run()
    jcc2 = jw.CompileCache(tmp_path / "jax", sources=[])
    jcc2.validate()
    jcc2.enabled = True
    j2 = _mgr("jax", menu=menu, cache=jcc2).run()
    # the port: the build is the compiler (a g++ stand-in for nvcc here)
    calls = []
    pcc = pw.CompileCache(tmp_path / "port")
    pcc.validate()
    pcc.enabled = True  # unit scope: leave the process's kernel directory alone
    m1 = _mgr("port", menu=menu, cache=pcc, compiler=_stub_compiler(calls))
    p1 = m1.run()
    pcc2 = pw.CompileCache(tmp_path / "port")
    assert pcc2.validate() == {"entries": 1, "corrupt": 0, "quarantined": False}
    pcc2.enabled = True
    m2 = _mgr("port", menu=menu, cache=pcc2, compiler=_stub_compiler(calls))
    p2 = m2.run()
    assert calls == [["keccak.cu"]]  # one library for both shapes, built once
    assert (m1.builds, m2.builds) == (1, 0)
    for snap in (j1, j2, p1, p2):
        snap.pop("compile_wall_s")
        for key in ("dir", "loaded_elsewhere", "entries"):
            snap["cache"].pop(key, None)
    assert (p1, p2) == (j1, j2)
    assert (p1["cache_misses"], p1["cache_hits"], p2["cache_hits"], p2["cache_misses"]) == \
        (2, 0, 2, 0)
    assert p2["cache"]["mode"] == "warm"


def test_unreadable_probe_keeps_the_cache_off(tmp_path):
    """verify_cache: the libraries are built into the directory first, and a
    probe that fails leaves the process's kernel directory alone (the build
    goes to the kernel directory instead)."""
    calls = []
    cc = pw.CompileCache(tmp_path)
    cc.probe = lambda injector=None: False
    mgr = _mgr("port", cache=cc, enable_cache=True, verify_cache=True,
               compiler=_stub_compiler(calls))
    kernel_dir = tmp_path / "kernels"
    _build.set_kernel_dir(kernel_dir)
    try:
        snap = mgr.run()
    finally:
        _build.set_kernel_dir(None)
    assert not cc.enabled and snap["cache"]["mode"] == "off"
    assert calls == [["keccak.cu"], ["keccak.cu"]]
    assert _build.library_path(_build.CUDA_SRC_DIR / "keccak.cu", cc.dir).exists()
    assert _build.library_path(_build.CUDA_SRC_DIR / "keccak.cu", kernel_dir).exists()
    assert snap["cache_hits"] == snap["cache_misses"] == 0


def test_entry_points_need_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        pw.WarmupManager(menu=[], registry=pmetrics.MetricsRegistry())
    with pytest.raises(RuntimeError):
        pw.build_warmup(registry=pmetrics.MetricsRegistry())
    with pytest.raises(RuntimeError):
        pw.build_shape(pw.MenuShape("keccak.masked", 4, 8))
