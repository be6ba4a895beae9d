"""The port's meshed hash service (reth_tpu_torch/ops/hash_service.py with
mesh=, breaker_board=, device_injector=, rebuild_devices=) and the mesh
under the rebuild against the JAX package's on its virtual CPU devices
(tests/conftest.py). Mirrors tests/test_mesh_service.py but its bench mode:
partition-rule routing, streaming, the sub-mesh lease with the live lane
going on, the leased rebuild, the wedge drill (shed, replay on the
survivors, the numpy twin only once every member tripped), the breaker's
cooldown, the double-buffer pipeline lease, window requests, and the
k-level engines' differential. Both services hash on numpy backends where
they have one; the port's mesh launches the kernels' plain versions on
"cpu" members. Digests, roots, snapshot counters and drill outcomes must
equal the reference's."""

from __future__ import annotations

import threading

import numpy as np
import pytest

import jax
from _torch_mesh_helpers import SIZES, jobs, roster, same, turbo_mesh_case
from reth_tpu.metrics import MetricsRegistry as JRegistry
from reth_tpu.ops import hash_service as jhs
from reth_tpu.ops import supervisor as jsup
from reth_tpu.parallel import mesh as jmesh
from reth_tpu.primitives.keccak import keccak256_batch_np as jhash
from reth_tpu.trie.turbo import TurboCommitter as JaxTurbo
from reth_tpu_torch.metrics import MetricsRegistry
from reth_tpu_torch.ops import _build
from reth_tpu_torch.ops import hash_service as phs
from reth_tpu_torch.ops import keccak as pk
from reth_tpu_torch.ops import supervisor as psup
from reth_tpu_torch.primitives.keccak import keccak256, keccak256_batch_np
from reth_tpu_torch.trie.turbo import TurboCommitter

PKGS = ("jax", "port")
MESH_KEYS = ("total", "healthy", "unhealthy", "leased", "live", "shrinks", "recoveries",
             "submesh_leases", "sharded_dispatches", "single_dispatches", "mesh_replays",
             "submesh_held", "pipeline_leases")


def _mesh(pkg: str, n: int):
    if pkg == "jax":
        return jmesh.HashMesh(jax.devices()[:n], registry=JRegistry())
    return roster(n)


def _svc(pkg: str, hm, **kw):
    kw.setdefault("min_tier", 16)
    if pkg == "jax":
        return jhs.HashService(mesh=hm, backend=jhash, registry=JRegistry(), **kw)
    return phs.HashService(mesh=hm, backend=keccak256_batch_np, registry=MetricsRegistry(),
                           device="cpu", **kw)


def _board(pkg: str, hm, **kw):
    return (jsup if pkg == "jax" else psup).DeviceBreakerBoard(hm, **kw)


def _injector(pkg: str, wedged):
    return (jsup if pkg == "jax" else psup).FaultInjector(device_wedge=wedged)


def _msgs(seed: int, n: int, lo: int = 1, hi: int = 300) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(rng.integers(lo, hi)), dtype=np.uint8).tobytes()
            for _ in range(n)]


def _mesh_snap(svc) -> dict:
    snap = svc.snapshot()["mesh"]
    return {k: snap[k] for k in MESH_KEYS}


def _both(fn):
    """``fn(pkg)`` on both packages; the two results."""
    return [fn(pkg) for pkg in PKGS]


# -- routing ------------------------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
def test_sharded_parity_and_routing_match_reference(n):
    """A large live batch shards over the mesh, a scalar probe stays on one
    member; digests and the mesh snapshot equal the reference's."""
    big, one = _msgs(1, 120), [b"k"]

    def run(pkg):
        svc = _svc(pkg, _mesh(pkg, n))
        try:
            out = (svc.client("live")(big), svc.client("proof")(one))
            return out, _mesh_snap(svc)
        finally:
            svc.stop()

    (jout, jsnap), (pout, psnap) = _both(run)
    assert pout == jout == ([keccak256(m) for m in big], [keccak256(b"k")])
    assert psnap == jsnap
    assert (psnap["sharded_dispatches"], psnap["single_dispatches"]) == (
        (1, 1) if n > 1 else (0, 2))


def test_streaming_chunks_fuse_on_the_mesh():
    svc = _svc("port", roster(8), window_s=0.01)
    try:
        msgs = _msgs(2, 96)
        out = svc.client("live").map_chunks([msgs[i:i + 8] for i in range(0, 96, 8)])
        assert out == [keccak256(m) for m in msgs]
    finally:
        svc.stop()


# -- the sub-mesh lease -------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_submesh_lease_keeps_the_live_lane_going(pkg):
    """A rebuild holds 4 of 8 members; live dispatches complete on the rest
    while the lease is held, with no bypass onto the twin."""
    hm = _mesh(pkg, 8)
    svc = _svc(pkg, hm)
    try:
        msgs = _msgs(3, 128)
        want = [keccak256(m) for m in msgs]
        results = []

        def live_worker():
            for _ in range(4):
                results.append(svc.client("live")(msgs) == want)

        with svc.lease(what="rebuild", devices=4):
            sub = svc.rebuild_mesh()
            assert (sub.devices.size if pkg == "jax" else sub.size) == 4
            assert svc.snapshot()["mesh"]["leased"] == 4
            t = threading.Thread(target=live_worker)
            t.start()
            t.join(60)
            assert not t.is_alive()
        assert results == [True] * 4
        assert svc.lease_bypasses == 0 and svc.submesh_leases == 1
        assert svc.snapshot()["mesh"]["leased"] == 0 and svc.rebuild_mesh() is None
    finally:
        svc.stop()


def test_lease_too_wide_for_the_mesh_is_exclusive_like_reference():
    """A sub-mesh lease the live members cannot spare falls back to the
    exclusive lease (the lanes pause), as the reference's does."""
    def run(pkg):
        svc = _svc(pkg, _mesh(pkg, 2))
        try:
            with svc.lease(devices=2):
                held = (svc.rebuild_mesh(), svc.snapshot()["leased_by"])
            return held, svc.submesh_leases, svc.leases
        finally:
            svc.stop()

    assert _both(run)[0] == _both(run)[1] == ((None, "rebuild"), 0, 1)


def test_turbo_pipelined_commit_takes_the_submesh_lease():
    """A pipelined turbo commit through a meshed service holds a sub-mesh lease (its
    engine over the leased members) while a live client keeps hashing; the
    roots the reference's numpy committer's, no bypass."""
    hm = roster(4)
    svc = _svc("port", hm, rebuild_devices=2)
    try:
        work = jobs()
        c = TurboCommitter(backend="device", min_tier=256, hash_service=svc, device="cpu")
        made = []
        factory = c._device_engine
        c._device_engine = lambda *a, **kw: made.append(factory(*a, **kw)) or made[-1]
        assert c.mesh is hm
        stop = threading.Event()
        ok = []
        msgs = _msgs(5, 48)
        want = [keccak256(m) for m in msgs]

        def live():  # at least one request, however the threads are scheduled
            while True:
                ok.append(svc.client("live")(msgs) == want)
                if stop.wait(0.01):
                    return

        t = threading.Thread(target=live)
        t.start()
        try:
            got = c.commit_hashed_pipelined(work, collect_branches=True)
        finally:
            stop.set()
            t.join(30)
        same(got, JaxTurbo(backend="numpy").commit_hashed_pipelined(work, collect_branches=True))
        assert [e.mesh.indices for e in made] == [(2, 3)]
        assert svc.submesh_leases == 1 and svc.lease_bypasses == 0
        assert ok and all(ok) and svc.snapshot()["mesh"]["leased"] == 0
    finally:
        svc.stop()


def test_pipeline_lease_matches_reference():
    """The import pipeline's double-buffer sub-mesh: half the mesh taken at
    once, hashing on it, released once; None when the mesh cannot spare it."""
    def run(pkg):
        hm = _mesh(pkg, 4)
        svc = _svc(pkg, hm)
        try:
            lease = svc.pipeline_lease()
            msgs = _msgs(6, 40)
            out = [lease.devices, lease.hash(msgs) == [keccak256(m) for m in msgs],
                   svc.snapshot()["mesh"]["leased"], svc.pipeline_lease(devices=3)]
            lease.release()
            lease.release()
            out += [svc.snapshot()["mesh"]["leased"], lease.hash(msgs[:2]) == [
                keccak256(m) for m in msgs[:2]], svc.pipeline_leases]
            return out
        finally:
            svc.stop()

    jout, pout = _both(run)
    assert pout == jout == [2, True, 2, None, 0, True, 1]


# -- per-member breakers: shed, replay, the final rung, recovery ---------------------------


@pytest.mark.parametrize("n,wedged", [(8, (3,)), (3, (2,)), (2, (0,))])
def test_device_wedge_sheds_and_replays_like_reference(n, wedged):
    """One injected member wedge sheds that member and the in-flight batch
    replays on the survivors: digests bit-identical, every future completes
    once, the numpy twin not involved; later dispatches run on the shrunken
    mesh without a replay."""
    msgs = _msgs(6, 100)
    want = [keccak256(m) for m in msgs]

    def run(pkg):
        hm = _mesh(pkg, n)
        svc = _svc(pkg, hm, breaker_board=_board(pkg, hm, failure_threshold=1),
                   device_injector=_injector(pkg, wedged))
        try:
            fut = svc.submit("live", msgs)
            out = [fut.result(60) == want, fut.completions, _mesh_snap(svc), svc.replays]
            out += [svc.client("payload")(msgs) == want, svc.mesh_replays,
                    svc.breaker_board.snapshot()]
            return out
        finally:
            svc.stop()

    jout, pout = _both(run)
    assert pout == jout
    assert pout[:2] == [True, 1] and pout[2]["healthy"] == n - 1 and pout[3] == 0


@pytest.mark.parametrize("n", (1, 4))
def test_all_members_trip_then_the_numpy_twin(n):
    """Wedging every member walks the ladder to its end: each member shed,
    then MeshExhausted, and the numpy twin replays the batch once."""
    msgs = _msgs(7, 60)

    def run(pkg):
        hm = _mesh(pkg, n)
        svc = _svc(pkg, hm, breaker_board=_board(pkg, hm, failure_threshold=1),
                   device_injector=_injector(pkg, range(n)))
        try:
            out = [svc.client("live")(msgs) == [keccak256(m) for m in msgs], _mesh_snap(svc),
                   svc.replays, svc.breaker_board.exhausted()]
            return out
        finally:
            svc.stop()

    jout, pout = _both(run)
    assert pout == jout
    assert pout[0] and pout[1]["healthy"] == 0 and pout[2] == 1 and pout[3]


def test_breaker_cooldown_readmits_the_member_like_reference():
    """Trial by fire: a shed member rejoins once its cooldown elapsed (poll
    before the next dispatch) and a clean dispatch closes its breaker."""
    def run(pkg):
        clock = [0.0]
        hm = _mesh(pkg, 4)
        inj = _injector(pkg, (2,))
        svc = _svc(pkg, hm, breaker_board=_board(pkg, hm, failure_threshold=1,
                                                 reset_timeout=10.0, clock=lambda: clock[0]),
                   device_injector=inj)
        try:
            msgs = _msgs(8, 64)
            out = [svc.client("live")(msgs) == [keccak256(m) for m in msgs], _mesh_snap(svc)]
            inj.device_wedge = frozenset()
            out.append(svc.client("live")(msgs[:32]) is not None and _mesh_snap(svc))
            clock[0] = 11.0
            out += [svc.client("live")(msgs) == [keccak256(m) for m in msgs], _mesh_snap(svc),
                    svc.breaker_board.breakers[2].state]
            return out
        finally:
            svc.stop()

    jout, pout = _both(run)
    assert pout == jout
    assert pout[4]["healthy"] == 4 and pout[4]["recoveries"] == 1 and pout[5] == "closed"


def test_a_kernel_fault_on_the_mesh_raises_and_sheds_nothing(monkeypatch):
    """The port's departure: a real kernel fault (a refused launch) is not a
    member's wedge. The batch's futures fail with it, no member is shed and
    nothing replays on the twin."""
    def refused(words, counts):
        raise _build.LaunchError("keccak256_absorb: CUDA error 700 at launch")

    monkeypatch.setattr(pk, "keccak256_words_masked", refused)
    hm = roster(4)
    svc = _svc("port", hm, breaker_board=psup.DeviceBreakerBoard(hm, failure_threshold=1))
    try:
        fut = svc.submit("live", _msgs(9, 64))
        with pytest.raises(_build.LaunchError):
            fut.result(30)
        snap = _mesh_snap(svc)
        assert (snap["healthy"], snap["mesh_replays"], svc.replays) == (4, 0, 0)
        assert svc.failed_dispatches == 1
    finally:
        svc.stop()


# -- window requests and the k-level engines over the mesh --------------------------------


def test_window_request_on_the_mesh_matches_reference():
    """A k-level window on the live lane of a three-member mesh runs
    SubtrieMeshEngine (over the members the partition rules pick); its
    digest buffer equals the reference's from slot 1."""
    rows = [b"\x11" * 45, b"\x22" * 50]
    parent = b"\xc1" * 6 + b"\xa0" + b"\x00" * 32
    window = [{"flat": np.frombuffer(b"".join(rows), np.uint8),
               "row_off": np.array([0, 45], np.uint32), "row_len": np.array([45, 50], np.uint32),
               "slots": np.array([1, 2], np.int32), "holes": None, "b_tier": 1},
              {"flat": np.frombuffer(parent, np.uint8), "row_off": np.array([0], np.uint32),
               "row_len": np.array([len(parent)], np.uint32), "slots": np.array([3], np.int32),
               "holes": np.array([[0], [7], [2]], np.int32), "b_tier": 1}]

    def run(pkg):
        svc = _svc(pkg, _mesh(pkg, 3), subtrie_levels=8)
        try:
            buf = svc.client("live").commit_window(window, 3)
            return buf[1:4].tobytes(), svc.window_dispatches, svc.replays
        finally:
            svc.stop()

    jout, pout = _both(run)
    assert pout == jout
    assert pout[0][64:] == keccak256(parent[:7] + keccak256(rows[1]))


@pytest.mark.parametrize("n", SIZES)
def test_turbo_subtrie_mesh_matches_reference_mesh(n):
    """The rebuild on SubtrieMeshEngine (k = 8) over n members against the
    reference's on n virtual devices (test_mesh_service.py's differential;
    tests/test_torch_mesh_engines.py runs FusedMeshEngine's)."""
    turbo_mesh_case(n, 8)
