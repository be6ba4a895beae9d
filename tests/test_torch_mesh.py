"""The port's member mesh (reth_tpu_torch/parallel/mesh.py, the per-member
breakers of ops/supervisor.py, metrics.MeshMetrics) against the JAX
package's parallel/mesh.py on its virtual CPU devices (tests/conftest.py).
The port's mesh is a roster of n "cpu" members, the reference's
jax.devices()[:n], n in {1, 2, 3, 8}: partition decisions, tiers, snapshots
through the same scripted health and lease sequence, breaker drills, and
MeshKeccak / sharded_keccak digests, bit-exact. Mirrors
tests/test_mesh_service.py (the mesh half) and tests/test_parallel.py:42."""

from __future__ import annotations

import numpy as np
import pytest

import jax
from _torch_mesh_helpers import SIZES, roster
from reth_tpu.metrics import MetricsRegistry as JRegistry
from reth_tpu.ops import supervisor as jsup
from reth_tpu.parallel import mesh as jmesh
from reth_tpu_torch.metrics import MetricsRegistry
from reth_tpu_torch.ops import supervisor as psup
from reth_tpu_torch.parallel import mesh as pmesh
from reth_tpu_torch.primitives.keccak import keccak256, pad_batch

NAMES = ("rebuild/fused.packed", "live/fused.branch", "payload/fused.subtrie",
         "proof/fused.subtrie", "live/keccak.scalar", "live/keccak.masked",
         "proof/keccak.masked", "proof/other", "rebuild/keccak.exact")


def _both(n: int):
    return (jmesh.HashMesh(jax.devices()[:n], registry=JRegistry()), roster(n))


def _msgs(seed: int, n: int, lo: int = 1, hi: int = 700) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(rng.integers(lo, hi)), dtype=np.uint8).tobytes()
            for _ in range(n)]


# -- the partition-rule table, spec_for, tiers -----------------------------------------


def test_partition_rules_are_the_reference_table():
    assert pmesh.DEFAULT_PARTITION_RULES == jmesh.DEFAULT_PARTITION_RULES


@pytest.mark.parametrize("n", SIZES)
def test_partition_decisions_match_reference(n):
    for name in NAMES:
        for rows in (0, 1, 3, 4, 7, 8, 9, 31, 32, 33, 64, 1024):
            assert (pmesh.match_partition_rule(pmesh.DEFAULT_PARTITION_RULES, name, rows, n)
                    == jmesh.match_partition_rule(jmesh.DEFAULT_PARTITION_RULES, name, rows, n))


@pytest.mark.parametrize("n", SIZES)
def test_spec_for_matches_reference(n):
    """The spec's length (sharded or not) and the membership it picks."""
    j, p = _both(n)
    for name in NAMES:
        lane, program = name.split("/")
        for rows in (1, 8, 2048):
            jspec, jm = j.spec_for(lane, program, rows)
            pspec, pm = p.spec_for(lane, program, rows)
            assert len(pspec) == len(jspec) and pm.size == jm.devices.size
            assert pm.indices == tuple(j.devices.index(d) for d in jm.devices.flat)
    for i in range(n):  # every member dead: the CPU rung
        j.mark_unhealthy(i)
        p.mark_unhealthy(i)
    assert p.spec_for("live", "keccak.masked", 2048) == j.spec_for(
        "live", "keccak.masked", 2048) == (None, None)


@pytest.mark.parametrize("mult", [1, 2, 3, 5, 6, 7, 8])
def test_mesh_tier_matches_reference(mult):
    for n in (1, 100, 1024, 2000, 12345, 70000):
        for min_tier in (16, 1000, 1024):
            for ceiling in (None, 16384, 65536):
                assert (pmesh.mesh_tier(n, min_tier, mult, ceiling)
                        == jmesh.mesh_tier(n, min_tier, mult, ceiling))


@pytest.mark.parametrize("n,shard,want", [(10, 4, [(0, 4), (4, 8), (8, 10)]),
                                          (5, None, [(0, 2), (2, 4), (4, 5)]),
                                          (2, 4, [(0, 2), (2, 2), (2, 2)]),
                                          (0, None, [(0, 0), (0, 0), (0, 0)])])
def test_member_ranges_split_in_roster_order(n, shard, want):
    assert roster(3).mesh.ranges(n, shard) == want


# -- the roster: health mask, leases, snapshots ----------------------------------------


def _script(hm, errors):
    """The same health and lease sequence on either package's HashMesh;
    returns the snapshots and live memberships along the way."""
    out = []

    def live():
        mesh, idx = hm.live_snapshot()
        return None if mesh is None else tuple(idx)

    def step(what, fn):
        try:
            res = fn()
        except errors as e:
            res = type(e).__name__
        out.append((what, res if not hasattr(res, "indices") else tuple(res.indices),
                    hm.snapshot(), live()))
        return res

    n = hm.n_devices
    step("shed last", lambda: hm.mark_unhealthy(n - 1, reason="drill"))
    step("shed last again", lambda: hm.mark_unhealthy(n - 1))
    lease = step("lease 1", lambda: hm.lease_submesh(1))
    step("lease 2", lambda: hm.lease_submesh(2))
    if hasattr(lease, "release"):
        lease.release()
        lease.release()  # idempotent
    step("released", lambda: None)
    step("readmit", lambda: hm.mark_healthy(n - 1))
    step("readmit again", lambda: hm.mark_healthy(n - 1))
    step("lease all", lambda: hm.lease_submesh(n))
    return out


@pytest.mark.parametrize("n", SIZES)
def test_health_and_lease_script_matches_reference(n):
    j, p = _both(n)
    assert _script(p, (pmesh.MeshExhausted,)) == _script(j, (jmesh.MeshExhausted,))
    for name in ("_shrinks", "_recoveries", "_submesh_leases"):
        assert getattr(p.metrics, name).value == getattr(j.metrics, name).value


def test_build_clamps_to_the_cards_there_are():
    hm = pmesh.HashMesh.build(4, device="cpu", registry=MetricsRegistry())
    assert hm.n_devices == 1 and hm.mesh.indices == (0,)
    with pytest.raises(ValueError):
        pmesh.HashMesh([], registry=MetricsRegistry())


def test_a_roster_may_name_one_device_several_times():
    hm = roster(4)
    assert hm.devices == [hm.devices[0]] * 4 and len(hm.streams) == 4
    sub = hm.lease_submesh(2)
    assert sub.indices == (2, 3) and sub.mesh is hm._mesh_for((2, 3))
    assert hm.live_snapshot()[1] == (0, 1)


def test_mesh_metrics_names_match_reference():
    preg, jreg = MetricsRegistry(), JRegistry()
    pm = pmesh.HashMesh(["cpu"] * 3, registry=preg)
    jm = jmesh.HashMesh(jax.devices()[:3], registry=jreg)
    for hm in (pm, jm):
        hm.mark_unhealthy(1)
        hm.lease_submesh(1)
        hm.mark_healthy(1)
        hm.metrics.record_sharded()
        hm.metrics.record_replay()

    def mesh_lines(text):
        return sorted(line for line in text.splitlines() if line.startswith("mesh_"))

    assert mesh_lines(preg.render()) == mesh_lines(jreg.render())


# -- the per-member breakers --------------------------------------------------------------


def _boards(n: int, **kw):
    clock = [0.0]
    j, p = _both(n)
    jb = jsup.DeviceBreakerBoard(j, clock=lambda: clock[0], **kw)
    pb = psup.DeviceBreakerBoard(p, clock=lambda: clock[0], **kw)
    return clock, (j, jb), (p, pb)


@pytest.mark.parametrize("n", (2, 3, 8))
def test_breaker_board_drill_matches_reference(n):
    """Attributed failures shed at once, unattributed ones at the threshold;
    poll re-admits after the cooldown; a clean dispatch closes the breaker;
    the snapshots equal the reference's at every step."""
    clock, ref, port = _boards(n, failure_threshold=2, reset_timeout=10.0)
    log = {"ref": [], "port": []}
    for key, (hm, board) in (("ref", ref), ("port", port)):
        clock[0] = 0.0
        seq = [board.record_failure(n - 1, attributed=True), board.record_failure(0),
               board.record_failure(0), board.record_failure(0), board.poll(),
               board.exhausted()]
        clock[0] = 11.0
        seq += [board.poll(), hm.snapshot()["healthy"]]
        board.record_success(tuple(range(n)))
        seq += [board.snapshot(), hm.snapshot()]
        log[key] = seq
    assert log["port"] == log["ref"]


def test_breaker_defaults_come_from_env(monkeypatch):
    monkeypatch.setenv("RETH_TPU_DEVICE_BREAKER_TRIPS", "5")
    monkeypatch.setenv("RETH_TPU_DEVICE_BREAKER_RESET", "7.5")
    board = psup.DeviceBreakerBoard(roster(2))
    assert all((b.failure_threshold, b.base_reset_timeout) == (5, 7.5) for b in board.breakers)
    assert not board.exhausted()


def test_device_wedge_injector_from_env(monkeypatch):
    monkeypatch.setenv("RETH_TPU_FAULT_DEVICE_WEDGE", "1,5")
    inj = psup.FaultInjector.from_env()
    assert inj is not None and inj.device_wedge == frozenset((1, 5))
    with pytest.raises(psup.InjectedDeviceWedge) as ei:
        inj.on_mesh_dispatch((0, 1, 2))
    assert ei.value.device_index == 1
    inj.on_mesh_dispatch((0, 2, 3))  # no wedged member takes part


# -- kernel 1 over the mesh --------------------------------------------------------------


class _Gate:
    """A warm-up stand-in that records what it is asked and routes every
    bucket to the card."""

    def __init__(self):
        self.asked = []

    def route_bucket(self, *key):
        self.asked.append(key)
        return True


@pytest.mark.parametrize("n", SIZES)
def test_mesh_keccak_matches_reference(n):
    """MeshKeccak over n members: the reference's digests, buckets and
    tiers (the warm-up keys each bucket asks for), over the live mesh and
    over one member."""
    j, p = _both(n)
    msgs = _msgs(n, 150)
    jg, pg = _Gate(), _Gate()
    jk = jmesh.MeshKeccak(j, min_tier=16, warmup=jg)
    pk = pmesh.MeshKeccak(p, min_tier=16, warmup=pg)
    got = pk.hash_sharded(msgs, p.mesh)
    assert got == jk.hash_sharded(msgs, j.mesh) == [keccak256(m) for m in msgs]
    assert pg.asked == jg.asked
    assert pk.hash_sharded(msgs[:9], p._mesh_for((0,))) == got[:9]


def test_mesh_keccak_hashes_an_unwarm_bucket_on_the_host():
    class Cold:
        def route_bucket(self, *key):
            return False

    p = roster(3)
    front = pmesh.MeshKeccak(p, min_tier=16, warmup=Cold())
    msgs = _msgs(1, 40)
    assert front.hash_sharded(msgs, p.mesh) == [keccak256(m) for m in msgs]
    assert front.host_hashed == 40


@pytest.mark.parametrize("n", SIZES)
def test_sharded_keccak_matches_reference(n):
    """tests/test_parallel.py:42 on both packages: one-block rows sharded
    over the whole roster."""
    rng = np.random.default_rng(5)
    msgs = [rng.integers(0, 256, size=77, dtype=np.uint8).tobytes() for _ in range(24)]
    words = np.ascontiguousarray(pad_batch(msgs, 1)).view("<u4").reshape(24, 34)
    j, p = _both(n)
    got = pmesh.sharded_keccak(p, words)
    want = np.asarray(jmesh.sharded_keccak(j, words))
    assert got.tobytes() == want.tobytes()
    assert [got[i].tobytes() for i in range(24)] == [keccak256(m) for m in msgs]
    if n > 1:
        with pytest.raises(ValueError):
            pmesh.sharded_keccak(p, words[:n + 1])
