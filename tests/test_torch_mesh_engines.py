"""The port's mesh engines (reth_tpu_torch/ops/fused_commit.py FusedMeshEngine
and SubtrieMeshEngine, the exchange_slots plain version, TurboCommitter(mesh=)
and TrieCommitter(mesh=)) against the JAX package's on its virtual CPU
devices (tests/conftest.py: 8 of them). The port's mesh is a roster of n
"cpu" members; the reference's is jax.devices()[:n], n in {1, 2, 3, 8}. Roots,
branch nodes, digests and tiers must be bit-exact; the port's replicas must
be byte-equal after every commit. Mirrors tests/test_mesh_service.py's
differential and tests/test_fused_commit.py:97 / test_subtrie_fused.py:204."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_helpers import branches, prefix_jobs
from _torch_mesh_helpers import MIN_TIER, SIZES, jax_mesh as _jax_mesh, roster as _roster
from _torch_mesh_helpers import same as _same
from _torch_mesh_helpers import turbo_mesh_case
from reth_tpu.ops import fused_commit as jfc
from reth_tpu.trie.committer import TrieCommitter as JaxCommitter
from reth_tpu.trie.turbo import TurboCommitter as JaxTurbo
from reth_tpu_torch.ops import _build
from reth_tpu_torch.ops import fused_commit as fc
from reth_tpu_torch.primitives.keccak import keccak256
from reth_tpu_torch.primitives.nibbles import Nibbles
from reth_tpu_torch.primitives.rlp import rlp_encode
from reth_tpu_torch.trie.committer import TrieCommitter
from reth_tpu_torch.trie.turbo import TurboCommitter


# -- the rebuild over the mesh (TurboCommitter(mesh=)) ---------------------------------


@pytest.mark.parametrize("n", SIZES)
def test_turbo_fused_mesh_matches_reference_mesh(n):
    """FusedMeshEngine under the rebuild; the k-level engine's cases are in
    tests/test_torch_mesh_service.py, beside the service's differential."""
    turbo_mesh_case(n, 0)


def test_turbo_mesh_prefix_subtries_match_reference():
    """The account trie's shape (two-nibble prefix subtries, start_depth=2)
    on the uneven three-member mesh, against the reference's numpy twin."""
    jobs = prefix_jobs(300, seed=6)
    want = JaxTurbo(backend="numpy").commit_hashed_pipelined(jobs, True, 2)
    port = TurboCommitter(backend="device", min_tier=MIN_TIER, mesh=_roster(3), device="cpu")
    _same(port.commit_hashed_pipelined(jobs, True, 2), want)


# -- the engines' tiers and a level split over the members -----------------------------


@pytest.mark.parametrize("n", SIZES + (6,))
def test_min_tier_rounds_up_to_the_member_count_like_reference(n):
    for min_tier in (12, 18, 1024):
        want = jfc.FusedMeshEngine(_jax_mesh(n), min_tier=min_tier).min_tier
        assert fc.FusedMeshEngine(_roster(n), min_tier=min_tier).min_tier == want
        assert fc.SubtrieMeshEngine(_roster(n), min_tier=min_tier, k=4).min_tier == want


@pytest.mark.parametrize("n", (8,))
def test_trie_committer_fused_mesh_matches_reference(n):
    """TrieCommitter(fused=True, mesh=): the template levels (dispatch_level)
    sharded over the members, with a min_tier the member count does not
    divide (test_fused_commit.py:97)."""
    rng = np.random.default_rng(42)
    leaves = sorted({bytes(rng.integers(0, 16, 64, dtype=np.uint8)):
                     rlp_encode(bytes(rng.integers(0, 256, 40, dtype=np.uint8)))
                     for _ in range(60)}.items())
    want = JaxCommitter(fused=True, min_tier=12, mesh=_jax_mesh(n)).commit(
        leaves, collect_branches=True)
    got = TrieCommitter(fused=True, min_tier=12, mesh=_roster(n), device="cpu").commit(
        [(Nibbles(k), v) for k, v in leaves], collect_branches=True)
    assert got.root == want.root
    assert branches(got.branch_nodes) == branches(want.branch_nodes)


def test_trie_committer_forms_over_the_live_members():
    """A HashMesh with a shed member: the engine forms over the live ones."""
    hm = _roster(8)
    hm.mark_unhealthy(7)
    c = TrieCommitter(fused=True, min_tier=14, mesh=hm, device="cpu")
    rng = np.random.default_rng(4)
    leaves = [(Nibbles(bytes(rng.integers(0, 16, 64, dtype=np.uint8))),
               rlp_encode(bytes(rng.integers(0, 256, 40, dtype=np.uint8)))) for _ in range(60)]
    leaves = sorted(dict(leaves).items())
    assert c._engine.mesh.indices == tuple(range(7))
    assert c.commit(leaves).root == TrieCommitter(hasher=None, fused=True, device="cpu").commit(
        leaves).root


def _leaf_rows(seed: int, n: int = 24):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(rng.integers(1, 130)), dtype=np.uint8).tobytes()
            for _ in range(n)]


def _run_leaf_levels(eng, rows, per_level: int = 8):
    eng.begin(len(rows) + 1)
    slots = np.array([eng.alloc_slot() for _ in rows], dtype=np.int32)
    flat = np.frombuffer(b"".join(rows), dtype=np.uint8)
    row_len = np.array([len(r) for r in rows], dtype=np.uint32)
    row_off = (np.cumsum(row_len) - row_len).astype(np.uint32)
    for lo in range(0, len(rows), per_level):
        hi = min(lo + per_level, len(rows))
        base, end = int(row_off[lo]), int(row_off[hi - 1] + row_len[hi - 1])
        eng.dispatch_packed(flat[base:end], row_off[lo:hi] - base, row_len[lo:hi],
                            slots[lo:hi], None, b_tier=1)
    return eng.finish(), slots


@pytest.mark.parametrize("n", (2, 3))
def test_subtrie_mesh_engine_matches_reference_small(n):
    """test_subtrie_fused.py:204 on both packages: the k-level engine over
    2 and 3 members gives the single engine's digests."""
    rows = _leaf_rows(7)
    want, want_slots = _run_leaf_levels(
        jfc.SubtrieMeshEngine(_jax_mesh(n), min_tier=8, k=4, row_floor=32, hole_floor=32), rows)
    eng = fc.SubtrieMeshEngine(_roster(n), min_tier=8, k=4)
    got, slots = _run_leaf_levels(eng, rows)
    assert list(slots) == list(want_slots)
    assert all(got[s].tobytes() == want[s].tobytes() == keccak256(r)
               for s, r in zip(slots, rows))
    assert (eng.levels_staged, eng.dispatches, eng.exchanges) == (3, 1, 3)
    assert eng.member_launches == 3 * n


def test_level_split_over_six_members_matches_reference():
    """A level of 150 rows on six members (test_mesh_service.py's row-range
    split): every digest the reference's."""
    rng = np.random.default_rng(9)
    rows = [rng.integers(0, 256, size=int(rng.integers(1, 120)), dtype=np.uint8).tobytes()
            for _ in range(150)]
    ref = jfc.FusedMeshEngine(_jax_mesh(6), min_tier=18)
    ref.MAX_BATCH_ROWS = 100
    want, _ = _run_leaf_levels(ref, rows, per_level=150)
    eng = fc.FusedMeshEngine(_roster(6), min_tier=18)
    got, slots = _run_leaf_levels(eng, rows, per_level=150)
    assert all(got[s].tobytes() == want[s].tobytes() for s in slots)
    assert eng.member_launches == 6 and eng.exchanges == 1


# -- the exchange's plain version and the replicas -------------------------------------


@pytest.mark.parametrize("m", [2, 3, 5])
def test_exchange_ref_gives_every_replica_every_members_rows(m):
    rng = np.random.default_rng(m)
    n, rows = 37, 64
    slots = torch.from_numpy(rng.choice(np.arange(1, rows), size=n, replace=False))
    bufs = [torch.zeros((rows, 32), dtype=torch.uint8) for _ in range(m)]
    shard = -(-n // m)
    bounds = [min(j * shard, n) for j in range(m)] + [n]
    for j in range(m):  # member j's rows only in its own replica
        lo, hi = bounds[j], bounds[j + 1]
        bufs[j][slots[lo:hi]] = torch.from_numpy(
            rng.integers(0, 256, size=(hi - lo, 32), dtype=np.uint8))
    mine = [b.clone() for b in bufs]
    fc.exchange_slots(bufs, slots, bounds)
    for b in bufs:
        assert torch.equal(b, bufs[0])
    for j in range(m):
        ids = slots[bounds[j]:bounds[j + 1]]
        assert torch.equal(bufs[0][ids], mine[j][ids])


@pytest.mark.parametrize("bounds", [[0, 2], [0, 4, 3], [1, 2, 3]])
def test_exchange_refuses_bad_bounds(bounds):
    bufs = [torch.zeros((8, 32), dtype=torch.uint8) for _ in range(len(bounds) - 1)]
    with pytest.raises(ValueError):
        fc.exchange_slots(bufs, torch.arange(1, 4), bounds)


def test_replica_mismatch_is_caught():
    eng = fc.FusedMeshEngine(_roster(3), min_tier=8)
    eng.begin(4)
    s = eng.alloc_slot()
    eng.dispatch_packed(np.frombuffer(b"\x01" * 40, dtype=np.uint8), np.zeros(1, np.int64),
                        np.array([40], np.int32), np.array([s], np.int64), None, 1)
    eng._execute()
    eng._replicas[2][s] ^= 1
    with pytest.raises(fc.ReplicaMismatch):
        eng.finish()


def test_mesh_engine_is_a_membership_snapshot():
    hm = _roster(4)
    hm.mark_unhealthy(1)
    lease = hm.lease_submesh(1)
    eng = fc.FusedMeshEngine(hm, min_tier=8)
    assert eng.mesh.indices == (0, 2)
    lease.release()
    assert fc.FusedMeshEngine(lease.mesh, min_tier=8).mesh.indices == (3,)
    for i in range(4):
        hm.mark_unhealthy(i)
    with pytest.raises(RuntimeError, match="no live devices"):
        fc.FusedMeshEngine(hm)


# -- the k-level ladder on the mesh --------------------------------------------------------


def _ladder_engine(**kw):
    return fc.SubtrieMeshEngine(_roster(3), min_tier=8, k=8, ladder=True, **kw)


@pytest.mark.parametrize("fault", ["wedge", "abort"])
def test_subtrie_mesh_ladder_answers_injected_faults_like_reference(fault):
    """RETH_TPU_FAULT_SUBTRIE_WEDGE / _ABORT on the mesh engine: the same
    rung as the reference's single engine (per level, then the numpy twin),
    digests bit-identical."""
    rows = _leaf_rows(11)
    want, _ = _run_leaf_levels(jfc.SubtrieFusedEngine(
        min_tier=8, k=8, row_floor=32, hole_floor=32,
        injector=jfc.SubtrieFaultInjector(**{f"{fault}_at": 1})), rows)
    eng = _ladder_engine(injector=fc.SubtrieFaultInjector(**{f"{fault}_at": 1}))
    got, slots = _run_leaf_levels(eng, rows)
    assert all(got[s].tobytes() == want[s].tobytes() for s in slots)
    assert eng.mode == ("perlevel" if fault == "wedge" else "cpu")


def test_subtrie_mesh_ladder_raises_a_kernel_fault(monkeypatch):
    """A real kernel fault (here a refused launch) raises out of the mesh
    engine even with the ladder armed: shedding a member would hide it."""
    def refused(*args):
        raise _build.LaunchError("subtrie_levels: CUDA error 719 at launch")

    monkeypatch.setattr(fc, "subtrie_levels", refused)
    with pytest.raises(_build.LaunchError):
        _run_leaf_levels(_ladder_engine(), _leaf_rows(12))


def test_mesh_warmup_route_key_is_rounded_to_the_members():
    from reth_tpu_torch.ops.warmup import DEFAULT_SUBTRIE_TIER

    asked = []

    class Gate:
        def route_bucket(self, *key):
            asked.append(key)
            return False

    eng = fc.SubtrieMeshEngine(_roster(3), min_tier=8, k=4, warmup=Gate())
    got, slots = _run_leaf_levels(eng, _leaf_rows(13))
    assert asked == [("fused.subtrie", 4, -(-DEFAULT_SUBTRIE_TIER // 3) * 3, 3)]
    assert eng.dispatches == 3  # not warm: one level a launch
