"""Shared pieces of the mesh tests (tests/test_torch_mesh*.py): the port's
roster of n "cpu" members beside the reference's mesh over the first n of
JAX's virtual CPU devices (tests/conftest.py), the small rebuild jobs and
the rebuild's differential on both."""

from __future__ import annotations

import numpy as np
from jax.sharding import Mesh

import jax
from _torch_helpers import branches, job
from reth_tpu.trie.turbo import TurboCommitter as JaxTurbo
from reth_tpu_torch.metrics import MetricsRegistry
from reth_tpu_torch.ops import fused_commit as fc
from reth_tpu_torch.parallel import HashMesh
from reth_tpu_torch.trie.turbo import TurboCommitter

SIZES = (1, 2, 3, 8)
# one batch tier for every level of the small jobs (as test_mesh_service.py's
# lease drill does): the reference compiles one program per kind and mesh
MIN_TIER = 256


def roster(n: int) -> HashMesh:
    return HashMesh(["cpu"] * n, registry=MetricsRegistry())


def jax_mesh(n: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:n]), ("data",))


def jobs():
    return [job(90, 1), job(40, 2), job(9, 3), job(1, 4)]


def same(got, want) -> None:
    assert [r.root for r in got] == [r.root for r in want]
    assert [branches(r.branch_nodes) for r in got] == [branches(r.branch_nodes) for r in want]


def turbo_mesh_case(n: int, k: int) -> None:
    """The rebuild's level loop sharded over n members equals the reference's
    over n virtual devices (k > 1: the k-level engines), pipelined (and
    serial on three members), roots and branch nodes; every commit leaves the port's
    replicas byte-equal, and every level runs one exchange (none on one
    member)."""
    work = jobs()
    want = JaxTurbo(backend="device", min_tier=MIN_TIER, mesh=jax_mesh(n),
                    subtrie_levels=k).commit_hashed_many(work, collect_branches=True)
    port = TurboCommitter(backend="device", min_tier=MIN_TIER, mesh=roster(n),
                          subtrie_levels=k, device="cpu")
    made = []
    factory = port._device_engine
    port._device_engine = lambda *a, **kw: made.append(factory(*a, **kw)) or made[-1]
    same(port.commit_hashed_pipelined(work, collect_branches=True), want)
    if n == 3:  # the serial level loop too, on the uneven mesh
        same(port.commit_hashed_many(work, collect_branches=True), want)
    engine = fc.SubtrieMeshEngine if k else fc.FusedMeshEngine
    assert [type(e) for e in made] == [engine] * len(made) and made
    assert all(e.mesh.size == n for e in made)
    assert all(e.replicas_checked == (n > 1) for e in made)
    assert all(e.exchanges == (0 if n == 1 else e.levels_staged if k else e.dispatches)
               for e in made)
