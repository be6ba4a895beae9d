"""The port's TurboCommitter (reth_tpu_torch/trie/turbo.py) against the JAX
TurboCommitter(backend="device") under JAX_PLATFORMS=cpu: roots and branch
nodes, serial and pipelined, start_depth 0 and 2, branch collection on and
off. The port runs on device="cpu" (its kernels' plain versions)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_helpers import branches, job, prefix_jobs
from reth_tpu.trie.turbo import TurboCommitter as JaxTurbo
from reth_tpu_torch import convert
from reth_tpu_torch.primitives.types import EMPTY_ROOT_HASH
from reth_tpu_torch.trie.turbo import TurboCommitter


@pytest.fixture(scope="module")
def jax_dev():
    return JaxTurbo(backend="device", min_tier=64)


@pytest.fixture(scope="module")
def port():
    return TurboCommitter(backend="device", min_tier=64, device="cpu")


def _jobs(start_depth):
    if start_depth == 0:
        return [job(20 + 13 * i, seed=i) for i in range(8)]
    return prefix_jobs(300, seed=5)


def _same(got, want):
    assert [r.root for r in got] == [r.root for r in want]
    assert [branches(r.branch_nodes) for r in got] == [branches(r.branch_nodes) for r in want]
    assert got[-1].hashed_nodes == want[-1].hashed_nodes


@pytest.mark.parametrize("start_depth", [0, 2])
@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("mode", ["serial", "pipelined"])
def test_matches_jax_turbo(jax_dev, port, mode, collect, start_depth):
    jobs = _jobs(start_depth)
    if mode == "serial":
        want = jax_dev.commit_hashed_many(jobs, collect, start_depth)
        got = port.commit_hashed_many(jobs, collect, start_depth)
    else:
        want = jax_dev.commit_hashed_pipelined(jobs, collect, start_depth, jobs_per_sweep=3)
        got = port.commit_hashed_pipelined(jobs, collect, start_depth, jobs_per_sweep=3)
    _same(got, want)


def test_numpy_backend_matches_device_backend(port):
    jobs = _jobs(2)
    twin = TurboCommitter(backend="numpy")
    _same(twin.commit_hashed_pipelined(jobs, True, 2, hash_workers=3),
          port.commit_hashed_pipelined(jobs, True, 2))


def test_pipeline_env_kill_switch(port, monkeypatch):
    """RETH_TPU_PIPELINE=0 takes the serial path, as in the reference
    (tests/test_turbo_pipeline.py test_pipeline_env_kill_switch): the
    pipeline is never run, and the roots are commit_hashed_many's."""
    from reth_tpu_torch.trie import turbo as tturbo

    def refuse(*args, **kwargs):
        raise AssertionError("RebuildPipeline.run ran with RETH_TPU_PIPELINE=0")

    jobs = [job(25, seed=i) for i in range(6)]
    want = port.commit_hashed_many(jobs)
    monkeypatch.setenv("RETH_TPU_PIPELINE", "0")
    monkeypatch.setattr(tturbo.RebuildPipeline, "run", refuse)
    got = port.commit_hashed_pipelined(jobs)
    assert [r.root for r in got] == [r.root for r in want]
    monkeypatch.setenv("RETH_TPU_PIPELINE", "1")
    with pytest.raises(AssertionError, match="RETH_TPU_PIPELINE=0"):
        port.commit_hashed_pipelined(jobs)


def test_device_backend_takes_one_hash_worker(port):
    with pytest.raises(ValueError):
        port.commit_hashed_pipelined(_jobs(2), hash_workers=2)


def test_empty_single_and_inline_jobs(jax_dev, port):
    assert port.commit_hashed_pipelined([]) == []
    tiny = (np.arange(32, dtype=np.uint8).reshape(1, 32), [b"\x01"])  # inlined root
    empty = (np.zeros((0, 32), dtype=np.uint8), [])
    jobs = [tiny, empty, job(30, seed=9)]
    got = port.commit_hashed_many(jobs, collect_branches=True)
    _same(got, jax_dev.commit_hashed_many(jobs, collect_branches=True))
    assert got[1].root == EMPTY_ROOT_HASH
    assert port.commit_hashed_pipelined([tiny])[0].root == got[0].root


def test_rejects_like_reference(port):
    keys, vals = job(10, seed=1)
    dup = (np.vstack([keys, keys[:1]]), vals + vals[:1])
    with pytest.raises(ValueError):
        port.commit_hashed_many([dup])
    with pytest.raises(ValueError):
        port.commit_hashed_pipelined([dup, job(5, seed=2)])


# "auto", supervisor= and hash_service= take their objects
@pytest.mark.parametrize("kw", [dict(backend="auto", hash_service=object()),
                                dict(hash_service=object())])
def test_seams_take_their_objects(kw):
    assert TurboCommitter(device="cpu", **kw).hash_service is kw["hash_service"]


@pytest.mark.parametrize("k", [0, 4])
def test_mesh_seam_roots_equal_reference_mesh(k):
    """TurboCommitter(mesh=): the rebuild on a roster of two "cpu" members
    (FusedMeshEngine, or SubtrieMeshEngine for k > 1) gives the reference's
    roots and branch nodes on its mesh of two virtual devices."""
    import jax
    from jax.sharding import Mesh

    from reth_tpu_torch.metrics import MetricsRegistry
    from reth_tpu_torch.parallel import HashMesh

    jobs = prefix_jobs(200, seed=8)
    want = JaxTurbo(backend="device", min_tier=256, subtrie_levels=k,
                    mesh=Mesh(np.array(jax.devices()[:2]), ("data",))).commit_hashed_pipelined(
        jobs, True, 2)
    port = TurboCommitter(device="cpu", min_tier=256, subtrie_levels=k,
                          mesh=HashMesh(["cpu"] * 2, registry=MetricsRegistry()))
    _same(port.commit_hashed_pipelined(jobs, True, 2), want)


def test_mesh_seam_takes_the_services_mesh():
    """Without mesh=, the committer takes its hash service's mesh, as the
    reference's does."""
    class Service:
        mesh = object()

    assert TurboCommitter(device="cpu", hash_service=Service()).mesh is Service.mesh
    assert TurboCommitter(device="cpu", hash_service=object()).mesh is None


def test_jobs_to_device_round_trip():
    jobs = [job(7, seed=3), (np.zeros((0, 32), dtype=np.uint8), [])]
    out = convert.jobs_to_device(jobs, "cpu")
    for (keys, values), (k, flat, off) in zip(jobs, out):
        assert k.dtype == torch.uint8 and np.array_equal(k.numpy(), keys)
        assert [flat[off[i]:off[i + 1]].numpy().tobytes() for i in range(len(values))] == values


_PIPE_ENV = ("RETH_TPU_PIPELINE_SWEEPERS", "RETH_TPU_PIPELINE_HASHERS",
             "RETH_TPU_PIPELINE_WINDOW", "RETH_TPU_PIPELINE_SWEEP_LEAVES")
_PIPE_KNOBS = ("sweep_workers", "hash_workers", "pack_window", "queue_depth",
               "leaves_per_sweep", "jobs_per_sweep")


@pytest.mark.parametrize("env,kw", [
    ({}, {}),
    ({"RETH_TPU_PIPELINE_SWEEPERS": "3", "RETH_TPU_PIPELINE_WINDOW": "5",
      "RETH_TPU_PIPELINE_SWEEP_LEAVES": "1000"}, {}),
    ({"RETH_TPU_PIPELINE_HASHERS": "4"}, {"hash_workers": None}),
    ({"RETH_TPU_PIPELINE_HASHERS": "4"}, {}),
    ({"RETH_TPU_PIPELINE_SWEEPERS": "3", "RETH_TPU_PIPELINE_HASHERS": "4",
      "RETH_TPU_PIPELINE_WINDOW": "5", "RETH_TPU_PIPELINE_SWEEP_LEAVES": "1000"},
     {"sweep_workers": 7, "hash_workers": 2, "pack_window": 9, "leaves_per_sweep": 77}),
    ({"RETH_TPU_PIPELINE_WINDOW": "", "RETH_TPU_PIPELINE_SWEEPERS": "0"}, {"pack_window": 0}),
])
def test_pipeline_reads_environment_like_reference(monkeypatch, env, kw):
    """RebuildPipeline's knobs: an argument given wins, an unset one comes
    from RETH_TPU_PIPELINE_* as in the reference, else the same default."""
    from reth_tpu.trie.turbo import RebuildPipeline as JaxPipeline
    from reth_tpu_torch.trie.turbo import RebuildPipeline

    for name in _PIPE_ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    lib = object()  # neither package loads its native library
    got = RebuildPipeline(None, lib, **kw)
    want = JaxPipeline(None, lib, **kw)
    assert {k: getattr(got, k) for k in _PIPE_KNOBS} == {k: getattr(want, k) for k in _PIPE_KNOBS}
    for name, knob in zip(_PIPE_ENV, ("sweep_workers", "hash_workers", "pack_window",
                                      "leaves_per_sweep")):
        if kw.get(knob):
            assert getattr(got, knob) == kw[knob]
        elif env.get(name) and (knob != "hash_workers" or knob in kw):
            assert getattr(got, knob) == int(env[name])
