"""The port stands alone: importing reth_tpu_torch and every submodule loads
neither jax nor anything of reth_tpu, and its entry points run on the card
unless the caller asks for the CPU."""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from reth_tpu_torch import convert
from reth_tpu_torch.device import resolve
from reth_tpu_torch.metrics import MetricsRegistry
from reth_tpu_torch.ops import fused_commit as fc
from reth_tpu_torch.ops import hash_service as ths
from reth_tpu_torch.ops import keccak as tk
from reth_tpu_torch.ops import supervisor as tsup
from reth_tpu_torch.ops import warmup as tw
from reth_tpu_torch.primitives.keccak import keccak256_batch_np
from reth_tpu_torch.stages import hashing as thashing
from reth_tpu_torch.stages import merkle as tmerkle
from reth_tpu_torch.trie import incremental as tinc
from reth_tpu_torch.trie import sparse as tsp
from reth_tpu_torch.trie import state_root as tsr
from reth_tpu_torch.trie.committer import TrieCommitter
from reth_tpu_torch.trie.turbo import TurboCommitter

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import json, pkgutil, sys
import reth_tpu_torch
names = [m.name for m in pkgutil.walk_packages(reth_tpu_torch.__path__, "reth_tpu_torch.")]
for name in names:
    __import__(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "reth_tpu"))
print(json.dumps({"modules": names, "leaked": leaked}))
"""


def test_import_loads_no_jax_and_nothing_of_reth_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["leaked"] == []
    for mod in ("reth_tpu_torch.ops.keccak", "reth_tpu_torch.ops.fused_commit",
                "reth_tpu_torch.trie.turbo", "reth_tpu_torch.trie.state_root",
                "reth_tpu_torch.convert", "reth_tpu_torch.primitives.types",
                "reth_tpu_torch.trie.sparse", "reth_tpu_torch.metrics", "reth_tpu_torch.tracing",
                "reth_tpu_torch.ops.supervisor", "reth_tpu_torch.trie.hot_cache",
                "reth_tpu_torch.ops.warmup", "reth_tpu_torch.ops.hash_service",
                "reth_tpu_torch.storage", "reth_tpu_torch.storage.kv",
                "reth_tpu_torch.storage.tables", "reth_tpu_torch.storage.provider",
                "reth_tpu_torch.etl", "reth_tpu_torch.trie.naive",
                "reth_tpu_torch.trie.incremental", "reth_tpu_torch.stages",
                "reth_tpu_torch.stages.api", "reth_tpu_torch.stages.hashing",
                "reth_tpu_torch.stages.merkle"):
        assert mod in res["modules"]


def test_probe_code_names_no_jax_and_nothing_of_reth_tpu():
    """The supervisor's probe child imports torch and the port only."""
    code = tsup.PROBE_CODE
    assert "jax" not in code and "reth_tpu." not in code
    assert "import torch" in code and "reth_tpu_torch" in code


def test_sources_name_no_jax_import():
    for path in (ROOT / "reth_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                assert "jax" not in stripped and "reth_tpu." not in stripped.replace(
                    "reth_tpu_torch", ""), f"{path}: {stripped}"


@pytest.mark.parametrize("entry", [
    tk.KeccakDevice.__init__, fc.FusedLevelEngine.__init__, fc.MegaFusedEngine.__init__,
    fc.SubtrieFusedEngine.__init__, TrieCommitter.__init__,
    TurboCommitter.__init__, tsr.state_root, tsr.storage_root, tsr.ordered_trie_root,
    convert.jobs_to_device, convert.digest_buffer_from_numpy,
    tsp.ParallelSparseCommitter.__init__, tsp.SparseTrie.root_hash_compute,
    tsp.SparseStateTrie.root, tsp.device_hasher, tsup.SupervisedBackend.__init__,
    tsup.SupervisedHasher.__init__, ths.HashService.__init__, tw.WarmupManager.__init__,
    tw.build_shape, tmerkle.MerkleStage.__init__, tmerkle.MerkleUnwindStage.__init__,
    thashing.AccountHashingStage.__init__, thashing.StorageHashingStage.__init__,
    tinc.IncrementalStateRoot.__init__, tinc.full_state_root, tinc.full_state_root_turbo,
    tinc.verify_state_root,
])
def test_entry_points_default_to_the_card(entry):
    assert inspect.signature(entry).parameters["device"].default == "cuda"


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        resolve("cuda")
    with pytest.raises(RuntimeError):
        tk.KeccakDevice()
    with pytest.raises(RuntimeError):
        TurboCommitter()
    with pytest.raises(RuntimeError):
        TrieCommitter()
    with pytest.raises(RuntimeError):
        tsp.ParallelSparseCommitter()
    # the commitment stages: their committer and their rebuild on the card
    for stage in (tmerkle.MerkleStage, tmerkle.MerkleUnwindStage,
                  thashing.AccountHashingStage, thashing.StorageHashingStage):
        with pytest.raises(RuntimeError):
            stage()
    with pytest.raises(RuntimeError):
        tmerkle.MerkleStage(TrieCommitter(hasher=keccak256_batch_np))._turbo_committer()
    sup = tsup.DeviceSupervisor(probe_fn=lambda budget, injector=None: None)
    with pytest.raises(RuntimeError):
        TurboCommitter(backend="auto", supervisor=sup)
    with pytest.raises(RuntimeError):
        TrieCommitter(supervisor=sup)
    # the control plane: the hash service, warm-up and its constructor
    with pytest.raises(RuntimeError):
        ths.HashService(registry=MetricsRegistry())
    with pytest.raises(RuntimeError):
        tw.WarmupManager(registry=MetricsRegistry())
    with pytest.raises(RuntimeError):
        tw.build_warmup(registry=MetricsRegistry())
    with pytest.raises(ValueError):
        resolve("meta")


def test_merkle_stage_rebuilds_on_the_device_route():
    """A stage with no committer, or with one that sets no turbo_backend,
    runs its rebuild on TurboCommitter(backend="device") on the committer's
    card; turbo_backend="numpy" is the twin on request only."""
    stage = tmerkle.MerkleStage(device="cpu")
    assert stage.committer.device == torch.device("cpu")
    turbo = stage._turbo_committer()
    assert turbo.backend_kind == "device" and turbo.device == torch.device("cpu")
    kw = tmerkle.MerkleStage(TrieCommitter(hasher=keccak256_batch_np))._turbo_kw()
    assert (kw["backend"], kw["device"]) == ("device", torch.device("cuda"))
    twin = TrieCommitter(hasher=keccak256_batch_np, device="cpu")
    twin.turbo_backend = "numpy"
    assert tmerkle.MerkleStage(twin)._turbo_committer().backend_kind == "numpy"
    assert stage.fallbacks == 0
