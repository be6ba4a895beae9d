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
from reth_tpu_torch import stages as tstages
from reth_tpu_torch import testing as ttesting
from reth_tpu_torch.consensus import EthBeaconConsensus
from reth_tpu_torch.stages import execution as texecution
from reth_tpu_torch.storage import genesis as tgenesis
from reth_tpu_torch.device import resolve
from reth_tpu_torch.engine import native_exec
from reth_tpu_torch.engine.sparse_root import SparseRootTask
from reth_tpu_torch.engine.tree import EngineTree
from reth_tpu_torch.metrics import MetricsRegistry
from reth_tpu_torch.net import downloader as tdownloader
from reth_tpu_torch.net import server as tnetserver
from reth_tpu_torch.net import snap as tsnap
from reth_tpu_torch.ops import fused_commit as fc
from reth_tpu_torch.ops import hash_service as ths
from reth_tpu_torch.ops import keccak as tk
from reth_tpu_torch.ops import supervisor as tsup
from reth_tpu_torch.ops import warmup as tw
from reth_tpu_torch.parallel import HashMesh
from reth_tpu_torch.primitives.keccak import keccak256_batch_np
from reth_tpu_torch.primitives.types import EMPTY_ROOT_HASH
from reth_tpu_torch.rpc import engine_api as tengine_api
from reth_tpu_torch.stages import hashing as thashing
from reth_tpu_torch.stages import merkle as tmerkle
from reth_tpu_torch.storage import MemDb, ProviderFactory
from reth_tpu_torch.storage import native as tnative
from reth_tpu_torch.storage import recovery as trecovery
from reth_tpu_torch.trie import incremental as tinc
from reth_tpu_torch.trie import proof as tproof
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
                if m.split(".")[0] in ("jax", "jaxlib", "reth_tpu", "cryptography"))
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
                "reth_tpu_torch.stages.merkle", "reth_tpu_torch.trie.proof",
                "reth_tpu_torch.evm", "reth_tpu_torch.evm.state", "reth_tpu_torch.evm.executor",
                "reth_tpu_torch.engine", "reth_tpu_torch.engine.stateless",
                "reth_tpu_torch.engine.sparse_root", "reth_tpu_torch.evm.interpreter",
                "reth_tpu_torch.evm.spec", "reth_tpu_torch.chainspec",
                "reth_tpu_torch.primitives.secp256k1", "reth_tpu_torch.primitives.pairing",
                "reth_tpu_torch.primitives.bls12381", "reth_tpu_torch.primitives.kzg",
                "reth_tpu_torch.primitives.blake2", "reth_tpu_torch.consensus",
                "reth_tpu_torch.consensus.validation", "reth_tpu_torch.storage.genesis",
                "reth_tpu_torch.stages.execution", "reth_tpu_torch.stages.sender_recovery",
                "reth_tpu_torch.stages.tx_lookup", "reth_tpu_torch.stages.index_history",
                "reth_tpu_torch.stages.finish", "reth_tpu_torch.testing",
                "reth_tpu_torch.chaos", "reth_tpu_torch.storage.overlay",
                "reth_tpu_torch.storage.recovery", "reth_tpu_torch.engine.tree",
                "reth_tpu_torch.engine.block_buffer", "reth_tpu_torch.engine.invalid_hooks",
                "reth_tpu_torch.engine.util", "reth_tpu_torch.engine.execution_cache",
                "reth_tpu_torch.engine.prewarm", "reth_tpu_torch.engine.pipelined_root",
                "reth_tpu_torch.engine.native_exec", "reth_tpu_torch.engine.bal",
                "reth_tpu_torch.engine.optimistic", "reth_tpu_torch.engine.block_pipeline",
                "reth_tpu_torch.engine.witness", "reth_tpu_torch.engine.local",
                "reth_tpu_torch.pool", "reth_tpu_torch.pool.pool", "reth_tpu_torch.pool.batcher",
                "reth_tpu_torch.pool.blobstore", "reth_tpu_torch.payload",
                "reth_tpu_torch.payload.builder", "reth_tpu_torch.payload.producer",
                "reth_tpu_torch.storage.wal", "reth_tpu_torch.storage.nippyjar",
                "reth_tpu_torch.storage.static_files", "reth_tpu_torch.storage.settings",
                "reth_tpu_torch.storage.native", "reth_tpu_torch.storage.historical",
                "reth_tpu_torch.prune", "reth_tpu_torch.rpc", "reth_tpu_torch.rpc.convert",
                "reth_tpu_torch.rpc.server", "reth_tpu_torch.rpc.jwt",
                "reth_tpu_torch.rpc.engine_api", "reth_tpu_torch.rpc.state_cache",
                "reth_tpu_torch.rpc.gas_oracle", "reth_tpu_torch.rpc.eth",
                "reth_tpu_torch.rpc.debug", "reth_tpu_torch.rpc.flashbots",
                "reth_tpu_torch.rpc.miner", "reth_tpu_torch.rpc.net",
                "reth_tpu_torch.rpc.otterscan", "reth_tpu_torch.rpc.gateway",
                "reth_tpu_torch.rpc.ws", "reth_tpu_torch.rpc.ipc",
                "reth_tpu_torch.consensus.debug_client", "reth_tpu_torch.net",
                "reth_tpu_torch.net._aes", "reth_tpu_torch.net.wire",
                "reth_tpu_torch.net.snappy", "reth_tpu_torch.net.ecies",
                "reth_tpu_torch.net.rlpx", "reth_tpu_torch.net.p2p",
                "reth_tpu_torch.net.sessions", "reth_tpu_torch.net.reputation",
                "reth_tpu_torch.net.swarm", "reth_tpu_torch.net.server",
                "reth_tpu_torch.net.snap", "reth_tpu_torch.net.downloader",
                "reth_tpu_torch.net.discv4", "reth_tpu_torch.net.discv5",
                "reth_tpu_torch.net.enr", "reth_tpu_torch.net.dnsdisc",
                "reth_tpu_torch.net.nat", "reth_tpu_torch.stages.headers_bodies",
                "reth_tpu_torch.era", "reth_tpu_torch.era_sync", "reth_tpu_torch.rpc.admin",
                "reth_tpu_torch.parallel", "reth_tpu_torch.parallel.mesh"):
        assert mod in res["modules"]


def test_probe_code_names_no_jax_and_nothing_of_reth_tpu():
    """The supervisor's probe child imports torch and the port only."""
    code = tsup.PROBE_CODE
    assert "jax" not in code and "reth_tpu." not in code
    assert "import torch" in code and "reth_tpu_torch" in code


def test_sources_name_no_jax_import():
    """No port source imports jax, anything of reth_tpu, or the cryptography
    package (the networking's AES is the port's own csrc/aes.cpp)."""
    for path in (ROOT / "reth_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                assert "jax" not in stripped and "reth_tpu." not in stripped.replace(
                    "reth_tpu_torch", ""), f"{path}: {stripped}"
                assert "cryptography" not in stripped, f"{path}: {stripped}"


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
    tinc.verify_state_root, tproof.ProofCalculator.__init__, tstages.default_stages,
    EthBeaconConsensus.__init__, texecution.ExecutionStage.__init__, tgenesis.init_genesis,
    ttesting.ChainBuilder.__init__, EngineTree.__init__, trecovery.recover_on_startup,
    tengine_api.payload_to_block, tsnap.SnapServer.__init__, tnetserver.NetworkManager.__init__,
    tdownloader.sync_from_peer, tdownloader.BodiesDownloader.__init__,
    tdownloader.FullBlockClient.__init__, tstages.online_stages,
    tstages.HeadersStage.__init__, tstages.BodiesStage.__init__, HashMesh.__init__,
    HashMesh.build,
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
    # the member mesh: a roster of cards, and its builder
    with pytest.raises(RuntimeError):
        HashMesh(registry=MetricsRegistry())
    with pytest.raises(RuntimeError):
        HashMesh(["cuda:0"] * 2, registry=MetricsRegistry())
    with pytest.raises(RuntimeError):
        HashMesh.build(2, registry=MetricsRegistry())
    with pytest.raises(RuntimeError):
        tw.WarmupManager(registry=MetricsRegistry())
    with pytest.raises(RuntimeError):
        tw.build_warmup(registry=MetricsRegistry())
    # the live tip: proofs on the default committer, and the task's finish
    # on its committer's device (a committer given a hasher keeps "cuda")
    provider = ProviderFactory(MemDb()).provider()
    with pytest.raises(RuntimeError):
        tproof.ProofCalculator(provider)
    with pytest.raises(RuntimeError):
        SparseRootTask(provider, EMPTY_ROOT_HASH, tsp.PreservedSparseTrie(),
                       TrieCommitter(hasher=keccak256_batch_np))
    # the staged sync: every stage that builds a committer, the consensus,
    # genesis and the chain builder hash on the card by default
    with pytest.raises(RuntimeError):
        tstages.default_stages()
    with pytest.raises(RuntimeError):
        EthBeaconConsensus()
    with pytest.raises(RuntimeError):
        texecution.ExecutionStage()
    with pytest.raises(RuntimeError):
        tgenesis.init_genesis(ProviderFactory(MemDb()), None, {})
    with pytest.raises(RuntimeError):
        ttesting.ChainBuilder({})
    # the RPC: a payload's ordered roots without the node's committer
    payload = {"parentHash": "0x" + "00" * 32, "feeRecipient": "0x" + "00" * 20,
               "stateRoot": "0x" + "00" * 32, "receiptsRoot": "0x" + "00" * 32,
               "logsBloom": "0x" + "00" * 256, "prevRandao": "0x" + "00" * 32,
               "blockNumber": "0x1", "gasLimit": "0x1", "gasUsed": "0x0", "timestamp": "0x1",
               "extraData": "0x", "baseFeePerGas": "0x1", "transactions": [],
               "withdrawals": [{"index": "0x0", "validatorIndex": "0x0",
                                "address": "0x" + "00" * 20, "amount": "0x1"}]}
    with pytest.raises(RuntimeError):
        tengine_api.payload_to_block(payload)
    assert tengine_api.payload_to_block(payload, device="cpu").header.number == 1
    # the networking: the snap server's proofs, the online stages and the
    # downloaders' body roots
    with pytest.raises(RuntimeError):
        tsnap.SnapServer(ProviderFactory(MemDb()))
    with pytest.raises(RuntimeError):
        tstages.online_stages(None)
    with pytest.raises(RuntimeError):
        tdownloader.BodiesDownloader([])
    with pytest.raises(RuntimeError):
        tdownloader.FullBlockClient(None)
    assert tsnap.SnapServer(ProviderFactory(MemDb()), device="cpu").committer.device == \
        torch.device("cpu")
    with pytest.raises(ValueError):
        resolve("meta")


def test_engine_tree_builds_on_the_device():
    """EngineTree without a committer hashes on the card (and raises without
    one); with device="cpu" its committer, its consensus and its default
    unwinder's stages are on the CPU, and it builds its hot-state plane."""
    factory = ProviderFactory(MemDb())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            EngineTree(factory)
    tree = EngineTree(factory, device="cpu", hot_state=True)
    assert tree.committer.device == torch.device("cpu")
    assert tree.consensus.committer is tree.committer
    assert tree.hot_arena is not None and tree.hot_cache is not None
    made = []
    orig = tstages.default_stages
    try:
        tstages.default_stages = lambda **kw: made.append(kw) or []
        tree.unwinder(factory, 0)
    finally:
        tstages.default_stages = orig
    assert made == [{"committer": tree.committer, "device": "cpu"}]


def test_native_executor_source_is_the_ports_own():
    """The native executor builds from the port's csrc/ by _build.py's g++
    route, not from the JAX package's native/ directory."""
    assert native_exec._SRC == ROOT / "reth_tpu_torch" / "csrc" / "evmexec.cpp"
    assert "subprocess" not in (ROOT / "reth_tpu_torch" / "engine" /
                                "native_exec.py").read_text()


def test_default_stages_build_on_the_device():
    """default_stages(device=) hands its device to every stage that builds a
    committer (the consensus of the execution stage among them), in the
    reference's order; a given committer is shared as it is."""
    made = tstages.default_stages(device="cpu")
    assert [s.id for s in made] == [
        "SenderRecovery", "Execution", "MerkleUnwind", "AccountHashing", "StorageHashing",
        "MerkleExecute", "TransactionLookup", "IndexStorageHistory", "IndexAccountHistory",
        "Finish"]
    devices = [made[1].consensus.committer.device, made[2].committer.device,
               made[5].committer.device] + [s.hasher.__self__.device for s in made[3:5]]
    assert set(devices) == {torch.device("cpu")}
    twin = TrieCommitter(hasher=keccak256_batch_np, device="cpu")
    given = tstages.default_stages(committer=twin, device="cpu")
    assert given[2].committer is twin and given[5].committer is twin
    assert given[3].hasher is keccak256_batch_np


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


def test_stateless_chain_roots_on_the_device():
    """StatelessChain without a hasher hashes on the card (and raises without
    one); with device="cpu" its witness batch and its finish run the
    kernels' plain versions on the CPU; a hasher of the caller's keeps the
    reference's serial finish."""
    from reth_tpu_torch.engine.stateless import StatelessChain

    assert inspect.signature(StatelessChain.__init__).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            StatelessChain()
    chain = StatelessChain(device="cpu")
    assert chain.hasher.__self__.device == torch.device("cpu")
    assert chain.committer.device == torch.device("cpu")
    assert StatelessChain(hasher=keccak256_batch_np).committer is None


def test_rpc_modules_stand_alone():
    """The RPC and the debug consensus client import nothing of the JAX
    package, and no module registers what waits for the node or the fleet;
    ``admin_*`` is served over the port's networking."""
    from reth_tpu_torch.consensus import debug_client
    from reth_tpu_torch.rpc import admin, debug, server

    rpc_dir = ROOT / "reth_tpu_torch" / "rpc"
    for path in list(rpc_dir.glob("*.py")) + [Path(debug_client.__file__)]:
        src = path.read_text()
        assert "import jax" not in src and "from reth_tpu." not in src, path
        assert "from .. import health" not in src and "..obs" not in src, path
    for name in ("admin_nodeInfo", "admin_peers", "admin_addPeer", "admin_removePeer"):
        assert hasattr(admin.AdminApi, name)
    for name in ("debug_healthCheck", "debug_sloStatus", "debug_metricsHistory",
                 "debug_fleetMetrics"):
        assert not hasattr(debug.DebugApi, name)
    assert hasattr(server.RpcServer, "keep_fault")


def test_block_production_modules_stand_alone():
    """The pool, the payload builder and producer, the miner and the witness
    import nothing of the JAX package, and the miner is the engine's export."""
    from reth_tpu_torch import engine
    from reth_tpu_torch.engine import local, witness
    from reth_tpu_torch.payload import builder, producer
    from reth_tpu_torch.pool import batcher, blobstore, pool

    assert engine.LocalMiner is local.LocalMiner
    for mod in (local, witness, builder, producer, batcher, blobstore, pool):
        src = Path(mod.__file__).read_text()
        assert "import jax" not in src and "from reth_tpu." not in src


def _chain_at_2_stages_at_1() -> ProviderFactory:
    """Linked headers 0-2, every engine stage's checkpoint at 1: the shape
    an unwind to 1 leaves when its marker was cleared."""
    from reth_tpu_torch.primitives.types import Header

    factory = ProviderFactory(MemDb())
    with factory.provider_rw() as p:
        parent = b"\x00" * 32
        for n in range(3):
            h = Header(parent_hash=parent, number=n)
            p.insert_header(h)
            parent = h.hash
        for stage in trecovery.ENGINE_STAGES:
            p.save_stage_checkpoint(stage, 1)
    return factory


def test_recovery_builds_on_the_device(monkeypatch):
    """recover_on_startup without a committer builds the unwind's stages
    (default_stages) and the root check's fused committer on its device,
    "cuda" unless the caller asks for the CPU; without a card the default
    raises out of the pass."""
    made, verified = [], []
    monkeypatch.setattr(tstages, "default_stages", lambda **kw: made.append(kw) or [])
    monkeypatch.setattr(tinc, "verify_state_root",
                        lambda p, committer=None, device="cuda": verified.append(
                            (committer.fused, committer.device, device)) or (EMPTY_ROOT_HASH, []))
    report = trecovery.recover_on_startup(_chain_at_2_stages_at_1(), device="cpu")
    assert made == [{"committer": None, "device": "cpu"}]
    assert report["healed"] == ["completed interrupted unwind 2 -> 1"]
    # the root check rebuilds on a fused committer: the level kernels
    assert verified == [(True, torch.device("cpu"), "cpu")] and report["root_verified"] is True
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            trecovery.recover_on_startup(_chain_at_2_stages_at_1())


def test_native_engines_source_is_the_ports_own():
    """The KV engines build from the port's csrc/ copies by _build.py's g++
    route; storage/native.py never names the JAX package's native/ tree."""
    assert tnative._SRC_DIR == ROOT / "reth_tpu_torch" / "csrc"
    src = (ROOT / "reth_tpu_torch" / "storage" / "native.py").read_text()
    assert "native/" not in src and "subprocess" not in src
    assert issubclass(tnative.NativeBuildError, __import__(
        "reth_tpu_torch.ops._build", fromlist=["BuildError"]).BuildError)
