"""The port's state_root (reth_tpu_torch/trie/state_root.py) and
TrieCommitter against the JAX package's, fused and per level, on plain
state made from a numpy seed. The port runs on device="cpu"."""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from _torch_helpers import branches
from reth_tpu.ops.keccak_jax import KeccakDevice as JaxKeccakDevice
from reth_tpu.primitives.types import Account as JaxAccount
from reth_tpu.trie.committer import TrieCommitter as JaxCommitter
from reth_tpu_torch.ops.keccak import KeccakDevice
from reth_tpu_torch.primitives.keccak import keccak256_batch_np
from reth_tpu_torch.primitives.types import Account
from reth_tpu_torch.trie import state_root as tsr
from reth_tpu_torch.trie.committer import TrieCommitter

# reth_tpu.trie re-exports the function under the module's name
jsr = importlib.import_module("reth_tpu.trie.state_root")


def _state(n_accounts, n_slots, seed, account_cls):
    rng = np.random.default_rng(seed)
    addrs = [bytes(a) for a in rng.integers(0, 256, size=(n_accounts, 20), dtype=np.uint8)]
    bal = rng.integers(0, 1 << 60, size=n_accounts)
    # every 7th account empty: EIP-161 drops it from the trie
    accounts = {a: account_cls(nonce=0 if i % 7 == 0 else i, balance=0 if i % 7 == 0 else int(bal[i]))
                for i, a in enumerate(addrs)}
    owners = addrs[1: 1 + max(1, n_accounts // 8)]
    storages: dict = {}
    for k in range(n_slots):
        slot = bytes(rng.integers(0, 256, size=32, dtype=np.uint8))
        # some zero values: deleted slots never enter the trie
        storages.setdefault(owners[k % len(owners)], {})[slot] = 0 if k % 11 == 0 else int(bal[k % n_accounts]) + 1
    storages[addrs[2]] = {b"\x00" * 32: 0}  # all-zero storage -> empty root
    return accounts, storages


def _committers(kind):
    if kind == "fused":
        port = TrieCommitter(fused=True, device="cpu",
                             hasher=KeccakDevice(min_tier=1024, block_tier=4, device="cpu").hash_batch)
        ref = JaxCommitter(fused=True,
                           hasher=JaxKeccakDevice(min_tier=1024, block_tier=4).hash_batch)
    else:
        port, ref = TrieCommitter(device="cpu"), JaxCommitter()
    return port, ref


@pytest.mark.parametrize("kind", ["fused", "per_level"])
def test_state_root_matches_jax(kind):
    port, ref = _committers(kind)
    accounts, storages = _state(300, 400, seed=1, account_cls=Account)
    j_accounts, j_storages = _state(300, 400, seed=1, account_cls=JaxAccount)
    got_root, got = tsr.state_root(accounts, storages, committer=port)
    want_root, want = jsr.state_root(j_accounts, j_storages, committer=ref)
    assert got_root == want_root
    assert branches(got["branch_nodes"]) == branches(want["branch_nodes"])
    assert got["storage_roots"] == want["storage_roots"]
    assert got["hashed_addresses"] == want["hashed_addresses"]


def test_state_root_default_committer_and_numpy_hasher_agree():
    accounts, storages = _state(120, 150, seed=2, account_cls=Account)
    root, _ = tsr.state_root(accounts, storages, device="cpu")
    np_root, _ = tsr.state_root(accounts, storages,
                                committer=TrieCommitter(hasher=keccak256_batch_np))
    assert root == np_root
    incl, _ = tsr.state_root(accounts, storages, device="cpu", include_empty=True)
    j_accounts, j_storages = _state(120, 150, seed=2, account_cls=JaxAccount)
    assert incl == jsr.state_root(j_accounts, j_storages, committer=JaxCommitter(
        hasher=JaxKeccakDevice(min_tier=1024, block_tier=4).hash_batch), include_empty=True)[0]


def test_storage_and_ordered_roots_match_jax():
    rng = np.random.default_rng(3)
    slots = {bytes(rng.integers(0, 256, size=32, dtype=np.uint8)): int(v)
             for v in rng.integers(0, 1000, size=60)}
    items = [bytes(rng.integers(0, 256, size=int(n), dtype=np.uint8))
             for n in rng.integers(1, 200, size=40)]
    ref = JaxCommitter(hasher=JaxKeccakDevice(min_tier=1024, block_tier=4).hash_batch)
    assert tsr.storage_root(slots, device="cpu") == jsr.storage_root(slots, ref)
    assert tsr.ordered_trie_root(items, device="cpu") == jsr.ordered_trie_root(items, ref)
    assert tsr.storage_root({}, device="cpu") == jsr.storage_root({}, ref)
    acc = Account(nonce=1, balance=2)
    addr = b"\x11" * 20
    assert tsr.account_trie_leaves({addr: acc}) == jsr.account_trie_leaves(
        {addr: JaxAccount(nonce=1, balance=2)})


def test_fused_without_hasher_fails_like_reference():
    # the reference leaves `hasher` unset when fused; state_root then
    # cannot hash its keys — the port keeps that behaviour
    accounts, storages = _state(10, 5, seed=4, account_cls=Account)
    j_accounts, j_storages = _state(10, 5, seed=4, account_cls=JaxAccount)
    with pytest.raises(TypeError):
        jsr.state_root(j_accounts, j_storages, committer=JaxCommitter(fused=True))
    with pytest.raises(TypeError):
        tsr.state_root(accounts, storages, committer=TrieCommitter(fused=True, device="cpu"))


def test_committer_mesh_seam_roots_equal_reference():
    """TrieCommitter(mesh=): the fused committer on a roster of two "cpu"
    members (FusedMeshEngine) gives the reference's state root on its mesh
    of two virtual devices; the unfused path ignores the mesh, as the
    reference's does."""
    import jax
    from jax.sharding import Mesh

    from reth_tpu.primitives.keccak import keccak256_batch_np as jhash
    from reth_tpu_torch.metrics import MetricsRegistry
    from reth_tpu_torch.ops.fused_commit import FusedMeshEngine
    from reth_tpu_torch.parallel import HashMesh

    accounts, storages = _state(40, 12, seed=8, account_cls=Account)
    j_accounts, j_storages = _state(40, 12, seed=8, account_cls=JaxAccount)
    hm = HashMesh(["cpu"] * 2, registry=MetricsRegistry())
    port = TrieCommitter(fused=True, mesh=hm, min_tier=16, device="cpu",
                         hasher=keccak256_batch_np)
    assert isinstance(port._engine, FusedMeshEngine) and port._engine.mesh.size == 2
    want = jsr.state_root(j_accounts, j_storages, committer=JaxCommitter(
        fused=True, min_tier=16, mesh=Mesh(np.array(jax.devices()[:2]), ("data",)),
        hasher=jhash))
    assert tsr.state_root(accounts, storages, committer=port)[0] == want[0]
    assert TrieCommitter(hasher=keccak256_batch_np, mesh=hm, device="cpu")._engine is None


@pytest.mark.parametrize("seam", ["supervisor", "warmup"])
def test_committer_seams_reach_the_hasher(seam):
    """The warm-up manager, with or without a supervisor, reaches the
    committer's hasher."""
    kw = {seam: object()}
    manager = kw["warmup"] = object()
    c = TrieCommitter(device="cpu", **kw)
    assert c.warmup is manager
    gate = c.hasher._warmup if seam == "supervisor" else c.hasher.__self__.warmup
    assert gate is manager
