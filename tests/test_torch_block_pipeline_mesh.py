"""The cross-block import pipeline over a meshed hash service: the port's
``engine/block_pipeline.py`` takes a sub-mesh lease (``HashService.
pipeline_lease``) for the speculative block's key prehash whenever the
committer's service has a mesh. Two deep (``depth=2``, ``overlap=True``) on
tests/test_block_pipeline.py's chain, the committer wired by hand as the
reference's ``cli.py`` wires ``--mesh --hash-service``: the port on rosters
of 2 and 3 ``"cpu"`` members (the kernels' plain versions), the reference
on the first 2 and 3 of JAX's virtual CPU devices. State roots, receipts and
senders must equal the reference's and a serial import's, the lease must be
taken and every lease released. Both services pad a mesh dispatch to
``MIN_TIER`` messages, not the default 1,024, so the plain versions stay
quick."""

from __future__ import annotations

import pytest

import jax
from _torch_helpers import hold_root_until_child_arrives, pipeline_chain
from _torch_mesh_helpers import roster
from reth_tpu import testing as jtesting
from reth_tpu.engine import EngineTree as JEngineTree
from reth_tpu.engine import block_pipeline as jpipeline
from reth_tpu.metrics import MetricsRegistry as JRegistry
from reth_tpu.ops import hash_service as jhs
from reth_tpu.parallel import mesh as jmesh
from reth_tpu.primitives import Account as JAccount
from reth_tpu.primitives.keccak import keccak256_batch_np as jhash
from reth_tpu.storage import MemDb as JMemDb
from reth_tpu.storage import ProviderFactory as JFactory
from reth_tpu.storage.genesis import init_genesis as jinit_genesis
from reth_tpu.trie import TrieCommitter as JCommitter
from reth_tpu_torch import testing as ptesting
from reth_tpu_torch.engine import EngineTree
from reth_tpu_torch.engine import block_pipeline as ppipeline
from reth_tpu_torch.metrics import MetricsRegistry
from reth_tpu_torch.ops import hash_service as phs
from reth_tpu_torch.primitives.keccak import keccak256_batch_np
from reth_tpu_torch.primitives.types import Account
from reth_tpu_torch.storage import MemDb, ProviderFactory
from reth_tpu_torch.storage.genesis import init_genesis
from reth_tpu_torch.trie.committer import TrieCommitter


MIN_TIER = 16


@pytest.fixture(scope="module")
def chains():
    """The chain sealed by each package's ``ChainBuilder``: the same blocks."""
    jb = pipeline_chain(jtesting, JAccount, JCommitter(hasher=jhash))
    pb = pipeline_chain(ptesting, Account, TrieCommitter(hasher=keccak256_batch_np, device="cpu"))
    assert [b.hash for b in pb.blocks] == [b.hash for b in jb.blocks]
    return jb, pb


def _wire(committer, hm, service_cls, **kw):
    """``cli.py``'s ``--mesh --hash-service`` committer: the mesh on the
    committer, one service over it on the committer's hasher, and the
    committer hashing through the service's live lane."""
    committer.hash_mesh = hm
    committer.hash_service = service_cls(backend=committer.hasher, mesh=hm, **kw)
    committer.hasher = committer.hash_service.client("live")
    return committer.hash_service


def _port_tree(builder, depth: int, mesh=None):
    c = TrieCommitter(hasher=keccak256_batch_np, device="cpu")
    svc = None if mesh is None else _wire(c, mesh, phs.HashService, registry=MetricsRegistry(),
                                          min_tier=MIN_TIER, device="cpu")
    factory = ProviderFactory(MemDb())
    init_genesis(factory, builder.genesis, builder.accounts_at_genesis, committer=c)
    return EngineTree(factory, committer=c, persistence_threshold=100, pipeline_depth=depth,
                      device="cpu"), svc


def _ref_tree(builder, n: int):
    c = JCommitter(hasher=jhash)
    svc = _wire(c, jmesh.HashMesh(jax.devices()[:n], registry=JRegistry()), jhs.HashService,
                registry=JRegistry(), min_tier=MIN_TIER)
    factory = JFactory(JMemDb())
    jinit_genesis(factory, builder.genesis, builder.accounts_at_genesis, committer=c)
    return JEngineTree(factory, committer=c, persistence_threshold=100, pipeline_depth=2), svc


def _blocks(tree, blocks) -> list:
    """Each block's state root, receipts (EIP-2718 encodings) and senders."""
    out = []
    for b in blocks:
        eb = tree.blocks[b.hash]
        out.append((eb.block.header.state_root, [r.encode_2718() for r in eb.receipts],
                    list(eb.senders)))
    return out


@pytest.mark.parametrize("n", [2, 3])
def test_two_deep_import_over_meshed_service_equals_reference_and_serial(chains, n, monkeypatch):
    jb, pb = chains
    blocks = pb.blocks[1:]
    piped, svc = _port_tree(pb, 2, roster(n))
    ref, jsvc = _ref_tree(jb, n)
    serial, _ = _port_tree(pb, 1)
    late = hold_root_until_child_arrives(monkeypatch, piped, blocks)
    try:
        got = ppipeline.import_chain(piped, blocks, fcu=False, overlap=True)
        want = jpipeline.import_chain(ref, jb.blocks[1:], fcu=False, overlap=True)
        one = ppipeline.import_chain(serial, blocks, fcu=False, overlap=False)
    finally:
        svc.stop()
        jsvc.stop()
    assert late == [], f"no child payload reached try_speculate within the hold: {late}"
    for statuses in (got, want, one):
        assert [s.status.value for s in statuses] == ["VALID"] * len(blocks)
    assert _blocks(piped, blocks) == _blocks(serial, blocks) == _blocks(ref, jb.blocks[1:])
    stats = piped.pipeline.stats_snapshot()
    assert stats["speculations"] >= 1 and stats["adopted"] >= 1
    assert svc.pipeline_leases >= 1
    assert stats["leases_active"] == 0
    assert ref.pipeline.stats_snapshot()["leases_active"] == 0
    assert svc.snapshot()["mesh"]["leased"] == 0
