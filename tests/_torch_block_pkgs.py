"""Both packages' block-production and stateless-validation surfaces side by
side, for tests/test_torch_pool.py, test_torch_payload.py and
test_torch_witness.py.

A scenario is one function of a package namespace (``REF``, ``PORT`` or
``PORT_CARD``) that returns a trace of what it observed: hashes, counts,
error classes and messages. Its inputs are the JAX package's: transactions
are signed by the reference's ``Wallet`` and chains sealed by its
``ChainBuilder``, then carried across by their RLP (``P.tx``, ``P.block``)
and a genesis by its plain fields (``genesis_factory``). A test runs the
scenario on the reference and on the port and holds the two traces equal,
tolerance zero.

``PORT`` runs the port's tree on a numpy-hashing committer on the CPU;
``PORT_CARD`` takes the card route's plain versions instead
(``TrieCommitter(device="cpu")``: kernel 1's plain version for every hash;
with ``hot_state=True`` kernel 4's for the import's arena). The port's
``StatelessChain`` always takes its default route, on ``device="cpu"``.
"""

from __future__ import annotations

import types

from reth_tpu import testing as jtesting
from reth_tpu.consensus import EthBeaconConsensus as JConsensus
from reth_tpu.engine import EngineTree as JEngineTree
from reth_tpu.engine import stateless as jstateless
from reth_tpu.engine import witness as jwitness
from reth_tpu.engine.local import LocalMiner as JLocalMiner
from reth_tpu.engine.tree import PayloadStatusKind as JStatus
from reth_tpu.evm import EvmConfig as JEvmConfig
from reth_tpu.payload import builder as jbuilder
from reth_tpu.payload import producer as jproducer
from reth_tpu.pool import batcher as jbatcher
from reth_tpu.pool import blobstore as jblobstore
from reth_tpu.pool import pool as jpool
from reth_tpu.primitives import keccak as jkeccak
from reth_tpu.primitives import kzg as jkzg
from reth_tpu.primitives import types as jtypes
from reth_tpu.stages import Pipeline as JPipeline
from reth_tpu.stages import default_stages as jdefault_stages
from reth_tpu.storage import MemDb as JMemDb
from reth_tpu.storage import ProviderFactory as JFactory
from reth_tpu.storage import genesis as jgenesis
from reth_tpu.trie.committer import TrieCommitter as JCommitter
from reth_tpu_torch import convert
from reth_tpu_torch.consensus import EthBeaconConsensus
from reth_tpu_torch.engine import EngineTree
from reth_tpu_torch.engine import stateless as pstateless
from reth_tpu_torch.engine import witness as pwitness
from reth_tpu_torch.engine.local import LocalMiner
from reth_tpu_torch.engine.tree import PayloadStatusKind
from reth_tpu_torch.evm import EvmConfig
from reth_tpu_torch.payload import builder as pbuilder
from reth_tpu_torch.payload import producer as pproducer
from reth_tpu_torch.pool import batcher as pbatcher
from reth_tpu_torch.pool import blobstore as pblobstore
from reth_tpu_torch.pool import pool as ppool
from reth_tpu_torch.primitives import keccak as pkeccak
from reth_tpu_torch.primitives import kzg as pkzg
from reth_tpu_torch.primitives import types as ptypes
from reth_tpu_torch.stages import Pipeline
from reth_tpu_torch.stages import default_stages
from reth_tpu_torch.storage import MemDb, ProviderFactory
from reth_tpu_torch.storage import genesis as pgenesis
from reth_tpu_torch.trie.committer import TrieCommitter

Wallet = jtesting.Wallet
ChainBuilder = jtesting.ChainBuilder
Account = jtypes.Account


def ref_committer():
    return JCommitter(hasher=jkeccak.keccak256_batch_np)


def np_committer():
    return TrieCommitter(hasher=pkeccak.keccak256_batch_np, device="cpu")


def _ref_tree(factory, **kw):
    return JEngineTree(factory, committer=ref_committer(), **kw)


def _port_tree(card_route: bool):
    def make(factory, **kw):
        committer = TrieCommitter(device="cpu") if card_route else np_committer()
        return EngineTree(factory, committer=committer,
                          consensus=EthBeaconConsensus(np_committer(), device="cpu"),
                          device="cpu", **kw)
    return make


def _ns(**kw):
    ns = types.SimpleNamespace(**kw)
    mods = {k[:-4]: v for k, v in kw.items() if k.endswith("_mod")}
    ns.TransactionPool = mods["pool"].TransactionPool
    ns.PoolConfig = mods["pool"].PoolConfig
    ns.PoolError = mods["pool"].PoolError
    ns.TxBatcher = mods["batcher"].TxBatcher
    ns.PoolOverloaded = mods["batcher"].PoolOverloaded
    ns.BlobSidecar = mods["blobstore"].BlobSidecar
    ns.BlobStoreError = mods["blobstore"].BlobStoreError
    ns.InMemoryBlobStore = mods["blobstore"].InMemoryBlobStore
    ns.DiskBlobStore = mods["blobstore"].DiskBlobStore
    ns.PayloadAttributes = mods["builder"].PayloadAttributes
    ns.PayloadBuilderService = mods["builder"].PayloadBuilderService
    ns.build_payload = mods["builder"].build_payload
    ns.BlockProducer = mods["producer"].BlockProducer
    ns.StatelessValidationError = mods["stateless"].StatelessValidationError
    ns.ExecutionWitness = mods["witness"].ExecutionWitness
    ns.generate_witness = mods["witness"].generate_witness
    return ns


REF = _ns(
    name="reference", types=jtypes, keccak=jkeccak, kzg=jkzg,
    pool_mod=jpool, batcher_mod=jbatcher, blobstore_mod=jblobstore,
    builder_mod=jbuilder, producer_mod=jproducer, stateless_mod=jstateless,
    witness_mod=jwitness, LocalMiner=JLocalMiner, Status=JStatus, EvmConfig=JEvmConfig,
    committer=ref_committer, tree=_ref_tree,
    stateless=lambda cfg: jstateless.StatelessChain(config=cfg),
    consensus=lambda: JConsensus(ref_committer()),
    stages=lambda: jdefault_stages(committer=ref_committer()), Pipeline=JPipeline,
    import_chain=jgenesis.import_chain,
    tx=lambda t: t, block=lambda b: b, header=lambda h: h,
)


def _port(name: str, card_route: bool):
    return _ns(
        name=name, types=ptypes, keccak=pkeccak, kzg=pkzg,
        pool_mod=ppool, batcher_mod=pbatcher, blobstore_mod=pblobstore,
        builder_mod=pbuilder, producer_mod=pproducer, stateless_mod=pstateless,
        witness_mod=pwitness, LocalMiner=LocalMiner, Status=PayloadStatusKind,
        EvmConfig=EvmConfig,
        committer=(lambda: TrieCommitter(device="cpu")) if card_route else np_committer,
        tree=_port_tree(card_route),
        stateless=lambda cfg: pstateless.StatelessChain(config=cfg, device="cpu"),
        consensus=lambda: EthBeaconConsensus(np_committer(), device="cpu"),
        stages=lambda: default_stages(committer=np_committer(), device="cpu"),
        Pipeline=Pipeline, import_chain=pgenesis.import_chain,
        tx=lambda t: ptypes.Transaction.decode(t.encode()),
        block=lambda b: ptypes.Block.decode(b.encode()),
        header=lambda h: ptypes.Header.decode(h.encode()),
    )


PORT = _port("port", card_route=False)
PORT_CARD = _port("port, card route", card_route=True)


def genesis_factory(P, builder):
    """P's database at ``builder``'s genesis: the reference's own, the port's
    from the genesis alloc's plain fields and the genesis header's RLP."""
    if P is REF:
        f = JFactory(JMemDb())
        jgenesis.init_genesis(f, builder.genesis, dict(builder.accounts_at_genesis),
                              storage=builder.storage_at_genesis,
                              codes=builder.codes_at_genesis, committer=ref_committer())
        return f
    fields = {a: dict(nonce=acc.nonce, balance=acc.balance,
                      code=builder.codes_at_genesis.get(acc.code_hash, b""),
                      storage=builder.storage_at_genesis.get(a, {}))
              for a, acc in builder.accounts_at_genesis.items()}
    accounts, storage, codes = convert.alloc_from_fields(fields)
    f = ProviderFactory(MemDb())
    pgenesis.init_genesis(f, P.header(builder.genesis), accounts, storage=storage,
                          codes=codes, committer=np_committer())
    return f


def attempt(fn):
    """``("ok", value)`` or ``("err", class name, message)``: an outcome two
    packages can be held equal on."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the outcome is the observation
        return ("err", type(e).__name__, str(e))


def hashes(txs) -> list[bytes]:
    return [t.hash for t in txs]


def both(scenario, *args, port=PORT):
    """The scenario's trace on the reference and on the port, held equal;
    returns the port's."""
    want = scenario(REF, *args)
    got = scenario(port, *args)
    assert got == want
    return got
