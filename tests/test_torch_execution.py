"""Block execution and the staged sync of the port (testing.py, consensus/,
storage/genesis.py, stages/, convert.py) against the JAX package's, on the
CPU, tolerance zero.

Chains: tests/test_pipeline_e2e.py's six-block chain, and the staged-sync
chain of chip_smoke.py's "sync" path at a small size
(tests/_torch_helpers.py ``SyncChain``, ``SYNC_BLOCK_SMALL``), each built by
both packages' ``ChainBuilder`` from the same wallets: the same block
hashes. The port syncs the reference's chain carried across by its
encodings (``convert.blocks_from_rlp``, ``alloc_from_fields``), on its
``"cuda"`` route run on ``device="cpu"`` (the kernels' plain versions); the
reference syncs it on its numpy committer. After every step the two
databases hold the same rows in every table.
"""

from __future__ import annotations

import types

import pytest

from _torch_helpers import SYNC_BLOCK_SMALL, SyncChain
from reth_tpu import testing as jtesting
from reth_tpu.consensus import EthBeaconConsensus as JConsensus
from reth_tpu.primitives import keccak as jkeccak
from reth_tpu.primitives import secp256k1 as jsecp
from reth_tpu.primitives import types as jtypes
from reth_tpu.stages import Pipeline as JPipeline
from reth_tpu.stages import default_stages as jdefault_stages
from reth_tpu.storage import MemDb as JMemDb
from reth_tpu.storage import ProviderFactory as JFactory
from reth_tpu.storage import genesis as jgenesis
from reth_tpu.trie.committer import TrieCommitter as JCommitter
from reth_tpu_torch import convert
from reth_tpu_torch import testing as ptesting
from reth_tpu_torch.consensus import ConsensusError, EthBeaconConsensus
from reth_tpu_torch.primitives import keccak as pkeccak
from reth_tpu_torch.primitives import secp256k1 as psecp
from reth_tpu_torch.primitives import types as ptypes
from reth_tpu_torch.stages import (ExecutionStage, Pipeline, SenderRecoveryStage, StageError,
                                   default_stages)
from reth_tpu_torch.storage import MemDb, ProviderFactory
from reth_tpu_torch.storage import genesis as pgenesis
from reth_tpu_torch.trie.committer import TrieCommitter

JAX = types.SimpleNamespace(testing=jtesting, types=jtypes, keccak=jkeccak, secp256k1=jsecp)
PORT = types.SimpleNamespace(testing=ptesting, types=ptypes, keccak=pkeccak, secp256k1=psecp)
STORE_CODE = bytes.fromhex("5f355f5500")  # sstore(0, calldata[0])


def ref_committer():
    return JCommitter(hasher=jkeccak.keccak256_batch_np)


def initcode_for(runtime: bytes) -> bytes:
    n = len(runtime)
    return bytes([0x60, n, 0x60, 0x0B, 0x5F, 0x39, 0x60, n, 0x5F, 0xF3]) + b"\x00" + runtime


def e2e_chain(pkg, committer):
    """tests/test_pipeline_e2e.py's chain: transfers, a deploy, contract
    calls, a slot overwritten and deleted, an empty block."""
    alice, bob = pkg.testing.Wallet(0xA11CE), pkg.testing.Wallet(0xB0B)
    Account = pkg.types.Account
    builder = pkg.testing.ChainBuilder(
        {alice.address: Account(balance=10**21), bob.address: Account(balance=10**20)},
        committer=committer)
    builder.build_block([alice.transfer(bob.address, 10**18),
                         bob.transfer(alice.address, 5 * 10**17)])
    builder.build_block([alice.deploy(initcode_for(STORE_CODE))])
    contract = [a for a, acc in builder.accounts.items()
                if acc.code_hash == pkg.keccak.keccak256(STORE_CODE)][0]
    builder.build_block([alice.call(contract, (0xBEEF).to_bytes(32, "big"))])
    builder.build_block([alice.call(contract, (0xCAFE).to_bytes(32, "big")),
                         alice.transfer(b"\x99" * 20, 123)])
    builder.build_block([alice.call(contract, b"\x00" * 32)])
    builder.build_block([])
    return builder


def sync_chain(pkg, committer):
    return SyncChain(pkg, n_accounts=60, n_slots=24, seed=47, n_wallets=4, n_blocks=3,
                     sizes=SYNC_BLOCK_SMALL, committer=committer).builder


@pytest.fixture(scope="module")
def chains():
    """Each chain built on both packages: (reference builder, port builder)."""
    return {
        "e2e": (e2e_chain(JAX, ref_committer()), e2e_chain(PORT, TrieCommitter(device="cpu"))),
        "sync": (sync_chain(JAX, ref_committer()), sync_chain(PORT, TrieCommitter(device="cpu"))),
    }


def port_inputs(ref):
    """The reference builder's genesis and chain, carried across by their
    encodings and plain fields."""
    fields = {a: dict(nonce=acc.nonce, balance=acc.balance,
                      code=ref.codes_at_genesis.get(acc.code_hash, b""),
                      storage=ref.storage_at_genesis.get(a, {}))
              for a, acc in ref.accounts_at_genesis.items()}
    accounts, storage, codes = convert.alloc_from_fields(fields)
    return (ptypes.Header.decode(ref.genesis.encode()), accounts, storage, codes,
            convert.blocks_from_rlp(ref.export_rlp()))


def tables(db) -> dict:
    return {name: dict(rows) for name, rows in db._tables.items() if rows}


class Synced:
    """One chain synced by both packages' default_stages: ``ref`` /
    ``port`` factories and pipelines over their MemDbs."""

    def __init__(self, ref_builder, target=None):
        tip = ref_builder.tip.number if target is None else target
        c = ref_committer()
        self.ref_db = JMemDb()
        self.ref = JFactory(self.ref_db)
        jgenesis.init_genesis(self.ref, ref_builder.genesis,
                              dict(ref_builder.accounts_at_genesis),
                              storage=ref_builder.storage_at_genesis,
                              codes=ref_builder.codes_at_genesis, committer=c)
        jgenesis.import_chain(self.ref, ref_builder.blocks[1:], JConsensus(c))
        self.ref_pipe = JPipeline(self.ref, jdefault_stages(committer=c))
        self.ref_pipe.run(tip)

        header, accounts, storage, codes, blocks = port_inputs(ref_builder)
        self.db = MemDb()
        self.port = ProviderFactory(self.db)
        pgenesis.init_genesis(self.port, header, accounts, storage=storage, codes=codes,
                              device="cpu")
        pgenesis.import_chain(self.port, blocks, EthBeaconConsensus(device="cpu"))
        self.stages = default_stages(device="cpu")
        self.pipe = Pipeline(self.port, self.stages)
        self.pipe.run(tip)

    def same_tables(self):
        got, want = tables(self.db), tables(self.ref_db)
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name] == want[name], name
        return got


@pytest.mark.parametrize("name", ["e2e", "sync"])
def test_chain_builder_seals_the_same_blocks(chains, name):
    ref, port = chains[name]
    assert [b.hash for b in port.blocks] == [b.hash for b in ref.blocks]
    assert port.export_rlp() == ref.export_rlp()
    assert [b.encode() for b in convert.blocks_from_rlp(ref.export_rlp())] == [
        b.encode() for b in port.blocks[1:]]
    assert port.genesis.encode() == ref.genesis.encode()


def test_sync_chain_shape(chains):
    """Every kind of transaction of the "sync" block."""
    ref, port = chains["sync"]
    blk = port.blocks[1]
    assert [tx.tx_type for tx in blk.transactions].count(4) == 1
    assert {tx.tx_type for tx in blk.transactions} == {0, 1, 2, 4}
    assert len(blk.withdrawals) == SYNC_BLOCK_SMALL["withdrawals"]
    n = sum(v for k, v in SYNC_BLOCK_SMALL.items() if k not in ("fresh", "new_holders",
                                                                 "runtime", "withdrawals"))
    assert len(blk.transactions) == n


def test_alloc_fields_round_trip(chains):
    ref, _ = chains["sync"]
    header, accounts, storage, codes, _ = port_inputs(ref)
    fields = convert.alloc_to_fields(accounts, storage, codes)
    assert convert.alloc_from_fields(fields) == (accounts, storage, codes)
    assert header.hash == ref.genesis.hash


@pytest.mark.parametrize("name", ["e2e", "sync"])
def test_default_stages_sync_equal(chains, name):
    ref, _ = chains[name]
    s = Synced(ref)
    got = s.same_tables()
    tip = ref.tip.number
    p = s.port.provider()
    assert {st.id: p.stage_checkpoint(st.id) for st in s.stages} == {
        st.id: tip for st in s.stages}
    assert p.header_by_number(tip).state_root == ref.tip.state_root
    assert s.stages[5].fallbacks == 0
    if name == "sync":  # every transaction of the chain succeeded
        idx = p.block_body_indices(tip)
        assert all(p.receipt(i).success for i in range(idx.next_tx_num))
    for table in ("TransactionSenders", "Receipts", "AccountChangeSets", "StorageChangeSets",
                  "TransactionHashNumbers", "AccountsHistory", "HashedAccounts", "AccountsTrie"):
        assert got.get(table), table


def test_unwind_and_resync_equal(chains):
    """Unwind to 3 and sync again on both: the same tables after each, and
    after the re-sync the tables of the first sync."""
    ref, _ = chains["e2e"]
    s = Synced(ref)
    first = s.same_tables()
    s.ref_pipe.unwind(3)
    s.pipe.unwind(3)
    s.same_tables()
    p = s.port.provider()
    for stage in ("Execution", "MerkleExecute", "Finish", "SenderRecovery"):
        assert p.stage_checkpoint(stage) == 3
    contract = [a for a, acc in ref.accounts.items()
                if acc.code_hash == pkeccak.keccak256(STORE_CODE)][0]
    assert p.storage(contract, b"\x00" * 32) == 0xBEEF
    s.ref_pipe.run(ref.tip.number)
    s.pipe.run(ref.tip.number)
    assert s.same_tables() == first


def test_incremental_second_sync_equal(chains):
    """Sync to 3, then on to the tip: the incremental Merkle route on both."""
    ref, _ = chains["e2e"]
    s = Synced(ref, target=3)
    s.same_tables()
    s.ref_pipe.run(ref.tip.number)
    s.pipe.run(ref.tip.number)
    s.same_tables()
    assert s.port.provider().header_by_number(ref.tip.number).state_root == ref.tip.state_root


def _tampered(ref, block_no: int, **header_fields):
    """The reference's chain with block ``block_no``'s first transaction
    given ``s = 0`` (no header change), or its header given
    ``header_fields``; returned for both packages."""
    blocks = list(ref.blocks[1:])
    blk = blocks[block_no - 1]
    if header_fields:
        blk = jtypes.Block(jtypes.Header(**{**blk.header.__dict__, **header_fields}),
                           blk.transactions, blk.ommers, blk.withdrawals)
    else:
        bad = jtypes.Transaction(**{**blk.transactions[0].__dict__, "s": 0})
        blk = jtypes.Block(blk.header, (bad,) + tuple(blk.transactions[1:]), blk.ommers,
                           blk.withdrawals)
    blocks[block_no - 1] = blk
    return blocks, convert.blocks_from_rlp(b"".join(b.encode() for b in blocks))


def _run_both(ref, jblocks, pblocks, jstages, pstages, target):
    """Import without validation and run ``target`` on both; each side's
    StageError."""
    c = ref_committer()
    jf = JFactory(JMemDb())
    jgenesis.init_genesis(jf, ref.genesis, dict(ref.accounts_at_genesis), committer=c)
    jgenesis.import_chain(jf, jblocks)
    header, accounts, storage, codes, _ = port_inputs(ref)
    pf = ProviderFactory(MemDb())
    pgenesis.init_genesis(pf, header, accounts, storage=storage, codes=codes, device="cpu")
    pgenesis.import_chain(pf, pblocks)
    errors = []
    for factory, stages in ((jf, jstages), (pf, pstages)):
        with pytest.raises(Exception) as info:
            (JPipeline if factory is jf else Pipeline)(factory, stages).run(target)
        errors.append(info.value)
    return errors


def test_sender_recovery_invalid_signature_error_equal(chains):
    from reth_tpu.stages import SenderRecoveryStage as JSenderRecovery

    ref, _ = chains["e2e"]
    jblocks, pblocks = _tampered(ref, 2)
    jerr, perr = _run_both(ref, jblocks, pblocks, [JSenderRecovery()], [SenderRecoveryStage()], 6)
    assert type(perr) is StageError and type(jerr).__name__ == "StageError"
    assert str(perr) == str(jerr) == "invalid signature in block 2 tx 0: signature out of range"
    assert perr.block == jerr.block == 2


def test_execution_post_validation_error_equal(chains):
    from reth_tpu.stages import ExecutionStage as JExecution
    from reth_tpu.stages import SenderRecoveryStage as JSenderRecovery

    ref, _ = chains["e2e"]
    jblocks, pblocks = _tampered(ref, 4, gas_used=ref.blocks[4].header.gas_used + 1)
    jerr, perr = _run_both(
        ref, jblocks, pblocks, [JSenderRecovery(), JExecution(consensus=JConsensus(
            ref_committer()))],
        [SenderRecoveryStage(), ExecutionStage(device="cpu")], 6)
    assert str(perr) == str(jerr)
    assert str(perr).startswith("post-execution validation failed at 4: gas used ")
    assert isinstance(perr.__cause__, ConsensusError)


def test_consensus_root_fault_is_the_stage_errors_cause(chains):
    """A fault in the consensus's receipts root (a launch fault, injected
    into the committer's hasher) raises out of the stage with the fault as
    the StageError's cause: nothing carries on on the host."""
    ref, _ = chains["e2e"]
    header, accounts, storage, codes, blocks = port_inputs(ref)
    pf = ProviderFactory(MemDb())
    pgenesis.init_genesis(pf, header, accounts, storage=storage, codes=codes, device="cpu")
    pgenesis.import_chain(pf, blocks)

    def launch_fault(msgs):
        raise RuntimeError("keccak256_absorb: CUDA error 700 at launch")

    consensus = EthBeaconConsensus(TrieCommitter(hasher=launch_fault, device="cpu"))
    with pytest.raises(StageError, match="post-execution validation failed at 1") as info:
        Pipeline(pf, [SenderRecoveryStage(), ExecutionStage(consensus=consensus)]).run(6)
    assert isinstance(info.value.__cause__, RuntimeError)
    assert "CUDA error 700" in str(info.value.__cause__)


def test_import_validates_on_the_consensus_committer(chains):
    """import_chain's pre-execution checks (transactions and withdrawals
    roots) on the port's consensus, and a tampered body rejected with the
    reference's error."""
    from reth_tpu.consensus import ConsensusError as JConsensusError

    ref, _ = chains["sync"]
    header, accounts, storage, codes, blocks = port_inputs(ref)
    consensus = EthBeaconConsensus(device="cpu")
    assert consensus.committer.device.type == "cpu"
    pf = ProviderFactory(MemDb())
    pgenesis.init_genesis(pf, header, accounts, storage=storage, codes=codes, device="cpu")
    assert pgenesis.import_chain(pf, blocks, consensus) == ref.tip.number
    jblocks, pblocks = _tampered(ref, 2)
    with pytest.raises(JConsensusError) as want:
        JConsensus(ref_committer()).validate_block_pre_execution(jblocks[1])
    with pytest.raises(ConsensusError) as got:
        consensus.validate_block_pre_execution(pblocks[1])
    assert str(got.value) == str(want.value) == "transactions root mismatch"


def test_genesis_mismatch_equal(chains):
    ref, _ = chains["e2e"]
    header, accounts, storage, codes, _ = port_inputs(ref)
    pf = ProviderFactory(MemDb())
    assert pgenesis.init_genesis(pf, header, accounts, device="cpu") == ref.genesis.hash
    jf = JFactory(JMemDb())
    jgenesis.init_genesis(jf, ref.genesis, dict(ref.accounts_at_genesis),
                          committer=ref_committer())
    other = jtypes.Header(number=0, state_root=b"\x11" * 32)
    with pytest.raises(jgenesis.GenesisMismatch) as want:
        jgenesis.init_genesis(jf, other, {}, committer=ref_committer())
    with pytest.raises(pgenesis.GenesisMismatch) as got:
        pgenesis.init_genesis(pf, ptypes.Header.decode(other.encode()), {}, device="cpu")
    assert str(got.value) == str(want.value)
    # a fresh database whose computed root differs from the header's
    with pytest.raises(pgenesis.GenesisMismatch, match="computed genesis state root"):
        pgenesis.init_genesis(ProviderFactory(MemDb()), ptypes.Header.decode(other.encode()),
                              accounts, device="cpu")
