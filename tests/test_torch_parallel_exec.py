"""The port's parallel executors (engine/native_exec.py with csrc/evmexec.cpp,
engine/bal.py, engine/optimistic.py) and its cross-block import pipeline
(engine/block_pipeline.py) against the port's serial interpreter and the
JAX package's executors, on the CPU, tolerance zero.

Each block is built by one function run on both packages (their own
``Account``, ``Transaction``, ``Header`` and ``Block``), from the cases of
tests/test_native_exec.py, test_bal.py and test_parallel_exec.py. Outputs are
compared by receipts' EIP-2718 encodings, gas, post state, changesets and
requests; accounts, whose classes differ between the packages, by their
fields. The import pipeline runs the small staged-sync chain
(tests/_torch_helpers.py ``SyncChain``) built by the JAX package's
``ChainBuilder`` and carried across by its RLP.
"""

from __future__ import annotations

import types

import numpy as np
import pytest

from _torch_helpers import SYNC_BLOCK_SMALL, SyncChain, hold_root_until_child_arrives
from reth_tpu import testing as jtesting
from reth_tpu.engine import EngineTree as JEngineTree
from reth_tpu.engine import bal as jbal
from reth_tpu.engine import block_pipeline as jpipeline
from reth_tpu.engine import optimistic as jopt
from reth_tpu.evm import BlockExecutor as JBlockExecutor
from reth_tpu.evm import EvmConfig as JEvmConfig
from reth_tpu.evm import executor as jexecutor
from reth_tpu.primitives import keccak as jkeccak
from reth_tpu.primitives import secp256k1 as jsecp
from reth_tpu.primitives import types as jtypes
from reth_tpu.storage import MemDb as JMemDb
from reth_tpu.storage import ProviderFactory as JFactory
from reth_tpu.storage import genesis as jgenesis
from reth_tpu.trie.committer import TrieCommitter as JCommitter
from reth_tpu_torch.engine import EngineTree
from reth_tpu_torch.engine import bal as pbal
from reth_tpu_torch.engine import block_pipeline as ppipeline
from reth_tpu_torch.engine import native_exec
from reth_tpu_torch.engine import optimistic as popt
from reth_tpu_torch.evm import BlockExecutor, EvmConfig
from reth_tpu_torch.evm import executor as pexecutor
from reth_tpu_torch.evm.spec import LATEST_SPEC
from reth_tpu_torch.ops._build import BuildError
from reth_tpu_torch.primitives import keccak as pkeccak
from reth_tpu_torch.primitives import types as ptypes
from reth_tpu_torch.storage import MemDb, ProviderFactory
from reth_tpu_torch.storage import genesis as pgenesis
from reth_tpu_torch.trie.committer import TrieCommitter

JAX = types.SimpleNamespace(
    types=jtypes, keccak=jkeccak.keccak256, executor=jexecutor, BlockExecutor=JBlockExecutor,
    config=JEvmConfig(chain_id=1), bal=jbal, optimistic=jopt)
JAX_CHAIN = types.SimpleNamespace(testing=jtesting, types=jtypes, keccak=jkeccak, secp256k1=jsecp)
PORT = types.SimpleNamespace(
    types=ptypes, keccak=pkeccak.keccak256, executor=pexecutor, BlockExecutor=BlockExecutor,
    config=EvmConfig(chain_id=1), bal=pbal, optimistic=popt)

COINBASE = b"\xc0" * 20
STORE_CODE = bytes.fromhex("5f355f5500")  # sstore(0, calldata[0])
REVERT_CODE = bytes.fromhex("5f5ffd")
READ_COINBASE = bytes([0x73]) + COINBASE + bytes.fromhex("315000")
# CALL(store, ...): a call the native core declines
STORE_AT = b"\x5e" + b"\x00" * 19
CALLER_CODE = bytes.fromhex("5f5f5f5f5f73") + STORE_AT + bytes.fromhex("61fffff100")


def _sender(i: int) -> bytes:
    return bytes([0xA0]) + i.to_bytes(19, "big")


def _tx(pkg, nonce, to, value=0, data=b"", gas_limit=200_000):
    return pkg.types.Transaction(tx_type=2, chain_id=1, nonce=nonce,
                                 max_fee_per_gas=100 * 10**9,
                                 max_priority_fee_per_gas=10**9, gas_limit=gas_limit,
                                 to=to, value=value, data=data)


def _block(pkg, txs, **hkw):
    header = pkg.types.Header(number=1, gas_limit=1_000_000_000, base_fee_per_gas=7,
                              beneficiary=COINBASE, **hkw)
    return pkg.types.Block(header, tuple(txs), (), ())


def _code(pkg, accounts, codes, addr, code):
    accounts[addr] = pkg.types.Account(code_hash=pkg.keccak(code))
    codes[pkg.keccak(code)] = code


# -- the blocks (each one function of a package) -------------------------------


def case_transfers_and_stores(pkg):
    accounts, codes = {}, {}
    contract = b"\x5c" + b"\x00" * 19
    _code(pkg, accounts, codes, contract, STORE_CODE)
    senders, txs = [], []
    for i in range(40):
        s = _sender(i)
        accounts[s] = pkg.types.Account(balance=10**20)
        senders.append(s)
        txs.append(_tx(pkg, 0, bytes([0xD0]) + i.to_bytes(19, "big"), value=1 + i,
                       gas_limit=21_000) if i < 30
                   else _tx(pkg, 0, contract, data=i.to_bytes(32, "big")))
    return accounts, codes, _block(pkg, txs), senders


def case_same_slot_and_sender_chains(pkg):
    accounts, codes = {}, {}
    contract = b"\x5d" + b"\x00" * 19
    _code(pkg, accounts, codes, contract, STORE_CODE)
    a, b = _sender(1), _sender(2)
    accounts[a] = pkg.types.Account(balance=10**20)
    accounts[b] = pkg.types.Account(balance=10**20)
    txs = []
    for i in range(6):
        txs.append(_tx(pkg, i, contract, data=(100 + i).to_bytes(32, "big")))
        txs.append(_tx(pkg, i, contract, data=(200 + i).to_bytes(32, "big")))
    return accounts, codes, _block(pkg, txs), [a, b] * 6


def case_declined_calls(pkg):
    accounts, codes = {}, {}
    _code(pkg, accounts, codes, STORE_AT, STORE_CODE)
    caller = b"\x5f" + b"\x00" * 19
    _code(pkg, accounts, codes, caller, CALLER_CODE)
    senders = [_sender(10 + i) for i in range(6)]
    for s in senders:
        accounts[s] = pkg.types.Account(balance=10**20)
    txs = [_tx(pkg, 0, b"\x01" * 20, value=5, gas_limit=21_000),
           _tx(pkg, 0, caller),
           _tx(pkg, 0, b"\x02" * 20, value=7, gas_limit=21_000),
           _tx(pkg, 0, STORE_AT, data=(3).to_bytes(32, "big")),
           _tx(pkg, 0, caller),
           _tx(pkg, 0, b"\x03" * 20, value=9, gas_limit=21_000)]
    return accounts, codes, _block(pkg, txs), senders


def case_system_calls(pkg):
    accounts, codes = {}, {}
    _code(pkg, accounts, codes, pkg.executor.BEACON_ROOTS_ADDRESS, STORE_CODE)
    senders = [_sender(i) for i in range(4)]
    for s in senders:
        accounts[s] = pkg.types.Account(balance=10**20)
    txs = [_tx(pkg, 0, bytes([0xD0 + i]) * 20, value=1 + i, gas_limit=21_000)
           for i in range(4)]
    return accounts, codes, _block(pkg, txs, parent_beacon_block_root=b"\x42" * 32), senders


def case_randomized(conflict_rate: float):
    def build(pkg):
        rng = np.random.default_rng(int(conflict_rate * 10) * 7 + 4)
        accounts, codes = {}, {}
        shared, reader, reverter = b"\x5e" * 20, b"\x5d" * 20, b"\x5b" * 20
        _code(pkg, accounts, codes, shared, STORE_CODE)
        _code(pkg, accounts, codes, reader, READ_COINBASE)
        _code(pkg, accounts, codes, reverter, REVERT_CODE)
        chain_sender = _sender(999)
        accounts[chain_sender] = pkg.types.Account(balance=10**20)
        chain_nonce = 0
        senders, txs = [], []
        for i in range(28):
            roll = rng.random()
            s = _sender(i)
            if conflict_rate <= roll < conflict_rate + 0.1:
                senders.append(chain_sender)
                txs.append(_tx(pkg, chain_nonce, bytes([0xD0]) * 20, value=1 + i,
                               gas_limit=21_000))
                chain_nonce += 1
                continue
            accounts[s] = pkg.types.Account(balance=10**20)
            senders.append(s)
            if roll < conflict_rate:
                word = int(rng.integers(1, 1 << 60)).to_bytes(32, "big")
                txs.append(_tx(pkg, 0, shared, data=word))
            elif roll < conflict_rate + 0.15:
                txs.append(_tx(pkg, 0, reader))
            elif roll < conflict_rate + 0.2:
                txs.append(_tx(pkg, 0, reverter))
            else:
                c = bytes([0x5C]) + i.to_bytes(19, "big")
                _code(pkg, accounts, codes, c, STORE_CODE)
                txs.append(_tx(pkg, 0, c, data=int(rng.integers(1, 1 << 60)).to_bytes(32, "big")))
        return accounts, codes, _block(pkg, txs), senders
    return build


CASES = {
    "transfers_and_stores": case_transfers_and_stores,
    "same_slot_and_sender_chains": case_same_slot_and_sender_chains,
    "declined_calls": case_declined_calls,
    "system_calls": case_system_calls,
    "randomized_0.0": case_randomized(0.0),
    "randomized_0.3": case_randomized(0.3),
    "randomized_0.7": case_randomized(0.7),
}


# -- comparison ------------------------------------------------------------------


def _acct(a):
    return None if a is None else (a.nonce, a.balance, a.storage_root, a.code_hash)


def canon(out) -> dict:
    """An execution output in plain values, comparable across packages."""
    return {
        "receipts": [r.encode_2718() for r in out.receipts],
        "gas": out.gas_used,
        "post_accounts": {k: _acct(v) for k, v in out.post_accounts.items()},
        "post_storage": out.post_storage,
        "changes_accounts": {k: _acct(v) for k, v in out.changes.accounts.items()},
        "changes_storage": out.changes.storage,
        "wiped": out.changes.wiped_storage,
        "requests": out.requests,
    }


def _source(pkg, accounts, codes):
    return pkg.executor.InMemoryStateSource(dict(accounts), codes=dict(codes))


def run_ways(pkg, case, monkeypatch):
    """The case's block through ``pkg``'s serial executor, its BAL
    executor on the Python ranks and on the native core, and its
    optimistic scheduler: ``{way: (canonical output, stats)}``."""
    accounts, codes, block, senders = case(pkg)
    cfg = pkg.config
    outs = {"serial": (canon(pkg.BlockExecutor(_source(pkg, accounts, codes), cfg)
                             .execute(block, senders)), None)}
    hint = pkg.bal.record_access_list(_source(pkg, accounts, codes), block, senders, cfg)
    with monkeypatch.context() as m:
        m.setenv("RETH_TPU_BAL_NATIVE", "0")
        out, stats = pkg.bal.execute_block_bal(_source(pkg, accounts, codes), block, senders,
                                               hint, cfg)
        outs["bal python"] = (canon(out), stats)
    out, stats = pkg.bal.execute_block_bal(_source(pkg, accounts, codes), block, senders, hint, cfg)
    outs["bal native"] = (canon(out), stats)
    out, stats = pkg.optimistic.execute_block_optimistic(_source(pkg, accounts, codes), block,
                                                         senders, cfg, max_workers=4)
    outs["optimistic"] = (canon(out), stats)
    return outs


@pytest.mark.parametrize("name", sorted(CASES))
def test_executors_equal_serial_and_reference(name, monkeypatch):
    port = run_ways(PORT, CASES[name], monkeypatch)
    ref = run_ways(JAX, CASES[name], monkeypatch)
    serial = port["serial"][0]
    assert serial == ref["serial"][0]
    for way in ("bal python", "bal native", "optimistic"):
        assert port[way][0] == ref[way][0], way
        # the BAL executor folds no system call (the reference's does not
        # either); every other way equals the serial executor
        if way == "optimistic" or ref[way][0] == ref["serial"][0]:
            assert port[way][0] == serial, way
    # the schedulers took the same route on both packages
    assert port["bal native"][1] == ref["bal native"][1]
    keys = ("native", "python", "fallback", "native_available", "serial_rerun")
    assert {k: port["optimistic"][1][k] for k in keys} == \
        {k: ref["optimistic"][1][k] for k in keys}
    assert port["optimistic"][1]["fallback"] is None
    if name == "transfers_and_stores":
        assert port["bal native"][1]["native"] == 40
        assert port["optimistic"][1]["native"] == 40
    if name == "declined_calls":
        # the native core declines the CALLs, which run on the interpreter
        assert 0 < port["optimistic"][1]["native"] < 6


def test_native_library_is_built_by_the_gxx_route():
    lib = native_exec.load_library()
    path = native_exec._SRC
    assert path.name == "evmexec.cpp" and path.parent.name == "csrc"
    assert path.read_bytes() == (path.parents[2] / "native" / "evmexec.cpp").read_bytes()
    from reth_tpu_torch.ops import _build

    assert _build.loaded_from()[path].parent == _build.BUILD_DIR
    assert lib is native_exec.load_library()


def test_failed_native_build_raises_build_error(tmp_path, monkeypatch):
    """A source that does not compile raises BuildError out of the loader,
    the optimistic scheduler and the BAL flow; the reference's callers fall
    to Python ranks instead."""
    broken = tmp_path / "evmexec.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native_exec, "_SRC", broken)
    monkeypatch.setattr(native_exec, "_lib", None)
    with pytest.raises(BuildError):
        native_exec.load_library()
    accounts, codes, block, senders = case_transfers_and_stores(PORT)
    with pytest.raises(BuildError):
        popt.execute_block_optimistic(_source(PORT, accounts, codes), block, senders,
                                      PORT.config)
    hint = pbal.record_access_list(_source(PORT, accounts, codes), block, senders, PORT.config)
    with pytest.raises(BuildError):
        pbal.execute_block_bal(_source(PORT, accounts, codes), block, senders, hint, PORT.config)


# -- the engine tree's parallel execution and the import pipeline ------------------


@pytest.fixture(scope="module")
def chain():
    return SyncChain(JAX_CHAIN, n_accounts=60, n_slots=24, seed=47, n_wallets=4, n_blocks=4,
                     sizes=SYNC_BLOCK_SMALL,
                     committer=JCommitter(hasher=jkeccak.keccak256_batch_np)).builder


def _trees(ref_builder, **kw):
    """A reference tree and a port tree over the chain's genesis, each with a
    numpy-hashing committer; ``kw`` goes to both ``EngineTree``s."""
    jc = JCommitter(hasher=jkeccak.keccak256_batch_np)
    ref = JFactory(JMemDb())
    jgenesis.init_genesis(ref, ref_builder.genesis, dict(ref_builder.accounts_at_genesis),
                          storage=ref_builder.storage_at_genesis,
                          codes=ref_builder.codes_at_genesis, committer=jc)
    pc = TrieCommitter(hasher=pkeccak.keccak256_batch_np, device="cpu")
    port = ProviderFactory(MemDb())
    from reth_tpu_torch import convert

    fields = {a: dict(nonce=acc.nonce, balance=acc.balance,
                      code=ref_builder.codes_at_genesis.get(acc.code_hash, b""),
                      storage=ref_builder.storage_at_genesis.get(a, {}))
              for a, acc in ref_builder.accounts_at_genesis.items()}
    accounts, storage, codes = convert.alloc_from_fields(fields)
    pgenesis.init_genesis(port, ptypes.Header.decode(ref_builder.genesis.encode()), accounts,
                          storage=storage, codes=codes, committer=pc)
    blocks = convert.blocks_from_rlp(ref_builder.export_rlp())
    return (JEngineTree(ref, committer=jc, **kw),
            EngineTree(port, committer=pc, device="cpu", **kw), blocks)


def _tables(tree) -> dict:
    return {name: dict(rows) for name, rows in tree.factory.db._tables.items() if rows}


def _status(st):
    return (st.status.value, st.latest_valid_hash, st.validation_error)


def test_sync_chain_runs_the_native_core_at_the_latest_spec(chain):
    """The staged-sync chain's blocks run at Prague, the native core's spec,
    so the engine's parallel execution takes native ranks on it."""
    blocks = [ptypes.Block.decode(b.encode()) for b in chain.blocks[1:]]
    assert all(EvmConfig().spec_for(b.header.number, b.header.timestamp) is LATEST_SPEC
               for b in blocks)
    assert LATEST_SPEC.name == "prague"
    ref, port, _ = _trees(chain, parallel_exec=True, sparse_workers=1)
    for rb, pb in zip(chain.blocks[1:], blocks):
        assert _status(port.on_new_payload(pb)) == _status(ref.on_new_payload(rb))
        assert port.last_exec["native"] > 0
        assert port.last_exec["fallback"] is None
        assert {k: port.last_exec[k] for k in ("native", "python", "serial_rerun")} == \
            {k: ref.last_exec[k] for k in ("native", "python", "serial_rerun")}


@pytest.mark.parametrize("parallel_exec", [False, True])
def test_pipelined_import_equals_serial_and_reference(chain, parallel_exec, monkeypatch):
    """``import_chain`` two deep (payload N+1 lands while N is in its root
    phase) adopts speculations, and ends with the statuses, roots and table
    rows of a serial import and of the reference's pipelined import."""
    kw = dict(parallel_exec=parallel_exec, sparse_workers=1, persistence_threshold=0)
    ref, port, blocks = _trees(chain, pipeline_depth=2, **kw)
    _, serial, _ = _trees(chain, **kw)
    late = hold_root_until_child_arrives(monkeypatch, port, blocks)
    got = [_status(s) for s in ppipeline.import_chain(port, blocks)]
    assert late == [], f"no child payload reached try_speculate within the hold: {late}"
    want = [_status(s) for s in jpipeline.import_chain(ref, chain.blocks[1:])]
    assert got == want == [("VALID", b.hash, None) for b in blocks]
    assert [_status(s) for s in ppipeline.import_chain(serial, blocks)] == got
    snap = port.pipeline.stats_snapshot()
    assert snap["speculations"] >= 1 and snap["adopted"] >= 1
    assert snap["aborted"] == 0 and snap["prehash_failed"] == 0
    assert port.persisted_number == ref.persisted_number == serial.persisted_number == len(blocks)
    assert _tables(port) == _tables(serial)
    assert _tables(port) == reference_tables(chain, ref)


TRIE_TABLES = ("AccountsTrie", "StoragesTrie")


def reference_tables(chain, ref) -> dict:
    """The reference tree's persisted tables, its stored branches taken from
    its incremental route (``state_root_strategy="pipelined"``) over the
    same chain: the reference's sparse write-back can leave a ``tree_mask``
    bit clear where an insert split an extension above a stored branch, a
    fault the port does not copy (ROADMAP C), so its trie tables are
    held against the route both packages agree on."""
    want = _tables(ref)
    if ref.state_root_strategy == "sparse":
        inc, _, _ = _trees(chain, state_root_strategy="pipelined", persistence_threshold=0)
        for blk in chain.blocks[1:ref.persisted_number + 1]:
            assert inc.on_new_payload(blk).status.value == "VALID"
            inc.on_forkchoice_updated(blk.hash)
        got = _tables(inc)
        for name in TRIE_TABLES:
            want[name] = got.get(name)
        want = {k: v for k, v in want.items() if v}
    return want


def test_speculation_aborts_when_parent_invalid(chain):
    """A parent whose root mismatches closes its window not-ok: the child's
    speculation aborts ("parent_invalid") and the child is judged an invalid
    ancestor, as in the reference."""
    ref, port, blocks = _trees(chain, pipeline_depth=2, sparse_workers=1)
    rb1 = chain.blocks[1]
    bad_r = jtypes.Block(jtypes.Header(**{**rb1.header.__dict__, "state_root": b"\x13" * 32}),
                         rb1.transactions, (), rb1.withdrawals)
    child_r = jtypes.Block(jtypes.Header(**{**chain.blocks[2].header.__dict__,
                                            "parent_hash": bad_r.hash}),
                           chain.blocks[2].transactions, (), chain.blocks[2].withdrawals)
    bad_p = ptypes.Block.decode(bad_r.encode())
    child_p = ptypes.Block.decode(child_r.encode())
    got = [_status(s) for s in ppipeline.import_chain(port, [bad_p, child_p])]
    want = [_status(s) for s in jpipeline.import_chain(ref, [bad_r, child_r])]
    assert got == want
    assert got[0][0] == "INVALID" and got[1] == ("INVALID", None, "invalid ancestor")
