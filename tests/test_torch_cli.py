"""The port's CLI (``reth_tpu_torch/cli.py``) against the JAX package's, every
subcommand of tests/test_cli.py on the same files: exit codes, standard
output and standard error equal (each side's paths and walls masked) and the
datadirs' tables equal, tolerance zero. The reference runs ``--hasher cpu``
(its numpy committer); the port runs ``--device cpu`` on its default
``--hasher device`` route, the card route's plain versions (kernel 1's for
every hash, the level kernels' for MerkleStage's rebuild). Also the smoke's
leg a at a small size: ``init`` and ``import`` of a ``SyncChain`` through a
geth-style genesis JSON."""

from __future__ import annotations

import json
import re
import shutil
import types

import pytest
from _torch_helpers import SYNC_BLOCK_SMALL, SyncChain, geth_genesis
from _torch_node_pkgs import NPORT, NREF, ALICE, Account, ChainBuilder, Wallet, both, \
    ref_committer, store_tables

from reth_tpu import testing as jtesting
from reth_tpu.consensus import EthBeaconConsensus as JConsensus
from reth_tpu.net import NetworkManager as JNetworkManager
from reth_tpu.net import Status as JStatus
from reth_tpu.primitives import keccak as jkeccak
from reth_tpu.primitives import secp256k1 as jsecp
from reth_tpu.primitives import types as jtypes
from reth_tpu.stages import Pipeline as JPipeline
from reth_tpu.stages import default_stages as jdefault_stages
from reth_tpu.storage import MemDb as JMemDb
from reth_tpu.storage import ProviderFactory as JFactory
from reth_tpu.storage.genesis import import_chain as jimport_chain
from reth_tpu.storage.genesis import init_genesis as jinit_genesis
from reth_tpu_torch.convert import alloc_to_fields

_WALL = re.compile(r" in \d+\.\d+s")


def run(P, capsys, *argv, committer: bool = False) -> tuple:
    """P's ``main(argv)`` (plus ``P.argv`` where the subcommand builds a
    committer): (exit code, stdout, stderr), walls masked."""
    capsys.readouterr()
    rc = P.cli.main(list(argv) + (P.argv if committer else []))
    out = capsys.readouterr()
    return rc, _WALL.sub(" in <t>s", out.out), _WALL.sub(" in <t>s", out.err)


@pytest.fixture(scope="module")
def chain_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chain")
    alice = Wallet(ALICE)
    builder = ChainBuilder({alice.address: Account(balance=10**21)}, committer=ref_committer())
    for i in range(3):
        builder.build_block([alice.transfer(b"\x0b" * 20, 1000 + i)])
    genesis = {
        "config": {"chainId": 1},
        "gasLimit": hex(builder.genesis.gas_limit),
        "baseFeePerGas": hex(builder.genesis.base_fee_per_gas),
        "alloc": {"0x" + alice.address.hex(): {"balance": hex(10**21)}},
    }
    gpath = tmp / "genesis.json"
    gpath.write_text(json.dumps(genesis))
    cpath = tmp / "chain.rlp"
    cpath.write_bytes(builder.export_rlp())
    return tmp, gpath, cpath, builder


def each(tmp_path):
    """Each side's own directory under ``tmp_path``, masked as one path."""
    return lambda P: (tmp_path / P.name,)


def test_init_and_db_stats(chain_files, capsys, tmp_path):
    _, gpath, _, builder = chain_files

    def scenario(P):
        d = tmp_path / P.name / "data1"
        d.mkdir(parents=True)
        obs = [run(P, capsys, "init", "--datadir", str(d), "--genesis", str(gpath),
                   committer=True),
               run(P, capsys, "db", "stats", "--datadir", str(d))]
        return obs + [store_tables(P, "paged", d)]

    got = both(scenario, paths=each(tmp_path))
    assert got[0][0] == 0 and builder.genesis.hash.hex() in got[0][1]
    assert "PlainAccountState" in got[1][1]


def test_import_pipeline_and_stage_rerun(chain_files, capsys, tmp_path):
    _, gpath, cpath, _ = chain_files

    def scenario(P):
        d = tmp_path / P.name / "data2"
        d.mkdir(parents=True)
        obs = [run(P, capsys, "import", "--datadir", str(d), "--genesis", str(gpath),
                   str(cpath), committer=True),
               run(P, capsys, "stage", "run", "--datadir", str(d), "--stage", "all",
                   committer=True)]
        return obs + [store_tables(P, "paged", d)]

    got = both(scenario, paths=each(tmp_path))
    assert got[0][0] == 0 and "imported 3 blocks" in got[0][1]
    assert "pipeline synced to 3" in got[0][1] and got[1][0] == 0


def test_db_verify_trie(chain_files, capsys, tmp_path):
    _, gpath, cpath, _ = chain_files

    def scenario(P):
        d = tmp_path / P.name / "data_verify"
        d.mkdir(parents=True)
        run(P, capsys, "import", "--datadir", str(d), "--genesis", str(gpath), str(cpath),
            committer=True)
        obs = [run(P, capsys, "db", "verify-trie", "--datadir", str(d), committer=True)]
        # a hashed account the trie does not hold: the root mismatches
        factory = P.storage.ProviderFactory(P.native.PagedDb(d / "pageddb"))
        with factory.provider_rw() as p:
            p.put_hashed_account(b"\x42" * 32, P.types.Account(balance=1))
        factory.db.flush()
        factory.db.close()
        obs.append(run(P, capsys, "db", "verify-trie", "--datadir", str(d), committer=True))
        # a stored branch node the leaves do not make: a structural problem
        factory = P.storage.ProviderFactory(P.native.PagedDb(d / "pageddb"))
        with factory.provider_rw() as p:
            p.put_account_branch(b"\x0a\x0b", P.BranchNode(0b11, 0, 0b1, (b"\x99" * 32,)))
        factory.db.flush()
        factory.db.close()
        obs.append(run(P, capsys, "db", "verify-trie", "--datadir", str(d), committer=True))
        return obs

    got = both(scenario, paths=each(tmp_path))
    assert got[0][0] == 0 and "trie OK at block 3" in got[0][1]
    assert got[1][0] == 1 and "TRIE MISMATCH" in got[1][2]
    assert got[2][0] == 1 and "extra stored branch" in got[2][2]


def test_genesis_mismatch_cli(chain_files, capsys, tmp_path):
    _, gpath, _, _ = chain_files
    other = json.loads(gpath.read_text())
    other["alloc"] = {}
    g2 = tmp_path / "g2.json"
    g2.write_text(json.dumps(other))

    def scenario(P):
        d = tmp_path / P.name / "data3"
        d.mkdir(parents=True)
        obs = [run(P, capsys, "init", "--datadir", str(d), "--genesis", str(gpath),
                   committer=True)]
        # a second init with another genesis fails loudly
        with pytest.raises(P.genesis.GenesisMismatch) as err:
            P.cli.main(["init", "--datadir", str(d), "--genesis", str(g2)] + P.argv)
        return obs + [str(err.value)]

    both(scenario, paths=each(tmp_path))


def test_dump_genesis_config_and_vectors(capsys):
    def scenario(P):
        return [run(P, capsys, "dump-genesis"), run(P, capsys, "config"),
                run(P, capsys, "test-vectors", "--count", "3", "--seed", "5")]

    got = both(scenario)
    assert json.loads(got[0][1])["config"]["chainId"] == 1337
    assert "[stages.merkle]" in got[1][1]
    assert len(json.loads(got[2][1])["accounts"]) == 3


def test_re_execute_and_prune(chain_files, capsys, tmp_path):
    _, gpath, cpath, _ = chain_files
    cfg = tmp_path / "reth.toml"
    cfg.write_text("[prune.sender_recovery]\ndistance = 0\n")

    def scenario(P):
        d = tmp_path / P.name / "data4"
        d.mkdir(parents=True)
        obs = [run(P, capsys, "import", "--datadir", str(d), "--genesis", str(gpath),
                   str(cpath), committer=True),
               run(P, capsys, "re-execute", "--datadir", str(d)),
               run(P, capsys, "prune", "--datadir", str(d), "--config", str(cfg))]
        return obs + [store_tables(P, "paged", d)]

    got = both(scenario, paths=each(tmp_path))
    assert "re-executed 3 blocks: all match" in got[1][1]
    assert "SenderRecovery" in got[2][1] and "2 entries pruned" in got[2][1]


def test_p2p_command(chain_files, capsys):
    """Both packages' ``p2p`` against one peer: the JAX package's
    ``NetworkManager`` serving the chain over RLPx."""
    _, _, _, builder = chain_files
    cpu = ref_committer()
    factory = JFactory(JMemDb())
    jinit_genesis(factory, builder.genesis, builder.accounts_at_genesis, committer=cpu)
    jimport_chain(factory, builder.blocks[1:], JConsensus(cpu))
    JPipeline(factory, jdefault_stages(committer=cpu)).run(3)
    status = JStatus(network_id=1, head=builder.tip.hash, genesis=builder.genesis.hash)
    server = JNetworkManager(factory, status, node_priv=0xBEEF)
    server.start()
    genesis = "0x" + builder.genesis.hash.hex()
    try:
        def scenario(P):
            return [run(P, capsys, "p2p", "header", "2", "--enode", server.enode,
                        "--genesis-hash", genesis),
                    run(P, capsys, "p2p", "body", "0x" + builder.blocks[2].hash.hex(),
                        "--enode", server.enode, "--genesis-hash", genesis)]

        got = both(scenario)
    finally:
        server.stop()
    assert f"hash=0x{builder.blocks[2].hash.hex()}" in got[0][1]
    assert "transactions=1" in got[1][1]


def test_node_native_db_backend(chain_files, tmp_path):
    """A node on the native WAL engine mines a block end to end."""
    _, _, _, builder = chain_files

    def scenario(P):
        d = tmp_path / P.name / "native_data"
        d.mkdir(parents=True)
        cfg = P.NodeConfig(dev=True, datadir=str(d), db_backend="native",
                           genesis_header=P.header(builder.genesis),
                           genesis_alloc=P.alloc(builder.accounts_at_genesis))
        n = P.node(cfg)
        try:
            n.pool.add_transaction(P.tx(Wallet(ALICE).transfer(b"\x0b" * 20, 42)))
            block = n.miner.mine_block()
            with n.factory.provider() as p:
                last = p.last_block_number()
            return [block.hash, last, type(n.factory.db).__name__]
        finally:
            n.stop()

    assert both(scenario)[2] == "NativeDb"


def test_db_get_list_diff_repair(chain_files, capsys, tmp_path):
    _, gpath, cpath, _ = chain_files

    def scenario(P):
        base = tmp_path / P.name
        d = base / "d"
        d.mkdir(parents=True)
        run(P, capsys, "import", "--datadir", str(d), "--genesis", str(gpath), str(cpath),
            committer=True)
        obs = [run(P, capsys, "db", "list", "--datadir", str(d), "PlainAccountState",
                   "--limit", "5")]
        key = obs[0][1].split()[0]
        obs.append(run(P, capsys, "db", "get", "--datadir", str(d), "PlainAccountState", key))
        shutil.copytree(d, base / "d2")
        obs.append(run(P, capsys, "db", "diff", "--datadir", str(d), str(base / "d2")))
        # a trie node overwritten with garbage: diff finds it, repair heals it
        db = P.native.PagedDb(d / "pageddb")
        with db.tx_mut() as tx:
            entry = tx.cursor(P.tables.Tables.AccountsTrie.name).first()
            tx.put(P.tables.Tables.AccountsTrie.name, entry[0], b"\x00garbage")
        db.flush()
        db.close()
        obs.append(run(P, capsys, "db", "diff", "--datadir", str(d), str(base / "d2")))
        obs.append(run(P, capsys, "db", "repair-trie", "--datadir", str(d), committer=True))
        obs.append(run(P, capsys, "db", "verify-trie", "--datadir", str(d), committer=True))
        return obs + [store_tables(P, "paged", d)]

    got = both(scenario, paths=each(tmp_path))
    assert [o[0] for o in got[:6]] == [0, 0, 0, 1, 0, 0]
    assert "0 difference(s)" in got[2][1] and "repaired" in got[4][1]


def test_init_state(capsys, tmp_path):
    from reth_tpu.trie.state_root import state_root

    root, _ = state_root({b"\xcd" * 20: Account(nonce=1, balance=5)}, {},
                         committer=ref_committer())
    dump = {"header": "0x" + jtypes.Header(number=9, state_root=root).encode().hex(),
            "accounts": {"0x" + "cd" * 20: {"balance": "0x5", "nonce": "0x1"}}}
    spath = tmp_path / "state.json"
    spath.write_text(json.dumps(dump))

    def scenario(P):
        d = tmp_path / P.name / "s"
        obs = [run(P, capsys, "init-state", str(spath), "--datadir", str(d), committer=True),
               run(P, capsys, "db", "verify-trie", "--datadir", str(d), committer=True)]
        return obs + [store_tables(P, "paged", d)]

    got = both(scenario, paths=each(tmp_path))
    assert "block 9" in got[0][1] and got[1][0] == 0


def test_legacy_memdb_datadir_keeps_its_engine(chain_files, capsys, tmp_path):
    """A datadir initialised under ``--db memdb`` keeps opening memdb when
    ``--db`` is unset."""
    _, gpath, cpath, _ = chain_files

    def scenario(P):
        d = tmp_path / P.name / "legacy"
        d.mkdir(parents=True)
        obs = [run(P, capsys, "import", "--datadir", str(d), "--genesis", str(gpath),
                   "--db", "memdb", str(cpath), committer=True),
               run(P, capsys, "db", "stats", "--datadir", str(d))]
        return obs + [(d / "pageddb").exists(), store_tables(P, "memdb", d)]

    got = both(scenario, paths=each(tmp_path))
    assert "CanonicalHeaders" in got[1][1] and got[2] is False


def test_node_explicit_paged_requires_datadir(capsys):
    def scenario(P):
        return [run(P, capsys, "node", "--dev", "--db", "paged", committer=True)]

    got = both(scenario)
    assert got[0][0] == 1 and "needs --datadir" in got[0][2]


def test_stale_empty_store_does_not_mask_initialised_one(chain_files, capsys, tmp_path):
    """An empty pageddb left by a command run before init must not win the
    backend resolution over a later memdb import."""
    _, gpath, cpath, _ = chain_files

    def scenario(P):
        d = tmp_path / P.name / "stale"
        d.mkdir(parents=True)
        obs = [run(P, capsys, "db", "stats", "--datadir", str(d)), (d / "pageddb").exists(),
               run(P, capsys, "import", "--datadir", str(d), "--genesis", str(gpath),
                   "--db", "memdb", str(cpath), committer=True),
               run(P, capsys, "db", "stats", "--datadir", str(d))]
        return obs

    got = both(scenario, paths=each(tmp_path))
    assert got[1] is True and "CanonicalHeaders" in got[3][1]
    assert any(line.split() == ["Transactions", "3"] for line in got[3][1].splitlines())


def test_hash_service_flag_wires_committer(chain_files, capsys, tmp_path):
    """``--hash-service``: the committer grows a service whose live-lane client
    is its hasher; init and verify-trie run through it."""
    _, gpath, _, _ = chain_files

    def scenario(P):
        args = types.SimpleNamespace(hasher="cpu", hash_service=True, device="cpu")
        committer = P.cli._make_committer(args)
        try:
            obs = [type(committer.hash_service).__name__, type(committer.hasher).__name__,
                   committer.hasher.lane, committer.for_lane("proof").hasher.lane,
                   committer.hasher([b"abc"]), committer.hash_service.dispatches >= 1]
        finally:
            committer.hash_service.stop()
        d = tmp_path / P.name / "svc"
        obs += [run(P, capsys, "init", "--datadir", str(d), "--genesis", str(gpath),
                    "--hash-service", committer=True),
                run(P, capsys, "db", "verify-trie", "--datadir", str(d), "--hash-service",
                    committer=True),
                run(P, capsys, "config")]
        return obs + [store_tables(P, "paged", d)]

    got = both(scenario, paths=each(tmp_path))
    assert got[:4] == ["HashService", "HashClient", "live", "proof"]
    assert got[4] == jkeccak.keccak256_batch_np([b"abc"]) and got[5] is True
    assert "hash_service = false" in got[8][1]


def test_port_hasher_cpu_route_matches(chain_files, capsys, tmp_path):
    """The port's explicit host route (``--hasher cpu --device cpu``: the numpy
    hasher, MerkleStage's numpy rebuild) imports the same tables as the
    reference's."""
    _, gpath, cpath, _ = chain_files

    def scenario(P):
        d = tmp_path / P.name / "hcpu"
        d.mkdir(parents=True)
        extra = ["--hasher", "cpu"] if P is NPORT else []
        obs = [run(P, capsys, "import", "--datadir", str(d), "--genesis", str(gpath),
                   str(cpath), *extra, committer=True)]
        return obs + [store_tables(P, "paged", d)]

    both(scenario, paths=each(tmp_path))


def test_sync_chain_init_and_import(capsys, tmp_path):
    """The smoke's leg a at a small size: a ``SyncChain`` (a few hundred
    accounts, storage, contracts, every transaction type, withdrawals) as a
    geth-style genesis JSON whose hash is the chain's, ``init`` and then
    ``import`` of its chain file on the default paged store: the head is the
    chain's tip at its state root, and the tables are equal."""
    pkg = types.SimpleNamespace(testing=jtesting, types=jtypes, keccak=jkeccak,
                                secp256k1=jsecp)
    chain = SyncChain(pkg, n_accounts=300, n_slots=120, seed=47, n_wallets=6, n_blocks=3,
                      sizes=SYNC_BLOCK_SMALL, committer=ref_committer())
    b = chain.builder
    gpath = tmp_path / "sync-genesis.json"
    gpath.write_text(json.dumps(geth_genesis(
        alloc_to_fields(b.accounts_at_genesis, b.storage_at_genesis, b.codes_at_genesis),
        b.genesis)))
    cpath = tmp_path / "sync-chain.rlp"
    cpath.write_bytes(b.export_rlp())

    def scenario(P):
        d = tmp_path / P.name / "sync"
        d.mkdir(parents=True)
        obs = [run(P, capsys, "init", "--datadir", str(d), "--genesis", str(gpath),
                   committer=True),
               run(P, capsys, "import", "--datadir", str(d), "--genesis", str(gpath),
                   str(cpath), committer=True)]
        tables = store_tables(P, "paged", d)
        return obs + [tables]

    got = both(scenario, paths=each(tmp_path))
    assert f"hash=0x{b.genesis.hash.hex()}" in got[0][1]
    assert "pipeline synced to 3" in got[1][1]
    headers = dict(got[2]["Headers"])
    tip = jtypes.Header.decode(headers[(3).to_bytes(8, "big")][0])
    assert tip.hash == b.tip.hash and tip.state_root == b.tip.state_root
