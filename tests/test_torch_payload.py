"""The port's block production (payload/builder.py, payload/producer.py,
engine/local.py) against the JAX package's, on the CPU, tolerance zero.

Every payload case of tests/test_pool_payload.py and test_txflow.py's
producer cases run as one scenario on both packages
(tests/_torch_block_pkgs.py); so do builds over the small staged-sync chain
(tests/_torch_helpers.py ``SyncChain`` at ``SYNC_BLOCK_SMALL``, sealed by the
reference and carried across by its RLP and its genesis's plain fields):
serial and with ``parallel_exec=True``, under a gas ceiling, with an
unexecutable transaction, and the empty payload; ``LocalMiner`` over four
blocks; ``PayloadJob``'s first build. Block hashes, fees, selections and
evictions must be equal. The card route (``TrieCommitter(device="cpu")``
with the hot-state arena) mines through kernel 1's and kernel 4's plain
versions.

The departure: at each of the eight catch-alls of the payload path a kernel
fault (``LaunchError``, also on a ``__cause__`` chain) raises, and any other
cause keeps the reference's fallback, with the reference's result, and is
counted.
"""

from __future__ import annotations

import random
import time
import types

import pytest

from _torch_block_pkgs import (
    PORT,
    PORT_CARD,
    REF,
    Account,
    ChainBuilder,
    Wallet,
    attempt,
    both,
    genesis_factory,
    hashes,
)
from _torch_helpers import SYNC_BLOCK_SMALL, SyncChain
from reth_tpu import testing as jtesting
from reth_tpu.primitives import keccak as jkeccak
from reth_tpu.primitives import secp256k1 as jsecp
from reth_tpu.primitives import types as jtypes
from reth_tpu_torch.engine import optimistic as poptimistic
from reth_tpu_torch.metrics import producer_metrics
from reth_tpu_torch.ops._build import LaunchError, is_kernel_fault

ALICE = 0xA11CE
BOB = 0xB0B
SINK = b"\x0f" * 20
JAX = types.SimpleNamespace(testing=jtesting, types=jtypes, keccak=jkeccak, secp256k1=jsecp)


def make_node(P, n_wallets=0, cancun=False, **tree_kw):
    """alice and bob (or ``n_wallets`` txflow wallets), a tree and a pool."""
    if n_wallets:
        wallets = [Wallet(0x7F000 + i) for i in range(n_wallets)]
        alloc = {w.address: Account(balance=10**21) for w in wallets}
    else:
        wallets = [Wallet(ALICE), Wallet(BOB)]
        alloc = {wallets[0].address: Account(balance=10**21),
                 wallets[1].address: Account(balance=10**20)}
    builder = ChainBuilder(alloc, committer=REF.committer(), cancun=cancun)
    tree = P.tree(genesis_factory(P, builder), persistence_threshold=2, **tree_kw)
    pool = P.TransactionPool(lambda: tree.overlay_provider())
    pool.base_fee = 10**9
    return tree, pool, wallets


def add(P, pool, tx):
    return pool.add_transaction(P.tx(tx))


def block_trace(blk, fees=None) -> tuple:
    return (blk.hash, hashes(blk.transactions), blk.header.gas_used, fees)


# -- tests/test_pool_payload.py ----------------------------------------------


def sc_builder_and_miner(P):
    tree, pool, (alice, bob) = make_node(P)
    for i in range(3):
        add(P, pool, alice.transfer(bob.address, 1000 + i))
    miner = P.LocalMiner(tree, pool)
    block = miner.mine_block()
    balance = tree.overlay_provider().account(bob.address).balance
    b2 = miner.mine_block()
    out = [block_trace(block), tree.head_hash == b2.hash, len(pool), balance, block_trace(b2)]
    assert balance == 10**20 + 3000 + 3 and len(block.transactions) == 3
    assert len(b2.transactions) == 0 and miner.serial_builds == 2
    return out


def sc_service(P):
    tree, pool, (alice, bob) = make_node(P)
    add(P, pool, alice.transfer(bob.address, 5))
    svc = P.PayloadBuilderService(tree, pool)
    pid = svc.new_payload_job(tree.head_hash, P.PayloadAttributes(timestamp=12))
    block, fees = svc.get_payload_with_fees(pid)
    st = tree.on_new_payload(block)
    out = [block_trace(block, fees), st.status.value, len(pid)]
    assert out[1] == "VALID" and len(block.transactions) == 1
    return out


def sc_gas_limit(P):
    tree, pool, (alice, bob) = make_node(P)
    for i in range(5):
        add(P, pool, alice.transfer(bob.address, i + 1))
    block, fees = P.build_payload(tree, pool, tree.head_hash, P.PayloadAttributes(timestamp=12))
    assert block.header.gas_used == 5 * 21000 <= block.header.gas_limit
    return [block_trace(block, fees), block.header.gas_limit]


def sc_job_swap(P):
    tree, pool, (alice, _bob) = make_node(P)
    svc = P.PayloadBuilderService(tree, pool, deadline=5.0, interval=10.0)
    add(P, pool, alice.transfer(b"\x01" * 20, 100))
    pid = svc.new_payload_job(tree.head_hash, P.PayloadAttributes(timestamp=12))
    job = svc.jobs[pid]
    out = [block_trace(job.best, job.best_fees)]
    add(P, pool, alice.transfer(b"\x02" * 20, 100, max_priority_fee_per_gas=5 * 10**9))
    out += [job.rebuild(), block_trace(job.best, job.best_fees), job.rebuild()]
    block = svc.get_payload(pid)
    out += [block_trace(block), job.rebuild(), job.rebuilds]
    assert out[1] is True and out[3] is False and out[5] is False
    return out


class ExplodingPool:
    def __init__(self, err):
        self.err = err

    def best_transactions(self, base_fee=None):
        raise self.err


def sc_job_empty_fallback(P):
    tree, _pool, _w = make_node(P)
    svc = P.PayloadBuilderService(tree, ExplodingPool(RuntimeError("pool exploded")),
                                  deadline=0.1)
    pid = svc.new_payload_job(tree.head_hash, P.PayloadAttributes(timestamp=12))
    block = svc.get_payload(pid)
    assert len(block.transactions) == 0
    return [block_trace(block)]


def sc_builder_evicts_unexecutable(P):
    tree, pool, (alice, bob) = make_node(P)
    a0 = alice.transfer(bob.address, 1)
    a1 = alice.transfer(bob.address, 5 * 10**20)
    a2 = alice.transfer(bob.address, 2)
    for t in (a0, a1, a2):
        add(P, pool, t)
    ext = Wallet(ALICE)
    chain = ChainBuilder({ext.address: Account(balance=10**21),
                          bob.address: Account(balance=10**20)}, committer=REF.committer())
    blk = chain.build_block([ext.transfer(b"\xcc" * 20, 95 * 10**19, gas_limit=21_000)])
    st = tree.on_new_payload(P.block(blk))
    tree.on_forkchoice_updated(blk.hash)
    block, fees = P.build_payload(tree, pool, tree.head_hash, P.PayloadAttributes(timestamp=30))
    out = [st.status.value, block_trace(block, fees), pool.contains(a1.hash),
           pool.contains(a2.hash)]
    assert out[2:] == [False, True] and block.transactions == ()
    return out


# -- builds over the small staged-sync chain ------------------------------------


@pytest.fixture(scope="module")
def sync():
    """The small sync chain, sealed by the reference (3 blocks)."""
    return SyncChain(JAX, n_accounts=60, n_slots=24, seed=47, n_wallets=4, n_blocks=3,
                     sizes=SYNC_BLOCK_SMALL, committer=REF.committer())


@pytest.fixture(scope="module")
def sync_chain(sync):
    return sync.builder


@pytest.fixture(scope="module")
def unexecutable(sync):
    """A transaction the pool admits and no build can execute: the first
    wallet's next nonce after block 1, at a gas limit under the intrinsic
    21,000."""
    w = sync.wallets[0]
    signer = Wallet(w.priv, nonce=sync.senders[1].count(w.address))
    return signer.transfer(b"\x0e" * 20, 1, gas_limit=20_000)


def attrs_of(P, blk, **kw):
    """The payload attributes of a chain block's header: its timestamp,
    randao, fee recipient and withdrawals."""
    h = blk.header
    return P.PayloadAttributes(timestamp=kw.get("timestamp", h.timestamp),
                               prev_randao=h.mix_hash, suggested_fee_recipient=h.beneficiary,
                               withdrawals=tuple(P.block(blk).withdrawals))


def sync_node(P, builder, **tree_kw):
    tree = P.tree(genesis_factory(P, builder), persistence_threshold=2, **tree_kw)
    pool = P.TransactionPool(lambda: tree.overlay_provider(), P.PoolConfig(max_account_slots=64))
    pool.base_fee = 10**9
    return tree, pool


def sc_sync_build(P, builder, mode: str, unexecutable=None):
    """Block 1's transactions pooled over genesis and built by one
    ``build_payload`` (``mode``: serial, parallel, a gas ceiling, an
    unexecutable transaction added, or the empty payload), then imported."""
    tree, pool = sync_node(P, builder, parallel_exec=(mode == "parallel"))
    blk = builder.blocks[1]
    out = []
    for t in blk.transactions:
        add(P, pool, t)
    if mode == "unexecutable":
        # admitted (the pool checks no intrinsic gas), evicted by the build
        out.append(attempt(lambda: add(P, pool, unexecutable)))
    kw = {"gas_ceiling": 10_000_000} if mode == "ceiling" else {}
    block, fees = P.build_payload(tree, None if mode == "empty" else pool, tree.head_hash,
                                  attrs_of(P, blk), **kw)
    if mode == "unexecutable":
        out.append(pool.contains(unexecutable.hash))
        assert out[0][0] == "ok" and out[1] is False
    st = tree.on_new_payload(block)
    out += [block_trace(block, fees), block.header.gas_limit, st.status.value, len(pool),
            block.header.state_root, block.header.receipts_root,
            block.header.transactions_root, block.header.withdrawals_root]
    assert st.status.value == "VALID"
    return out


def sc_sync_mine(P, builder, card_route: bool = False):
    """``LocalMiner`` over four blocks: each of the chain's three blocks'
    transactions pooled and mined at its header's attributes, then one empty
    block; every block imported VALID (the sparse strategy) and the pool
    empty after each."""
    tree, pool = sync_node(P, builder, hot_state=card_route)
    miner = P.LocalMiner(tree, pool)
    out = []
    for blk in builder.blocks[1:]:
        for t in blk.transactions:
            add(P, pool, t)
        parent = tree.overlay_provider().header_by_number(blk.header.number - 1)
        mined = miner.mine_block(timestamp=parent.timestamp + 12)
        out.append((block_trace(mined), mined.header.state_root, len(pool)))
    out.append(block_trace(miner.mine_block()))
    if card_route:
        snap = tree.hot_arena.snapshot()
        assert snap["full_epochs"] + snap["delta_epochs"] > 0 and not snap["faults"]
    assert getattr(tree, "sparse_fallbacks", 0) == 0 and miner.serial_builds == 4
    return out


def sc_sync_job(P, builder):
    """``PayloadJob``'s first build through ``PayloadBuilderService``."""
    tree, pool = sync_node(P, builder)
    for t in builder.blocks[1].transactions:
        add(P, pool, t)
    svc = P.PayloadBuilderService(tree, pool, deadline=5.0, interval=10.0)
    pid = svc.new_payload_job(tree.head_hash, attrs_of(P, builder.blocks[1]))
    first = svc.jobs[pid].best
    block, fees = svc.get_payload_with_fees(pid)
    return [block_trace(first), block_trace(block, fees)]


# -- the continuous producer (tests/test_txflow.py) ------------------------------


def wait_parity(prod, pool, tree, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with prod._lock:
            cand = prod.candidate
            if (cand is not None and cand.window is None
                    and cand.parent_hash == tree.head_hash
                    and cand.pool_seq == pool.event_seq):
                return hashes(cand.selected), cand.parent_hash, cand.attrs
        time.sleep(0.005)
    raise AssertionError(f"producer never reached pool parity: {prod.snapshot()}")


def clone_pool(P, pool):
    clone = P.TransactionPool(pool.state_reader, config=pool.config)
    clone.base_fee = pool.base_fee
    clone.blob_base_fee = pool.blob_base_fee
    with pool._lock:
        for p in sorted(pool.by_hash.values(), key=lambda p: p.submission_id):
            if p.tx.tx_type == 3:
                clone.add_blob_transaction(p.tx, pool.get_blob_sidecar(p.tx.hash))
            else:
                clone.add_transaction(p.tx, sender=p.sender)
    return clone


def serial_selection(P, tree, pool, parent, attrs):
    block, _fees = P.build_payload(tree, clone_pool(P, pool), parent, attrs)
    return hashes(block.transactions)


def sc_producer_randomized(P, seed: int):
    tree, pool, wallets = make_node(P, n_wallets=3)
    prod = P.BlockProducer(tree, pool, interval=0.01)
    prod.start()
    try:
        rng = random.Random(seed)
        miner = P.LocalMiner(tree, pool, producer=prod)
        out = []
        for _rnd in range(3):
            for _ in range(rng.randint(4, 8)):
                w = rng.choice(wallets)
                tip = rng.choice([10**9, 2 * 10**9, 5 * 10**9])
                tx = w.transfer(SINK, rng.randint(1, 10**6), max_priority_fee_per_gas=tip)
                out.append(attempt(lambda: add(P, pool, tx)))
                roll = rng.random()
                if roll < 0.25:
                    repl = w.sign_tx(jtypes.Transaction(
                        tx_type=2, chain_id=1, nonce=tx.nonce,
                        max_fee_per_gas=tx.max_fee_per_gas * 2,
                        max_priority_fee_per_gas=tip * 2,
                        gas_limit=21_000, to=SINK, value=7), bump_nonce=False)
                    out.append(attempt(lambda: add(P, pool, repl)))
                elif roll < 0.40:
                    out.append(attempt(lambda: add(P, pool, tx)))
            got, parent, attrs = wait_parity(prod, pool, tree)
            assert got == serial_selection(P, tree, pool, parent, attrs)
            blk = miner.mine_block()
            assert hashes(blk.transactions) == got
            out.append((got, blk.hash))
        assert miner.producer_seals == 3 and miner.serial_builds == 0
        assert prod.errors == 0
        return out
    finally:
        prod.stop()


def sc_producer_gap_promotion(P):
    tree, pool, wallets = make_node(P, n_wallets=3)
    prod = P.BlockProducer(tree, pool, interval=0.01)
    prod.start()
    try:
        w = wallets[0]
        t0 = w.transfer(SINK, 1)
        w.nonce = 2
        t2 = w.transfer(SINK, 3)
        w.nonce = 1
        t1 = w.transfer(SINK, 2)
        add(P, pool, t0)
        add(P, pool, t2)
        first = wait_parity(prod, pool, tree)[0]
        rebuilds = prod.full_rebuilds
        add(P, pool, t1)
        got, parent, attrs = wait_parity(prod, pool, tree)
        assert first == [t0.hash] and got == [t0.hash, t1.hash, t2.hash]
        assert prod.full_rebuilds == rebuilds
        return [first, got, serial_selection(P, tree, pool, parent, attrs)]
    finally:
        prod.stop()


def sc_producer_replacement_race(P):
    tree, pool, wallets = make_node(P, n_wallets=3)
    prod = P.BlockProducer(tree, pool, interval=0.01)
    prod.start()
    try:
        w = wallets[0]
        base = w.transfer(SINK, 10)
        add(P, pool, base)
        out = [wait_parity(prod, pool, tree)[0]]

        def resigned(factor_num, factor_den, value):
            return w.sign_tx(jtypes.Transaction(
                tx_type=2, chain_id=1, nonce=base.nonce,
                max_fee_per_gas=base.max_fee_per_gas * factor_num // factor_den,
                max_priority_fee_per_gas=base.max_priority_fee_per_gas * factor_num // factor_den,
                gas_limit=21_000, to=SINK, value=value), bump_nonce=False)

        repl = resigned(2, 1, 11)
        out.append(attempt(lambda: add(P, pool, repl)))
        out.append(attempt(lambda: add(P, pool, resigned(105, 100, 12))))
        got, parent, attrs = wait_parity(prod, pool, tree)
        out += [got, serial_selection(P, tree, pool, parent, attrs)]
        blk = P.LocalMiner(tree, pool, producer=prod).mine_block()
        out += [block_trace(blk), attempt(lambda: add(P, pool, resigned(10, 1, 13)))]
        assert got == [repl.hash] and out[-1][2] == "nonce too low"
        return out
    finally:
        prod.stop()


# -- the tests -------------------------------------------------------------------


@pytest.mark.parametrize("scenario", [
    sc_builder_and_miner, sc_service, sc_gas_limit, sc_job_swap, sc_job_empty_fallback,
    sc_builder_evicts_unexecutable, sc_producer_gap_promotion, sc_producer_replacement_race,
], ids=lambda f: f.__name__[3:])
def test_payload_matches_reference(scenario):
    both(scenario)


@pytest.mark.parametrize("seed", [0x7AF10, 1, 2])
def test_producer_matches_serial_greedy_randomized(seed):
    both(sc_producer_randomized, seed)


@pytest.mark.parametrize("mode", ["serial", "parallel", "ceiling", "unexecutable", "empty"])
def test_sync_chain_build_matches_reference(sync_chain, unexecutable, mode):
    both(sc_sync_build, sync_chain, mode, unexecutable)


def test_sync_chain_job_matches_reference(sync_chain):
    both(sc_sync_job, sync_chain)


def test_local_miner_four_blocks_matches_reference(sync_chain):
    both(sc_sync_mine, sync_chain)


def test_local_miner_card_route_matches_reference(sync_chain):
    """The card route on the CPU: the builder's key hashing and ordered roots
    through kernel 1's plain version, the import's hot-state arena through
    kernel 4's; every block the reference's."""
    want = sc_sync_mine(REF, sync_chain)
    assert sc_sync_mine(PORT_CARD, sync_chain, card_route=True) == want


def test_build_stats_name_the_phases(sync_chain):
    tree, pool = sync_node(PORT, sync_chain)
    for t in sync_chain.blocks[1].transactions:
        add(PORT, pool, t)
    stats: dict = {}
    PORT.build_payload(tree, pool, tree.head_hash, attrs_of(PORT, sync_chain.blocks[1]),
                       stats=stats)
    assert sorted(stats) == ["ordered_roots_s", "select_s", "state_root_s"]
    assert all(v >= 0 for v in stats.values())


# -- the departure: no catch-all swallows a kernel fault --------------------------


def kernel_fault(chained: bool = False):
    err = LaunchError("keccak256_absorb: CUDA error 700 at launch")
    if not chained:
        return err
    try:
        raise RuntimeError("the build failed") from err
    except RuntimeError as wrapped:
        return wrapped


def other_fault():
    return ValueError("not a kernel fault")


class StubProducer:
    """A producer whose ``take`` raises ``err``."""

    def __init__(self, err):
        self.err = err
        self.last_stats = {}

    def take(self, *a, **kw):
        raise self.err


def fallbacks(site: str) -> int:
    return producer_metrics.fallbacks.get(site, 0)


def port_node():
    tree, pool, (alice, bob) = make_node(PORT)
    for i in range(5):
        add(PORT, pool, alice.transfer(bob.address, i + 1))
    return tree, pool


def ref_block(site: str) -> bytes:
    """The reference's block for the same node when the site's catch-all
    takes its fallback (built without the failing part)."""
    tree, pool, (alice, bob) = make_node(REF)
    for i in range(5):
        add(REF, pool, alice.transfer(bob.address, i + 1))
    if site == "job_empty":
        return REF.build_payload(tree, None, tree.head_hash,
                                 REF.PayloadAttributes(timestamp=12))[0].hash
    if site == "miner_producer":
        return REF.LocalMiner(tree, pool, producer=StubProducer(ValueError("x"))).mine_block().hash
    return REF.build_payload(tree, pool, tree.head_hash,
                             REF.PayloadAttributes(timestamp=12))[0].hash


def drive_site(site: str, err, monkeypatch):
    """Run the payload path with ``err`` injected at ``site``; returns the
    block it gave (raising whatever raised)."""
    attrs = PORT.PayloadAttributes(timestamp=12)
    if site == "parallel_build":
        tree, pool = port_node()
        tree.parallel_exec = True

        def broken(*_a, **_kw):
            raise err

        monkeypatch.setattr(poptimistic, "execute_candidates_optimistic", broken)
        return PORT.build_payload(tree, pool, tree.head_hash, attrs)[0]
    if site == "job_empty":
        tree, _pool = port_node()
        svc = PORT.PayloadBuilderService(tree, ExplodingPool(err), deadline=0.1)
        return svc.get_payload(svc.new_payload_job(tree.head_hash, attrs))
    if site == "job_producer":
        tree, pool = port_node()
        svc = PORT.PayloadBuilderService(tree, pool, deadline=0.1, producer=StubProducer(err))
        return svc.get_payload(svc.new_payload_job(tree.head_hash, attrs))
    if site == "job_rebuild":
        tree, pool = port_node()
        svc = PORT.PayloadBuilderService(tree, pool, deadline=5.0, interval=10.0)
        job = svc.jobs[svc.new_payload_job(tree.head_hash, attrs)]
        job.pool = ExplodingPool(err)
        job.rebuild()
        return svc.get_payload(next(iter(svc.jobs)))
    if site == "miner_producer":
        tree, pool = port_node()
        return PORT.LocalMiner(tree, pool, producer=StubProducer(err)).mine_block()
    # the producer's own thread and its refresh: the fault (or a first
    # fallback) is awaited, the patch undone, then the candidate sealed
    tree, pool = port_node()
    prod = PORT.BlockProducer(tree, pool, interval=0.01)

    def broken(*_a, **_kw):
        raise err

    target = {"producer_candidate": (prod, "_ensure_locked"),
              "producer_staleness": (producer_metrics, "set_staleness"),
              "producer_refresh_metrics": (producer_metrics, "record_refresh")}[site]
    monkeypatch.setattr(*target, broken)
    before = fallbacks(site)
    prod.start()
    try:
        deadline = time.monotonic() + 10
        while (time.monotonic() < deadline and prod.fault is None
               and fallbacks(site) == before):
            time.sleep(0.01)
        monkeypatch.undo()
        return prod.take(attrs=attrs)[0]
    finally:
        prod.stop()


SITES = ["parallel_build", "job_empty", "job_producer", "job_rebuild", "producer_candidate",
         "producer_staleness", "producer_refresh_metrics", "miner_producer"]


@pytest.mark.parametrize("chained", [False, True], ids=["LaunchError", "on the cause chain"])
@pytest.mark.parametrize("site", SITES)
def test_kernel_fault_raises_out_of_the_catch_all(site, chained, monkeypatch):
    before = sum(producer_metrics.fallbacks.values())
    with pytest.raises(Exception) as info:
        drive_site(site, kernel_fault(chained), monkeypatch)
    assert is_kernel_fault(info.value)
    assert sum(producer_metrics.fallbacks.values()) == before


@pytest.mark.parametrize("site", SITES)
def test_other_fault_keeps_the_reference_fallback(site, monkeypatch):
    before = fallbacks(site)
    block = drive_site(site, other_fault(), monkeypatch)
    assert fallbacks(site) > before
    if site not in ("producer_candidate", "producer_staleness", "producer_refresh_metrics"):
        assert block.hash == ref_block(site)
    else:
        assert len(block.transactions) == 5


def test_payload_job_rebuild_fault_raises_out_of_resolve():
    """A kernel fault in a rebuild on the job's improvement thread ends the
    loop; the payload is not quietly kept: ``get_payload`` raises it."""
    tree, pool = port_node()
    svc = PORT.PayloadBuilderService(tree, pool, deadline=5.0, interval=0.01)
    pid = svc.new_payload_job(tree.head_hash, PORT.PayloadAttributes(timestamp=12))
    job = svc.jobs[pid]
    assert len(job.best.transactions) == 5
    job.pool = ExplodingPool(kernel_fault())
    deadline = time.monotonic() + 10
    while job.fault is None and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(LaunchError):
        svc.get_payload(pid)


def test_launch_error_in_the_ordered_roots_raises_out_of_mine_block(monkeypatch):
    """Kernel 1 failing inside a build (the ordered roots and key hashing of
    the card route): ``mine_block`` raises, never an empty block."""
    from reth_tpu_torch.ops import _build
    from reth_tpu_torch.ops import keccak as ok

    tree, pool, (alice, bob) = make_node(PORT_CARD)
    add(PORT, pool, alice.transfer(bob.address, 1))

    def failing(*_a):
        _build.check_launch(700, "keccak256_absorb")

    monkeypatch.setattr(ok, "keccak256_words_masked", failing)
    head = tree.head_hash
    with pytest.raises(LaunchError):
        PORT.LocalMiner(tree, pool).mine_block()
    with pytest.raises(LaunchError):
        PORT.PayloadBuilderService(tree, pool).new_payload_job(
            head, PORT.PayloadAttributes(timestamp=12))
    assert tree.head_hash == head and len(pool) == 1
