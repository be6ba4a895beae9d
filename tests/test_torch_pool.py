"""The port's transaction pool (pool/pool.py, blobstore.py, batcher.py)
against the JAX package's, on the CPU, tolerance zero.

Every pool case of tests/test_pool_payload.py, test_pool_stress.py and
test_blob_pool.py, and test_txflow.py's event plane, runs as one scenario
on both packages (tests/_torch_block_pkgs.py): the same transactions, signed
by the reference's wallets and carried across by their RLP, the same
genesis; admission results, error classes and messages,
``best_transactions`` orders, discards, contents and events must be equal.
Randomised admission scenarios run at several seeds. KZG cases put each
package's four-point ``dev_setup(4)`` active.
"""

from __future__ import annotations

import random
import threading
import time

import pytest

from _torch_block_pkgs import (
    PORT,
    REF,
    Account,
    ChainBuilder,
    Wallet,
    attempt,
    both,
    genesis_factory,
    hashes,
)
from reth_tpu_torch.ops._build import BuildError
from reth_tpu_torch.pool import batcher as pbatcher

ALICE = 0xA11CE
BOB = 0xB0B
SINK = b"\x0f" * 20


def make_node(P, config=None, alloc=None, pool_base_fee=10**9):
    """A tree and a pool over alice (10**21) and bob (10**20), the reference's
    ``make_node``; returns (tree, pool, alice, bob), the wallets the
    reference's."""
    alice, bob = Wallet(ALICE), Wallet(BOB)
    alloc = alloc or {alice.address: Account(balance=10**21),
                      bob.address: Account(balance=10**20)}
    builder = ChainBuilder(alloc, committer=REF.committer())
    tree = P.tree(genesis_factory(P, builder), persistence_threshold=2)
    args = (config,) if config is not None else ()
    pool = P.TransactionPool(lambda: tree.overlay_provider(), *args)
    pool.base_fee = pool_base_fee
    return tree, pool, alice, bob


def add(P, pool, tx, **kw):
    return attempt(lambda: pool.add_transaction(P.tx(tx), **kw))


def best(pool, base_fee=None):
    return hashes(pool.best_transactions(base_fee))


def content(pool) -> dict:
    return {k: {s: {n: t.hash for n, t in txs.items()} for s, txs in v.items()}
            for k, v in pool.content().items()}


def pooled(pool) -> list:
    return sorted((p.sender, p.nonce, p.tx.hash, p.submission_id, p.cost)
                  for p in pool.by_hash.values())


# -- tests/test_pool_payload.py ----------------------------------------------


def sc_validation(P):
    tree, pool, alice, bob = make_node(P)
    tx = alice.transfer(bob.address, 100)
    out = [add(P, pool, tx), pool.contains(tx.hash), len(pool), add(P, pool, tx)]
    out.append(add(P, pool, Wallet(0xDEAD).transfer(bob.address, 10**18)))
    assert out[3][0] == "err" and "already known" in out[3][2]
    assert "insufficient funds" in out[4][2]
    return out


def sc_nonce_too_low_after_mining(P):
    tree, pool, alice, bob = make_node(P)
    out = [add(P, pool, alice.transfer(bob.address, 1))]
    blk = P.LocalMiner(tree, pool).mine_block()
    out += [blk.hash, add(P, pool, Wallet(ALICE).transfer(bob.address, 2))]
    assert out[-1][2] == "nonce too low"
    return out


def sc_nonce_gap_and_ordering(P):
    tree, pool, alice, bob = make_node(P)
    t0 = alice.transfer(bob.address, 1)
    t1 = alice.transfer(bob.address, 2)
    alice.nonce = 5
    t5 = alice.transfer(bob.address, 3)
    b0 = bob.transfer(alice.address, 1, max_priority_fee_per_gas=5 * 10**9)
    out = [add(P, pool, t) for t in (t1, t5, b0, t0)]
    out += [best(pool, 10**9), content(pool)]
    assert out[4] == [b0.hash, t0.hash, t1.hash]
    assert t5.hash in out[5]["queued"][alice.address].values()
    return out


def sc_replacement_rules(P):
    tree, pool, alice, bob = make_node(P)
    t0 = alice.transfer(bob.address, 1)
    out = [add(P, pool, t0)]
    alice.nonce = 0
    out.append(add(P, pool, alice.transfer(bob.address, 2)))
    alice.nonce = 0
    bumped = alice.transfer(bob.address, 2, max_fee_per_gas=200 * 10**9)
    out += [add(P, pool, bumped), pool.contains(t0.hash), pool.contains(bumped.hash)]
    assert out[1][2] == "replacement underpriced" and out[3:] == [False, True]
    return out


def sc_wrong_chain_id(P):
    tree, _pool, alice, bob = make_node(P)
    pool = P.TransactionPool(lambda: tree.overlay_provider(), P.PoolConfig(chain_id=1))
    pool.base_fee = 10**9
    out = [add(P, pool, alice.transfer(bob.address, 1, chain_id=5))]
    legacy = alice.sign_tx(REF.types.Transaction(
        tx_type=0, chain_id=None, nonce=alice.nonce - 1, gas_price=10**10,
        gas_limit=21_000, to=bob.address, value=7))
    out.append(add(P, pool, legacy))
    assert out[0][2] == "wrong chain id 5 (expected 1)" and out[1][0] == "ok"
    return out


def sc_remove_invalid(P):
    tree, pool, alice, bob = make_node(P)
    h0 = add(P, pool, alice.transfer(bob.address, 1))[1]
    h1 = add(P, pool, alice.transfer(bob.address, 2))[1]
    pool.remove_invalid(h0)
    out = [pool.contains(h0), pool.contains(h1), sorted(pool.by_sender[alice.address])]
    pool.remove_invalid(b"\x99" * 32)
    out += [len(pool), best(pool, 10**9)]
    assert out == [False, True, [1], 1, []]
    return out


def sc_remove_invalid_mid_best(P):
    tree, pool, alice, bob = make_node(P)
    txs = [alice.transfer(bob.address, i + 1) for i in range(3)]
    for t in txs:
        add(P, pool, t)
    it = pool.best_transactions(10**9)
    first = next(it).hash
    pool.remove_invalid(txs[1].hash)
    out = [first, hashes(it), pool.contains(txs[2].hash)]
    assert out == [txs[0].hash, [], True]
    return out


# -- tests/test_pool_stress.py ------------------------------------------------


def stress_pool(P, n_senders: int, max_pool: int):
    wallets = [Wallet(0x50000 + i) for i in range(n_senders)]
    builder = ChainBuilder({w.address: Account(balance=10**20) for w in wallets},
                           committer=REF.committer())
    tree = P.tree(genesis_factory(P, builder))
    pool = P.TransactionPool(lambda: tree.overlay_provider(),
                             P.PoolConfig(max_pool_size=max_pool, max_account_slots=64))
    pool.base_fee = 10**9
    return wallets, pool


def tip_tx(w, tip_gwei: int):
    return w.transfer(b"\x99" * 20, 1, max_fee_per_gas=1000 * 10**9,
                      max_priority_fee_per_gas=tip_gwei * 10**9)


def sc_saturated_discards_worst(P, txs):
    _wallets, pool = stress_pool(P, 300, max_pool=100)
    out = [add(P, pool, t) for t in txs[:100]]
    out.append(add(P, pool, txs[100]))
    for t in txs[101:]:
        out.append(add(P, pool, t))
        assert len(pool) <= 100
    tips = sorted(p.effective_tip(pool.base_fee) // 10**9 for p in pool.by_hash.values())
    out += [len(pool), tips, pooled(pool)]
    assert "underpriced" in out[100][2] and all(t >= 250 for t in tips)
    return out


@pytest.fixture(scope="module")
def saturated_txs():
    """tests/test_pool_stress.py's saturated-pool inputs: 100 txs at tips
    1..100 gwei, one at 0 gwei, then 150 at 200..349 gwei, one sender each."""
    wallets = [Wallet(0x50000 + i) for i in range(300)]
    return ([tip_tx(wallets[i], 1 + i) for i in range(100)] + [tip_tx(wallets[200], 0)]
            + [tip_tx(wallets[100 + i], 200 + i) for i in range(150)])


def sc_discard_drops_descendants(P):
    wallets, pool = stress_pool(P, 10, max_pool=4)
    victim = wallets[0]
    out = [add(P, pool, t) for t in (tip_tx(victim, 1), tip_tx(victim, 300),
                                     tip_tx(wallets[1], 5), tip_tx(wallets[2], 5),
                                     tip_tx(wallets[3], 50))]
    out += [victim.address in pool.by_sender, len(pool), pooled(pool)]
    assert out[5:7] == [False, 3]
    return out


def sc_discard_same_sender_visible(P):
    wallets, pool = stress_pool(P, 4, max_pool=3)
    s = wallets[0]
    out = [add(P, pool, t) for t in (tip_tx(s, 1), tip_tx(wallets[1], 5),
                                     tip_tx(wallets[2], 5), tip_tx(s, 500))]
    h = out[-1][1]
    out += [pool.contains(h), s.address in pool.by_sender, pool.by_sender[s.address][1].tx.hash,
            pooled(pool)]
    assert out[4:7] == [True, True, h]
    return out


def sc_batcher_concurrent(P):
    """Eight threads submit through the batcher: every future resolves, the
    pool holds the valid set (the order of admission depends on the threads,
    so the trace is the set and the counts)."""
    wallets, pool = stress_pool(P, 40, max_pool=10_000)
    batcher = P.TxBatcher(pool, max_batch=64)
    txs = [P.tx(w.transfer(b"\x88" * 20, 1 + n)) for w in wallets for n in range(3)]
    futures, lock = [], threading.Lock()

    def submit(chunk):
        for t in chunk:
            f = batcher.submit(t)
            with lock:
                futures.append(f)

    threads = [threading.Thread(target=submit, args=(txs[i::8],)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    results = sorted(f.result(timeout=30) for f in futures)
    out = [results, len(pool), batcher.processed, batcher.batches < len(txs)]
    batcher.close()
    assert out[1:] == [120, 120, True]
    return out


def sc_batcher_rejects_invalid(P):
    wallets, pool = stress_pool(P, 3, max_pool=100)
    batcher = P.TxBatcher(pool, max_batch=16)
    good1, signed, good2 = tip_tx(wallets[0], 2), tip_tx(wallets[1], 2), tip_tx(wallets[2], 2)
    bad = P.types.Transaction(**{**P.tx(signed).__dict__, "r": 0})
    futs = [batcher.submit(P.tx(good1)), batcher.submit(bad), batcher.submit(P.tx(good2))]
    out = [attempt(lambda f=f: f.result(30)) for f in futs] + [len(pool)]
    batcher.close()
    assert out[1] == ("err", "PoolError", "invalid signature: recovery failed")
    return out


# -- tests/test_txflow.py: the event plane and the batcher's sheds -------------


def sc_event_plane(P):
    tree, pool, alice, _bob = make_node(P)
    events = []
    pool.add_listener(events.append)
    t0 = alice.transfer(SINK, 1)
    add(P, pool, t0)
    alice.nonce = 0
    repl = alice.transfer(SINK, 2, max_fee_per_gas=200 * 10**9,
                          max_priority_fee_per_gas=2 * 10**9)
    add(P, pool, repl)
    t1 = alice.transfer(SINK, 3)
    add(P, pool, t1)
    pool.remove_invalid(t1.hash)
    pool.on_canonical_state_change(2 * 10**9)
    pool.remove_listener(events.append)
    out = [{k: (v.hash if hasattr(v, "hash") else v) for k, v in e.items()} for e in events]
    assert [e["kind"] for e in out] == ["add", "replace", "add", "drop", "canon"]
    assert out[1]["old_hash"] == t0.hash and out[3]["reason"] == "invalid"
    return out


def sc_batcher_sheds(P):
    tree, pool, alice, _bob = make_node(P)
    batcher = P.TxBatcher(pool, max_batch=1, max_queue=4, retry_after_s=0.25)
    futs, shed = [], None
    txs = [P.tx(alice.transfer(SINK, i + 1)) for i in range(8)]
    try:
        with pool._lock:  # wedge the insert worker mid-batch
            for t in txs:
                f = batcher.submit(t)
                futs.append(f)
                if f.done():  # only sheds fail synchronously
                    shed = f
                    break
                time.sleep(0.005)
            assert shed is not None, "queue never saturated"
            err = shed.exception()
            out = [type(err).__name__, str(err), err.retry_after_s,
                   isinstance(err, P.PoolError), batcher.sheds >= 1]
        # how many got in before the shed depends on the worker's timing
        out.append(all(isinstance(f.result(timeout=10), bytes) for f in futs[:-1]))
        out.append(batcher.processed == len(futs) - 1)
    finally:
        batcher.close()
    assert out[0] == "PoolOverloaded" and out[2:5] == [0.25, True, True]
    return out


# -- tests/test_blob_pool.py ---------------------------------------------------


@pytest.fixture(scope="module")
def kzg4():
    """Each package's four-point dev setup active (a mini blob of 4 field
    elements), the earlier setups put back after."""
    saved = (REF.kzg._active_setup, PORT.kzg._active_setup)
    REF.kzg._active_setup, PORT.kzg._active_setup = REF.kzg.dev_setup(4), PORT.kzg.dev_setup(4)
    yield
    REF.kzg._active_setup, PORT.kzg._active_setup = saved


def mini_blob(P, seed: int) -> bytes:
    n = P.kzg.active_blob_size()
    return b"".join(((seed * 1000 + i) % P.kzg.BLS_MODULUS).to_bytes(32, "big")
                    for i in range(n))


_SIDECARS: dict = {}


def make_sidecar(P, n_blobs=1, seed=1):
    """A sidecar of ``n_blobs`` mini blobs made by P's KZG, once per package
    and shape (the dev setup is deterministic)."""
    key = (P.name, n_blobs, seed)
    if key not in _SIDECARS:
        _SIDECARS[key] = _make_sidecar(P, n_blobs, seed)
    return _SIDECARS[key]


def _make_sidecar(P, n_blobs, seed):
    blobs, commitments, proofs = [], [], []
    for i in range(n_blobs):
        blob = mini_blob(P, seed + i)
        c = P.kzg.blob_to_kzg_commitment(blob)
        blobs.append(blob)
        commitments.append(c)
        proofs.append(P.kzg.compute_blob_kzg_proof(blob, c))
    return P.BlobSidecar(tuple(blobs), tuple(commitments), tuple(proofs))


def sidecar_fields(sc) -> tuple:
    return (sc.blobs, sc.commitments, sc.proofs) if sc is not None else None


def sc_blob_math(P):
    sc = make_sidecar(P, 2)
    blob, c, p = sc.blobs[0], sc.commitments[0], sc.proofs[0]
    bad = bytearray(blob)
    bad[40] ^= 1
    out = [sidecar_fields(sc), P.kzg.verify_blob_kzg_proof(blob, c, p),
           P.kzg.verify_blob_kzg_proof(bytes(bad), c, p),
           P.kzg.verify_blob_kzg_proof(blob, sc.commitments[1], p),
           sc.versioned_hashes(), attempt(lambda: sc.validate(sc.versioned_hashes())),
           attempt(lambda: sc.validate(tuple(reversed(sc.versioned_hashes())))),
           sc.encode(), P.BlobSidecar.decode(sc.encode()) == sc]
    assert out[1:4] == [True, False, False] and out[-1] is True
    assert out[6] == ("err", "BlobStoreError", "versioned hashes do not match commitments")
    return out


def sc_blob_stores(P, tmp):
    sc = make_sidecar(P, 2)
    store = P.DiskBlobStore(tmp)
    store.insert(b"\x01" * 32, sc)
    cold = P.DiskBlobStore(tmp)
    out = [sidecar_fields(cold.get(b"\x01" * 32)), cold.get(b"\x02" * 32)]
    vh = sc.versioned_hashes()
    out.append(cold.by_versioned_hashes([vh[1], b"\x01" + b"\x00" * 31, vh[0]]))
    cold.delete(b"\x01" * 32)
    out.append(P.DiskBlobStore(tmp).get(b"\x01" * 32))
    mem = P.InMemoryBlobStore()
    mem.insert(b"\x01" * 32, sc)
    out += [mem.by_versioned_hashes([vh[1], b"\x02" * 32, vh[0]]), len(mem)]
    assert out[3] is None and out[2][1] is None
    return out


class _State:
    def __init__(self, accounts):
        self._a = accounts

    def account(self, addr):
        return self._a.get(addr)


def blob_tx(P, wallet, sidecar, nonce=0, max_blob_fee=100):
    return wallet.sign_tx(REF.types.Transaction(
        tx_type=3, chain_id=1, nonce=nonce, max_fee_per_gas=10**10,
        max_priority_fee_per_gas=10**9, gas_limit=21_000, to=b"\x20" * 20,
        max_fee_per_blob_gas=max_blob_fee, blob_versioned_hashes=sidecar.versioned_hashes(),
    ), bump_nonce=False)


def blob_pool(P, *wallets):
    accounts = {w.address: P.types.Account(balance=10**21) for w in wallets}
    pool = P.TransactionPool(lambda: _State(accounts))
    pool.base_fee = 10**9
    return pool, accounts


def sc_blob_pool(P):
    w = Wallet(0xB10B)
    sc = make_sidecar(P, 2)
    pool, _ = blob_pool(P, w)
    tx = P.tx(blob_tx(P, w, sc))
    out = [attempt(lambda: pool.add_transaction(tx))]
    bad = P.BlobSidecar(sc.blobs, tuple(reversed(sc.commitments)), sc.proofs)
    out.append(attempt(lambda: pool.add_blob_transaction(tx, bad)))
    out.append(attempt(lambda: pool.add_blob_transaction(tx, sc)))
    out += [sidecar_fields(pool.get_blob_sidecar(tx.hash)), best(pool)]
    assert out[0][2] == "blob tx requires a sidecar (add_blob_transaction)"
    assert out[1][2].startswith("invalid blob sidecar") and out[-1] == [tx.hash]
    return out


def sc_blob_fee_market(P):
    w = Wallet(0xB10B)
    sc = make_sidecar(P, 2)
    pool, _ = blob_pool(P, w)
    h = pool.add_blob_transaction(P.tx(blob_tx(P, w, sc, max_blob_fee=5)), sc)
    pool.on_canonical_state_change(10**9, blob_base_fee=50)
    out = [best(pool)]
    pool.on_canonical_state_change(10**9, blob_base_fee=3)
    out.append(best(pool))
    assert out == [[], [h]]
    return out


def sc_mined_sidecar_retention(P):
    w1, w2 = Wallet(0xB10B), Wallet(0xB20B)
    sc = make_sidecar(P, 2)
    pool, accounts = blob_pool(P, w1, w2)
    pool.mined_sidecar_retention = 1
    h1 = pool.add_blob_transaction(P.tx(blob_tx(P, w1, sc)), sc)
    h2 = pool.add_blob_transaction(P.tx(blob_tx(P, w2, sc)), sc)
    for w in (w1, w2):
        accounts[w.address] = P.types.Account(nonce=1, balance=10**21)
    pool.on_canonical_state_change(10**9)
    out = [pool.contains(h1), pool.contains(h2),
           [h for h in (h1, h2) if pool.get_blob_sidecar(h) is not None]]
    assert out[:2] == [False, False] and len(out[2]) == 1
    return out


# -- randomised admission ------------------------------------------------------


def sc_random(P, seed: int):
    """A seeded mix on a small pool (max 12, 4 slots a sender): fresh nonces,
    gaps, duplicates, replacements above and below the bump, foreign chains,
    underfunded senders, evictions, ``remove_invalid`` and fee-market moves;
    every outcome, every event, ``best_transactions`` at three base fees and
    the pool's contents, after each step."""
    rng = random.Random(seed)
    wallets = [Wallet(0x60000 + i) for i in range(6)]
    alloc = {w.address: Account(balance=10**18 if i < 5 else 10**15)
             for i, w in enumerate(wallets)}
    tree, pool, _a, _b = make_node(P, P.PoolConfig(max_pool_size=12, max_account_slots=4,
                                                   chain_id=1), alloc=alloc)
    events = []
    pool.add_listener(lambda e: events.append(
        {k: (v.hash if hasattr(v, "hash") else v) for k, v in e.items()}))
    out = []
    sent: list = []  # (wallet, tx)
    for step in range(40):
        roll = rng.random()
        w = rng.choice(wallets)
        tip = rng.choice([1, 2, 3, 5, 8]) * 10**9
        if roll < 0.55:
            w.nonce = rng.choice([w.nonce, w.nonce, w.nonce + 1, max(0, w.nonce - 1)])
            tx = w.transfer(SINK, rng.randint(1, 10**6), max_fee_per_gas=tip + 40 * 10**9,
                            max_priority_fee_per_gas=tip,
                            chain_id=1 if rng.random() < 0.9 else 7)
            sent.append((w, tx))
            out.append(("add", add(P, pool, tx)))
        elif roll < 0.7 and sent:
            owner, old = sent[rng.randrange(len(sent))]
            factor = rng.choice([105, 110, 200])
            repl = Wallet(owner.priv, nonce=old.nonce)
            tx = repl.transfer(SINK, 3, max_fee_per_gas=old.max_fee_per_gas * factor // 100,
                               max_priority_fee_per_gas=old.max_priority_fee_per_gas
                               * factor // 100)
            out.append(("replace", add(P, pool, tx)))
        elif roll < 0.8 and sent:
            out.append(("dup", add(P, pool, sent[rng.randrange(len(sent))][1])))
        elif roll < 0.9 and len(pool):
            victim = sorted(pool.by_hash)[rng.randrange(len(pool))]
            pool.remove_invalid(victim)
            out.append(("remove", victim))
        else:
            fee = rng.choice([10**9, 5 * 10**9, 30 * 10**9])
            pool.on_canonical_state_change(fee)
            out.append(("canon", fee))
        out.append(best(pool))
    out += [events, content(pool), pooled(pool), pool.event_seq,
            [best(pool, f) for f in (0, 10**9, 20 * 10**9)]]
    return out


# -- the departure: a kernel fault in the batcher's native recovery -------------


def test_batcher_kernel_fault_fails_futures_with_the_fault(monkeypatch):
    """A failed build of the native recovery batch is no malformed
    transaction: every future of the batch fails with the BuildError itself,
    where the reference falls back to per-transaction "invalid signature"."""
    _wallets, pool = stress_pool(PORT, 2, max_pool=100)

    def broken(_txs):
        raise BuildError("secp256k1.cpp: g++ failed")

    monkeypatch.setattr(pbatcher, "recover_senders", broken)
    batcher = PORT.TxBatcher(pool, max_batch=16)
    try:
        futs = [batcher.submit(PORT.tx(tip_tx(Wallet(0x50000 + i), 2))) for i in range(2)]
        for f in futs:
            with pytest.raises(BuildError, match="g\\+\\+ failed"):
                f.result(30)
    finally:
        batcher.close()
    assert len(pool) == 0


def test_batcher_other_recovery_failure_falls_back(monkeypatch):
    """Any other failure of the batch keeps the reference's fallback: each
    transaction fails as an unrecoverable signature."""
    _wallets, pool = stress_pool(PORT, 2, max_pool=100)

    def broken(_txs):
        raise ValueError("malformed batch")

    monkeypatch.setattr(pbatcher, "recover_senders", broken)
    batcher = PORT.TxBatcher(pool, max_batch=16)
    try:
        f = batcher.submit(PORT.tx(tip_tx(Wallet(0x50000), 2)))
        with pytest.raises(PORT.PoolError, match="invalid signature: recovery failed"):
            f.result(30)
    finally:
        batcher.close()


# -- the tests -------------------------------------------------------------------


@pytest.mark.parametrize("scenario", [
    sc_validation, sc_nonce_too_low_after_mining, sc_nonce_gap_and_ordering,
    sc_replacement_rules, sc_wrong_chain_id, sc_remove_invalid, sc_remove_invalid_mid_best,
    sc_discard_drops_descendants, sc_discard_same_sender_visible, sc_batcher_concurrent,
    sc_batcher_rejects_invalid, sc_event_plane, sc_batcher_sheds,
], ids=lambda f: f.__name__[3:])
def test_pool_matches_reference(scenario):
    both(scenario)


def test_saturated_pool_matches_reference(saturated_txs):
    both(sc_saturated_discards_worst, saturated_txs)


@pytest.mark.parametrize("scenario", [sc_blob_math, sc_blob_pool, sc_blob_fee_market,
                                      sc_mined_sidecar_retention],
                         ids=lambda f: f.__name__[3:])
def test_blob_pool_matches_reference(kzg4, scenario):
    both(scenario)


def test_blob_stores_match_reference(kzg4, tmp_path):
    want = sc_blob_stores(REF, tmp_path / "ref")
    assert sc_blob_stores(PORT, tmp_path / "port") == want


@pytest.mark.parametrize("seed", range(8))
def test_random_admission_matches_reference(seed):
    both(sc_random, seed)
