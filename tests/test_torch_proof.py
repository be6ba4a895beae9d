"""The port's proofs (reth_tpu_torch/trie/proof.py) against the JAX
package's, on the CPU.

Both packages' MemDb hold one seeded state (tests/_torch_helpers.py
``stage_pair``: 2,000 accounts, 800 slots over 200 owners, each package's
hashing stages and numpy rebuild). The reference proves on
``TrieCommitter(hasher=keccak256_batch_np)``, the port on
``TrieCommitter(device="cpu")`` (kernel 1's plain version through
``KeccakDevice``) unless a test says otherwise. Tolerance zero: every proof
node, value and root is the same bytes.
"""

from __future__ import annotations

import numpy as np
import pytest

from _torch_helpers import stage_pair
from reth_tpu.primitives.keccak import keccak256_batch_np as jhash
from reth_tpu.storage import kv as jkv
from reth_tpu.storage import provider as jprov
from reth_tpu.trie import committer as jcommitter
from reth_tpu.trie import incremental as jinc
from reth_tpu.trie import proof as jproof
from reth_tpu_torch import metrics as pmetrics
from reth_tpu_torch.ops import hash_service as phs
from reth_tpu_torch.primitives.keccak import keccak256
from reth_tpu_torch.primitives.keccak import keccak256_batch_np as phash
from reth_tpu_torch.primitives.nibbles import unpack_nibbles
from reth_tpu_torch.storage import kv as pkv
from reth_tpu_torch.storage import provider as pprov
from reth_tpu_torch.trie import committer as pcommitter
from reth_tpu_torch.trie import incremental as pinc
from reth_tpu_torch.trie import proof as pproof
from reth_tpu_torch.trie import sparse as psparse

N_ACCOUNTS, N_SLOTS, SEED = 2000, 800, 5


@pytest.fixture(scope="module")
def dbs():
    """(reference StageDb, port StageDb, plain accounts, plain storages)."""
    from _torch_helpers import stage_state
    from reth_tpu_torch.primitives.types import Account

    ref, port, _ = stage_pair(N_ACCOUNTS, N_SLOTS, SEED)
    accounts, storages = stage_state(Account, N_ACCOUNTS, N_SLOTS, SEED)
    return ref, port, accounts, storages


def ref_calc(ref):
    return jproof.ProofCalculator(ref.factory.provider(), jcommitter.TrieCommitter(hasher=jhash))


def port_calc(port, committer=None):
    return pproof.ProofCalculator(port.factory.provider(),
                                  committer or pcommitter.TrieCommitter(device="cpu"))


def fields(ap) -> tuple:
    """An AccountProof of either package as plain values."""
    acc = None if ap.account is None else (ap.account.nonce, ap.account.balance,
                                           ap.account.storage_root, ap.account.code_hash)
    return (ap.address, acc, list(ap.proof), ap.storage_root,
            [(sp.key, sp.value, list(sp.proof)) for sp in ap.storage_proofs])


def same_proofs(got: dict, want: dict, ordered: bool = True) -> None:
    assert list(got) == list(want) if ordered else sorted(got) == sorted(want)
    for a in want:
        assert fields(got[a]) == fields(want[a]), a.hex()


def absent_slot(rng) -> bytes:
    return bytes(rng.integers(0, 256, size=32, dtype=np.uint8))


def targets_of(case: str, accounts: dict, storages: dict) -> dict:
    """The multiproof targets of one case."""
    rng = np.random.default_rng(11)
    owners = list(storages)
    plain = [a for a in accounts if a not in storages]
    absent = [bytes(rng.integers(0, 256, size=20, dtype=np.uint8)) for _ in range(4)]
    if case == "existing":
        return {plain[3]: []}
    if case == "absent":
        return {absent[0]: [absent_slot(rng)]}
    if case == "storage-less":
        return {plain[7]: [absent_slot(rng), absent_slot(rng)]}
    if case == "slots":
        o = owners[5]
        return {o: sorted(storages[o])[:3] + [absent_slot(rng)]}
    # many: existing, absent, owners with every slot and an absent one
    out = {a: [] for a in plain[:40]}
    out.update({a: [] for a in absent})
    for o in owners[:12]:
        out[o] = list(storages[o]) + [absent_slot(rng)]
    return out


@pytest.mark.parametrize("case", ["existing", "absent", "storage-less", "slots", "many"])
def test_multiproof_equals_reference(dbs, case):
    """account_proof / multiproof over existing, absent and storage-less
    accounts, present and absent slots: every AccountProof equal to the
    reference's field by field, and each verifies against the root."""
    ref, port, accounts, storages = dbs
    targets = targets_of(case, accounts, storages)
    if len(targets) == 1:
        (a, slots), = targets.items()
        got = {a: port_calc(port).account_proof(a, slots)}
        want = {a: ref_calc(ref).account_proof(a, slots)}
    else:
        got = port_calc(port).multiproof(targets)
        want = ref_calc(ref).multiproof(targets)
    same_proofs(got, want)
    root = port.roots[1]
    for a, ap in got.items():
        assert pproof.verify_account_proof(root, a, ap)
        assert (ap.account is None) == (a not in accounts)
        for sp in ap.storage_proofs:
            assert sp.value == storages.get(a, {}).get(sp.key, 0)
            assert pproof.verify_storage_proof(ap.storage_root, sp)


def test_proof_on_empty_state():
    """An empty database: the empty root, an absent account, the same
    (empty) proof as the reference's, and it verifies."""
    out = []
    for kv, prov, inc, proof, committer in (
            (jkv, jprov, jinc, jproof, jcommitter.TrieCommitter(hasher=jhash)),
            (pkv, pprov, pinc, pproof, pcommitter.TrieCommitter(device="cpu"))):
        factory = prov.ProviderFactory(kv.MemDb())
        with factory.provider_rw() as p:
            root = inc.full_state_root(p, committer)
        with factory.provider() as p:
            ap = proof.ProofCalculator(p, committer).account_proof(b"\x01" * 20, [b"\x02" * 32])
        out.append((root, fields(ap)))
        assert proof.verify_account_proof(root, b"\x01" * 20, ap)
    assert out[0] == out[1]
    assert out[1][1][1] is None


@pytest.mark.parametrize("length", [0, 1, 7, 64])
def test_spines_equal_reference(dbs, length):
    """spine_for_path and storage_spine_for_path through paths of 0, 1, 7
    and 64 nibbles (random ones, and prefixes of an account's and a slot's
    keys): the reference's node lists, the root node first."""
    ref, port, accounts, storages = dbs
    rng = np.random.default_rng(length)
    owner = max(storages, key=lambda a: len(storages[a]))
    howner = keccak256(owner)
    got, want = port_calc(port), ref_calc(ref)
    for path in (bytes(rng.integers(0, 16, size=length, dtype=np.uint8)),
                 unpack_nibbles(keccak256(list(accounts)[9]))[:length]):
        spine = got.spine_for_path(path)
        assert spine == want.spine_for_path(path)
        assert keccak256(spine[0]) == port.roots[1]
    for path in (bytes(rng.integers(0, 16, size=length, dtype=np.uint8)),
                 unpack_nibbles(keccak256(min(storages[owner])))[:length]):
        assert got.storage_spine_for_path(howner, path) == \
            want.storage_spine_for_path(howner, path)


def test_verify_rejects_tampering(dbs):
    """verify_* is True on the port's proofs, False with one byte of a node
    flipped, with a wrong account field, and against another root."""
    _, port, accounts, storages = dbs
    owner = list(storages)[2]
    slot = sorted(storages[owner])[0]
    ap = port_calc(port).account_proof(owner, [slot])
    root = port.roots[1]
    sp = ap.storage_proofs[0]
    assert pproof.verify_account_proof(root, owner, ap)
    assert pproof.verify_storage_proof(ap.storage_root, sp)
    for i in range(len(ap.proof)):
        bad = bytearray(ap.proof[i])
        bad[len(bad) // 2] ^= 1
        tampered = pproof.AccountProof(ap.address, ap.account,
                                       ap.proof[:i] + [bytes(bad)] + ap.proof[i + 1:],
                                       ap.storage_root)
        assert not pproof.verify_account_proof(root, owner, tampered)
    bad = bytearray(sp.proof[-1])
    bad[-1] ^= 1
    assert not pproof.verify_storage_proof(
        ap.storage_root, pproof.StorageProof(sp.key, sp.value, sp.proof[:-1] + [bytes(bad)]))
    assert not pproof.verify_storage_proof(ap.storage_root,
                                           pproof.StorageProof(sp.key, sp.value + 1, sp.proof))
    wrong = pproof.AccountProof(ap.address, ap.account.with_(balance=ap.account.balance + 1),
                                ap.proof, ap.storage_root)
    assert not pproof.verify_account_proof(root, owner, wrong)
    assert not pproof.verify_account_proof(b"\x13" * 32, owner, ap)
    assert not pproof.verify_storage_proof(b"\x13" * 32, sp)


@pytest.mark.parametrize("workers", [1, 4])
def test_worker_pool_equals_calculator(dbs, workers):
    """ProofWorkerPool.multiproof at 1 and 4 workers, with one account of
    200 slots (split above SLOT_SPLIT_MIN, the order restored): the port's
    ProofCalculator's proofs, and the reference pool's shards and proofs."""
    ref, port, accounts, storages = dbs
    rng = np.random.default_rng(workers)
    owner = list(storages)[0]
    big = list(storages[owner]) + [absent_slot(rng) for _ in range(200 - len(storages[owner]))]
    targets = targets_of("many", accounts, storages)
    targets[owner] = big
    pool = pproof.ProofWorkerPool(lambda: port_calc(port, pcommitter.TrieCommitter(
        hasher=phash, device="cpu")), workers=workers)
    ref_pool = jproof.ProofWorkerPool(lambda: ref_calc(ref), workers=workers)
    try:
        got = pool.multiproof(targets)
        want = ref_pool.multiproof(targets)
    finally:
        pool.shutdown()
        ref_pool.shutdown()
    assert pool._shards(targets) == ref_pool._shards(targets)
    assert (pool.fetches, pool.shards_total) == (ref_pool.fetches, ref_pool.shards_total)
    assert (len(pool._shards(targets)) > 1) == (workers > 1)
    same_proofs(got, want)
    # the pool merges its shards in their order, the calculator keeps the request's
    same_proofs(got, port_calc(port).multiproof(targets), ordered=False)
    assert [sp.key for sp in got[owner].storage_proofs] == big


def test_proof_lane_through_hash_service(dbs):
    """A committer behind the port's HashService: ProofCalculator hashes on
    the proof lane (for_lane("proof")), whose counter moves while the live
    lane's does not; the proofs are the reference's."""
    ref, port, accounts, storages = dbs
    svc = phs.HashService(backend=phash, registry=pmetrics.MetricsRegistry(), device="cpu")
    try:
        committer = pcommitter.TrieCommitter(hasher=phash, device="cpu")
        committer.hash_service = svc
        committer.hasher = svc.client("live")
        calc = port_calc(port, committer)
        assert calc.committer is not committer and calc.committer.hasher.lane == "proof"
        targets = targets_of("many", accounts, storages)
        got = calc.multiproof(targets)
        msgs = {lane: svc.metrics._msgs[lane].value for lane in ("live", "proof")}
    finally:
        svc.stop()
    assert msgs["proof"] > 0 and msgs["live"] == 0
    same_proofs(got, ref_calc(ref).multiproof(targets))


def test_proof_wedge_fires_on_the_reference_fetch(dbs, monkeypatch):
    """RETH_TPU_FAULT_SPARSE_PROOF_WEDGE=2 over four shards: the second and
    fourth fetch raise in both packages, with the reference's messages, and
    the other shards' proofs are the reference's."""
    ref, port, accounts, storages = dbs
    monkeypatch.setenv("RETH_TPU_FAULT_SPARSE_PROOF_WEDGE", "2")
    targets = targets_of("many", accounts, storages)
    runs = []
    for pool in (jproof.ProofWorkerPool(lambda: ref_calc(ref), workers=4),
                 pproof.ProofWorkerPool(lambda: port_calc(port, pcommitter.TrieCommitter(
                     hasher=phash, device="cpu")), workers=4)):
        errors, proofs = set(), {}
        try:
            for fut, _shard in pool.submit(targets):
                try:
                    proofs.update(fut.result(timeout=120)[0])
                except RuntimeError as e:
                    errors.add(str(e))
        finally:
            pool.shutdown()
        runs.append((errors, pool.injector.wedges, pool.injector.proof_fetches, proofs))
    (errors, wedges, fetches, want), (got_errors, *got_counts, got) = runs
    assert (got_errors, *got_counts) == (errors, wedges, fetches)
    assert wedges == 2 and fetches == 4
    assert errors == {f"injected sparse proof wedge on fetch #{n} "
                      f"(RETH_TPU_FAULT_SPARSE_PROOF_WEDGE=2)" for n in (2, 4)}
    assert set(got) == set(want)
    for a in want:
        assert fields(got[a]) == fields(want[a])
    assert psparse.SparseFaultInjector.from_env().proof_wedge_every == 2
