"""The port's sparse live-tip finish (reth_tpu_torch/trie/sparse.py) against
the JAX package's trie/sparse.py under JAX_PLATFORMS=cpu. Inputs come from
numpy seeds; tolerance zero: roots, digests and stored branch nodes are
equal byte for byte, the commit stats equal as integers. The port runs on
device="cpu" (kernels 1 and 4 through their plain versions) or with the
numpy hasher; the reference's fused finish runs its JAX engine on the CPU
with the padding floors at 64, as its own tests set them."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_helpers import branches, sparse_block, sparse_state
from reth_tpu.primitives import Account
from reth_tpu.primitives.keccak import keccak256 as jkeccak256
from reth_tpu.primitives.keccak import keccak256_batch_np as jhash
from reth_tpu.storage import MemDb, ProviderFactory
from reth_tpu.storage.tables import encode_account
from reth_tpu.trie import TrieCommitter as JaxTrieCommitter
from reth_tpu.trie import sparse as js
from reth_tpu.trie.incremental import full_state_root
from reth_tpu.trie.proof import ProofCalculator
from reth_tpu_torch.primitives.keccak import keccak256_batch_np as phash
from reth_tpu_torch.primitives.nibbles import unpack_nibbles
from reth_tpu_torch.trie import sparse as ts

STATS = ("tries", "levels", "dispatches", "hashed", "encode_chunks", "pooled_levels")


def _committers(k=0, workers=None, split_depth=None, injector=None):
    jc = js.ParallelSparseCommitter(workers=workers, split_depth=split_depth,
                                    subtrie_levels=k, injector=injector)
    jc.SUBTRIE_ROW_FLOOR = 64
    jc.SUBTRIE_HOLE_FLOOR = 64
    pc = ts.ParallelSparseCommitter(workers=workers, split_depth=split_depth,
                                    subtrie_levels=k, device="cpu", injector=injector)
    return jc, pc


def _states(seed, **kw):
    return sparse_state(js, seed, **kw), sparse_state(ts, seed, **kw)


# -- the trie's own operations ------------------------------------------------


@pytest.mark.parametrize("hasher", ["numpy", "device"])
@pytest.mark.parametrize("seed", [77, 78])
def test_update_insert_delete_roots_match_reference(seed, hasher):
    """Random updates, inserts and deletes (collapses among them) on a
    fully revealed trie: the same roots at every checkpoint. ``device``:
    the port's default hasher, kernel 1's plain version on the CPU."""
    rng = np.random.default_rng(seed)
    tj, tp = js.SparseTrie(), ts.SparseTrie()
    keys = []
    for _ in range(40):
        k = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
        keys.append(k)
        v = bytes(rng.integers(0, 256, int(rng.integers(1, 40)), dtype=np.uint8))
        tj.update(k, v)
        tp.update(k, v)

    def roots():
        want = tj.root_hash_compute(jhash)
        got = (tp.root_hash_compute(phash) if hasher == "numpy"
               else tp.root_hash_compute(device="cpu"))
        assert got == want
        assert tp.revealed_count() == tj.revealed_count()

    roots()
    for step in range(45):
        op = int(rng.integers(0, 3))
        if op == 0 and keys:
            k = keys[int(rng.integers(0, len(keys)))]
            v = bytes(rng.integers(0, 256, int(rng.integers(1, 40)), dtype=np.uint8))
            tj.update(k, v)
            tp.update(k, v)
        elif op == 1:
            k = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
            keys.append(k)
            tj.update(k, b"\x01" * 20)
            tp.update(k, b"\x01" * 20)
        elif keys:
            k = keys.pop(int(rng.integers(0, len(keys))))
            tj.delete(k)
            tp.delete(k)
        if step % 9 == 8:
            roots()
    for k in keys:
        assert tp.get(k) == tj.get(k)
    while keys:  # delete down to the empty trie
        k = keys.pop()
        tj.delete(k)
        tp.delete(k)
    roots()
    assert tp.root is None and tp.root_hash == tj.root_hash


def _proof_state(n_accounts=40):
    rng = np.random.default_rng(11)
    factory = ProviderFactory(MemDb())
    cpu = JaxTrieCommitter(hasher=jhash)
    addrs = [bytes(rng.integers(0, 256, 20, dtype=np.uint8)) for _ in range(n_accounts)]
    with factory.provider_rw() as p:
        for i, a in enumerate(addrs):
            p.put_hashed_account(jkeccak256(a), Account(nonce=i, balance=1000 + i))
        root = full_state_root(p, cpu)
    with factory.provider() as p:
        calc = ProofCalculator(p, cpu)
        proofs = {a: calc.account_proof(a).proof for a in addrs + [b"\xaa" * 20]}
    return addrs, root, proofs


def _blinded_path(trie, key):
    with pytest.raises((js.BlindedNodeError, ts.BlindedNodeError)) as ei:
        trie.get(key)
    return ei.value.path


def test_reveal_from_proofs_matches_reference():
    """Reveal from the reference's ProofCalculator over a MemDb: the same
    reads, BlindedNodeError at the same paths, the same roots after
    updates, an insert through an exclusion proof, and a delete."""
    addrs, root, proofs = _proof_state()
    tj, tp = js.SparseTrie(root), ts.SparseTrie(root)
    for a in addrs[:10] + [b"\xaa" * 20]:
        tj.reveal(proofs[a])
        tp.reveal(proofs[a])
    assert tp.revealed_count() == tj.revealed_count()
    for a in addrs[:10]:
        assert tp.get(jkeccak256(a)) == tj.get(jkeccak256(a)) is not None
    for a in addrs[10:]:
        assert _blinded_path(tp, jkeccak256(a)) == _blinded_path(tj, jkeccak256(a))
    for i, a in enumerate(addrs[:6]):
        v = encode_account(Account(nonce=100 + i, balance=5))
        tj.update(jkeccak256(a), v)
        tp.update(jkeccak256(a), v)
    for t in (tj, tp):
        t.update(jkeccak256(b"\xaa" * 20), encode_account(Account(balance=77)))
    assert tp.root_hash_compute(phash) == tj.root_hash_compute(jhash)
    # a delete with only its own spine revealed: the same outcome (a
    # collapse into a blinded sibling raises at the same path, or none)
    outcome = []
    for mod in (js, ts):
        t = mod.SparseTrie(root)
        t.reveal(proofs[addrs[7]])
        try:
            t.delete(jkeccak256(addrs[7]))
            outcome.append(None)
        except mod.BlindedNodeError as e:
            outcome.append(e.path)
    assert outcome[0] == outcome[1]
    for t in (tj, tp):
        for a in addrs:
            t.reveal(proofs[a])
        t.delete(jkeccak256(addrs[7]))
    assert tp.root_hash_compute(phash) == tj.root_hash_compute(jhash)
    assert tp.spine(jkeccak256(addrs[2])) == tj.spine(jkeccak256(addrs[2]))


def test_collapse_into_blinded_sibling_raises_at_same_path():
    """A delete that leaves a branch with one blinded child raises at the
    child's path in both packages; once the sibling is revealed the
    collapse gives the same root."""
    a, b = b"\x11" * 32, b"\x12" * 32
    full = ts.SparseTrie()
    full.update(a, b"A-value")
    full.update(b, b"B-value")
    root = full.root_hash_compute(phash)
    paths = []
    for mod in (js, ts):
        t = mod.SparseTrie(root)
        t.reveal(full.spine(a))
        with pytest.raises(mod.BlindedNodeError) as ei:
            t.delete(a)
        paths.append(ei.value.path)
    assert paths[0] == paths[1]
    tj, tp = js.SparseTrie(root), ts.SparseTrie(root)
    for t in (tj, tp):
        t.reveal(full.spine(a))
        t.reveal(full.spine(b))
        t.delete(a)
    assert tp.root_hash_compute(phash) == tj.root_hash_compute(jhash)


def test_state_trie_serial_root_matches_reference():
    (sj, owners, keys), (sp, _, _) = _states(21)
    assert sp.root(phash) == sj.root(jhash)
    sparse_block(sj, owners, keys, seed=22)
    sparse_block(sp, owners, keys, seed=22)
    assert len(sp.dirty_storage_tries()) == len(sj.dirty_storage_tries())
    assert sp.root(device="cpu") == sj.root(jhash)
    sj.remove_account(owners[0])
    sp.remove_account(owners[0])
    assert sp.root(phash) == sj.root(jhash)


# -- the parallel finish --------------------------------------------------------


@pytest.mark.parametrize("split_depth", [0, 1, 2, 3])
@pytest.mark.parametrize("workers", [1, 4])
def test_classic_finish_matches_reference(workers, split_depth):
    """The classic finish: the same roots and the same stats (levels,
    dispatches, hashed, encode chunks) as the reference's, over a baseline
    commit and two blocks on the preserved trie."""
    (sj, owners, keys), (sp, _, _) = _states(31 + split_depth, tries=12)
    jc, pc = _committers(workers=workers, split_depth=split_depth)
    chunks = 0
    for block in range(3):
        if block:
            sparse_block(sj, owners, keys, seed=100 * workers + block)
            sparse_block(sp, owners, keys, seed=100 * workers + block)
        assert sp.root(phash, committer=pc) == sj.root(jhash, committer=jc)
        assert {k: pc.last[k] for k in STATS} == {k: jc.last[k] for k in STATS}
        chunks += pc.last["encode_chunks"]
    assert (chunks > 0) == (workers > 1)  # the encode pool ran


def test_classic_finish_default_hasher_is_kernel_1():
    """With no hasher the classic finish hashes through KeccakDevice on the
    committer's device (min tier 1024, one 4-block bucket: kernel 1, here
    its plain version on the CPU), with the same root and stats as the
    reference's numpy hasher."""
    from reth_tpu_torch.ops.keccak import KeccakDevice

    (sj, owners, keys), (sp, _, _) = _states(41)
    jc, pc = _committers()
    assert sp.root(committer=pc) == sj.root(jhash, committer=jc)
    dev = pc._hasher.__self__
    assert isinstance(dev, KeccakDevice)
    assert (dev.device, dev.min_tier, dev.block_tier) == (torch.device("cpu"), 1024, 4)
    assert dev.uploads == 2 * pc.last["dispatches"]  # words and counts, one bucket a depth
    assert {k: pc.last[k] for k in STATS} == {k: jc.last[k] for k in STATS}


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("seed", [4, 5])
def test_fused_finish_matches_reference(seed, k):
    """subtrie_levels=k against the reference over a baseline and a block on
    the preserved trie: the same roots, levels, dispatches and hashed nodes.
    At k = 2 and 8 both take the fused finish (the reference's
    _commit_fused on its JAX engine); at k = 1 both take the classic one."""
    (sj, owners, keys), (sp, _, _) = _states(seed)
    jc, pc = _committers(k=k)
    for block in range(2):
        if block:
            sparse_block(sj, owners, keys, seed=seed + 100)
            sparse_block(sp, owners, keys, seed=seed + 100)
        assert sp.root(committer=pc) == sj.root(jhash, committer=jc)
        assert {k_: pc.last[k_] for k_ in ("levels", "dispatches", "hashed")} == \
            {k_: jc.last[k_] for k_ in ("levels", "dispatches", "hashed")}
        assert pc.last.get("subtrie_k") == jc.last.get("subtrie_k")
        assert (pc.last.get("subtrie_k") is None) == (k == 1)


def test_fused_finish_inline_children_and_empty_tries():
    """Inline children (two leaves under the last nibble: no row of their
    own, their bytes inside the parent's template), an empty trie and a
    trie anchored at a blinded root, in one commit."""
    tries = []
    for mod in (js, ts):
        small, empty, blind = mod.SparseTrie(), mod.SparseTrie(), mod.SparseTrie(b"\x05" * 32)
        small.update(b"\x01" * 31 + b"\x10", b"\x02")
        small.update(b"\x01" * 31 + b"\x11", b"\x03")
        tries.append([small, empty, blind])
    jc, pc = _committers(k=8)
    assert pc.commit(tries[1]) == jc.commit(tries[0], jhash)
    assert {k: pc.last[k] for k in STATS} == {k: jc.last[k] for k in STATS}
    assert pc.last["hashed"] == 1  # the extension; its branch and the leaves are inline


# -- stored branch updates and the preserved cache ------------------------------


def _fields(updates):
    """Branch updates as plain tuples (None for a delete marker): the two
    packages' BranchNode classes differ."""
    return {p: None if b is None else next(iter(branches({p: b}).values()))
            for p, b in updates.items()}


def _stored_branches(leaves):
    from reth_tpu.trie import TrieCommitter

    res = TrieCommitter(hasher=jhash).commit(sorted((unpack_nibbles(k), v)
                                                    for k, v in leaves.items()))
    return dict(res.branch_nodes)


@pytest.mark.parametrize("case", range(6))
def test_export_branch_updates_matches_reference(case):
    """export_branch_updates after a delete/insert batch, against the
    pre-state's stored branches: field for field the reference's (new
    branches, delete markers, masks, child hashes)."""
    rng = np.random.default_rng(700 + case)
    n = int(rng.integers(5, 40))
    keys = list(dict.fromkeys(bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(n)))
    for i in range(1, len(keys), 3):  # shared prefixes: collapses and extensions
        j = int(rng.integers(1, 8))
        keys[i] = keys[0][:j] + keys[i][j:]
    keys = list(dict.fromkeys(keys))
    pre = {k: bytes([65 + j % 26]) * 3 for j, k in enumerate(keys)}
    stored = _stored_branches(pre)
    dels = [k for j, k in enumerate(keys) if j % 4 == 1]
    ins = {bytes(rng.integers(0, 256, 32, dtype=np.uint8)): b"new" for _ in range(3)}
    ins.update({k: b"upd" for j, k in enumerate(keys) if j % 5 == 2 and k not in dels})
    out = []
    for mod, hasher in ((js, jhash), (ts, phash)):
        t = mod.SparseTrie()
        for k, v in pre.items():
            t.update(k, v)
        t.root_hash_compute(hasher)
        for k in dels:
            t.delete(k)
        for k, v in ins.items():
            t.update(k, v)
        t.root_hash_compute(hasher)
        out.append(mod.export_branch_updates(t, dels + list(ins), stored.get))
    assert _fields(out[1]) == _fields(out[0])


def test_export_branch_updates_with_blinded_children():
    """A partially revealed trie: blinded children take their tree-mask bit
    from the pre-state branch, in both packages."""
    addrs, root, proofs = _proof_state(60)
    from reth_tpu.trie import TrieCommitter

    leaves = {jkeccak256(a): encode_account(Account(nonce=i, balance=1000 + i))
              for i, a in enumerate(addrs)}
    stored = dict(TrieCommitter(hasher=jhash).commit(
        sorted((unpack_nibbles(k), v) for k, v in leaves.items())).branch_nodes)
    changed = [jkeccak256(a) for a in addrs[:5]]
    out = []
    for mod, hasher in ((js, jhash), (ts, phash)):
        t = mod.SparseTrie(root)
        for a in addrs[:5]:
            t.reveal(proofs[a])
        for i, k in enumerate(changed):
            t.update(k, encode_account(Account(nonce=9, balance=i)))
        t.root_hash_compute(hasher)
        out.append(mod.export_branch_updates(t, changed, stored.get))
    assert _fields(out[1]) == _fields(out[0])


def test_preserved_sparse_trie_matches_reference():
    got, want = [], []
    for mod, log in ((js, want), (ts, got)):
        cache = mod.PreservedSparseTrie()
        t = mod.SparseStateTrie.anchored(b"\x01" * 32)
        cache.preserve(b"\xbb" * 32, t)
        log.append(cache.take(b"\xcc" * 32) is None)   # wrong anchor: miss
        log.append(cache.peek(b"\xbb" * 32) is t)
        log.append(cache.take(b"\xbb" * 32) is t)
        log.append(cache.take(b"\xbb" * 32) is None)   # consumed
        cache.preserve(b"\xdd" * 32, t)
        cache.invalidate()
        log.append(cache.peek(b"\xdd" * 32) is None)
        log.append(cache.take(b"\xdd" * 32) is None)
        log.append((cache.hits, cache.misses))
    assert got == want


# -- fault drills and the seams -------------------------------------------------


@pytest.mark.parametrize("k", [0, 8])
@pytest.mark.parametrize("abort_at", [1, 3])
def test_sparse_abort_drill_fires_on_the_same_dispatch(monkeypatch, abort_at, k):
    """RETH_TPU_FAULT_SPARSE_ABORT=N raises InjectedSparseAbort on the same
    dispatch number in both packages, on the classic and the fused finish."""
    monkeypatch.setenv("RETH_TPU_FAULT_SPARSE_ABORT", str(abort_at))
    (sj, _, _), (sp, _, _) = _states(9)
    jc, pc = _committers(k=k)
    assert pc.injector is not None and pc.injector.abort_at == abort_at
    with pytest.raises(js.InjectedSparseAbort):
        sj.root(jhash, committer=jc)
    with pytest.raises(ts.InjectedSparseAbort):
        sp.root(phash, committer=pc)
    assert (pc.injector.dispatches, pc.injector.aborts) == \
        (jc.injector.dispatches, jc.injector.aborts) == (abort_at, 1)


def test_worker_count_and_split_depth_read_the_environment(monkeypatch):
    monkeypatch.setenv("RETH_TPU_SPARSE_WORKERS", "3")
    monkeypatch.setenv("RETH_TPU_SPARSE_SPLIT_DEPTH", "1")
    monkeypatch.setenv("RETH_TPU_SUBTRIE_LEVELS", "4")
    jc, pc = _committers(k=None)
    assert (pc.workers, pc.split_depth, pc.subtrie_levels) == \
        (jc.workers, jc.split_depth, jc.subtrie_levels) == (3, 1, 4)
    assert ts.sparse_worker_count(7) == js.sparse_worker_count(7) == 7


class _ServiceClient:
    def __call__(self, msgs):
        return phash(msgs)

    def submit(self, msgs):
        raise AssertionError("never called")


def test_unported_seams_raise():
    """The hash service's lanes are ported now: a hasher with submit() is
    taken, with or without the hot-state arena, and a one-leaf trie (no
    pooled depth) never streams, so the root comes from its calls."""
    from reth_tpu_torch.ops.fused_commit import DigestArena

    for arena in (None, DigestArena()):
        t, twin = ts.SparseTrie(), ts.SparseTrie()
        for trie in (t, twin):
            trie.update(b"\x01" * 32, b"\x02" * 40)
        got = ts.ParallelSparseCommitter(arena=arena, device="cpu").commit([t], _ServiceClient())
        assert got == [twin.root_hash_compute(phash)]


def test_the_card_is_the_default_and_never_replaced_by_the_cpu():
    """ParallelSparseCommitter and the default hasher run on the card; with
    no card they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        ts.ParallelSparseCommitter()
    with pytest.raises(RuntimeError):
        ts.ParallelSparseCommitter(subtrie_levels=8)
    t = ts.SparseTrie()
    t.update(b"\x01" * 32, b"\x02" * 40)
    t.update(b"\x02" * 32, b"\x02" * 40)
    with pytest.raises(RuntimeError):
        t.root_hash_compute()
    with pytest.raises(RuntimeError):
        ts.SparseStateTrie(account_trie=t).root()
