"""The port's live tip (reth_tpu_torch/engine: SparseRootTask,
apply_output_to_trie) against the JAX package's, on the CPU.

Both packages' MemDb hold one seeded state and its blocks 2 and 3
(tests/_torch_helpers.py ``stage_pair``: 2,000 accounts, 800 slots,
``STAGE_BLOCK_SMALL`` blocks through each package's hashing stages and
incremental MerkleStage route). Each block's ``BlockExecutionOutput`` comes
from the same ``stage_block`` tuples, its keys stream through
``on_state_update``, and the task proves from a read view of the parent's
tables. The reference hashes with ``keccak256_batch_np``; the port runs on
``device="cpu"``, with kernel 1's plain version (``TrieCommitter(device=
"cpu")``) or the numpy hasher as each test says. Tolerance zero: roots,
digests, storage roots, exported branch nodes, trie tables and the
reveal / cache counters are equal.
"""

from __future__ import annotations

import threading

import pytest
import torch

from _torch_helpers import (STAGE_BLOCK_SMALL, stage_block_bursts, stage_block_output,
                            stage_pair, write_back_updates)
from reth_tpu.engine import sparse_root as jsr
from reth_tpu.engine import stateless as jstateless
from reth_tpu.evm import executor as jexec
from reth_tpu.evm import state as jstate
from reth_tpu.ops import fused_commit as jfc
from reth_tpu.primitives.keccak import keccak256_batch_np as jhash
from reth_tpu.primitives.rlp import encode_int, rlp_encode
from reth_tpu.storage import tables as jtables
from reth_tpu.trie import committer as jcommitter
from reth_tpu.trie import hot_cache as jhot
from reth_tpu.trie import proof as jproof
from reth_tpu.trie import sparse as jsparse
from reth_tpu_torch.engine import sparse_root as psr
from reth_tpu_torch.engine import stateless as pstateless
from reth_tpu_torch.evm import executor as pexec
from reth_tpu_torch.evm import state as pstate
from reth_tpu_torch.ops import fused_commit as pfc
from reth_tpu_torch.ops import keccak as pkeccak
from reth_tpu_torch.primitives.keccak import keccak256
from reth_tpu_torch.primitives.keccak import keccak256_batch_np as phash
from reth_tpu_torch.storage import tables as ptables
from reth_tpu_torch.trie import committer as pcommitter
from reth_tpu_torch.trie import hot_cache as phot
from reth_tpu_torch.trie import proof as pproof
from reth_tpu_torch.trie import sparse as psparse

N_ACCOUNTS, N_SLOTS, SEED = 2000, 800, 5
BLOCKS = (2, 3)
TRIE_TABLES = ("AccountsTrie", "StoragesTrie")


class Pkg:
    """One package's modules of the live tip."""

    def __init__(self, sr, stateless, exec_mod, state_mod, sparse, hot, fc, proof, tables):
        self.sr, self.stateless, self.sparse, self.hot, self.fc = sr, stateless, sparse, hot, fc
        self.proof, self.tables = proof, tables
        self.output, self.changes = exec_mod.BlockExecutionOutput, state_mod.BlockChanges


JAX = Pkg(jsr, jstateless, jexec, jstate, jsparse, jhot, jfc, jproof, jtables)
PORT = Pkg(psr, pstateless, pexec, pstate, psparse, phot, pfc, pproof, ptables)


@pytest.fixture(scope="module")
def chain():
    """(reference StageDb, port StageDb, the blocks' stage_block tuples)."""
    return stage_pair(N_ACCOUNTS, N_SLOTS, SEED, blocks=BLOCKS, sizes=STAGE_BLOCK_SMALL)


def sides(chain):
    ref, port, blocks = chain
    return ((JAX, ref), (PORT, port)), blocks


def committer(pkg, route: str = "numpy"):
    """The reference's numpy committer, or the port's on the CPU: ``"plain"``
    (KeccakDevice on kernel 1's plain version) or ``"numpy"``."""
    if pkg is JAX:
        return jcommitter.TrieCommitter(hasher=jhash)
    if route == "plain":
        return pcommitter.TrieCommitter(device="cpu")
    return pcommitter.TrieCommitter(hasher=phash, device="cpu")


def output(pkg, db, block):
    return stage_block_output(block, pkg.output, pkg.changes, db.convert)


def start(pkg, db, b: int, c, preserved, pool: bool = False, **kw):
    """Block ``b``'s task over a read view of block ``b - 1``'s tables, with
    the proof pool (a fresh view a worker) when ``pool``."""
    _, factory = db.at(b - 1)
    if pool:
        kw.update(provider_factory=factory.provider, workers=4)
    else:
        kw.setdefault("workers", 1)
    return pkg.sr.SparseRootTask(factory.provider(), db.roots[b - 1], preserved, c,
                                 parent_hash=bytes([b - 1]) * 32, **kw)


def run_block(pkg, db, blocks, b: int, c, preserved, bursts: int = 1, pool: bool = False,
              absorb: bool = False, **kw) -> dict:
    """Block ``b`` through a task: its keys in ``bursts`` bursts, then
    ``finish``; its root must be the incremental route's. Preserves the
    trie (and absorbs into the cache when ``absorb``), then writes the
    exported updates back onto a copy of the parent's tables."""
    out = output(pkg, db, blocks[b])
    task = start(pkg, db, b, c, preserved, pool, **kw)
    for burst in stage_block_bursts(out, bursts, seed=b):
        task.on_state_update(burst)
    root, digests, storage_roots = task.finish(out)
    assert root == db.roots[b]
    task.preserve(bytes([b]) * 32)
    if absorb:
        task.absorb_into_cache(out, digests)
    updates = task.export_updates(out, digests)
    after, factory = db.at(b - 1)
    with factory.provider_rw() as p:
        write_back_updates(p, out, digests, updates)
    return dict(task=task, root=root, digests=dict(digests), storage_roots=storage_roots,
                updates=updates, tables=after._tables)


def branch(node):
    return None if node is None else (node.state_mask, node.tree_mask, node.hash_mask,
                                      tuple(node.hashes))


def plain_updates(updates) -> tuple:
    accounts, storages = updates
    return ({p: branch(n) for p, n in accounts.items()},
            {o: {p: branch(n) for p, n in u.items()} for o, u in storages.items()})


def check_block(db, b: int, res: dict) -> None:
    """The written-back trie tables are the incremental route's, and the
    storage roots those HashedAccounts holds after the block."""
    for name in TRIE_TABLES:
        assert res["tables"].get(name) == db.tables[b].get(name), name
    _, factory = db.at(b)
    with factory.provider() as p:
        for a, sroot in res["storage_roots"].items():
            acc = p.hashed_account(keccak256(a))
            if acc is not None:
                assert acc.storage_root == sroot


# -- apply_output_to_trie -------------------------------------------------------


def full_trie(pkg, db, b: int):
    """A fully revealed SparseStateTrie of the state after block ``b``, built
    by inserting every leaf of the hashed tables."""
    st = pkg.sparse.SparseStateTrie()
    _, factory = db.at(b)
    with factory.provider() as p:
        for ha, raw in p.tx.cursor("HashedAccounts").walk():
            st.account_trie.update(ha, pkg.tables.decode_account(raw).trie_encode())
        for ha, dup in p.tx.cursor("HashedStorages").walk():
            slot, value = pkg.tables.decode_storage_entry(dup)
            st.storage_trie(ha).update(slot, rlp_encode(encode_int(value)))
    return st


@pytest.mark.parametrize("mode", ["numpy", "parallel-1", "parallel-4"])
def test_apply_output_to_trie_equals_reference(chain, mode):
    """Blocks 2 and 3 applied to a fully revealed trie of block 1: with the
    numpy hasher, and through ParallelSparseCommitter(device="cpu") at 1
    and 4 workers (the reference's at the same workers), each root and
    storage_roots_out equal to the reference's and the root the
    incremental route's."""
    pairs, blocks = sides(chain)
    got = []
    for pkg, db in pairs:
        st = full_trie(pkg, db, 1)
        kw = {}
        if mode != "numpy":
            workers = int(mode.split("-")[1])
            kw["committer"] = (psparse.ParallelSparseCommitter(workers=workers, device="cpu")
                               if pkg is PORT else jsparse.ParallelSparseCommitter(workers))
        runs = []
        for b in BLOCKS:
            sroots: dict = {}
            root = pkg.stateless.apply_output_to_trie(
                st, output(pkg, db, blocks[b]), jhash if pkg is JAX else phash,
                storage_roots_out=sroots, **kw)
            assert root == db.roots[b]
            runs.append((root, sroots))
        got.append(runs)
    assert got[0] == got[1]


def test_storage_blind_carries_its_owner(chain):
    """A storage write into a storage trie anchored blind at its root raises
    BlindedNodeError whose owner is the trie's hashed address and whose
    path is the reference's."""
    pairs, blocks = sides(chain)
    seen = []
    for pkg, db in pairs:
        out = output(pkg, db, blocks[2])
        st = pkg.sparse.SparseStateTrie.anchored(db.roots[1])
        _, factory = db.at(1)
        with factory.provider() as p:
            calc = pkg.proof.ProofCalculator(p, committer(pkg))
            proofs = calc.multiproof({a: [] for a in out.post_storage})
            for a, ap in proofs.items():
                st.reveal_account(ap.proof)
                st.storage_trie(keccak256(a), ap.storage_root)
        with pytest.raises(pkg.sparse.BlindedNodeError) as e:
            pkg.stateless.apply_output_to_trie(st, out, jhash if pkg is JAX else phash)
        seen.append((e.value.owner, bytes(e.value.path)))
    assert seen[0] == seen[1]
    first = next(iter(output(PORT, chain[1], blocks[2]).post_storage))
    assert seen[1][0] == keccak256(first)


# -- SparseRootTask ----------------------------------------------------------------


@pytest.mark.parametrize("variant", ["plain", "pool", "hot"])
def test_sparse_root_task_equals_reference(chain, variant):
    """Blocks 2 and 3 through both packages' tasks, one burst a block: each
    root the incremental route's; digest maps, storage roots, exported
    branch updates, proof targets and cache unblinds equal to the
    reference's; the written-back trie tables the incremental route's.
    "plain": kernel 1's plain version, the single worker, the preserved
    trie reused on block 3. "pool": the proof pool (4 workers, a fresh view
    each). "hot": the pool with a TrieNodeCache and a DigestArena (the
    delta finish on the CPU); block 2 absorbs, block 3 anchors cold on a
    fresh preserved trie and unblinds from the cache."""
    pairs, blocks = sides(chain)
    results = []
    for pkg, db in pairs:
        c = committer(pkg, "plain" if variant == "plain" else "numpy")
        preserved = pkg.sparse.PreservedSparseTrie()
        kw = {}
        if variant == "hot":
            kw = dict(hot_cache=pkg.hot.TrieNodeCache(), arena=pkg.fc.DigestArena())
        runs = []
        for b in BLOCKS:
            if variant == "hot" and b == 3:
                preserved = pkg.sparse.PreservedSparseTrie()
            res = run_block(pkg, db, blocks, b, c, preserved, pool=variant != "plain",
                            absorb=variant == "hot", **kw)
            check_block(db, b, res)
            task = res["task"]
            runs.append((res["root"], res["digests"], res["storage_roots"],
                         plain_updates(res["updates"]), task.proof_targets,
                         task.cache_unblinds, task.reused, task.proof_batches,
                         sorted(task.overlap_metrics())))
        results.append(runs)
    assert results[0] == results[1]
    reused = [r[6] for r in results[1]]
    assert reused == ([False, False] if variant == "hot" else [False, True])
    if variant == "hot":
        assert results[1][1][5] > 0  # block 3 unblinded from the cache


@pytest.mark.parametrize("bursts", [1, 7, 64])
def test_bursts_give_the_same_root(chain, bursts):
    """The port's task with the proof pool: block 2's keys in 1, 7 or 64
    bursts give the incremental route's root and trie tables."""
    _, port, blocks = chain
    res = run_block(PORT, port, blocks, 2, committer(PORT), psparse.PreservedSparseTrie(),
                    bursts=bursts, pool=True)
    check_block(port, 2, res)
    assert res["task"].proof_batches >= 1


def test_task_on_a_cpu_committer_finishes_on_the_cpu(chain):
    """The task's sparse committer takes the committer's device: a
    TrieCommitter(device="cpu") gives a finish on the CPU."""
    _, port, _ = chain
    task = start(PORT, port, 2, committer(PORT), psparse.PreservedSparseTrie())
    try:
        assert task.sparse_committer.device == torch.device("cpu")
    finally:
        task.abort()
    assert not task._thread.is_alive()


# -- drills --------------------------------------------------------------------------


@pytest.mark.parametrize("knob,message", [
    ("RETH_TPU_FAULT_SPARSE_PROOF_WEDGE", "worker failed: injected sparse proof wedge"),
    ("RETH_TPU_FAULT_SPARSE_ABORT", "parallel commit failed: injected sparse-commit abort"),
])
def test_fault_drills_end_in_sparse_root_error(chain, monkeypatch, knob, message):
    """The proof wedge (every fetch) and the commit abort (first dispatch):
    SparseRootError in both packages with the reference's message, the
    injected fault its cause."""
    monkeypatch.setenv(knob, "1")
    pairs, blocks = sides(chain)
    seen = []
    for pkg, db in pairs:
        with pytest.raises(pkg.sr.SparseRootError, match=message) as e:
            run_block(pkg, db, blocks, 2, committer(pkg), pkg.sparse.PreservedSparseTrie(),
                      pool=True)
        assert isinstance(e.value.__cause__, RuntimeError)
        seen.append(str(e.value))
    assert seen[0] == seen[1]


def test_cancel_from_another_thread(chain):
    """cancel() from another thread: finish raises "cancelled by forkchoice
    reorg" in both packages."""
    pairs, blocks = sides(chain)
    for pkg, db in pairs:
        out = output(pkg, db, blocks[2])
        task = start(pkg, db, 2, committer(pkg), pkg.sparse.PreservedSparseTrie(), pool=True)
        task.on_state_update(stage_block_bursts(out, 1, seed=2)[0])
        t = threading.Thread(target=task.cancel)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with pytest.raises(pkg.sr.SparseRootError, match="cancelled by forkchoice reorg"):
            task.finish(out)
        assert not task._thread.is_alive()


def test_abort_joins_the_worker(chain):
    """abort() after a burst: the worker thread has ended, in both packages."""
    pairs, blocks = sides(chain)
    for pkg, db in pairs:
        out = output(pkg, db, blocks[2])
        task = start(pkg, db, 2, committer(pkg), pkg.sparse.PreservedSparseTrie(), pool=True)
        task.on_state_update(stage_block_bursts(out, 1, seed=2)[0])
        task.abort()
        assert not task._thread.is_alive()


def test_launch_fault_in_the_finish_keeps_its_cause(chain, monkeypatch):
    """A RuntimeError raised by kernel 1's wrapper during the finish's
    commit (as a failed launch or build would): SparseRootError, whose
    __cause__ is that very error. Nothing falls back."""
    _, port, blocks = chain
    fault = RuntimeError("injected launch fault")
    armed = []
    real_launch = pkeccak.keccak256_words_masked
    real_commit = psparse.ParallelSparseCommitter.commit

    def launch(*args):
        if armed:
            raise fault
        return real_launch(*args)

    def commit(self, tries, hasher=None):
        armed.append(True)
        return real_commit(self, tries, hasher)

    monkeypatch.setattr(pkeccak, "keccak256_words_masked", launch)
    monkeypatch.setattr(psparse.ParallelSparseCommitter, "commit", commit)
    with pytest.raises(psr.SparseRootError, match="parallel commit failed") as e:
        run_block(PORT, port, blocks, 2, committer(PORT, "plain"),
                  psparse.PreservedSparseTrie())
    assert e.value.__cause__ is fault


# -- the distinct-node reveal ---------------------------------------------------------


def dump(node):
    """A sparse-trie node of either package as plain values."""
    if node is None:
        return None
    kind = type(node).__name__
    if kind == "_Blind":
        return ("blind", node.hash)
    if kind == "_Leaf":
        return ("leaf", node.path, node.value, node._ref)
    if kind == "_Ext":
        return ("ext", node.path, dump(node.child), node._ref)
    return ("branch", tuple(dump(c) for c in node.children), node.value, node._ref)


def test_distinct_node_reveal_equals_reference(chain):
    """One burst of many owners (24 owners, a slot each, and 24 other
    accounts) revealed with stamping on (a hot cache): the port's tries,
    node by node, and each trie's stamped count equal the reference's, which
    hashes the burst's account nodes on the host once per owner (so the
    burst stays small: its cost grows with owners x account nodes)."""
    pairs, _ = sides(chain)
    ref_db = pairs[0][1]
    _, factory = ref_db.at(1)
    with factory.provider() as p:
        owners = sorted({k for k, _ in p.tx.cursor("PlainStorageState").walk()})[:24]
        slots = {o: p.tx.get_dups("PlainStorageState", o)[0][:32] for o in owners}
        plain = [k for k, _ in p.tx.cursor("PlainAccountState").walk()][:24]
    burst = plain + [(o, slots[o]) for o in owners]
    got = []
    for pkg, db in pairs:
        task = start(pkg, db, 2, committer(pkg), pkg.sparse.PreservedSparseTrie(),
                     hot_cache=pkg.hot.TrieNodeCache())
        try:
            task._process(burst)
        finally:
            task.abort()
        st = task.trie
        got.append((dump(st.account_trie.root), st.account_trie.stamped,
                    {o: (dump(t.root), t.stamped) for o, t in st.storage_tries.items()},
                    task.proof_targets))
    assert got[0] == got[1]
    assert len(got[1][2]) == len(owners) and got[1][1] > 0
    assert all(stamped > 0 for _, stamped in got[1][2].values())


def test_storage_reveal_map_is_the_merged_map():
    """The storage reveal's node map (the owner's nodes over the burst's
    account nodes, not copied) reads and counts as the merged dict the
    reference builds, a node in both maps counted once."""
    shared = {keccak256(bytes([i])): bytes([i]) for i in range(6)}
    own = {keccak256(bytes([i])): bytes([i]) for i in range(4, 9)}
    merged = {**shared, **own}
    got = psr._NodeMap(own, shared)
    assert len(got) == len(merged) == 9
    assert {k: got.get(k) for k in merged} == merged
    assert got.get(keccak256(b"absent")) is None


def test_stateless_chain_and_witness_source_construct_and_answer_empty_state():
    """WitnessStateSource and StatelessChain are ported now (the EVM's ROADMAP
    item 7): they construct without raising, the chain on the device it is
    given, and an empty witness answers an empty state (tests/
    test_torch_witness.py holds both against the reference's)."""
    chain = pstateless.StatelessChain(device="cpu")
    assert chain.committer is not None and chain.preserved.hits == 0
    src = pstateless.WitnessStateSource(psparse.SparseStateTrie(), [], [])
    assert src.account(b"\x01" * 20) is None and src.storage(b"\x01" * 20, b"\x00" * 32) == 0


def test_export_keeps_a_stored_branch_under_a_split_extension():
    """An insert that splits an extension above a stored branch the proof
    left blind: the port's export_branch_updates gives the new branch the
    tree_mask bit of that child, and the updates written over the old
    stored branches are a whole rebuild's. The reference leaves the bit
    clear, which loses the stored branch below it (the port's departure,
    ROADMAP C): the same roots, another tree_mask."""
    from reth_tpu_torch.primitives.nibbles import pack_nibbles, unpack_nibbles

    def key(head, fill):
        return pack_nibbles(bytes(head) + bytes([fill]) * (64 - len(head)))

    old_keys = [key([13, 15, 0], 1), key([13, 15, 1], 2), key([0], 3), key([1], 4)]
    new_key = key([13, 0], 5)
    value = rlp_encode(encode_int(7))
    got = {}
    for pkg, committer_mod, hasher in ((JAX, jcommitter, jhash), (PORT, pcommitter, phash)):
        c = (committer_mod.TrieCommitter(hasher=hasher) if pkg is JAX
             else committer_mod.TrieCommitter(hasher=hasher, device="cpu"))

        def stored(keys):
            res = c.commit([(unpack_nibbles(k), value) for k in keys])
            return res.root, {p: branch(n) for p, n in res.branch_nodes.items()}

        old_root, old = stored(old_keys)
        full = pkg.sparse.SparseTrie()
        for k in old_keys:
            full.update(k, value)
        assert full.root_hash_compute(hasher) == old_root
        trie = pkg.sparse.SparseTrie(old_root)
        trie.reveal(full.spine(new_key))
        trie.update(new_key, value)
        new_root, want = stored(old_keys + [new_key])
        assert trie.root_hash_compute(hasher) == new_root
        old_nodes = c.commit([(unpack_nibbles(k), value) for k in old_keys]).branch_nodes
        updates = pkg.sparse.export_branch_updates(trie, [new_key], old_nodes.get)
        written = dict(old)
        for p, n in updates.items():
            if n is None:
                written.pop(p, None)
            else:
                written[p] = branch(n)
        got[pkg] = (new_root, written, want)
    (ref_root, ref_written, want), (root, written, port_want) = got[JAX], got[PORT]
    assert root == ref_root and want == port_want
    assert b"\x0d\x0f" in want and want[b"\x0d"][1] & (1 << 15)
    assert written == want
    assert ref_written[b"\x0d"][1] & (1 << 15) == 0 and ref_written != want
