"""The port's hot-state plane against the JAX package's under
JAX_PLATFORMS=cpu: the cross-block node cache (trie/hot_cache.py), reveal-ref
stamping and the cache's hooks on SparseTrie, and the device DigestArena's
delta finish (ops/fused_commit.py DigestArena, SubtrieFusedEngine.begin_delta
/ peek_slots, ParallelSparseCommitter(arena=)). Inputs come from seeds;
tolerance zero: roots, RLP, cache stats, arena snapshots and the arena
finish's stats are equal. The port runs on device="cpu" (kernel 4 through
its plain version); the reference's arena engine runs its JAX program on the
CPU with the padding floors at 64, as tests/test_torch_sparse.py sets them."""

from __future__ import annotations

import random

import numpy as np
import pytest

from _torch_helpers import arena_level, branches, sparse_block, sparse_state
from reth_tpu.ops import fused_commit as jfc
from reth_tpu.primitives.keccak import keccak256 as jkeccak256
from reth_tpu.primitives.keccak import keccak256_batch_np as jhash
from reth_tpu.trie import hot_cache as jhc
from reth_tpu.trie import sparse as js
from reth_tpu_torch.ops import fused_commit as pfc
from reth_tpu_torch.primitives.keccak import keccak256 as pkeccak256
from reth_tpu_torch.primitives.keccak import keccak256_batch_np as phash
from reth_tpu_torch.primitives.rlp import rlp_encode
from reth_tpu_torch.trie import hot_cache as phc
from reth_tpu_torch.trie import sparse as ts

# each package's modules: trie.sparse, trie.hot_cache, ops.fused_commit, keccak256,
# the numpy batch hasher
REF = (js, jhc, jfc, jkeccak256, jhash)
PORT = (ts, phc, pfc, pkeccak256, phash)
ARENA_STATS = ("staged_rows", "stamped_rows", "delta_fraction", "arena_fresh", "subtrie_k",
               "hashed", "levels")


def _committer(pkg, arena=None, workers=1, k=None):
    mod = pkg[0]
    if mod is js:
        c = js.ParallelSparseCommitter(workers=workers, arena=arena, subtrie_levels=k)
        c.SUBTRIE_ROW_FLOOR = c.SUBTRIE_HOLE_FLOOR = 64
        return c
    return ts.ParallelSparseCommitter(workers=workers, arena=arena, subtrie_levels=k,
                                      device="cpu")


def _commit(pkg, committer, tries):
    """A commit through ``committer`` (the numpy hasher on the classic
    finish, so only the arena's engine runs a kernel's plain version)."""
    return committer.commit(tries, pkg[4])


def _keys(n: int, salt: int = 0):
    return [pkeccak256(salt.to_bytes(4, "big") + i.to_bytes(8, "big")) for i in range(n)]


def _arena_stats(c) -> dict:
    return {k: c.last.get(k) for k in ARENA_STATS}


# -- TrieNodeCache: the reference's unit drills, on both caches ----------------


def _drill_versions(pkg):
    _, hc, _, keccak, _ = pkg
    cache = hc.TrieNodeCache(injector=None)
    a, b = b"\xaa" * 40, b"\xbb" * 41
    cache.put(hc.ACCOUNT_OWNER, b"\x01", a)
    cache.put(hc.ACCOUNT_OWNER, b"\x01", b)
    out = [cache.lookup(hc.ACCOUNT_OWNER, b"\x01", keccak(a)),
           cache.lookup(hc.ACCOUNT_OWNER, b"\x01", keccak(b)), cache.stats()]
    out += [cache.lookup(hc.ACCOUNT_OWNER, b"\x01", b"\x00" * 32), cache.stats()]
    assert out[:2] == [a, b] and out[3] is None and cache.hits == 2 and cache.misses == 1
    return out


def _drill_cap_and_trim(pkg):
    _, hc, _, keccak, _ = pkg
    cache = hc.TrieNodeCache(injector=None)
    rlps = [bytes([i]) * 40 for i in range(6)]
    for r in rlps:
        cache.put(hc.ACCOUNT_OWNER, b"", r)
    out = [len(cache), cache.lookup(hc.ACCOUNT_OWNER, b"", keccak(rlps[0])),
           cache.lookup(hc.ACCOUNT_OWNER, b"", keccak(rlps[-1])), cache.stats()]
    assert out[0] == cache.VERSIONS_PER_PATH and out[1] is None and out[2] == rlps[-1]
    cache.invalidate_key(hc.ACCOUNT_OWNER, b"\x07" * 32)
    out += [len(cache), cache.lookup(hc.ACCOUNT_OWNER, b"", keccak(rlps[-1])), cache.stats()]
    assert out[4] == cache.INVALIDATE_KEEP and out[5] == rlps[-1]
    cache.drop_owner(hc.ACCOUNT_OWNER)
    out += [len(cache), cache.stats()]
    assert out[7] == 0
    return out


def _drill_clear_and_owners(pkg):
    _, hc, _, keccak, _ = pkg
    cache = hc.TrieNodeCache(injector=None)
    cache.put(hc.ACCOUNT_OWNER, b"\x01", b"\xaa" * 40)
    cache.put(b"\x99" * 32, b"\x01", b"\xbb" * 40)
    cache.drop_owner(b"\x99" * 32)
    out = [cache.lookup(hc.ACCOUNT_OWNER, b"\x01", keccak(b"\xaa" * 40)),
           cache.lookup(b"\x99" * 32, b"\x01", keccak(b"\xbb" * 40)), cache.stats()]
    assert out[0] is not None and out[1] is None
    cache.clear("test")
    out += [len(cache), cache.stats()]
    assert out[3] == 0 and cache.clears == 1
    return out


def _drill_poison(pkg):
    _, hc, _, keccak, _ = pkg
    cache = hc.TrieNodeCache(injector=hc.HotStateFaultInjector(poison_every=2))
    rlp = b"\xcd" * 40
    cache.put(hc.ACCOUNT_OWNER, b"\x02", rlp)
    h = keccak(rlp)
    out = []
    for _ in range(5):
        out += [cache.lookup(hc.ACCOUNT_OWNER, b"\x02", h), cache.stats()]
    assert out[0::2] == [rlp, None, rlp, None, rlp]
    assert cache.poison_caught == 2 and cache.injector.poisons == 2
    return out


def _drill_reveal_through(pkg):
    mod, hc, _, _, _ = pkg
    keys = _keys(50)
    truth = mod.SparseTrie()
    for i, k in enumerate(keys):
        truth.update(k, rlp_encode((i + 1).to_bytes(4, "big")))
    _commit(pkg, _committer(pkg), [truth])
    cache = hc.TrieNodeCache(injector=None)
    out = [cache.harvest(truth, hc.ACCOUNT_OWNER, keys), cache.stats()]
    assert out[0] > 0
    blind = mod.SparseTrie(root_hash=truth.root_hash)
    for i, k in enumerate(keys):
        assert cache.reveal_through(blind, hc.ACCOUNT_OWNER, k)
        assert blind.get(k) == rlp_encode((i + 1).to_bytes(4, "big"))
    out += [cache.stats(), blind.stamped, blind.revealed_count()]
    assert cache.hits > 0 and cache.stale_drops == 0
    cache.clear("test")
    out += [cache.reveal_through(mod.SparseTrie(root_hash=truth.root_hash), hc.ACCOUNT_OWNER,
                                 keys[0]), cache.stats()]
    assert out[-2] is False
    return out


_DRILLS = {"versions_coexist": _drill_versions, "version_cap_and_trim": _drill_cap_and_trim,
           "clear_and_owner_isolation": _drill_clear_and_owners, "poison_caught": _drill_poison,
           "reveal_through": _drill_reveal_through}


@pytest.mark.parametrize("drill", sorted(_DRILLS))
def test_cache_drill_matches_reference(drill):
    """The same operations on both caches: the same served entries and the
    same stats() after each."""
    assert _DRILLS[drill](PORT) == _DRILLS[drill](REF)


def test_cache_env_knobs_match_reference():
    env = {"RETH_TPU_FAULT_HOTSTATE_POISON": "3", "RETH_TPU_FAULT_HOTSTATE_EVICT_STORM": "1",
           "RETH_TPU_HOT_STATE": "1", "RETH_TPU_HOT_CACHE_ENTRIES": "77"}
    for hc in (phc, jhc):
        inj = hc.HotStateFaultInjector.from_env(env)
        assert (inj.poison_every, inj.evict_storm) == (3, True)
        assert hc.HotStateFaultInjector.from_env({}) is None
        assert hc.hot_state_enabled(env) and not hc.hot_state_enabled({})
        assert hc.TrieNodeCache.from_env(env).max_entries == 77
    assert phc.ACCOUNT_OWNER == jhc.ACCOUNT_OWNER == b""
    for fc in (pfc, jfc):
        a = fc.DigestArena.from_env({"RETH_TPU_HOT_ARENA_ROWS": "5000",
                                     "RETH_TPU_HOT_ARENA_EPOCHS": "3"})
        assert (a.max_rows, a.max_epoch_age) == (5000, 3)


# -- stamping and the cache's hooks on SparseTrie ------------------------------


def _truth(pkg, seed: int, n: int = 120):
    mod = pkg[0]
    rng = np.random.default_rng(seed)
    keys = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(n)]
    t = mod.SparseTrie()
    for k in keys:
        t.update(k, bytes(rng.integers(1, 256, int(rng.integers(1, 40)), dtype=np.uint8)))
    _commit(pkg, _committer(pkg), [t])
    return t, keys


def _encoded(mod, node):
    """A node as comparable data: its kind and, when hashable, its RLP."""
    if node is None:
        return None
    if isinstance(node, mod._Blind):
        return ("blind", node.hash)
    return (type(node).__name__, mod._encode_rlp(node) if mod._children_ready(node) else None)


def _hooks(pkg, seed: int):
    mod = pkg[0]
    truth, keys = _truth(pkg, seed)
    rng = np.random.default_rng(seed + 1)
    out = []
    # node_at / blind_hash_at on a fully revealed trie and on a blind one
    paths = [bytes(rng.integers(0, 16, int(rng.integers(0, 5)), dtype=np.uint8))
             for _ in range(40)] + [bytes(mod.unpack_nibbles(k)[:d]) for k in keys[:10]
                                    for d in (0, 1, 2, 3)]
    blind = mod.SparseTrie(root_hash=truth.root_hash)
    for p in paths:
        out.append((_encoded(mod, truth.node_at(p)), truth.blind_hash_at(p),
                    blind.blind_hash_at(p)))
    # harvest_spine over every key of the committed trie
    spine, seen = [], set()
    for k in keys:
        truth.harvest_spine(k, spine, seen)
    out.append(spine)
    # a stamped reveal from one key's proof, then the rest by reveal_at
    blind.stamp_reveals = True
    blind.reveal(truth.spine(keys[0]))
    out.append((blind.stamped, blind.revealed_count()))
    fetched = 0
    for k in keys[1:30]:
        while True:
            try:
                blind.get(k)
                break
            except mod.BlindedNodeError as e:
                path = bytes(e.path)
                node = truth.node_at(path)
                assert not blind.reveal_at(path, b"\x80" * 40)  # a wrong RLP never splices
                assert blind.reveal_at(path, mod._encode_rlp(node))
                fetched += 1
    out.append((fetched, blind.stamped, blind.revealed_count()))
    # a stamped reveal keeps the unmutated nodes clean through a commit
    blind.update(keys[1], b"\x42" * 20)
    (root,) = _commit(pkg, _committer(pkg), [blind])
    out.append((root, blind.revealed_count()))
    # an unstamped reveal of the same proofs marks nothing
    plain = mod.SparseTrie(root_hash=truth.root_hash)
    plain.reveal([r for k in keys[:5] for r in truth.spine(k)])
    out.append((plain.stamped, plain.revealed_count(), plain.root._ref))
    return out


@pytest.mark.parametrize("seed", [3, 4])
def test_hooks_and_stamping_match_reference(seed):
    """node_at, blind_hash_at, reveal_at, harvest_spine and stamped reveals
    on seeded tries: equal outputs, RLP and stamped counts."""
    assert _hooks(PORT, seed) == _hooks(REF, seed)


def test_state_stamping_propagates_like_reference():
    outs = []
    for mod in (ts, js):
        st = mod.SparseStateTrie()
        st.storage_trie(b"\x01" * 32)
        st.set_stamping(True)
        st.storage_trie(b"\x02" * 32)
        st.reveal_storage(b"\x03" * 32, b"\x05" * 32, [])
        outs.append(sorted((k, t.stamp_reveals) for k, t in st.storage_tries.items())
                    + [st.account_trie.stamp_reveals, st.stamp_reveals])
    assert outs[0] == outs[1]
    assert all(s for _, s in outs[0][:3])


# -- resident holes in the templates -------------------------------------------


def test_resident_templates_match_reference():
    """A blind or clean child whose hash is resident becomes a hole spliced
    from its slot: the same templates and holes in both packages."""
    outs = []
    for pkg in (PORT, REF):
        mod = pkg[0]
        truth, keys = _truth(pkg, 9, n=60)
        blind = mod.SparseTrie(root_hash=truth.root_hash)
        blind.stamp_reveals = True
        blind.reveal([r for k in keys[:8] for r in truth.spine(k)])
        resident = {}
        for i, r in enumerate(r for k in keys[:20] for r in truth.spine(k)):
            resident.setdefault(mod.keccak256(r), i + 1)
        out = []
        stack = [blind.root]
        while stack:
            node = stack.pop()
            if node is None or isinstance(node, mod._Blind):
                continue
            for res in (None, lambda h: resident.get(h, 0)):
                out.append(mod._node_template_sparse(node, {}, res))
            if isinstance(node, mod._Branch):
                stack.extend(node.children)
            elif isinstance(node, mod._Ext):
                stack.append(node.child)
        outs.append(out)
    assert outs[0] == outs[1]
    assert any(holes for _t, holes in outs[0])


# -- the randomized differential: cached + arena vs uncached -------------------


def _apply_with_reveals(mod, blind, twin, cache, owner, fn, counters):
    """One mutation, unblinding on demand: the cache first (validated),
    else the twin's node RLP as the simulated proof fetch."""
    for _ in range(400):
        try:
            return fn()
        except mod.BlindedNodeError as e:
            path = bytes(e.path)
            h = blind.blind_hash_at(path)
            rlp = cache.lookup(owner, path, h) if h is not None else None
            if rlp is not None and blind.reveal_at(path, rlp):
                counters["cache"] += 1
                continue
            node = twin.node_at(path)
            assert node is not None, "twin missing a node the blind needs"
            assert blind.reveal_at(path, mod._encode_rlp(node))
            counters["fetch"] += 1
    raise AssertionError("reveal loop did not converge")


def _differential(pkg, seed: int):
    """The reference's differential stream (tests/test_hotstate.py): two
    alternating sibling forks, each block revealed into a blind trie from
    the cache or the fork's twin, committed (through the arena on odd
    seeds), checked against the twin (and, in the reference's run, a
    from-scratch rebuild), then absorbed into the cache. Returns per round
    (root, arena snapshot, arena stats) and the final counters."""
    mod, hc, fc, _, _ = pkg
    rng = random.Random(0x407E + seed)
    keys = _keys(36, salt=seed)
    cache = hc.TrieNodeCache(injector=None)
    arena = fc.DigestArena(max_rows=1 << 12) if seed % 2 else None
    hot, cold = _committer(pkg, arena), _committer(pkg)
    counters = {"cache": 0, "fetch": 0}
    forks = {f: {"state": {}, "root": None, "twin": mod.SparseTrie()} for f in "AB"}
    rounds = []
    for rnd in range(14):
        fork = forks["AB"[rnd % 2] if rng.random() < 0.8 else rng.choice("AB")]
        blind = mod.SparseTrie() if fork["root"] is None else mod.SparseTrie(fork["root"])
        blind.stamp_reveals = True
        ops = []
        if fork["state"] and rng.random() < 0.08:
            ops.append(("wipe", None, None))
        else:
            present = list(fork["state"])
            for k in rng.sample(keys, rng.randint(3, 9)):
                if k in fork["state"] and rng.random() < 0.35:
                    ops.append(("del", k, None))  # sibling-collapse deletes
                else:
                    ops.append(("set", k, rlp_encode(rng.randbytes(rng.randint(1, 48)))))
            if present and rng.random() < 0.5:
                ops.append(("del", rng.choice(present), None))
        for op, k, v in ops:
            if op == "wipe":
                blind = mod.SparseTrie()
                blind.stamp_reveals = True
                fork["twin"], fork["state"] = mod.SparseTrie(), {}
                cache.drop_owner(hc.ACCOUNT_OWNER)
                continue
            fn = ((lambda k=k, v=v: blind.update(k, v)) if op == "set"
                  else (lambda k=k: blind.delete(k)))
            _apply_with_reveals(mod, blind, fork["twin"], cache, hc.ACCOUNT_OWNER, fn, counters)
        for op, k, v in ops:
            if op == "set":
                fork["twin"].update(k, v)
                fork["state"][k] = v
            elif op == "del":
                fork["twin"].delete(k)
                fork["state"].pop(k, None)
        (hot_root,) = _commit(pkg, hot, [blind])
        (cold_root,) = _commit(pkg, cold, [fork["twin"]])
        assert hot_root == cold_root, f"round {rnd}: cached diverged"
        if mod is js:  # the port's roots are held against these
            scratch = mod.SparseTrie()
            for k, v in fork["state"].items():
                scratch.update(k, v)
            assert scratch.root_hash_compute(pkg[4]) == cold_root
        rounds.append((hot_root, None if arena is None else arena.snapshot(),
                       None if arena is None else _arena_stats(hot)))
        changed = [k for op, k, _ in ops if op != "wipe"]
        for k in changed:
            cache.invalidate_key(hc.ACCOUNT_OWNER, k)
        cache.harvest(blind, hc.ACCOUNT_OWNER, changed)
        fork["root"] = hot_root
    assert counters["cache"] > 0, "cache never served a reveal"
    if arena is not None:
        assert arena.leaked_rows() == 0 and arena.snapshot()["delta_epochs"] > 0
    return rounds, counters, cache.stats()


@pytest.mark.parametrize("seed", range(1, 11))
def test_differential_cached_arena_vs_uncached_matches_reference(seed):
    """The reference's 10-seed differential on both packages (the arena on
    odd seeds): every round's root, arena snapshot and arena stats
    (staged_rows, stamped_rows, delta_fraction, arena_fresh) equal, and
    each root equal to the uncached twin's and a from-scratch rebuild's."""
    got, want = _differential(PORT, seed), _differential(REF, seed)
    assert got == want


# -- the arena finish over a state's many tries -------------------------------


def test_state_arena_blocks_match_reference():
    """tests/_torch_helpers.py's sparse state (storage tries and their
    accounts) committed through the arena: a full epoch, then delta epochs
    of seeded blocks. The same roots, snapshots and stats; branch exports
    of the account trie equal."""
    outs = []
    for pkg in (PORT, REF):
        mod, _, fc, _, _ = pkg
        st, owners, keys = sparse_state(mod, 21, tries=6, slots=16)
        arena = fc.DigestArena()
        c = _committer(pkg, arena, workers=2)
        out = []
        for block in range(4):
            if block:
                sparse_block(st, owners, keys, seed=100 + block)
            root = st.root(pkg[4], committer=c)
            updates = mod.export_branch_updates(st.account_trie, owners)
            out.append((root, arena.snapshot(), _arena_stats(c),
                        {p: None if b is None else branches({p: b})[p]
                         for p, b in updates.items()}))
        outs.append(out)
    assert outs[0] == outs[1]
    snap = outs[0][-1][1]
    assert (snap["full_epochs"], snap["delta_epochs"], snap["faults"]) == (1, 3, 0)
    assert snap["resident_hits"] > 0 and snap["leaked_rows"] == 0


# -- arena drills --------------------------------------------------------------


def _arena_rounds(pkg, committer, trie, keys, rng, rounds=6):
    roots = []
    for _ in range(rounds):
        for k in rng.sample(keys, 6):
            trie.update(k, rlp_encode(rng.randbytes(20)))
        roots.append(_commit(pkg, committer, [trie])[0])
    return roots


@pytest.mark.parametrize("drill", ["eviction", "evict_storm"])
def test_arena_drill_matches_reference(drill, monkeypatch):
    """eviction: a row budget makes begin_epoch evict, the next epoch is a
    full upload. evict_storm: RETH_TPU_FAULT_HOTSTATE_EVICT_STORM=1, every
    epoch full. Both packages: the same roots (equal to a classic twin's)
    and the same snapshots; no row leaks."""
    if drill == "evict_storm":
        monkeypatch.setenv("RETH_TPU_FAULT_HOTSTATE_EVICT_STORM", "1")
    outs = []
    for pkg in (PORT, REF):
        mod, _, fc, _, _ = pkg
        keys = _keys(48, salt=77)
        arena = fc.DigestArena()
        if drill == "eviction":
            arena.max_rows = 24  # the constructor floors at 1024
        hot, cold = _committer(pkg, arena), _committer(pkg)
        hot_roots = _arena_rounds(pkg, hot, mod.SparseTrie(), keys, random.Random(11), 8)
        cold_roots = _arena_rounds(pkg, cold, mod.SparseTrie(), keys, random.Random(11), 8)
        assert hot_roots == cold_roots
        assert arena.leaked_rows() == 0
        outs.append((hot_roots, arena.snapshot()))
    assert outs[0] == outs[1]
    snap = outs[0][1]
    if drill == "eviction":
        assert snap["evictions"] >= 1 and snap["full_epochs"] >= 2
    else:
        assert snap["delta_epochs"] == 0 and snap["full_epochs"] == 8


@pytest.mark.parametrize("when", ["delta", "fresh"])
def test_arena_fault_reruns_the_commit(when):
    """A launch that raises inside an epoch (delta, or the first full one):
    one fault and one eviction, the same commit's root from the classic
    finish (equal to the reference's), and the next commits back on a full
    epoch and then on delta. The arena's engine is on the committer's
    device with its ladder off."""
    keys = _keys(40, salt=5)
    arena = pfc.DigestArena()
    hot = _committer(PORT, arena)
    trie, twin = ts.SparseTrie(), js.SparseTrie()
    want = _committer(REF)

    def block(lo, hi, tag):
        for k in keys[lo:hi]:
            trie.update(k, rlp_encode(tag + k[:8]))
            twin.update(k, rlp_encode(tag + k[:8]))

    def explode(*_a, **_kw):
        raise RuntimeError("injected launch fault")

    block(0, 12, b"\x01")
    if when == "fresh":
        real = pfc.subtrie_levels
        pfc.subtrie_levels = explode
        try:
            (got,) = _commit(PORT, hot, [trie])
        finally:
            pfc.subtrie_levels = real
        assert "arena_fresh" not in hot.last  # the classic finish ran
    else:
        (got,) = _commit(PORT, hot, [trie])
        eng = arena.engine
        assert (eng.ladder, eng.device, eng.k) == (False, hot.device, 8)
        block(12, 24, b"\x02")
        eng._run_chunks = explode
        (got,) = _commit(PORT, hot, [trie])
    assert got == _commit(REF, want, [twin])[0]
    snap = arena.snapshot()
    assert (snap["faults"], snap["evictions"], arena.engine, arena.leaked_rows()) == \
        (1, 1, None, 0)
    for i, (lo, tag) in enumerate(((24, b"\x03"), (30, b"\x04"))):
        block(lo, lo + 6, tag)
        (got,) = _commit(PORT, hot, [trie])
        assert got == _commit(REF, want, [twin])[0]
        assert hot.last["arena_fresh"] is (i == 0)
    assert arena.snapshot()["faults"] == 1 and arena.leaked_rows() == 0


def test_arena_contention_takes_the_classic_finish():
    """Another finish holds the arena: this one takes the classic finish,
    counts one contention and leaves the arena untouched."""
    arena = pfc.DigestArena()
    c = _committer(PORT, arena)
    t = ts.SparseTrie()
    for k in _keys(20, salt=3):
        t.update(k, b"\x05" * 30)
    assert arena.try_acquire()
    try:
        (root,) = _commit(PORT, c, [t])
    finally:
        arena.release()
    j = js.SparseTrie()
    for k in _keys(20, salt=3):
        j.update(k, b"\x05" * 30)
    assert root == j.root_hash_compute(jhash)
    assert arena.snapshot()["contended"] == 1 and arena.epoch == 0
    assert "arena_fresh" not in c.last


def test_injected_sparse_abort_keeps_its_meaning_under_the_arena():
    arena = pfc.DigestArena()
    c = ts.ParallelSparseCommitter(workers=1, arena=arena, device="cpu",
                                   injector=ts.SparseFaultInjector(abort_at=1))
    t = ts.SparseTrie()
    t.update(b"\x11" * 32, b"v1" * 20)
    with pytest.raises(ts.InjectedSparseAbort):
        c.commit([t], phash)
    assert arena.faults == 1 and arena.leaked_rows() == 0


# -- the engine's delta protocol -----------------------------------------------


def test_begin_delta_precondition_raises_arena_fault():
    eng = pfc.SubtrieFusedEngine(min_tier=64, k=8, device="cpu")
    with pytest.raises(pfc.ArenaFault):
        eng.begin_delta(10)  # no resident buffer yet
    eng.begin(10)
    eng.dispatch_packed(*arena_level(np.random.default_rng(1), 4, 1))
    eng.peek_slots(np.arange(1, 5))
    eng._mode = "perlevel"
    with pytest.raises(pfc.ArenaFault):
        eng.begin_delta(10)  # off the fused rung


def test_peek_keeps_the_buffer_and_growth_keeps_resident_rows():
    """peek_slots reads back exactly the rows asked for and keeps the
    buffer; a delta commit past the buffer's size copy-grows it with every
    resident row intact, and its holes read rows an earlier commit wrote.
    The buffer equals one engine committing every level at once (the plain
    version of the same chunks)."""
    rng = np.random.default_rng(4)
    eng = pfc.SubtrieFusedEngine(min_tier=64, k=8, device="cpu")
    one = pfc.SubtrieFusedEngine(min_tier=64, k=8, device="cpu")
    lv1 = arena_level(rng, 40, 1)
    lv2 = arena_level(rng, 30, 41, srcs=range(1, 41))
    eng.begin(70)
    one.begin(300)
    for lv in (lv1, lv2):
        eng.dispatch_packed(*lv)
        one.dispatch_packed(*lv)
    got = eng.peek_slots(np.arange(1, 71))
    assert got.shape == (70, 32) and eng._buf is not None and eng.pinned_bytes() == 0
    before = eng._buf.clone()
    assert before.shape[0] == 128 and eng.growths == 0
    lv3 = arena_level(rng, 200, 71, srcs=range(1, 71))  # holes read the earlier commit's rows
    eng.begin_delta(270)
    assert eng._buf.shape[0] == 512 and eng.growths == 1 and eng.grown_bytes == 128 * 32
    assert bool((eng._buf[:128] == before).all())
    assert (eng.dispatches, eng.uploads, eng.staged_u8_bytes, eng.levels_staged) == (0, 0, 0, 0)
    eng.dispatch_packed(*lv3)
    one.dispatch_packed(*lv3)
    got3 = eng.peek_slots(np.arange(71, 271))
    want = one.finish()
    assert np.array_equal(got3, want[71:271])
    assert np.array_equal(got, want[1:71])
    assert np.array_equal(eng._buf.numpy()[:271], want[:271])
    assert eng.dispatches == 1 and eng.levels_staged == 1 and eng.grow_ms() == 0.0


def test_delta_launch_fault_raises_even_with_the_ladder_armed():
    eng = pfc.SubtrieFusedEngine(min_tier=64, k=8, device="cpu", ladder=True)
    rng = np.random.default_rng(2)
    eng.begin(8)
    eng.dispatch_packed(*arena_level(rng, 4, 1))
    eng.peek_slots(np.arange(1, 5))
    eng.begin_delta(8)
    eng.dispatch_packed(*arena_level(rng, 4, 5, srcs=range(1, 5)))

    def explode(*_a, **_kw):
        raise RuntimeError("injected launch fault")

    eng._run_chunks = explode
    with pytest.raises(RuntimeError, match="injected"):
        eng.peek_slots(np.arange(5, 9))
    assert eng.mode == "fused"
