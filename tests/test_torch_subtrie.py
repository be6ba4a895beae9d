"""The port's staged engines (reth_tpu_torch/ops/fused_commit.py
MegaFusedEngine, SubtrieFusedEngine) and its TurboCommitter's engine choice
against the JAX package's under JAX_PLATFORMS=cpu. The port runs on
device="cpu" (kernels 2-4 through their plain versions). Tolerance zero:
digest buffers are compared from slot 1 (the JAX engines aim padding rows
at dummy slot 0), dispatch and staged-level counts exactly, roots and
branch nodes field-wise."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_helpers import (EDGE_SRC, branches, edge_chain, level_b_tier, prefix_jobs, staged_chunks,
                            threshold_chain)
from reth_tpu.ops import fused_commit as jfc
from reth_tpu.primitives.keccak import keccak256
from reth_tpu.trie.turbo import TurboCommitter as JaxTurbo
from reth_tpu_torch.ops import fused_commit as fc
from reth_tpu_torch.primitives.rlp import rlp_encode
from reth_tpu_torch.trie import turbo as tturbo
from reth_tpu_torch.trie.turbo import TurboCommitter


def _levels():
    """Real levels of a sweep: packed levels with holes, branch levels."""
    return tturbo.sweep_levels(prefix_jobs(400, seed=11), collect_branches=True, start_depth=2)


def _max_slot(levels):
    return max([int(lv.row_slot.max()) for lv in levels if len(lv.row_slot)]
               + [int(lv.bmp_slot.max()) for lv in levels if len(lv.bmp_slot)])


def _drive(eng, levels, flush_every: int = 0):
    """Stage ``levels`` (deepest first), flushing every ``flush_every``
    levels when asked, and fetch the whole digest buffer."""
    eng.begin(_max_slot(levels))
    for i, lv in enumerate(levels):
        eng.dispatch_packed(lv.flat, lv.row_off, lv.row_len, lv.row_slot, lv.holes, lv.b_tier)
        eng.dispatch_branch(lv.masks, lv.bmp_slot, lv.children)
        if flush_every and (i + 1) % flush_every == 0:
            eng.flush_window()
    return eng.finish()


def _jax_subtrie(k):
    return jfc.SubtrieFusedEngine(min_tier=8, k=k, row_floor=32, hole_floor=32)


def _same_buffers(got, want):
    assert got.shape == want.shape
    assert np.array_equal(got[1:], want[1:])


def test_mega_engine_matches_jax_mega_engine():
    levels = _levels()
    assert any(lv.holes is not None for lv in levels) and any(len(lv.masks) for lv in levels)
    want = _drive(jfc.MegaFusedEngine(min_tier=64), levels)
    eng = fc.MegaFusedEngine(min_tier=64, device="cpu")
    got = _drive(eng, levels)
    _same_buffers(got, want)
    staged = sum((len(lv.row_slot) > 0) + (len(lv.masks) > 0) for lv in levels)
    assert eng.dispatches == staged
    assert eng.uploads == 2  # one flush at the terminal fetch: bytes + indices
    assert eng.staged_u8_bytes == sum(lv.flat.nbytes + 4 * len(lv.masks) for lv in levels)


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("flush_every", [0, 3])
def test_subtrie_engine_matches_jax_subtrie_engine(k, flush_every):
    levels = _levels()
    jax_eng = _jax_subtrie(k)
    want = _drive(jax_eng, levels, flush_every)
    eng = fc.SubtrieFusedEngine(min_tier=8, k=k, device="cpu")
    got = _drive(eng, levels, flush_every)
    _same_buffers(got, want)
    assert eng.levels_staged == jax_eng.levels_staged
    assert eng.dispatches == jax_eng.dispatches
    flushes = -(-len(levels) // flush_every) if flush_every else 1
    assert eng.uploads == 2 * flushes
    if k > 1:
        assert eng.dispatches < eng.levels_staged


def _packed_one(eng, data: bytes, holes=None, b_tier: int = 1) -> int:
    slot = eng.alloc_slot()
    eng.dispatch_packed(np.frombuffer(data, np.uint8), np.zeros((1,), np.uint32),
                        np.array([len(data)], np.uint32), np.array([slot], np.int32),
                        holes, b_tier)
    return slot


@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("engine", ["port", "jax"])
def test_parent_composition_within_and_across_chunks(engine, k):
    """A child flushed in one window (read back from the resident buffer);
    its parent and grandparent staged in the next, in one chunk (the
    grandparent reads what the step before it wrote)."""
    eng = (fc.SubtrieFusedEngine(min_tier=8, k=k, device="cpu") if engine == "port"
           else _jax_subtrie(k))
    eng.begin(8)
    child = b"\x55" * 44
    s_child = _packed_one(eng, child)
    eng.flush_window()  # the child lands in the resident buffer
    prefix = b"\xc0" * 7
    tmpl = prefix + b"\xa0" + b"\x00" * 32
    hole = lambda src: np.array([[0], [len(prefix) + 1], [src]], np.int32)  # noqa: E731
    s_mid = _packed_one(eng, tmpl, hole(s_child))
    s_top = _packed_one(eng, tmpl, hole(s_mid))
    d = eng.finish()
    mid = keccak256(prefix + b"\xa0" + keccak256(child))
    assert d[s_child].tobytes() == keccak256(child)
    assert d[s_mid].tobytes() == mid
    assert d[s_top].tobytes() == keccak256(prefix + b"\xa0" + mid)
    assert (eng.levels_staged, eng.dispatches) == (3, 2)


@pytest.mark.parametrize("engine", ["port", "jax"])
def test_long_row_level_runs_in_a_chunk_of_its_own(engine):
    """A level with a 1,100-byte row (9 rate blocks, block tier 16 > 8)
    between two short levels, the upper one splicing its digest."""
    eng = (fc.SubtrieFusedEngine(min_tier=8, k=8, device="cpu") if engine == "port"
           else _jax_subtrie(8))
    eng.begin(8)
    rng = np.random.default_rng(3)
    short = rng.integers(0, 256, size=40, dtype=np.uint8).tobytes()
    long_row = bytearray(rng.integers(0, 256, size=1100, dtype=np.uint8).tobytes())
    s_short = _packed_one(eng, short)
    s_long = _packed_one(eng, bytes(long_row), np.array([[0], [1050], [s_short]], np.int32),
                         b_tier=16)
    parent = b"\xe2" + b"\xa0" + b"\x00" * 32
    s_parent = _packed_one(eng, parent, np.array([[0], [2], [s_long]], np.int32))
    d = eng.finish()
    long_row[1050:1082] = keccak256(short)
    assert d[s_long].tobytes() == keccak256(bytes(long_row))
    assert d[s_parent].tobytes() == keccak256(parent[:2] + keccak256(bytes(long_row)))
    assert (eng.levels_staged, eng.dispatches) == (3, 3)


def _job(n: int, seed: int):
    """tests/test_subtrie_fused.py's _turbo_differential job."""
    r = np.random.default_rng(seed)
    keys = r.integers(0, 256, (n, 32), dtype=np.uint8)
    vals = [rlp_encode(bytes(r.integers(0, 256, size=int(r.integers(1, 60)), dtype=np.uint8)))
            for _ in range(n)]
    return keys, vals


@pytest.mark.parametrize("mode", ["many", "pipelined"])
@pytest.mark.parametrize("k", [0, 4])
def test_turbo_subtrie_levels_match_jax_turbo(k, mode):
    jobs = [_job(n, 10 + i) for i, n in enumerate((130, 50, 9, 1))]
    jax_dev = JaxTurbo(backend="device", min_tier=16, subtrie_levels=k)
    port = TurboCommitter(backend="device", min_tier=16, subtrie_levels=k, device="cpu")
    if mode == "many":
        want = jax_dev.commit_hashed_many(jobs, collect_branches=True)
        got = port.commit_hashed_many(jobs, collect_branches=True)
    else:
        want = jax_dev.commit_hashed_pipelined(jobs, collect_branches=True, jobs_per_sweep=2)
        got = port.commit_hashed_pipelined(jobs, collect_branches=True, jobs_per_sweep=2)
    assert [r.root for r in got] == [r.root for r in want]
    assert [branches(r.branch_nodes) for r in got] == [branches(r.branch_nodes) for r in want]


@pytest.mark.parametrize("arg,env,kind,k", [
    (None, None, "mega", None), (None, "", "mega", None), (None, "1", "mega", None),
    (None, "4", "subtrie", 4), (0, "4", "mega", None), (8, None, "subtrie", 8),
    (2, "0", "subtrie", 2),
])
def test_engine_selection(monkeypatch, arg, env, kind, k):
    if env is None:
        monkeypatch.delenv("RETH_TPU_SUBTRIE_LEVELS", raising=False)
    else:
        monkeypatch.setenv("RETH_TPU_SUBTRIE_LEVELS", env)
    port = TurboCommitter(subtrie_levels=arg, device="cpu")
    ref = JaxTurbo(subtrie_levels=arg)
    assert port.subtrie_levels == ref.subtrie_levels
    eng, ref_eng = port._make_backend(), ref._make_backend()
    assert type(eng).__name__ == type(ref_eng).__name__
    assert type(eng) is (fc.SubtrieFusedEngine if kind == "subtrie" else fc.MegaFusedEngine)
    if k is not None:
        assert eng.k == ref_eng.k == k


@pytest.mark.parametrize("env", [None, "", "0", "5"])
def test_subtrie_engine_default_k_follows_jax(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("RETH_TPU_SUBTRIE_LEVELS", raising=False)
    else:
        monkeypatch.setenv("RETH_TPU_SUBTRIE_LEVELS", env)
    assert fc.SubtrieFusedEngine(device="cpu").k == jfc.SubtrieFusedEngine().k


@pytest.mark.parametrize("engine,wrapper", [("mega", "packed_level"), ("mega", "branch_level"),
                                            ("subtrie", "subtrie_levels")])
def test_failed_launch_raises_out_of_finish(monkeypatch, engine, wrapper):
    """No journal replay and no fall to another path: the launch's error
    leaves finish() as it is, after one attempt."""
    calls = []

    def failing(*args):
        calls.append(args)
        raise RuntimeError(f"{wrapper}: CUDA error 719 at launch")

    monkeypatch.setattr(fc, wrapper, failing)
    for name in {"packed_level", "branch_level", "subtrie_levels"} - {wrapper}:
        monkeypatch.setattr(fc, name, lambda *a: None)
    eng = (fc.MegaFusedEngine(min_tier=8, device="cpu") if engine == "mega"
           else fc.SubtrieFusedEngine(min_tier=8, k=8, device="cpu"))
    levels = _levels()
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        _drive(eng, levels)
    assert len(calls) == 1


def test_subtrie_levels_rejects_malformed_arguments():
    buf = torch.zeros((8, 32), dtype=torch.uint8)
    u8 = torch.zeros(64, dtype=torch.uint8)
    steps = torch.zeros((1, fc._PARAM_W), dtype=torch.int64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fc.subtrie_levels(u8[8:40], u8, steps, [1], buf)
    with pytest.raises(ValueError, match="steps"):
        fc.subtrie_levels(u8, u8, steps.int(), [1], buf)
    with pytest.raises(ValueError, match="uint8"):
        fc.subtrie_levels(u8.view(torch.int32), u8, steps, [1], buf)
    with pytest.raises(ValueError, match="one count per step"):
        fc.subtrie_levels(u8, u8, steps, [1, 2], buf)
    before = fc.subtrie_levels.launches
    fc.subtrie_levels(u8, u8, steps[:0], [], buf)  # an empty chunk launches nothing
    assert fc.subtrie_levels.launches == before and not buf.any()


@pytest.fixture(scope="module")
def edge_chain_per_level():
    """The edge chain and its digest buffer, the levels dispatched one at a
    time by the port's FusedLevelEngine (held against the JAX engine on
    each edge level by tests/test_torch_level_edges.py)."""
    levels, rows = edge_chain()
    eng = fc.FusedLevelEngine(min_tier=8, device="cpu")
    eng.begin_from(torch.zeros((rows, 32), dtype=torch.uint8))
    for kind, args in levels:
        if kind == "packed":
            eng.dispatch_packed(*args, b_tier=level_b_tier(kind, args))
        else:
            eng.dispatch_branch(*args)
    return levels, eng.finish()


@pytest.mark.parametrize("k", [1, 2, 8])
def test_edge_chain_chunks_match_per_level_engine(edge_chain_per_level, k):
    """The card test's chunks (tests/test_torch_cuda.py): every edge level,
    each splicing the digests of the one before, through subtrie_levels
    chunk by chunk. The JAX staged engines do not take these levels: they
    rebuild row offsets from the row lengths, and the edge levels have gaps
    between rows and rows out of order."""
    levels, want = edge_chain_per_level
    chunks = staged_chunks(levels, k, "cpu")
    assert len(chunks) < len(levels) if k > 1 else len(chunks) == len(levels)
    buf = torch.zeros(want.shape, dtype=torch.uint8)
    for chunk in chunks:
        fc.subtrie_levels(*chunk, buf)
    assert np.array_equal(buf.numpy(), want)
    # every level wrote its slots (the first level read only zeros)
    assert (want[EDGE_SRC:] != 0).any(axis=1).all()


@pytest.fixture(scope="module")
def threshold_levels():
    return threshold_chain()


@pytest.mark.parametrize("k", [1, 2, 8])
def test_threshold_chunks_match_jax_subtrie_engine(threshold_levels, k):
    """The card test's chunks around kernel 4's path split (levels of 1, 15,
    16 and 17 rows, 1-4 block branch rows, 1-15 block packed rows, levels at
    the H100's five-lane limit and one past it, narrow steps after a wide
    one) through the port's SubtrieFusedEngine against the JAX package's."""
    levels, rows = threshold_levels
    engines = (fc.SubtrieFusedEngine(min_tier=8, k=k, device="cpu"), _jax_subtrie(k))
    bufs = []
    for eng in engines:
        eng.begin(rows)
        for kind, args in levels:
            if kind == "packed":
                eng.dispatch_packed(*args, b_tier=level_b_tier(kind, args))
            else:
                eng.dispatch_branch(*args)
        bufs.append(eng.finish())
    got, want = bufs
    assert np.array_equal(got[1:rows], want[1:rows])
    assert (got[EDGE_SRC:rows] != 0).any(axis=1).all()  # every level wrote its slots
    port, ref = engines
    assert (port.dispatches, port.levels_staged) == (ref.dispatches, ref.levels_staged)
    assert port.dispatches == {1: 9, 2: 5, 8: 3}[k]
    chunks = staged_chunks(levels, k, "cpu")
    assert [c[3].tolist() for c in chunks][-1][-2:] == ([40, 3] if k != 1 else [3])
