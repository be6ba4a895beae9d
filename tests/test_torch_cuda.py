"""Each CUDA kernel of the port against its plain PyTorch version on the
card, bit for bit. Marked ``cuda``: without a Hopper card the tests skip.
This file imports nothing of JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_helpers import (EDGE_CASES, TEMPLATE_CASES, arena_level, edge_chain,
                            edge_digest_buffer, hold_root_until_child_arrives, pipeline_chain,
                            edge_level, level_kernel_args, prefix_jobs, require_card,
                            sparse_block, sparse_state, staged_chunks, template_bucket,
                            template_buffer, template_levels, threshold_chain)
from reth_tpu_torch import convert
from reth_tpu_torch.metrics import MetricsRegistry, fused_metrics
from reth_tpu_torch.ops import fused_commit as fc
from reth_tpu_torch.ops import keccak as tk
from reth_tpu_torch.ops.supervisor import DeviceSupervisor
from reth_tpu_torch.primitives.keccak import keccak256, num_blocks_for, pad_batch
from reth_tpu_torch.primitives.types import Account
from reth_tpu_torch.trie import sparse as tsp
from reth_tpu_torch.trie import state_root as tsr
from reth_tpu_torch.trie import turbo as tturbo
from reth_tpu_torch.trie.committer import TrieCommitter


def _max_slot(levels):
    return max([int(lv.row_slot.max()) for lv in levels if len(lv.row_slot)]
               + [int(lv.bmp_slot.max()) for lv in levels if len(lv.bmp_slot)])


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    require_card()
    rng = np.random.default_rng(7)
    msgs = [bytes(rng.integers(0, 256, size=int(n), dtype=np.uint8))
            for n in list(rng.integers(0, 600, size=4096)) + [135, 136]]
    counts = np.array([num_blocks_for(m) for m in msgs], dtype=np.int32)
    w = torch.from_numpy(pad_batch(msgs, counts).view("<u4")).cuda()
    c = torch.from_numpy(counts).cuda()
    before = tk.keccak256_words_masked.launches
    got = tk.keccak256_words_masked(w, c)
    torch.cuda.synchronize()
    assert tk.keccak256_words_masked.launches == before + 1
    assert torch.equal(got, tk.keccak256_words_masked_ref(w, c))
    assert got[-1].cpu().numpy().tobytes() == keccak256(msgs[-1])


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    require_card()
    levels = tturbo.sweep_levels(prefix_jobs(3000, seed=4), start_depth=2)
    rng = np.random.default_rng(4)
    base = torch.from_numpy(rng.integers(0, 256, size=(_max_slot(levels) + 1, 32),
                                         dtype=np.uint8)).cuda()
    for lv in levels:
        b_k, b_r = base.clone(), base.clone()
        n = len(lv.row_slot)
        if n:
            holes = lv.holes if lv.holes is not None else np.zeros((3, 0), np.int32)
            order, start = fc._csr(holes[0], n)
            args = [torch.from_numpy(np.ascontiguousarray(a).astype(t)).cuda() for a, t in (
                (lv.flat, np.uint8), (lv.row_off, np.int64), (lv.row_len, np.int32),
                (lv.row_slot, np.int64), (start, np.int64), (holes[1][order], np.int32),
                (holes[2][order], np.int64))]
            fc.packed_level(*args, b_k)
            fc.packed_level_ref(*args, b_r)
        n = len(lv.masks)
        if n:
            order, start = fc._csr(lv.children[0], n)
            args = [torch.from_numpy(np.ascontiguousarray(a).astype(t)).cuda() for a, t in (
                (lv.masks, np.int32), (lv.bmp_slot, np.int64), (start, np.int64),
                (lv.children[1][order], np.int32), (lv.children[2][order], np.int64))]
            fc.branch_level(*args, b_k)
            fc.branch_level_ref(*args, b_r)
        torch.cuda.synchronize()
        assert torch.equal(b_k, b_r)


@pytest.mark.cuda
def test_level_kernels_match_plain_versions_on_edge_levels():
    require_card()
    for case in EDGE_CASES:
        kind, args = edge_level(case)
        kargs = level_kernel_args(kind, args, "cuda")
        kernel, ref = ((fc.packed_level, fc.packed_level_ref) if kind == "packed"
                       else (fc.branch_level, fc.branch_level_ref))
        b_k = torch.from_numpy(edge_digest_buffer()).cuda()
        b_r = b_k.clone()
        before = kernel.launches
        kernel(*kargs, b_k)
        ref(*kargs, b_r)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1, case
        assert torch.equal(b_k, b_r), case


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("chain", ["edge", "threshold"])
def test_subtrie_levels_matches_plain_version_on_edge_chunks(chain, k):
    """Kernel 4 on chunks of the edge levels, each level splicing digests
    the level before it wrote in the same launch (branch steps, rows of up
    to 15 rate blocks); at k=8 a last level of more rows than one pass of
    the co-resident grid. "threshold": the chunks around its path split
    (steps of 1, 15, 16 and 17 rows, at the card's five-lane limit and one
    past it, narrow steps after a wide one in one launch)."""
    require_card()
    if chain == "edge":
        extra = fc.subtrie_resident_blocks() * 128 + 1000 if k == 8 else 0
        levels, rows = edge_chain(extra)
    else:
        levels, rows = threshold_chain(fc.subtrie_lanes5_rows())
    chunks = staged_chunks(levels, k, "cuda")
    base = torch.from_numpy(np.random.default_rng(k).integers(0, 256, size=(rows, 32),
                                                              dtype=np.uint8)).cuda()
    b_k, b_r = base.clone(), base.clone()
    before = fc.subtrie_levels.launches
    for chunk in chunks:
        fc.subtrie_levels(*chunk, b_k)
        fc.subtrie_levels_ref(*chunk, b_r)
    torch.cuda.synchronize()
    assert fc.subtrie_levels.launches == before + len(chunks)
    assert torch.equal(b_k, b_r)
    assert not torch.equal(b_k, base)


@pytest.mark.cuda
def test_five_lane_permutation_matches_one_thread():
    """kernel 4's five-lane keccak-f[1600] against the one-thread one, through
    the timing probe the smoke launches (the same state, 1 and 7 rounds of
    permutations)."""
    require_card()
    lib = fc._fused_lib()
    for perms in (1, 7):
        outs = []
        for lanes5 in (0, 1):
            out = torch.zeros(25, dtype=torch.int64, device="cuda")
            assert lib.keccak_perm_probe(out.data_ptr(), perms, lanes5,
                                         torch.cuda.current_stream().cuda_stream) == 0
            outs.append(out)
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1])


# kernel 1's launch widths: below, at and above a warp, a block, and one
# 128-row block per SM of a 132-SM card
ABSORB_ROWS = (1, 31, 32, 33, 127, 128, 129, 132 * 128 - 1, 132 * 128, 132 * 128 + 1)


def _absorb_inputs(n: int, blocks: int, seed: int):
    """n messages padded to ``blocks`` rate blocks: counts 1..blocks mixed
    within every warp (most rows shorter than the padded width), the first
    rows 0, 135, 136, 271 and 272 bytes long where they fit."""
    rng = np.random.default_rng([seed, n, blocks])
    lens = rng.integers(0, blocks * 136, size=n)
    edge = [ln for ln in (0, 135, 136, 271, 272) if ln < blocks * 136]
    lens[:len(edge)] = edge[:n]
    msgs = [rng.integers(0, 256, size=int(ln), dtype=np.uint8).tobytes() for ln in lens]
    counts = np.array([num_blocks_for(m) for m in msgs], dtype=np.int32)
    words = pad_batch(msgs, counts, pad_to_blocks=blocks).view("<u4")
    return msgs, torch.from_numpy(words).cuda(), torch.from_numpy(counts).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [1, 3, 4, 16])
def test_absorb_matches_plain_and_unstaged(blocks):
    """Kernel 1 (rows staged in shared memory, sorted by count within a
    block) against its plain version and against its first design (the
    debug entry keccak256_absorb_unstaged), at every launch width of
    ABSORB_ROWS; one counted launch a call, none for the debug entry."""
    require_card()
    for n in ABSORB_ROWS:
        msgs, w, c = _absorb_inputs(n, blocks, seed=3)
        before = tk.keccak256_words_masked.launches
        got = tk.keccak256_words_masked(w, c)
        unstaged = tk.keccak256_words_masked_unstaged(w, c)
        want = tk.keccak256_words_masked_ref(w, c)
        torch.cuda.synchronize()
        assert tk.keccak256_words_masked.launches == before + 1
        assert torch.equal(got, want), (n, blocks)
        assert torch.equal(got, unstaged), (n, blocks)
        host = got.cpu().numpy()
        for i in {0, n // 2, n - 1}:
            assert host[i].tobytes() == keccak256(msgs[i]), (n, blocks, i)


@pytest.mark.cuda
def test_absorb_counts_below_width_and_clamped():
    """Counts below a row's own block count (the kernel absorbs only
    ``counts[i]`` blocks), zero counts (zero digest) and counts above the
    width (clamped to it), mixed in each warp: equal to the plain version
    and to the first design."""
    require_card()
    _, w, c = _absorb_inputs(1000, 4, seed=5)
    rng = np.random.default_rng(5)
    c = torch.from_numpy(rng.integers(0, 7, size=1000).astype(np.int32)).cuda()
    got = tk.keccak256_words_masked(w, c)
    torch.cuda.synchronize()
    assert torch.equal(got, tk.keccak256_words_masked_ref(w, c.clamp(max=4)))
    assert torch.equal(got, tk.keccak256_words_masked_unstaged(w, c))
    assert not got.view(torch.int32)[c == 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [1, 3])
def test_absorb_takes_words_at_an_odd_8_byte_offset(blocks):
    """``words`` starting 8 bytes past a 16-byte boundary (every row then
    starts 8 bytes off one at even width, every other row at odd width):
    the same digests as from an aligned copy."""
    require_card()
    msgs, w, c = _absorb_inputs(300, blocks, seed=7)
    flat = torch.empty(w.numel() + 2, dtype=torch.uint32, device="cuda")
    shifted = flat[2:].view(w.shape)
    shifted.copy_(w)
    assert shifted.data_ptr() % 16 == 8
    got = tk.keccak256_words_masked(shifted, c)
    torch.cuda.synchronize()
    assert torch.equal(got, tk.keccak256_words_masked_ref(w, c))
    with pytest.raises(ValueError):
        tk.keccak256_words_masked(flat[1:1 + w.numel()].view(w.shape), c)


@pytest.mark.cuda
def test_absorb_grid_spreads_narrow_launches():
    """Rows per block: ceil(n / SMs) in whole warps up to one full block per
    SM, so a narrow launch takes every SM; at most 128."""
    require_card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n in (1, 33, 6454, sms * 128, sms * 128 + 1, 69396, 10 ** 6):
        r = tk.absorb_rows_per_block(n, 4)
        assert r % 32 == 0 and 32 <= r <= 128, (n, r)
        if n <= sms * 128:
            assert r == max(32, (-(-n // sms) + 31) // 32 * 32), (n, r)


@pytest.mark.cuda
@pytest.mark.parametrize("case", TEMPLATE_CASES)
def test_dispatch_level_on_card_matches_cpu_and_splice_level(case):
    """The general committer's template levels on the card: one
    packed_level launch per bucket, the buffer equal to the same dispatch
    on the CPU and to ``splice_level`` on the reference's padded layout."""
    require_card()
    rng = np.random.default_rng(21)
    levels = template_levels(case, rng)
    shared = template_buffer(rng)
    out = {}
    for device in ("cpu", "cuda"):
        eng = fc.FusedLevelEngine(min_tier=64, device=device)
        eng.begin_from(convert.digest_buffer_from_numpy(shared, device))
        before = fc.packed_level.launches
        for lv in levels:
            eng.dispatch_level(template_bucket(fc._Bucket, lv, np.random.default_rng(1)))
        out[device] = eng.finish()
        if device == "cuda":
            assert fc.packed_level.launches == before + len(levels)
    assert np.array_equal(out["cuda"], out["cpu"])
    buf = torch.from_numpy(shared).cuda()
    for lv in levels:
        eng = fc.FusedLevelEngine(min_tier=64, device="cuda")
        calls, real = [], fc.packed_level
        fc.packed_level = lambda *a: calls.append(a[:-1])
        try:
            eng.begin(1)
            eng.dispatch_level(template_bucket(fc._Bucket, lv))
        finally:
            fc.packed_level = real
        fc.splice_level(*fc.padded_level(*calls[0]), buf)
    torch.cuda.synchronize()
    assert np.array_equal(buf.cpu().numpy(), out["cpu"])


@pytest.mark.cuda
def test_state_root_on_card_matches_cpu():
    """state_root through TrieCommitter(fused=True) on the card: the same
    root and branch nodes as on the CPU; its levels launch packed_level,
    its key hashing keccak256_absorb."""
    require_card()
    rng = np.random.default_rng(8)
    addrs = [bytes(a) for a in rng.integers(0, 256, size=(500, 20), dtype=np.uint8)]
    accounts = {a: Account(nonce=i + 1, balance=int(rng.integers(1, 1 << 60)))
                for i, a in enumerate(addrs)}
    storages = {a: {bytes(rng.integers(0, 256, size=32, dtype=np.uint8)): k + 1 for k in range(9)}
                for a in addrs[:40]}
    out = {}
    for device in ("cpu", "cuda"):
        committer = TrieCommitter(fused=True, device=device,
                                  hasher=tk.KeccakDevice(block_tier=4, device=device).hash_batch)
        k1, k2 = tk.keccak256_words_masked.launches, fc.packed_level.launches
        out[device] = tsr.state_root(accounts, storages, committer=committer)
        if device == "cuda":
            assert tk.keccak256_words_masked.launches > k1 and fc.packed_level.launches > k2
    assert out["cuda"][0] == out["cpu"][0]
    assert out["cuda"][1]["branch_nodes"] == out["cpu"][1]["branch_nodes"]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 8])
@pytest.mark.parametrize("seed", [3, 4])
def test_sparse_finish_on_card_matches_cpu(seed, k):
    """The live-tip finish on the card, classic (k=0: keccak256_absorb
    through KeccakDevice) and fused (k=8: subtrie_levels), against the same
    commits on device="cpu": the same roots over a baseline and two blocks,
    and the same stored branch updates of the account trie."""
    require_card()
    out = {}
    for device in ("cpu", "cuda"):
        st, owners, keys = sparse_state(tsp, seed, tries=40, slots=32)
        c = tsp.ParallelSparseCommitter(subtrie_levels=k, device=device)
        k1, k4 = tk.keccak256_words_masked.launches, fc.subtrie_levels.launches
        roots = [st.root(committer=c)]
        stored = {}
        for block in range(2):
            sparse_block(st, owners, keys, seed=seed * 10 + block)
            roots.append(st.root(committer=c))
            stored[block] = tsp.export_branch_updates(st.account_trie, owners)
        if device == "cuda":
            launched = (tk.keccak256_words_masked.launches - k1, fc.subtrie_levels.launches - k4)
            assert (launched[0] > 0, launched[1] > 0) == (k == 0, k == 8), launched
        out[device] = roots, stored
    assert out["cuda"][0] == out["cpu"][0]
    assert out["cuda"][1] == out["cpu"][1]


@pytest.mark.cuda
def test_startup_probe_is_healthy_on_card():
    """The real startup probe: the kernels built in this process, then a
    child that loads kernel 1 and hashes keccak256(b"") on the card."""
    require_card()
    sup = DeviceSupervisor(registry=MetricsRegistry(), probe_budget=300)
    assert sup.startup(), sup.last_probe.diag
    assert sup.breaker.state == "closed" and sup.last_probe.latency > 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 8])
def test_supervised_rebuild_on_card_matches_twin(monkeypatch, k):
    """TurboCommitter(backend="auto") on the card: clean, the device route
    launches its kernels with no failover; with the first chunk wedged at
    k=8, the per-level rung launches kernel 4 once a level. Roots equal the
    numpy twin's either way."""
    require_card()
    jobs = prefix_jobs(3000, seed=6)
    want = [r.root for r in tturbo.TurboCommitter(backend="numpy").commit_hashed_many(jobs, True, 2)]
    for wedge in ((0, 1) if k else (0,)):
        sup = DeviceSupervisor(registry=MetricsRegistry(), probe_fn=lambda b, injector=None: None)
        committer = tturbo.TurboCommitter(backend="auto", supervisor=sup, subtrie_levels=k)
        if wedge:
            monkeypatch.setenv("RETH_TPU_FAULT_SUBTRIE_WEDGE", "1")
        before = fc.subtrie_levels.launches + fc.packed_level.launches
        got = committer.commit_hashed_many(jobs, True, 2)
        torch.cuda.synchronize()
        assert [r.root for r in got] == want
        assert sup.failovers == 0 and sup.breaker.state == "closed"
        assert fc.subtrie_levels.launches + fc.packed_level.launches > before
        if k:
            assert fused_metrics.last["mode"] == ("perlevel" if wedge else "fused")


@pytest.mark.cuda
def test_delta_epochs_on_card_match_cpu_engine():
    """The hot-state arena's engine protocol on the card: a full epoch, then
    delta epochs whose holes read rows of earlier epochs (kernel 4 on a
    buffer it did not fill in the same commit), the last one past the
    buffer's size so that it copy-grows. Every read-back and the whole
    buffer equal the same epochs on device="cpu"; the grown buffer keeps
    every resident row; no pinned staging outlives an epoch."""
    require_card()
    out = {}
    for device in ("cpu", "cuda"):
        rng = np.random.default_rng(12)
        eng = fc.SubtrieFusedEngine(min_tier=64, k=8, device=device)
        reads, slot = [], 1
        for epoch, (n_levels, rows) in enumerate(((3, 20), (2, 15), (4, 60))):
            start = slot
            levels = []
            for _ in range(n_levels):
                srcs = range(1, slot) if slot > 1 else ()
                levels.append(arena_level(rng, rows, slot, srcs))
                slot += rows
            if epoch == 0:
                eng.begin(slot - 1)
            else:
                before = eng._buf.clone()
                eng.begin_delta(slot - 1)
                assert bool((eng._buf[:before.shape[0]] == before).all())
            k4 = fc.subtrie_levels.launches
            for lv in levels:
                eng.dispatch_packed(*lv)
            reads.append(eng.peek_slots(np.arange(start, slot)))
            assert eng.pinned_bytes() == 0 and eng._buf is not None
            if device == "cuda":
                assert fc.subtrie_levels.launches > k4
        assert eng.growths == 2  # 64 -> 128 -> 512 rows
        out[device] = reads, eng._buf.cpu().numpy()
    for got, want in zip(out["cuda"][0], out["cpu"][0]):
        assert np.array_equal(got, want)
    assert np.array_equal(out["cuda"][1], out["cpu"][1])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [5, 6])
def test_arena_finish_on_card_matches_cpu(seed):
    """ParallelSparseCommitter(arena=DigestArena()) on the card against the
    same commits on device="cpu": the same roots, arena snapshots and delta
    stats over a full epoch and three delta epochs, launching
    subtrie_levels only, with no fault."""
    require_card()
    out = {}
    for device in ("cpu", "cuda"):
        st, owners, keys = sparse_state(tsp, seed, tries=40, slots=32)
        arena = fc.DigestArena()
        c = tsp.ParallelSparseCommitter(arena=arena, device=device)
        k1, k4 = tk.keccak256_words_masked.launches, fc.subtrie_levels.launches
        rec = []
        for block in range(4):
            if block:
                sparse_block(st, owners, keys, seed=seed * 10 + block)
            root = st.root(committer=c)
            rec.append((root, arena.snapshot(), {k: c.last[k] for k in (
                "staged_rows", "stamped_rows", "delta_fraction", "arena_fresh", "hashed")}))
        if device == "cuda":
            assert tk.keccak256_words_masked.launches == k1
            assert fc.subtrie_levels.launches > k4
            assert arena.engine.device.type == "cuda" and not arena.engine.ladder
        snap = arena.snapshot()
        assert (snap["faults"], snap["full_epochs"], snap["delta_epochs"]) == (0, 1, 3)
        assert snap["resident_hits"] > 0 and arena.leaked_rows() == 0
        out[device] = rec
    assert out["cuda"] == out["cpu"]


@pytest.mark.cuda
def test_default_menu_warms_on_card():
    """Warm-up over the default menu on the card: every shape WARM, and each
    shape's step launched its kernel (kernel 1 for keccak.*, kernel 2 for
    fused.plain / fused.splice, kernel 4 for fused.subtrie)."""
    from reth_tpu_torch.ops import warmup as pw

    require_card()
    counter = {"keccak.masked": tk.keccak256_words_masked, "keccak.exact": tk.keccak256_words_masked,
               "fused.plain": fc.packed_level, "fused.splice": fc.packed_level,
               "fused.subtrie": fc.subtrie_levels}
    moved = {}

    def builder(shape):
        before = counter[shape.program].launches
        pw.build_shape(shape, "cuda")
        moved[str(shape)] = counter[shape.program].launches - before

    mgr = pw.WarmupManager(builder=builder, budget=120, attempts=1, backoff=0,
                           registry=MetricsRegistry())
    snap = mgr.run()
    assert snap["state"] == "warm" and snap["warm"] == snap["total"] == len(pw.default_menu())
    assert mgr.wedges == 0 and set(moved) == {str(s) for s in mgr.menu}
    assert all(n == 1 for n in moved.values())


@pytest.mark.cuda
def test_hash_service_on_card_matches_numpy():
    """The service's default backend (kernel 1 through KeccakDevice) on the
    card: coalesced digests bit-exact against keccak256_batch_np, fewer
    launches than requests, no replay; a window request equals the CPU
    service's buffer."""
    import threading

    from reth_tpu_torch.ops.hash_service import HashService
    from reth_tpu_torch.primitives.keccak import keccak256_batch_np

    require_card()
    svc = HashService(registry=MetricsRegistry(), window_s=0.004, subtrie_levels=8)
    rng = np.random.default_rng(11)
    reqs = [[bytes(rng.integers(0, 256, size=int(n), dtype=np.uint8))
             for n in rng.integers(1, 300, size=4)] for _ in range(256)]
    out = [None] * len(reqs)
    before = tk.keccak256_words_masked.launches

    def client(i):
        for j in range(i, len(reqs), 8):
            out[j] = svc.client(("live", "payload", "rebuild", "proof")[j % 4])(reqs[j])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    launches = tk.keccak256_words_masked.launches - before
    assert out == [keccak256_batch_np(r) for r in reqs]
    assert 0 < launches < len(reqs) and svc.replays == 0
    rows = [b"\x11" * 45, b"\x22" * 50]
    window = [{"flat": np.frombuffer(b"".join(rows), np.uint8),
               "row_off": np.array([0, 45], np.uint32), "row_len": np.array([45, 50], np.uint32),
               "slots": np.array([1, 2], np.int32), "holes": None, "b_tier": 1}]
    got = svc.client("live").commit_window(window, 2)
    svc.stop()
    cpu = HashService(backend=keccak256_batch_np, registry=MetricsRegistry(), device="cpu",
                      subtrie_levels=8)
    want = cpu.client("live").commit_window(window, 2)
    cpu.stop()
    assert got[1:3].tobytes() == want[1:3].tobytes() == keccak256(rows[0]) + keccak256(rows[1])
    assert svc.replays == 0


@pytest.mark.cuda
def test_failed_build_raises_from_service_and_warmup_on_card(monkeypatch, tmp_path):
    """A kernel build that fails (here a flag nvcc refuses, into an empty
    kernel directory) raises out of HashService(...) and out of
    WarmupManager.run(): never replayed, never parked as FAILED."""
    from reth_tpu_torch.ops import _build
    from reth_tpu_torch.ops import warmup as pw
    from reth_tpu_torch.ops.hash_service import HashService

    require_card()
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["--no-such-nvcc-flag"])
    monkeypatch.setattr(_build, "_kernel_dir", tmp_path)
    with pytest.raises(_build.BuildError):
        HashService(registry=MetricsRegistry())
    mgr = pw.WarmupManager(budget=60, attempts=1, registry=MetricsRegistry())
    with pytest.raises(_build.BuildError):
        mgr.run()
    assert mgr.wedges == 0 and pw.FAILED not in mgr.states.values()


@pytest.mark.cuda
def test_commitment_stages_on_card(monkeypatch):
    """The four commitment stages (MerkleUnwind, AccountHashing,
    StorageHashing, MerkleStage, in default_stages' order) on the card at
    20,000 accounts / 8,000 slots, chunked at 9,000 leaves: every row of the
    four hashed and trie tables equal to the numpy twin's (hashing stages,
    then the single-shot rebuild), keccak256_absorb, packed_level and
    branch_level launched and subtrie_levels not, 0 fallbacks; then one
    incremental block and its unwind, each against the twin."""
    from _torch_helpers import apply_stage_block, load_stage_state, stage_block, stage_state

    from reth_tpu_torch.primitives.keccak import keccak256_batch_np
    from reth_tpu_torch.primitives.types import Header
    from reth_tpu_torch.stages import (AccountHashingStage, MerkleStage, MerkleUnwindStage,
                                       Pipeline, StorageHashingStage)
    from reth_tpu_torch.storage import MemDb, ProviderFactory
    from reth_tpu_torch.trie.incremental import full_state_root_turbo

    require_card()
    monkeypatch.delenv("RETH_TPU_SUBTRIE_LEVELS", raising=False)
    tables = ("HashedAccounts", "HashedStorages", "AccountsTrie", "StoragesTrie")
    accounts, storages = stage_state(Account, 20_000, 8_000, seed=45)
    db, twin_db = MemDb(), MemDb()
    card, twin = ProviderFactory(db), ProviderFactory(twin_db)
    load_stage_state(card, accounts, storages, Header(number=0))
    twin_db._tables = dict(db._tables)
    tc = TrieCommitter(hasher=keccak256_batch_np, device="cpu")
    tc.turbo_backend = "numpy"
    hashing = [AccountHashingStage(tc), StorageHashingStage(tc)]
    Pipeline(twin, hashing).run(1)
    with twin.provider_rw() as p:
        header = Header(number=1, state_root=full_state_root_turbo(p, backend="numpy"))
        p.insert_header(header)
    with card.provider_rw() as p:
        p.insert_header(header)
    c = TrieCommitter(device="cuda")
    merkle = MerkleStage(c, chunk_leaves=9_000)
    stages = [MerkleUnwindStage(c), AccountHashingStage(c), StorageHashingStage(c), merkle]
    wrappers = (tk.keccak256_words_masked, fc.packed_level, fc.branch_level, fc.subtrie_levels)
    before = [w.launches for w in wrappers]
    Pipeline(card, stages).run(1)
    torch.cuda.synchronize()
    launched = [w.launches - b for w, b in zip(wrappers, before)]
    assert all(launched[:3]) and launched[3] == 0, launched
    assert merkle.fallbacks == 0
    with card.provider() as p:
        assert [p.stage_checkpoint(s.id) for s in stages] == [1, 1, 1, 1]
        assert p.stage_progress(MerkleStage.id) is None
    for name in tables:
        assert db._tables[name] == twin_db._tables[name], name
    at_block_1 = twin_db._tables
    block = stage_block(accounts, storages, 2, 45, Account)
    apply_stage_block(twin, block, 2)
    Pipeline(twin, hashing).run(2)
    with twin.provider_rw() as p:
        header = Header(number=2, state_root=MerkleStage(tc)._incremental(p, 2, 2))
        p.insert_header(header)
    apply_stage_block(card, block, 2, header)
    Pipeline(card, stages).run(2)
    for name in tables:
        assert db._tables[name] == twin_db._tables[name], name
    Pipeline(card, stages).unwind(1)
    for name in tables:
        assert db._tables[name] == at_block_1[name], name


@pytest.mark.cuda
def test_live_tip_on_card_matches_cpu():
    """The live tip on the card: a SparseRootTask with a DigestArena over a
    2,000-account database (block 2 of STAGE_BLOCK_SMALL, seven bursts, the
    proof pool) gives the incremental route's root, and the digests,
    storage roots and exported branch updates of the same task on the CPU,
    launching kernels 1 and 4; a multiproof on the card equals the CPU's."""
    from _torch_helpers import (STAGE_BLOCK_SMALL, stage_block_bursts, stage_block_output,
                                stage_pair)

    from reth_tpu_torch.engine import SparseRootTask
    from reth_tpu_torch.evm import BlockChanges, BlockExecutionOutput
    from reth_tpu_torch.trie.proof import ProofCalculator

    require_card()
    db, blocks = stage_pair(2000, 800, 5, blocks=(2,), sizes=STAGE_BLOCK_SMALL, packages=(True,))
    out = stage_block_output(blocks[2], BlockExecutionOutput, BlockChanges)
    _, factory = db.at(1)
    runs = []
    for device in ("cpu", "cuda"):
        before = (tk.keccak256_words_masked.launches, fc.subtrie_levels.launches)
        task = SparseRootTask(factory.provider(), db.roots[1], tsp.PreservedSparseTrie(),
                              TrieCommitter(device=device), provider_factory=factory.provider,
                              workers=4, arena=fc.DigestArena())
        for burst in stage_block_bursts(out, 7, seed=2):
            task.on_state_update(burst)
        root, digests, storage_roots = task.finish(out)
        torch.cuda.synchronize()
        acct, stor = task.export_updates(out, digests)
        runs.append((root, dict(digests), storage_roots, acct, stor))
        launched = (tk.keccak256_words_masked.launches - before[0],
                    fc.subtrie_levels.launches - before[1])
        assert all(launched) == (device == "cuda"), launched
        assert task.sparse_committer.arena.faults == 0
    assert runs[0] == runs[1]
    assert runs[1][0] == db.roots[2]
    targets = {a: list(out.post_storage.get(a, {}))[:3] for a in list(out.post_accounts)[:16]}
    proofs = [ProofCalculator(factory.provider(), TrieCommitter(device=device)).multiproof(targets)
              for device in ("cpu", "cuda")]
    assert proofs[0] == proofs[1]


@pytest.mark.cuda
def test_staged_sync_on_card_matches_cpu():
    """The staged-sync chain at a small size (SYNC_BLOCK_SMALL), sealed on the
    host, synced by default_stages(device="cuda") and by
    default_stages(device="cpu"): the same rows in every table after the
    sync, after an unwind to block 1 and after the re-sync, and kernel 1
    launched on the card by the consensus roots and the hashing stages."""
    import types

    from _torch_helpers import SYNC_BLOCK_SMALL, SyncChain
    from reth_tpu_torch import testing
    from reth_tpu_torch.consensus import EthBeaconConsensus
    from reth_tpu_torch.primitives import keccak as pkeccak
    from reth_tpu_torch.primitives import secp256k1, types as ptypes
    from reth_tpu_torch.primitives.keccak import keccak256_batch_np
    from reth_tpu_torch.stages import Pipeline, default_stages
    from reth_tpu_torch.storage import MemDb, ProviderFactory
    from reth_tpu_torch.storage.genesis import import_chain, init_genesis

    require_card()
    pkg = types.SimpleNamespace(testing=testing, types=ptypes, keccak=pkeccak,
                                secp256k1=secp256k1)
    chain = SyncChain(pkg, n_accounts=200, n_slots=80, seed=47, n_wallets=4, n_blocks=3,
                      sizes=SYNC_BLOCK_SMALL,
                      committer=TrieCommitter(hasher=keccak256_batch_np, device="cpu")).builder
    def rows(db):  # a table emptied by the unwind may stay as an empty map
        return {name: t for name, t in db._tables.items() if t}

    dbs, launches = {}, 0
    for device in ("cuda", "cpu"):
        db = MemDb()
        factory = ProviderFactory(db)
        before = tk.keccak256_words_masked.launches
        init_genesis(factory, chain.genesis, dict(chain.accounts_at_genesis),
                     storage=chain.storage_at_genesis, codes=chain.codes_at_genesis,
                     device=device)
        import_chain(factory, chain.blocks[1:], EthBeaconConsensus(device=device))
        pipeline = Pipeline(factory, default_stages(device=device))
        pipeline.run(chain.tip.number)
        synced = rows(db)
        pipeline.unwind(1)
        unwound = rows(db)
        pipeline.run(chain.tip.number)
        torch.cuda.synchronize()
        assert rows(db) == synced
        dbs[device] = (synced, unwound)
        if device == "cuda":
            launches = tk.keccak256_words_masked.launches - before
    assert dbs["cuda"] == dbs["cpu"]
    assert launches > 0


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["sparse", "pipelined"])
def test_engine_tree_on_card_matches_cpu(strategy):
    """The staged-sync chain at a small size (SYNC_BLOCK_SMALL), sealed on the
    host, imported by EngineTree(device="cuda") and EngineTree(device="cpu")
    (newPayload then forkchoiceUpdated each block, hot state on, persisted to
    the tip): every status VALID at the header's root, the same rows in every
    table, and the strategy's kernels launched on the card: kernel 1 on both
    strategies, kernel 4 (the hot-state arena's delta finish) on the sparse
    one."""
    import types

    from _torch_helpers import SYNC_BLOCK_SMALL, SyncChain
    from reth_tpu_torch import testing
    from reth_tpu_torch.engine import EngineTree
    from reth_tpu_torch.primitives import keccak as pkeccak
    from reth_tpu_torch.primitives import secp256k1, types as ptypes
    from reth_tpu_torch.primitives.keccak import keccak256_batch_np
    from reth_tpu_torch.storage import MemDb, ProviderFactory
    from reth_tpu_torch.storage.genesis import init_genesis

    require_card()
    pkg = types.SimpleNamespace(testing=testing, types=ptypes, keccak=pkeccak,
                                secp256k1=secp256k1)
    chain = SyncChain(pkg, n_accounts=200, n_slots=80, seed=47, n_wallets=4, n_blocks=3,
                      sizes=SYNC_BLOCK_SMALL,
                      committer=TrieCommitter(hasher=keccak256_batch_np, device="cpu")).builder
    dbs, launched = {}, {}
    for device in ("cuda", "cpu"):
        db = MemDb()
        factory = ProviderFactory(db)
        init_genesis(factory, chain.genesis, dict(chain.accounts_at_genesis),
                     storage=chain.storage_at_genesis, codes=chain.codes_at_genesis,
                     committer=TrieCommitter(hasher=keccak256_batch_np, device="cpu"))
        tree = EngineTree(factory, device=device, state_root_strategy=strategy,
                          hot_state=True, persistence_threshold=2)
        before = (tk.keccak256_words_masked.launches, fc.subtrie_levels.launches)
        for blk in chain.blocks[1:]:
            st = tree.on_new_payload(blk)
            assert (st.status.value, st.latest_valid_hash) == ("VALID", blk.hash)
            if strategy == "sparse":
                assert tree.last_sparse["strategy"] == "sparse"
            assert tree.on_forkchoice_updated(blk.hash).status.value == "VALID"
        tree.persistence_threshold = 0
        tree.on_forkchoice_updated(chain.tip.hash)
        torch.cuda.synchronize()
        assert tree.persisted_number == chain.tip.number
        assert tree.hot_arena.faults == 0
        dbs[device] = {name: t for name, t in db._tables.items() if t}
        launched[device] = (tk.keccak256_words_masked.launches - before[0],
                            fc.subtrie_levels.launches - before[1])
    assert dbs["cuda"] == dbs["cpu"]
    assert launched["cuda"][0] > 0
    assert (launched["cuda"][1] > 0) == (strategy == "sparse")


@pytest.mark.cuda
def test_torch_device_error_on_card_is_a_kernel_fault():
    """An error PyTorch raises on the card (a device mismatch against a CPU
    tensor) is a kernel fault, so no fallback of the engine swallows it."""
    require_card()
    from reth_tpu_torch.ops._build import is_kernel_fault

    with pytest.raises(RuntimeError) as info:
        torch.zeros(4, device="cuda") + torch.zeros(4)
    assert is_kernel_fault(info.value)


def _mine_witness_validate(device: str) -> dict:
    """The small sync chain's genesis and its blocks' transactions, sealed on
    the host; on ``device``: a tree with hot state (the sparse strategy),
    each block's transactions admitted through ``TxBatcher`` and mined by
    ``LocalMiner``, each mined block witnessed against its parent's overlay
    (4 proof workers) and validated by one ``StatelessChain``."""
    import types

    from _torch_helpers import SYNC_BLOCK_SMALL, SyncChain
    from reth_tpu_torch import testing
    from reth_tpu_torch.engine import EngineTree, LocalMiner, StatelessChain, generate_witness
    from reth_tpu_torch.evm import EvmConfig
    from reth_tpu_torch.pool import PoolConfig, TransactionPool, TxBatcher
    from reth_tpu_torch.primitives import keccak as pkeccak
    from reth_tpu_torch.primitives import secp256k1, types as ptypes
    from reth_tpu_torch.primitives.keccak import keccak256_batch_np
    from reth_tpu_torch.storage import MemDb, ProviderFactory
    from reth_tpu_torch.storage.genesis import init_genesis

    pkg = types.SimpleNamespace(testing=testing, types=ptypes, keccak=pkeccak,
                                secp256k1=secp256k1)
    chain = SyncChain(pkg, n_accounts=200, n_slots=80, seed=47, n_wallets=4, n_blocks=1,
                      sizes=SYNC_BLOCK_SMALL,
                      committer=TrieCommitter(hasher=keccak256_batch_np, device="cpu")).builder
    factory = ProviderFactory(MemDb())
    init_genesis(factory, chain.genesis, dict(chain.accounts_at_genesis),
                 storage=chain.storage_at_genesis, codes=chain.codes_at_genesis,
                 committer=TrieCommitter(hasher=keccak256_batch_np, device="cpu"))
    tree = EngineTree(factory, device=device, hot_state=True, persistence_threshold=2)
    pool = TransactionPool(lambda: tree.overlay_provider(), PoolConfig(max_account_slots=64))
    batcher = TxBatcher(pool)
    miner = LocalMiner(tree, pool)
    stateless = StatelessChain(EvmConfig(), device=device)
    before = (tk.keccak256_words_masked.launches, fc.subtrie_levels.launches)
    out = {"blocks": [], "witnesses": [], "roots": []}
    try:
        for blk in chain.blocks[1:]:
            for f in [batcher.submit(t) for t in blk.transactions]:
                f.result(60)
            parent_hash = tree.head_hash
            parent = tree.overlay_provider().header_by_number(blk.header.number - 1)
            mined = miner.mine_block(timestamp=parent.timestamp + 12)
            assert len(mined.transactions) == len(blk.transactions) and len(pool) == 0
            w = generate_witness(tree.overlay_provider(parent_hash), mined, tree.committer,
                                 parent_header=parent, config=EvmConfig(),
                                 provider_factory=lambda h=parent_hash: tree.overlay_provider(h),
                                 proof_workers=4)
            root = stateless.validate(mined, w, parent)
            assert root == mined.header.state_root
            out["blocks"].append(mined.hash)
            out["witnesses"].append(w.to_json())
            out["roots"].append(root)
    finally:
        batcher.close()
    if device == "cuda":
        torch.cuda.synchronize()
    assert tree.sparse_fallbacks == 0 and tree.hot_arena.faults == 0
    out["launched"] = (tk.keccak256_words_masked.launches - before[0],
                       fc.subtrie_levels.launches - before[1])
    return out


@pytest.mark.cuda
def test_mined_witnessed_and_stateless_blocks_on_card_match_cpu():
    """Block production and stateless validation on the card at a small
    state: the mined blocks, their witnesses and the stateless roots equal
    the same path on device="cpu" (the kernels' plain versions), with
    kernel 1 and kernel 4 launched on the card."""
    require_card()
    got = _mine_witness_validate("cuda")
    want = _mine_witness_validate("cpu")
    for key in ("blocks", "witnesses", "roots"):
        assert got[key] == want[key], key
    assert got["launched"][0] > 0 and got["launched"][1] > 0


def _rpc_on(device: str) -> dict:
    """The small sync chain imported through the engine API on ``device``:
    each block as a payload through ``RpcServer.handle`` (newPayloadV2, then
    forkchoiceUpdatedV2), then ``eth_getProof`` at 3 slots and at 80 (the
    proof-worker pool) on the storage writer, each checked against the
    direct ``ProofCalculator`` call. Returns the responses and the kernels'
    launches by phase."""
    import json
    import types

    from _torch_helpers import SYNC_BLOCK_SMALL, SyncChain
    from reth_tpu_torch import testing
    from reth_tpu_torch.engine import EngineTree
    from reth_tpu_torch.primitives import keccak as pkeccak
    from reth_tpu_torch.primitives import secp256k1, types as ptypes
    from reth_tpu_torch.primitives.keccak import keccak256_batch_np
    from reth_tpu_torch.rpc import EngineApi, EthApi, RpcServer
    from reth_tpu_torch.rpc.engine_api import block_to_payload
    from reth_tpu_torch.storage import MemDb, ProviderFactory
    from reth_tpu_torch.storage.genesis import init_genesis
    from reth_tpu_torch.trie.proof import ProofCalculator

    pkg = types.SimpleNamespace(testing=testing, types=ptypes, keccak=pkeccak,
                                secp256k1=secp256k1)
    sync = SyncChain(pkg, n_accounts=200, n_slots=80, seed=47, n_wallets=4, n_blocks=2,
                     sizes=SYNC_BLOCK_SMALL,
                     committer=TrieCommitter(hasher=keccak256_batch_np, device="cpu"))
    chain = sync.builder
    factory = ProviderFactory(MemDb())
    init_genesis(factory, chain.genesis, dict(chain.accounts_at_genesis),
                 storage=chain.storage_at_genesis, codes=chain.codes_at_genesis,
                 committer=TrieCommitter(hasher=keccak256_batch_np, device="cpu"))
    tree = EngineTree(factory, device=device, hot_state=True, persistence_threshold=2)
    server = RpcServer()
    server.register(EngineApi(tree))
    server.register(EthApi(tree, None, chain.chain_id))

    def call(method, *params):
        out = json.loads(server.handle(json.dumps(
            {"jsonrpc": "2.0", "id": 1, "method": method, "params": list(params)}).encode()))
        assert "error" not in out, out
        return out["result"]

    def launches():
        if device == "cuda":
            torch.cuda.synchronize()
        return tk.keccak256_words_masked.launches, fc.subtrie_levels.launches

    out = {"statuses": [], "proofs": []}
    before = launches()
    for blk in chain.blocks[1:]:
        st = call("engine_newPayloadV2", block_to_payload(blk))
        out["statuses"].append((st["status"], st["latestValidHash"]))
        fcu = call("engine_forkchoiceUpdatedV2", {"headBlockHash": "0x" + blk.hash.hex()})
        assert fcu["payloadStatus"]["status"] == "VALID"
    mid = launches()
    writer = "0x" + SyncChain.WRITER.hex()
    for n_slots in (3, 80):
        slots = [hex(i + 1) for i in range(n_slots)]
        got = call("eth_getProof", writer, slots, "latest")
        direct = ProofCalculator(tree.overlay_provider(), tree.committer).account_proof(
            SyncChain.WRITER, [(i + 1).to_bytes(32, "big") for i in range(n_slots)])
        assert got["accountProof"] == ["0x" + n.hex() for n in direct.proof]
        assert [sp["proof"] for sp in got["storageProof"]] == \
            [["0x" + n.hex() for n in sp.proof] for sp in direct.storage_proofs]
        out["proofs"].append(got)
    end = launches()
    assert tree.sparse_fallbacks == 0 and server.kernel_faults == 0
    out["import"] = (mid[0] - before[0], mid[1] - before[1])
    out["proof"] = (end[0] - mid[0], end[1] - mid[1])
    out["head"] = tree.head_hash
    return out


@pytest.mark.cuda
def test_rpc_on_card_matches_cpu():
    """engine_newPayload through RpcServer.handle on device="cuda" launches
    kernels 1 and 4 (the ordered roots, the keys, the hot-state arena's
    finish) and eth_getProof launches kernel 1, at 3 and 80 slots; every
    status VALID and every response equal to device="cpu"'s and to the
    direct ProofCalculator call."""
    require_card()
    got, want = _rpc_on("cuda"), _rpc_on("cpu")
    assert [s for s, _h in got["statuses"]] == ["VALID", "VALID"]
    for key in ("statuses", "proofs", "head"):
        assert got[key] == want[key], key
    assert got["import"][0] > 0 and got["import"][1] > 0
    assert got["proof"][0] > 0 and got["proof"][1] == 0


def _unwind_crash_datadir(d, interrupted: bool = True):
    """A small datadir left by an engine tree with a WAL attached (5 blocks of
    one transfer, persisted to 4): with ``interrupted``, a deep-reorg unwind
    to 2 marked and interrupted before its first stage commit."""
    from reth_tpu_torch import testing
    from reth_tpu_torch.engine import EngineTree
    from reth_tpu_torch.primitives.keccak import keccak256_batch_np
    from reth_tpu_torch.storage import MemDb, ProviderFactory
    from reth_tpu_torch.storage.genesis import init_genesis
    from reth_tpu_torch.storage.recovery import UNWIND_MARKER_KEY
    from reth_tpu_torch.storage.tables import Tables
    from reth_tpu_torch.storage.wal import attach_wal

    host = TrieCommitter(hasher=keccak256_batch_np, device="cpu")
    alice = testing.Wallet(0xA11CE)
    builder = testing.ChainBuilder({alice.address: Account(balance=10**21)}, committer=host)
    for i in range(5):
        builder.build_block([alice.transfer(b"\xaa" * 20, 100 + i)])
    db = MemDb(d / "db.bin")
    dur = attach_wal(db, d / "wal")
    factory = ProviderFactory(db)
    init_genesis(factory, builder.genesis, builder.accounts_at_genesis, committer=host)
    tree = EngineTree(factory, committer=host, device="cpu", persistence_threshold=1)
    tree.durability = dur
    for blk in builder.blocks[1:]:
        assert tree.on_new_payload(blk).status.value == "VALID"
        tree.on_forkchoice_updated(blk.hash)
    if interrupted:  # the marker only: recovery unwinds every stage
        with factory.provider_rw() as p:
            p.tx.put(Tables.Metadata.name, UNWIND_MARKER_KEY, (2).to_bytes(8, "big"))


def _reopen(d):
    from reth_tpu_torch.storage import MemDb, ProviderFactory
    from reth_tpu_torch.storage.wal import attach_wal

    db = MemDb(d / "db.bin")
    return db, ProviderFactory(db), attach_wal(db, d / "wal")


@pytest.mark.cuda
def test_recovery_heals_an_interrupted_unwind_on_card(tmp_path):
    """recover_on_startup(device="cuda") completes an interrupted unwind (its
    stages' committers on the card: kernel 1) and verifies the head's root
    on the fused committer it builds there (kernel 2): the same report and
    tables as device="cpu", root_verified, kernels 1 and 2 launched."""
    import shutil

    from reth_tpu_torch.storage.recovery import recover_on_startup

    require_card()
    src = tmp_path / "src"
    src.mkdir()
    _unwind_crash_datadir(src)
    out = {}
    for device in ("cuda", "cpu"):
        d = tmp_path / device
        shutil.copytree(src, d)
        db, factory, dur = _reopen(d)
        before = (tk.keccak256_words_masked.launches, fc.packed_level.launches)
        report = recover_on_startup(factory, durability=dur, device=device)
        torch.cuda.synchronize()
        report.pop("wall_s")
        out[device] = (report, {n: t for n, t in db._tables.items() if t},
                       (tk.keccak256_words_masked.launches - before[0],
                        fc.packed_level.launches - before[1]))
    assert out["cuda"][:2] == out["cpu"][:2]
    report = out["cuda"][0]
    assert report["healed"] == ["completed interrupted unwind 4 -> 2"]
    assert report["root_verified"] is True and report["fallbacks"] == {}
    assert out["cuda"][2][0] > 0 and out["cuda"][2][1] > 0
    assert out["cpu"][2] == (0, 0)


@pytest.mark.cuda
def test_launch_fault_in_root_check_raises_out_of_recovery(tmp_path, monkeypatch):
    """A LaunchError in the root check's committer (the fused committer
    recover_on_startup builds on the card, its level kernel refusing the
    launch) propagates out of recover_on_startup instead of becoming a
    "failed" report."""
    from reth_tpu_torch.ops._build import LaunchError
    from reth_tpu_torch.storage.recovery import recover_on_startup

    require_card()
    _unwind_crash_datadir(tmp_path, interrupted=False)
    _, factory, dur = _reopen(tmp_path)

    def refused(*args, **kwargs):
        raise LaunchError("packed_level: CUDA error 700 at launch")

    monkeypatch.setattr(fc, "packed_level", refused)
    with pytest.raises(LaunchError, match="packed_level"):
        recover_on_startup(factory, durability=dur, device="cuda")


@pytest.mark.cuda
def test_failed_paged_engine_build_raises_on_card(tmp_path, monkeypatch):
    """A pagedkv.cpp that does not compile raises BuildError out of PagedDb,
    on the machine with the card as here."""
    from reth_tpu_torch.ops import _build
    from reth_tpu_torch.storage import native

    require_card()
    (tmp_path / "pagedkv.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC_DIR", tmp_path)
    monkeypatch.setattr(native, "_apis", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.BuildError, match="building pagedkv.cpp failed"):
        native.PagedDb(tmp_path / "db")


def _net_legs(device: str, tmp_path) -> dict:
    """The smoke's "net" legs b and c at the small sync chain's size: a port
    ``NetworkManager`` on 127.0.0.1 serves a database synced to block 3; a
    fresh client imports blocks 0-1 from era1 archives over HTTP
    (``EraStage`` before ``default_stages(device=)``), then syncs blocks 2-3
    from the server over encrypted RLPx (``sync_from_peer``: the online
    stages on ``device``). Returns the client's tables after each leg, the
    checkpoints and each leg's kernel launches."""
    import http.server
    import threading
    import types

    from _torch_helpers import SYNC_BLOCK_SMALL, SyncChain
    from reth_tpu_torch import era, era_sync, testing
    from reth_tpu_torch.consensus import EthBeaconConsensus
    from reth_tpu_torch.net import NetworkManager, PeerConnection, Status, sync_from_peer
    from reth_tpu_torch.primitives import keccak as pkeccak
    from reth_tpu_torch.primitives import secp256k1, types as ptypes
    from reth_tpu_torch.primitives.keccak import keccak256_batch_np
    from reth_tpu_torch.stages import Pipeline, default_stages
    from reth_tpu_torch.storage import MemDb, ProviderFactory
    from reth_tpu_torch.storage.genesis import import_chain, init_genesis

    host = TrieCommitter(hasher=keccak256_batch_np, device="cpu")
    pkg = types.SimpleNamespace(testing=testing, types=ptypes, keccak=pkeccak,
                                secp256k1=secp256k1)
    chain = SyncChain(pkg, n_accounts=200, n_slots=80, seed=47, n_wallets=4, n_blocks=3,
                      sizes=SYNC_BLOCK_SMALL, committer=host).builder

    def genesis_db():
        f = ProviderFactory(MemDb())
        init_genesis(f, chain.genesis, dict(chain.accounts_at_genesis),
                     storage=chain.storage_at_genesis, codes=chain.codes_at_genesis,
                     committer=host, device="cpu")
        return f

    served = genesis_db()
    import_chain(served, chain.blocks[1:], EthBeaconConsensus(host, device="cpu"))
    Pipeline(served, default_stages(committer=host, consensus=EthBeaconConsensus(
        host, device="cpu"), device="cpu")).run(3)
    src = tmp_path / f"era-{device}"
    src.mkdir()
    era.export_era(served, 0, 1, src / "chain-00000.era1")
    era_sync.EraSource.build_index(src)

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=str(src), **kw)

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Quiet)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    status = Status(network_id=1, head=chain.tip.hash, genesis=chain.genesis.hash)
    server = NetworkManager(served, status, node_priv=0x5E4, device="cpu")
    server.start()

    def launches():
        return (tk.keccak256_words_masked.launches, fc.packed_level.launches,
                fc.branch_level.launches, fc.subtrie_levels.launches)

    out = {}
    try:
        client = genesis_db()
        before = launches()
        source = era_sync.HttpEraSource(f"http://127.0.0.1:{httpd.server_address[1]}")
        stage = era_sync.EraStage(era_sync.EraDownloader(source, tmp_path / f"cache-{device}"),
                                  EthBeaconConsensus(device=device))
        Pipeline(client, [stage, *default_stages(device=device)]).run(1)
        torch.cuda.synchronize()
        mid = launches()
        out["era"] = {n: dict(t) for n, t in client.db._tables.items() if t}
        peer = PeerConnection.connect("127.0.0.1", server.port, Status(
            network_id=1, head=chain.genesis.hash, genesis=chain.genesis.hash),
            secp256k1.pubkey_from_priv(0x5E4))
        try:
            assert sync_from_peer(client, peer, device=device) == 3
        finally:
            peer.close()
        torch.cuda.synchronize()
        end = launches()
        out["online"] = {n: dict(t) for n, t in client.db._tables.items() if t}
        with client.provider() as p:
            out["checkpoints"] = {s: p.stage_checkpoint(s)
                                  for s in ("Era", "Headers", "Bodies", "MerkleExecute",
                                            "Finish")}
            out["root"] = p.header_by_number(3).state_root == chain.tip.state_root
        out["launches"] = ([b - a for a, b in zip(before, mid)],
                           [b - a for a, b in zip(mid, end)])
    finally:
        server.stop()
        httpd.shutdown()
    return out


@pytest.mark.cuda
def test_net_legs_on_card_match_cpu(tmp_path):
    """Era import then online sync (the smoke's "net" legs b and c) on
    device="cuda" and device="cpu": the same rows in every table after each
    leg, the root at block 3, the era leg's MerkleStage from checkpoint 0 on
    kernels 1-3 and the online leg's stages on kernel 1, no kernel 4."""
    require_card()
    got, want = _net_legs("cuda", tmp_path), _net_legs("cpu", tmp_path)
    assert got["era"] == want["era"] and got["online"] == want["online"]
    assert got["root"] and got["checkpoints"] == want["checkpoints"]
    era_l, online_l = got["launches"]
    assert all(n > 0 for n in era_l[:3]) and era_l[3] == 0
    assert online_l[0] > 0 and online_l[3] == 0


# -- the member mesh: exchange_slots and the mesh engines ------------------------


def _exchange_case(m: int, rows: int, n: int, seed: int, layout: str = "scattered"):
    """``m`` random replicas of ``rows`` slots and ``n`` distinct slots in m
    ranges in roster order: ``layout`` "scattered" (random slots, even
    ranges, the last one short), "consecutive" (slots 7, 8, ...),
    "warp-split" (scattered, members' boundaries at rows 5, 11, 17, ...:
    inside a warp's 16 rows, and inside a block's 8 of the warp-a-row
    design) or "empty" (scattered, member 1's range
    empty)."""
    rng = np.random.default_rng(seed)
    base = [torch.from_numpy(rng.integers(0, 256, size=(rows, 32), dtype=np.uint8)).cuda()
            for _ in range(m)]
    ids = (np.arange(7, 7 + n) if layout == "consecutive"
           else rng.choice(np.arange(1, rows), size=n, replace=False))
    slots = torch.from_numpy(ids.astype(np.int64)).cuda()
    shard = -(-n // m)
    bounds = [min(j * shard, n) for j in range(m)] + [n]
    if layout == "warp-split":
        bounds = [0] + [min(n, 6 * j - 1) for j in range(1, m)] + [n]
    elif layout == "empty":
        bounds[2] = bounds[1]
    return base, slots, bounds


# n of 1, 15, 16, 17 and counts that are no multiple of a block's 64 rows a
# pass or 256 rows at 4 rows a thread; counts above one wave of resident
# blocks at a row a thread (about 135,000 rows on an H100), which take 4 rows
# a thread, one of them past 4 rows a thread of one wave (several trips of
# the grid); boundaries inside a warp; an empty member
EXCHANGE_CASES = [(2, 1, "scattered"), (3, 1000, "scattered"), (4, 4097, "scattered"),
                  (16, 300, "scattered"), (3, 15, "scattered"), (4, 16, "consecutive"),
                  (16, 17, "scattered"), (2, 4097, "consecutive"), (3, 100, "warp-split"),
                  (16, 100, "warp-split"), (3, 40, "empty"), (4, 1000, "empty"),
                  (3, 167_548, "scattered"), (2, 600_001, "consecutive")]


def _exchange_matches(fn, m: int, n: int, layout: str) -> None:
    base, slots, bounds = _exchange_case(m, max(5000, n + 100), n, seed=m + n, layout=layout)
    k_bufs = [b.clone() for b in base]
    r_bufs = [b.clone() for b in base]
    before = fn.launches
    fn(k_bufs, slots, bounds)
    fc.exchange_slots_ref(r_bufs, slots, bounds)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    for a, b in zip(k_bufs, r_bufs):
        assert torch.equal(a, b)
    assert all(torch.equal(k_bufs[0][slots], b[slots]) for b in k_bufs[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,layout", EXCHANGE_CASES)
def test_exchange_slots_matches_index_copy_on_card(m, n, layout):
    require_card()
    _exchange_matches(fc.exchange_slots, m, n, layout)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,layout", EXCHANGE_CASES)
def test_exchange_slots_warp_row_matches_index_copy_on_card(m, n, layout):
    """The first design, kept as a debug entry, on the same cases; it does
    not count as the exchange's launch."""
    require_card()
    before = fc.exchange_slots.launches
    _exchange_matches(fc.exchange_slots_warp_row, m, n, layout)
    assert fc.exchange_slots.launches == before


@pytest.mark.cuda
def test_exchange_slots_refuses_more_members_than_one_launch_takes():
    require_card()
    base, slots, bounds = _exchange_case(fc.EXCHANGE_MAX_MEMBERS + 1, 64, 40, seed=1)
    with pytest.raises(ValueError):
        fc.exchange_slots(base, slots, bounds)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 8])
def test_mesh_engines_on_repeated_card_match_single_engine(k):
    """TurboCommitter(mesh=) over cuda:0 named three times (FusedMeshEngine,
    SubtrieMeshEngine at k=8) gives the single-card engine's roots and
    branch nodes, launches the exchange, and leaves the replicas equal."""
    from reth_tpu_torch.parallel import HashMesh

    require_card()
    jobs = prefix_jobs(3000, seed=9)
    one = tturbo.TurboCommitter(device="cuda", subtrie_levels=k)
    want = one.commit_hashed_pipelined(jobs, collect_branches=True, start_depth=2)
    hm = HashMesh(["cuda:0"] * 3, registry=MetricsRegistry())
    mesh = tturbo.TurboCommitter(device="cuda", subtrie_levels=k, mesh=hm)
    made = []
    factory = mesh._device_engine
    mesh._device_engine = lambda *a, **kw: made.append(factory(*a, **kw)) or made[-1]
    before = fc.exchange_slots.launches
    got = mesh.commit_hashed_pipelined(jobs, collect_branches=True, start_depth=2)
    serial = mesh.commit_hashed_many(jobs, collect_branches=True, start_depth=2)
    torch.cuda.synchronize()
    assert [r.root for r in got] == [r.root for r in serial] == [r.root for r in want]
    assert [r.branch_nodes for r in got] == [r.branch_nodes for r in want]
    assert fc.exchange_slots.launches > before
    assert [e.replicas_checked for e in made] == [1, 1]


@pytest.mark.cuda
def test_two_deep_import_over_meshed_service_on_card_matches_serial(monkeypatch):
    """The cross-block import pipeline two deep over a meshed hash service on
    cuda:0 named twice (the committer wired as the reference's cli.py wires
    --mesh --hash-service): the speculation takes the service's sub-mesh
    lease, and state roots, receipts and senders equal a serial import's on
    one card; every lease is released."""
    from reth_tpu_torch import testing as ptesting
    from reth_tpu_torch.engine import EngineTree
    from reth_tpu_torch.engine import block_pipeline
    from reth_tpu_torch.ops.hash_service import HashService
    from reth_tpu_torch.parallel import HashMesh
    from reth_tpu_torch.primitives.keccak import keccak256_batch_np
    from reth_tpu_torch.storage import MemDb, ProviderFactory
    from reth_tpu_torch.storage.genesis import init_genesis

    require_card()
    builder = pipeline_chain(ptesting, Account,
                             TrieCommitter(hasher=keccak256_batch_np, device="cpu"))
    blocks = builder.blocks[1:]

    def tree(depth, mesh=None):
        c, svc = TrieCommitter(device="cuda"), None
        if mesh is not None:
            c.hash_mesh = mesh
            c.hash_service = svc = HashService(backend=c.hasher, mesh=mesh,
                                               registry=MetricsRegistry())
            c.hasher = svc.client("live")
        factory = ProviderFactory(MemDb())
        init_genesis(factory, builder.genesis, builder.accounts_at_genesis, committer=c)
        return EngineTree(factory, committer=c, persistence_threshold=100,
                          pipeline_depth=depth), svc

    piped, svc = tree(2, HashMesh(["cuda:0"] * 2, registry=MetricsRegistry()))
    serial, _ = tree(1)
    late = hold_root_until_child_arrives(monkeypatch, piped, blocks)
    try:
        got = block_pipeline.import_chain(piped, blocks, fcu=False, overlap=True)
    finally:
        svc.stop()
    one = block_pipeline.import_chain(serial, blocks, fcu=False, overlap=False)
    assert late == []
    assert [s.status.value for s in got] == [s.status.value for s in one] == ["VALID"] * len(
        blocks)
    for b in blocks:
        p, q = piped.blocks[b.hash], serial.blocks[b.hash]
        assert p.block.header.state_root == q.block.header.state_root == b.header.state_root
        assert [r.encode_2718() for r in p.receipts] == [r.encode_2718() for r in q.receipts]
        assert list(p.senders) == list(q.senders)
    stats = piped.pipeline.stats_snapshot()
    assert stats["adopted"] >= 1 and stats["leases_active"] == 0
    assert svc.pipeline_leases >= 1


@pytest.mark.cuda
def test_mesh_without_a_card_or_with_a_failed_build_raises(monkeypatch, tmp_path):
    """A mesh member on a card that is not there raises at once, and a kernel
    library that does not build raises out of the mesh engine's commit and
    out of the meshed service, never replayed on the CPU."""
    from reth_tpu_torch.ops import _build
    from reth_tpu_torch.ops.hash_service import HashService
    from reth_tpu_torch.parallel import HashMesh

    require_card()
    with pytest.raises(RuntimeError):
        HashMesh([f"cuda:{torch.cuda.device_count()}"])
    hm = HashMesh(["cuda:0"] * 2, registry=MetricsRegistry())
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["--no-such-nvcc-flag"])
    monkeypatch.setattr(_build, "_kernel_dir", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(_build.BuildError):
        tturbo.TurboCommitter(device="cuda", mesh=hm).commit_hashed_many(
            prefix_jobs(200, seed=3), start_depth=2)
    with pytest.raises(_build.BuildError):
        HashService(mesh=hm, registry=MetricsRegistry())


# -- the node and the CLI ------------------------------------------------------------


def _node_legs(device: str, tmp_path, gpath, cpath, txs) -> dict:
    """The CLI's ``init`` and ``import`` into a fresh datadir on ``device``
    (``--device cpu`` for the CPU; nothing for the card, the default), then a
    short dev node on it: its recovery's root check, one block of ``txs``
    mined. The kernels' launches of the CLI's two commands and of the node."""
    from reth_tpu_torch.cli import main
    from reth_tpu_torch.node import Node, NodeConfig
    from reth_tpu_torch.storage import open_database
    from reth_tpu_torch.storage.tables import TableDef, Tables

    wrappers = (tk.keccak256_words_masked, fc.packed_level, fc.branch_level, fc.subtrie_levels)
    d = tmp_path / device
    flags = [] if device == "cuda" else ["--device", "cpu"]
    before = [w.launches for w in wrappers]
    assert main(["init", "--datadir", str(d), "--genesis", str(gpath)] + flags) == 0
    assert main(["import", "--datadir", str(d), "--genesis", str(gpath), str(cpath)]
                + flags) == 0
    torch.cuda.synchronize()
    cli = [w.launches - b for w, b in zip(wrappers, before)]
    db = open_database("paged", d)
    with db.tx() as tx:
        tables = {v.name: list(tx.cursor(v.name).walk()) for v in vars(Tables).values()
                  if isinstance(v, TableDef)}
    db.close()
    before = [w.launches for w in wrappers]
    node = Node(NodeConfig(datadir=str(d), dev=True), device=device)
    try:
        report = dict(node.recovery)
        for tx in txs:
            node.pool.add_transaction(tx)
        block = node.miner.mine_block()
    finally:
        node.stop()
    torch.cuda.synchronize()
    return {"tables": tables, "root_verified": report["root_verified"],
            "fallbacks": report["fallbacks"], "block": (block.hash, block.header.state_root,
                                                          len(block.transactions)),
            "cli": cli, "node": [w.launches - b for w, b in zip(wrappers, before)]}


@pytest.mark.cuda
def test_cli_init_import_and_dev_node_on_card_match_cpu(tmp_path):
    """``cli.main(["init", ...])`` and ``["import", ...]`` of a small sync
    chain, then a short dev node over the datadir, on the card and with
    ``--device cpu``: the same tables, the recovered root verified on both,
    the same mined block (hash and state root). On the card the import's
    MerkleStage runs kernels 1-3 and the node's block kernel 1."""
    import json
    import types

    from _torch_helpers import SYNC_BLOCK_SMALL, SyncChain, geth_genesis
    from reth_tpu_torch import testing as ptesting
    from reth_tpu_torch.convert import alloc_to_fields
    from reth_tpu_torch.primitives import keccak as pkeccak
    from reth_tpu_torch.primitives import secp256k1 as psecp
    from reth_tpu_torch.primitives import types as ptypes

    require_card()
    pkg = types.SimpleNamespace(testing=ptesting, types=ptypes, keccak=pkeccak,
                                secp256k1=psecp)
    chain = SyncChain(pkg, n_accounts=300, n_slots=120, seed=47, n_wallets=6, n_blocks=3,
                      sizes=SYNC_BLOCK_SMALL,
                      committer=TrieCommitter(hasher=pkeccak.keccak256_batch_np, device="cpu"),
                      spare=1)
    b = chain.builder
    gpath = tmp_path / "genesis.json"
    gpath.write_text(json.dumps(geth_genesis(
        alloc_to_fields(b.accounts_at_genesis, b.storage_at_genesis, b.codes_at_genesis),
        b.genesis)))
    cpath = tmp_path / "chain.rlp"
    cpath.write_bytes(b.export_rlp())
    _, txs, _ = chain.batch()
    got = _node_legs("cuda", tmp_path, gpath, cpath, txs)
    want = _node_legs("cpu", tmp_path, gpath, cpath, txs)
    assert got["tables"] == want["tables"]
    assert got["root_verified"] is True and want["root_verified"] is True
    assert got["fallbacks"] == {} and got["block"] == want["block"]
    assert got["block"][2] == len(txs)
    assert all(n > 0 for n in got["cli"][:3]) and got["node"][0] > 0
