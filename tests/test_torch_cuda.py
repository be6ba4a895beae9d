"""Each CUDA kernel of the port against its plain PyTorch version on the
card, bit for bit. Marked ``cuda``: without a Hopper card the tests skip.
This file imports nothing of JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_helpers import (EDGE_CASES, edge_chain, edge_digest_buffer, edge_level,
                            level_kernel_args, prefix_jobs, require_card, staged_chunks,
                            threshold_chain)
from reth_tpu_torch.ops import fused_commit as fc
from reth_tpu_torch.ops import keccak as tk
from reth_tpu_torch.primitives.keccak import keccak256, num_blocks_for, pad_batch
from reth_tpu_torch.trie import turbo as tturbo


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
