"""The level kernels' edge cases (tests/_torch_helpers.py edge_level): the
port's plain versions (device="cpu") against the JAX FusedLevelEngine's
dispatch_packed / dispatch_branch under JAX_PLATFORMS=cpu, bit for bit from
one shared random digest buffer, compared from slot 1 (the JAX engine aims
its padding rows at dummy slot 0). tests/test_torch_cuda.py holds the CUDA
kernels against the same plain versions on the same cases."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_helpers import EDGE_CASES, edge_digest_buffer, edge_level
from reth_tpu.ops.fused_commit import FusedLevelEngine as JaxEngine
from reth_tpu_torch import convert
from reth_tpu_torch.ops import fused_commit as fc


def _dispatch(engine, kind, args):
    if kind == "packed":
        # the JAX engine's rows are b_tier rate blocks wide
        nb = int(args[2].max()) // 136 + 1 if len(args[2]) else 1
        engine.dispatch_packed(*args, b_tier=max(4, 1 << (nb - 1).bit_length()))
    else:
        engine.dispatch_branch(*args)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_edge_level_matches_jax_engine(case):
    import jax.numpy as jnp

    kind, args = edge_level(case)
    seed_buf = edge_digest_buffer()
    jax_eng = JaxEngine(min_tier=seed_buf.shape[0])
    jax_eng.begin(seed_buf.shape[0] - 1)
    jax_eng._buf = jnp.asarray(seed_buf)
    _dispatch(jax_eng, kind, args)
    want = jax_eng.finish()

    eng = fc.FusedLevelEngine(min_tier=seed_buf.shape[0], device="cpu")
    eng.begin_from(convert.digest_buffer_from_numpy(seed_buf, "cpu"))
    _dispatch(eng, kind, args)
    got = eng.finish()
    assert got.shape == want.shape
    assert np.array_equal(got[1:], want[1:])
    # every row wrote its own slot, and no other slot moved
    slots = (args[3] if kind == "packed" else args[1]).astype(np.int64)
    assert (got[slots] != seed_buf[slots]).any(axis=1).all()
    untouched = np.setdiff1d(np.arange(1, seed_buf.shape[0]), slots)
    assert np.array_equal(got[untouched], seed_buf[untouched])


def _misaligned_u8(n: int, by: int = 8) -> torch.Tensor:
    """n bytes starting ``by`` bytes past a 16-byte boundary."""
    base = torch.zeros(n + 32, dtype=torch.uint8)
    skip = (by - base.data_ptr()) % 16
    return base[skip:skip + n]


@pytest.mark.parametrize("kernel", ["packed_buf", "branch_buf", "packed_flat"])
def test_level_kernels_reject_unaligned_buffers(kernel):
    ix = torch.zeros(1, dtype=torch.int64)
    start = torch.zeros(2, dtype=torch.int64)
    no_i32, no_i64 = torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=torch.int64)
    buf8 = _misaligned_u8(8 * 32).view(8, 32)
    assert buf8.data_ptr() % 8 == 0 and buf8.data_ptr() % 16 == 8
    buf = torch.zeros((8, 32), dtype=torch.uint8)
    with pytest.raises(ValueError, match="8-byte aligned" if kernel == "packed_flat"
                       else "16-byte aligned"):
        if kernel == "packed_buf":
            fc.packed_level(torch.zeros(16, dtype=torch.uint8), ix, ix.int(), ix, start,
                            no_i32, no_i64, buf8)
        elif kernel == "branch_buf":
            fc.branch_level(torch.full((1,), 3, dtype=torch.int32), ix, start, no_i32,
                            no_i64, buf8)
        else:
            fc.packed_level(_misaligned_u8(16, by=4), ix, ix.int(), ix, start, no_i32, no_i64,
                            buf)


def test_engine_aligns_unaligned_numpy_views():
    """On the CPU the engine hands numpy memory to the wrappers; a view that
    starts off a 16-byte boundary is copied, and the digests are those of
    the aligned array."""
    kind, args = edge_level("packed-tail")
    flat = args[0]
    backing = np.zeros(len(flat) + 32, dtype=np.uint8)
    skip = (8 - backing.ctypes.data) % 16
    view = backing[skip:skip + len(flat)]
    view[:] = flat
    assert view.ctypes.data % 16 == 8
    seed_buf = edge_digest_buffer()
    outs = []
    for f in (flat, view):
        eng = fc.FusedLevelEngine(min_tier=seed_buf.shape[0], device="cpu")
        eng.begin_from(convert.digest_buffer_from_numpy(seed_buf, "cpu"))
        eng.dispatch_packed(f, *args[1:], b_tier=4)
        outs.append(eng.finish())
    assert np.array_equal(outs[0], outs[1])
