"""The general committer's template levels in the port: ``FusedLevelEngine.
dispatch_level`` (reth_tpu_torch/ops/fused_commit.py), which hashes a bucket
of RLP templates with digest holes as a PACKED level through kernel 2,
against the JAX FusedLevelEngine's ``_plain_level``/``_splice_level``
programs under JAX_PLATFORMS=cpu, and against its own plain version
``splice_level`` in the reference's padded layout. Both engines start from
the same digest buffer; buffers must agree bit for bit from slot 1 (slot 0
is the dummy the JAX engine's padding rows write). The port runs on
device="cpu" (kernel 2's plain version)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_helpers import (TEMPLATE_CASES, TEMPLATE_LENS, TEMPLATE_SRC, template_bucket,
                            template_buffer, template_level, template_levels)
from reth_tpu.ops.fused_commit import FusedLevelEngine as JaxEngine
from reth_tpu.ops.fused_commit import _Bucket as JaxBucket
from reth_tpu.primitives.keccak import num_blocks_for as jax_num_blocks_for
from reth_tpu_torch import convert
from reth_tpu_torch.ops import fused_commit as fc
from reth_tpu_torch.ops.keccak import KeccakDevice
from reth_tpu_torch.primitives.keccak import RATE, keccak256, num_blocks_for
from reth_tpu_torch.primitives.types import Account
from reth_tpu_torch.trie import state_root as tsr
from reth_tpu_torch.trie.committer import TrieCommitter

MIN_TIER = 64


@pytest.mark.parametrize("case", TEMPLATE_CASES)
def test_dispatch_level_matches_jax_engine(case):
    rng = np.random.default_rng(11)
    levels = template_levels(case, rng)
    shared = template_buffer(rng)

    import jax.numpy as jnp

    jax_eng = JaxEngine(min_tier=MIN_TIER)
    jax_eng.begin(shared.shape[0] - 1)
    jax_eng._buf = jnp.asarray(shared)
    port = fc.FusedLevelEngine(min_tier=MIN_TIER, device="cpu")
    port.begin_from(convert.digest_buffer_from_numpy(shared, "cpu"))
    for lv in levels:
        jax_eng.dispatch_level(template_bucket(JaxBucket, lv))
        port.dispatch_level(template_bucket(fc._Bucket, lv, rng))
    want, got = jax_eng.finish(), port.finish()
    assert got.shape == want.shape
    assert np.array_equal(got[1:], want[1:])
    n_out = sum(len(lv[1]) for lv in levels)
    assert got[TEMPLATE_SRC:TEMPLATE_SRC + n_out].any(axis=1).all()


def _kernel2_args(bucket, shared):
    """The arguments ``dispatch_level`` hands kernel 2 for ``bucket``."""
    calls = []
    real = fc.packed_level

    def record(*args):
        calls.append(args[:-1])
        return real(*args)

    eng = fc.FusedLevelEngine(min_tier=MIN_TIER, device="cpu")
    eng.begin_from(convert.digest_buffer_from_numpy(shared, "cpu"))
    fc.packed_level = record
    try:
        eng.dispatch_level(bucket)
    finally:
        fc.packed_level = real
    assert len(calls) == 1
    return calls[0], eng.finish()


@pytest.mark.parametrize("case", ["plain", "spliced", "random"])
def test_packed_route_matches_splice_level(case):
    """Kernel 2's route (its plain version here; the kernel on the card in
    test_torch_cuda.py) against ``splice_level`` on the reference's padded
    layout of the same level, from the same buffer."""
    rng = np.random.default_rng(12)
    (lv,) = template_levels(case, rng)
    shared = template_buffer(rng)
    args, got = _kernel2_args(template_bucket(fc._Bucket, lv, rng), shared)
    want = torch.from_numpy(shared.copy())
    fc.splice_level(*fc.padded_level(*args), want)
    assert np.array_equal(got, want.numpy())
    assert not np.array_equal(got, shared)


def test_padded_level_is_the_reference_layout():
    """``padded_level`` pads exactly as the reference's host loop
    (reth_tpu/ops/fused_commit.py _dispatch_one): the pow2 block tier of the
    longest row (at least 2), 0x01 after the template, 0x80 at the last byte
    of its own last rate block; and holes sorted by row."""
    rng = np.random.default_rng(13)
    lv = template_level(rng, TEMPLATE_LENS, True, TEMPLATE_SRC)
    bucket = template_bucket(fc._Bucket, lv, rng)
    args, _ = _kernel2_args(bucket, template_buffer(rng))
    templates, counts, hole_row, hole_off, hole_src, slots = fc.padded_level(*args)
    want = np.zeros((len(lv[0]), 16 * RATE), dtype=np.uint8)
    for i, t in enumerate(lv[0]):
        want[i, :len(t)] = np.frombuffer(t, dtype=np.uint8)
        want[i, len(t)] ^= 0x01
        want[i, num_blocks_for(t) * RATE - 1] ^= 0x80
    assert np.array_equal(templates.numpy(), want)
    assert counts.tolist() == [num_blocks_for(t) for t in lv[0]]
    got_holes = sorted(zip(hole_row.tolist(), hole_off.tolist(), hole_src.tolist()))
    assert got_holes == sorted(lv[2])
    assert slots.tolist() == lv[1]


def test_block_count_identity():
    """The committer's block count ``len // RATE + 1``
    (trie/committer.py), the keccak padding's, the reference's, and kernel
    2's own (``row_len // RATE + 1``) are one count, at every length up to
    16 blocks; ``dispatch_level`` refuses a bucket whose count differs."""
    lens = np.arange(16 * RATE + 1)
    row_len = torch.from_numpy(lens.astype(np.int32))
    _, kernel2 = fc._padded_rows(torch.zeros(1, dtype=torch.uint8),
                                 torch.zeros(len(lens), dtype=torch.int64), row_len)
    assert kernel2.tolist() == [int(n) // RATE + 1 for n in lens]
    assert kernel2.tolist() == [num_blocks_for(bytes(int(n))) for n in lens]
    assert kernel2.tolist() == [jax_num_blocks_for(bytes(int(n))) for n in lens]
    bad = fc._Bucket()
    bad.add(bytes(200), 1, 5, [])
    eng = fc.FusedLevelEngine(min_tier=MIN_TIER, device="cpu")
    eng.begin(8)
    with pytest.raises(ValueError):
        eng.dispatch_level(bad)


def test_committer_buckets_keep_the_route_exact():
    """Every bucket the general committer hands the engine on a real
    state_root: each template's count is ``len // RATE + 1``, every hole
    lies inside its template (so it never covers a padding byte), and holes
    read only slots of deeper levels; the digests match keccak of the
    spliced RLP."""
    rng = np.random.default_rng(14)
    addrs = [bytes(a) for a in rng.integers(0, 256, size=(120, 20), dtype=np.uint8)]
    accounts = {a: Account(nonce=i + 1, balance=int(rng.integers(1, 1 << 60)))
                for i, a in enumerate(addrs)}
    storages = {addrs[0]: {bytes(rng.integers(0, 256, size=32, dtype=np.uint8)): i + 1
                           for i in range(60)}}
    committer = TrieCommitter(fused=True, device="cpu",
                              hasher=KeccakDevice(block_tier=4, device="cpu").hash_batch)
    eng = committer._engine
    seen, real = [], eng.dispatch_level

    def record(bucket):
        seen.append(bucket)
        real(bucket)

    finished, real_finish = [], eng.finish
    eng.dispatch_level = record
    eng.finish = lambda: finished.append(real_finish()) or finished[-1]
    tsr.state_root(accounts, storages, committer=committer)
    assert any(b.holes for b in seen) and any(b.templates and not b.holes for b in seen)
    written: set[int] = set()
    digests = {}
    for bucket in seen:
        for t, nb in zip(bucket.templates, bucket.counts):
            assert nb == len(t) // RATE + 1
        for row, off, src in bucket.holes:
            assert 0 <= off and off + 32 <= len(bucket.templates[row])
            assert src in written
        for i, (t, s) in enumerate(zip(bucket.templates, bucket.slots)):
            rlp = bytearray(t)
            for row, off, src in bucket.holes:
                if row == i:
                    rlp[off:off + 32] = digests[src]
            digests[s] = keccak256(bytes(rlp))
        written.update(bucket.slots)
    assert digests and all(finished[-1][s].tobytes() == d for s, d in digests.items())
