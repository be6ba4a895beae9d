"""Batched Keccak-256 on the card: kernel 1 (``csrc/keccak.cu``), its plain
PyTorch version, and the host batching front-end ``KeccakDevice``.

Port of the JAX package's ``ops/keccak_jax.py`` (XLA masked absorb,
``KeccakDevice``) and ``ops/keccak_pallas.py`` (the single-block Pallas
kernel). One CUDA kernel takes the place of both device paths: it absorbs
any number of rate blocks per message, so the 1-block bucket (the Pallas
kernel's job), the exact-block buckets and the masked buckets all launch
the same kernel. A bucket goes to the numpy twin on the host only while a
warm-up manager serves degraded (``ops/warmup.py``): its shape is not warm
yet. A message above the menu's block-tier ceiling (32 rate blocks) is off
the menu, so it too is hashed on the host while the menu warms; without a
manager, or once the menu is warm, it runs on the kernel. (The reference
hashes such messages on the host always, because XLA compiles one program
per shape; the digests are the same.)

Word layout is the reference's: a padded message is ``(B*34,)`` little-endian
u32 words (``pad_batch`` viewed as ``<u4``); a digest is ``(8,)`` u32 words
``[lo0,hi0,...,lo3,hi3]`` whose bytes are the 32-byte digest.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import resolve, stream_handle
from ..primitives.keccak import (RATE, RC, ROT, bucketed_hash, keccak256_words_masked_np,
                                 pad_batch)
from . import _build

WORDS_PER_BLOCK = RATE // 4  # 34 u32 words per rate block

_RC_SIGNED = [rc - (1 << 64) if rc >> 63 else rc for rc in RC]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate int64 lanes left by a static r (logical shift via mask)."""
    if r == 0:
        return x
    return (x << r) | ((x >> (64 - r)) & ((1 << r) - 1))


def keccak_f1600_ref(a: list[torch.Tensor]) -> list[torch.Tensor]:
    """keccak-f[1600] over 25 int64 lane tensors (plain PyTorch)."""
    a = list(a)
    for rc in _RC_SIGNED:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        b = [None] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y], ROT[x][y])
        a = [b[i] ^ (~b[(i % 5 + 1) % 5 + 5 * (i // 5)] & b[(i % 5 + 2) % 5 + 5 * (i // 5)])
             for i in range(25)]
        a[0] = a[0] ^ rc
    return a


def _check_words(words: torch.Tensor, counts: torch.Tensor) -> int:
    if words.dtype != torch.uint32 or words.dim() != 2:
        raise ValueError(f"words must be a 2-D uint32 tensor, got {words.dtype} {tuple(words.shape)}")
    if words.shape[1] == 0 or words.shape[1] % WORDS_PER_BLOCK:
        raise ValueError(f"words width {words.shape[1]} is not a positive multiple of 34")
    if counts.dtype != torch.int32 or counts.shape != (words.shape[0],):
        raise ValueError(f"counts must be int32 of shape ({words.shape[0]},)")
    if counts.device != words.device:
        raise ValueError("words and counts are on different devices")
    return words.shape[1] // WORDS_PER_BLOCK


def keccak256_words_masked_ref(words: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel 1: message i absorbs its first
    ``counts[i]`` rate blocks of ``words`` (N, B*34) u32; returns (N, 8) u32."""
    blocks = _check_words(words, counts)
    n = words.shape[0]
    lanes = words.contiguous().view(torch.int64).reshape(n, blocks, 17)
    state = [torch.zeros(n, dtype=torch.int64, device=words.device) for _ in range(25)]
    for blk in range(blocks):
        nxt = keccak_f1600_ref(
            [state[j] ^ lanes[:, blk, j] if j < 17 else state[j] for j in range(25)])
        live = blk < counts
        state = [torch.where(live, nxt[j], state[j]) for j in range(25)]
    return torch.stack(state[:4], dim=1).view(torch.uint32)


def _absorb_lib() -> ctypes.CDLL:
    lib = _build.load_kernel("keccak.cu")
    args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p]
    for fn in (lib.keccak256_absorb, lib.keccak256_absorb_unstaged):
        fn.restype = ctypes.c_int
        fn.argtypes = args
    lib.keccak256_absorb_rows_per_block.restype = ctypes.c_int
    lib.keccak256_absorb_rows_per_block.argtypes = [ctypes.c_int64, ctypes.c_int32]
    return lib


def _launch(entry: str, words: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Launch one of kernel 1's C entries on CUDA tensors; returns the
    (N, 8) u32 digests."""
    blocks = _check_words(words, counts)
    if words.device.type != "cuda":
        raise ValueError(f"{entry}: expected CUDA tensors, got {words.device}")
    words = words.contiguous()
    counts = counts.contiguous()
    if words.data_ptr() % 8:
        raise ValueError("words must be 8-byte aligned (the kernel reads 64-bit lanes)")
    out = torch.empty((words.shape[0], 8), dtype=torch.uint32, device=words.device)
    err = getattr(_absorb_lib(), entry)(words.data_ptr(), counts.data_ptr(), out.data_ptr(),
                                        words.shape[0], blocks, stream_handle(words))
    _build.check_launch(err, entry)
    return out


def keccak256_words_masked(words: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Masked absorb (kernel 1, ``csrc/keccak.cu keccak256_absorb``).

    ``words``: (N, B*34) u32 pre-padded messages, each padded at its own last
    block and zero-extended to B blocks; ``counts``: (N,) int32 real block
    counts. Returns (N, 8) u32 digests. A CPU tensor runs the plain version;
    a CUDA tensor launches the kernel. ``words`` may start at any 8-byte
    boundary."""
    _check_words(words, counts)
    if words.device.type == "cpu":
        return keccak256_words_masked_ref(words, counts)
    out = _launch("keccak256_absorb", words, counts)
    keccak256_words_masked.launches += 1
    return out


keccak256_words_masked.launches = 0


def keccak256_words_masked_unstaged(words: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Kernel 1's first design (``csrc/keccak.cu keccak256_absorb_unstaged``:
    one thread a message reading its own row, 128-thread blocks), a debug
    entry the port never calls: the smoke times it beside the kernel, and
    counts one permutation's instructions on it. CUDA tensors only; not
    counted as a launch."""
    return _launch("keccak256_absorb_unstaged", words, counts)


def absorb_rows_per_block(n: int, blocks: int) -> int:
    """Rows per block kernel 1 takes for a launch of ``n`` rows ``blocks``
    rate blocks wide on the current card (its grid is ceil(n / that))."""
    r = _absorb_lib().keccak256_absorb_rows_per_block(n, blocks)
    if r <= 0:
        raise RuntimeError(f"keccak256_absorb: grid query failed (CUDA error {-r})")
    return r


def keccak256_words(words: torch.Tensor, num_blocks: int) -> torch.Tensor:
    """Keccak-256 over messages that all take ``num_blocks`` rate blocks:
    (N, num_blocks*34) u32 → (N, 8) u32 (the reference's exact programs)."""
    counts = torch.full((words.shape[0],), num_blocks, dtype=torch.int32, device=words.device)
    return keccak256_words_masked(words, counts)


def _next_tier(n: int, min_tier: int, max_tier: int | None = None) -> int:
    """The pow2 ladder from ``min_tier``, clamped at ``max_tier``."""
    t = min_tier
    while t < n:
        t *= 2
    if max_tier is not None and t > max_tier:
        return max_tier
    return t


class KeccakDevice:
    """Host batching front-end for kernel 1: callers hand over lists of
    byte strings; messages are bucketed by rate-block count exactly as the
    reference buckets them, each bucket is padded on the host, hashed in one
    launch, and digests come back in order.

    Same bucket keys as the reference (exact buckets up to
    ``MAX_EXACT_BLOCKS``, or one shared ``block_tier`` bucket, pow2 block
    tiers above), and batches above ``MAX_BATCH_TIER`` (rounded onto the
    pow2 ladder from ``min_tier``) are hashed in chunks. Batches are not
    padded to batch tiers: the kernel takes any row count. ``warmup`` (an
    ``ops/warmup.py WarmupManager``) is asked for each bucket's (kind, block
    tier, batch tier); a shape it has not warmed, a bucket above the menu's
    block ceiling included, is hashed on the host while it warms.
    ``host_hashed`` counts the messages hashed on the host."""

    MAX_EXACT_BLOCKS = 8
    # the batch ceiling of the warm-up menu (ops/warmup.py)
    MAX_BATCH_TIER = 16384

    def __init__(self, min_tier: int = 8, block_tier: int | None = None, warmup=None,
                 max_batch_tier: int | None = None, device: str | torch.device = "cuda"):
        self.min_tier = min_tier
        self.block_tier = block_tier
        self.warmup = warmup
        self.device = resolve(device)
        if max_batch_tier is None:
            max_batch_tier = self.MAX_BATCH_TIER
        cap = min_tier
        while cap * 2 <= max_batch_tier:
            cap *= 2
        self.max_batch_tier = cap
        self.uploads = 0  # host-to-device copies since construction
        self.host_hashed = 0  # messages hashed on the host since construction

    def hash_batch(self, msgs: list[bytes]) -> list[bytes]:
        cap = self.max_batch_tier
        out: list[bytes] = []
        for lo in range(0, len(msgs), cap):
            out.extend(bucketed_hash(msgs[lo:lo + cap], self._hash_bucket,
                                     bucket_key=self._bucket_key))
        return out

    def _bucket_key(self, nb: int) -> int:
        if self.block_tier is not None:
            if nb <= self.block_tier:
                return self.block_tier
            return _next_tier(nb, 2 * self.block_tier)
        if nb <= self.MAX_EXACT_BLOCKS:
            return nb
        return _next_tier(nb, 2 * self.MAX_EXACT_BLOCKS)

    def _hash_bucket(self, sub: list[bytes], key: int, counts: np.ndarray) -> np.ndarray:
        """Hash one bucket; returns digests whose rows ``.tobytes()`` to the
        32-byte digests: (n, 8) u32 from the kernel, (n, 4) u64 from the
        host twin."""
        if self.warmup is not None and not self.warmup.route_bucket(
                self._kind(key), key, _next_tier(len(sub), self.min_tier, self.max_batch_tier)):
            self.host_hashed += len(sub)
            return keccak256_words_masked_np(pad_batch(sub, counts), int(counts.max()), counts)
        words = pad_batch(sub, counts, pad_to_blocks=key).view("<u4")
        w = torch.from_numpy(words).to(self.device)
        c = torch.from_numpy(counts.astype(np.int32)).to(self.device)
        self.uploads += 2
        return keccak256_words_masked(w, c).cpu().numpy()

    def _kind(self, key: int) -> str:
        """The menu program a bucket key runs as (the reference's kinds)."""
        if self.block_tier is None and key <= self.MAX_EXACT_BLOCKS:
            return "keccak.exact"
        return "keccak.masked"

    def hash_one(self, msg: bytes) -> bytes:
        return self.hash_batch([msg])[0]
