"""Shared inputs and the card check for the port's tests (tests/test_torch_*.py)."""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from reth_tpu_torch.primitives.rlp import rlp_encode


def require_card() -> None:
    """Skip the calling test unless a Hopper card is present. Called inside
    tests, never at import, so every pytest worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper (sm_90) card")


def job(n: int, seed: int, val_len=(1, 100)):
    """One secure trie's input: (n, 32) u8 hashed keys, RLP values."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    keys = np.unique(keys.view("S32").ravel()).view(np.uint8).reshape(-1, 32)
    rng.shuffle(keys)
    values = [
        rlp_encode(bytes(rng.integers(0, 256, size=int(rng.integers(*val_len)),
                                      dtype=np.uint8)))
        for _ in range(len(keys))
    ]
    return keys, values


def prefix_jobs(n: int, seed: int):
    """The account trie split into two-nibble prefix subtries (the rebuild's
    start_depth=2 shape)."""
    keys, values = job(n, seed)
    jobs = []
    for pfx in np.unique(keys[:, 0]):
        sel = np.nonzero(keys[:, 0] == pfx)[0]
        jobs.append((keys[sel], [values[i] for i in sel]))
    return jobs


def branches(branch_nodes: dict) -> dict:
    """Branch nodes as plain tuples: the two packages' BranchNode classes
    differ, so dataclass equality alone would never hold across them."""
    return {path: (b.state_mask, b.tree_mask, b.hash_mask, b.hashes)
            for path, b in branch_nodes.items()}


# -- edge levels for the level kernels (packed_level, branch_level) ------------

EDGE_SRC = 256  # child digests come from slots 1..EDGE_SRC-1
EDGE_BUF_ROWS = 1024  # the sources plus every case's output slots
EDGE_LAUNCH_ROWS = (1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 257)
EDGE_CASES = (
    "packed-offsets", "packed-holes-mod8", "packed-holes-straddle", "packed-lengths",
    "packed-tail", "packed-many-holes", "branch-popcounts",
    *(f"packed-rows{n}" for n in EDGE_LAUNCH_ROWS),
    *(f"branch-rows{n}" for n in EDGE_LAUNCH_ROWS),
    "packed-long",
)


def edge_digest_buffer(seed: int = 5) -> np.ndarray:
    """The (EDGE_BUF_ROWS, 32) random digest buffer every edge case starts from."""
    return np.random.default_rng(seed).integers(0, 256, size=(EDGE_BUF_ROWS, 32), dtype=np.uint8)


def _packed_case(rng, rows, order=None):
    """Dispatch arguments of a PACKED level from (gap, length, hole offsets)
    per row: each row lies in ``flat`` after ``gap`` random bytes, and flat
    ends at the last row's last byte. ``order`` permutes the rows (their
    offsets then no longer rise)."""
    parts, row_off, row_len, holes = [], [], [], []
    pos = 0
    for gap, ln, _ in rows:
        parts.append(rng.integers(0, 256, size=gap + ln, dtype=np.uint8))
        row_off.append(pos + gap)
        row_len.append(ln)
        pos += gap + ln
    order = np.arange(len(rows)) if order is None else np.asarray(order)
    for r, src in enumerate(order):
        holes += [(r, off, int(rng.integers(1, EDGE_SRC))) for off in rows[src][2]]
    holes = np.array(holes, dtype=np.int32).reshape(-1, 3)
    holes = holes[rng.permutation(len(holes))].T.copy()  # the engine groups them by row
    return (np.concatenate(parts) if parts else np.zeros(0, np.uint8),
            np.array(row_off, dtype=np.uint32)[order], np.array(row_len, dtype=np.uint32)[order],
            np.arange(EDGE_SRC, EDGE_SRC + len(rows), dtype=np.int32),
            holes if holes.shape[1] else None)


def _branch_case(rng, masks):
    """Dispatch arguments of a BITMAP level: one child per present nibble,
    children shuffled across rows."""
    kids = [(r, nib, int(rng.integers(1, EDGE_SRC)))
            for r, m in enumerate(masks) for nib in range(16) if (m >> nib) & 1]
    kids = np.array(kids, dtype=np.int32)[rng.permutation(len(kids))].T.copy()
    return (np.array(masks, dtype=np.uint16),
            np.arange(EDGE_SRC, EDGE_SRC + len(masks), dtype=np.int32), kids)


def _gap_to(pos: int, mod8: int, rng) -> int:
    """A gap that puts the next row at ``mod8`` modulo 8."""
    return (mod8 - pos) % 8 + 8 * int(rng.integers(0, 3))


def _mask(rng, popcount: int, must=()) -> int:
    nibs = list(must) + [int(x) for x in rng.permutation([b for b in range(16) if b not in must])]
    return sum(1 << b for b in nibs[:popcount])


def edge_level(case: str, seed: int = 5):
    """("packed" | "branch", the engine's dispatch arguments) of one edge case
    (``EDGE_CASES``); numpy only. Packed: (flat, row_off, row_len, slots,
    holes (3, H) [row, byte_off, src_slot] or None); branch: (masks, slots,
    children (3, C) [row, nibble, src_slot]). Output slots start at
    EDGE_SRC, so no row reads a slot its launch writes."""
    rng = np.random.default_rng([seed, EDGE_CASES.index(case)])
    if case == "packed-offsets":  # every row_off % 8, rows out of order
        rows, pos = [], 0
        for m in range(8):
            for ln in (1, 7, 8, 9, 40, 135, 136, 200):
                gap = _gap_to(pos, m, rng)
                rows.append((gap, ln, [0] if ln >= 32 else []))
                pos += gap + ln
        return "packed", _packed_case(rng, rows, order=rng.permutation(len(rows)))
    if case == "packed-holes-mod8":  # a hole at every offset mod 8, rows at every alignment
        rows, pos = [], 0
        for m in range(8):
            for o in range(8):
                gap = _gap_to(pos, m, rng)
                rows.append((gap, 100, [o, 40 + o]))
                pos += gap + 100
        return "packed", _packed_case(rng, rows)
    if case == "packed-holes-straddle":  # holes across the 136/272/408 block edges
        rows = [(int(rng.integers(0, 8)), 543, [b - s for b in (136, 272, 408)])
                for s in (1, 7, 8, 16, 24, 31)]
        rows += [(int(rng.integers(0, 8)), 300, [136 - s, 272 - s]) for s in (3, 29)]
        return "packed", _packed_case(rng, rows)
    if case == "packed-lengths":
        lens = (0, 1, 135, 136, 271, 272, 407, 408, 543)
        rows = [(int(rng.integers(0, 8)), ln, sorted({0, ln - 32}) if ln >= 64 else [])
                for ln in lens]
        return "packed", _packed_case(rng, rows)
    if case == "packed-tail":  # flat ends at the last row's last byte, mid 16-byte chunk
        rows = [(5, 77, [3]), (0, 135, [100]), (3, 541, [509]), (1, 13, [])]
        return "packed", _packed_case(rng, rows)
    if case == "packed-many-holes":  # rows without holes beside rows with 16
        rows = [(int(rng.integers(0, 8)), 543, [1 + 33 * k for k in range(16)] if r % 2 else [])
                for r in range(12)]
        return "packed", _packed_case(rng, rows)
    if case == "packed-long":  # rows past four rate blocks beside short ones in one warp
        # (holes across the 544-byte edge of the kernel's four-block window)
        rows = [(int(rng.integers(0, 8)), ln, holes) for ln, holes in (
            (544, [0, 512]), (30, []), (680, [544 - 31, 600]), (700, [544 - 8, 640]),
            (690, [544 - 1, 600]), (600, [544]), (1000, [1 + 37 * k for k in range(26)]),
            (5, []), (1088, [1020, 1060]), (1500, [136 * k - 3 for k in range(1, 11)]),
            (2000, [1967]), (300, [100]))]
        return "packed", _packed_case(rng, rows)
    if case == "branch-popcounts":  # popcount 2..16, nibbles 0 and 15, f8 (7) vs f9 (8)
        masks = [_mask(rng, p, must) for p in range(2, 17) for must in ((0, 15), (0,), (15,), ())]
        return "branch", _branch_case(rng, masks)
    kind, n = case.split("-rows")
    n = int(n)
    if kind == "packed":  # 1-block and 4-block rows mixed within each warp
        rows = []
        for _ in range(n):
            ln = int(rng.choice([0, 50, 130, 200, 300, 500, 543]))
            offs = [o for o in (int(rng.integers(0, 8)), ln - 32) if ln >= 72]
            rows.append((int(rng.integers(0, 8)), ln, sorted(set(offs))))
        return "packed", _packed_case(rng, rows)
    masks = [_mask(rng, int(rng.choice([2, 3, 7, 8, 16]))) for _ in range(n)]
    return "branch", _branch_case(rng, masks)


def level_kernel_args(kind: str, args, device) -> tuple:
    """The wrapper arguments (all but ``buf``) of ``packed_level`` /
    ``branch_level`` for an edge case's dispatch arguments, as the port's
    engine builds them."""
    from reth_tpu_torch.ops.fused_commit import _csr

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a).astype(dtype)).to(device)

    if kind == "packed":
        flat, row_off, row_len, slots, holes = args
        holes = holes if holes is not None else np.zeros((3, 0), np.int32)
        order, start = _csr(holes[0], len(row_off))
        return (put(flat, np.uint8), put(row_off, np.int64), put(row_len, np.int32),
                put(slots, np.int64), put(start, np.int64), put(holes[1][order], np.int32),
                put(holes[2][order], np.int64))
    masks, slots, children = args
    order, start = _csr(children[0], len(masks))
    return (put(masks, np.int32), put(slots, np.int64), put(start, np.int64),
            put(children[1][order], np.int32), put(children[2][order], np.int64))


# -- chunks of dependent levels for kernel 4 (subtrie_levels) -------------------


def level_b_tier(kind: str, args) -> int:
    """A level's block tier as the native sweep gives it (a branch level's
    is 4): the power of two above its longest row's rate blocks."""
    if kind == "branch":
        return 4
    nb = int(args[2].max()) // 136 + 1 if len(args[2]) else 1
    return 1 << (nb - 1).bit_length()


def edge_chain(extra_rows: int = 0, seed: int = 5):
    """Every edge level in order, each reading only digests the level before
    it wrote (the first reads slots 1..EDGE_SRC-1), each writing slots of
    its own; with ``extra_rows``, a last PACKED level of that many rows
    (1-5 rate blocks, a hole in every row of 32 bytes or more). Returns
    ([(kind, dispatch arguments)], digest buffer rows needed)."""
    levels, base, prev = [], EDGE_SRC, (1, EDGE_SRC - 1)
    cases = [edge_level(case, seed) for case in EDGE_CASES]
    if extra_rows:
        rng = np.random.default_rng([seed, len(EDGE_CASES)])
        lens = rng.choice([0, 20, 100, 135, 136, 300, 543], size=extra_rows)
        rows = [(int(g), int(ln), [0] if ln >= 32 else [])
                for g, ln in zip(rng.integers(0, 8, size=extra_rows), lens)]
        cases.append(("packed", _packed_case(rng, rows)))
    for kind, args in cases:
        args = list(args)
        si, ei = (3, 4) if kind == "packed" else (1, 2)
        n = len(args[si])
        args[si] = np.arange(base, base + n, dtype=np.int32)
        if args[ei] is not None:
            entries = args[ei].copy()
            entries[2] = prev[0] + (entries[2] - 1) % prev[1]
            args[ei] = entries
        levels.append((kind, tuple(args)))
        prev, base = (base, n), base + n
    return levels, base


def staged_chunks(levels, k: int, device) -> list[tuple]:
    """``levels`` staged by the port's SubtrieFusedEngine(k) and uploaded to
    ``device``: each chunk's ``subtrie_levels`` arguments but the buffer."""
    from reth_tpu_torch.ops.fused_commit import SubtrieFusedEngine

    eng = SubtrieFusedEngine(min_tier=8, k=k, device=device)
    eng.begin(0)
    for kind, args in levels:
        if kind == "packed":
            eng.dispatch_packed(*args, b_tier=level_b_tier(kind, args))
        else:
            eng.dispatch_branch(*args)
    u8, idx, plan, t_off = eng._stage_flush()
    return eng._chunk_args(eng._to_device(u8), eng._to_device(idx), t_off, plan,
                           eng._chunk_plan(plan, k))


# -- chunks around kernel 4's path split (five lanes a row on narrow steps) ----

# kernel 4's five-lane limit on an H100: 396 co-resident blocks x 16 rows
# (on the card, fused_commit.subtrie_lanes5_rows() gives the card's own)
LANES5_ROWS_H100 = 396 * 16


def threshold_chain(limit: int = LANES5_ROWS_H100, seed: int = 7):
    """Levels around kernel 4's path split, each reading only digests the
    level before it wrote (the first reads slots 1..EDGE_SRC-1); numpy only.
    Rows lie tight and in order in ``flat``, as the native sweep emits them,
    so the JAX package's staged engines take these levels too:
    - PACKED levels of 1, 15 and 16 rows, then a BITMAP level of 17 rows of
      1-4 rate blocks;
    - a PACKED level of 17 rows of 1-15 rate blocks (block tier 16: a chunk
      of its own);
    - PACKED levels of ``limit`` rows (the largest five-lane step) and
      ``limit + 1`` (one thread a row), then a BITMAP level of 40 rows and a
      PACKED one of 3: narrow steps whose children the wide step wrote in
      the same launch (k >= 4 puts these four levels in one chunk).
    Returns ([(kind, dispatch arguments)], digest buffer rows needed)."""
    rng = np.random.default_rng(seed)

    def packed(lens):
        # holes that do not overlap: one in a row of 32-63 bytes, two above
        rows = [(0, int(ln), [int(rng.integers(0, ln - 63)), int(ln) - 32] if ln >= 64
                 else [0] if ln >= 32 else []) for ln in lens]
        return "packed", _packed_case(rng, rows)

    def short(n):  # 1-4 rate blocks, mostly one
        return rng.choice([0, 20, 33, 100, 135, 136, 300, 543], size=n, p=[.05, .2, .2, .25, .1,
                                                                          .1, .05, .05])

    def branch(pops):
        return "branch", _branch_case(rng, [_mask(rng, int(p)) for p in pops])

    cases = [packed(short(1)), packed(short(15)), packed(short(16)),
             branch([2, 3, 4, 7, 8, 11, 12, 16, 2, 5, 9, 13, 15, 3, 6, 10, 14]),
             packed([136 * b - int(rng.integers(1, 136)) for b in range(1, 16)] + [2039, 1904]),
             packed(short(limit)), packed(short(limit + 1)),
             branch(rng.choice([2, 3, 4, 8, 16], size=40)), packed(short(3))]
    levels, base, prev = [], EDGE_SRC, (1, EDGE_SRC - 1)
    for kind, args in cases:
        args = list(args)
        si, ei = (3, 4) if kind == "packed" else (1, 2)
        n = len(args[si])
        args[si] = np.arange(base, base + n, dtype=np.int32)
        if args[ei] is not None:
            entries = args[ei].copy()
            entries[2] = prev[0] + (entries[2] - 1) % prev[1]
            args[ei] = entries
        levels.append((kind, tuple(args)))
        prev, base = (base, n), base + n
    return levels, base


# -- template levels for the general committer's dispatch_level -----------------

TEMPLATE_SRC = 40  # source digests in slots 1..TEMPLATE_SRC-1; outputs from slot TEMPLATE_SRC on
TEMPLATE_BUF_ROWS = 128
# template lengths at the rate-block edges, up to 15 blocks (block tier 16)
TEMPLATE_LENS = (32, 135, 136, 271, 272, 600, 15 * 136 - 1)
TEMPLATE_CASES = ("plain", "spliced", "chained", "random")


def _template_holes(length: int) -> list[int]:
    """Hole offsets inside a template of ``length`` bytes: at byte 0, one
    across the first rate-block edge, and one at the last 32 bytes, as far
    as they fit without overlapping."""
    offs = [0]
    if length >= 184:
        offs.append(120)
    if length >= 64:
        offs.append(length - 32)
    return offs


def template_level(rng, lens, spliced: bool, slot0: int, src=range(1, TEMPLATE_SRC)):
    """(templates, slots, holes [(row, byte_off, src_slot)]) of one level."""
    templates = [rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes() for n in lens]
    slots = list(range(slot0, slot0 + len(lens)))
    src = list(src)
    holes = [(r, off, src[int(rng.integers(0, len(src)))])
             for r, n in enumerate(lens) for off in (_template_holes(int(n)) if spliced else ())]
    return templates, slots, holes


def _random_template_level(rng, n_rows: int, slot0: int):
    """Rows of random lengths (32 bytes to 15 blocks) with random
    non-overlapping holes."""
    lens = [int(rng.integers(32, 15 * 136)) for _ in range(n_rows)]
    templates = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes() for n in lens]
    holes = []
    for r, n in enumerate(lens):
        at = int(rng.integers(0, 40))
        while at + 32 <= n:
            holes.append((r, at, int(rng.integers(1, TEMPLATE_SRC))))
            at += 32 + int(rng.integers(0, 200))
    return templates, list(range(slot0, slot0 + n_rows)), holes


def template_levels(case: str, rng) -> list:
    """The levels of one ``TEMPLATE_CASES`` case, deepest first: "plain"
    (no holes), "spliced" (holes at byte 0, across a block edge and at the
    last 32 bytes), "chained" (a second level splicing the first's
    digests), "random" (40 rows of random lengths and holes)."""
    if case == "plain":
        return [template_level(rng, TEMPLATE_LENS, False, TEMPLATE_SRC)]
    if case == "spliced":
        return [template_level(rng, TEMPLATE_LENS, True, TEMPLATE_SRC)]
    if case == "chained":
        first = template_level(rng, TEMPLATE_LENS, True, TEMPLATE_SRC)
        second = template_level(rng, TEMPLATE_LENS[::-1], True,
                                TEMPLATE_SRC + len(TEMPLATE_LENS), src=first[1])
        return [first, second]
    return [_random_template_level(rng, 40, TEMPLATE_SRC)]


def template_bucket(cls, level, rng=None):
    """The level as a bucket of ``cls`` (either package's ``_Bucket``);
    with ``rng``, its holes in a shuffled order (the port groups them by
    row itself)."""
    templates, slots, holes = level
    b = cls()
    for t, s in zip(templates, slots):
        b.add(t, len(t) // 136 + 1, s, [])
    b.holes = list(holes)
    if rng is not None:
        rng.shuffle(b.holes)
    return b


def template_buffer(rng) -> np.ndarray:
    """A (TEMPLATE_BUF_ROWS, 32) digest buffer, random in the source slots."""
    buf = np.zeros((TEMPLATE_BUF_ROWS, 32), dtype=np.uint8)
    buf[1:TEMPLATE_SRC] = rng.integers(0, 256, size=(TEMPLATE_SRC - 1, 32), dtype=np.uint8)
    return buf


# -- sparse live-tip states (trie/sparse.py) ------------------------------------


def sparse_state(mod, seed: int, tries: int = 10, slots: int = 24):
    """A fully revealed, not yet hashed ``mod.SparseStateTrie`` (``mod`` is
    either package's ``trie.sparse``): ``tries`` storage tries of ``slots``
    random slots (the first deleted again) and their account leaves.
    Returns (state, owners, slot keys by owner)."""
    rng = np.random.default_rng(seed)
    st = mod.SparseStateTrie()
    owners, slot_keys = [], {}
    for _ in range(tries):
        ha = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
        owners.append(ha)
        t = st.storage_trie(ha)
        keys = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(slots)]
        slot_keys[ha] = keys
        for k in keys:
            t.update(k, bytes(rng.integers(1, 256, 8, dtype=np.uint8)))
        t.delete(keys[0])
        st.update_account(ha, b"account-leaf-" + ha)
    return st, owners, slot_keys


def sparse_block(st, owners, slot_keys, seed: int, dirty: int = 4, wipe_every: int = 4) -> None:
    """One block's dirty set on ``st``: ``dirty`` writes to random slots and
    one delete per storage trie, every ``wipe_every``-th trie wiped, a new
    slot in a few, and every account leaf rewritten."""
    rng = np.random.default_rng(seed)
    for i, ha in enumerate(owners):
        keys = slot_keys[ha]
        if i % wipe_every == wipe_every - 1:
            st.storage_tries[ha] = type(st.account_trie)()
        t = st.storage_trie(ha)
        for j in rng.integers(0, len(keys), size=dirty):
            t.update(keys[int(j)], bytes(rng.integers(1, 256, 8, dtype=np.uint8)))
        t.delete(keys[int(rng.integers(0, len(keys)))])
        if i % 3 == 0:
            t.update(bytes(rng.integers(0, 256, 32, dtype=np.uint8)), b"\x07\x08")
        st.update_account(ha, bytes(rng.integers(1, 256, 40, dtype=np.uint8)))


# -- delta commits of the hot-state arena (SubtrieFusedEngine.begin_delta) -----


def arena_level(rng, n: int, slot0: int, srcs=()):
    """``dispatch_packed``'s arguments for one level of ``n`` rows of 40-140
    random bytes at slots slot0.., each row with a hole at byte 3 whose
    digest comes from ``srcs`` (cycled) when given."""
    rows = [rng.integers(0, 256, int(rng.integers(40, 140)), dtype=np.uint8).tobytes()
            for _ in range(n)]
    row_len = np.array([len(r) for r in rows], dtype=np.uint32)
    row_off = (np.cumsum(row_len) - row_len).astype(np.uint32)
    holes = (np.array([[i, 3, srcs[i % len(srcs)]] for i in range(n)], dtype=np.int32).T
             if len(srcs) else None)
    return (np.frombuffer(b"".join(rows), dtype=np.uint8), row_off, row_len,
            np.arange(slot0, slot0 + n, dtype=np.int32), holes, 2)


# -- the commitment stages' state and blocks (stages/, storage/) ---------------

# one block after the clean rebuild: accounts rewritten (of them new), accounts
# deleted together with their storage, slot writes over owners (of them set to
# zero); chip_smoke.py's size, and a small one for the CPU tests
STAGE_BLOCK = dict(accounts=2048, new=128, wiped=16, slots=4096, owners=512, zeroed=256)
STAGE_BLOCK_SMALL = dict(accounts=24, new=4, wiped=2, slots=48, owners=8, zeroed=4)


def stage_state(account_cls, n_accounts: int, n_slots: int, seed: int):
    """Plain state: ``n_accounts`` random 20-byte addresses with
    ``account_cls`` accounts, and ``n_slots`` slots spread over the first
    ``n_accounts // 10`` (chip_smoke.py's ``plain_state``). Returns
    (accounts by address, {owner: {slot: value}})."""
    rng = np.random.default_rng(seed)
    addrs = [bytes(a) for a in rng.integers(0, 256, size=(n_accounts, 20), dtype=np.uint8)]
    balances = rng.integers(1, 1 << 60, size=n_accounts)
    accounts = {a: account_cls(nonce=i % 300, balance=int(balances[i]))
                for i, a in enumerate(addrs)}
    owners = addrs[: max(1, n_accounts // 10)]
    slots = rng.integers(0, 256, size=(n_slots, 32), dtype=np.uint8)
    values = rng.integers(1, 1 << 60, size=n_slots)
    storages: dict[bytes, dict[bytes, int]] = {}
    for k in range(n_slots):
        storages.setdefault(owners[k % len(owners)], {})[bytes(slots[k])] = int(values[k])
    return accounts, storages


def load_stage_state(factory, accounts: dict, storages: dict, header) -> None:
    """The plain state into PlainAccountState / PlainStorageState through
    the provider, with ``header`` (block 0)."""
    with factory.provider_rw() as p:
        for addr, acc in accounts.items():
            p.put_account(addr, acc)
        for addr, slots in storages.items():
            for slot, value in slots.items():
                p.put_storage(addr, slot, value)
        p.insert_header(header)


def stage_block(accounts: dict, storages: dict, b: int, seed: int, account_cls,
                sizes: dict = STAGE_BLOCK):
    """Block ``b``'s writes, seeded, on the plain state as the blocks before
    left it, ``accounts`` and ``storages`` (a mirror, updated here): ``sizes
    ["accounts"]`` accounts rewritten, ``sizes["new"]`` of them new;
    ``sizes["wiped"]`` owners deleted with their storage; ``sizes["slots"]``
    slot writes over ``sizes["owners"]`` other owners, the first
    ``sizes["zeroed"]`` setting an existing slot to zero. Returns (account
    writes [(addr, prev, new)], slot writes [(addr, slot, prev, new)], wiped
    addresses); a deleted account's new is None, a new one's prev None."""
    rng = np.random.default_rng(seed * 1000 + b)
    owners = [a for a in storages if a in accounts and storages[a]]
    live = list(accounts)
    picks = rng.choice(len(owners), size=sizes["wiped"] + sizes["owners"], replace=False)
    wiped = [owners[i] for i in picks[:sizes["wiped"]]]
    writers = [owners[i] for i in picks[sizes["wiped"]:]]
    n_old = sizes["accounts"] - sizes["new"]
    rewritten = [live[i] for i in rng.choice(len(live), size=n_old + sizes["wiped"],
                                             replace=False) if live[i] not in wiped][:n_old]
    new = [bytes(a) for a in rng.integers(0, 256, size=(sizes["new"], 20), dtype=np.uint8)]
    balances = rng.integers(1, 1 << 60, size=sizes["accounts"])
    acct_writes = [(a, accounts.get(a), account_cls(nonce=b, balance=int(v)))
                   for a, v in zip(rewritten + new, balances)]
    acct_writes += [(a, accounts[a], None) for a in wiped]
    slot_writes = []
    for k in range(sizes["slots"]):
        owner = writers[k % sizes["owners"]]
        slots = storages[owner]
        if k < sizes["zeroed"]:
            slot = min(slots)
            value = 0
        else:
            slot = bytes(rng.integers(0, 256, size=32, dtype=np.uint8))
            value = int(rng.integers(1, 1 << 60))
        slot_writes.append((owner, slot, slots.get(slot, 0), value))
        if value:
            slots[slot] = value
        else:
            slots.pop(slot)
    for a in wiped:
        slot_writes += [(a, slot, v, 0) for slot, v in sorted(storages.pop(a).items())]
    for a, _prev, acc in acct_writes:
        if acc is None:
            accounts.pop(a)
        else:
            accounts[a] = acc
    return acct_writes, slot_writes, wiped


def apply_stage_block(factory, block, b: int, header=None, convert=lambda acc: acc) -> None:
    """Block ``b``'s plain-state writes with their changesets
    (``record_account_change`` / ``record_storage_change``), a wiped
    account's storage cleared with it, and ``header`` when given.
    ``convert`` maps the block's accounts onto the provider's account type."""
    acct_writes, slot_writes, wiped = block
    with factory.provider_rw() as p:
        for addr, prev, acc in acct_writes:
            p.record_account_change(b, addr, None if prev is None else convert(prev))
            p.put_account(addr, None if acc is None else convert(acc))
        for addr, slot, prev, value in slot_writes:
            p.record_storage_change(b, addr, slot, prev)
            p.put_storage(addr, slot, value)
        for addr in wiped:
            p.clear_account_storage(addr)
        if header is not None:
            p.insert_header(header)


# -- the live tip's block outputs and their write-back (engine/) ----------------


def stage_block_output(block, output_cls, changes_cls, convert=lambda acc: acc):
    """Block ``b``'s ``BlockExecutionOutput`` (``output_cls``, with a
    ``changes_cls`` ``BlockChanges``) from ``stage_block``'s tuples:
    ``changes.accounts`` / ``.storage`` the prior values, ``wiped_storage``
    the deleted owners, ``post_accounts`` (None for a deleted account) and
    ``post_storage`` the new ones. A wiped owner's storage is in
    ``wiped_storage`` alone: its cleared slots are no slot writes.
    ``convert`` maps the block's accounts onto the package's account type."""
    acct_writes, slot_writes, wiped = block
    changes = changes_cls(wiped_storage=set(wiped))
    out = output_cls(changes=changes)
    for addr, prev, acc in acct_writes:
        changes.accounts.setdefault(addr, None if prev is None else convert(prev))
        out.post_accounts[addr] = None if acc is None else convert(acc)
    for addr, slot, prev, value in slot_writes:
        if addr in changes.wiped_storage:
            continue
        changes.storage.setdefault(addr, {}).setdefault(slot, prev)
        out.post_storage.setdefault(addr, {})[slot] = value
    return out


def stage_block_bursts(out, n: int, seed: int) -> list[list]:
    """The keys a block's execution touches, as ``SparseRootTask.
    on_state_update`` takes them (addresses and ``(address, slot)`` pairs),
    shuffled with ``seed`` and cut into ``n`` bursts, one a transaction."""
    keys = list(out.post_accounts) + [(a, s) for a, slots in out.post_storage.items()
                                      for s in slots]
    order = np.random.default_rng(seed).permutation(len(keys))
    return [[keys[i] for i in part] for part in np.array_split(order, n)]


def write_back_updates(provider, out, digest_map, updates) -> None:
    """``SparseRootTask.export_updates``' result onto ``provider``'s trie
    tables, as the reference's engine tree writes a sparse block
    (``reth_tpu/engine/tree.py`` ``_write_sparse_output``, its trie half): a
    wiped owner's stored branches first, then the account branch puts and
    deletes, then the storage branch puts and deletes."""
    account_updates, storage_updates = updates
    for a in out.changes.wiped_storage:
        provider.delete_storage_branches_with_prefix(digest_map[a], b"")
    for path, node in account_updates.items():
        if node is None:
            provider.delete_account_branch(path)
        else:
            provider.put_account_branch(path, node)
    for ha, upd in storage_updates.items():
        for path, node in upd.items():
            if node is None:
                provider.delete_storage_branch(ha, path)
            else:
                provider.put_storage_branch(ha, path, node)


class StageDb:
    """One package's MemDb at ``stage_state``'s plain state, for the proof
    and live-tip tests: the hashing stages and the single-shot numpy
    rebuild (header 1), then each block's writes, hashing stages and
    ``MerkleStage._incremental`` (the block's header root and tables), as
    chip_smoke.py's MerkleStage twin builds them. ``port=False`` builds the
    JAX package's (imported here, so that this module stays free of it).
    Both run the numpy route on the host: these databases are the tests'
    inputs, and the stage tests hold the routes themselves. ``tables[b]`` is
    the published table map after block ``b`` (immutable: a free
    snapshot), ``roots[b]`` its state root."""

    def __init__(self, port: bool, accounts: dict, storages: dict):
        if port:
            from reth_tpu_torch import stages
            from reth_tpu_torch.primitives import types
            from reth_tpu_torch.primitives.keccak import keccak256_batch_np
            from reth_tpu_torch.stages import merkle
            from reth_tpu_torch.storage import kv, provider
            from reth_tpu_torch.trie import incremental
            from reth_tpu_torch.trie.committer import TrieCommitter

            self.committer = TrieCommitter(hasher=keccak256_batch_np, device="cpu")
            self.convert = lambda acc: acc
        else:
            from reth_tpu import stages
            from reth_tpu.primitives import types
            from reth_tpu.primitives.keccak import keccak256_batch_np
            from reth_tpu.stages import merkle
            from reth_tpu.storage import kv, provider
            from reth_tpu.trie import incremental
            from reth_tpu.trie.committer import TrieCommitter

            self.committer = TrieCommitter(hasher=keccak256_batch_np)
            self.convert = lambda acc: types.Account(acc.nonce, acc.balance, acc.storage_root,
                                                     acc.code_hash)
        self.port, self.kv, self.provider, self.types = port, kv, provider, types
        self.stages, self.merkle = stages, merkle
        self.committer.turbo_backend = "numpy"
        self.hashing = [stages.AccountHashingStage(self.committer),
                        stages.StorageHashingStage(self.committer)]
        self.db = kv.MemDb()
        self.factory = provider.ProviderFactory(self.db)
        load_stage_state(self.factory, {a: self.convert(acc) for a, acc in accounts.items()},
                         storages, types.Header(number=0))
        stages.Pipeline(self.factory, self.hashing).run(1)
        with self.factory.provider_rw() as p:
            root = incremental.full_state_root_turbo(p, backend="numpy")
            p.insert_header(types.Header(number=1, state_root=root))
        self.roots = {1: root}
        self.tables = {1: self.db._tables}

    def advance(self, block, b: int) -> bytes:
        """Block ``b``'s writes, hashing stages and incremental root."""
        apply_stage_block(self.factory, block, b, convert=self.convert)
        self.stages.Pipeline(self.factory, self.hashing).run(b)
        with self.factory.provider_rw() as p:
            root = self.merkle.MerkleStage(self.committer)._incremental(p, b, b)
            p.insert_header(self.types.Header(number=b, state_root=root))
        self.roots[b] = root
        self.tables[b] = self.db._tables
        return root

    def at(self, b: int):
        """A fresh MemDb over the tables after block ``b``, and its factory:
        writes to it leave this database as it is."""
        db = self.kv.MemDb()
        db._tables = self.tables[b]
        return db, self.provider.ProviderFactory(db)


def stage_pair(n_accounts: int, n_slots: int, seed: int, blocks=(), sizes: dict = STAGE_BLOCK,
               packages=(False, True)):
    """One ``StageDb`` for each of ``packages`` (False: the JAX package's,
    True: the port's) at one seeded state, each taken through ``blocks``
    (``stage_block`` at ``sizes``); and the blocks' tuples by number."""
    from reth_tpu_torch.primitives.types import Account

    accounts, storages = stage_state(Account, n_accounts, n_slots, seed)
    dbs = [StageDb(port, accounts, storages) for port in packages]
    made = {}
    for b in blocks:
        made[b] = stage_block(accounts, storages, b, seed, Account, sizes)
        roots = {db.advance(made[b], b) for db in dbs}
        assert len(roots) == 1, f"block {b}: the packages' incremental roots differ"
    return (*dbs, made)


# -- the staged-sync chain (chip_smoke.py "sync", tests/test_torch_execution.py) --
#
# A genesis of ``stage_state`` accounts plus funded wallets and three
# hand-assembled contracts, and blocks shaped like a mainnet block at a
# 30,000,000 gas limit, sealed by executing them (``ChainBuilder``). Every
# function takes the package it builds with (``pkg``: an object with the
# package's ``testing``, ``types``, ``keccak`` and ``secp256k1`` modules), so
# the same code builds the chain on either package.

# the full block (chip_smoke.py) and the tests' small one: ETH transfers
# (types 0, 1, 2 in turn; ``fresh`` of them to new addresses), token
# transfers (``new_holders`` of them to new holders), storage-writer calls,
# precompile calls, CREATE deploys of a ``runtime``-byte contract, type-4
# transactions with one authorization each, and withdrawals
SYNC_BLOCK = dict(transfers=100, fresh=40, token=100, new_holders=25, writes=30, precompiles=12,
                  creates=2, runtime=6000, setcode=1, withdrawals=16)
SYNC_BLOCK_SMALL = dict(transfers=6, fresh=2, token=4, new_holders=1, writes=2, precompiles=6,
                        creates=1, runtime=96, setcode=1, withdrawals=2)
SYNC_CHAIN_ID = 1
TOKEN_SUPPLY = 10**24  # each wallet's token balance at genesis
WALLET_WEI = 10**21


def _push(n: int, width: int) -> bytes:
    return bytes([0x5F + width]) + n.to_bytes(width, "big")


def token_code(transfer_topic: bytes) -> bytes:
    """An ERC-20-shaped ``transfer(to, amount)``: calldata is two words, the
    balances mapping sits at slot 0 (``keccak(pad32(holder) . pad32(0))``).
    Reverts when the caller's balance is short; else two SSTOREs and a LOG3
    (topic ``transfer_topic``, from, to; data the amount)."""
    head = bytes.fromhex(
        "335f52"        # mstore(0, caller)
        "5f602052"      # mstore(32, 0)
        "60405f20"      # s_from = keccak(0, 64)
        "8054"          # bal_from = sload(s_from)
        "602035"        # amount
        "808210"        # bal_from < amount
    )
    rest_head = bytes.fromhex(
        "57"            # jumpi(revert, short)
        "900390"        # s_from, bal_from - amount -> new, s_from
        "55"            # sstore(s_from, new)
        "5f355f52"      # mstore(0, to)
        "60405f20"      # s_to
        "8054602035019055"  # sstore(s_to, sload(s_to) + amount)
        "6020355f52"    # mstore(0, amount)
        "5f3533"        # topic2 = to, topic1 = caller
    ) + b"\x7f" + transfer_topic + bytes.fromhex("60205fa300")  # log3(0, 32, ...); stop
    dest = len(head) + 2 + len(rest_head)
    return head + _push(dest, 1) + rest_head + bytes.fromhex("5b5f5ffd")


# sstore(cd[0], v), sstore(cd[1], v), sstore(cd[2], v), sstore(cd[3], v),
# sstore(cd[4], 0) with v = cd[5]: four slot writes and one slot zeroed
WRITER_CODE = bytes.fromhex("60a035" "805f3555" "80602035" "55" "80604035" "55" "80606035" "55"
                            "505f60803555" "00")
# staticcall(gas, cd[0], input = cd[32:], out = 32 bytes at 0), then
# sstore(cd[0], mload(0)): the precompile's first output word lands in the
# slot named by its address
CALLER_CODE = bytes.fromhex("602036038060205f37" "60205f825f5f355afa" "5f515f3555" "00")
# blake2f's EIP-152 vector at 12 rounds
BLAKE2F_INPUT = bytes.fromhex(
    "0000000c48c9bdf267e6096a3ba7ca8485ae67bb2bf894fe72f36e3cf1361d5f3af54fa5"
    "d182e6ad7f520e511f6c3e2b8c68059b6bbd41fbabd9831f79217e1319cde05b"
    "6162630000000000000000000000000000000000000000000000000000000000"
    "0000000000000000000000000000000000000000000000000000000000000000"
    "0000000000000000000000000000000000000000000000000000000000000000"
    "0000000000000000000000000000000000000000000000000000000000000000"
    "0300000000000000" "0000000000000000" "01")
SYNC_PRECOMPILES = (1, 2, 5, 6, 7, 9)


def initcode_for(runtime: bytes) -> bytes:
    """Initcode that returns ``runtime`` (up to 65,535 bytes)."""
    n = len(runtime)
    return _push(n, 2) + bytes.fromhex("600c5f39") + _push(n, 2) + bytes.fromhex("5ff3") + runtime


def _word(n: int) -> bytes:
    return n.to_bytes(32, "big")


def _address(a: bytes) -> bytes:
    return b"\x00" * 12 + a


def token_slot(keccak, holder: bytes) -> bytes:
    return keccak(_address(holder) + _word(0))


class SyncChain:
    """The staged-sync chain, built on ``pkg``: ``stage_state(n_accounts,
    n_slots, seed)`` plus ``n_wallets`` wallets (keys from the seed, 10^21
    wei each), the token (every wallet a holder), the storage writer (its
    slots to zero prefilled) and the precompile caller; then ``n_blocks``
    blocks of ``sizes``, each sealed by ``pkg.testing.ChainBuilder`` on
    ``committer`` (with ``seal=False`` the caller seals them, one ``block()``
    call each). ``senders[b]`` lists block b's signing addresses in order.
    ``spare`` more batches of the same shape can be signed after the blocks
    and left unsealed (``batch()``): the genesis prefills their writer slots
    and draws their type-4 authorities."""

    TOKEN = b"\x70" * 19 + b"\x01"
    WRITER = b"\x70" * 19 + b"\x02"
    CALLER = b"\x70" * 19 + b"\x03"

    def __init__(self, pkg, n_accounts: int, n_slots: int, seed: int, n_wallets: int,
                 n_blocks: int, sizes: dict, committer, seal: bool = True, spare: int = 0):
        t, keccak = pkg.types, pkg.keccak.keccak256
        self.pkg, self.sizes, self.seed = pkg, sizes, seed
        rng = np.random.default_rng(seed)
        keys = rng.integers(1, 1 << 62, size=n_wallets + n_blocks + spare, dtype=np.int64)
        self.wallets = [pkg.testing.Wallet(int(k) * 7919 + 1) for k in keys[:n_wallets]]
        # the type-4 authorities: one fresh wallet a block, never a sender
        self.authorities = [pkg.testing.Wallet(int(k) * 7919 + 3) for k in keys[n_wallets:]]
        accounts, storages = stage_state(t.Account, n_accounts, n_slots, seed)
        topic = keccak(b"Transfer(address,address,uint256)")
        self.codes = {self.TOKEN: token_code(topic), self.WRITER: WRITER_CODE,
                      self.CALLER: CALLER_CODE}
        for addr, code in self.codes.items():
            accounts[addr] = t.Account(nonce=1, code_hash=keccak(code))
        for w in self.wallets:
            accounts[w.address] = t.Account(balance=WALLET_WEI)
        storages[self.TOKEN] = {token_slot(keccak, w.address): TOKEN_SUPPLY for w in self.wallets}
        # one prefilled slot for each writer call to zero
        n_zero = (sizes["writes"] + sizes["setcode"]) * (n_blocks + spare)
        storages[self.WRITER] = {_word(i + 1): i + 1 for i in range(n_zero)}
        self.zero_slots = [_word(i + 1) for i in range(n_zero)]
        self.builder = pkg.testing.ChainBuilder(
            accounts, storages, {keccak(c): c for c in self.codes.values()},
            chain_id=SYNC_CHAIN_ID, committer=committer)
        self.existing = list(accounts)[: max(1, n_accounts)]
        self.senders: dict[int, list[bytes]] = {}
        self.withdrawal_index = 0
        self.unsealed = 0  # batches signed by batch() past the sealed tip
        for _ in range(n_blocks if seal else 0):
            self.block()

    def _sender(self, i: int):
        return self.wallets[i % len(self.wallets)]

    def _precompile_input(self, idx: int, rng, wallet) -> bytes:
        keccak = self.pkg.keccak.keccak256
        if idx == 1:
            h = keccak(bytes(rng.integers(0, 256, size=32, dtype=np.uint8)))
            parity, r, s = self.pkg.secp256k1.sign(h, wallet.priv)
            return h + _word(27 + parity) + _word(r) + _word(s)
        if idx == 2:
            return bytes(rng.integers(0, 256, size=64, dtype=np.uint8))
        if idx == 5:
            base, exp, mod = (int(x) for x in rng.integers(1, 1 << 62, size=3))
            return _word(32) * 3 + _word(base) + _word(exp) + _word(mod | 1)
        if idx == 6:
            return _word(1) + _word(2) + _word(1) + _word(2)
        if idx == 7:
            return _word(1) + _word(2) + _word(int(rng.integers(1, 1 << 62)))
        return BLAKE2F_INPUT

    def block(self):
        """Seal the next block: its transactions in the order ETH transfers,
        token transfers, writer calls, precompile calls, deploys, type 4."""
        txs, withdrawals = self._batch(self.builder.tip.number + 1)
        return self.builder.build_block(txs, withdrawals=tuple(withdrawals))

    def batch(self):
        """Sign the next block's transactions and withdrawals without sealing
        it (block tip + 1, then tip + 2, ...): the same wallets at their next
        nonces. Returns ``(number, transactions, withdrawals)``."""
        self.unsealed += 1
        b = self.builder.tip.number + self.unsealed
        txs, withdrawals = self._batch(b)
        return b, txs, withdrawals

    def _batch(self, b: int):
        t, sz = self.pkg.types, self.sizes
        rng = np.random.default_rng(self.seed * 1000 + b)
        txs, senders = [], []
        i = 0

        def fresh() -> bytes:
            return bytes(rng.integers(0, 256, size=20, dtype=np.uint8))

        def signed(w, tx):
            txs.append(w.sign_tx(tx))
            senders.append(w.address)

        for k in range(sz["transfers"]):
            w = self._sender(i)
            i += 1
            to = fresh() if k < sz["fresh"] else self._sender(i + 7).address
            value = int(rng.integers(1, 10**15))
            if k % 3 == 0:
                tx = t.Transaction(tx_type=0, chain_id=SYNC_CHAIN_ID, nonce=w.nonce,
                                   gas_price=50 * 10**9, gas_limit=21_000, to=to, value=value)
            elif k % 3 == 1:
                tx = t.Transaction(tx_type=1, chain_id=SYNC_CHAIN_ID, nonce=w.nonce,
                                   gas_price=50 * 10**9, gas_limit=21_000, to=to, value=value)
            else:
                tx = t.Transaction(tx_type=2, chain_id=SYNC_CHAIN_ID, nonce=w.nonce,
                                   max_fee_per_gas=100 * 10**9, max_priority_fee_per_gas=10**9,
                                   gas_limit=21_000, to=to, value=value)
            signed(w, tx)
        for k in range(sz["token"]):
            w = self._sender(i)
            i += 1
            to = fresh() if k < sz["new_holders"] else self._sender(i + 3).address
            data = _word(int.from_bytes(to, "big")) + _word(int(rng.integers(1, 10**9)))
            signed(w, t.Transaction(tx_type=2, chain_id=SYNC_CHAIN_ID, nonce=w.nonce,
                                    max_fee_per_gas=100 * 10**9, max_priority_fee_per_gas=10**9,
                                    gas_limit=100_000, to=self.TOKEN, data=data))
        for k in range(sz["writes"]):
            w = self._sender(i)
            i += 1
            signed(w, t.Transaction(tx_type=2, chain_id=SYNC_CHAIN_ID, nonce=w.nonce,
                                    max_fee_per_gas=100 * 10**9, max_priority_fee_per_gas=10**9,
                                    gas_limit=200_000, to=self.WRITER,
                                    data=self._writer_data(rng)))
        for k in range(sz["precompiles"]):
            w = self._sender(i)
            i += 1
            idx = SYNC_PRECOMPILES[k % len(SYNC_PRECOMPILES)]
            data = _word(idx) + self._precompile_input(idx, rng, w)
            signed(w, t.Transaction(tx_type=2, chain_id=SYNC_CHAIN_ID, nonce=w.nonce,
                                    max_fee_per_gas=100 * 10**9, max_priority_fee_per_gas=10**9,
                                    gas_limit=200_000, to=self.CALLER, data=data))
        for k in range(sz["creates"]):
            w = self._sender(i)
            i += 1
            runtime = self.codes[self.TOKEN] + bytes(
                rng.integers(0, 256, size=max(0, sz["runtime"] - len(self.codes[self.TOKEN])),
                             dtype=np.uint8))
            signed(w, t.Transaction(tx_type=2, chain_id=SYNC_CHAIN_ID, nonce=w.nonce,
                                    max_fee_per_gas=100 * 10**9, max_priority_fee_per_gas=10**9,
                                    gas_limit=1_500_000, to=None, data=initcode_for(runtime)))
        for k in range(sz["setcode"]):
            w = self._sender(i)
            i += 1
            authority = self.authorities[(b - 1) % len(self.authorities)]
            auth = authority.authorize(self.WRITER, nonce=authority.nonce, chain_id=SYNC_CHAIN_ID)
            authority.nonce += 1
            signed(w, t.Transaction(tx_type=4, chain_id=SYNC_CHAIN_ID, nonce=w.nonce,
                                    max_fee_per_gas=100 * 10**9, max_priority_fee_per_gas=10**9,
                                    gas_limit=300_000, to=authority.address,
                                    data=self._writer_data(rng), authorization_list=(auth,)))
        withdrawals = []
        for k in range(sz["withdrawals"]):
            addr = (self._sender(k).address if k % 2 else
                    self.existing[int(rng.integers(0, len(self.existing)))])
            withdrawals.append(t.Withdrawal(self.withdrawal_index, 1000 + k, addr,
                                            int(rng.integers(1, 10**9))))
            self.withdrawal_index += 1
        self.senders[b] = senders
        return txs, withdrawals

    def _writer_data(self, rng) -> bytes:
        slots = [bytes(rng.integers(0, 256, size=32, dtype=np.uint8)) for _ in range(4)]
        return (b"".join(slots) + self.zero_slots.pop(0)
                + _word(int(rng.integers(1, 1 << 62))))


def geth_genesis(fields: dict, header) -> dict:
    """A geth-style genesis JSON (the CLI's ``--genesis`` schema, its
    ``_load_genesis``) of a dev-style genesis: ``fields`` is the alloc's plain
    fields (``convert.alloc_to_fields``: address -> nonce, balance, code,
    storage) and ``header`` the genesis header whose gas limit, base fee and
    timestamp it carries. No fork schedule, so ``_load_genesis`` builds the
    dev-style header (base fee, empty withdrawals root) on chain id 1: the
    ``SyncChain`` genesis, whose hash the JSON's must equal."""
    alloc = {}
    for addr, f in fields.items():
        entry = {"balance": hex(int(f.get("balance", 0)))}
        if f.get("nonce"):
            entry["nonce"] = hex(int(f["nonce"]))
        if f.get("code"):
            entry["code"] = "0x" + bytes(f["code"]).hex()
        if f.get("storage"):
            entry["storage"] = {"0x" + bytes(k).hex(): hex(int(v))
                                for k, v in f["storage"].items()}
        alloc["0x" + bytes(addr).hex()] = entry
    return {"config": {"chainId": SYNC_CHAIN_ID}, "gasLimit": hex(header.gas_limit),
            "baseFeePerGas": hex(header.base_fee_per_gas), "timestamp": hex(header.timestamp),
            "alloc": alloc}


# -- the cross-block import pipeline ---------------------------------------------


HOLD_S = 120.0  # the longest a root phase waits for its child payload


def hold_root_until_child_arrives(monkeypatch, tree, blocks) -> list:
    """Make the two-deep overlap of ``import_chain`` deterministic: every
    block that has a child in ``blocks`` holds its state-root phase (its
    commit window open) until the child's ``on_new_payload`` has reached
    ``try_speculate``, so a loaded host cannot close the window before the
    child looks at it. Patches only ``tree``'s instance (through
    ``monkeypatch``); returns the list
    of blocks whose child did not arrive within ``HOLD_S`` (empty when the
    overlap held)."""
    parents = {b.hash for b in blocks[:-1]}
    arrived = {h: threading.Event() for h in parents}
    late: list = []
    pipe = tree.pipeline
    try_speculate = pipe.try_speculate

    def speculate(block):
        ev = arrived.get(block.header.parent_hash)
        if ev is not None:
            ev.set()
        return try_speculate(block)

    def held(root_fn):
        def root(*args, **kwargs):
            win = pipe.current_window()
            if win is not None and win.block_hash in arrived:
                if not arrived[win.block_hash].wait(HOLD_S):
                    late.append(win.number)
            return root_fn(*args, **kwargs)
        return root

    monkeypatch.setattr(pipe, "try_speculate", speculate)
    for name in ("_sparse_root_or_fallback", "_state_root_job"):
        monkeypatch.setattr(tree, name, held(getattr(tree, name)))
    return late


def pipeline_chain(testing, account_cls, committer, n_blocks: int = 5, n_wallets: int = 6,
                   txs_per_block: int = 4, seed: int = 11):
    """tests/test_block_pipeline.py's ``build_chain`` on a package's own
    ``testing`` module (``ChainBuilder``, ``Wallet``) and ``Account``: random
    transfers with same-sender nonce chains inside a block and receivers of
    block i spending in block i + 1. Both packages seal the same blocks."""
    import random

    rng = random.Random(seed)
    wallets = [testing.Wallet(0x5EED + i) for i in range(n_wallets)]
    genesis = {w.address: account_cls(balance=10**21) for w in wallets}
    builder = testing.ChainBuilder(genesis, committer=committer)
    prev_receivers: list[int] = []
    for i in range(n_blocks):
        txs = []
        for j in range(txs_per_block):
            if prev_receivers and j < 2:
                s = prev_receivers[j % len(prev_receivers)]
            else:
                s = rng.randrange(n_wallets)
            r = rng.randrange(n_wallets)
            txs.append(wallets[s].transfer(wallets[r].address, 10**14 + i * 100 + j))
            prev_receivers = [r] + prev_receivers[:1]
        s = rng.randrange(n_wallets)
        txs.append(wallets[s].transfer(wallets[(s + 1) % n_wallets].address, 10**13))
        txs.append(wallets[s].transfer(wallets[(s + 2) % n_wallets].address, 10**13))
        builder.build_block(txs)
    return builder
