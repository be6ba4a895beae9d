"""Moving the rebuild's inputs and state onto the device, and a chain and
its genesis state across from another implementation.

The state commitment has no learned weights: what it carries is its input
(bench-shaped jobs: ``(n, 32)`` u8 hashed keys plus aligned RLP value
bytes) and its resident ``(S, 32)`` u8 digest buffer. A chain crosses by
its consensus encoding (``blocks_from_rlp``: the chain file
``ChainBuilder.export_rlp`` writes), its genesis state by plain fields
(``alloc_from_fields`` / ``alloc_to_fields``).
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve
from .primitives.keccak import keccak256
from .primitives.rlp import rlp_decode_prefix
from .primitives.types import KECCAK_EMPTY, Account, Block


def jobs_to_device(jobs: list[tuple[np.ndarray, list[bytes]]],
                   device: str | torch.device = "cuda"
                   ) -> list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Each job ``(keys (n, 32) u8, values)`` as three tensors on ``device``:
    the keys ``(n, 32)`` uint8, the values concatenated ``(sum len,)``
    uint8, and their offsets ``(n + 1,)`` int64 (value i is
    ``flat[off[i]:off[i+1]]``)."""
    dev = resolve(device)
    out = []
    for keys, values in jobs:
        keys = np.ascontiguousarray(keys, dtype=np.uint8).reshape(-1, 32)
        if len(keys) != len(values):
            raise ValueError("keys/values length mismatch")
        off = np.zeros((len(values) + 1,), dtype=np.int64)
        off[1:] = np.cumsum([len(v) for v in values])
        flat = np.frombuffer(b"".join(values), dtype=np.uint8)
        out.append((torch.from_numpy(keys.copy()).to(dev),
                    torch.from_numpy(flat.copy()).to(dev),
                    torch.from_numpy(off).to(dev)))
    return out


def digest_buffer_from_numpy(buf: np.ndarray,
                             device: str | torch.device = "cuda") -> torch.Tensor:
    """An ``(S, 32)`` uint8 digest buffer (e.g. a JAX engine's ``finish()``
    output) as a tensor on ``device``, ready for
    ``FusedLevelEngine.begin_from``. Row ``s`` ``.tobytes()`` to the digest
    in slot ``s``, as in the reference."""
    arr = np.asarray(buf)
    if arr.dtype != np.uint8 or arr.ndim != 2 or arr.shape[1] != 32:
        raise ValueError(f"digest buffer must be (S, 32) uint8, got {arr.dtype} {arr.shape}")
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(resolve(device))


def blocks_from_rlp(data: bytes) -> list[Block]:
    """The blocks of a chain file: concatenated block RLP, as
    ``ChainBuilder.export_rlp`` writes it and ``reth import`` reads it."""
    data = bytes(data)
    blocks, pos = [], 0
    while pos < len(data):
        _item, used = rlp_decode_prefix(data[pos:])
        blocks.append(Block.decode(data[pos:pos + used]))
        pos += used
    return blocks


def alloc_from_fields(fields: dict[bytes, dict]
                      ) -> tuple[dict[bytes, Account], dict[bytes, dict[bytes, int]],
                                 dict[bytes, bytes]]:
    """A genesis alloc from plain fields: ``address -> {"nonce", "balance",
    "code", "storage"}`` (each optional; ``storage`` maps 32-byte slots to
    ints). Returns ``(accounts, storage, codes)`` as ``init_genesis`` and
    ``ChainBuilder`` take them: an account's ``code_hash`` is its code's
    keccak, its storage root is left for the state root to compute."""
    accounts, storage, codes = {}, {}, {}
    for addr, f in fields.items():
        code = bytes(f.get("code", b""))
        code_hash = keccak256(code) if code else KECCAK_EMPTY
        if code:
            codes[code_hash] = code
        accounts[addr] = Account(nonce=int(f.get("nonce", 0)),
                                 balance=int(f.get("balance", 0)), code_hash=code_hash)
        slots = {bytes(k): int(v) for k, v in (f.get("storage") or {}).items()}
        if slots:
            storage[addr] = slots
    return accounts, storage, codes


def alloc_to_fields(accounts: dict[bytes, Account],
                    storage: dict[bytes, dict[bytes, int]] | None = None,
                    codes: dict[bytes, bytes] | None = None) -> dict[bytes, dict]:
    """The plain fields of a genesis alloc: :func:`alloc_from_fields`'s
    inverse (an account's code is looked up by its ``code_hash``)."""
    storage, codes = storage or {}, codes or {}
    out = {}
    for addr, acc in accounts.items():
        f = {"nonce": acc.nonce, "balance": acc.balance}
        if acc.code_hash != KECCAK_EMPTY:
            f["code"] = codes[acc.code_hash]
        if storage.get(addr):
            f["storage"] = dict(storage[addr])
        out[addr] = f
    return out
