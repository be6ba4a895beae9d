"""Naive recursive MPT root — the correctness oracle.

A copy of the JAX package's ``trie/naive.py``. Reference analogue: the
`triehash`-style reference implementations the reference tests against
(proptest vs naive root). Never used on hot paths; the level-batched
`TrieCommitter` and the incremental walker are tested for equality against
this.
"""

from __future__ import annotations

from ..primitives.keccak import keccak256
from ..primitives.nibbles import Nibbles, unpack_nibbles, common_prefix_len
from ..primitives.rlp import rlp_encode
from .node import (
    EMPTY_STRING_RLP,
    branch_node_rlp,
    extension_node_rlp,
    leaf_node_rlp,
    node_ref,
)


def _build_ref(items: list[tuple[Nibbles, bytes]], depth: int) -> bytes:
    """RLP-encoded reference of the subtree holding ``items`` below ``depth``."""
    node = _build_rlp(items, depth)
    return node_ref(node)


def _build_rlp(items: list[tuple[Nibbles, bytes]], depth: int) -> bytes:
    if len(items) == 1:
        path, value = items[0]
        return leaf_node_rlp(path[depth:], value)
    # common prefix below depth
    first = items[0][0]
    cpl = len(first) - depth
    for path, _ in items[1:]:
        cpl = min(cpl, common_prefix_len(first[depth:], path[depth:]))
        if cpl == 0:
            break
    if cpl > 0:
        child = _build_ref(items, depth + cpl)
        return extension_node_rlp(first[depth : depth + cpl], child)
    # branch
    children = [EMPTY_STRING_RLP] * 16
    value = b""
    i = 0
    while i < len(items):
        path, val = items[i]
        if len(path) == depth:  # value sits at this branch
            value = val
            i += 1
            continue
        nib = path[depth]
        j = i
        while j < len(items) and len(items[j][0]) > depth and items[j][0][depth] == nib:
            j += 1
        children[nib] = _build_ref(items[i:j], depth + 1)
        i = j
    return branch_node_rlp(children, value)


def naive_trie_root(pairs: dict[bytes, bytes]) -> bytes:
    """Root of the MPT holding ``{byte_key: value}`` (keys used as-is)."""
    items = sorted((unpack_nibbles(k), v) for k, v in pairs.items() if v != b"")
    if not items:
        return keccak256(rlp_encode(b""))
    return keccak256(_build_rlp(items, 0))


def naive_secure_root(pairs: dict[bytes, bytes]) -> bytes:
    """Root of the secure MPT (keys pre-hashed with keccak256)."""
    return naive_trie_root({keccak256(k): v for k, v in pairs.items()})
