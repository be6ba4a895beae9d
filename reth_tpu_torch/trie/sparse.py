"""Proof-revealed sparse MPT, its parallel cross-trie commit on the card, and
the cross-block preserved trie cache: the live-tip state-root finish.

Port of the JAX package's ``trie/sparse.py``. The structure walk (reveal,
update, delete, collapse) is host pointer work, as in the reference; the
hashing of the dirty nodes runs on the card, on one of two paths of
``ParallelSparseCommitter``:

- the classic finish: every dirty node of every trie grouped by depth into
  one global schedule, each depth RLP-encoded (lower subtries on a thread
  pool) and hashed in one ``KeccakDevice`` batch, kernel 1
  (``ops/csrc/keccak.cu keccak256_absorb``);
- the fused finish (``subtrie_levels`` k > 1): the same schedule built as
  RLP templates with zero-filled holes where a child's digest goes, staged
  into a ``SubtrieFusedEngine`` and run k depths per launch of kernel 4
  (``ops/csrc/fused_level.cu subtrie_levels``), children's digests spliced
  from the resident digest buffer on the card; one read-back at the end.

Roots are bit-identical to the serial per-trie ``root_hash_compute`` on
either path: the templates come from the same RLP functions as the serial
encode. Entry points run on the card unless the caller passes
``device="cpu"`` or a hasher of its own.

With ``arena=`` (the hot-state plane's device half,
``ops/fused_commit.py DigestArena``) the fused finish runs against one
engine whose digest buffer outlives the block: each commit stages only its
dirty rows, and a child whose digest is still resident from an earlier
commit is spliced from its slot on the card (the delta finish). The plane's
host half, reveal-ref stamping and the hooks ``node_at`` / ``blind_hash_at``
/ ``reveal_at`` / ``harvest_spine``, serves ``trie/hot_cache.py
TrieNodeCache``. One departure from the reference, whose arena reruns any
failed epoch on the classic finish: a kernel fault in an epoch (a failed
build, a launch error, a CUDA runtime error; ``ops/_build.is_kernel_fault``)
raises out of the commit after the arena evicts and counts it, whoever owns
the arena, so no fault of kernel 4 turns into a quiet rerun on kernel 1.

A hasher bound to the shared hash service's live lane
(``ops/hash_service.py HashClient``) is used as the reference uses it: the
classic finish streams each pooled depth's encode chunks through
``hasher.submit``, so the service's continuous batching fuses them back
into full launches while the pool keeps encoding; the fused finish hands
its whole window to ``hasher.commit_window``, one k-level engine commit on
the service's dispatcher; and such a hasher skips the arena's delta finish.

Blinded nodes are paths the proofs never revealed. Reading through or
collapsing into one raises ``BlindedNodeError`` carrying the nibble path, so
a caller holding a proof source can reveal that path and retry.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import tracing
from ..device import resolve
from ..metrics import hotstate_metrics, sparse_commit_metrics
from ..ops._build import is_kernel_fault
from ..ops.fused_commit import SubtrieFusedEngine
from ..ops.keccak import KeccakDevice
from ..primitives.keccak import RATE, keccak256
from ..primitives.nibbles import Nibbles, common_prefix_len, decode_path, unpack_nibbles
from ..primitives.rlp import rlp_decode, rlp_encode
from ..primitives.types import EMPTY_ROOT_HASH
from .committer import BranchNode
from .hot_cache import HotStateFaultInjector
from .node import (
    EMPTY_STRING_RLP,
    HASH_REF_HOLE,
    branch_node_rlp,
    encode_hash_ref,
    extension_node_rlp,
    leaf_node_rlp,
)


def device_hasher(device: str | torch.device = "cuda"):
    """The default hasher of the sparse finish on ``device``: a batched
    ``KeccakDevice`` with one shared 4-block bucket (a trie node is at most
    4 rate blocks), the reference bench's settings."""
    return KeccakDevice(min_tier=1024, block_tier=4, device=device).hash_batch


class BlindedNodeError(Exception):
    """Traversal hit an unrevealed subtree; ``path`` names the blinded
    node so the caller can fetch a proof for it and retry."""

    def __init__(self, path: Nibbles, msg: str = ""):
        super().__init__(msg or f"blinded node at {path.hex()}")
        self.path = path
        # hashed address of the storage trie the blind was hit in (set by
        # state-level callers); None = the account trie
        self.owner: bytes | None = None


# -- node objects -------------------------------------------------------------


class _Blind:
    __slots__ = ("hash",)

    def __init__(self, h: bytes):
        self.hash = h


class _Leaf:
    __slots__ = ("path", "value", "_ref")

    def __init__(self, path: Nibbles, value: bytes):
        self.path = path
        self.value = value
        self._ref = None  # cached RLP ref while clean


class _Ext:
    __slots__ = ("path", "child", "_ref")

    def __init__(self, path: Nibbles, child):
        self.path = path
        self.child = child
        self._ref = None


class _Branch:
    __slots__ = ("children", "value", "_ref")

    def __init__(self, children=None, value: bytes = b""):
        self.children = children if children is not None else [None] * 16
        self.value = value
        self._ref = None


def _decode_node(rlp: bytes, by_hash: dict[bytes, bytes], stamp: bool = False):
    """Materialize one RLP node, descending into children found in
    ``by_hash`` (the proof set); absent hashed children stay blinded.

    ``stamp`` (the hot-state plane): a revealed node's hash is known, since
    the proof addressed it by hash, so its ``_ref`` is stamped at decode
    time. A revealed node that is never mutated then stays clean through
    the next commit instead of being re-encoded, staged and hashed again;
    a mutation clears the refs along its path as before, so roots are
    bit-identical."""
    items = rlp_decode(rlp)
    if len(items) == 2:
        prefix, payload = items
        nib, is_leaf = decode_path(prefix)
        if is_leaf:
            return _Leaf(nib, payload)
        # extension: payload is a child ref (raw RLP list when inline)
        return _Ext(nib, _decode_ref(payload, by_hash, stamp))
    if len(items) != 17:
        raise ValueError("malformed MPT node")
    br = _Branch(value=items[16])
    for i in range(16):
        if items[i] != b"":
            br.children[i] = _decode_ref(items[i], by_hash, stamp)
    return br


def _decode_ref(ref, by_hash: dict[bytes, bytes], stamp: bool = False):
    """A child as it appears inside a parent's decoded RLP: a 32-byte hash
    string, or an inline (already decoded) list for <32-byte nodes."""
    if isinstance(ref, list):  # inline child: re-encode to reuse _decode_node
        inline = rlp_encode(ref)
        node = _decode_node(inline, by_hash, stamp)
        if stamp:
            node._ref = inline  # an inline ref is the node's RLP
        return node
    if len(ref) == 32:
        sub = by_hash.get(ref)
        if sub is None:
            return _Blind(ref)
        node = _decode_node(sub, by_hash, stamp)
        if stamp:
            node._ref = encode_hash_ref(ref)
        return node
    raise ValueError("unexpected short child reference")


class SparseTrie:
    """One partially-revealed secure MPT (account trie or one storage trie)."""

    def __init__(self, root_hash: bytes = EMPTY_ROOT_HASH):
        self.root_hash = root_hash
        self.root = None if root_hash == EMPTY_ROOT_HASH else _Blind(root_hash)
        self.updates = 0  # mutations since last root()
        # hot-state plane: when set, reveals stamp the (known) node hashes
        # as clean refs, so unmutated revealed nodes never stage again;
        # ``stamped`` counts them since the last arena commit (the
        # denominator of its delta-upload fraction)
        self.stamp_reveals = False
        self.stamped = 0

    # -- reveal ---------------------------------------------------------------

    def reveal(self, proof_nodes: list[bytes], by_hash: dict[bytes, bytes] | None = None) -> None:
        """Reveal the subtrees reachable from the current root through the
        given proof nodes (spine nodes of one or more proofs). ``by_hash``,
        when given, is those nodes keyed by their keccak, hashed once by a
        caller that reveals the same nodes into many tries."""
        if not proof_nodes:
            return
        stamp = self.stamp_reveals
        if by_hash is None:
            by_hash = {keccak256(n): n for n in proof_nodes}
        if self.root is None or isinstance(self.root, _Blind):
            top = by_hash.get(self.root_hash)
            if top is None:
                return  # a proof for a different root
            self.root = _decode_node(top, by_hash, stamp)
            if stamp:
                self.root._ref = encode_hash_ref(self.root_hash)
                self.stamped += len(by_hash)
            return
        self.root = self._merge(self.root, by_hash, stamp)
        if stamp:
            self.stamped += len(by_hash)

    def _merge(self, node, by_hash, stamp: bool = False):
        if isinstance(node, _Blind):
            rlp = by_hash.get(node.hash)
            if rlp is None:
                return node
            revealed = _decode_node(rlp, by_hash, stamp)
            if stamp:
                revealed._ref = encode_hash_ref(node.hash)
            return revealed
        if isinstance(node, _Ext):
            node.child = self._merge(node.child, by_hash, stamp)
        elif isinstance(node, _Branch):
            for i, c in enumerate(node.children):
                if c is not None:
                    node.children[i] = self._merge(c, by_hash, stamp)
        return node

    # -- hot-state plane hooks (trie/hot_cache.py) ----------------------------

    def node_at(self, path: bytes):
        """The node reached after consuming exactly ``path``'s nibbles (the
        key-nibble positions ``BlindedNodeError.path`` uses); None when the
        walk diverges, ends early, or an earlier blind blocks it."""
        node, depth = self.root, 0
        while node is not None:
            if depth == len(path):
                return node
            if isinstance(node, (_Blind, _Leaf)):
                return None
            if isinstance(node, _Ext):
                np_ = node.path
                if depth + len(np_) > len(path) or path[depth:depth + len(np_)] != np_:
                    return None
                depth += len(np_)
                node = node.child
                continue
            node = node.children[path[depth]]
            depth += 1
        return None

    def blind_hash_at(self, path: bytes) -> bytes | None:
        """Hash of the blinded node at ``path``, or None when the position
        is not a blind: the hot cache's lookup key and validator."""
        node = self.node_at(path)
        return node.hash if isinstance(node, _Blind) else None

    def reveal_at(self, path: bytes, rlp: bytes) -> bool:
        """Reveal one blinded node in place from an RLP (a cache hit, or a
        proof fetch). Validates ``keccak(rlp)`` against the blind's hash, so
        a poisoned or stale entry never splices in, and stamps the revealed
        node's ref. Its children decode to blinds, revealed in turn. False
        when the position is not a matching blind."""
        node, depth, parent, link = self.root, 0, None, None
        while node is not None:
            if depth == len(path):
                break
            if isinstance(node, (_Blind, _Leaf)):
                return False
            if isinstance(node, _Ext):
                np_ = node.path
                if depth + len(np_) > len(path) or path[depth:depth + len(np_)] != np_:
                    return False
                depth += len(np_)
                parent, link = node, None
                node = node.child
                continue
            parent, link = node, path[depth]
            node = node.children[path[depth]]
            depth += 1
        if not isinstance(node, _Blind) or keccak256(rlp) != node.hash:
            return False
        revealed = _decode_node(rlp, {}, stamp=True)
        revealed._ref = encode_hash_ref(node.hash)
        self.stamped += 1
        if parent is None:
            self.root = revealed
        elif isinstance(parent, _Ext):
            parent.child = revealed
        else:
            parent.children[link] = revealed
        return True

    def harvest_spine(self, key: bytes, out: list, seen: set) -> None:
        """Append ``(path, rlp)`` of every node of 32 bytes or more along
        ``key``'s path to ``out`` (the hot cache's population), paths as
        key-nibble positions. The walk stops at the first node whose
        children's refs are not clean (a revealed subtree under a clean
        parent before any commit); harvests run after a commit, or after a
        reveal with stamping, where that does not happen on the key path."""
        nib = unpack_nibbles(key) if len(key) == 32 else key
        node, depth = self.root, 0
        while node is not None and not isinstance(node, _Blind):
            path = bytes(nib[:depth])
            if path not in seen:
                if not _children_ready(node):
                    return
                rlp = _encode_rlp(node)
                if len(rlp) >= 32:
                    seen.add(path)
                    out.append((path, rlp))
            if isinstance(node, _Leaf):
                return
            if isinstance(node, _Ext):
                if nib[depth:depth + len(node.path)] != node.path:
                    return
                depth += len(node.path)
                node = node.child
            else:
                node = node.children[nib[depth]]
                depth += 1

    # -- read -----------------------------------------------------------------

    def get(self, key: bytes):
        """Value for a 32-byte hashed key; None when provably absent."""
        nib = unpack_nibbles(key)
        node, depth = self.root, 0
        while True:
            if node is None:
                return None
            if isinstance(node, _Blind):
                raise BlindedNodeError(nib[:depth])
            if isinstance(node, _Leaf):
                return node.value if node.path == nib[depth:] else None
            if isinstance(node, _Ext):
                if nib[depth:depth + len(node.path)] != node.path:
                    return None
                depth += len(node.path)
                node = node.child
                continue
            node = node.children[nib[depth]]
            depth += 1

    # -- write ----------------------------------------------------------------

    def update(self, key: bytes, value: bytes) -> None:
        nib = unpack_nibbles(key)
        self.root = self._insert(self.root, nib, 0, value)
        self.updates += 1

    def delete(self, key: bytes) -> None:
        nib = unpack_nibbles(key)
        self.root = self._remove(self.root, nib, 0)
        self.updates += 1

    def _insert(self, node, nib: Nibbles, depth: int, value: bytes):
        if node is None:
            return _Leaf(nib[depth:], value)
        if isinstance(node, _Blind):
            raise BlindedNodeError(nib[:depth])
        node._ref = None  # path dirties
        if isinstance(node, _Leaf):
            rem = nib[depth:]
            if node.path == rem:
                node.value = value
                return node
            return self._split(node.path, node, rem, _Leaf(b"", value))
        if isinstance(node, _Ext):
            rem = nib[depth:]
            common = common_prefix_len(node.path, rem)
            if common == len(node.path):
                node.child = self._insert(node.child, nib, depth + common, value)
                return node
            return self._split(node.path, node, rem, _Leaf(b"", value), common)
        idx = nib[depth]
        node.children[idx] = self._insert(node.children[idx], nib, depth + 1, value)
        return node

    @staticmethod
    def _strip(node, by: int):
        """Drop ``by`` leading nibbles from a leaf/ext's remaining path."""
        node.path = node.path[by:]
        return node

    def _split(self, old_path: Nibbles, old_node, new_path: Nibbles, new_leaf,
               common: int | None = None):
        """Diverge two paths into (optional ext →) branch."""
        if common is None:
            common = common_prefix_len(old_path, new_path)
        branch = _Branch()
        old = self._strip(old_node, common + 1) if len(old_path) > common else old_node
        if len(old_path) == common:
            # old path exhausted at the branch: only a leaf can end here (its
            # value goes to the branch's slot 16); an extension always has a
            # next nibble
            branch.value = old_node.value
        else:
            child = old
            if isinstance(child, _Ext) and len(child.path) == 0:
                child = child.child  # ext with empty path collapses
            branch.children[old_path[common]] = child
        if len(new_path) == common:
            branch.value = new_leaf.value
        else:
            new_leaf.path = new_path[common + 1:]
            branch.children[new_path[common]] = new_leaf
        if common:
            return _Ext(old_path[:common], branch)
        return branch

    def _remove(self, node, nib: Nibbles, depth: int):
        if node is None:
            return None
        if isinstance(node, _Blind):
            raise BlindedNodeError(nib[:depth])
        node._ref = None
        if isinstance(node, _Leaf):
            return None if node.path == nib[depth:] else node
        if isinstance(node, _Ext):
            if nib[depth:depth + len(node.path)] != node.path:
                return node
            node.child = self._remove(node.child, nib, depth + len(node.path))
            if node.child is None:
                return None
            return self._collapse_ext(node)
        idx = nib[depth]
        node.children[idx] = self._remove(node.children[idx], nib, depth + 1)
        return self._collapse_branch(node, nib, depth)

    @staticmethod
    def _collapse_ext(ext: _Ext):
        child = ext.child
        if isinstance(child, (_Ext, _Leaf)):
            child._ref = None
            child.path = ext.path + child.path
            return child
        return ext

    @staticmethod
    def _collapse_branch(br: _Branch, nib: Nibbles, depth: int):
        live = [(i, c) for i, c in enumerate(br.children) if c is not None]
        if br.value:
            return br if live else _Leaf(b"", br.value)
        if len(live) > 1:
            return br
        if not live:
            return None
        idx, child = live[0]
        # merging needs the child's structure: a blinded survivor must be
        # revealed first (the caller reveals and retries)
        if isinstance(child, _Blind):
            raise BlindedNodeError(nib[:depth] + bytes([idx]), "collapse into blinded sibling")
        child._ref = None
        if isinstance(child, (_Leaf, _Ext)):
            child.path = bytes([idx]) + child.path
            return child
        return _Ext(bytes([idx]), child)

    # -- hashing --------------------------------------------------------------

    def root_hash_compute(self, hasher=None, device: str | torch.device = "cuda") -> bytes:
        """Level-batched rehash of dirty subtrees: one batched keccak call
        per depth level, cached refs for clean subtrees (the cross-block
        reuse). ``hasher`` (``list[bytes] -> list[bytes]``) defaults to
        ``device_hasher(device)``; the root itself is hashed on the host,
        as in the reference."""
        if self.root is None:
            self.root_hash = EMPTY_ROOT_HASH
            self.updates = 0
            return self.root_hash
        if isinstance(self.root, _Blind):
            self.root_hash = self.root.hash
            return self.root_hash
        # collect dirty nodes by depth (a node is dirty iff _ref is None)
        levels: dict[int, list] = {}

        def collect(node, depth):
            if isinstance(node, _Blind) or node is None or node._ref is not None:
                return  # blinded, absent, or clean subtree: ref cached
            levels.setdefault(depth, []).append(node)
            if isinstance(node, _Ext):
                collect(node.child, depth + 1)
            elif isinstance(node, _Branch):
                for c in node.children:
                    collect(c, depth + 1)

        collect(self.root, 0)
        for depth in sorted(levels, reverse=True):
            rlps, nodes = [], []
            for node in levels[depth]:
                rlp = _encode_rlp(node)
                if len(rlp) < 32:
                    node._ref = rlp  # inline ref
                else:
                    rlps.append(rlp)
                    nodes.append(node)
            if rlps:
                if hasher is None:
                    hasher = device_hasher(device)
                for node, d in zip(nodes, hasher(rlps)):
                    node._ref = encode_hash_ref(bytes(d))
        self.root_hash = keccak256(_encode_rlp(self.root))
        self.updates = 0
        return self.root_hash

    def spine(self, key: bytes) -> list[bytes]:
        """The RLP nodes along ``key``'s path (a single-key proof). Valid
        after ``root_hash_compute`` (refs must be clean)."""
        out = []
        nib = unpack_nibbles(key)
        node, depth = self.root, 0
        while node is not None and not isinstance(node, _Blind):
            rlp = _encode_rlp(node)
            if len(rlp) >= 32:
                out.append(rlp)
            if isinstance(node, _Leaf):
                break
            if isinstance(node, _Ext):
                if nib[depth:depth + len(node.path)] != node.path:
                    break
                depth += len(node.path)
                node = node.child
            else:
                node = node.children[nib[depth]]
                depth += 1
        return out

    def revealed_count(self) -> int:
        n = 0
        stack = [self.root]
        while stack:
            node = stack.pop()
            if node is None or isinstance(node, _Blind):
                continue
            n += 1
            if isinstance(node, _Ext):
                stack.append(node.child)
            elif isinstance(node, _Branch):
                stack.extend(node.children)
        return n


def _encode_rlp(node) -> bytes:
    """RLP-encode one node from its children's (clean) refs. Module-level
    so the commit's encode pool can fan it out without touching any trie
    instance state."""
    if isinstance(node, _Leaf):
        return leaf_node_rlp(node.path, node.value)
    if isinstance(node, _Ext):
        return extension_node_rlp(node.path, _child_ref_of(node.child))
    refs = [_child_ref_of(c) if c is not None else EMPTY_STRING_RLP for c in node.children]
    return branch_node_rlp(refs, node.value)


def _child_ref_of(child) -> bytes:
    if isinstance(child, _Blind):
        return encode_hash_ref(child.hash)
    if child._ref is None:
        raise RuntimeError("child not hashed (collect order bug)")
    return child._ref


def _children_ready(node) -> bool:
    """True when every child carries a usable ref (a blind, or a cached
    ref): ``_encode_rlp``'s precondition outside a commit."""
    if isinstance(node, _Leaf):
        return True
    if isinstance(node, _Ext):
        c = node.child
        return isinstance(c, _Blind) or c._ref is not None
    return all(c is None or isinstance(c, _Blind) or c._ref is not None for c in node.children)


def _child_ref_template(child, slot_of: dict[int, int], resident=None) -> tuple[bytes, int]:
    """Child reference as template bytes + digest source slot (0 = no
    hole): clean, blinded and inline children contribute literal bytes,
    dirty hashed children a 33-byte placeholder whose digest the card
    splices from the resident buffer. Dirty inline children were finalised
    when their own (deeper) level was walked, so their ``_ref`` already
    holds complete hole-free bytes.

    ``resident`` (the hot-state arena): maps a known child hash to a digest
    slot still resident from an earlier epoch (0: not resident). A hit
    turns the literal ref into a hole spliced from that slot; the spliced
    bytes are the slot's digest, which is the hash, so the RLP is
    bit-identical either way."""
    if isinstance(child, _Blind):
        if resident is not None:
            s = resident(child.hash)
            if s:
                return HASH_REF_HOLE, s
        return encode_hash_ref(child.hash), 0
    if child._ref is not None:
        r = child._ref
        if resident is not None and len(r) == 33 and r[0] == 0xA0:
            s = resident(r[1:])
            if s:
                return HASH_REF_HOLE, s
        return r, 0
    return HASH_REF_HOLE, slot_of[id(child)]


def _node_template_sparse(node, slot_of: dict[int, int], resident=None):
    """(RLP template with zero-filled holes, [(byte_off, src_slot)]) for one
    dirty node, built with the same RLP functions as the serial encode
    (``HASH_REF_HOLE`` is a well-formed 33-byte ref), so the spliced bytes
    equal ``_encode_rlp``'s output."""
    if isinstance(node, _Leaf):
        return leaf_node_rlp(node.path, node.value), []
    if isinstance(node, _Ext):
        ref, src = _child_ref_template(node.child, slot_of, resident)
        rlp = extension_node_rlp(node.path, ref)
        # the child ref is the payload's tail; +1 skips its 0xa0 marker
        return rlp, ([(len(rlp) - 32, src)] if src else [])
    refs: list[bytes] = []
    srcs: list[int] = []
    for c in node.children:
        r, s = (EMPTY_STRING_RLP, 0) if c is None else _child_ref_template(c, slot_of, resident)
        refs.append(r)
        srcs.append(s)
    rlp = branch_node_rlp(refs, node.value)
    # refs sit back to back after the list header; the branch value is the
    # tail, so the first ref starts before the value and all the refs
    off = len(rlp) - len(rlp_encode(node.value)) - sum(len(r) for r in refs)
    holes: list[tuple[int, int]] = []
    for r, s in zip(refs, srcs):
        if s:
            holes.append((off + 1, s))
        off += len(r)
    return rlp, holes


# -- parallel cross-trie commit ----------------------------------------------


class InjectedSparseAbort(RuntimeError):
    """Fault injection killed a parallel sparse commit at a dispatch
    boundary (RETH_TPU_FAULT_SPARSE_ABORT)."""


class SparseFaultInjector:
    """Fault policies for the parallel sparse commit, as in the reference.

    ``abort_at``: the Nth hash dispatch of this injector raises
    :class:`InjectedSparseAbort` (once). ``proof_wedge_every``: every Nth
    proof fetch raises. Env form (:meth:`from_env`):
    ``RETH_TPU_FAULT_SPARSE_ABORT`` / ``RETH_TPU_FAULT_SPARSE_PROOF_WEDGE``.
    """

    def __init__(self, abort_at: int = 0, proof_wedge_every: int = 0):
        self.abort_at = abort_at
        self.proof_wedge_every = proof_wedge_every
        self.dispatches = 0
        self.proof_fetches = 0
        self.aborts = 0
        self.wedges = 0
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls, env=None) -> "SparseFaultInjector | None":
        env = os.environ if env is None else env
        abort_at = int(env.get("RETH_TPU_FAULT_SPARSE_ABORT", "0") or 0)
        wedge = int(env.get("RETH_TPU_FAULT_SPARSE_PROOF_WEDGE", "0") or 0)
        if not (abort_at or wedge):
            return None
        return cls(abort_at=abort_at, proof_wedge_every=wedge)

    def on_dispatch(self) -> None:
        with self._lock:
            self.dispatches += 1
            n = self.dispatches
            fire = bool(self.abort_at) and n == self.abort_at
            if fire:
                self.aborts += 1
        if fire:
            tracing.fault_event("RETH_TPU_FAULT_SPARSE_ABORT", target="trie::sparse", dispatch=n)
            raise InjectedSparseAbort(f"injected sparse-commit abort on dispatch #{n} "
                                      f"(RETH_TPU_FAULT_SPARSE_ABORT={self.abort_at})")

    def on_proof_fetch(self) -> None:
        with self._lock:
            self.proof_fetches += 1
            n = self.proof_fetches
            fire = bool(self.proof_wedge_every) and n % self.proof_wedge_every == 0
            if fire:
                self.wedges += 1
        if fire:
            tracing.fault_event("RETH_TPU_FAULT_SPARSE_PROOF_WEDGE", target="trie::sparse",
                                fetch=n)
            raise RuntimeError(f"injected sparse proof wedge on fetch #{n} "
                               f"(RETH_TPU_FAULT_SPARSE_PROOF_WEDGE={self.proof_wedge_every})")


def sparse_worker_count(workers: int | None = None) -> int:
    """Resolve the ``--sparse-workers`` knob: an explicit value, else
    ``RETH_TPU_SPARSE_WORKERS``, else from the CPU count. 1 disables the
    encode pool."""
    if workers is None or workers <= 0:
        workers = int(os.environ.get("RETH_TPU_SPARSE_WORKERS", "0") or 0)
    if workers <= 0:
        workers = max(2, min(4, os.cpu_count() or 1))
    return max(1, workers)


class ParallelSparseCommitter:
    """Commit of many dirty sparse tries at once: the live-tip finish.

    Over the serial per-trie ``root_hash_compute`` loop:

    (a) **Cross-trie level packing**: dirty nodes of every trie (the dirty
        storage tries and the account trie) go into one global per-depth
        schedule, and each depth is one hasher dispatch, deepest first (a
        parent always sits at a smaller depth; across tries there is no
        ordering constraint).
    (b) **Upper/lower subtrie split with a host encode pool**: each trie
        partitions at ``split_depth``; RLP encoding of the lower subtries
        fans out over a thread pool (chunks never split a subtrie) while the
        short upper spine encodes on the caller's thread.

    ``subtrie_levels`` k > 1 (or ``RETH_TPU_SUBTRIE_LEVELS``) takes the fused
    finish instead: the schedule as hole-spliced templates through
    ``SubtrieFusedEngine``, k depths per launch of kernel 4. The classic
    finish hashes each depth with ``hasher``, by default
    ``device_hasher(device)`` (kernel 1).

    ``arena=`` (a :class:`~reth_tpu_torch.ops.fused_commit.DigestArena`,
    the hot-state plane) takes the delta finish before either: the fused
    layout against the arena's one engine, whose digest buffer stays on the
    card across commits, at ``subtrie_levels`` depths per launch (8 when
    unset). Only the commit's dirty rows stage; clean and blinded children
    whose digests are still resident splice from their slots. If another
    finish holds the arena, or the epoch fails for a cause that is no
    kernel fault (the arena evicts and counts the fault), the same commit
    reruns on the finish it would take without the arena, on the same
    device.

    All run on ``device`` (the card by default; ``device="cpu"`` runs the
    kernels' plain versions). There is no fallback to the CPU: a failed
    build or launch raises out of ``commit``, under the arena too (the
    arena evicts and counts it first). Roots are bit-identical to the serial path. Per-commit state is
    local; the pool and the arena are shared.
    """

    POOL_MIN_NODES = 128   # below this a level encodes serially
    MIN_CHUNK = 32

    # the reference's padding floors of its k-level programs, kept because
    # tests set them; the port launches exact row counts, so they pad nothing
    SUBTRIE_ROW_FLOOR = 512
    SUBTRIE_HOLE_FLOOR = 512

    def __init__(self, workers: int | None = None, split_depth: int | None = None,
                 injector: SparseFaultInjector | None = None,
                 subtrie_levels: int | None = None, arena=None,
                 device: str | torch.device = "cuda"):
        env = os.environ
        self.device = resolve(device)
        self.workers = sparse_worker_count(workers)
        self.split_depth = int(split_depth if split_depth is not None
                               else env.get("RETH_TPU_SPARSE_SPLIT_DEPTH", "2"))
        self.subtrie_levels = int(subtrie_levels if subtrie_levels is not None
                                  else env.get("RETH_TPU_SUBTRIE_LEVELS", "0") or 0)
        self.injector = injector if injector is not None else SparseFaultInjector.from_env()
        # the hot-state arena: its engine runs k depths a launch, the
        # fused layout even when subtrie_levels is unset
        self.arena = arena
        self._arena_k = self.subtrie_levels if self.subtrie_levels > 1 else 8
        self.hot_injector = HotStateFaultInjector.from_env() if arena is not None else None
        self._hasher = None  # device_hasher(self.device), built at first use
        self._pool: ThreadPoolExecutor | None = None
        self._pool_lock = threading.Lock()
        self.last: dict | None = None  # most recent commit's stats

    def _executor(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=self.workers,
                                                thread_name_prefix="sparse-encode")
            return self._pool

    def shutdown(self) -> None:
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    def _engine(self) -> SubtrieFusedEngine:
        """The fused finish's engine for one commit."""
        return SubtrieFusedEngine(min_tier=64, k=self.subtrie_levels, device=self.device)

    # -- collection -----------------------------------------------------------

    def _collect(self, tries):
        """Global per-depth schedule: ``levels[depth] = [(group, node)]``
        across all tries. ``group`` identifies the lower subtrie a node
        belongs to (nodes above ``split_depth`` get the trie's own upper
        group) so encode chunks never split a subtrie."""
        levels: dict[int, list] = {}
        split = self.split_depth
        group_counter = [0]

        def collect(node, depth, group):
            if node is None or isinstance(node, _Blind) or node._ref is not None:
                return  # absent, blinded, or clean subtree (cross-block reuse)
            levels.setdefault(depth, []).append((group, node))
            nxt = depth + 1
            children = [node.child] if isinstance(node, _Ext) else (
                node.children if isinstance(node, _Branch) else [])
            for c in children:
                if c is None:
                    continue
                cg = group
                if nxt == split:
                    group_counter[0] += 1
                    cg = group_counter[0]
                collect(c, nxt, cg)

        for t in tries:
            group_counter[0] += 1
            collect(t.root, 0, group_counter[0])
        return levels

    def _chunk(self, entries):
        """Group-aligned contiguous chunks sized for the pool width."""
        target = max(self.MIN_CHUNK, len(entries) // (self.workers * 2) or 1)
        chunks: list[list] = []
        cur: list = []
        cur_group = None
        for group, node in entries:
            if cur and len(cur) >= target and group != cur_group:
                chunks.append(cur)
                cur = []
            cur.append(node)
            cur_group = group
        if cur:
            chunks.append(cur)
        return chunks

    # -- commit ---------------------------------------------------------------

    def commit(self, tries: list["SparseTrie"], hasher=None) -> list[bytes]:
        """Hash every dirty subtree of ``tries`` and return their roots (in
        input order), bit-identical to calling ``root_hash_compute`` on
        each. The classic finish makes one hasher dispatch per global depth
        (``hasher`` defaults to ``device_hasher(self.device)``), streamed
        chunk by chunk through ``hasher.submit`` where the hasher has it; the
        fused finish one launch per ``subtrie_levels`` depths, or one
        ``hasher.commit_window`` where the hasher has that."""
        t_wall = time.perf_counter()
        roots: list[bytes | None] = [None] * len(tries)
        live: list[tuple[int, "SparseTrie"]] = []
        for i, t in enumerate(tries):
            if t.root is None:
                t.root_hash = EMPTY_ROOT_HASH
                t.updates = 0
                roots[i] = t.root_hash
            elif isinstance(t.root, _Blind):
                t.root_hash = t.root.hash
                roots[i] = t.root_hash
            else:
                live.append((i, t))
        stats = {"tries": len(live), "levels": 0, "dispatches": 0, "hashed": 0,
                 "encode_chunks": 0, "pooled_levels": 0, "streamed": 0}
        if not live:
            self.last = {**stats, "wall_s": 0.0}
            return roots
        if self.arena is not None and getattr(hasher, "commit_window", None) is None:
            # the hot-state delta finish; None: contended, or a fault (no
            # kernel fault) the arena counted and evicted for, and the same
            # commit reruns below
            delta = self._commit_fused_arena(live, roots, stats, t_wall)
            if delta is not None:
                return delta
        if self.subtrie_levels > 1:
            return self._commit_fused(live, roots, stats, t_wall, hasher)
        if hasher is None:
            if self._hasher is None:
                self._hasher = device_hasher(self.device)
            hasher = self._hasher

        levels = self._collect([t for _, t in live])
        encode_wall = [0.0]  # summed per-chunk encode time (pool side)

        def _encode_chunk(c):
            t0 = time.perf_counter()
            out = [_encode_rlp(n) for n in c]
            dt = time.perf_counter() - t0
            with self._pool_lock:
                encode_wall[0] += dt
            return out

        for depth in sorted(levels, reverse=True):
            entries = levels[depth]
            stats["levels"] += 1
            if self.injector is not None:
                self.injector.on_dispatch()
            if self.workers <= 1 or len(entries) < self.POOL_MIN_NODES:
                self._apply_level([node for _, node in entries],
                                  [_encode_rlp(node) for _, node in entries], hasher, stats)
                continue
            stats["pooled_levels"] += 1
            chunks = self._chunk(entries)
            stats["encode_chunks"] += len(chunks)
            pool = self._executor()
            sparse_commit_metrics.set_encode_busy(len(chunks))
            futs = [pool.submit(_encode_chunk, c) for c in chunks]
            try:
                if hasattr(hasher, "submit"):
                    self._stream_level(chunks, futs, hasher, stats)
                else:
                    nodes, rlps = [], []
                    for chunk, f in zip(chunks, futs):
                        nodes.extend(chunk)
                        rlps.extend(f.result())
                    self._apply_level(nodes, rlps, hasher, stats)
            finally:
                sparse_commit_metrics.set_encode_busy(0)

        # per-trie top: the root hash is keccak of the root RLP whatever its
        # size; every live trie's top goes in one dispatch
        if self.injector is not None:
            self.injector.on_dispatch()
        tops = [_encode_rlp(t.root) for _, t in live]
        stats["dispatches"] += 1
        stats["h2d_bytes"] = stats.get("h2d_bytes", 0) + sum(len(r) for r in tops)
        with tracing.span("trie::sparse", "hash.dispatch", msgs=len(tops), what="trie_tops"):
            digests = hasher(tops)
        for (i, t), d in zip(live, digests):
            t.root_hash = bytes(d)
            t.updates = 0
            roots[i] = t.root_hash
        if encode_wall[0]:
            # the pool's summed worker-side walls (chunks run concurrently,
            # so this is work, not wall clock)
            tracing.record_span("trie::sparse", "sparse.encode", time.time() - encode_wall[0],
                                encode_wall[0], ctx=tracing.current_context(),
                                fields={"chunks": stats["encode_chunks"]})
        stats["wall_s"] = round(time.perf_counter() - t_wall, 6)
        self.last = stats
        sparse_commit_metrics.record_commit(stats)
        return roots

    # -- whole-subtrie fused finish (k levels per launch) -------------------

    def _commit_fused(self, live, roots, stats, t_wall, hasher=None):
        """Pack the global per-depth schedule into hole-spliced level
        templates (the inline-vs-hashed split needs only RLP lengths, never
        digest values) and commit the whole dirty set through a
        ``SubtrieFusedEngine``: one launch of kernel 4 per
        ``subtrie_levels`` depths, one read-back of the digest buffer. With
        a hasher that has ``commit_window`` (the hash service's live lane)
        the window runs on the service instead. Digest slots start at 1;
        slot 0 is the engine's dummy."""
        commit_window = getattr(hasher, "commit_window", None)
        schedule, slot_of = self._templates(live, stats, itertools.count(1).__next__)
        window = self._pack_schedule(schedule, slot_of)
        if window:
            if commit_window is not None:
                buf = commit_window(window, len(slot_of))
                stats["streamed"] += len(window)
                stats["dispatches"] += max(1, -(-len(window) // self.subtrie_levels))
            else:
                eng = self._engine()
                eng.begin(len(slot_of))
                for w in window:
                    eng.dispatch_packed(w["flat"], w["row_off"], w["row_len"], w["slots"],
                                        w["holes"], w["b_tier"])
                buf = eng.finish()
                stats["dispatches"] += eng.dispatches
                stats["h2d_bytes"] = eng.staged_u8_bytes + eng.staged_i32_bytes
            for nodes, _templates, _holes in schedule:
                for node in nodes:
                    node._ref = encode_hash_ref(bytes(buf[slot_of[id(node)]]))
                    stats["hashed"] += 1
        self._set_roots(live, roots, slot_of)
        stats["wall_s"] = round(time.perf_counter() - t_wall, 6)
        stats["subtrie_k"] = self.subtrie_levels
        self.last = stats
        sparse_commit_metrics.record_commit(stats)
        return roots

    # -- hot-state arena delta finish -----------------------------------------

    def _commit_fused_arena(self, live, roots, stats, t_wall):
        """Commit the dirty set against the persistent ``DigestArena``: only
        this block's dirty rows stage; unchanged children (clean refs,
        blinds, reveal-stamped subtrees) inline as literal bytes or
        hole-splice rows still resident from earlier epochs. The terminal
        fetch is ``peek_slots`` (this epoch's rows), which keeps the buffer
        on the card for the next block.

        Returns None, and the caller reruns the same commit on the finish
        it takes without the arena, when the arena is contended or the epoch
        fails for a cause that is no kernel fault; a kernel fault raises.
        Either way the arena evicts first, so no partial epoch is ever
        referenced. The engine is built on ``self.device`` with its
        ladder off, outside any catch but the owner's. Roots are
        bit-identical either way: a resident splice writes the exact digest
        bytes the literal ref would have carried."""
        arena = self.arena
        if not arena.try_acquire():
            return None  # another finish holds the arena: classic finish
        try:
            evict_storm = self.hot_injector is not None and self.hot_injector.evict_storm
            fresh = arena.begin_epoch(evict_storm=evict_storm)
            eng = arena.engine
            if eng is None:
                eng = arena.engine = SubtrieFusedEngine(min_tier=64, k=self._arena_k,
                                                        device=self.device)
                fresh = True

            schedule, slot_of = self._templates(live, stats, arena.alloc,
                                                None if fresh else arena.lookup)
            epoch_nodes = [n for nodes, _t, _h in schedule for n in nodes]
            epoch_slots = [slot_of[id(n)] for n in epoch_nodes]
            window = self._pack_schedule(schedule, slot_of)
            h2d_bytes = 0
            if window:
                max_slots = arena.next_slot - 1
                if fresh:
                    eng.begin(max_slots)
                else:
                    eng.begin_delta(max_slots)
                for w in window:
                    eng.dispatch_packed(w["flat"], w["row_off"], w["row_len"], w["slots"],
                                        w["holes"], w["b_tier"])
                rows = eng.peek_slots(np.asarray(epoch_slots, dtype=np.int64))
                for node, slot, d in zip(epoch_nodes, epoch_slots, rows):
                    dig = bytes(d)
                    node._ref = encode_hash_ref(dig)
                    arena.note(dig, slot)
                    stats["hashed"] += 1
                stats["dispatches"] += eng.dispatches
                h2d_bytes = eng.staged_u8_bytes + eng.staged_i32_bytes

            self._set_roots(live, roots, slot_of)
            # delta-upload accounting: staged rows against the
            # reveal-stamped rows a cold finish would have staged again
            stamped = 0
            for _i, t in live:
                stamped += t.stamped
                t.stamped = 0
            staged_rows = len(epoch_nodes)
            denom = staged_rows + stamped
            delta_fraction = (staged_rows / denom) if denom else 0.0
            stats["wall_s"] = round(time.perf_counter() - t_wall, 6)
            stats["subtrie_k"] = self._arena_k
            stats["staged_rows"] = staged_rows
            stats["stamped_rows"] = stamped
            stats["delta_fraction"] = round(delta_fraction, 4)
            stats["h2d_bytes"] = h2d_bytes
            stats["arena_fresh"] = fresh
            self.last = stats
            sparse_commit_metrics.record_commit(stats)
            try:
                hotstate_metrics.record_arena(arena.snapshot(), delta_fraction=delta_fraction,
                                              staged_rows=staged_rows, stamped_rows=stamped,
                                              h2d_bytes=h2d_bytes, fresh=fresh)
            except Exception:  # noqa: BLE001 — metrics never gate a commit
                pass
            return roots
        except BaseException as e:  # noqa: BLE001 — the owner's catch: evict, count, rerun
            arena.on_fault(e)
            if not isinstance(e, Exception) or isinstance(e, InjectedSparseAbort):
                raise  # injected aborts and interrupts keep their meaning
            if is_kernel_fault(e):
                raise  # no classic rerun hides a failed build or a device fault
            return None
        finally:
            arena.release()

    def _templates(self, live, stats, alloc, resident=None):
        """The fused layout of the dirty set: by depth, deepest first, each
        hashed node's RLP template with holes and its slot from ``alloc()``
        (inline nodes are complete and get their refs here; ``resident``:
        see ``_child_ref_template``). The inline-vs-hashed split needs only
        RLP lengths, never digests. Returns ([(nodes, templates, holes)] by
        level, slot by node id)."""
        levels = self._collect([t for _, t in live])
        slot_of: dict[int, int] = {}
        schedule: list[tuple[list, list, list]] = []
        for depth in sorted(levels, reverse=True):
            if self.injector is not None:
                self.injector.on_dispatch()
            stats["levels"] += 1
            lv_nodes, lv_templates, lv_holes = [], [], []
            for _g, node in levels[depth]:
                t, holes = _node_template_sparse(node, slot_of, resident)
                if len(t) < 32:
                    node._ref = t  # inline: complete and hole-free
                    continue
                slot_of[id(node)] = alloc()
                lv_nodes.append(node)
                lv_templates.append(t)
                lv_holes.append(holes)
            if lv_nodes:
                schedule.append((lv_nodes, lv_templates, lv_holes))
        return schedule, slot_of

    @staticmethod
    def _set_roots(live, roots, slot_of: dict[int, int]) -> None:
        """Each live trie's root once its hashed nodes carry their refs: a
        hashed root's digest, else keccak of the full root RLP whatever its
        size (an inline or clean root: the serial path's rule)."""
        for i, t in live:
            if id(t.root) in slot_of:
                t.root_hash = bytes(t.root._ref[1:])
            else:
                t.root_hash = keccak256(_encode_rlp(t.root))
            t.updates = 0
            roots[i] = t.root_hash

    @staticmethod
    def _pack_schedule(schedule, slot_of: dict[int, int]) -> list[dict]:
        """Level template lists -> the engine's level arguments (flat bytes,
        row offsets and lengths, digest slots, hole triples, block tier)."""
        window: list[dict] = []
        for nodes, templates, holess in schedule:
            row_len = np.array([len(t) for t in templates], dtype=np.uint32)
            row_off = (np.cumsum(row_len) - row_len).astype(np.uint32)
            flat = np.frombuffer(b"".join(templates), dtype=np.uint8)
            slots = np.array([slot_of[id(n)] for n in nodes], dtype=np.int32)
            holes = [(i, off, src) for i, hl in enumerate(holess) for off, src in hl]
            holes = np.array(holes, dtype=np.int32).T if holes else None
            bt = 1
            while bt * RATE <= int(row_len.max()):
                bt *= 2
            window.append({"flat": flat, "row_off": row_off, "row_len": row_len,
                           "slots": slots, "holes": holes, "b_tier": bt})
        return window

    @staticmethod
    def _stream_level(chunks, futs, hasher, stats) -> None:
        """One pooled depth on the live lane: each encoded chunk's rows of 32
        bytes or more go to ``hasher.submit`` as their own request while the
        pool encodes the next chunks; the service fuses them back into full
        launches."""
        pending = []
        for chunk, f in zip(chunks, futs):
            rlps = f.result()
            to_hash = [(n, r) for n, r in zip(chunk, rlps) if len(r) >= 32]
            for n, r in zip(chunk, rlps):
                if len(r) < 32:
                    n._ref = r  # inline ref
            if to_hash:
                stats["streamed"] += 1
                stats["h2d_bytes"] = stats.get("h2d_bytes", 0) + sum(len(r) for _, r in to_hash)
                pending.append((to_hash, hasher.submit([r for _, r in to_hash])))
        for to_hash, fut in pending:
            for (n, _r), d in zip(to_hash, fut.result()):
                n._ref = encode_hash_ref(bytes(d))
                stats["hashed"] += 1
        stats["dispatches"] += 1 if pending else 0

    @staticmethod
    def _apply_level(nodes, rlps, hasher, stats) -> None:
        to_hash = [(n, r) for n, r in zip(nodes, rlps) if len(r) >= 32]
        for n, r in zip(nodes, rlps):
            if len(r) < 32:
                n._ref = r  # inline ref
        if to_hash:
            stats["dispatches"] += 1
            stats["h2d_bytes"] = stats.get("h2d_bytes", 0) + sum(len(r) for _, r in to_hash)
            with tracing.span("trie::sparse", "hash.dispatch", msgs=len(to_hash), what="level"):
                digests = hasher([r for _, r in to_hash])
            for (n, _r), d in zip(to_hash, digests):
                n._ref = encode_hash_ref(bytes(d))
                stats["hashed"] += 1


# -- state-level composition --------------------------------------------------


@dataclass
class SparseStateTrie:
    """Account trie + per-account storage tries, revealed from proofs.
    Keys are hashed (secure trie): callers pass keccak(address) and
    keccak(slot)."""

    account_trie: SparseTrie = field(default_factory=SparseTrie)
    storage_tries: dict[bytes, SparseTrie] = field(default_factory=dict)
    # the hot-state plane: reveal-ref stamping on every trie
    stamp_reveals: bool = False

    @classmethod
    def anchored(cls, state_root: bytes) -> "SparseStateTrie":
        return cls(account_trie=SparseTrie(state_root))

    def set_stamping(self, on: bool) -> None:
        """Turn reveal-ref stamping on or off for every current and future
        trie (the delta finish stages fewer rows with it on)."""
        self.stamp_reveals = on
        self.account_trie.stamp_reveals = on
        for t in self.storage_tries.values():
            t.stamp_reveals = on

    def reveal_account(self, proof_nodes: list[bytes],
                       by_hash: dict[bytes, bytes] | None = None) -> None:
        self.account_trie.reveal(proof_nodes, by_hash)

    def _new_trie(self, hashed_addr: bytes, storage_root: bytes) -> SparseTrie:
        st = self.storage_tries[hashed_addr] = SparseTrie(storage_root)
        st.stamp_reveals = self.stamp_reveals
        return st

    def storage_trie(self, hashed_addr: bytes,
                     storage_root: bytes = EMPTY_ROOT_HASH) -> SparseTrie:
        st = self.storage_tries.get(hashed_addr)
        if st is None:
            st = self._new_trie(hashed_addr, storage_root)
        return st

    def reveal_storage(self, hashed_addr: bytes, storage_root: bytes,
                       proof_nodes: list[bytes],
                       by_hash: dict[bytes, bytes] | None = None) -> None:
        st = self.storage_tries.get(hashed_addr)
        if st is None or (st.root is None and st.root_hash != storage_root):
            st = self._new_trie(hashed_addr, storage_root)
        st.reveal(proof_nodes, by_hash)

    def update_account(self, hashed_addr: bytes, account_rlp: bytes) -> None:
        self.account_trie.update(hashed_addr, account_rlp)

    def remove_account(self, hashed_addr: bytes) -> None:
        self.account_trie.delete(hashed_addr)
        self.storage_tries.pop(hashed_addr, None)

    def dirty_storage_tries(self) -> list[SparseTrie]:
        return [t for t in self.storage_tries.values()
                if t.updates or (t.root is not None and not isinstance(t.root, _Blind)
                                 and t.root._ref is None)]

    def root(self, hasher=None, committer: ParallelSparseCommitter | None = None,
             device: str | torch.device = "cuda") -> bytes:
        """State root over every dirty storage trie + the account trie.

        With a ``ParallelSparseCommitter`` the dirty storage tries and the
        account trie share one global per-depth schedule (the account
        trie's leaves already embed their storage roots, so there is no
        ordering constraint between the tries), on the committer's device.
        Without one, each trie runs its own level batching with ``hasher``,
        by default ``device_hasher(device)``."""
        dirty = self.dirty_storage_tries()
        if committer is not None:
            return committer.commit(dirty + [self.account_trie], hasher)[-1]
        if hasher is None:
            hasher = device_hasher(device)
        for t in dirty:
            t.root_hash_compute(hasher)
        return self.account_trie.root_hash_compute(hasher)


def export_branch_updates(trie: SparseTrie, changed_keys: list[bytes], old_branch=None):
    """Stored-format trie updates from an updated and hashed sparse trie.

    For every prefix of every changed key path, returns ``{path:
    BranchNode}`` where the trie holds a branch, and ``{path: None}`` (a
    delete marker) where it no longer does but the pre-state did
    (``old_branch(path)`` resolves). Only prefixes of changed keys can have
    changed stored nodes. Must be called after the root is computed (child
    refs must be clean).

    ``old_branch(path)`` resolves the pre-state stored branch; it also
    carries over ``tree_mask`` bits for blinded children (their subtrees are
    untouched by definition, so the old bit is still exact). Where the
    branch itself is new, a blinded child's bit is whether the pre-state
    stored a branch at the child's path. The reference leaves that bit
    clear, which loses a stored branch under a split extension (ROADMAP C).
    """
    out: dict[bytes, BranchNode | None] = {}
    branches: dict[bytes, _Branch] = {}
    old_cache: dict[bytes, object] = {}

    def old_at(path: bytes):
        if path not in old_cache:
            old_cache[path] = old_branch(path) if old_branch is not None else None
        return old_cache[path]

    # Which prefixes can hold a stale stored branch (a delete marker)? Only
    # pre-state branch paths along a changed key. Three sound cuts:
    # (a) a stored branch whose tree_mask bit for the key's next nibble is
    #     clear proves no deeper stored branch exists in that subtree;
    # (b) for a key still present post-state, pre-state branches on its path
    #     never lie deeper than its post-state walk depth (a deeper branch
    #     that collapsed did so because a sibling key was deleted this block,
    #     and the deleted key's own uncapped walk emits the marker);
    # (c) one pre-state read per distinct prefix across all keys.
    probe_caps: dict[bytes, int] = {}
    for key in changed_keys:
        nib = unpack_nibbles(key) if len(key) == 32 else key
        node, depth = trie.root, 0
        present = False
        while node is not None and not isinstance(node, _Blind):
            if isinstance(node, _Leaf):
                present = node.path == nib[depth:]
                break
            if isinstance(node, _Ext):
                if nib[depth:depth + len(node.path)] != node.path:
                    break
                depth += len(node.path)
                node = node.child
                continue
            branches[nib[:depth]] = node
            node = node.children[nib[depth]]
            depth += 1
        probe_caps[nib] = depth + 1 if present else 64

    # cut (a) prunes delete-marker probing only: every post-state branch
    # recorded by the walks is emitted below, so a new branch deeper than a
    # collapsed (bit-clear) pre-state branch is never skipped
    marker_candidates: set[bytes] = set()
    for nib, cap in probe_caps.items():
        for plen in range(0, min(cap, 64)):
            p = nib[:plen]
            if p in branches:
                continue  # post-state branch: emitted below, no marker
            ob = old_at(p)
            if ob is not None:
                marker_candidates.add(p)
                if not (ob.tree_mask >> nib[plen]) & 1:
                    break  # (a): provably nothing stored deeper pre-state

    for path in marker_candidates:
        if path not in branches:
            out[path] = None  # pre-state stored a branch here; gone now
    for path, br in branches.items():
        state_mask = tree_mask = hash_mask = 0
        hashes: list[bytes] = []
        old = None
        old_resolved = False
        for nibble in range(16):
            c = br.children[nibble]
            if c is None:
                continue
            state_mask |= 1 << nibble
            if isinstance(c, _Blind):
                # blinded child: its subtree is unchanged, so the old stored
                # node's bit is still exact; a branch new at ``path`` (an
                # insert split the extension above it) has no old node, and
                # the blinded child a split leaves is that extension's child,
                # a branch: stored at the child's own path
                if not old_resolved:
                    old = old_at(path)
                    old_resolved = True
                if old is not None:
                    has_branch = bool((old.tree_mask >> nibble) & 1)
                else:
                    has_branch = old_at(path + bytes([nibble])) is not None
            else:
                # an extension's child is always a branch (MPT)
                has_branch = not isinstance(c, _Leaf)
            if has_branch:
                tree_mask |= 1 << nibble
            ref = encode_hash_ref(c.hash) if isinstance(c, _Blind) else c._ref
            if ref is not None and len(ref) == 33:
                hash_mask |= 1 << nibble
                hashes.append(ref[1:])
        out[path] = BranchNode(state_mask, tree_mask, hash_mask, tuple(hashes))
    return out


class PreservedSparseTrie:
    """Cross-block sparse-trie cache anchored at the canonical tip: after a
    payload's state root is computed, the revealed and updated trie is kept
    under that block's hash; the next payload building on it takes the trie
    and reveals only the paths it newly touches. A reorg (parent mismatch)
    drops the cache."""

    def __init__(self):
        self._anchor: bytes | None = None
        self._trie: SparseStateTrie | None = None
        self.hits = 0
        self.misses = 0

    def take(self, parent_hash: bytes) -> SparseStateTrie | None:
        """Claim the preserved trie if it is anchored at ``parent_hash``."""
        if self._trie is not None and self._anchor == parent_hash:
            t, self._trie, self._anchor = self._trie, None, None
            self.hits += 1
            return t
        self.misses += 1
        return None

    def preserve(self, block_hash: bytes, trie: SparseStateTrie) -> None:
        self._anchor = block_hash
        self._trie = trie

    def peek(self, block_hash: bytes) -> SparseStateTrie | None:
        """Read the preserved trie without claiming it."""
        if self._trie is not None and self._anchor == block_hash:
            return self._trie
        return None

    def invalidate(self) -> None:
        self._anchor = None
        self._trie = None
