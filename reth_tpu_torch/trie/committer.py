"""Level-batched trie committer — structure on the host, hashing on the card.

Port of the JAX package's ``trie/committer.py`` (same structure phase, same
outputs); the hash phase runs on ``ops.keccak.KeccakDevice`` (one batched
launch per level) or, with ``fused=True``, on
``ops.fused_commit.FusedLevelEngine`` (every level against a resident digest
buffer, one read-back at the end).

1. **Structure phase (host):** build the radix structure of the (sub)trie
   from sorted leaves. Unchanged subtrees can be passed in as *opaque
   boundary refs* (path → 32-byte hash).
2. **Hash phase (device):** nodes are grouped by nibble depth and hashed
   bottom-up one whole level per dispatch. A node's parent always sits at a
   strictly smaller depth, so level order is a valid topological order.

Outputs mirror the reference's `TrieUpdates`: the root hash plus every
branch node with its state/tree/hash masks and child hashes
(reference `BranchNodeCompact`, crates/trie/common/src/updates.rs).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import torch

from ..device import resolve
from ..ops.fused_commit import FusedLevelEngine, FusedMeshEngine, _Bucket
from ..ops.keccak import KeccakDevice
from ..ops.supervisor import SupervisedBackend, SupervisedHasher
from ..primitives.keccak import RATE, keccak256
from ..primitives.nibbles import Nibbles, common_prefix_len, encode_path
from ..primitives.rlp import _encode_length, rlp_encode
from ..primitives.types import EMPTY_ROOT_HASH
from .node import (
    EMPTY_STRING_RLP,
    HASH_REF_HOLE,
    branch_node_rlp,
    encode_hash_ref,
    extension_node_rlp,
    leaf_node_rlp,
    ref_is_hash,
)

LEAF = 0
EXT = 1
BRANCH = 2
OPAQUE = 3  # unchanged subtree boundary: ref is a known 32-byte hash


class BoundaryCollapse(Exception):
    """Structure change would merge a path INTO an opaque boundary node.

    Raised when the rebuilt trie needs an extension pointing at a boundary
    — e.g. deletions left a branch with a single unchanged child. The
    boundary node's kind (leaf/ext/branch) is unknown from its hash alone,
    so the caller must "reveal" the subtree (drop the boundary, supply its
    leaves) and retry — the analogue of the reference's sparse-trie node
    reveal on branch collapse (crates/trie/sparse/src/state.rs).
    """

    def __init__(self, path: Nibbles):
        self.path = path
        super().__init__(f"boundary collapse at {path.hex()}")


@dataclass
class _Node:
    kind: int
    at: Nibbles                     # trie path where this node sits
    ext_path: Nibbles = b""         # leaf/ext: remaining path below ``at``
    value: bytes = b""              # leaf value / branch value
    children: list[int] | None = None  # branch: 16 indices into node arena (-1 = none)
    child: int = -1                 # ext: child index
    ref: bytes = b""                # resolved RLP-encoded reference
    node_hash: bytes = b""          # keccak of rlp, when hashed
    slot: int = 0                   # fused path: digest-buffer slot (0 = not hashed)
    opaque_branch: bool = True      # OPAQUE: subtree contains stored branches


@dataclass(frozen=True)
class BranchNode:
    """Stored branch node (reference `BranchNodeCompact`)."""

    state_mask: int
    tree_mask: int
    hash_mask: int
    hashes: tuple[bytes, ...]

    def child_hash(self, nibble: int) -> bytes | None:
        if not (self.hash_mask >> nibble) & 1:
            return None
        idx = bin(self.hash_mask & ((1 << nibble) - 1)).count("1")
        return self.hashes[idx]


@dataclass
class TrieBuildResult:
    root: bytes
    branch_nodes: dict[Nibbles, BranchNode] = field(default_factory=dict)
    hashed_nodes: int = 0
    levels: int = 0
    # node RLPs along requested proof spines: trie path -> node RLP
    proof_nodes: dict[Nibbles, bytes] = field(default_factory=dict)


class TrieCommitter:
    """Builds (sub)trie structure from sorted leaves and batch-hashes it.

    ``hasher``: callable ``list[bytes] -> list[bytes]`` — the batched keccak
    backend (``ops.keccak.KeccakDevice.hash_batch``, the numpy baseline, or
    the pure reference).
    """

    def __init__(self, hasher=None, fused: bool = False, min_tier: int = 1024,
                 mesh=None, supervisor=None, warmup=None,
                 device: str | torch.device = "cuda"):
        """``fused=True`` switches the hash phase to the fused multi-level
        commit (``ops.fused_commit.FusedLevelEngine`` on ``device``): child
        digests stay resident on the card between levels, and one read-back
        at the end resolves every node hash. ``hasher`` is ignored when
        fused, and left unset as the reference leaves it. A missing
        ``hasher`` without ``fused`` builds ``KeccakDevice(min_tier,
        block_tier=4)`` on ``device``. ``supervisor`` (an
        ``ops/supervisor.py DeviceSupervisor``) puts every device call
        behind the watchdog and the breaker with failover to the numpy twin
        (the reference's ``--hasher auto``): the fused engine runs as a
        ``SupervisedBackend``, a missing ``hasher`` becomes a
        ``SupervisedHasher``. ``warmup`` (an ``ops/warmup.py
        WarmupManager``) adds degraded serving: the default hasher's
        ``KeccakDevice`` hashes each un-warm bucket on the host until its
        shape is warm (a supervised fused commit is gated through the
        supervisor the manager attached to). ``mesh`` (a ``parallel/mesh.py``
        HashMesh, or one of its memberships) shards the fused level loop
        over its live members: the engine is a ``FusedMeshEngine``; ``hasher``
        and the unfused path ignore it, as in the reference."""
        # the card this committer hashes on, checked when it hashes there;
        # the rebuilds built from it (stages/merkle.py) run on it too
        self.device = (resolve(device) if fused or hasher is None
                       else torch.device(device))
        self.fused = fused
        self.supervisor = supervisor
        self.warmup = warmup
        self._engine = None
        if fused:
            dev = self.device
            if mesh is not None:
                def engine_factory():
                    return FusedMeshEngine(mesh, min_tier=min_tier)
            else:
                def engine_factory():
                    return FusedLevelEngine(min_tier=min_tier, device=dev)
            if supervisor is not None:
                self._engine = SupervisedBackend(supervisor, engine_factory, device=dev)
            else:
                self._engine = engine_factory()
        elif hasher is None:
            if supervisor is not None:
                hasher = SupervisedHasher(supervisor, min_tier=min_tier, warmup=warmup,
                                          device=device)
            else:
                # Trie nodes are <= 4 rate blocks (branch max ~533 B): one
                # shared block-tier bucket per batch
                hasher = KeccakDevice(min_tier=min_tier, block_tier=4, warmup=warmup,
                                      device=device).hash_batch
        self.hasher = hasher
        # the shared hash service (ops/hash_service.py) when one is hung off
        # this committer: ``hasher`` is then a lane-bound client, and
        # ``for_lane`` hands each call site its own priority lane
        self.hash_service = None
        # the member mesh (parallel/mesh.py HashMesh) a node hangs off this
        # committer, as the reference's --mesh wiring does
        self.hash_mesh = None

    def attach_warmup(self, manager) -> None:
        """Late-bind a warm-up manager to a built committer: per-bucket
        routing for the ``KeccakDevice``-backed hashers and a meshed hash
        service's ``MeshKeccak`` (the supervised fused path is gated through
        the supervisor the manager attached to)."""
        self.warmup = manager
        h = self.hasher
        if isinstance(h, SupervisedHasher):
            h._warmup = manager
            h._device = None  # rebuilt with the manager at the next call
        else:
            owner = getattr(h, "__self__", None)  # KeccakDevice.hash_batch
            if isinstance(owner, KeccakDevice):
                owner.warmup = manager
        svc = self.hash_service
        if svc is not None and getattr(svc, "_mesh_hasher", None) is not None:
            # a meshed service's sharded front-end routes by the menu too
            svc._mesh_hasher.warmup = manager

    def for_lane(self, lane: str) -> "TrieCommitter":
        """A shallow clone whose ``hasher`` is the hash service's client on
        ``lane`` (live > payload > rebuild > proof). Without a service, or on
        the fused path (which does not hash through ``hasher``), the
        committer itself."""
        if self.hash_service is None or self.fused:
            return self
        clone = copy.copy(self)
        clone.hasher = self.hash_service.client(lane)
        return clone

    def commit(
        self,
        leaves: list[tuple[Nibbles, bytes]],
        boundaries: dict[Nibbles, bytes] | None = None,
        collect_branches: bool = True,
    ) -> TrieBuildResult:
        """Compute the root of the trie holding ``leaves``.

        ``leaves``: (full nibble path, RLP-encoded value) pairs, need not be
        sorted; empty values are disallowed (deletion = omit the leaf).
        ``boundaries``: path → 32-byte subtree hash for unchanged subtrees
        (the node at ``path`` is referenced, not rebuilt), or
        (hash, has_branch) to state whether the subtree contains stored
        branch nodes (drives the parent's ``tree_mask``; bare hashes are
        conservatively treated as branch-containing). No leaf path may
        pass through a boundary path.
        """
        return self.commit_many([(leaves, boundaries)], collect_branches)[0]

    def commit_many(
        self,
        jobs: list[tuple[list[tuple[Nibbles, bytes]], dict[Nibbles, bytes] | None]],
        collect_branches: bool = True,
        proof_targets: list[list[Nibbles]] | None = None,
    ) -> list[TrieBuildResult]:
        """Commit MANY independent tries with shared level batching.

        All tries' nodes at the same depth are hashed in one device dispatch
        — this is how per-account storage tries (small, shallow) keep the
        device busy, replacing the reference's per-account sequential
        `StorageRoot` walks (reference crates/trie/trie/src/trie.rs:488).
        """
        arenas: list[list[_Node] | None] = []
        roots_idx: list[int] = []
        results = [TrieBuildResult(root=EMPTY_ROOT_HASH) for _ in jobs]
        for leaves, boundaries in jobs:
            items = self._items(leaves, boundaries)
            if not items:
                arenas.append(None)
                roots_idx.append(-1)
                continue
            arena: list[_Node] = []
            roots_idx.append(self._build(arena, items, 0, 0, len(items), b""))
            arenas.append(arena)

        if self.fused:
            self._hash_levels_fused(arenas, results, proof_targets)
        else:
            self._hash_levels(arenas, results, proof_targets)

        for arena, root_idx, result in zip(arenas, roots_idx, results):
            if arena is None:
                continue
            root_node = arena[root_idx]
            if root_node.node_hash:
                result.root = root_node.node_hash
            elif root_node.kind == OPAQUE:
                # whole trie unchanged: the boundary hash IS the root
                result.root = root_node.ref[1:]
            else:  # root rlp < 32 bytes: root hash is still keccak of it
                result.root = keccak256(root_node.ref)
            if collect_branches:
                self._collect_branches(arena, result)
        return results

    def collapses(self, leaves: list[tuple[Nibbles, bytes]],
                  boundaries: dict[Nibbles, bytes] | None) -> list[Nibbles]:
        """Every boundary path the structure of ``leaves`` and ``boundaries``
        collapses into, from one structure pass (no hashing). ``commit``
        raises ``BoundaryCollapse`` at the first of them; a reveal of one
        leaves the others as they were, so a caller may reveal them all at
        once."""
        items = self._items(leaves, boundaries)
        found: list[Nibbles] = []
        if items:
            self._build([], items, 0, 0, len(items), b"", found)
        return found

    # -- structure phase ----------------------------------------------------

    @staticmethod
    def _items(leaves, boundaries) -> list[tuple[Nibbles, int, object]]:
        """One job's leaves and boundaries as sorted structure items."""
        items: list[tuple[Nibbles, int, object]] = [(p, LEAF, v) for p, v in leaves]
        for p, h in (boundaries or {}).items():
            items.append((p, OPAQUE, h if isinstance(h, tuple) else (h, True)))
        items.sort(key=lambda t: t[0])
        for i in range(1, len(items)):
            a, b = items[i - 1][0], items[i][0]
            if a == b or (
                len(a) < len(b) and b[: len(a)] == a and items[i - 1][1] == OPAQUE
            ):
                raise ValueError(f"conflicting trie items at {a.hex()}/{b.hex()}")
        return items

    def _build(self, arena, items, depth, lo, hi, at: Nibbles, collapsed=None) -> int:
        """Build the subtree for items[lo:hi]; all share ``at`` (= depth
        nibbles). With a ``collapsed`` list, a collapse is recorded there
        (the structure is then only a survey) instead of raised."""
        if hi - lo == 1:
            path, kind, payload = items[lo]
            if kind == LEAF:
                arena.append(_Node(LEAF, at, ext_path=path[depth:], value=payload))
                return len(arena) - 1
            if len(path) == depth:
                arena.append(_Node(OPAQUE, at, ref=encode_hash_ref(payload[0]),
                                   opaque_branch=payload[1]))
                return len(arena) - 1
            # A lone opaque subtree strictly below this point means the
            # surrounding structure collapsed into it — its node kind is
            # unknown, so the boundary must be revealed by the caller.
            if collapsed is None:
                raise BoundaryCollapse(path)
            collapsed.append(path)
            arena.append(_Node(OPAQUE, at))
            return len(arena) - 1
        # common prefix of all items below depth
        first = items[lo][0]
        last = items[hi - 1][0]  # sorted ⇒ min/max share the group prefix
        cpl = common_prefix_len(first[depth:], last[depth:])
        if cpl > 0:
            child = self._build(arena, items, depth + cpl, lo, hi, first[: depth + cpl],
                                collapsed)
            arena.append(_Node(EXT, at, ext_path=first[depth : depth + cpl], child=child))
            return len(arena) - 1
        children = [-1] * 16
        value = b""
        i = lo
        if len(first) == depth:  # branch value (non-secure tries only)
            if items[lo][1] != LEAF:
                raise ValueError("opaque boundary cannot sit at a branch value")
            value = items[lo][2]
            i += 1
        while i < hi:
            nib = items[i][0][depth]
            j = i
            while j < hi and items[j][0][depth] == nib:
                j += 1
            children[nib] = self._build(arena, items, depth + 1, i, j,
                                        first[:depth] + bytes([nib]), collapsed)
            i = j
        arena.append(_Node(BRANCH, at, value=value, children=children))
        return len(arena) - 1

    # -- hash phase ---------------------------------------------------------

    @staticmethod
    def _make_on_spine(proof_targets):
        """Spine test shared by both hash phases: a node is on a proof spine
        if its trie path is a prefix of any target key."""

        def on_spine(aid: int, at: Nibbles) -> bool:
            if not proof_targets or not proof_targets[aid]:
                return False
            return any(t[: len(at)] == at for t in proof_targets[aid])

        return on_spine

    @staticmethod
    def _group_by_depth(arenas) -> dict[int, list[tuple[int, int]]]:
        """(aid, node idx) per nibble depth — the level batching order."""
        by_depth: dict[int, list[tuple[int, int]]] = {}
        for aid, arena in enumerate(arenas):
            if arena is None:
                continue
            for idx, node in enumerate(arena):
                if node.kind != OPAQUE:
                    by_depth.setdefault(len(node.at), []).append((aid, idx))
        return by_depth

    @staticmethod
    def _set_levels(results, arenas, total_levels: int) -> None:
        for r, arena in zip(results, arenas):
            if arena is not None:
                r.levels = total_levels

    def _hash_levels(
        self,
        arenas: list[list[_Node] | None],
        results: list[TrieBuildResult],
        proof_targets: list[list[Nibbles]] | None = None,
    ) -> None:
        """Hash all arenas bottom-up, one device dispatch per depth level.

        ``proof_targets[aid]``: full key paths whose spines' node RLPs are
        recorded into ``results[aid].proof_nodes`` (a node is on a spine if
        its path is a prefix of a target)."""
        on_spine = self._make_on_spine(proof_targets)
        by_depth = self._group_by_depth(arenas)
        for depth in sorted(by_depth, reverse=True):
            level = by_depth[depth]
            rlps: list[bytes] = []
            for aid, idx in level:
                arena = arenas[aid]
                node = arena[idx]
                if node.kind == LEAF:
                    rlp = leaf_node_rlp(node.ext_path, node.value)
                elif node.kind == EXT:
                    rlp = extension_node_rlp(node.ext_path, arena[node.child].ref)
                else:
                    refs = [
                        arena[c].ref if c >= 0 else EMPTY_STRING_RLP
                        for c in node.children
                    ]
                    rlp = branch_node_rlp(refs, node.value)
                rlps.append(rlp)
            to_hash = [(pos, r) for pos, r in zip(level, rlps) if len(r) >= 32]
            hashes = self.hasher([r for _, r in to_hash]) if to_hash else []
            for ((aid, idx), _rlp), h in zip(to_hash, hashes):
                arenas[aid][idx].node_hash = h
                arenas[aid][idx].ref = encode_hash_ref(h)
                results[aid].hashed_nodes += 1
            for (aid, idx), rlp in zip(level, rlps):
                if not arenas[aid][idx].node_hash:
                    arenas[aid][idx].ref = rlp  # inline
                if on_spine(aid, arenas[aid][idx].at):
                    results[aid].proof_nodes[arenas[aid][idx].at] = rlp
        self._set_levels(results, arenas, len(by_depth))

    # -- fused hash phase (device-resident digests) -------------------------

    def _child_ref_template(self, arena, c: int) -> tuple[bytes, int]:
        """Child reference as template bytes + digest source slot (0 = none).

        A hashed child contributes a 33-byte placeholder whose digest the
        device splices from the resident buffer; inline and opaque children
        contribute literal host-known bytes. The inline-vs-hashed decision
        needs only RLP *lengths*, never digest values — the invariant the
        whole fused path rests on (an inline node, <32 B, can never contain
        a 33-byte hash ref, so inline RLP is always hole-free)."""
        node = arena[c]
        if node.slot:
            return HASH_REF_HOLE, node.slot
        return node.ref, 0

    def _node_template(self, arena, node) -> tuple[bytes, list[tuple[int, int]]]:
        """(RLP template with zero-filled holes, [(byte_off, src_slot)])."""
        if node.kind == LEAF:
            return leaf_node_rlp(node.ext_path, node.value), []
        holes: list[tuple[int, int]] = []
        if node.kind == EXT:
            prefix = rlp_encode(encode_path(node.ext_path, False))
            ref, src = self._child_ref_template(arena, node.child)
            payload = prefix + ref
            if src:
                holes.append((len(prefix) + 1, src))  # +1 skips the 0xa0
        else:
            parts: list[bytes] = []
            off = 0
            for c in node.children:
                if c < 0:
                    ref = EMPTY_STRING_RLP
                else:
                    ref, src = self._child_ref_template(arena, c)
                    if src:
                        holes.append((off + 1, src))
                parts.append(ref)
                off += len(ref)
            parts.append(rlp_encode(node.value))
            payload = b"".join(parts)
        header = _encode_length(len(payload), 0xC0)
        return header + payload, [(len(header) + o, s) for o, s in holes]

    def _hash_levels_fused(
        self,
        arenas: list[list[_Node] | None],
        results: list[TrieBuildResult],
        proof_targets: list[list[Nibbles]] | None = None,
    ) -> None:
        """Fused hash phase: every level queues on the device without any
        D2H; digests resolve from ONE buffer fetch at the end. Template
        building for the next level overlaps device hashing of the previous
        one (async dispatch). See ``ops.fused_commit``."""
        on_spine = self._make_on_spine(proof_targets)
        engine = self._engine
        by_depth = self._group_by_depth(arenas)
        total_nodes = sum(len(a) for a in arenas if a is not None)
        engine.begin(total_nodes)
        hashed: list[tuple[int, int]] = []  # (aid, idx) with slots to resolve
        spines: list[tuple[int, Nibbles, bytes, list[tuple[int, int]]]] = []
        for depth in sorted(by_depth, reverse=True):
            plain, splice = _Bucket(), _Bucket()
            for aid, idx in by_depth[depth]:
                arena = arenas[aid]
                node = arena[idx]
                template, holes = self._node_template(arena, node)
                if len(template) >= 32:
                    node.slot = engine.alloc_slot()
                    nb = len(template) // RATE + 1
                    (splice if holes else plain).add(template, nb, node.slot, holes)
                    hashed.append((aid, idx))
                else:
                    node.ref = template  # inline: complete, hole-free
                if on_spine(aid, node.at):
                    spines.append((aid, node.at, template, holes))
            engine.dispatch_level(plain)
            engine.dispatch_level(splice)
        digests = engine.finish()  # the single D2H of the whole commit
        for aid, idx in hashed:
            node = arenas[aid][idx]
            h = digests[node.slot].tobytes()
            node.node_hash = h
            node.ref = encode_hash_ref(h)
            results[aid].hashed_nodes += 1
        for aid, at, template, holes in spines:
            rlp = bytearray(template)
            for off, src in holes:
                rlp[off : off + 32] = digests[src].tobytes()
            results[aid].proof_nodes[at] = bytes(rlp)
        self._set_levels(results, arenas, len(by_depth))

    # -- TrieUpdates --------------------------------------------------------

    def _collect_branches(self, arena: list[_Node], result: TrieBuildResult) -> None:
        # tree_mask: child subtree contains stored (branch) nodes
        def subtree_has_branch(idx: int) -> bool:
            node = arena[idx]
            if node.kind == BRANCH:
                return True
            if node.kind == OPAQUE:
                return node.opaque_branch
            if node.kind == EXT:
                return subtree_has_branch(node.child)
            return False

        for node in arena:
            if node.kind != BRANCH:
                continue
            state_mask = tree_mask = hash_mask = 0
            hashes: list[bytes] = []
            for nib in range(16):
                c = node.children[nib]
                if c < 0:
                    continue
                state_mask |= 1 << nib
                if subtree_has_branch(c):
                    tree_mask |= 1 << nib
                cref = arena[c].ref
                if ref_is_hash(cref):
                    hash_mask |= 1 << nib
                    hashes.append(cref[1:])
            result.branch_nodes[node.at] = BranchNode(
                state_mask, tree_mask, hash_mask, tuple(hashes)
            )
