"""snap/1: state-range serving + client requests (snap sync protocol).

Reference analogue: the `StateRangeProvider` storage trait the reference
exposes for snap serving (crates/storage/storage-api/src/trie.rs:73) and
the snap wire vocabulary from the devp2p spec the ecosystem shares; reth
multiplexes extra capabilities next to eth via its RLPx sub-protocol
registry (crates/net/network/src/protocol.rs). Here snap/1 rides the
same encrypted session as eth/68: capability ids are assigned
alphabetically after eth's 17 message ids.

Messages (snap/1):

  0x00 GetAccountRange  [reqid, root, origin, limit, bytes]
  0x01 AccountRange     [reqid, [[hash, slim-account]...], [proof...]]
  0x02 GetStorageRanges [reqid, root, [acct-hash...], origin, limit, bytes]
  0x03 StorageRanges    [reqid, [[[hash, value]...]...], [proof...]]
  0x04 GetByteCodes     [reqid, [code-hash...], bytes]
  0x05 ByteCodes        [reqid, [code...]]
  0x06 GetTrieNodes     [reqid, root, [[path...]...], bytes]
  0x07 TrieNodes        [reqid, [node...]]

Accounts travel in the "slim" encoding: empty storage root / empty code
hash collapse to empty strings. Range responses carry boundary proofs
(origin + last returned key) so the requester can verify completeness
against the state root.

A copy of the JAX package's ``net/snap.py``. The one departure: the
``SnapServer`` proves its ranges on ``TrieCommitter(device=device)``
(kernel 1 on the card unless ``device="cpu"``), where the reference chose
the host numpy hasher.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..primitives.keccak import keccak256
from ..primitives.nibbles import unpack_nibbles
from ..primitives.rlp import decode_int, encode_int, rlp_decode, rlp_encode
from ..primitives.types import EMPTY_ROOT_HASH, Account

EMPTY_CODE_HASH = keccak256(b"")

# snap/1 message ids (offset within the capability)
GET_ACCOUNT_RANGE = 0x00
ACCOUNT_RANGE = 0x01
GET_STORAGE_RANGES = 0x02
STORAGE_RANGES = 0x03
GET_BYTE_CODES = 0x04
BYTE_CODES = 0x05
GET_TRIE_NODES = 0x06
TRIE_NODES = 0x07

SNAP_MSG_COUNT = 8
SOFT_RESPONSE_LIMIT = 2 * 1024 * 1024
MAX_CODES_SERVE = 1024


def slim_account(acc: Account) -> bytes:
    """Snap "slim" account body: empty root/code-hash become b""."""
    root = b"" if acc.storage_root == EMPTY_ROOT_HASH else acc.storage_root
    code = b"" if acc.code_hash == EMPTY_CODE_HASH else acc.code_hash
    return rlp_encode([encode_int(acc.nonce), encode_int(acc.balance), root, code])


def unslim_account(raw: bytes) -> Account:
    f = rlp_decode(raw)
    return Account(
        nonce=decode_int(f[0]), balance=decode_int(f[1]),
        storage_root=bytes(f[2]) or EMPTY_ROOT_HASH,
        code_hash=bytes(f[3]) or EMPTY_CODE_HASH,
    )


# -- message dataclasses ------------------------------------------------------


@dataclass
class GetAccountRange:
    request_id: int
    root: bytes
    origin: bytes
    limit: bytes
    response_bytes: int = SOFT_RESPONSE_LIMIT

    def encode_payload(self):
        return [encode_int(self.request_id), self.root, self.origin,
                self.limit, encode_int(self.response_bytes)]

    @classmethod
    def decode_payload(cls, f):
        return cls(decode_int(f[0]), bytes(f[1]), bytes(f[2]), bytes(f[3]),
                   decode_int(f[4]))


@dataclass
class AccountRange:
    request_id: int
    accounts: list[tuple[bytes, bytes]]  # (hashed key, slim body)
    proof: list[bytes]

    def encode_payload(self):
        return [encode_int(self.request_id),
                [[h, body] for h, body in self.accounts],
                list(self.proof)]

    @classmethod
    def decode_payload(cls, f):
        return cls(decode_int(f[0]),
                   [(bytes(e[0]), bytes(e[1])) for e in f[1]],
                   [bytes(p) for p in f[2]])


@dataclass
class GetStorageRanges:
    request_id: int
    root: bytes
    account_hashes: list[bytes]
    origin: bytes
    limit: bytes
    response_bytes: int = SOFT_RESPONSE_LIMIT

    def encode_payload(self):
        return [encode_int(self.request_id), self.root,
                list(self.account_hashes), self.origin, self.limit,
                encode_int(self.response_bytes)]

    @classmethod
    def decode_payload(cls, f):
        return cls(decode_int(f[0]), bytes(f[1]), [bytes(h) for h in f[2]],
                   bytes(f[3]), bytes(f[4]), decode_int(f[5]))


@dataclass
class StorageRanges:
    request_id: int
    slots: list[list[tuple[bytes, bytes]]]  # per account: (hashed slot, rlp value)
    proof: list[bytes]

    def encode_payload(self):
        return [encode_int(self.request_id),
                [[[h, v] for h, v in acct] for acct in self.slots],
                list(self.proof)]

    @classmethod
    def decode_payload(cls, f):
        return cls(decode_int(f[0]),
                   [[(bytes(e[0]), bytes(e[1])) for e in acct] for acct in f[1]],
                   [bytes(p) for p in f[2]])


@dataclass
class GetByteCodes:
    request_id: int
    hashes: list[bytes]
    response_bytes: int = SOFT_RESPONSE_LIMIT

    def encode_payload(self):
        return [encode_int(self.request_id), list(self.hashes),
                encode_int(self.response_bytes)]

    @classmethod
    def decode_payload(cls, f):
        return cls(decode_int(f[0]), [bytes(h) for h in f[1]], decode_int(f[2]))


@dataclass
class ByteCodes:
    request_id: int
    codes: list[bytes]

    def encode_payload(self):
        return [encode_int(self.request_id), list(self.codes)]

    @classmethod
    def decode_payload(cls, f):
        return cls(decode_int(f[0]), [bytes(c) for c in f[1]])


@dataclass
class GetTrieNodes:
    request_id: int
    root: bytes
    paths: list[list[bytes]]  # path groups: [acct-path] or [acct-path, slot-path...]
    response_bytes: int = SOFT_RESPONSE_LIMIT

    def encode_payload(self):
        return [encode_int(self.request_id), self.root,
                [[bytes(p) for p in grp] for grp in self.paths],
                encode_int(self.response_bytes)]

    @classmethod
    def decode_payload(cls, f):
        return cls(decode_int(f[0]), bytes(f[1]),
                   [[bytes(p) for p in grp] for grp in f[2]], decode_int(f[3]))


@dataclass
class TrieNodes:
    request_id: int
    nodes: list[bytes]

    def encode_payload(self):
        return [encode_int(self.request_id), list(self.nodes)]

    @classmethod
    def decode_payload(cls, f):
        return cls(decode_int(f[0]), [bytes(n) for n in f[1]])


_BY_ID = {
    GET_ACCOUNT_RANGE: GetAccountRange, ACCOUNT_RANGE: AccountRange,
    GET_STORAGE_RANGES: GetStorageRanges, STORAGE_RANGES: StorageRanges,
    GET_BYTE_CODES: GetByteCodes, BYTE_CODES: ByteCodes,
    GET_TRIE_NODES: GetTrieNodes, TRIE_NODES: TrieNodes,
}
_TO_ID = {v: k for k, v in _BY_ID.items()}


def encode_snap(msg) -> tuple[int, bytes]:
    return _TO_ID[type(msg)], rlp_encode(msg.encode_payload())


def decode_snap(mid: int, payload: bytes):
    cls = _BY_ID.get(mid)
    if cls is None:
        raise ValueError(f"unknown snap message {mid:#x}")
    return cls.decode_payload(rlp_decode(payload))


# -- server (StateRangeProvider analogue) ------------------------------------


class SnapServer:
    """Serves snap/1 ranges from the canonical hashed state.

    Responses are only meaningful for the CURRENT state root (snap
    servers may refuse stale roots — we return empty responses, which
    the spec treats as "unavailable")."""

    def __init__(self, factory, committer=None, device="cuda"):
        from ..trie.committer import TrieCommitter

        self.factory = factory
        # the port's committers are on the card by default (the reference
        # chose the host numpy hasher here for its dispatch latency)
        self.committer = committer or TrieCommitter(device=device)

    def _current_root(self, p) -> bytes:
        tip = p.last_block_number()
        h = p.header_by_number(tip)
        return h.state_root if h else b""

    def _account_proof_for(self, p, hashed_keys: list[bytes]) -> list[bytes]:
        from ..trie.incremental import IncrementalStateRoot, PrefixSet, plan_subtrie
        from ..trie.proof import _spine_nodes

        inc = IncrementalStateRoot(p, self.committer)
        paths = [unpack_nibbles(h) for h in hashed_keys]
        plan = plan_subtrie(p.account_branch, PrefixSet(paths))
        res = self.committer.commit_many(
            [(inc._scan_account_leaves(plan.dirty_ranges), dict(plan.boundaries))],
            collect_branches=False, proof_targets=[paths])
        nodes: list[bytes] = []
        seen = set()
        for path in paths:
            for n in _spine_nodes(res[0].proof_nodes, path):
                if n not in seen:
                    seen.add(n)
                    nodes.append(n)
        return nodes

    def _storage_proof_for(self, p, hashed_addr: bytes,
                           hashed_keys: list[bytes]) -> list[bytes]:
        from ..trie.incremental import IncrementalStateRoot, PrefixSet, plan_subtrie
        from ..trie.proof import _spine_nodes

        inc = IncrementalStateRoot(p, self.committer)
        paths = [unpack_nibbles(h) for h in hashed_keys]
        plan = plan_subtrie(lambda pa: p.storage_branch(hashed_addr, pa),
                            PrefixSet(paths))
        res = self.committer.commit_many(
            [(inc._scan_storage_leaves(hashed_addr, plan.dirty_ranges),
              dict(plan.boundaries))],
            collect_branches=False, proof_targets=[paths])
        nodes: list[bytes] = []
        seen = set()
        for path in paths:
            for n in _spine_nodes(res[0].proof_nodes, path):
                if n not in seen:
                    seen.add(n)
                    nodes.append(n)
        return nodes

    def account_range(self, req: GetAccountRange) -> AccountRange:
        from ..storage import tables as T

        with self.factory.provider() as p:
            if req.root != self._current_root(p):
                return AccountRange(req.request_id, [], [])
            budget = min(req.response_bytes, SOFT_RESPONSE_LIMIT)
            out: list[tuple[bytes, bytes]] = []
            size = 0
            cur = p.tx.cursor(T.Tables.HashedAccounts.name)
            entry = cur.seek(req.origin)
            while entry is not None:
                k, v = entry
                if k > req.limit and out:
                    break
                body = slim_account(T.decode_account(v))
                out.append((k, body))
                size += 32 + len(body)
                if size >= budget or k > req.limit:
                    break
                entry = cur.next()
            edges = [req.origin]
            if out:
                edges.append(out[-1][0])
            proof = self._account_proof_for(p, edges)
            return AccountRange(req.request_id, out, proof)

    def storage_ranges(self, req: GetStorageRanges) -> StorageRanges:
        from ..storage import tables as T

        with self.factory.provider() as p:
            if req.root != self._current_root(p):
                return StorageRanges(req.request_id, [], [])
            budget = min(req.response_bytes, SOFT_RESPONSE_LIMIT)
            all_slots: list[list[tuple[bytes, bytes]]] = []
            proof: list[bytes] = []
            size = 0
            origin = req.origin or b"\x00" * 32
            limit = req.limit or b"\xff" * 32
            # a proper-subset request (non-default window) must ALWAYS carry
            # boundary proofs, truncated or not — clients verify the window
            # against the storage root (snap/1 spec)
            windowed = origin != b"\x00" * 32 or limit != b"\xff" * 32
            for ha in req.account_hashes:
                acct_slots: list[tuple[bytes, bytes]] = []
                cur = p.tx.cursor(T.Tables.HashedStorages.name)
                entry = cur.seek_by_key_subkey(ha, origin)
                truncated = False
                while entry is not None:
                    key, data = entry
                    if key != ha:
                        break
                    hslot, value = data[:32], T.decode_storage_entry(data)[1]
                    if hslot > limit and acct_slots:
                        truncated = True
                        break
                    body = rlp_encode(encode_int(value))
                    acct_slots.append((hslot, body))
                    size += 32 + len(body)
                    if size >= budget or hslot > limit:
                        truncated = True
                        break
                    entry = cur.next_dup()
                all_slots.append(acct_slots)
                if truncated or windowed or size >= budget:
                    # proofs for the (possibly partial) last account range
                    edges = [origin]
                    if acct_slots:
                        edges.append(acct_slots[-1][0])
                    proof = self._storage_proof_for(p, ha, edges)
                    break
            return StorageRanges(req.request_id, all_slots, proof)

    def byte_codes(self, req: GetByteCodes) -> ByteCodes:
        with self.factory.provider() as p:
            budget = min(req.response_bytes, SOFT_RESPONSE_LIMIT)
            out, size = [], 0
            for h in req.hashes[:MAX_CODES_SERVE]:
                code = p.bytecode(h)
                if code is None:
                    continue
                out.append(code)
                size += len(code)
                if size >= budget:
                    break
            return ByteCodes(req.request_id, out)

    def trie_nodes(self, req: GetTrieNodes) -> TrieNodes:
        """Healing: fetch account/storage trie nodes by path. Node RLPs are
        regenerated through the proof machinery for the REQUESTED paths'
        spines, then matched by path."""
        with self.factory.provider() as p:
            if req.root != self._current_root(p):
                return TrieNodes(req.request_id, [])
            out: list[bytes] = []
            budget = min(req.response_bytes, SOFT_RESPONSE_LIMIT)
            size = 0
            for group in req.paths:
                if not group:
                    continue
                if len(group) == 1:
                    nodes = self._account_proof_for(p, [_pad_path(group[0])])
                else:
                    ha = group[0]
                    for sub in group[1:]:
                        nodes = self._storage_proof_for(p, ha, [_pad_path(sub)])
                        for n in nodes:
                            out.append(n)
                            size += len(n)
                        if size >= budget:
                            return TrieNodes(req.request_id, out)
                    continue
                for n in nodes:
                    out.append(n)
                    size += len(n)
                if size >= budget:
                    break
            return TrieNodes(req.request_id, out)


def _pad_path(path: bytes) -> bytes:
    """Trie-node paths may be partial; extend to a full 32-byte key for the
    spine walk (any key under the path shares the spine above it)."""
    return (path + b"\x00" * 32)[:32]


# -- range verification (client side) ----------------------------------------


def verify_account_range(root: bytes, origin: bytes,
                         rng: AccountRange) -> bool:
    """Boundary-proof check: keys sorted from origin, the origin spine
    verifies against the root, and the LAST returned account proves
    membership with its value (the proofs cover the range boundaries —
    interior completeness follows from the boundary spines in a full
    stitch, which the sync pipeline does when healing)."""
    keys = [h for h, _ in rng.accounts]
    if keys != sorted(keys) or (keys and keys[0] < origin):
        return False
    if not rng.accounts:
        return True
    by_hash = {keccak256(n): n for n in rng.proof}
    ok, _leaf = _verify_path_from(root, origin, by_hash, rng.proof)
    if not ok:
        return False
    last_h, last_body = rng.accounts[-1]
    ok, leaf = _verify_path_from(root, last_h, by_hash, rng.proof)
    if not ok:
        return False
    return leaf == unslim_account(last_body).trie_encode()


def _verify_path_from(root: bytes, hashed_key: bytes, by_hash, nodes):
    """Spine walk over an unordered node set (snap proofs are a set, not a
    root→leaf list)."""
    from ..primitives.nibbles import decode_path

    path = unpack_nibbles(hashed_key)
    cur = by_hash.get(root)
    if cur is None:
        return False, None
    depth = 0
    while True:
        node = rlp_decode(cur)
        if len(node) == 17:
            if depth == len(path):
                return True, node[16] or None
            child = node[path[depth]]
            depth += 1
            if child in (b"", []):
                return True, None
            nxt = child
        elif len(node) == 2:
            nibs, is_leaf = decode_path(node[0])
            if is_leaf:
                return True, (node[1] if path[depth:] == nibs else None)
            if path[depth:depth + len(nibs)] != nibs:
                return True, None
            depth += len(nibs)
            nxt = node[1]
        else:
            return False, None
        if isinstance(nxt, bytes) and len(nxt) == 32:
            cur = by_hash.get(nxt)
            if cur is None:
                return False, None
        else:
            cur = rlp_encode(nxt)
