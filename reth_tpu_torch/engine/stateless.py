"""Stateless block validation over a witness-backed sparse trie.

A copy of the JAX package's ``engine/stateless.py``: ``WitnessStateSource``
answers every read of the port's EVM from a sparse trie revealed out of the
witness's nodes, ``apply_output_to_trie`` applies the block's state delta to
that trie and recomputes the root (the step the live tip,
``engine/sparse_root.py``, finishes every block with), and
``StatelessChain`` validates consecutive blocks over the preserved sparse
trie (``PreservedSparseTrie``): block n+1 anchors on the trie block n left
and reveals only what it newly touches.

Two departures from the reference, with its results and its messages:

- ``StatelessChain`` roots on the card by default: without a ``hasher`` it
  hashes the witness on a ``KeccakDevice`` (kernel 1) and finishes each block
  through ``ParallelSparseCommitter(device=device)``; the reference's
  default is host numpy. ``device="cpu"`` runs the kernels' plain versions;
  a ``hasher`` of the caller's hashes everything, the finish serially per
  trie, as in the reference;
- ``validate`` hashes the witness's nodes, its key preimages and its codes
  in one batch and reveals with that map (``SparseTrie.reveal(by_hash=)``),
  where the reference hashes every node on the host once for the account
  trie and once more for each storage trie it reveals; the key digests
  feed ``apply_output_to_trie(digests=)`` and the state source's reads.
  The block's senders come from the port's native batch
  (``primitives/types.py recover_senders``); a signature it cannot recover
  is recovered again one at a time, which raises the reference's error.

Reference analogue: the stateless validation flow the reference exposes
through `debug_executionWitness` + invalid-block witness hooks
(crates/engine/invalid-block-hooks/src/witness.rs), and the sparse-trie
state-root strategy's reveal→update→rehash loop
(crates/engine/tree/src/tree/state_root_strategy/sparse_trie.rs:126-259).
"""

from __future__ import annotations

import time
from dataclasses import replace

import torch

from .. import tracing
from ..evm.executor import BlockExecutor, StateSource
from ..primitives.keccak import keccak256, keccak256_batch_np
from ..primitives.rlp import decode_int, encode_int, rlp_decode, rlp_encode
from ..primitives.types import KECCAK_EMPTY, Account, Block, Header, recover_senders
from ..trie.sparse import (
    BlindedNodeError,
    ParallelSparseCommitter,
    PreservedSparseTrie,
    SparseStateTrie,
    SparseTrie,
)


class StatelessValidationError(Exception):
    pass


def _decode_account_leaf(leaf: bytes) -> Account:
    nonce, balance, storage_root, code_hash = rlp_decode(leaf)
    return Account(nonce=decode_int(nonce), balance=decode_int(balance),
                   storage_root=storage_root, code_hash=code_hash)


class WitnessStateSource(StateSource):
    """EVM state source answering every read from a shared sparse trie
    revealed out of witness nodes (no database anywhere). ``by_hash`` (the
    witness's nodes keyed by their keccak) and ``digests`` (plain key ->
    keccak) are the caller's batch; without them nodes and keys hash on the
    host, as in the reference."""

    def __init__(self, trie: SparseStateTrie, witness_nodes: list[bytes],
                 codes: list[bytes], by_hash: dict[bytes, bytes] | None = None,
                 digests: dict[bytes, bytes] | None = None):
        self.trie = trie
        self.nodes = witness_nodes
        self.by_hash = by_hash
        self.digests = digests if digests is not None else {}
        self.codes = {self._key(c): c for c in codes}
        self._storage_revealed: set[bytes] = set()

    def _key(self, data: bytes) -> bytes:
        digest = self.digests.get(data)
        return digest if digest is not None else keccak256(data)

    def account(self, address: bytes) -> Account | None:
        leaf = self.trie.account_trie.get(self._key(address))
        return _decode_account_leaf(leaf) if leaf is not None else None

    def storage(self, address: bytes, slot: bytes) -> int:
        acct = self.account(address)
        if acct is None:
            return 0
        ha = self._key(address)
        if ha not in self._storage_revealed:
            self.trie.reveal_storage(ha, acct.storage_root, self.nodes, self.by_hash)
            self._storage_revealed.add(ha)
        leaf = self.trie.storage_trie(ha).get(self._key(slot))
        return decode_int(rlp_decode(leaf)) if leaf is not None else 0

    def bytecode(self, code_hash: bytes) -> bytes:
        if code_hash == KECCAK_EMPTY:
            return b""
        code = self.codes.get(code_hash)
        if code is None:
            raise StatelessValidationError(
                f"witness missing bytecode {code_hash.hex()}")
        return code


def apply_output_to_trie(st: SparseStateTrie, out,
                         hasher=keccak256_batch_np,
                         storage_roots_out: dict | None = None,
                         committer=None, digests: dict | None = None) -> bytes:
    """Apply a BlockExecutionOutput's state delta to the sparse state trie
    and return the recomputed root. Raises BlindedNodeError when an edit
    needs an unrevealed path (a storage trie's carries its ``owner``):
    witness generation catches it to close the witness, stateless validation
    treats it as an incomplete witness.
    ``storage_roots_out`` (plain address -> recomputed storage root) is
    filled for callers that must mirror the roots into hashed tables (the
    live tip). ``committer`` (a ``trie/sparse.py``
    :class:`~reth_tpu_torch.trie.sparse.ParallelSparseCommitter`) switches
    hashing to the parallel packed path on its device: all writes apply
    first (host pointer work), then every dirty storage trie hashes in ONE
    cross-trie per-depth schedule, then the account trie — bit-identical
    roots, far fewer dispatches. Without one each trie hashes serially with
    ``hasher``. ``digests`` (plain key -> its keccak digest, such as the
    live tip's digest map) spares the host keccak of the keys it holds,
    whose digests the reference recomputes on every call; the others hash
    on the host as in the reference."""
    known = digests if digests is not None else {}

    def key_hash(key: bytes) -> bytes:
        digest = known.get(key)
        return digest if digest is not None else keccak256(key)

    # storage wipes reset the trie (SELFDESTRUCT / re-created accounts)
    for a in out.changes.wiped_storage:
        st.storage_tries[key_hash(a)] = SparseTrie()
    # phase 1: storage writes (structure-only; hashing is deferred so the
    # parallel path can pack every dirty trie into one schedule)
    touched_storage: list[tuple[bytes, SparseTrie]] = []
    for a, slots in out.post_storage.items():
        ha = key_hash(a)
        stg = st.storage_trie(ha)
        try:
            for slot, val in slots.items():
                hs = key_hash(slot)
                if val == 0:
                    stg.delete(hs)
                else:
                    stg.update(hs, rlp_encode(encode_int(val)))
        except BlindedNodeError as e:
            e.owner = ha  # which storage trie needs the reveal
            raise
        touched_storage.append((a, stg))
    for a in out.changes.wiped_storage:
        if a not in out.post_storage:
            touched_storage.append((a, st.storage_tries[key_hash(a)]))
    # phase 2: storage roots — packed across tries, or per-trie serial
    storage_roots: dict[bytes, bytes] = {}
    if committer is not None:
        roots = committer.commit([t for _, t in touched_storage], hasher)
        storage_roots.update(
            (a, r) for (a, _t), r in zip(touched_storage, roots))
    else:
        for a, stg in touched_storage:
            storage_roots[a] = stg.root_hash_compute(hasher)
    if storage_roots_out is not None:
        storage_roots_out.update(storage_roots)
    # account writes: compose leaves with the recomputed storage roots
    touched = set(out.post_accounts) | set(storage_roots)
    for a in sorted(touched):
        ha = key_hash(a)
        if a in out.post_accounts:
            acct = out.post_accounts[a]
            if acct is None:
                st.remove_account(ha)
                continue
        else:  # storage-only change: account fields come from the parent leaf
            leaf = st.account_trie.get(ha)
            if leaf is None:
                continue  # storage of a deleted account
            acct = _decode_account_leaf(leaf)
        sroot = storage_roots.get(a)
        if sroot is None:
            prior = st.account_trie.get(ha)
            sroot = (_decode_account_leaf(prior).storage_root
                     if prior is not None else Account().storage_root)
        st.update_account(ha, replace(acct, storage_root=sroot).trie_encode())
    if committer is not None:
        return committer.commit([st.account_trie], hasher)[0]
    return st.account_trie.root_hash_compute(hasher)


class StatelessChain:
    """Validate consecutive blocks statelessly, preserving the sparse trie
    across blocks (reference PreservedSparseTrie semantics). Without a
    ``hasher`` every digest is taken on ``device``: the witness batch on a
    ``KeccakDevice`` (kernel 1), the finish through a
    ``ParallelSparseCommitter``; ``last_stats`` holds the last block's walls
    (reveal, execution, root) and counts."""

    def __init__(self, config=None, hasher=None, device: str | torch.device = "cuda"):
        self.config = config
        self.device = device
        if hasher is None:
            from ..ops.keccak import KeccakDevice

            self.hasher = KeccakDevice(min_tier=1024, block_tier=4, device=device).hash_batch
            self.committer = ParallelSparseCommitter(device=device)
        else:
            self.hasher = hasher
            self.committer = None
        self.preserved = PreservedSparseTrie()
        # the last validated block's BlockExecutionOutput: the replica
        # role serves receipts/logs from it (stateless re-execution
        # yields the receipts the full node committed — the root check
        # proves the whole output agrees)
        self.last_output = None
        self.last_stats: dict | None = None

    def validate(self, block: Block, witness, parent_header: Header) -> bytes:
        """Re-execute ``block`` purely from ``witness``; returns the
        computed state root or raises StatelessValidationError."""
        if block.header.parent_hash != parent_header.hash:
            raise StatelessValidationError("witness parent mismatch")
        t0 = time.perf_counter()
        with tracing.span("engine::stateless", "stateless.reveal",
                          nodes=len(witness.state)):
            st = self.preserved.take(block.header.parent_hash)
            if st is None:
                st = SparseStateTrie.anchored(parent_header.state_root)
            # the witness's nodes, key preimages and codes in one batch
            nodes = list(witness.state)
            keys = list(dict.fromkeys(list(witness.keys) + list(witness.codes)))
            digests = self.hasher(nodes + keys) if nodes or keys else []
            by_hash = dict(zip(digests[:len(nodes)], nodes))
            key_digests = dict(zip(keys, digests[len(nodes):]))
            st.reveal_account(nodes, by_hash)
        src = WitnessStateSource(st, nodes, witness.codes, by_hash, key_digests)
        t1 = time.perf_counter()
        # BLOCKHASH map from witness.headers — but only headers provably in
        # the ancestor chain: walk parent_hash links down from parent_header
        # and reject anything unlinked (a malicious witness could otherwise
        # inject arbitrary (number, hash) pairs; reference stateless crate
        # verifies the same linkage)
        hashes = {parent_header.number: parent_header.hash}
        by_number: dict[int, Header] = {}
        for raw in witness.headers:
            h = Header.decode(raw)
            if h.number == parent_header.number:
                if h.hash != parent_header.hash:
                    raise StatelessValidationError(
                        "witness header forks from parent")
                continue
            if h.number in by_number and by_number[h.number].hash != h.hash:
                raise StatelessValidationError(
                    f"conflicting witness headers at {h.number}")
            by_number[h.number] = h
        expected = parent_header
        n = parent_header.number - 1
        while n in by_number:
            h = by_number.pop(n)
            if h.hash != expected.parent_hash:
                raise StatelessValidationError(
                    f"witness header {n} not hash-linked to parent chain")
            hashes[n] = h.hash
            expected = h
            n -= 1
        if by_number:
            raise StatelessValidationError(
                f"witness headers not in ancestor chain: {sorted(by_number)}")
        executor = BlockExecutor(src, self.config)
        t2 = t1
        try:
            with tracing.span("engine::stateless", "stateless.execute",
                              txs=len(block.transactions)):
                senders = recover_senders(block.transactions)
                if None in senders:  # the reference's error for the bad one
                    senders = [tx.recover_sender() for tx in block.transactions]
                out = executor.execute(block, senders, hashes)
            t2 = time.perf_counter()
            with tracing.span("engine::stateless", "stateless.root"):
                if self.committer is not None:
                    root = apply_output_to_trie(st, out, None, committer=self.committer,
                                                digests=key_digests)
                else:
                    root = apply_output_to_trie(st, out, self.hasher, digests=key_digests)
        except BlindedNodeError as e:
            raise StatelessValidationError(
                f"witness incomplete: blinded path {e.path.hex()}") from e
        t3 = time.perf_counter()
        self.last_stats = {"reveal_s": t1 - t0, "execute_s": t2 - t1, "root_s": t3 - t2,
                           "nodes": len(nodes), "keys": len(keys)}
        if root != block.header.state_root:
            raise StatelessValidationError(
                f"stateless root mismatch: computed {root.hex()} header "
                f"{block.header.state_root.hex()}")
        if out.gas_used != block.header.gas_used:
            raise StatelessValidationError("gas used mismatch")
        self.preserved.preserve(block.header.hash, st)
        self.last_output = out
        return root
