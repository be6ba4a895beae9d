"""A block's state delta applied to a proof-revealed sparse trie.

A copy of the JAX package's ``engine/stateless.py`` ``apply_output_to_trie``
and what it needs: the sparse-trie state-root strategy's update → rehash
step (the reference's `sparse_trie.rs:126-259`), which the live tip
(``engine/sparse_root.py``) finishes every block with. Stateless
validation (``WitnessStateSource``, ``StatelessChain``) re-executes the
block on the port's EVM from a witness; it is not ported yet (ROADMAP A
item 7, the next slice's item 1): both raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import replace

from ..primitives.keccak import keccak256, keccak256_batch_np
from ..primitives.rlp import decode_int, encode_int, rlp_decode, rlp_encode
from ..primitives.types import Account
from ..trie.sparse import BlindedNodeError, SparseStateTrie, SparseTrie

_NO_EVM = ("stateless validation (a witness state source for the EVM) is not ported yet "
           "(ROADMAP A item 7: the next slice's item 1)")


class StatelessValidationError(Exception):
    pass


def _decode_account_leaf(leaf: bytes) -> Account:
    nonce, balance, storage_root, code_hash = rlp_decode(leaf)
    return Account(nonce=decode_int(nonce), balance=decode_int(balance),
                   storage_root=storage_root, code_hash=code_hash)


class WitnessStateSource:
    """EVM state source answering every read from a witness-revealed
    sparse trie: needs the EVM's state interface."""

    def __init__(self, trie: SparseStateTrie, witness_nodes: list[bytes],
                 codes: list[bytes]):
        raise NotImplementedError(_NO_EVM)


def apply_output_to_trie(st: SparseStateTrie, out,
                         hasher=keccak256_batch_np,
                         storage_roots_out: dict | None = None,
                         committer=None, digests: dict | None = None) -> bytes:
    """Apply a BlockExecutionOutput's state delta to the sparse state trie
    and return the recomputed root. Raises BlindedNodeError when an edit
    needs an unrevealed path (a storage trie's carries its ``owner``).
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
    """Validate consecutive blocks statelessly over a preserved sparse trie:
    re-executes each block, so it needs the EVM."""

    def __init__(self, config=None, hasher=keccak256_batch_np):
        raise NotImplementedError(_NO_EVM)
