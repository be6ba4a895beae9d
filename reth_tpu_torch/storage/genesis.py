"""Genesis initialisation + RLP chain-file import.

A copy of the JAX package's ``storage/genesis.py``.

Reference analogue: `init_genesis` (crates/storage/db-common/src/init.rs)
and the `reth import` file client
(crates/net/downloaders/src/file_client.rs). Writes the genesis header,
plain state, hashed state (batched keccak), trie tables, and zeroed
stage checkpoints; import inserts headers+bodies for the pipeline.
"""

from __future__ import annotations

import torch

from ..primitives.types import Account, Block, Header
from ..trie.committer import TrieCommitter
from ..trie.incremental import full_state_root
from .provider import ProviderFactory
from .tables import Tables


class GenesisMismatch(Exception):
    pass


def init_genesis(
    factory: ProviderFactory,
    genesis_header: Header,
    alloc: dict[bytes, Account],
    storage: dict[bytes, dict[bytes, int]] | None = None,
    codes: dict[bytes, bytes] | None = None,
    committer: TrieCommitter | None = None,
    device: str | torch.device = "cuda",
) -> bytes:
    """Initialise the database from genesis; returns the genesis hash. The
    key hashing and the genesis root run on ``committer``, else on
    ``TrieCommitter(device=device)``."""
    committer = committer or TrieCommitter(device=device)
    storage = storage or {}
    base = genesis_header.number  # >0 for init-state (sync-from-state) inits
    with factory.provider_rw() as p:
        existing = p.canonical_hash(base)
        if existing is not None:
            if existing != genesis_header.hash:
                raise GenesisMismatch(
                    f"database initialised with different genesis {existing.hex()}"
                )
            return existing
        # plain state
        for addr, acc in alloc.items():
            p.put_account(addr, acc)
        for addr, slots in storage.items():
            for slot, val in slots.items():
                p.put_storage(addr, slot, val)
        for code_hash, code in (codes or {}).items():
            p.put_bytecode(code_hash, code)
        # hashed state: one batched dispatch for all keys
        addrs = list(alloc.keys())
        slot_jobs = [(a, s) for a, slots in storage.items() for s in slots]
        digests = committer.hasher(addrs + [s for _, s in slot_jobs])
        haddr = dict(zip(addrs, digests[: len(addrs)]))
        for addr, acc in alloc.items():
            p.put_hashed_account(haddr[addr], acc)
        for (addr, slot), hslot in zip(slot_jobs, digests[len(addrs) :]):
            p.put_hashed_storage(haddr[addr], hslot, storage[addr][slot])
        # trie + root check
        root = full_state_root(p, committer)
        if root != genesis_header.state_root:
            raise GenesisMismatch(
                f"computed genesis state root {root.hex()} != header "
                f"{genesis_header.state_root.hex()}"
            )
        p.insert_header(genesis_header)
        p.tx.put(Tables.BlockBodyIndices.name, base.to_bytes(8, "big"),
                 (0).to_bytes(8, "big") * 2)
        if base > 0:
            # init-state: the chain below `base` has no data — every stage
            # starts AT the state block (reference `reth init-state`)
            for stage in ("Headers", "Bodies", "SenderRecovery", "Execution",
                          "AccountHashing", "StorageHashing", "MerkleExecute",
                          "TransactionLookup", "IndexAccountHistory",
                          "IndexStorageHistory", "Finish"):
                p.save_stage_checkpoint(stage, base)
        return genesis_header.hash


def import_chain(factory: ProviderFactory, blocks: list[Block], consensus=None) -> int:
    """Insert pre-validated headers+bodies (the `reth import` path).

    Headers are validated against their parents when ``consensus`` is
    given. Returns the new tip height. The pipeline does the rest.
    """
    with factory.provider_rw() as p:
        tip = p.last_block_number()
        for block in blocks:
            header = block.header
            if header.number != tip + 1:
                raise ValueError(f"non-contiguous import at block {header.number}")
            if consensus is not None:
                parent = p.header_by_number(tip)
                consensus.validate_header_against_parent(header, parent)
                consensus.validate_block_pre_execution(block)
            p.insert_header(header)
            p.insert_block_body(block)
            tip = header.number
        return tip
