"""Account/Storage hashing stages: plain state → hashed tables.

A copy of the JAX package's ``stages/hashing.py``. With no committer a stage
builds ``TrieCommitter(device=device)``, so its keccak batches run on kernel
1 through ``KeccakDevice`` on the card unless the caller passes
``device="cpu"``; each scan chunk of ``_SCAN_CHUNK`` keys is one
``KeccakDevice`` batch. Reference analogue: `AccountHashingStage`
(keccak256(address), rayon chunks + ETL —
crates/stages/stages/src/stages/hashing_account.rs:37) and
`StorageHashingStage` (hashing_storage.rs:133-137).

Clean path (first sync): scan the plain table in bounded chunks, batch-
hash each, collect through the ETL external-sort collector (``etl.py`` —
memory stays bounded for >RAM inputs) and bulk-load the hashed table
in sorted order. Incremental path: only keys in the range's changesets.
"""

from __future__ import annotations

import torch

from ..etl import Collector
from ..storage.provider import DatabaseProvider
from ..storage.tables import Tables, decode_storage_entry
from ..trie.committer import TrieCommitter
from .api import ExecInput, ExecOutput, Stage, UnwindInput

_SCAN_CHUNK = 200_000  # keys hashed per device dispatch during clean scans


class AccountHashingStage(Stage):
    id = "AccountHashing"

    def __init__(self, committer: TrieCommitter | None = None, clean_threshold: int = 100_000,
                 device: str | torch.device = "cuda"):
        committer = committer or TrieCommitter(device=device)
        # hashing-stage scans are rebuild work: with --hash-service their
        # chunk batches ride the rebuild lane (identity without a service)
        if hasattr(committer, "for_lane"):
            committer = committer.for_lane("rebuild")
        self.hasher = committer.hasher
        self.clean_threshold = clean_threshold

    def execute(self, provider: DatabaseProvider, inp: ExecInput) -> ExecOutput:
        if inp.checkpoint == 0 or inp.target - inp.checkpoint > self.clean_threshold:
            # clean rebuild: chunked scan -> batch hash -> ETL -> sorted load
            provider.tx.clear(Tables.HashedAccounts.name)
            with Collector() as col:
                batch: list[tuple[bytes, bytes]] = []

                def flush():
                    hashed = self.hasher([k for k, _ in batch])
                    for (_, value), haddr in zip(batch, hashed):
                        col.insert(haddr, value)
                    batch.clear()

                for entry in provider.tx.cursor(Tables.PlainAccountState.name).walk():
                    batch.append(entry)
                    if len(batch) >= _SCAN_CHUNK:
                        flush()
                if batch:
                    flush()
                for haddr, value in col:
                    provider.tx.put(Tables.HashedAccounts.name, haddr, value)
        else:
            changed = provider.account_changes_in_range(inp.next_block, inp.target)
            addrs = sorted(changed.keys())
            hashed = self.hasher(addrs)
            for addr, haddr in zip(addrs, hashed):
                acc = provider.account(addr)
                provider.put_hashed_account(haddr, acc)
        return ExecOutput(checkpoint=inp.target)

    def unwind(self, provider: DatabaseProvider, inp: UnwindInput) -> None:
        # Restore hashed accounts from changeset PREV-IMAGES directly: plain
        # state is unwound later (ExecutionStage is after us in unwind order).
        changed = provider.account_changes_in_range(inp.unwind_to + 1, inp.checkpoint)
        addrs = sorted(changed.keys())
        hashed = self.hasher(addrs)
        for addr, haddr in zip(addrs, hashed):
            provider.put_hashed_account(haddr, changed[addr])


class StorageHashingStage(Stage):
    id = "StorageHashing"

    def __init__(self, committer: TrieCommitter | None = None, clean_threshold: int = 100_000,
                 device: str | torch.device = "cuda"):
        committer = committer or TrieCommitter(device=device)
        # hashing-stage scans are rebuild work: with --hash-service their
        # chunk batches ride the rebuild lane (identity without a service)
        if hasattr(committer, "for_lane"):
            committer = committer.for_lane("rebuild")
        self.hasher = committer.hasher
        self.clean_threshold = clean_threshold

    def execute(self, provider: DatabaseProvider, inp: ExecInput) -> ExecOutput:
        if inp.checkpoint == 0 or inp.target - inp.checkpoint > self.clean_threshold:
            provider.tx.clear(Tables.HashedStorages.name)
            with Collector() as col:
                batch: list[tuple[bytes, bytes, int]] = []  # (addr, slot, value)

                def flush():
                    n = len(batch)
                    digests = self.hasher(
                        [a for a, _, _ in batch] + [s for _, s, _ in batch]
                    )
                    for (_, _, value), haddr, hslot in zip(batch, digests[:n], digests[n:]):
                        col.insert(haddr + hslot, value.to_bytes(32, "big"))
                    batch.clear()

                for addr, dup in provider.tx.cursor(Tables.PlainStorageState.name).walk():
                    slot, value = decode_storage_entry(dup)
                    batch.append((addr, slot, value))
                    if len(batch) >= _SCAN_CHUNK:
                        flush()
                if batch:
                    flush()
                for key, value32 in col:
                    provider.put_hashed_storage(
                        key[:32], key[32:], int.from_bytes(value32, "big")
                    )
        else:
            changed = provider.storage_changes_in_range(inp.next_block, inp.target)
            self._apply_changed(provider, changed, use_prev_images=False)
        return ExecOutput(checkpoint=inp.target)

    def _apply_changed(self, provider: DatabaseProvider, changed, use_prev_images: bool) -> None:
        pairs: list[tuple[bytes, bytes]] = [
            (addr, slot) for addr, slots in changed.items() for slot in slots
        ]
        addrs = sorted({a for a, _ in pairs})
        digests = self.hasher(addrs + [s for _, s in pairs])
        haddr_of = dict(zip(addrs, digests[: len(addrs)]))
        for (addr, slot), hslot in zip(pairs, digests[len(addrs) :]):
            value = changed[addr][slot] if use_prev_images else provider.storage(addr, slot)
            provider.put_hashed_storage(haddr_of[addr], hslot, value)

    def unwind(self, provider: DatabaseProvider, inp: UnwindInput) -> None:
        # prev-images ARE the post-unwind values (plain state unwinds later)
        changed = provider.storage_changes_in_range(inp.unwind_to + 1, inp.checkpoint)
        self._apply_changed(provider, changed, use_prev_images=True)
