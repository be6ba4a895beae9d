"""Historical state provider: state as of any block at or below the tip.

A copy of the JAX package's ``storage/historical.py`` on the port's
provider and history index.

Reference analogue: `HistoricalStateProvider`
(crates/storage/provider/src/providers/state/historical.rs). Two-phase
resolution:

1. **Indexed range** (fast path): the history shards give the first
   changeset block AFTER N; that changeset's pre-image is the value as
   of N (changesets store pre-images).
2. **Unindexed tail** (the engine's in-memory window / not-yet-indexed
   blocks): a bounded changeset range scan — the FIRST-seen pre-image
   per key over (N, tip] is by definition the value at N.

No later change in either phase ⇒ the current plain value stands.
"""

from __future__ import annotations

from ..primitives.types import Account
from ..stages.index_history import first_change_after
from . import tables as T
from .provider import DatabaseProvider
from .tables import Tables, be64


class HistoricalStateProvider:
    """Read-only account/storage/bytecode view at ``block``."""

    def __init__(self, provider: DatabaseProvider, block: int,
                 indexed_to: int | None = None, tip: int | None = None):
        self.provider = provider
        self.block = block
        self.indexed_to = (
            indexed_to if indexed_to is not None
            else provider.stage_checkpoint("IndexAccountHistory")
        )
        self.tip = tip if tip is not None else provider.last_block_number()

    def account(self, address: bytes) -> Account | None:
        p = self.provider
        change = first_change_after(
            p, Tables.AccountsHistory.name, address, self.block
        )
        if change is not None and change <= self.indexed_to:
            cur = p.tx.cursor(Tables.AccountChangeSets.name)
            for _, dup in cur.walk_dup(be64(change), address):
                addr, prev = T.decode_account_changeset(dup)
                if addr == address:
                    return prev
                break
        # unindexed tail: first-seen pre-image over (block, tip]
        start = max(self.block, self.indexed_to) + 1
        if start <= self.tip:
            tail = p.account_changes_in_range(start, self.tip)
            if address in tail:
                return tail[address]
        return p.account(address)

    def storage(self, address: bytes, slot: bytes) -> int:
        p = self.provider
        change = first_change_after(
            p, Tables.StoragesHistory.name, address + slot, self.block
        )
        if change is not None and change <= self.indexed_to:
            cur = p.tx.cursor(Tables.StorageChangeSets.name)
            for _, dup in cur.walk_dup(be64(change) + address, slot):
                eslot, prev = T.decode_storage_entry(dup)
                if eslot == slot:
                    return prev
                break
        start = max(self.block, self.indexed_to) + 1
        if start <= self.tip:
            tail = p.storage_changes_in_range(start, self.tip)
            if address in tail and slot in tail[address]:
                return tail[address][slot]
        return p.storage(address, slot)

    def bytecode(self, code_hash: bytes) -> bytes:
        return self.provider.bytecode(code_hash) or b""
