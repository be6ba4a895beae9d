"""History index stages: changesets → per-account/slot block-number shards.

A copy of the JAX package's ``stages/index_history.py``.

Reference analogue: `IndexAccountHistoryStage` / `IndexStorageHistoryStage`
(crates/stages/stages/src/stages/index_{account,storage}_history.rs) and
the sharded history tables (AccountsHistory/StoragesHistory). A shard's
key is ``addr [+ slot] + be64(highest block in shard)`` (the open tail
shard uses u64::MAX), its value the ascending be64 block numbers where
the key changed — enabling O(log n) "first change after block N" lookups
for historical state.
"""

from __future__ import annotations

from ..storage.provider import DatabaseProvider
from ..storage.tables import Tables, be64, from_be64
from .api import ExecInput, ExecOutput, Stage, UnwindInput

SHARD_CAP = 1000
TAIL = be64((1 << 64) - 1)


def _append_to_shards(provider: DatabaseProvider, table: str, prefix: bytes,
                      blocks: list[int]) -> None:
    """Append ascending ``blocks`` to the key's tail shard, splitting at cap."""
    tx = provider.tx
    tail_key = prefix + TAIL
    existing = tx.get(table, tail_key) or b""
    merged = existing + b"".join(be64(b) for b in blocks)
    while len(merged) // 8 > SHARD_CAP:
        full, merged = merged[: SHARD_CAP * 8], merged[SHARD_CAP * 8 :]
        highest = full[-8:]
        tx.put(table, prefix + highest, full)
    tx.put(table, tail_key, merged)


def _unwind_shards(provider: DatabaseProvider, table: str, prefix: bytes,
                   keep_below: int) -> None:
    """Drop indexed blocks >= ``keep_below`` for one key."""
    tx = provider.tx
    cur = tx.cursor(table)
    doomed = []
    keep: bytes = b""
    for k, v in cur.walk(prefix):
        if k[: len(prefix)] != prefix:
            break
        kept = b"".join(
            v[i : i + 8] for i in range(0, len(v), 8)
            if from_be64(v[i : i + 8]) < keep_below
        )
        doomed.append(k)
        keep += kept
    for k in doomed:
        tx.delete(table, k)
    if keep:
        _append_to_shards(provider, table, prefix, [
            from_be64(keep[i : i + 8]) for i in range(0, len(keep), 8)
        ])


class IndexAccountHistoryStage(Stage):
    id = "IndexAccountHistory"

    def execute(self, provider: DatabaseProvider, inp: ExecInput) -> ExecOutput:
        per_addr: dict[bytes, list[int]] = {}
        cur = provider.tx.cursor(Tables.AccountChangeSets.name)
        for key, dup in cur.walk_range(be64(inp.next_block), be64(inp.target + 1)):
            block = from_be64(key[:8])
            per_addr.setdefault(dup[:20], []).append(block)
        for addr, blocks in per_addr.items():
            _append_to_shards(provider, Tables.AccountsHistory.name, addr, sorted(set(blocks)))
        return ExecOutput(checkpoint=inp.target)

    def unwind(self, provider: DatabaseProvider, inp: UnwindInput) -> None:
        changed = provider.account_changes_in_range(inp.unwind_to + 1, inp.checkpoint)
        for addr in changed:
            _unwind_shards(provider, Tables.AccountsHistory.name, addr, inp.unwind_to + 1)


class IndexStorageHistoryStage(Stage):
    id = "IndexStorageHistory"

    def execute(self, provider: DatabaseProvider, inp: ExecInput) -> ExecOutput:
        per_key: dict[bytes, list[int]] = {}
        cur = provider.tx.cursor(Tables.StorageChangeSets.name)
        for key, dup in cur.walk_range(be64(inp.next_block), be64(inp.target + 1)):
            block = from_be64(key[:8])
            addr = key[8:28]
            slot = dup[:32]
            per_key.setdefault(addr + slot, []).append(block)
        for prefix, blocks in per_key.items():
            _append_to_shards(provider, Tables.StoragesHistory.name, prefix, sorted(set(blocks)))
        return ExecOutput(checkpoint=inp.target)

    def unwind(self, provider: DatabaseProvider, inp: UnwindInput) -> None:
        changed = provider.storage_changes_in_range(inp.unwind_to + 1, inp.checkpoint)
        for addr, slots in changed.items():
            for slot in slots:
                _unwind_shards(provider, Tables.StoragesHistory.name, addr + slot,
                               inp.unwind_to + 1)


def first_change_after(provider: DatabaseProvider, table: str, prefix: bytes,
                       block: int) -> int | None:
    """Smallest indexed block > ``block`` for the key, or None."""
    cur = provider.tx.cursor(table)
    entry = cur.seek(prefix + be64(block + 1))
    while entry is not None:
        k, v = entry
        if k[: len(prefix)] != prefix:
            return None
        for i in range(0, len(v), 8):
            b = from_be64(v[i : i + 8])
            if b > block:
                return b
        entry = cur.next()
    return None
