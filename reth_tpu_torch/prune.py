"""Segment-based pruning of historical data.

A copy of the JAX package's ``prune.py`` on the port's provider.

Reference analogue: crates/prune — `Pruner` with per-segment run limits
(src/pruner.rs, src/segments/) and `PruneModes` config. Segments:
sender recovery, receipts, transaction lookup, account/storage
changesets. Runs after persistence advances; respects a per-run delete
limit so pruning never stalls the node.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .storage.provider import DatabaseProvider, ProviderFactory
from .storage.tables import Tables, be64, from_be64


@dataclass
class PruneMode:
    """How far a segment keeps history: keep everything (None), keep the
    last ``distance`` blocks, or prune everything before ``before``."""

    distance: int | None = None
    before: int | None = None

    def prune_target(self, tip: int) -> int | None:
        """Highest block whose data may be pruned, or None."""
        if self.before is not None:
            return min(self.before - 1, tip)
        if self.distance is not None:
            return tip - self.distance - 1 if tip > self.distance else None
        return None


@dataclass
class PruneModes:
    sender_recovery: PruneMode = field(default_factory=PruneMode)
    receipts: PruneMode = field(default_factory=PruneMode)
    transaction_lookup: PruneMode = field(default_factory=PruneMode)
    account_history: PruneMode = field(default_factory=PruneMode)
    storage_history: PruneMode = field(default_factory=PruneMode)


@dataclass
class PruneProgress:
    segment: str
    pruned: int
    done: bool


class Pruner:
    def __init__(self, factory: ProviderFactory, modes: PruneModes,
                 delete_limit_per_run: int = 10_000):
        self.factory = factory
        self.modes = modes
        self.delete_limit = delete_limit_per_run

    def run(self, tip: int) -> list[PruneProgress]:
        """One pruning pass up to ``tip``; returns per-segment progress."""
        out = []
        with self.factory.provider_rw() as p:
            budget = self.delete_limit
            for name, mode, fn in [
                ("SenderRecovery", self.modes.sender_recovery, self._prune_senders),
                ("Receipts", self.modes.receipts, self._prune_receipts),
                ("TransactionLookup", self.modes.transaction_lookup, self._prune_lookup),
                ("AccountHistory", self.modes.account_history, self._prune_account_history),
                ("StorageHistory", self.modes.storage_history, self._prune_storage_history),
            ]:
                target = mode.prune_target(tip)
                if target is None:
                    continue
                checkpoint = self._checkpoint(p, name)
                if checkpoint > target:
                    continue
                pruned, done, new_cp = fn(p, checkpoint, target, budget)
                budget -= pruned
                p.tx.put(Tables.PruneCheckpoints.name, name.encode(), be64(new_cp))
                out.append(PruneProgress(name, pruned, done))
                if budget <= 0:
                    break
        return out

    def _checkpoint(self, p: DatabaseProvider, segment: str) -> int:
        raw = p.tx.get(Tables.PruneCheckpoints.name, segment.encode())
        return from_be64(raw) if raw else 0

    # each segment prunes tx-number- or block-keyed rows in [checkpoint, target]

    def _tx_range(self, p, start_block, end_block):
        first = p.block_body_indices(start_block)
        last = p.block_body_indices(end_block)
        if first is None or last is None:
            return None
        return first.first_tx_num, last.next_tx_num

    def _prune_tx_keyed(self, p, table, checkpoint, target, budget):
        rng = self._tx_range(p, checkpoint, target)
        if rng is None:
            return 0, True, target + 1
        lo, hi = rng
        cur = p.tx.cursor(table)
        doomed = []
        for k, _ in cur.walk_range(be64(lo), be64(hi)):
            doomed.append(k)
            if len(doomed) >= budget:
                break
        for k in doomed:
            p.tx.delete(table, k)
        done = len(doomed) < budget
        # conservative checkpoint: only advance fully when done
        return len(doomed), done, (target + 1 if done else checkpoint)

    def _prune_senders(self, p, checkpoint, target, budget):
        return self._prune_tx_keyed(p, Tables.TransactionSenders.name, checkpoint, target, budget)

    def _prune_receipts(self, p, checkpoint, target, budget):
        return self._prune_tx_keyed(p, Tables.Receipts.name, checkpoint, target, budget)

    def _prune_lookup(self, p, checkpoint, target, budget):
        # Scan the hash→number index directly: works even when the tx rows
        # themselves were moved to static files or already pruned.
        rng = self._tx_range(p, checkpoint, target)
        if rng is None:
            return 0, True, target + 1
        lo, hi = rng
        cur = p.tx.cursor(Tables.TransactionHashNumbers.name)
        doomed = []
        for h, v in cur.walk():
            if lo <= from_be64(v) < hi:
                doomed.append(h)
                if len(doomed) >= budget:
                    break
        for h in doomed:
            p.tx.delete(Tables.TransactionHashNumbers.name, h)
        done = len(doomed) < budget
        return len(doomed), done, (target + 1 if done else checkpoint)

    def _prune_block_keyed(self, p, table, checkpoint, target, budget):
        cur = p.tx.cursor(table)
        doomed = set()
        for k, _ in cur.walk_range(be64(checkpoint), be64(target + 1)):
            doomed.add(k)
            if len(doomed) >= budget:
                break
        for k in doomed:
            p.tx.delete(table, k)
        done = len(doomed) < budget
        return len(doomed), done, (target + 1 if done else checkpoint)

    def _prune_account_history(self, p, checkpoint, target, budget):
        return self._prune_block_keyed(p, Tables.AccountChangeSets.name, checkpoint, target, budget)

    def _prune_storage_history(self, p, checkpoint, target, budget):
        return self._prune_block_keyed(p, Tables.StorageChangeSets.name, checkpoint, target, budget)
