"""The transaction pool.

A copy of the JAX package's ``pool/pool.py``: every admission result, error
message, ordering, discard and event is the reference's.

Subpool model (reference src/pool/mod.rs state machine):

- **pending**: executable now — contiguous nonces from the account's
  on-chain nonce, fee cap >= current base fee.
- **basefee**: nonce-contiguous but priced below the current base fee;
  promoted when the base fee falls.
- **queued**: nonce gap; promoted when the gap fills.

``best_transactions`` yields pending txs ordered by effective tip (then
insertion order), never yielding a later nonce before an earlier one per
sender. ``on_canonical_state_change`` is the maintenance loop: drops
mined/stale txs and re-buckets everything against the new state.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

from ..primitives.types import Transaction

MIN_PRICE_BUMP_PERCENT = 10  # replacement bump (reference: 10%)


class PoolError(Exception):
    pass


@dataclass
class PoolConfig:
    max_account_slots: int = 16      # txs per sender
    max_pool_size: int = 10_000
    minimal_protocol_fee: int = 0
    chain_id: int | None = None      # reject foreign-chain txs at admission


@dataclass
class PooledTx:
    tx: Transaction
    sender: bytes
    submission_id: int
    cost: int  # max gas cost + value

    @property
    def nonce(self) -> int:
        return self.tx.nonce

    def effective_tip(self, base_fee: int) -> int:
        if self.tx.tx_type >= 2:
            if self.tx.max_fee_per_gas < base_fee:
                return -1
            return min(self.tx.max_priority_fee_per_gas,
                       self.tx.max_fee_per_gas - base_fee)
        return self.tx.gas_price - base_fee

    def max_fee(self) -> int:
        return self.tx.max_fee_per_gas if self.tx.tx_type >= 2 else self.tx.gas_price


class TransactionPool:
    """State-aware pool over a read-provider factory."""

    def __init__(self, state_reader, config: PoolConfig | None = None,
                 blob_store=None):
        """``state_reader()`` → object with .account(addr) and the current
        base fee via ``state_reader.base_fee`` callable/attribute."""
        from .blobstore import InMemoryBlobStore

        self.state_reader = state_reader
        self.config = config or PoolConfig()
        self.by_sender: dict[bytes, dict[int, PooledTx]] = {}
        self.by_hash: dict[bytes, PooledTx] = {}
        self._submission_counter = itertools.count()
        self.base_fee: int = 0
        self.blob_base_fee: int = 1
        self.blob_store = blob_store if blob_store is not None else InMemoryBlobStore()
        # mined blob sidecars are RETAINED for a while (reorg re-broadcast +
        # engine_getBlobs after canonicalization; reference keeps them until
        # finalization) — bounded FIFO
        self._mined_sidecars: list[bytes] = []
        self.mined_sidecar_retention = 128
        # set on every successful insert / canonical update; consumers
        # (instant-seal dev miner, payload jobs) wait on this instead of
        # polling executability (which costs a state read per sender)
        import threading

        self.updated = threading.Event()
        # one lock serializes mutation: RPC threads, the insertion batcher
        # worker, and canonical-update maintenance all touch the indexes
        # (reference: the pool lives behind a RwLock)
        self._lock = threading.RLock()
        # pool-event plane (reference: TransactionPool's event listeners,
        # src/pool/events.rs): every admission/replacement/drop/canon
        # update is published to registered sinks under the pool lock with
        # a monotonic sequence number. The continuous block producer keys
        # its incremental refreshes off ``event_seq``; the fleet feed
        # ships the same events as ``pt_*`` records so replicas hold a
        # pending view. Listeners must be fast and non-blocking.
        self.listeners: list = []
        self.event_seq: int = 0

    # -- events ----------------------------------------------------------------

    def add_listener(self, fn) -> None:
        """Register a pool-event sink: ``fn(event_dict)`` called under the
        pool lock for add/replace/drop/canon events."""
        with self._lock:
            self.listeners.append(fn)

    def remove_listener(self, fn) -> None:
        with self._lock:
            if fn in self.listeners:
                self.listeners.remove(fn)

    def _emit(self, kind: str, **fields) -> None:
        """Publish one pool event (lock held by every caller)."""
        self.event_seq += 1
        try:
            from ..metrics import pool_metrics

            pool_metrics.on_event(kind, fields.get("reason"))
        except Exception:  # noqa: BLE001 — metrics never block admission
            pass
        if not self.listeners:
            return
        ev = {"seq": self.event_seq, "kind": kind}
        ev.update(fields)
        for fn in list(self.listeners):
            try:
                fn(ev)
            except Exception:  # noqa: BLE001 — a broken sink must not
                pass           # poison admission for everyone

    # -- submission -----------------------------------------------------------

    def add_blob_transaction(self, tx: Transaction, sidecar) -> bytes:
        """Admit a type-3 tx WITH its sidecar: versioned hashes must bind
        the commitments and every KZG blob proof must verify (reference
        EthTransactionValidator + blobstore insert)."""
        from .blobstore import BlobStoreError

        if tx.tx_type != 3:
            raise PoolError("not a blob transaction")
        try:
            sidecar.validate(tx.blob_versioned_hashes)
        except BlobStoreError as e:
            raise PoolError(f"invalid blob sidecar: {e}")
        h = self.add_transaction(tx, _with_sidecar=True)
        self.blob_store.insert(h, sidecar)
        return h

    def add_transaction(self, tx: Transaction, _with_sidecar: bool = False,
                        sender: bytes | None = None) -> bytes:
        """Validate + insert; returns the tx hash. Raises PoolError.
        ``sender`` skips in-line recovery when the caller already recovered
        it (the insertion batcher's native batched secp dispatch)."""
        with self._lock:
            return self._add_locked(tx, _with_sidecar, sender)

    def _add_locked(self, tx: Transaction, _with_sidecar: bool,
                    sender: bytes | None) -> bytes:
        h = tx.hash
        if h in self.by_hash:
            raise PoolError("already known")
        if tx.tx_type == 3:
            if not _with_sidecar:
                raise PoolError("blob tx requires a sidecar (add_blob_transaction)")
            if not tx.blob_versioned_hashes:
                raise PoolError("blob tx without blobs")
            if tx.max_fee_per_blob_gas < self.blob_base_fee:
                raise PoolError("max blob fee below current blob base fee")
        # wrong-chain txs can never execute here — reject at admission
        # (reference EthTransactionValidator chain-id check); legacy
        # pre-EIP-155 txs carry no chain id and pass
        if (self.config.chain_id is not None and tx.chain_id is not None
                and tx.chain_id != self.config.chain_id):
            raise PoolError(
                f"wrong chain id {tx.chain_id} (expected {self.config.chain_id})")
        if sender is None:
            try:
                sender = tx.recover_sender()
            except ValueError as e:
                raise PoolError(f"invalid signature: {e}")
        if tx.tx_type >= 2 and tx.max_priority_fee_per_gas > tx.max_fee_per_gas:
            raise PoolError("priority fee exceeds max fee")
        # operator price floor (miner_setGasPrice): tip for 1559 txs,
        # gas price for legacy
        floor = self.config.minimal_protocol_fee
        if floor:
            offered = (tx.max_priority_fee_per_gas if tx.tx_type >= 2
                       else tx.gas_price)
            if offered < floor:
                raise PoolError("transaction underpriced (below pool floor)")
        if tx.gas_limit > 30_000_000:
            raise PoolError("gas limit too high")
        state = self.state_reader()
        acct = state.account(sender)
        nonce_on_chain = acct.nonce if acct else 0
        balance = acct.balance if acct else 0
        if tx.nonce < nonce_on_chain:
            raise PoolError("nonce too low")
        cost = tx.gas_limit * (tx.max_fee_per_gas if tx.tx_type >= 2 else tx.gas_price) + tx.value
        cost += tx.blob_gas() * tx.max_fee_per_blob_gas  # type-3 blob budget
        if cost > balance:
            raise PoolError("insufficient funds")
        sender_txs = self.by_sender.setdefault(sender, {})
        existing = sender_txs.get(tx.nonce)
        replaced_hash: bytes | None = None
        if existing is not None:
            bump = existing.max_fee() * (100 + MIN_PRICE_BUMP_PERCENT) // 100
            if self._fee_of(tx) < bump:
                raise PoolError("replacement underpriced")
            replaced_hash = existing.tx.hash
            self._drop(existing.tx.hash)
        if len(sender_txs) >= self.config.max_account_slots and existing is None:
            raise PoolError("sender slot limit")
        if len(self.by_hash) >= self.config.max_pool_size:
            # saturated: evict the worst-paying tx (and its descendants)
            # for a better one, else reject as underpriced (reference
            # discard_worst, pool/txpool.rs:1232)
            if tx.tx_type >= 2:
                tip = min(tx.max_priority_fee_per_gas,
                          max(0, tx.max_fee_per_gas - self.base_fee))
            else:
                tip = tx.gas_price - self.base_fee
            self._discard_worst(tip)
            # the discard may have evicted THIS sender's worst tx and
            # dropped its by_sender entry — re-anchor, or the insert below
            # would write into an orphaned dict invisible to the pool
            sender_txs = self.by_sender.setdefault(sender, {})
        ptx = PooledTx(tx, sender, next(self._submission_counter), cost)
        sender_txs[tx.nonce] = ptx
        self.by_hash[h] = ptx
        if replaced_hash is not None:
            self._emit("replace", tx=tx, sender=sender, old_hash=replaced_hash)
        else:
            self._emit("add", tx=tx, sender=sender)
        self.updated.set()
        return h

    def _discard_worst(self, incoming_tip: int) -> None:
        """Make room in a full pool: drop the lowest-priority tx plus its
        same-sender descendants (their nonces gap without it); raise when
        the incoming tx does not pay more than the current worst."""
        worst = min(self.by_hash.values(),
                    key=lambda p: (p.effective_tip(self.base_fee),
                                   -p.submission_id))
        if worst.effective_tip(self.base_fee) >= incoming_tip:
            raise PoolError("pool full: transaction underpriced")
        txs = self.by_sender.get(worst.sender, {})
        for n in sorted(n for n in txs if n >= worst.nonce):
            dropped = txs[n].tx.hash
            self._drop(dropped)
            del txs[n]
            self._emit("drop", hash=dropped, sender=worst.sender,
                       reason="evicted")
        if not txs:
            self.by_sender.pop(worst.sender, None)

    def _fee_of(self, tx: Transaction) -> int:
        return tx.max_fee_per_gas if tx.tx_type >= 2 else tx.gas_price

    def _drop(self, tx_hash: bytes, mined: bool = False) -> None:
        self.by_hash.pop(tx_hash, None)
        if mined and self.blob_store.get(tx_hash) is not None:
            # keep the sidecar until the retention window evicts it
            self._mined_sidecars.append(tx_hash)
            while len(self._mined_sidecars) > self.mined_sidecar_retention:
                self.blob_store.delete(self._mined_sidecars.pop(0))
            return
        self.blob_store.delete(tx_hash)

    def remove_invalid(self, tx_hash: bytes) -> None:
        """Evict a tx the payload builder proved unexecutable (reference
        BestTransactions::mark_invalid feeding pool removal) — without this
        an instant-seal dev miner spins forever on a 'best' tx that every
        build skips."""
        with self._lock:
            self._remove_invalid_locked(tx_hash)

    def _remove_invalid_locked(self, tx_hash: bytes) -> None:
        ptx = self.by_hash.get(tx_hash)
        if ptx is None:
            return
        self._drop(tx_hash)
        txs = self.by_sender.get(ptx.sender)
        if txs is not None:
            txs.pop(ptx.nonce, None)
            if not txs:
                del self.by_sender[ptx.sender]
        self._emit("drop", hash=tx_hash, sender=ptx.sender, reason="invalid")

    def get_blob_sidecar(self, tx_hash: bytes):
        return self.blob_store.get(tx_hash)

    # -- queries ---------------------------------------------------------------

    def get(self, tx_hash: bytes) -> Transaction | None:
        ptx = self.by_hash.get(tx_hash)
        return ptx.tx if ptx else None

    def contains(self, tx_hash: bytes) -> bool:
        return tx_hash in self.by_hash

    def __len__(self) -> int:
        return len(self.by_hash)

    def pooled_nonce(self, sender: bytes) -> int | None:
        """Highest contiguous pooled nonce + 1 for a sender (for RPC
        'pending' transaction count)."""
        state = self.state_reader()
        acct = state.account(sender)
        nonce = acct.nonce if acct else 0
        txs = self.by_sender.get(sender, {})
        while nonce in txs:
            nonce += 1
        return nonce

    def _bucket(self, ptx: PooledTx, nonce_on_chain: int, pending_gap: bool) -> str:
        if pending_gap:
            return "queued"
        if ptx.effective_tip(self.base_fee) < 0:
            return "basefee"
        return "pending"

    def content(self) -> dict[str, dict[bytes, dict[int, Transaction]]]:
        """txpool_content-shaped view: {pending|queued: {sender: {nonce: tx}}}."""
        out = {"pending": {}, "queued": {}}
        state = self.state_reader()
        for sender, txs in self.by_sender.items():
            acct = state.account(sender)
            next_nonce = acct.nonce if acct else 0
            for nonce in sorted(txs):
                ptx = txs[nonce]
                gap = nonce > next_nonce
                bucket = self._bucket(ptx, next_nonce, gap)
                key = "pending" if bucket == "pending" else "queued"
                out[key].setdefault(sender, {})[nonce] = ptx.tx
                if not gap:
                    next_nonce = nonce + 1
        return out

    # -- best transactions ------------------------------------------------------

    def best_transactions(self, base_fee: int | None = None):
        """Yield executable txs, highest effective tip first, nonce-ordered
        per sender (reference BestTransactions)."""
        base_fee = self.base_fee if base_fee is None else base_fee
        state = self.state_reader()
        heads: dict[bytes, int] = {}  # sender -> next yieldable nonce
        for sender in self.by_sender:
            acct = state.account(sender)
            heads[sender] = acct.nonce if acct else 0
        # heap keyed (-tip, submission_id): O(log n) per yield instead of a
        # full re-sort per transaction (reference BestTransactions keeps the
        # same priority order over its own BTree)
        import heapq

        heap: list[tuple[int, int, PooledTx]] = []
        for sender, txs in self.by_sender.items():
            ptx = txs.get(heads[sender])
            if ptx is not None and self._executable(ptx, base_fee):
                heapq.heappush(
                    heap, (-ptx.effective_tip(base_fee), ptx.submission_id, ptx))
        while heap:
            _, _, best = heapq.heappop(heap)
            yield best.tx
            heads[best.sender] += 1
            # .get twice: a consumer may remove_invalid() mid-iteration
            nxt = self.by_sender.get(best.sender, {}).get(heads[best.sender])
            if nxt is not None and self._executable(nxt, base_fee):
                heapq.heappush(
                    heap, (-nxt.effective_tip(base_fee), nxt.submission_id, nxt))

    def _executable(self, ptx: PooledTx, base_fee: int) -> bool:
        if ptx.effective_tip(base_fee) < 0:
            return False
        # blob subpool gate: blob txs wait until the blob fee market allows
        if ptx.tx.tx_type == 3 and ptx.tx.max_fee_per_blob_gas < self.blob_base_fee:
            return False
        return True

    # -- maintenance -------------------------------------------------------------

    def on_canonical_state_change(self, base_fee: int,
                                  blob_base_fee: int | None = None) -> None:
        """New head: drop mined/underfunded txs, update the fee markets.

        Reference: the maintenance task (src/maintain.rs) driven by
        CanonStateNotifications.
        """
        with self._lock:
            self._on_canon_locked(base_fee, blob_base_fee)

    def _on_canon_locked(self, base_fee: int,
                         blob_base_fee: int | None) -> None:
        self.base_fee = base_fee
        if blob_base_fee is not None:
            self.blob_base_fee = blob_base_fee
        state = self.state_reader()
        for sender in list(self.by_sender):
            acct = state.account(sender)
            nonce = acct.nonce if acct else 0
            balance = acct.balance if acct else 0
            txs = self.by_sender[sender]
            for n in [n for n in txs if n < nonce]:
                mined_hash = txs[n].tx.hash
                self._drop(mined_hash, mined=True)
                del txs[n]
                self._emit("drop", hash=mined_hash, sender=sender,
                           reason="mined")
            for n in [n for n in txs if txs[n].cost > balance]:
                poor_hash = txs[n].tx.hash
                self._drop(poor_hash)
                del txs[n]
                self._emit("drop", hash=poor_hash, sender=sender,
                           reason="underfunded")
            if not txs:
                del self.by_sender[sender]
        # one canon marker even when nothing dropped: the fee market moved,
        # so the producer's candidate ordering may be stale
        self._emit("canon", base_fee=base_fee,
                   blob_base_fee=self.blob_base_fee)
        if self.by_hash:
            self.updated.set()  # remaining txs may have become executable
