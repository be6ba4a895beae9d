"""Journaled EVM state with changeset capture.

A copy of the JAX package's ``evm/state.py``.

Reference analogue: revm's `Journal`/`State` + reth's
`StateProviderDatabase` adapter (crates/revm/src/database.rs) and the
changeset output consumed by `ExecutionStage`. Reads fall through to a
state source (the provider's plain state); writes are journaled so call
frames can revert, and per-block previous-images are captured for the
AccountChangeSets/StorageChangeSets tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..primitives.keccak import keccak256
from ..primitives.types import Account, DELEGATION_PREFIX, KECCAK_EMPTY, Log


def resolve_delegation(state, address: bytes) -> tuple[bytes, bytes | None]:
    """Code to EXECUTE for a call to ``address`` (EIP-7702, one level).

    Returns (code, delegate) — ``delegate`` is the designated target whose
    account-access cost the caller must charge, or None when the account's
    code is not a delegation designator. EXTCODE* opcodes must NOT use
    this: they observe the designator itself."""
    code = state.code(address)
    if code[:3] == DELEGATION_PREFIX and len(code) == 23:
        target = code[3:]
        return state.code(target), target
    return code, None


class StateSource:
    """Read interface the EVM pulls cold state through (StateProvider)."""

    def account(self, address: bytes) -> Account | None:
        raise NotImplementedError

    def storage(self, address: bytes, slot: bytes) -> int:
        raise NotImplementedError

    def bytecode(self, code_hash: bytes) -> bytes:
        raise NotImplementedError


@dataclass
class BlockChanges:
    """Previous-images of everything a block touched (changeset rows)."""

    accounts: dict[bytes, Account | None] = field(default_factory=dict)
    storage: dict[bytes, dict[bytes, int]] = field(default_factory=dict)
    wiped_storage: set[bytes] = field(default_factory=set)
    new_bytecodes: dict[bytes, bytes] = field(default_factory=dict)


class EvmState:
    """Mutable world state for one block's execution."""

    def __init__(self, source: StateSource):
        self.source = source
        self._accounts: dict[bytes, Account | None] = {}
        self._storage: dict[bytes, dict[bytes, int]] = {}
        self._code: dict[bytes, bytes] = {}
        self._journal: list[tuple] = []
        self._logs: list[Log] = []
        self.refund: int = 0
        # EIP-2929 warm sets (reset per transaction)
        self.warm_accounts: set[bytes] = set()
        self.warm_slots: set[tuple[bytes, bytes]] = set()
        self._selfdestructs: set[bytes] = set()
        self._created: set[bytes] = set()
        # destruct bookkeeping: accounts marked by SELFDESTRUCT this tx
        # (refund-once tracking) and those scheduled for end-of-tx deletion
        self._destruct_marks: set[bytes] = set()
        self._pending_destructs: set[bytes] = set()
        self._tx_original: dict[tuple[bytes, bytes], int] = {}
        # block-level changeset capture
        self.changes = BlockChanges()
        self._touched: set[bytes] = set()  # EIP-161 touched-empty tracking

    # -- account reads -------------------------------------------------------

    def account(self, address: bytes) -> Account | None:
        if address not in self._accounts:
            self._accounts[address] = self.source.account(address)
        return self._accounts[address]

    def account_or_empty(self, address: bytes) -> Account:
        return self.account(address) or Account()

    def balance(self, address: bytes) -> int:
        return self.account_or_empty(address).balance

    def nonce(self, address: bytes) -> int:
        return self.account_or_empty(address).nonce

    def code(self, address: bytes) -> bytes:
        acc = self.account(address)
        if acc is None or acc.code_hash == KECCAK_EMPTY:
            return b""
        if acc.code_hash not in self._code:
            self._code[acc.code_hash] = self.source.bytecode(acc.code_hash)
        return self._code[acc.code_hash]

    def exists(self, address: bytes) -> bool:
        return self.account(address) is not None

    def is_empty(self, address: bytes) -> bool:
        acc = self.account(address)
        return acc is None or acc.is_empty

    # -- storage -------------------------------------------------------------

    def sload(self, address: bytes, slot: bytes) -> int:
        per = self._storage.setdefault(address, {})
        if slot not in per:
            if address in self._created or address in self._selfdestructs:
                per[slot] = 0
            else:
                per[slot] = self.source.storage(address, slot)
        return per[slot]

    def original_storage(self, address: bytes, slot: bytes) -> int:
        """Value at TRANSACTION start (SSTORE gas/refunds, EIP-2200/3529)."""
        key = (address, slot)
        if key in self._tx_original:
            return self._tx_original[key]
        return self.sload(address, slot)

    def sstore(self, address: bytes, slot: bytes, value: int):
        prev = self.sload(address, slot)
        self._tx_original.setdefault((address, slot), prev)
        self._capture_storage_change(address, slot, prev)
        self._journal.append(("storage", address, slot, prev))
        self._storage[address][slot] = value

    # -- account writes ------------------------------------------------------

    def _capture_account_change(self, address: bytes):
        if address not in self.changes.accounts:
            # previous image = value at block start (source), unless already
            # modified this block — then the first capture already holds it.
            self.changes.accounts[address] = self.source.account(address)

    def _capture_storage_change(self, address: bytes, slot: bytes, prev: int):
        per = self.changes.storage.setdefault(address, {})
        if slot not in per:
            if address in self._created or address in self._selfdestructs or address in self.changes.wiped_storage:
                per[slot] = 0
            else:
                per[slot] = self.source.storage(address, slot)

    def _set_account(self, address: bytes, account: Account | None):
        self._capture_account_change(address)
        self._journal.append(("account", address, self._accounts.get(address, self.source.account(address))))
        self._accounts[address] = account

    def set_balance(self, address: bytes, balance: int):
        self._set_account(address, self.account_or_empty(address).with_(balance=balance))
        self._touched.add(address)

    def add_balance(self, address: bytes, amount: int):
        self.set_balance(address, self.balance(address) + amount)

    def sub_balance(self, address: bytes, amount: int):
        bal = self.balance(address)
        assert bal >= amount, "insufficient balance"
        self.set_balance(address, bal - amount)

    def set_nonce(self, address: bytes, nonce: int):
        self._set_account(address, self.account_or_empty(address).with_(nonce=nonce))

    def bump_nonce(self, address: bytes):
        self.set_nonce(address, self.nonce(address) + 1)

    def set_code(self, address: bytes, code: bytes):
        code_hash = keccak256(code) if code else KECCAK_EMPTY
        if code:
            self._code[code_hash] = code
            self.changes.new_bytecodes[code_hash] = code
        self._set_account(address, self.account_or_empty(address).with_(code_hash=code_hash))

    def create_account(self, address: bytes, nonce: int = 1):
        """Mark an account created by CREATE/CREATE2 (storage resets).
        EIP-161 starts contracts at nonce 1; pre-Spurious forks pass 0."""
        self._capture_account_change(address)
        self._journal.append(("create", address, self._accounts.get(address, self.source.account(address)), address in self._created))
        self._created.add(address)
        prev = self.account(address)
        balance = prev.balance if prev else 0
        self._accounts[address] = Account(nonce=nonce, balance=balance)
        self._storage[address] = {}

    def selfdestruct(self, address: bytes, beneficiary: bytes,
                     same_tx_only: bool = True) -> bool:
        """SELFDESTRUCT. With ``same_tx_only`` (EIP-6780, Cancun) a
        pre-existing account is NOT destroyed — pure balance move; before
        Cancun every destruct deletes the account. Deletion itself happens
        at END of transaction (``process_destructs``): until then the code
        keeps executing if called again, exactly per spec. Returns True on
        the first mark of ``address`` this tx (pre-London refund-once)."""
        bal = self.balance(address)
        first = address not in self._destruct_marks
        if first:
            self._journal.append(("destruct_mark", address))
            self._destruct_marks.add(address)
        destroys = (address in self._created) or not same_tx_only
        if not destroys:
            # EIP-6780 with a pre-existing account: balance move only
            # (self-beneficiary is a no-op)
            self.set_balance(address, 0)
            self.add_balance(beneficiary, bal)
            return first
        if address not in self._pending_destructs:
            self._journal.append(("destruct_pending", address))
            self._pending_destructs.add(address)
        if beneficiary != address:
            self.set_balance(address, 0)
            self.add_balance(beneficiary, bal)
        # beneficiary == address: balance stays and burns with the deletion
        return first

    def process_destructs(self):
        """End-of-tx deletion of selfdestructed accounts (+ storage wipe)."""
        for address in self._pending_destructs:
            self._capture_account_change(address)
            self._accounts[address] = None
            self._storage[address] = {}
            self._selfdestructs.add(address)
            self.changes.wiped_storage.add(address)
        self._pending_destructs = set()

    # -- logs / journal ------------------------------------------------------

    def add_log(self, log: Log):
        self._journal.append(("log", len(self._logs)))
        self._logs.append(log)

    def add_refund(self, amount: int):
        self._journal.append(("refund", self.refund))
        self.refund += amount

    def warm_account(self, address: bytes) -> bool:
        """Warm an account; returns True if it was already warm."""
        if address in self.warm_accounts:
            return True
        self._journal.append(("warm_acct", address))
        self.warm_accounts.add(address)
        return False

    def warm_slot(self, address: bytes, slot: bytes) -> bool:
        key = (address, slot)
        if key in self.warm_slots:
            return True
        self._journal.append(("warm_slot", key))
        self.warm_slots.add(key)
        return False

    def snapshot(self) -> int:
        return len(self._journal)

    def revert(self, snap: int):
        while len(self._journal) > snap:
            entry = self._journal.pop()
            kind = entry[0]
            if kind == "storage":
                _, addr, slot, prev = entry
                self._storage[addr][slot] = prev
            elif kind == "account":
                _, addr, prev = entry
                self._accounts[addr] = prev
            elif kind == "create":
                _, addr, prev, was_created = entry
                self._accounts[addr] = prev
                if not was_created:
                    self._created.discard(addr)
                self._storage.pop(addr, None)
            elif kind == "selfdestruct":
                _, addr, prev, storage, was_dead = entry
                self._accounts[addr] = prev
                self._storage[addr] = storage
                if not was_dead:
                    self._selfdestructs.discard(addr)
                    self.changes.wiped_storage.discard(addr)
            elif kind == "log":
                del self._logs[entry[1] :]
            elif kind == "refund":
                self.refund = entry[1]
            elif kind == "warm_acct":
                self.warm_accounts.discard(entry[1])
            elif kind == "warm_slot":
                self.warm_slots.discard(entry[1])
            elif kind == "destruct_mark":
                self._destruct_marks.discard(entry[1])
            elif kind == "destruct_pending":
                self._pending_destructs.discard(entry[1])

    def take_logs(self) -> list[Log]:
        logs = self._logs
        self._logs = []
        return logs

    def begin_tx(self):
        """Per-transaction resets (EIP-2929 warm sets, refund counter).
        Finalizes the previous tx's pending destructs first, so a caller
        that skips the explicit ``process_destructs`` cannot lose them."""
        self.process_destructs()
        self.warm_accounts = set()
        self.warm_slots = set()
        self.refund = 0
        self._created = set()
        self._destruct_marks = set()
        self._pending_destructs = set()
        self._tx_original = {}
        self._journal.clear()

    def delete_empty_touched(self):
        """EIP-161: remove touched empty accounts at tx end."""
        for addr in self._touched:
            acc = self._accounts.get(addr)
            if acc is not None and acc.is_empty:
                self._capture_account_change(addr)
                self._accounts[addr] = None
        self._touched = set()

    # -- post-block ----------------------------------------------------------

    def final_state(self) -> tuple[dict[bytes, Account | None], dict[bytes, dict[bytes, int]]]:
        """Post-block accounts and storage values for everything touched."""
        self.process_destructs()
        accounts = {a: self._accounts.get(a) for a in self.changes.accounts}
        storage: dict[bytes, dict[bytes, int]] = {}
        for addr, slots in self.changes.storage.items():
            cur = self._storage.get(addr, {})
            storage[addr] = {s: cur.get(s, 0) for s in slots}
        return accounts, storage
