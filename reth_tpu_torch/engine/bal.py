"""Block-access-list (BAL) parallel execution.

A copy of the JAX package's ``engine/bal.py`` on the port's modules.

Reference analogue: EIP-7928 block access lists and the reference's
BAL-driven parallel execution
(crates/engine/tree/src/tree/payload_processor/bal/execute.rs): when a
block's per-transaction access sets are known, non-conflicting
transactions execute concurrently against the pre-state and their
journals merge in order; transactions whose actual accesses collide with
an earlier in-flight write are re-executed serially against the merged
state. The result is bit-identical to serial execution — the access list
is an OPTIMIZATION HINT, never trusted for correctness:

* every wave worker re-records its actual reads/writes; the in-order
  commit validates them against the writes already merged this wave and
  demotes any collision to a serial re-run;
* the coinbase priority-fee credit — which would serialize every pair of
  transactions — is accumulated as a commutative delta through the
  executor's `_credit_coinbase` seam and applied once per commit; any
  OTHER coinbase access (BALANCE of the fee recipient, transfers to or
  from it) marks the transaction coinbase-sensitive and forces it serial.

Scheduling: waves are built greedily from the access list — a
transaction joins the current wave unless an earlier wave member's write
set intersects its read∪write set (read-after-write / write-after-write;
write-after-read is safe because wave members all read the pre-wave
state and journals merge in transaction order).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from ..evm.executor import BlockExecutor, blob_base_fee
from ..ops._build import BuildError
from ..evm.spec import LATEST_SPEC
from ..evm.interpreter import BlockEnv
from ..evm.state import EvmState, StateSource
from ..primitives.types import Account, Block, Receipt


@dataclass
class TxAccess:
    """One transaction's access sets (EIP-7928 per-tx entry)."""

    index: int
    account_reads: set[bytes] = field(default_factory=set)
    account_writes: set[bytes] = field(default_factory=set)
    slot_reads: set[tuple[bytes, bytes]] = field(default_factory=set)
    slot_writes: set[tuple[bytes, bytes]] = field(default_factory=set)
    coinbase_sensitive: bool = False

    def conflicts_with_write_sets(self, accts: set, slots: set) -> bool:
        """Same predicate against an AGGREGATE of many txs' writes — one
        intersection instead of a pairwise scan (O(wave) total instead of
        O(wave^2); the hot cost in big conflict-free blocks).

        ``isdisjoint`` instead of ``&`` over materialized unions: CPython
        iterates the smaller operand and early-exits on the first hit, so
        a conflict-free check costs O(per-tx keys) with zero temporary
        sets no matter how large the accumulated wave writes grow
        (tests/test_parallel_exec.py carries the micro-benchmark)."""
        if not accts.isdisjoint(self.account_reads):
            return True
        if not accts.isdisjoint(self.account_writes):
            return True
        if not slots.isdisjoint(self.slot_reads):
            return True
        return not slots.isdisjoint(self.slot_writes)

    def to_json(self) -> dict:
        hx = lambda b: "0x" + b.hex()  # noqa: E731
        return {
            "index": self.index,
            "accountReads": sorted(hx(a) for a in self.account_reads),
            "accountWrites": sorted(hx(a) for a in self.account_writes),
            "slotReads": sorted([hx(a), hx(s)] for a, s in self.slot_reads),
            "slotWrites": sorted([hx(a), hx(s)] for a, s in self.slot_writes),
        }


@dataclass
class BlockAccessList:
    """Per-transaction access sets for one block."""

    entries: list[TxAccess] = field(default_factory=list)

    def to_json(self) -> list[dict]:
        return [e.to_json() for e in self.entries]


# -- sources ------------------------------------------------------------------


class _RecordingSource(StateSource):
    """Records the cold reads one transaction pulls through the source."""

    def __init__(self, base: StateSource, acc: TxAccess):
        self.base = base
        self.acc = acc

    def account(self, address: bytes):
        self.acc.account_reads.add(address)
        return self.base.account(address)

    def storage(self, address: bytes, slot: bytes) -> int:
        self.acc.slot_reads.add((address, slot))
        return self.base.storage(address, slot)

    def bytecode(self, code_hash: bytes) -> bytes:
        return self.base.bytecode(code_hash)


class _MergedView(StateSource):
    """Parent source + committed post-state overlay."""

    def __init__(self, parent: StateSource):
        self.parent = parent
        self.accounts: dict[bytes, Account | None] = {}
        self.slots: dict[bytes, dict[bytes, int]] = {}
        self.wiped: set[bytes] = set()
        self.codes: dict[bytes, bytes] = {}

    def account(self, address: bytes):
        if address in self.accounts:
            return self.accounts[address]
        return self.parent.account(address)

    def storage(self, address: bytes, slot: bytes) -> int:
        per = self.slots.get(address)
        if per is not None and slot in per:
            return per[slot]
        if address in self.wiped:
            return 0
        return self.parent.storage(address, slot)

    def bytecode(self, code_hash: bytes) -> bytes:
        code = self.codes.get(code_hash)
        if code is not None:
            return code
        return self.parent.bytecode(code_hash)


class _BalState(EvmState):
    """EvmState flagging genuine coinbase accesses (the fee credit itself
    bypasses state through the executor seam, so anything left is real)."""

    def __init__(self, source: StateSource, coinbase: bytes, acc: TxAccess):
        super().__init__(source)
        self._coinbase = coinbase
        self._acc = acc

    def account(self, address: bytes):
        if address == self._coinbase:
            self._acc.coinbase_sensitive = True
        return super().account(address)


class _WaveExecutor(BlockExecutor):
    """Worker executor: coinbase credit becomes a commutative delta."""

    def __init__(self, source: StateSource, config):
        super().__init__(source, config)
        self.fee_delta = 0

    def _credit_coinbase(self, state, env, amount):
        self.fee_delta += amount


def make_recording_state(source: StateSource, coinbase: bytes, index: int,
                         config):
    """The recording trio every speculative/recording execution needs:
    (TxAccess, fee-delta executor, coinbase-flagging state). The fee
    credit MUST go through the delta executor — a plain BlockExecutor
    would write coinbase state and poison every access set with a
    coinbase conflict."""
    acc = TxAccess(index=index)
    rec = _RecordingSource(source, acc)
    ex = _WaveExecutor(rec, config)
    state = _BalState(rec, coinbase, acc)
    return acc, ex, state


# -- recording (builds the exact BAL from a serial reference run) -------------


def record_access_list(source: StateSource, block: Block,
                       senders: list[bytes], config=None) -> BlockAccessList:
    """Serial execution that records each transaction's exact access sets
    (the payload builder's side of EIP-7928: the builder KNOWS the
    accesses because it executed the block)."""
    env = _block_env(block, config)
    bal = BlockAccessList()
    merged = _MergedView(source)
    cumulative = 0
    for i, (tx, sender) in enumerate(zip(block.transactions, senders)):
        acc, ex, state = make_recording_state(merged, env.coinbase, i, config)
        result = ex._execute_tx(state, env, tx, sender,
                                env.gas_limit - cumulative)
        cumulative += result.gas_used
        _extract_writes(state, acc)
        _commit_journal(merged, state, ex.fee_delta, env.coinbase)
        bal.entries.append(acc)
    return bal


def _block_env(block: Block, config, block_hashes=None) -> BlockEnv:
    h = block.header
    return BlockEnv(
        number=h.number, timestamp=h.timestamp, coinbase=h.beneficiary,
        gas_limit=h.gas_limit, base_fee=h.base_fee_per_gas or 0,
        prev_randao=h.mix_hash,
        chain_id=config.chain_id if config is not None else 1,
        difficulty=h.difficulty,
        block_hashes=block_hashes or {},
        blob_base_fee=blob_base_fee(
            h.excess_blob_gas or 0,
            config.blob_params_for(h.number, h.timestamp).update_fraction
            if config is not None else LATEST_SPEC.blob.update_fraction),
    )


def _extract_writes(state: EvmState, acc: TxAccess) -> None:
    for addr in state.changes.accounts:
        acc.account_writes.add(addr)
    for addr, slots in state.changes.storage.items():
        for s in slots:
            acc.slot_writes.add((addr, s))


def _apply_fee_delta(merged: "_MergedView", coinbase: bytes,
                     fee_delta: int) -> None:
    """Credit the accumulated priority fees to the coinbase in the merged
    view (the single home of this logic — python and native commits)."""
    prev = merged.account(coinbase)
    if prev is None:
        merged.accounts[coinbase] = Account(balance=fee_delta)
    else:
        merged.accounts[coinbase] = Account(
            nonce=prev.nonce, balance=prev.balance + fee_delta,
            storage_root=prev.storage_root, code_hash=prev.code_hash)


def _commit_journal(merged: _MergedView, state: EvmState, fee_delta: int,
                    coinbase: bytes) -> None:
    """Fold one transaction's journal into the merged post-state view."""
    accounts, storage = state.final_state()
    merged.accounts.update(accounts)
    for addr in state.changes.wiped_storage:
        merged.wiped.add(addr)
        merged.slots[addr] = {}
    for addr, slots in storage.items():
        merged.slots.setdefault(addr, {}).update(slots)
    merged.codes.update(state.changes.new_bytecodes)
    if fee_delta:
        _apply_fee_delta(merged, coinbase, fee_delta)


# -- the shared commit fold ---------------------------------------------------


class BlockCommitter:
    """In-order fold of executed transactions into one block's output:
    the merged post-state view, first-touch changesets (previous images
    relative to BLOCK start), receipts, per-tx outputs, and the
    ``state_hook`` key streaming that feeds the background state-root
    task. ONE home for this logic, shared by the BAL wave loop
    (:func:`execute_block_bal`) and the optimistic scheduler
    (engine/optimistic.py) — the two parallel execution paths cannot
    drift in how they merge state.

    ``written_accts`` / ``written_slots`` accumulate every committed
    write key since construction: the optimistic scheduler validates
    block-start speculation against them (Block-STM's read-set check)."""

    def __init__(self, source: StateSource, env: BlockEnv, transactions,
                 state_hook=None):
        self.source = source
        self.env = env
        self.transactions = transactions
        self.state_hook = state_hook
        self.merged = _MergedView(source)
        self.changes_accounts: dict[bytes, Account | None] = {}
        self.changes_storage: dict[bytes, dict[bytes, int]] = {}
        self.wiped: set[bytes] = set()
        self.new_codes: dict[bytes, bytes] = {}
        self.receipts: list[Receipt] = []
        self.tx_outputs: list[bytes] = []
        self.cumulative = 0
        self.committed_any = False
        self.written_accts: set[bytes] = set()
        self.written_slots: set[tuple[bytes, bytes]] = set()

    def capture_changesets(self, state) -> None:
        # first-touch-wins previous images, relative to BLOCK start
        for addr, prev in state.changes.accounts.items():
            if addr not in self.changes_accounts:
                self.changes_accounts[addr] = prev
        for addr, slots in state.changes.storage.items():
            per = self.changes_storage.setdefault(addr, {})
            for s, prev in slots.items():
                per.setdefault(s, prev)
        for addr in state.changes.wiped_storage:
            self.wiped.add(addr)
        self.new_codes.update(state.changes.new_bytecodes)

    def commit_tx(self, i: int, state, fee_delta: int, result) -> None:
        """Fold one interpreter-executed tx (journal in ``state``) into
        the block output."""
        self.committed_any = True
        self.capture_changesets(state)
        if self.state_hook is not None:
            keys = list(state.changes.accounts) + [
                (a, s) for a, per in state.changes.storage.items()
                for s in per]
            if fee_delta:
                keys.append(self.env.coinbase)
            self.state_hook(keys)
        self.written_accts.update(state.changes.accounts)
        for a, per in state.changes.storage.items():
            self.written_slots.update((a, s) for s in per)
        _commit_journal(self.merged, state, fee_delta, self.env.coinbase)
        if fee_delta and self.env.coinbase not in self.changes_accounts:
            self.changes_accounts[self.env.coinbase] = \
                self.source.account(self.env.coinbase)
        self.cumulative += result.gas_used
        self.receipts.append(Receipt(
            tx_type=self.transactions[i].tx_type,
            success=result.success,
            cumulative_gas_used=self.cumulative,
            logs=tuple(result.receipt.logs),
        ))
        self.tx_outputs.append(result.output)

    def commit_native(self, tx_type: int, success: bool, gas_used: int,
                      fee_delta: int, logs, acct_writes, slot_writes,
                      prev_accounts, prev_slots, output: bytes = b"") -> None:
        """Single-pass fold of a natively executed tx — same effects as
        :meth:`commit_tx`, skipping the intermediate BlockChanges/shim
        objects (this is on the per-tx hot path of big blocks)."""
        self.committed_any = True
        merged = self.merged
        keys = [] if self.state_hook is not None else None
        for wa, deleted, nonce, balance in acct_writes:
            prev = prev_accounts[wa]
            if wa not in self.changes_accounts:
                self.changes_accounts[wa] = prev
            if deleted:
                merged.accounts[wa] = None
            elif prev is not None:
                merged.accounts[wa] = Account(
                    nonce=nonce, balance=balance,
                    storage_root=prev.storage_root,
                    code_hash=prev.code_hash)
            else:
                merged.accounts[wa] = Account(nonce=nonce, balance=balance)
            self.written_accts.add(wa)
            if keys is not None:
                keys.append(wa)
        for ka, ks, v in slot_writes:
            per = self.changes_storage.get(ka)
            if per is None:
                per = self.changes_storage[ka] = {}
            if ks not in per:
                per[ks] = prev_slots[(ka, ks)]
            mper = merged.slots.get(ka)
            if mper is None:
                mper = merged.slots[ka] = {}
            mper[ks] = v
            self.written_slots.add((ka, ks))
            if keys is not None:
                keys.append((ka, ks))
        if fee_delta:
            _apply_fee_delta(merged, self.env.coinbase, fee_delta)
            if self.env.coinbase not in self.changes_accounts:
                self.changes_accounts[self.env.coinbase] = \
                    self.source.account(self.env.coinbase)
            if keys is not None:
                keys.append(self.env.coinbase)
        if keys:
            self.state_hook(keys)
        self.cumulative += gas_used
        self.receipts.append(Receipt(
            tx_type=tx_type, success=success,
            cumulative_gas_used=self.cumulative, logs=logs,
        ))
        self.tx_outputs.append(output)

    def commit_system_state(self, state) -> None:
        """Fold a system-call phase's journal (an EvmState OVER the merged
        view) into the block: changesets, merged view, key stream — no
        receipt, no gas (system calls are unmetered in the block)."""
        self.capture_changesets(state)
        if self.state_hook is not None:
            keys = list(state.changes.accounts) + [
                (a, s) for a, per in state.changes.storage.items()
                for s in per]
            if keys:
                self.state_hook(keys)
        self.written_accts.update(state.changes.accounts)
        for a, per in state.changes.storage.items():
            self.written_slots.update((a, s) for s in per)
        _commit_journal(self.merged, state, 0, self.env.coinbase)

    def apply_withdrawals(self, withdrawals) -> None:
        """Post-tx withdrawal credits (gwei → wei), as the serial path."""
        keys = []
        for w in withdrawals or ():
            if w.amount:
                if w.address not in self.changes_accounts:
                    self.changes_accounts[w.address] = \
                        self.source.account(w.address)
                prev = self.merged.account(w.address) or Account()
                self.merged.accounts[w.address] = prev.with_(
                    balance=prev.balance + w.amount * 10**9)
                self.written_accts.add(w.address)
                keys.append(w.address)
        if keys and self.state_hook is not None:
            self.state_hook(keys)

    def build_output(self, senders):
        """Assemble the BlockExecutionOutput (identical in shape to the
        serial executor's)."""
        from ..evm.executor import BlockExecutionOutput

        out = BlockExecutionOutput()
        out.senders = senders
        out.receipts = self.receipts
        out.tx_outputs = self.tx_outputs
        out.gas_used = self.cumulative
        from ..evm.state import BlockChanges

        out.changes = BlockChanges(accounts=self.changes_accounts,
                                   storage=self.changes_storage,
                                   wiped_storage=self.wiped,
                                   new_bytecodes=self.new_codes)
        out.post_accounts = {a: self.merged.accounts.get(a)
                             for a in self.changes_accounts}
        out.post_storage = {
            a: {s: self.merged.slots.get(a, {}).get(s, 0) for s in slots}
            for a, slots in self.changes_storage.items()
        }
        return out


# -- parallel execution -------------------------------------------------------


def _build_waves(bal: BlockAccessList, n_txs: int) -> list[list[int]]:
    """Greedy in-order wave partition from the (hint) access list."""
    waves: list[list[int]] = []
    entries = {e.index: e for e in bal.entries}
    current: list[int] = []
    cur_accts: set = set()
    cur_slots: set = set()
    for i in range(n_txs):
        acc = entries.get(i)
        joins = (acc is not None and not acc.coinbase_sensitive
                 and not acc.conflicts_with_write_sets(cur_accts, cur_slots))
        if joins or not current:
            current.append(i)
            if acc is not None:
                cur_accts |= acc.account_writes
                cur_slots |= acc.slot_writes
        else:
            waves.append(current)
            current = [i]
            cur_accts = set(acc.account_writes) if acc else set()
            cur_slots = set(acc.slot_writes) if acc else set()
    if current:
        waves.append(current)
    return waves


def execute_block_bal(source: StateSource, block: Block,
                      senders: list[bytes], bal: BlockAccessList,
                      config=None, max_workers: int = 4, state_hook=None,
                      block_hashes=None):
    """Execute a block wave-parallel per the access-list hint; output is
    identical to `BlockExecutor.execute` (validated, with serial fallback
    per conflicting transaction). Returns (output, stats)."""
    env = _block_env(block, config, block_hashes)
    com = BlockCommitter(source, env, block.transactions,
                         state_hook=state_hook)
    merged = com.merged
    stats = {"waves": 0, "parallel": 0, "serial": 0, "native": 0}
    waves = _build_waves(bal, len(block.transactions))
    entries_by_index = {e.index: e for e in bal.entries}
    # Wave execution prefers the NATIVE core (native/evmexec.cpp): the
    # whole wave runs on real OS threads in C++ against a snapshot built
    # from the access hint, entirely GIL-free; transactions it declines
    # (unsupported ops, missing keys) fall back to the Python
    # interpreter below. RETH_TPU_BAL_NATIVE=0 disables it.
    use_native = os.environ.get("RETH_TPU_BAL_NATIVE", "1") != "0"
    # Pure-Python wave members under threads are GIL-bound: contention
    # without concurrency (measured ~4x SLOWER than serial) — so the
    # Python fallback runs sequentially; RETH_TPU_BAL_THREADS=1 forces a
    # pool anyway for experiments.
    use_threads = os.environ.get("RETH_TPU_BAL_THREADS") == "1"
    pool = (ThreadPoolExecutor(max_workers=max_workers)
            if use_threads and any(len(w) > 1 for w in waves) else None)

    def _speculate(i: int):
        acc, ex, state = make_recording_state(merged, env.coinbase, i, config)
        try:
            result = ex._execute_tx(state, env, block.transactions[i],
                                    senders[i], env.gas_limit)
            _extract_writes(state, acc)
            return (i, acc, state, ex.fee_delta, result, None)
        except Exception as e:  # noqa: BLE001 — stale-state failures retry serial
            return (i, acc, None, 0, None, e)

    def _serial(i: int):
        acc, ex, state = make_recording_state(merged, env.coinbase, i, config)
        result = ex._execute_tx(state, env, block.transactions[i], senders[i],
                                env.gas_limit - com.cumulative)
        _extract_writes(state, acc)
        return acc, state, ex.fee_delta, result

    native_done = False
    if use_native:
        # native segment flow: maximal runs of native-eligible txs execute
        # entirely in C++ (waves, conflict validation, inter-wave merge);
        # anything else runs serially through the interpreter in order
        try:
            from .native_exec import native_flow

            native_done = native_flow(
                block, senders, waves, entries_by_index, config, env,
                merged, max_workers, stats,
                commit_tx=com.commit_tx, commit_native=com.commit_native,
                run_python=_serial,
                remaining_gas=lambda: env.gas_limit - com.cumulative)
        except BuildError:
            raise  # a failed g++ build is a fault, not a decline
        except Exception:  # noqa: BLE001 — native is an accelerator only;
            native_done = False  # any failure restarts on the Python path
            if com.committed_any:
                raise  # partial commit: restarting would double-apply
            # nothing committed: zero the failed attempt's counters so the
            # Python loop's accounting starts clean
            for k in stats:
                stats[k] = 0

    if not native_done:
        for wave in waves:
            stats["waves"] += 1
            if len(wave) == 1 or pool is None:
                results = {i: _speculate(i) for i in wave}
            else:
                results = {r[0]: r for r in pool.map(_speculate, wave)}
            committed_accts: set = set()
            committed_slots: set = set()
            for i in wave:
                _, acc, state, fee_delta, result, err = results[i]
                conflicted = (
                    err is not None
                    or acc.coinbase_sensitive
                    or acc.conflicts_with_write_sets(committed_accts,
                                                     committed_slots)
                    or block.transactions[i].gas_limit > env.gas_limit - com.cumulative
                )
                if conflicted:
                    stats["serial"] += 1
                    acc, state, fee_delta, result = _serial(i)  # may raise: invalid block
                elif len(wave) > 1:
                    stats["parallel"] += 1  # conflict-free wave commit (the
                    # schedule-level count; threads only under RETH_TPU_BAL_THREADS)
                else:
                    stats["serial"] += 1
                com.commit_tx(i, state, fee_delta, result)
                committed_accts |= acc.account_writes
                committed_slots |= acc.slot_writes

    if pool is not None:
        pool.shutdown(wait=True)
    com.apply_withdrawals(block.withdrawals)
    return com.build_output(senders), stats
