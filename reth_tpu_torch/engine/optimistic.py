"""Optimistic parallel EVM execution with asynchronous storage prefetch.

A copy of the JAX package's ``engine/optimistic.py`` on the port's modules.

Reference analogue: Block-STM-style optimistic scheduling (the shape
reth's experimental parallel executors and Reddio's "Parallel EVM
Execution with Asynchronous Storage" — arxiv 2503.04595 — both describe):
every transaction of a block executes SPECULATIVELY in parallel against
the block-start state with per-rank read/write-set capture; each rank's
read set is validated in order against the writes committed by earlier
ranks; only invalidated ranks re-execute against the merged view. No
access-list hint is needed — this is the engine tree's no-BAL path, the
one every real ``newPayload`` takes.

Execution engine layering (the fallback ladder):

1. **Native rounds** — maximal runs of native-eligible transactions go
   to the C++ wave core (native/evmexec.cpp) as ONE single-wave segment:
   all ranks speculate on OS threads (GIL released for the whole ctypes
   call), in-order validation demotes conflicting ranks to a serial
   native re-run, and the committed prefix folds into the block output
   rank by rank. The snapshot the core executes against starts from the
   statically known keys (senders, targets, tx access lists) and GROWS
   round over round from the read sets every result reports back — a
   miss keeps its partial reads precisely so the next round can carry
   the missing state.
2. **Async storage layer** — :class:`AsyncStateReader` prefetches the
   discovered keys (accounts, slots, bytecode) on background threads
   while the native core crunches, so cold provider reads overlap
   execution instead of serializing in front of the next round.
3. **Python ranks** — transactions the native core cannot take
   (creations, blob/set-code types, coinbase-sensitive, unsupported
   opcodes) speculate on a thread pool against a frozen block-start view
   — this IS the prewarm pass (reads warm the shared execution cache and
   stream to the sparse root task) — and commit their speculative
   journal directly when validation passes; only invalidated ranks
   re-execute serially against the merged view.
4. **Serial fallback** — any scheduler error (not a consensus-invalid
   transaction) abandons the attempt and re-runs the whole block through
   ``BlockExecutor.execute``; nothing was written outside the
   scheduler's local views, so the fallback is always safe.

Receipts, logs, gas, requests, and post-state are bit-identical to the
serial executor by construction: commits happen strictly in rank order,
validation is the same read/write-intersection rule the BAL machinery
uses (engine/bal.py), and the native core reproduces the interpreter
bit-for-bit or declines.

Fault drills: ``RETH_TPU_FAULT_EXEC_CONFLICT_STORM`` forces every rank
through speculation-invalidated serial re-execution (the all-conflict
worst case); ``RETH_TPU_FAULT_EXEC_RANK_WEDGE=<rank>`` wedges that
rank's speculative worker so the rank timeout trips the serial-fallback
ladder end to end.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout
from dataclasses import dataclass

from .. import tracing
from ..evm.executor import (
    BEACON_ROOTS_ADDRESS,
    BlockExecutor,
    HISTORY_STORAGE_ADDRESS,
    InvalidTransaction,
)
from ..evm.spec import LATEST_SPEC
from ..evm.state import EvmState, StateSource
from ..ops._build import BuildError
from ..primitives.types import KECCAK_EMPTY
from .bal import (
    BlockCommitter,
    _block_env,
    _extract_writes,
    _MergedView,
    make_recording_state,
)

_FAULT_STORM = "RETH_TPU_FAULT_EXEC_CONFLICT_STORM"
_FAULT_WEDGE = "RETH_TPU_FAULT_EXEC_RANK_WEDGE"


class ExecSchedulerError(Exception):
    """The optimistic scheduler could not finish; use the serial path."""


class ExecCancelled(Exception):
    """Cooperative cancellation (a forkchoiceUpdated reorged away from
    the block mid-execution): NOT a scheduler failure — it must
    propagate to the engine, never fall back to a serial re-run of a
    dead head's block."""


def default_exec_workers() -> int:
    """Speculation width: RETH_TPU_EXEC_WORKERS, else core-derived."""
    env = os.environ.get("RETH_TPU_EXEC_WORKERS")
    if env:
        return max(1, int(env))
    return max(2, min(8, os.cpu_count() or 4))


# -- async storage layer ------------------------------------------------------


class AsyncStateReader:
    """Batched background prefetch of accounts, storage slots, and
    bytecode into a shared read cache (the paper's asynchronous storage
    layer). Requests come from three places: the block's statically
    known keys, the read sets missed native ranks report back, and the
    read sets completed speculative ranks captured — each feeding the
    still-running ones. All reads stay SYNCHRONOUS fallbacks: the reader
    only moves cold provider reads off the critical path, overlapping
    them with the GIL-free native rounds, so a wedged or slow prefetch
    can never change a result."""

    def __init__(self, base: StateSource, workers: int = 2):
        self.base = base
        self.accounts: dict[bytes, object] = {}
        self.slots: dict[tuple[bytes, bytes], int] = {}
        self.codes: dict[bytes, bytes] = {}
        self.prefetched = 0
        self._queue: queue.Queue = queue.Queue()
        self._seen: set = set()
        self._threads = [
            threading.Thread(target=self._run, daemon=True,
                             name=f"exec-prefetch-{i}")
            for i in range(max(1, workers))
        ]
        for t in self._threads:
            t.start()

    def request(self, keys) -> None:
        """Enqueue plain keys (20-byte addresses / (address, slot) pairs)
        for background fetch; duplicates are dropped."""
        fresh = [k for k in keys if k not in self._seen]
        if not fresh:
            return
        self._seen.update(fresh)
        self._queue.put(fresh)

    def _run(self) -> None:
        while True:
            batch = self._queue.get()
            if batch is None:
                return
            for k in batch:
                try:
                    if isinstance(k, bytes):
                        if k not in self.accounts:
                            acc = self.base.account(k)
                            self.accounts[k] = acc
                            if acc is not None \
                                    and acc.code_hash != KECCAK_EMPTY \
                                    and acc.code_hash not in self.codes:
                                self.codes[acc.code_hash] = \
                                    self.base.bytecode(acc.code_hash)
                    elif k not in self.slots:
                        self.slots[k] = self.base.storage(*k)
                    self.prefetched += 1
                except Exception:  # noqa: BLE001 — prefetch is advisory;
                    pass  # the synchronous read will surface real errors

    def stop(self) -> None:
        for _ in self._threads:
            self._queue.put(None)
        for t in self._threads:
            t.join(timeout=2)


class _PrefetchSource(StateSource):
    """StateSource over ``base`` consulting the reader's cache first and
    filling it on synchronous misses (the block's parent state is frozen,
    so caching is always sound)."""

    def __init__(self, base: StateSource, reader: AsyncStateReader):
        self.base = base
        self.reader = reader

    def account(self, address: bytes):
        cache = self.reader.accounts
        if address in cache:
            return cache[address]
        acc = self.base.account(address)
        cache[address] = acc
        return acc

    def storage(self, address: bytes, slot: bytes) -> int:
        cache = self.reader.slots
        key = (address, slot)
        if key in cache:
            return cache[key]
        v = self.base.storage(address, slot)
        cache[key] = v
        return v

    def bytecode(self, code_hash: bytes) -> bytes:
        cache = self.reader.codes
        code = cache.get(code_hash)
        if code is None:
            code = self.base.bytecode(code_hash)
            cache[code_hash] = code
        return code


# -- the scheduler ------------------------------------------------------------


@dataclass
class _Speculation:
    """One rank's speculative first attempt (= its prewarm run)."""

    acc: object          # TxAccess (read/write sets + coinbase flag)
    state: object        # EvmState journal over the frozen view
    fee_delta: int
    result: object       # TxResult
    err: Exception | None


class OptimisticScheduler:
    """One block's (or one payload candidate list's) optimistic run."""

    MAX_RETRIES = 6  # native retry rounds per stuck head rank

    def __init__(self, source: StateSource, transactions, senders,
                 config=None, max_workers: int | None = None,
                 state_hook=None, env=None, block=None, block_hashes=None,
                 mode: str = "block", withdrawals=None,
                 blob_cap: int | None = None, cancel_event=None):
        self.txs = list(transactions)
        self.senders = senders
        self.config = config
        self.block = block
        self.mode = mode
        self.withdrawals = withdrawals
        self.blob_cap = blob_cap
        self.blob_gas_used = 0
        self.state_hook = state_hook
        # cooperative cancellation (engine tree in-flight insert event):
        # checked at wave boundaries so a reorging fcU stops the rounds
        self.cancel_event = cancel_event
        self.workers = max_workers or default_exec_workers()
        self.env = env if env is not None else _block_env(
            block, config, block_hashes)
        self.spec = (config.spec_for(self.env.number, self.env.timestamp)
                     if config is not None else LATEST_SPEC)
        self.storm = bool(os.environ.get(_FAULT_STORM))
        wedge = os.environ.get(_FAULT_WEDGE)
        self.wedge_rank = int(wedge) if wedge not in (None, "") else None
        self.rank_timeout = float(
            os.environ.get("RETH_TPU_EXEC_RANK_TIMEOUT", "60"))
        self.reader = AsyncStateReader(source,
                                       workers=max(1, self.workers // 4))
        self.psource = _PrefetchSource(source, self.reader)
        self.lib = None
        if not self.storm and \
                os.environ.get("RETH_TPU_EXEC_NATIVE", "1") != "0":
            # a failed g++ build raises its BuildError (the reference
            # runs the block on Python ranks instead)
            from .native_exec import load_library

            self.lib = load_library()
        self.native_ok = (self.lib is not None
                          and self.spec.at_least(LATEST_SPEC.name))
        self.stats = {
            "mode": "optimistic", "workers": self.workers, "rounds": 0,
            "native": 0, "python": 0, "speculative": 0, "serial_rerun": 0,
            "conflicts": 0, "misses": 0, "demoted": 0, "prefetched": 0,
            "snapshot_keys": 0, "fallback": None,
            "native_available": self.native_ok,
        }
        self.committed: list[int] = []
        self.evicted: list[int] = []
        self.snap_accts: set[bytes] = set()
        self.snap_slots: set[tuple[bytes, bytes]] = set()
        self._pending_keys: queue.Queue = queue.Queue()
        self._attempts: dict[int, int] = {}
        self.spec_pool = ThreadPoolExecutor(
            max_workers=self.workers, thread_name_prefix="exec-spec")
        self.spec_futures: dict[int, object] = {}
        self.failed_senders: set[bytes] = set()
        self.frozen = None
        self.com = None
        self._ctx = tracing.current_context()
        if self.storm:
            tracing.fault_event("EXEC_CONFLICT_STORM",
                                target="engine::optimistic",
                                txs=len(self.txs))

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        self.reader.stop()
        try:
            self.spec_pool.shutdown(wait=False, cancel_futures=True)
        except TypeError:  # pragma: no cover - pre-3.9 signature
            self.spec_pool.shutdown(wait=False)

    # -- eligibility ---------------------------------------------------------

    def _static_eligible(self, i: int) -> bool:
        """Can rank ``i`` even be OFFERED to the native core? (The core
        itself still declines dynamically — nonce/balance/opcode misses
        come back as status 2.)"""
        if not self.native_ok:
            return False
        if self.wedge_rank is not None and i == self.wedge_rank:
            return False  # drill: force the wedged rank onto the pool
        tx = self.txs[i]
        env = self.env
        return (tx.tx_type <= 2 and tx.to is not None
                and not tx.authorization_list
                and (tx.chain_id is None or tx.chain_id == env.chain_id)
                and not (tx.tx_type >= 2 and tx.max_fee_per_gas < env.base_fee)
                and not (tx.tx_type < 2 and tx.gas_price < env.base_fee)
                and env.coinbase != tx.to
                and env.coinbase != self.senders[i])

    def _demote(self, i: int) -> None:
        """Hand rank ``i`` to the Python path permanently (and start its
        speculative prewarm run right away)."""
        if self.eligible[i]:
            self.eligible[i] = False
            self.stats["demoted"] += 1
            self._submit_speculation(i)

    # -- speculation (the folded-in prewarm pass) ----------------------------

    def _submit_speculation(self, i: int) -> None:
        if i not in self.spec_futures:
            self.spec_futures[i] = self.spec_pool.submit(self._speculate, i)

    def _speculate(self, i: int) -> _Speculation:
        """Speculative first attempt of rank ``i`` against the frozen
        block-start view. This IS the prewarm run: reads flow through
        (and warm) the shared cached source, the captured read set feeds
        the async storage layer and the state-root task's prefetch, and
        — unlike the old PrewarmTask — a validation-clean result commits
        directly instead of being thrown away."""
        with tracing.use_context(self._ctx):
            with tracing.span("engine::optimistic", "exec.speculate", idx=i):
                return self._speculate_inner(i)

    def _speculate_inner(self, i: int) -> _Speculation:
        if self.wedge_rank is not None and i == self.wedge_rank:
            tracing.fault_event("EXEC_RANK_WEDGE",
                                target="engine::optimistic", rank=i)
            time.sleep(float(os.environ.get(
                "RETH_TPU_FAULT_EXEC_WEDGE_S", "5")))
        acc, ex, state = make_recording_state(
            self.frozen, self.env.coinbase, i, self.config)
        try:
            result = ex._execute_tx(state, self.env, self.txs[i],
                                    self.senders[i], self.env.gas_limit)
            _extract_writes(state, acc)
            sp = _Speculation(acc, state, ex.fee_delta, result, None)
        except Exception as e:  # noqa: BLE001 — stale-state failures
            sp = _Speculation(acc, None, 0, None, e)  # retry serially
        # feed the async storage layer + the state-root prefetch with the
        # captured read set (complete for finished runs, partial for
        # failed ones — still the right keys to warm)
        try:
            keys = list(acc.account_reads) + list(acc.slot_reads)
            if keys:
                self.reader.request(keys)
                self._pending_keys.put(keys)
                if self.state_hook is not None and self.mode == "block":
                    self.state_hook(keys)
        except Exception:  # noqa: BLE001 — prefetch is advisory only
            pass
        return sp

    def _drain_pending_keys(self) -> None:
        """Fold worker-discovered keys into the native snapshot key sets
        (main-thread only: the sets are iterated during marshaling)."""
        while True:
            try:
                keys = self._pending_keys.get_nowait()
            except queue.Empty:
                return
            for k in keys:
                (self.snap_accts if isinstance(k, bytes)
                 else self.snap_slots).add(k)

    # -- native rounds -------------------------------------------------------

    def _native_round(self, lo: int, hi: int):
        """One optimistic native round over ranks [lo, hi): single-wave
        speculation + in-order validation + serial conflict re-runs, all
        in C++. Returns ``(next_pos, stopper, stopper_grew)`` where
        ``stopper`` is the first uncommitted rank's result (None when the
        whole run committed) and ``stopper_grew`` says whether its
        reported reads added new keys to the snapshot (i.e. a retry can
        succeed)."""
        from .native_exec import (
            call_segment,
            env_buffer,
            parse_results,
            snapshot_buffer,
            txs_buffer,
        )

        com = self.com
        self.stats["rounds"] += 1
        snap_buf, prev_accounts, prev_slots = snapshot_buffer(
            com.merged, self.snap_accts, self.snap_slots)
        txs_buf = txs_buffer(self.txs, self.senders, range(lo, hi),
                             self.spec, self.env)
        raw = call_segment(self.lib, snap_buf, env_buffer(self.env), txs_buf,
                           [hi - lo], self.env.gas_limit - com.cumulative,
                           self.workers)
        results = parse_results(raw)
        next_pos = lo
        stopper = None
        stopper_grew = False
        for res in results:
            i = res["index"]
            if res["status"] <= 1 and next_pos == i:
                com.commit_native(
                    self.txs[i].tx_type, res["status"] == 1,
                    res["gas_used"], res["fee_delta"], res["logs"],
                    res["acct_writes"], res["slot_writes"],
                    prev_accounts, prev_slots, output=res["output"])
                self.committed.append(i)
                self.stats["native"] += 1
                if res["mode"] == 1:
                    self.stats["conflicts"] += 1
                next_pos = i + 1
                continue
            # missed / not-run rank: harvest its reads for the prefetcher
            fresh_a = res["acct_reads"] - self.snap_accts
            fresh_s = res["slot_reads"] - self.snap_slots
            if fresh_a or fresh_s:
                self.snap_accts |= fresh_a
                self.snap_slots |= fresh_s
                self.reader.request(list(fresh_a) + list(fresh_s))
                if i == next_pos:
                    stopper_grew = True
            if i == next_pos and stopper is None:
                stopper = res
                self.stats["misses"] += 1
        return next_pos, stopper, stopper_grew

    # -- python ranks --------------------------------------------------------

    def _payload_gate(self, i: int):
        """Payload-build admission for rank ``i``; returns a skip reason
        (builder semantics: skip, never block-invalid) or None."""
        tx = self.txs[i]
        if self.senders[i] in self.failed_senders:
            return "nonce-gapped descendant"
        if tx.gas_limit > self.env.gas_limit - self.com.cumulative:
            return "over block gas limit"
        if tx.blob_gas():
            if self.blob_cap is None or \
                    self.blob_gas_used + tx.blob_gas() > self.blob_cap:
                return "over blob gas cap"
        return None

    def _commit_python_rank(self, i: int) -> None:
        """Commit rank ``i`` on the Python path: take its speculative
        result when validation passes, else re-execute serially against
        the merged view (only invalidated ranks pay the re-run)."""
        com = self.com
        env = self.env
        tx = self.txs[i]
        if self.mode == "payload":
            reason = self._payload_gate(i)
            if reason is not None:
                return  # skipped, stays pooled (builder semantics)
        t0 = time.time()
        self._submit_speculation(i)
        fut = self.spec_futures[i]
        try:
            sp = fut.result(timeout=self.rank_timeout)
        except _FutureTimeout:
            raise ExecSchedulerError(
                f"rank {i} speculation wedged past "
                f"{self.rank_timeout}s") from None
        mode = "speculative"
        if (sp.err is None and not self.storm
                and not sp.acc.coinbase_sensitive
                and tx.gas_limit <= env.gas_limit - com.cumulative
                and not sp.acc.conflicts_with_write_sets(com.written_accts,
                                                         com.written_slots)):
            # Block-STM commit: the speculative journal IS the result.
            # (Writes committed before the freeze — the system-call phase
            # — can flag a spurious conflict; that only costs a re-run.)
            com.commit_tx(i, sp.state, sp.fee_delta, sp.result)
            self.stats["speculative"] += 1
        else:
            mode = "serial"
            try:
                acc, ex, state = make_recording_state(
                    com.merged, env.coinbase, i, self.config)
                result = ex._execute_tx(state, env, tx, self.senders[i],
                                        env.gas_limit - com.cumulative)
                _extract_writes(state, acc)
            except (InvalidTransaction, ValueError) as e:
                if self.mode == "payload":
                    # provably unexecutable candidate: evict, skip its
                    # descendants (they are nonce-gapped now)
                    self.evicted.append(i)
                    self.failed_senders.add(self.senders[i])
                    return
                raise  # newPayload: the block is invalid, same as serial
            com.commit_tx(i, state, ex.fee_delta, result)
            self.stats["serial_rerun"] += 1
        self.committed.append(i)
        self.stats["python"] += 1
        self.blob_gas_used += tx.blob_gas()
        tracing.record_span("engine::optimistic", "exec.rank", t0,
                            time.time() - t0, ctx=self._ctx,
                            fields={"idx": i, "mode": mode})

    # -- system phases (newPayload mode only) --------------------------------

    def _pre_block_phase(self) -> None:
        """EIP-4788 beacon root + EIP-2935 history system calls, folded
        into the merged view before rank 0 (exactly the serial order)."""
        header = self.block.header
        spec = self.spec
        ex = BlockExecutor(self.com.merged, self.config)
        state = EvmState(self.com.merged)
        ran = False
        if spec.beacon_root_call and \
                header.parent_beacon_block_root is not None:
            ex._system_call(state, self.env, spec, BEACON_ROOTS_ADDRESS,
                            header.parent_beacon_block_root)
            ran = True
        if spec.history_contract_call and header.number > 0:
            ex._system_call(state, self.env, spec, HISTORY_STORAGE_ADDRESS,
                            header.parent_hash)
            ran = True
        if ran:
            self.com.commit_system_state(state)

    def _requests_phase(self) -> list[bytes]:
        """EIP-7685 requests over the merged post-tx view (deposit logs
        from the committed receipts + the two system calls)."""
        if not self.spec.has_requests:
            return []
        ex = BlockExecutor(self.com.merged, self.config)
        state = EvmState(self.com.merged)
        requests = ex._collect_requests(state, self.env, self.spec,
                                        self.com.receipts)
        self.com.commit_system_state(state)
        return requests

    # -- the run -------------------------------------------------------------

    def run(self):
        t_start = time.time()
        spec = self.spec
        if self.mode == "block" and (
                spec.block_reward or not spec.receipt_status
                or (self.block is not None and self.block.ommers)):
            raise ExecSchedulerError(
                f"pre-merge rules ({spec.name}): serial path")
        self.com = BlockCommitter(self.psource, self.env, self.txs,
                                  state_hook=self.state_hook)
        if self.mode == "block":
            self._pre_block_phase()
        # freeze the post-system-call view: speculation workers read this
        # while the commit loop mutates the live merged view
        frozen = _MergedView(self.psource)
        frozen.accounts = dict(self.com.merged.accounts)
        frozen.slots = {a: dict(p) for a, p in self.com.merged.slots.items()}
        frozen.wiped = set(self.com.merged.wiped)
        frozen.codes = dict(self.com.merged.codes)
        self.frozen = frozen
        n = len(self.txs)
        self.eligible = [self._static_eligible(i) for i in range(n)]
        # statically known keys seed the snapshot + the async prefetch
        static_keys: list = []
        for i in range(n):
            static_keys.append(self.senders[i])
            if self.txs[i].to is not None:
                static_keys.append(self.txs[i].to)
            for addr, slots in self.txs[i].access_list:
                static_keys.append(addr)
                static_keys.extend((addr, s) for s in slots)
        for k in static_keys:
            (self.snap_accts if isinstance(k, bytes)
             else self.snap_slots).add(k)
        self.reader.request(static_keys)
        # ineligible ranks start their speculative (prewarm) run now
        for i in range(n):
            if not self.eligible[i]:
                self._submit_speculation(i)

        pos = 0
        while pos < n:
            if self.cancel_event is not None and self.cancel_event.is_set():
                raise ExecCancelled("forkchoice reorged away mid-wave")
            if not self.eligible[pos]:
                self._commit_python_rank(pos)
                pos += 1
                continue
            end = pos
            while end < n and self.eligible[end]:
                end += 1
            self._drain_pending_keys()
            t0 = time.time()
            with tracing.span("engine::optimistic", "exec.round",
                              lo=pos, hi=end):
                next_pos, stopper, stopper_grew = self._native_round(pos, end)
            tracing.record_span(
                "engine::optimistic", "exec.commit", t0, time.time() - t0,
                ctx=self._ctx,
                fields={"committed": next_pos - pos, "lo": pos})
            if next_pos < end:
                head = next_pos
                attempts = self._attempts.get(head, 0) + 1
                self._attempts[head] = attempts
                if (stopper is None or stopper["coinbase_sensitive"]
                        or not stopper_grew
                        or attempts > self.MAX_RETRIES):
                    self._demote(head)
            pos = next_pos

        requests = []
        if self.mode == "block":
            requests = self._requests_phase()
        self.com.apply_withdrawals(
            self.withdrawals if self.mode == "payload"
            else (self.block.withdrawals if self.block is not None else None))
        out = self.com.build_output(self.senders)
        out.requests = requests
        self.stats["prefetched"] = self.reader.prefetched
        self.stats["snapshot_keys"] = (len(self.snap_accts)
                                       + len(self.snap_slots))
        self.stats["wall_s"] = round(time.time() - t_start, 4)
        return out


# -- entry points -------------------------------------------------------------


def execute_block_optimistic(source: StateSource, block, senders,
                             config=None, max_workers: int | None = None,
                             state_hook=None, block_hashes=None,
                             cancel_event=None):
    """Execute ``block`` with the optimistic scheduler; output is
    bit-identical to ``BlockExecutor.execute`` (including system calls,
    EIP-7685 requests, and withdrawals). Returns ``(output, stats)``.
    Consensus-invalid transactions raise :class:`InvalidTransaction`
    exactly like the serial path; ANY other scheduler failure falls back
    to a full serial re-run (``stats["fallback"]`` records why).
    ``cancel_event`` set mid-run raises :class:`ExecCancelled` instead —
    a reorged-away block must not be re-run at all."""
    sched = None
    try:
        sched = OptimisticScheduler(
            source, block.transactions, senders, config=config,
            max_workers=max_workers, state_hook=state_hook, block=block,
            block_hashes=block_hashes, mode="block",
            cancel_event=cancel_event)
        out = sched.run()
        return out, sched.stats
    except InvalidTransaction:
        raise  # genuinely invalid block — identical to serial behavior
    except ExecCancelled:
        raise  # cooperative abort — never serial-re-run a dead head
    except BuildError:
        raise  # a failed g++ build of the native core is a fault
    except Exception as e:  # noqa: BLE001 — fallback ladder's last rung
        stats = dict(sched.stats) if sched is not None else {}
        stats["fallback"] = f"{type(e).__name__}: {e}"
        stats["mode"] = "serial-fallback"
        out = BlockExecutor(source, config).execute(
            block, senders, block_hashes, state_hook=state_hook)
        return out, stats
    finally:
        if sched is not None:
            sched.close()


def execute_candidates_optimistic(source: StateSource, env, transactions,
                                  senders, config=None,
                                  max_workers: int | None = None,
                                  withdrawals=None,
                                  blob_cap: int | None = None):
    """Payload-builder mode: execute a candidate list optimistically with
    the builder's greedy semantics — unexecutable candidates are SKIPPED
    (and reported for pool eviction), never block-invalidating; gas and
    blob caps gate at commit time in rank order. Returns
    ``(output, committed_indices, evicted_indices, blob_gas_used,
    stats)`` where output's receipts align with ``committed_indices``.
    Raises on scheduler failure — the builder keeps its serial loop as
    the fallback."""
    sched = OptimisticScheduler(
        source, transactions, senders, config=config,
        max_workers=max_workers, env=env, mode="payload",
        withdrawals=withdrawals, blob_cap=blob_cap)
    try:
        out = sched.run()
        return (out, sched.committed, sched.evicted, sched.blob_gas_used,
                sched.stats)
    finally:
        sched.close()
