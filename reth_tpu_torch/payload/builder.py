"""Block assembly from pool transactions.

A copy of the JAX package's ``payload/builder.py`` on the port's engine tree,
EVM and committers: the sealed block's state root is the tree's incremental
root job (``EngineTree._state_root_job``, key hashing on kernel 1), and its
transactions, receipts and withdrawals roots are ordered tries on the
committer's ``"payload"`` lane (kernel 1 through ``KeccakDevice`` on the
card by default).

One departure: no catch-all swallows a kernel fault. Where the reference
falls back on any exception (``_build_parallel`` to the serial loop, the
payload job's first build to an empty payload, its producer seal to the
one-shot build, a rebuild to the current best), a cause for which
``ops/_build.is_kernel_fault`` is true (a ``BuildError``, a ``LaunchError``,
a CUDA error, or one of them on the ``__cause__`` chain) raises instead; a
rebuild's fault on the job's own thread raises out of ``resolve``. Any other
cause keeps the reference's fallback and is counted
(``PayloadJob.fallbacks``, ``producer_metrics.record_fallback``). ``stats=``
receives a build's walls: selection and execution, state root, ordered
roots.

Reference analogue: `EthereumPayloadBuilder::try_build`
(crates/ethereum/payload/src/lib.rs) — pull `best_transactions`, execute
greedily under the gas limit, skip invalid txs, seal with real roots.
The built block is re-validated when the CL returns it via newPayload
(same trust model as the reference).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass

from ..consensus.validation import calc_next_base_fee
from .. import tracing
from ..engine.tree import EngineTree
from ..evm import BlockExecutor
from ..evm.executor import InvalidTransaction, ProviderStateSource
from ..evm.interpreter import BlockEnv
from ..evm.state import EvmState
from ..metrics import producer_metrics
from ..ops._build import is_kernel_fault
from ..primitives.rlp import rlp_encode
from ..primitives.types import Block, Header, Receipt, Transaction, Withdrawal, logs_bloom
from ..storage.overlay import OverlayTx
from ..storage.provider import DatabaseProvider
from ..trie.state_root import ordered_trie_root


@dataclass
class PayloadAttributes:
    """engine_forkchoiceUpdated payload attributes (V2/V3 shape)."""

    timestamp: int
    prev_randao: bytes = b"\x00" * 32
    suggested_fee_recipient: bytes = b"\x00" * 20
    withdrawals: tuple[Withdrawal, ...] = ()
    parent_beacon_block_root: bytes | None = None


def payload_env(tree: EngineTree, parent: Header, attrs: PayloadAttributes,
                gas_ceiling: int | None = None):
    """Fee-market + block-env context for a child of ``parent``; returns
    ``(env, base_fee, cancun, excess_blob, blob_params)``. Shared by the
    one-shot builder below and the continuous producer (producer.py),
    which must price candidates identically or its incremental candidate
    diverges from the serial greedy build."""
    from ..evm.executor import blob_base_fee, next_excess_blob_gas

    base_fee = calc_next_base_fee(parent)
    blob_params = tree.config.blob_params_for(parent.number + 1, attrs.timestamp)
    # EIP-4844: blob fields continue once the parent carries them
    cancun = parent.excess_blob_gas is not None
    excess_blob = (
        next_excess_blob_gas(parent.excess_blob_gas, parent.blob_gas_used or 0,
                             blob_params.target_gas)
        if cancun else 0
    )
    # gas target moves toward the miner's ceiling by at most 1/1024 per
    # block (protocol rule the reference's gas-limit knob follows)
    gas_limit = parent.gas_limit
    if gas_ceiling is not None and gas_ceiling != gas_limit:
        step = max(1, parent.gas_limit // 1024 - 1)
        gas_limit = (min(gas_limit + step, gas_ceiling) if gas_ceiling > gas_limit
                     else max(gas_limit - step, gas_ceiling, 5000))
    env = BlockEnv(
        number=parent.number + 1,
        timestamp=attrs.timestamp,
        coinbase=attrs.suggested_fee_recipient,
        gas_limit=gas_limit,
        base_fee=base_fee,
        prev_randao=attrs.prev_randao,
        chain_id=tree.config.chain_id,
        blob_base_fee=blob_base_fee(excess_blob, blob_params.update_fraction),
    )
    return env, base_fee, cancun, excess_blob, blob_params


def build_payload(
    tree: EngineTree,
    pool,
    parent_hash: bytes,
    attrs: PayloadAttributes,
    extra_data: bytes = b"",
    gas_ceiling: int | None = None,
    stats: dict | None = None,
) -> Block:
    """Assemble a sealed block on top of ``parent_hash``; returns
    (block, total priority fees). ``pool=None`` builds the empty-payload
    fallback (reference BasicPayloadJob's pre-built empty payload)."""
    t0 = time.perf_counter()
    overlay = tree.overlay_provider(parent_hash)
    parent_num = overlay.block_number(parent_hash)
    parent = overlay.header_by_number(parent_num)
    env, base_fee, cancun, excess_blob, blob_params = payload_env(
        tree, parent, attrs, gas_ceiling)
    executor = BlockExecutor(ProviderStateSource(overlay), tree.config)
    state = EvmState(executor.source)
    selected: list[Transaction] = []
    receipts: list[Receipt] = []
    cumulative_gas = 0
    blob_gas_used = 0
    total_fees = 0
    # --parallel-exec: execute the candidate list through the optimistic
    # scheduler (engine/optimistic.py payload mode) — speculative parallel
    # first attempts, in-order validation, builder-semantics skips for
    # unexecutable candidates. Any scheduler failure falls back to the
    # serial greedy loop below (same selection, just slower).
    if pool is not None and getattr(tree, "parallel_exec", False):
        built = _build_parallel(tree, pool, overlay, env, base_fee,
                                cancun, blob_params, attrs)
        if built is not None:
            selected, out_mini, cumulative_gas, blob_gas_used, total_fees = built
            if stats is not None:
                stats["select_s"] = time.perf_counter() - t0
            return _seal(tree, overlay, parent_hash, attrs, env, extra_data,
                         selected, out_mini, cumulative_gas, blob_gas_used,
                         excess_blob, cancun, base_fee, total_fees, stats)
    with tracing.span("payload::builder", "payload.select"):
        failed_senders: set[bytes] = set()
        txs_iter = pool.best_transactions(base_fee) if pool is not None else ()
        for tx in txs_iter:
            if cumulative_gas + tx.gas_limit > env.gas_limit:
                continue
            if tx.blob_gas() and (
                not cancun or blob_gas_used + tx.blob_gas() > blob_params.max_gas
            ):
                continue
            try:
                sender = tx.recover_sender()
                if sender in failed_senders:
                    continue  # descendant of an evicted tx: nonce-gapped now
                result = executor._execute_tx(
                    state, env, tx, sender, env.gas_limit - cumulative_gas
                )
            except (InvalidTransaction, ValueError):
                # provably unexecutable against this state: evict it (reference
                # mark_invalid), or an instant-seal miner re-selects it forever;
                # later nonces of the same sender are skipped but kept pooled
                try:
                    failed_senders.add(tx.recover_sender())
                except ValueError:
                    pass
                if pool is not None:
                    pool.remove_invalid(tx.hash)
                continue
            cumulative_gas += result.gas_used
            blob_gas_used += tx.blob_gas()
            total_fees += result.gas_used * max(0, tx.effective_gas_price(base_fee) - base_fee)
            selected.append(tx)
            receipts.append(Receipt(
                tx_type=tx.tx_type, success=result.success,
                cumulative_gas_used=cumulative_gas, logs=result.receipt.logs,
            ))
        # withdrawals
        for w in attrs.withdrawals:
            if w.amount:
                state._capture_account_change(w.address)
                state.add_balance(w.address, w.amount * 10**9)

    post_accounts, post_storage = state.final_state()
    out = _MiniOutput(state.changes, post_accounts, post_storage, receipts)
    if stats is not None:
        stats["select_s"] = time.perf_counter() - t0
    return _seal(tree, overlay, parent_hash, attrs, env, extra_data,
                 selected, out, cumulative_gas, blob_gas_used, excess_blob,
                 cancun, base_fee, total_fees, stats)


def _build_parallel(tree, pool, overlay, env, base_fee, cancun, blob_params,
                    attrs):
    """Candidate selection through the optimistic scheduler; returns
    ``(selected, mini_output, cumulative_gas, blob_gas_used, total_fees)``
    or None (caller falls back to the serial greedy loop)."""
    try:
        from ..engine.optimistic import execute_candidates_optimistic
        from ..primitives.types import recover_senders

        candidates = list(pool.best_transactions(base_fee))
        if len(candidates) < 4:
            return None
        rec = recover_senders(candidates)
        txs, senders = [], []
        for tx, s in zip(candidates, rec):
            if s is None:
                pool.remove_invalid(tx.hash)
                continue
            txs.append(tx)
            senders.append(s)
        out, committed, evicted, blob_gas_used, _stats = \
            execute_candidates_optimistic(
                ProviderStateSource(overlay), env, txs, senders,
                tree.config, max_workers=getattr(tree, "exec_workers", None),
                withdrawals=attrs.withdrawals,
                blob_cap=blob_params.max_gas if cancun else None)
        for i in evicted:
            pool.remove_invalid(txs[i].hash)
        selected = [txs[i] for i in committed]
        total_fees = 0
        prev = 0
        for i, r in zip(committed, out.receipts):
            gas_used = r.cumulative_gas_used - prev
            prev = r.cumulative_gas_used
            total_fees += gas_used * max(
                0, txs[i].effective_gas_price(base_fee) - base_fee)
        mini = _MiniOutput(out.changes, out.post_accounts, out.post_storage,
                           out.receipts)
        return selected, mini, out.gas_used, blob_gas_used, total_fees
    except Exception as e:  # noqa: BLE001 — the serial loop is the fallback
        if is_kernel_fault(e):
            raise
        producer_metrics.record_fallback("parallel_build")
        return None


def _seal(tree, overlay, parent_hash, attrs, env, extra_data, selected, out,
          cumulative_gas, blob_gas_used, excess_blob, cancun, base_fee,
          total_fees, stats: dict | None = None):
    """State root + header assembly shared by the serial and parallel
    selection paths (the sealed block is identical either way)."""
    parent_num = overlay.block_number(parent_hash)
    parent = overlay.header_by_number(parent_num)
    receipts = out.receipts
    t0 = time.perf_counter()
    # state root over a scratch overlay (not retained; newPayload re-derives)
    with tracing.span("payload::builder", "payload.state_root"):
        scratch = DatabaseProvider(OverlayTx(tree.factory.db.tx(),
                                             tree._chain_layers(parent_hash), {}))
        root = tree._state_root_job(scratch, out)
    t1 = time.perf_counter()

    # payload-build hashing rides its own hash-service lane (below live,
    # above rebuild/proof): an improvement-loop rebuild coalesces with but
    # never delays the canonical tip's root job
    committer = (tree.committer.for_lane("payload")
                 if hasattr(tree.committer, "for_lane") else tree.committer)
    with tracing.span("payload::builder", "payload.ordered_roots"):
        transactions_root = ordered_trie_root([t.encode() for t in selected], committer)
        receipts_root = ordered_trie_root([r.encode_2718() for r in receipts], committer)
        withdrawals_root = ordered_trie_root(
            [rlp_encode(w.rlp_fields()) for w in attrs.withdrawals], committer)
    if stats is not None:
        stats.update(state_root_s=t1 - t0, ordered_roots_s=time.perf_counter() - t1)
    header = Header(
        parent_hash=parent_hash,
        beneficiary=attrs.suggested_fee_recipient,
        state_root=root,
        transactions_root=transactions_root,
        receipts_root=receipts_root,
        logs_bloom=logs_bloom([l for r in receipts for l in r.logs]),
        number=parent.number + 1,
        gas_limit=env.gas_limit,
        gas_used=cumulative_gas,
        timestamp=attrs.timestamp,
        extra_data=extra_data,
        mix_hash=attrs.prev_randao,
        base_fee_per_gas=base_fee,
        withdrawals_root=withdrawals_root,
        blob_gas_used=blob_gas_used if cancun else None,
        excess_blob_gas=excess_blob if cancun else None,
        parent_beacon_block_root=attrs.parent_beacon_block_root,
    )
    return Block(header, tuple(selected), (), tuple(attrs.withdrawals)), total_fees


@dataclass
class _MiniOutput:
    changes: object
    post_accounts: dict
    post_storage: dict
    receipts: list


class PayloadJob:
    """One deadline-driven payload build (reference BasicPayloadJob,
    crates/payload/basic/src/lib.rs:366).

    The first FULL build happens synchronously (so an immediate
    getPayload already carries transactions); an improvement loop then
    re-builds until the deadline and swaps in a payload ONLY when it
    pays more fees. If the full build fails, the empty-payload fallback
    keeps the job resolvable (a slot must never go blockless), unless the
    failure is a kernel fault, which raises out of the constructor; a
    rebuild's kernel fault on the improvement thread raises out of
    ``resolve``. ``fallbacks`` counts the fallbacks taken."""

    def __init__(self, tree, pool, parent_hash, attrs, lock, deadline: float,
                 interval: float, extra_data: bytes = b"",
                 gas_ceiling: int | None = None, producer=None):
        self.tree = tree
        self.pool = pool
        self.parent_hash = parent_hash
        self.attrs = attrs
        self.lock = lock
        self.deadline = time.monotonic() + deadline
        self.interval = interval
        self.extra_data = extra_data
        self.gas_ceiling = gas_ceiling
        self.producer = producer
        self.best: Block | None = None
        self.best_fees: int = -1
        self.rebuilds = 0
        self.fallbacks = 0
        self.fault: BaseException | None = None  # a rebuild's kernel fault
        self.last_stats: dict = {}
        self._resolved = threading.Event()
        with self.lock:
            try:
                self.best, self.best_fees = self._build_once()
            except Exception as e:  # noqa: BLE001 — fall back to an empty payload
                if is_kernel_fault(e):
                    raise
                self._fallback("job_empty")
                self.best, self.best_fees = build_payload(
                    tree, None, parent_hash, attrs,
                    extra_data=extra_data, gas_ceiling=gas_ceiling,
                )
        self._thread = threading.Thread(target=self._improve_loop, daemon=True)
        self._thread.start()

    def _fallback(self, site: str) -> None:
        self.fallbacks += 1
        producer_metrics.record_fallback(site)

    def _build_once(self):
        """One full build: seal the continuous producer's hot candidate
        when one is attached (incremental refresh, no re-execution on a
        hot hit), else the one-shot serial/parallel builder."""
        if self.producer is not None:
            try:
                return self.producer.take(
                    self.parent_hash, self.attrs, extra_data=self.extra_data,
                    gas_ceiling=self.gas_ceiling)
            except Exception as e:  # noqa: BLE001 — the one-shot builder is
                if is_kernel_fault(e):  # always the fallback
                    raise
                self._fallback("job_producer")
        self.last_stats = {}
        return build_payload(self.tree, self.pool, self.parent_hash,
                             self.attrs, extra_data=self.extra_data,
                             gas_ceiling=self.gas_ceiling, stats=self.last_stats)

    def rebuild(self) -> bool:
        """One re-build; swaps only a strictly better payload. Returns
        whether the swap happened."""
        with self.lock:
            if self._resolved.is_set():
                return False
            try:
                block, fees = self._build_once()
            except Exception as e:  # noqa: BLE001 — keep the current best
                if is_kernel_fault(e):
                    raise
                self._fallback("job_rebuild")
                return False
            self.rebuilds += 1
            if fees > self.best_fees:
                self.best, self.best_fees = block, fees
                return True
            return False

    def _improve_loop(self) -> None:
        while not self._resolved.is_set() and time.monotonic() < self.deadline:
            if self._resolved.wait(self.interval):
                return
            try:
                self.rebuild()
            except Exception as e:  # noqa: BLE001 — rebuild re-raises only
                self.fault = e      # kernel faults: resolve() raises it
                return

    def resolve(self) -> Block | None:
        self._resolved.set()
        if self.fault is not None:
            raise self.fault
        return self.best


class PayloadBuilderService:
    """payload_id → deadline-driven job (reference PayloadBuilderService).

    Bounded: only the newest ``MAX_JOBS`` jobs are retained (reference
    jobs resolve/expire; a CL issues one per slot)."""

    MAX_JOBS = 16

    def __init__(self, tree: EngineTree, pool, lock=None,
                 deadline: float = 2.0, interval: float = 0.25,
                 producer=None):
        self.tree = tree
        self.pool = pool
        self.lock = lock or threading.RLock()
        self.deadline = deadline
        self.interval = interval
        self.producer = producer
        # miner_ knobs (rpc/miner.py): stamped into every subsequent job
        self.extra_data: bytes = b""
        self.gas_ceiling: int | None = None
        self.jobs: dict[bytes, PayloadJob] = {}

    def new_payload_job(self, parent_hash: bytes, attrs: PayloadAttributes) -> bytes:
        payload_id = os.urandom(8)
        self.jobs[payload_id] = PayloadJob(
            self.tree, self.pool, parent_hash, attrs, self.lock,
            self.deadline, self.interval,
            extra_data=self.extra_data, gas_ceiling=self.gas_ceiling,
            producer=self.producer,
        )
        while len(self.jobs) > self.MAX_JOBS:
            self.jobs.pop(next(iter(self.jobs))).resolve()
        return payload_id

    def get_payload(self, payload_id: bytes) -> Block | None:
        block, _fees = self.get_payload_with_fees(payload_id)
        return block

    def get_payload_with_fees(self, payload_id: bytes) -> tuple[Block | None, int]:
        """Resolve the job: (best block, its total priority fees) — the
        fees become the engine response's blockValue."""
        job = self.jobs.get(payload_id)
        if job is None:
            return None, 0
        return job.resolve(), max(job.best_fees, 0)
