"""The eth_* namespace.

A copy of the JAX package's ``rpc/eth.py`` on the port's engine tree, pool
and proofs. ``eth_getProof`` runs ``ProofCalculator`` on the tree's
committer (kernel 1 on the card), or a ``ProofWorkerPool`` above
``SLOT_SPLIT_MIN`` slots; ``eth_simulateV1`` roots its blocks there too.

Reference analogue: crates/rpc/rpc-eth-api trait stack + crates/rpc/rpc
eth module. Serves state from the engine tree's canonical overlay
(pending blocks included), the pool, and the DB.
"""

from __future__ import annotations

from ..engine.tree import EngineTree
from ..evm import BlockExecutor
from ..evm.executor import ProviderStateSource
from ..evm.interpreter import BlockEnv, CallFrame, Interpreter, Revert, TxEnv
from ..evm.spec import LATEST_SPEC
from ..evm.state import EvmState
from ..primitives.types import KECCAK_EMPTY, Transaction
from .convert import (
    block_to_rpc,
    data,
    parse_data,
    parse_qty,
    qty,
    receipt_to_rpc,
    tx_to_rpc,
)
from .server import RpcError


class EthApi:
    def __init__(self, tree: EngineTree, pool=None, chain_id: int = 1,
                 tx_batcher=None):
        from .gas_oracle import GasPriceOracle
        from .state_cache import EthStateCache

        self.tree = tree
        self.pool = pool
        self.tx_batcher = tx_batcher
        self.chain_id = chain_id
        self.gas_oracle = GasPriceOracle()
        self.state_cache = EthStateCache()

    # -- helpers ---------------------------------------------------------------

    def _provider(self):
        return self.tree.overlay_provider()

    def _resolve_number(self, tag, p) -> int:
        if tag in (None, "latest", "pending", "safe", "finalized"):
            return p.last_block_number()
        if tag == "earliest":
            return 0
        return parse_qty(tag)

    def _state_at(self, tag):
        """State view at a block tag: the live overlay for the tip, a
        history-index-backed view for older blocks.

        Rejects: unknown (future) blocks, blocks newer than the history
        index covers (the unindexed in-memory window), and blocks below
        the history prune horizon — never silently serves tip state."""
        p = self._provider()
        n = self._resolve_number(tag, p)
        tip = p.last_block_number()
        if n == tip:
            return p
        if n > tip:
            raise RpcError(-32000, f"unknown block {n} (tip {tip})")
        from ..storage.tables import Tables, from_be64

        for seg in (b"AccountHistory", b"StorageHistory"):
            raw = p.tx.get(Tables.PruneCheckpoints.name, seg)
            if raw is not None and n < from_be64(raw):
                raise RpcError(-32000, f"historical state pruned below {from_be64(raw)}")
        from ..storage.historical import HistoricalStateProvider

        return HistoricalStateProvider(p, n)

    # -- chain meta ------------------------------------------------------------

    def eth_chainId(self):
        return qty(self.chain_id)

    def eth_blockNumber(self):
        return qty(self._provider().last_block_number())

    def eth_syncing(self):
        return False

    def eth_gasPrice(self):
        return qty(self.gas_oracle.suggest_gas_price(self._provider()))

    def eth_maxPriorityFeePerGas(self):
        return qty(self.gas_oracle.suggest_tip_cap(self._provider()))

    def eth_feeHistory(self, block_count, newest_tag="latest", reward_percentiles=None):
        p = self._provider()
        newest = self._resolve_number(newest_tag, p)
        tip = p.last_block_number()
        if newest > tip:
            raise RpcError(-32000, f"unknown block {newest} (tip {tip})")
        count = min(parse_qty(block_count), newest + 1, 1024)
        if count < 1:
            raise RpcError(-32602, "block count must be >= 1")
        oldest = newest - count + 1
        base_fees, ratios, rewards = [], [], []
        for n in range(oldest, newest + 1):
            h = p.header_by_number(n)
            base_fees.append(qty(h.base_fee_per_gas or 0))
            ratios.append(h.gas_used / h.gas_limit if h.gas_limit else 0.0)
            if reward_percentiles:
                tips = sorted(
                    tx.effective_gas_price(h.base_fee_per_gas) - (h.base_fee_per_gas or 0)
                    for tx in (p.transactions_by_block(n) or [])
                ) or [0]
                rewards.append([
                    qty(tips[min(len(tips) - 1, int(pc / 100 * len(tips)))])
                    for pc in reward_percentiles
                ])
        from ..consensus.validation import calc_next_base_fee

        base_fees.append(qty(calc_next_base_fee(p.header_by_number(newest))))
        out = {
            "oldestBlock": qty(oldest),
            "baseFeePerGas": base_fees,
            "gasUsedRatio": ratios,
        }
        if reward_percentiles:
            out["reward"] = rewards
        return out

    # -- state -----------------------------------------------------------------

    def eth_getAccount(self, address, tag="latest"):
        """Full account object in one call (reference eth_getAccount,
        rpc-eth-api/src/core.rs): balance, nonce, codeHash, storageRoot."""
        from ..primitives.keccak import keccak256
        from ..primitives.types import Account

        p = self._state_at(tag)
        addr = parse_data(address)
        acct = p.account(addr) or Account()
        # the CURRENT storage root is merkle-layer-owned and lives in
        # HashedAccounts (provider.put_hashed_account contract); the plain
        # account's field is an execution-time placeholder
        storage_root = acct.storage_root
        hashed_fn = getattr(p, "hashed_account", None)
        if hashed_fn is not None:
            hashed = hashed_fn(keccak256(addr))
            if hashed is not None:
                storage_root = hashed.storage_root
        return {"balance": qty(acct.balance), "nonce": qty(acct.nonce),
                "codeHash": data(acct.code_hash),
                "storageRoot": data(storage_root)}

    def eth_getBalance(self, address, tag="latest"):
        p = self._state_at(tag)
        acc = p.account(parse_data(address))
        return qty(acc.balance if acc else 0)

    def eth_getTransactionCount(self, address, tag="latest"):
        addr = parse_data(address)
        if tag == "pending" and self.pool is not None:
            return qty(self.pool.pooled_nonce(addr))
        p = self._state_at(tag)
        acc = p.account(addr)
        return qty(acc.nonce if acc else 0)

    def eth_getCode(self, address, tag="latest"):
        p = self._state_at(tag)
        acc = p.account(parse_data(address))
        if acc is None:
            return "0x"
        return data(p.bytecode(acc.code_hash) or b"")

    def eth_getStorageAt(self, address, slot, tag="latest"):
        p = self._state_at(tag)
        v = p.storage(parse_data(address), parse_qty(slot).to_bytes(32, "big"))
        return data(v.to_bytes(32, "big"))

    def eth_getProof(self, address, slots, tag="latest"):
        from ..storage.historical import HistoricalStateProvider
        from ..trie.proof import ProofCalculator, ProofWorkerPool

        p = self._state_at(tag)
        if isinstance(p, HistoricalStateProvider):
            raise RpcError(-32000, "proofs are served for the latest block only")
        addr = parse_data(address)
        keys = [parse_qty(s).to_bytes(32, "big") for s in slots]
        if len(keys) > ProofWorkerPool.SLOT_SPLIT_MIN:
            # big slot lists shard across the proof-worker pool (each
            # worker walks its slot chunk on its own state view, pinned
            # to the head resolved NOW so an advancing tip cannot mix
            # states) instead of one serial plan_subtrie pass
            head = self.tree.head_hash
            pool = ProofWorkerPool(
                lambda: ProofCalculator(self.tree.overlay_provider(head),
                                        self.tree.committer))
            try:
                proof = pool.multiproof({addr: keys})[addr]
            finally:
                pool.shutdown()
        else:
            proof = ProofCalculator(p, self.tree.committer).account_proof(
                addr, keys)
        acc = proof.account
        return {
            "address": address,
            "accountProof": [data(n) for n in proof.proof],
            "balance": qty(acc.balance if acc else 0),
            "nonce": qty(acc.nonce if acc else 0),
            "codeHash": data(acc.code_hash if acc else KECCAK_EMPTY),
            "storageHash": data(proof.storage_root),
            "storageProof": [
                {
                    "key": data(sp.key),
                    "value": qty(sp.value),
                    "proof": [data(n) for n in sp.proof],
                }
                for sp in proof.storage_proofs
            ],
        }

    # -- blocks ----------------------------------------------------------------

    def eth_getBlockByNumber(self, tag, full=False):
        p = self._provider()
        n = self._resolve_number(tag, p)
        cached = self.state_cache.block_with_senders(p, n)
        if cached is None:
            return None
        block, senders = cached
        return block_to_rpc(block, full, senders if full else None)

    def eth_getBlockByHash(self, block_hash, full=False):
        p = self._provider()
        n = p.block_number(parse_data(block_hash))
        if n is None:
            return None
        return self.eth_getBlockByNumber(qty(n), full)

    def eth_getBlockTransactionCountByNumber(self, tag):
        p = self._provider()
        idx = p.block_body_indices(self._resolve_number(tag, p))
        return qty(idx.tx_count if idx else 0)

    # -- transactions ----------------------------------------------------------

    def eth_getTransactionByHash(self, tx_hash):
        h = parse_data(tx_hash)
        if self.pool is not None:
            tx = self.pool.get(h)
            if tx is not None:
                return tx_to_rpc(tx)
        p = self._provider()
        from ..storage.tables import Tables, from_be64

        raw = p.tx.get(Tables.TransactionHashNumbers.name, h)
        if raw is None:
            return None
        tx_num = from_be64(raw)
        block_num = self._block_of_tx(p, tx_num)
        if block_num is None:
            return None
        header = p.header_by_number(block_num)
        idx = p.block_body_indices(block_num)
        txs = p.transactions_by_block(block_num)
        i = tx_num - idx.first_tx_num
        return tx_to_rpc(txs[i], header, i, p.sender(tx_num))

    def _block_of_tx(self, p, tx_num: int) -> int | None:
        # TransactionBlocks: be64(last_tx_num_of_block) -> be64(block);
        # seek gives the first block whose last tx >= tx_num (O(log n))
        from ..storage.tables import Tables, be64, from_be64

        cur = p.tx.cursor(Tables.TransactionBlocks.name)
        entry = cur.seek(be64(tx_num))
        if entry is not None:
            n = from_be64(entry[1])
            idx = p.block_body_indices(n)
            if idx and idx.first_tx_num <= tx_num < idx.next_tx_num:
                return n
        return None

    def eth_getTransactionReceipt(self, tx_hash):
        h = parse_data(tx_hash)
        p = self._provider()
        from ..storage.tables import Tables, from_be64

        raw = p.tx.get(Tables.TransactionHashNumbers.name, h)
        if raw is None:
            return None
        tx_num = from_be64(raw)
        block_num = self._block_of_tx(p, tx_num)
        if block_num is None:
            return None
        header = p.header_by_number(block_num)
        idx = p.block_body_indices(block_num)
        i = tx_num - idx.first_tx_num
        receipt = p.receipt(tx_num)
        if receipt is None:
            return None
        prev = p.receipt(tx_num - 1).cumulative_gas_used if i > 0 else 0
        log_base = 0
        for t in range(idx.first_tx_num, tx_num):
            log_base += len(p.receipt(t).logs)
        txs = p.transactions_by_block(block_num)
        return receipt_to_rpc(receipt, txs[i], header, i, prev, p.sender(tx_num), log_base)

    def eth_getBlockReceipts(self, tag):
        p = self._provider()
        n = self._resolve_number(tag, p)
        cached = self.state_cache.block_with_senders(p, n)
        if cached is None:
            return None
        block, senders = cached
        if not block.transactions:
            return []
        receipts = self.state_cache.receipts(p, n)
        if receipts is None:
            return None
        out = []
        log_base = 0
        prev_cum = 0
        for i, (tx, receipt) in enumerate(zip(block.transactions, receipts)):
            out.append(receipt_to_rpc(receipt, tx, block.header, i, prev_cum,
                                      senders[i], log_base))
            prev_cum = receipt.cumulative_gas_used
            log_base += len(receipt.logs)
        return out

    def eth_getTransactionByBlockNumberAndIndex(self, tag, index):
        p = self._provider()
        n = self._resolve_number(tag, p)
        idx = p.block_body_indices(n)
        i = parse_qty(index)
        if idx is None or i >= idx.tx_count:
            return None
        txs = p.transactions_by_block(n)
        return tx_to_rpc(txs[i], p.header_by_number(n), i, p.sender(idx.first_tx_num + i))

    def eth_accounts(self):
        return []

    def eth_sendRawTransaction(self, raw):
        # (marked _lockfree below: pool/batcher carry their own locks)
        if self.pool is None:
            raise RpcError(-32000, "no transaction pool")
        tx = Transaction.decode(parse_data(raw))
        from ..pool import PoolError, PoolOverloaded

        try:
            # through the insertion batcher when the node wired one:
            # validation (sender recovery) runs batched off this thread
            if self.tx_batcher is not None:
                h = self.tx_batcher.add_sync(tx)
            else:
                h = self.pool.add_transaction(tx)
        except PoolOverloaded as e:
            # firehose backpressure rides the gateway's shed convention
            # (-32005 + retry_after) so clients back off instead of
            # retrying hot — and the bounded admission queue never grows
            # into engine-lane starvation
            raise RpcError(-32005, "transaction pool overloaded",
                           data={"class": "tx",
                                 "retry_after": e.retry_after_s})
        except PoolError as e:
            raise RpcError(-32000, str(e))
        except TimeoutError as e:
            raise RpcError(-32000, f"tx submission timed out: {e}")
        return data(h)

    eth_sendRawTransaction._lockfree = True

    # -- execution (read-only) ---------------------------------------------------

    def _call_env(self, tag="latest"):
        """Execution env for eth_call at ``tag``: the REQUESTED block's
        number/timestamp/basefee, so state and env are consistent."""
        p = self._provider()
        n = self._resolve_number(tag, p)
        header = p.header_by_number(min(n, p.last_block_number()))
        return BlockEnv(
            number=header.number,
            timestamp=header.timestamp,
            coinbase=header.beneficiary,
            gas_limit=header.gas_limit,
            base_fee=header.base_fee_per_gas or 0,
            prev_randao=header.mix_hash,
            chain_id=self.chain_id,
        )

    @staticmethod
    def _build_call_frame(call, state, env) -> CallFrame:
        """One place that maps an eth_call-style dict to a CallFrame
        (from/to/data-or-input/value/gas) — eth_call, eth_estimateGas,
        eth_createAccessList, and eth_simulateV1 all share it."""
        sender = parse_data(call.get("from", "0x" + "00" * 20))
        to = parse_data(call["to"]) if call.get("to") else None
        return CallFrame(
            caller=sender,
            address=to or b"\x00" * 20,
            code=state.code(to) if to else b"",
            data=parse_data(call.get("data", call.get("input", "0x"))),
            value=parse_qty(call.get("value", "0x0")),
            gas=parse_qty(call.get("gas", hex(env.gas_limit))),
        )

    def eth_call(self, call, tag="latest"):
        p = self._state_at(tag)
        env = self._call_env(tag)
        state = EvmState(ProviderStateSource(p))
        interp = Interpreter(state, env, TxEnv(origin=parse_data(call.get("from", "0x" + "00" * 20))))
        frame = self._build_call_frame(call, state, env)
        try:
            ok, _gas_left, out = interp.call(frame)
        except Revert as r:
            raise RpcError(3, "execution reverted: 0x" + r.output.hex())
        if not ok:
            raise RpcError(-32000, "execution failed")
        return data(out)

    def eth_estimateGas(self, call, tag="latest"):
        p = self._state_at(tag)
        env = self._call_env(tag)
        sender = parse_data(call.get("from", "0x" + "00" * 20))
        state = EvmState(ProviderStateSource(p))
        interp = Interpreter(state, env, TxEnv(origin=sender))
        frame = self._build_call_frame(call, state, env)
        to, gas = frame.address if call.get("to") else None, frame.gas
        try:
            ok, gas_left, _ = interp.call(frame)
        except Revert:
            raise RpcError(3, "execution reverted")
        if not ok:
            raise RpcError(-32000, "execution failed")
        from ..evm.executor import intrinsic_gas

        used = gas - gas_left
        fake_tx = Transaction(to=to, data=parse_data(call.get("data", call.get("input", "0x"))))
        return qty(used + intrinsic_gas(fake_tx) + used // 16)


    def eth_blobBaseFee(self, tag="latest"):
        """Blob base fee at the requested block (reference eth_blobBaseFee,
        crates/rpc/rpc-eth-api/src/core.rs)."""
        from ..evm.executor import blob_base_fee

        p = self._provider()
        n = self._resolve_number(tag, p)
        header = p.header_by_number(min(n, p.last_block_number()))
        params = self.tree.config.blob_params_for(header.number, header.timestamp)
        return qty(blob_base_fee(header.excess_blob_gas or 0,
                                 params.update_fraction))

    def eth_createAccessList(self, call, tag="latest"):
        """EIP-2930 access-list generation: run the call and report every
        account/slot it warmed beyond the mandatory warm set (reference
        eth_createAccessList, rpc-eth-api/src/helpers/call.rs)."""
        p = self._state_at(tag)
        env = self._call_env(tag)
        sender = parse_data(call.get("from", "0x" + "00" * 20))

        class _AccessRecorder(EvmState):
            """Warm-set recording that SURVIVES journal rollback: a
            reverting call is this API's main use case, and the plain
            warm sets are wiped by the revert."""

            def __init__(self, src):
                super().__init__(src)
                self.rec_accounts: set = set()
                self.rec_slots: set = set()

            def warm_account(self, address):
                self.rec_accounts.add(address)
                return super().warm_account(address)

            def warm_slot(self, address, slot):
                self.rec_slots.add((address, slot))
                return super().warm_slot(address, slot)

        state = _AccessRecorder(ProviderStateSource(p))
        interp = Interpreter(state, env, TxEnv(origin=sender))
        frame = self._build_call_frame(call, state, env)
        to, gas = frame.address if call.get("to") else None, frame.gas
        try:
            ok, gas_left, _out = interp.call(frame)
        except Revert as r:
            ok, gas_left = False, getattr(r, "gas_left", 0)
        # mandatory-warm entries (sender, target, coinbase, precompiles)
        # never belong in the list (EIP-2930 semantics)
        skip = {sender, to, env.coinbase} | {
            (0).to_bytes(19, "big") + bytes([i]) for i in range(1, 11)}
        per_addr: dict[bytes, list[bytes]] = {}
        for a, s in sorted(state.rec_slots):
            per_addr.setdefault(a, []).append(s)
        access = [
            {"address": data(a),
             "storageKeys": [data(s) for s in per_addr.get(a, [])]}
            for a in sorted(set(state.rec_accounts) | set(per_addr))
            if a not in skip or a in per_addr
        ]
        return {"accessList": access, "gasUsed": qty(gas - gas_left),
                "error": None if ok else "execution failed"}

    def eth_simulateV1(self, payload, tag="latest"):
        """Simulate chains of call-blocks on top of the requested state
        (reference eth_simulateV1, rpc-eth-api/src/core.rs:245 +
        rpc-eth-types/src/simulate.rs). Each entry seals a REAL block:
        calls become typed transactions executed through the block
        executor under the active fork's rules (system calls included),
        and the result is a full RPC block — receiptsRoot/logsBloom/
        gasUsed always, stateRoot recomputed by the trie pipeline when
        the base is the canonical tip (elsewhere it is zero, like the
        reference's optional root computation). ``validation`` enforces
        nonce/fee rules; without it nonces auto-fill, base fee is zero
        and EIP-3607 is off (reference disables the same CfgEnv checks).
        Gaps in `blockOverrides.number` are filled with empty blocks per
        the execution-apis spec. ``returnFullTransactions`` switches the
        block's tx list from hashes to objects."""
        import hashlib
        from dataclasses import replace as _dc_replace

        from ..consensus.validation import calc_next_base_fee
        from ..evm import BlockExecutor
        from ..evm.executor import InvalidTransaction
        from ..primitives.types import (
            Account, Block, EMPTY_ROOT_HASH, Header, Transaction, logs_bloom,
        )
        from ..stages.execution import write_execution_output
        from ..trie.state_root import ordered_trie_root
        from .convert import block_to_rpc

        entries = payload.get("blockStateCalls") or []
        if not entries:
            raise RpcError(-32602, "calls are empty")
        if len(entries) > 256:
            raise RpcError(-32602, "too many blocks")
        validation = bool(payload.get("validation"))
        full_txs = bool(payload.get("returnFullTransactions"))

        p0 = self._provider()
        base_n = self._resolve_number(tag, p0)
        compute_roots = base_n == p0.last_block_number()
        # a dedicated overlay accumulates the simulated chain's writes so
        # the incremental committer can root every simulated block
        overlay = self._provider() if compute_roots else None
        parent = p0.header_by_number(base_n)

        from ..evm.state import StateSource

        # execution state: post-state folded over the base view per block
        class _Folded(StateSource):
            def __init__(self, base):
                self.base = base
                self.accounts: dict = {}
                self.storages: dict = {}
                self.codes: dict = {}
                self.wiped: set = set()

            def account(self, address):
                if address in self.accounts:
                    return self.accounts[address]
                return self.base.account(address)

            def storage(self, address, slot):
                per = self.storages.get(address)
                if per is not None and slot in per:
                    return per[slot]
                if address in self.wiped:
                    return 0
                return self.base.storage(address, slot)

            def bytecode(self, code_hash):
                return self.codes.get(code_hash) or self.base.bytecode(code_hash)

            def fold(self, out):
                for addr, acc in out.post_accounts.items():
                    self.accounts[addr] = acc
                for addr in out.changes.wiped_storage:
                    self.wiped.add(addr)
                    self.storages[addr] = {}
                for addr, slots in out.post_storage.items():
                    self.storages.setdefault(addr, {}).update(slots)
                self.codes.update(out.changes.new_bytecodes)

        folded = _Folded(ProviderStateSource(self._state_at(tag)))
        cfg = _dc_replace(self.tree.config, disable_eip3607=True,
                          disable_nonce_check=not validation)

        # BLOCKHASH window: canonical hashes below the base + simulated
        # blocks as they seal
        sim_hashes: dict[int, bytes] = {}
        for h in range(max(0, base_n - 256), base_n + 1):
            bh = p0.canonical_hash(h)
            if bh:
                sim_hashes[h] = bh

        out_blocks = []

        def _simulate_block(entry):
            nonlocal parent
            env_number = parent.number + 1
            env_time = parent.timestamp + 12
            coinbase = b"\x00" * 20
            gas_limit = parent.gas_limit
            base_fee = None  # None = per-parent (validation) or 0
            for k, v in (entry.get("blockOverrides") or {}).items():
                if k == "number":
                    env_number = parse_qty(v)
                elif k == "time":
                    env_time = parse_qty(v)
                elif k == "baseFeePerGas":
                    base_fee = parse_qty(v)
                elif k in ("feeRecipient", "coinbase"):
                    coinbase = parse_data(v)
                elif k == "gasLimit":
                    gas_limit = parse_qty(v)
                elif k == "prevRandao":
                    pass  # header mix hash stays zero (spec default)
            if env_number <= parent.number:
                raise RpcError(-32602, f"block number {env_number} not "
                                       f"after parent {parent.number}")
            if env_time <= parent.timestamp:
                env_time = parent.timestamp + 1
            # gap filling: empty blocks up to env_number-1 (spec note).
            # Timestamps must stay strictly increasing THROUGH the gap.
            gaps = env_number - parent.number - 1
            if env_time - parent.timestamp <= gaps:
                raise RpcError(-32602, "timestamps not strictly increasing "
                                       "across the gap-filled blocks")
            while parent.number + 1 < env_number:
                _seal({}, parent.number + 1,
                      min(parent.timestamp + 12,
                          env_time - (env_number - parent.number - 1)),
                      coinbase, gas_limit, None)
            _seal(entry, env_number, env_time, coinbase, gas_limit, base_fee)

        def _seal(entry, number, timestamp, coinbase, gas_limit, base_fee):
            nonlocal parent
            if base_fee is None:
                base_fee = calc_next_base_fee(parent) if validation else 0
            for addr_hex, ov in (entry.get("stateOverrides") or {}).items():
                addr = parse_data(addr_hex)
                acc = folded.account(addr) or Account()
                if "balance" in ov:
                    acc = acc.with_(balance=parse_qty(ov["balance"]))
                if "nonce" in ov:
                    acc = acc.with_(nonce=parse_qty(ov["nonce"]))
                if "code" in ov:
                    code = parse_data(ov["code"])
                    from ..primitives.keccak import keccak256 as _k

                    ch = _k(code) if code else _k(b"")
                    folded.codes[ch] = code
                    acc = acc.with_(code_hash=ch)
                folded.accounts[addr] = acc
                if "state" in ov or "stateDiff" in ov:
                    if "state" in ov:  # full replacement wipes the rest
                        folded.wiped.add(addr)
                        folded.storages[addr] = {}
                    per = folded.storages.setdefault(addr, {})
                    for slot_hex, val in (ov.get("state") or ov.get("stateDiff")).items():
                        per[parse_data(slot_hex).rjust(32, b"\x00")] = parse_qty(val)
            blob_kw = {}
            if parent.excess_blob_gas is not None:
                params = self.tree.config.blob_params_for(number, timestamp)
                from ..evm.executor import next_excess_blob_gas

                blob_kw = dict(
                    blob_gas_used=0,
                    excess_blob_gas=next_excess_blob_gas(
                        parent.excess_blob_gas, parent.blob_gas_used or 0,
                        params.target_gas))
            if parent.parent_beacon_block_root is not None:
                blob_kw["parent_beacon_block_root"] = b"\x00" * 32
            draft = Header(
                parent_hash=parent.hash, beneficiary=coinbase, number=number,
                gas_limit=gas_limit, timestamp=timestamp,
                base_fee_per_gas=base_fee,
                withdrawals_root=(EMPTY_ROOT_HASH
                                  if parent.withdrawals_root is not None
                                  else None),
                requests_hash=parent.requests_hash and hashlib.sha256().digest(),
                **blob_kw,
            )
            # sequential per-call execution so a call without an explicit
            # gas defaults to the block gas REMAINING after earlier calls
            # (geth's simulate semantics); system calls run like any block
            from ..evm.executor import (
                BEACON_ROOTS_ADDRESS, BlockExecutionOutput,
                HISTORY_STORAGE_ADDRESS, blob_base_fee as _bbf,
            )
            from ..primitives.types import Receipt

            executor = BlockExecutor(folded, cfg)
            spec = cfg.spec_for(number, timestamp)
            env = BlockEnv(
                number=number, timestamp=timestamp, coinbase=coinbase,
                gas_limit=gas_limit, base_fee=base_fee,
                chain_id=self.chain_id, block_hashes=dict(sim_hashes),
                blob_base_fee=_bbf(blob_kw.get("excess_blob_gas") or 0,
                                   (spec.blob or LATEST_SPEC.blob)
                                   .update_fraction),
            )
            state = EvmState(folded)
            if spec.beacon_root_call and draft.parent_beacon_block_root is not None:
                executor._system_call(state, env, spec, BEACON_ROOTS_ADDRESS,
                                      draft.parent_beacon_block_root)
            if spec.history_contract_call and number > 0:
                executor._system_call(state, env, spec,
                                      HISTORY_STORAGE_ADDRESS, parent.hash)
            txs, senders, receipts, outputs = [], [], [], []
            cumulative = 0
            for call in entry.get("calls", ()):
                sender = parse_data(call.get("from", "0x" + "00" * 20))
                gas = (parse_qty(call["gas"]) if "gas" in call
                       else gas_limit - cumulative)
                max_fee = parse_qty(call.get("maxFeePerGas",
                                             call.get("gasPrice", qty(base_fee))))
                common = dict(
                    nonce=(parse_qty(call["nonce"]) if "nonce" in call
                           else state.nonce(sender)),
                    gas_limit=gas,
                    to=parse_data(call["to"]) if call.get("to") else None,
                    value=parse_qty(call.get("value", "0x0")),
                    data=parse_data(call.get("data", call.get("input", "0x"))),
                )
                if spec.max_tx_type >= 2:
                    tx = Transaction(
                        tx_type=2, chain_id=self.chain_id,
                        max_fee_per_gas=max_fee,
                        max_priority_fee_per_gas=parse_qty(
                            call.get("maxPriorityFeePerGas", "0x0")),
                        **common)
                else:  # pre-London spec at the simulated height: legacy tx
                    tx = Transaction(
                        tx_type=0,
                        chain_id=self.chain_id if spec.eip155 else None,
                        gas_price=max_fee, **common)
                try:
                    result = executor._execute_tx(
                        state, env, tx, sender, gas_limit - cumulative,
                        spec=spec)
                except InvalidTransaction as e:
                    raise RpcError(-38014,
                                   f"invalid transaction in simulation: {e}")
                cumulative += result.gas_used
                receipts.append(Receipt(
                    tx_type=tx.tx_type, success=result.success,
                    cumulative_gas_used=cumulative,
                    logs=tuple(result.receipt.logs)))
                outputs.append(result.output)
                txs.append(tx)
                senders.append(sender)
            post_accounts, post_storage = state.final_state()
            out = BlockExecutionOutput(
                receipts=receipts, gas_used=cumulative, changes=state.changes,
                post_accounts=post_accounts, post_storage=post_storage,
                senders=senders, tx_outputs=outputs)
            folded.fold(out)
            header = Header(**{
                **draft.__dict__,
                "state_root": b"\x00" * 32,
                "transactions_root": ordered_trie_root(
                    [tx.encode() for tx in txs], self.tree.committer),
                "receipts_root": ordered_trie_root(
                    [r.encode_2718() for r in out.receipts], self.tree.committer),
                "logs_bloom": logs_bloom(
                    [lg for r in out.receipts for lg in r.logs]),
                "gas_used": out.gas_used,
            })
            if overlay is not None:
                # root the simulated block through the real trie pipeline
                overlay.insert_header(header)
                overlay.insert_block_body(Block(
                    header, tuple(txs), (),
                    () if header.withdrawals_root is not None else None))
                idx = overlay.block_body_indices(number)
                for i, s in enumerate(senders):
                    overlay.put_sender(idx.first_tx_num + i, s)
                write_execution_output(overlay, number, idx.first_tx_num, out)
                root = self.tree._state_root_job(overlay, out)
                header = Header(**{**header.__dict__, "state_root": root})
            sealed = Block(header, tuple(txs), (),
                           () if header.withdrawals_root is not None else None)
            calls_out = []
            log_index = 0
            cumulative_prev = 0
            for i, (receipt, ret) in enumerate(zip(out.receipts, out.tx_outputs)):
                logs = []
                for lg in receipt.logs:
                    logs.append({
                        "address": data(lg.address),
                        "topics": [data(t) for t in lg.topics],
                        "data": data(lg.data),
                        "blockNumber": qty(number),
                        "blockHash": data(sealed.hash),
                        "transactionHash": data(txs[i].hash),
                        "transactionIndex": qty(i),
                        "logIndex": qty(log_index),
                        "removed": False,
                    })
                    log_index += 1
                entry_out = {
                    "status": qty(1 if receipt.success else 0),
                    "returnData": data(ret),
                    "gasUsed": qty(receipt.cumulative_gas_used - cumulative_prev),
                    "logs": logs,
                }
                cumulative_prev = receipt.cumulative_gas_used
                if not receipt.success:
                    entry_out["error"] = {"code": -32000 if not ret else 3,
                                          "message": ("execution reverted"
                                                      if ret else "vm error")}
                calls_out.append(entry_out)
            out_blocks.append({**block_to_rpc(sealed, full_txs, senders),
                               "calls": calls_out})
            sim_hashes[number] = sealed.hash
            parent = header

        for entry in entries:
            _simulate_block(entry)
        return out_blocks

    # -- logs --------------------------------------------------------------------

    def eth_getLogs(self, filt):
        p = self._provider()
        start = self._resolve_number(filt.get("fromBlock", "earliest"), p)
        end = self._resolve_number(filt.get("toBlock", "latest"), p)
        want_addr = None
        if filt.get("address"):
            a = filt["address"]
            want_addr = {parse_data(x) for x in (a if isinstance(a, list) else [a])}
        topics = filt.get("topics") or []
        out = []
        for n in range(start, end + 1):
            idx = p.block_body_indices(n)
            if idx is None or idx.tx_count == 0:
                continue
            header = p.header_by_number(n)
            txs = p.transactions_by_block(n)
            log_base = 0
            for i, t in enumerate(range(idx.first_tx_num, idx.next_tx_num)):
                receipt = p.receipt(t)
                if receipt is None:
                    continue
                for j, log in enumerate(receipt.logs):
                    if want_addr and log.address not in want_addr:
                        continue
                    if not _topics_match(log.topics, topics):
                        continue
                    out.append({
                        "address": data(log.address),
                        "topics": [data(x) for x in log.topics],
                        "data": data(log.data),
                        "blockNumber": qty(n),
                        "blockHash": data(header.hash),
                        "transactionHash": data(txs[i].hash),
                        "transactionIndex": qty(i),
                        "logIndex": qty(log_base + j),
                        "removed": False,
                    })
                log_base += len(receipt.logs)
        return out


def _topics_match(log_topics, want) -> bool:
    for i, t in enumerate(want):
        if t is None or t == []:  # null and [] are both wildcards
            continue
        if i >= len(log_topics):
            return False
        opts = t if isinstance(t, list) else [t]
        if data(log_topics[i]) not in [o.lower() for o in opts]:
            return False
    return True
