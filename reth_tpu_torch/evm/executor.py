"""Block executor: transaction validation, execution, receipts, changesets.

A copy of the JAX package's ``evm/executor.py``.

Reference analogue: `ConfigureEvm`/`Executor`/`BlockExecutionOutput`
(crates/evm/evm/src/lib.rs:181, crates/evm/execution-types) with
`EthEvmConfig`'s mainnet wiring (crates/ethereum/evm) and its per-block
revm `SpecId` selection (crates/ethereum/evm/src/config.rs:2-3). All
fork-dependent rules come from the active :class:`Spec`: EIP-1559 fee
handling vs full-fee-to-miner, EIP-3529 refund caps, pre-merge block +
ommer rewards, pre-Byzantium state-root receipts, EIP-161 state
clearing, EIP-7623 calldata floor, and the system calls (EIP-4788
beacon roots, EIP-2935 history, EIP-7002/7251 request contracts,
EIP-6110 deposit log parsing — reference
crates/evm/evm/src/system_calls/).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..primitives.keccak import keccak256
from ..primitives.types import (
    Account,
    Block,
    DELEGATION_PREFIX,
    EIP4844_TX_TYPE,
    EIP7702_TX_TYPE,
    GAS_PER_BLOB,
    Receipt,
    Transaction,
)
from .interpreter import (
    BlockEnv,
    CallFrame,
    G_ACCESS_LIST_ADDR,
    G_ACCESS_LIST_SLOT,
    G_INITCODE_WORD,
    G_TX,
    G_ZERO_BYTE,
    Halt,
    Interpreter,
    MAX_INITCODE_SIZE,
    PrecompileNotImplemented,
    Revert,
    TxEnv,
)
from .spec import LATEST_SPEC, Spec, spec_for_block
from .state import BlockChanges, EvmState, StateSource, resolve_delegation

MAX_REFUND_QUOTIENT = 5  # EIP-3529

# EIP-4844 blob fee market (Cancun parameters)
MIN_BLOB_BASE_FEE = 1
BLOB_BASE_FEE_UPDATE_FRACTION = 3_338_477
TARGET_BLOB_GAS_PER_BLOCK = 3 * GAS_PER_BLOB
MAX_BLOB_GAS_PER_BLOCK = 6 * GAS_PER_BLOB

# EIP-7702
PER_EMPTY_ACCOUNT_COST = 25_000
PER_AUTH_BASE_COST = 12_500
SECP256K1_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141


def fake_exponential(factor: int, numerator: int, denominator: int) -> int:
    """EIP-4844 blob base fee approximation of factor * e^(num/denom)."""
    i = 1
    output = 0
    acc = factor * denominator
    while acc > 0:
        output += acc
        acc = acc * numerator // (denominator * i)
        i += 1
    return output // denominator


def blob_base_fee(excess_blob_gas: int,
                  update_fraction: int = BLOB_BASE_FEE_UPDATE_FRACTION) -> int:
    return fake_exponential(MIN_BLOB_BASE_FEE, excess_blob_gas, update_fraction)


def next_excess_blob_gas(parent_excess: int, parent_blob_gas_used: int,
                         target: int = TARGET_BLOB_GAS_PER_BLOCK) -> int:
    total = parent_excess + parent_blob_gas_used
    return max(0, total - target)


# system-call fixed addresses (each from its EIP)
SYSTEM_ADDRESS = bytes.fromhex("fffffffffffffffffffffffffffffffffffffffe")
BEACON_ROOTS_ADDRESS = bytes.fromhex("000f3df6d732807ef1319fb7b8bb8522d0beac02")
HISTORY_STORAGE_ADDRESS = bytes.fromhex("0000f90827f1c53a10cb7a02335b175320002935")
WITHDRAWAL_REQUEST_ADDRESS = bytes.fromhex("00000961ef480eb55e80d19ad83579a64c007002")
CONSOLIDATION_REQUEST_ADDRESS = bytes.fromhex("0000bbddc7ce488642fb579f8b00f3a590007251")
MAINNET_DEPOSIT_CONTRACT = bytes.fromhex("00000000219ab540356cbb839cbe05303d7705fa")
# keccak256("DepositEvent(bytes,bytes,bytes,bytes,bytes)")
DEPOSIT_EVENT_TOPIC = keccak256(b"DepositEvent(bytes,bytes,bytes,bytes,bytes)")


class InvalidTransaction(ValueError):
    """A transaction that cannot be included in its block (consensus
    invalidity — nonce/fee/fork gating), distinct from an in-block
    failure. ValueError subclass so generic rejection paths catch it."""


class BlockExecutionError(InvalidTransaction):
    """A block-level execution failure that invalidates the whole block:
    a mandatory system call reverted/halted (EIP-7002/7251 contracts must
    not fail) or a deposit-contract log that does not decode (EIP-6110).
    Subclasses InvalidTransaction so every block-rejection path (engine
    tree, pipeline, conformance) treats it as block-invalid."""


# EIP-6110 DepositEvent field sizes, in ABI order
_DEPOSIT_FIELDS = (48, 32, 8, 96, 8)  # pubkey, wc, amount, signature, index


def _decode_deposit_log(data: bytes) -> bytes:
    """Decode one DepositEvent(bytes,bytes,bytes,bytes,bytes) log's ABI
    data into the EIP-6110 deposit-request encoding: the five payloads
    concatenated (48+32+8+96+8 = 192 bytes).

    The ABI head is five 32-byte offsets; each tail is a 32-byte length
    word followed by the right-padded payload. Offsets and lengths are
    VALIDATED, not assumed (reference crates/ethereum/evm deposit
    decoding) — the canonical deposit contract always emits the fixed
    576-byte layout, but a spoofed log with the right topic from a chain's
    overridden deposit-contract address must not be trusted blindly.
    Raises :class:`BlockExecutionError` on any malformed field."""

    def word(off: int) -> int:
        if off + 32 > len(data):
            raise BlockExecutionError(
                f"deposit log truncated at byte {off} (len {len(data)})")
        return int.from_bytes(data[off : off + 32], "big")

    out = bytearray()
    for i, size in enumerate(_DEPOSIT_FIELDS):
        tail = word(32 * i)
        if tail % 32 or tail < 32 * len(_DEPOSIT_FIELDS):
            raise BlockExecutionError(
                f"deposit log field {i}: bad ABI offset {tail}")
        length = word(tail)
        if length != size:
            raise BlockExecutionError(
                f"deposit log field {i}: length {length} != {size}")
        start = tail + 32
        if start + size > len(data):
            raise BlockExecutionError(
                f"deposit log field {i}: payload out of bounds")
        out += data[start : start + size]
    return bytes(out)


@dataclass
class EvmConfig:
    """Chain-level execution config (reference `EthEvmConfig`).

    ``chainspec`` drives per-block fork selection; ``spec`` pins one rule
    set regardless of height (tests, conformance). With neither, the
    latest rule set applies — the right default for dev chains and the
    post-merge live-tip paths."""

    chain_id: int = 1
    chainspec: object | None = None  # reth_tpu_torch.chainspec.ChainSpec
    spec: Spec | None = None
    # revm CfgEnv-style relaxations (eth_simulateV1 / eth_call paths)
    disable_eip3607: bool = False
    disable_nonce_check: bool = False

    def spec_for(self, number: int, timestamp: int) -> Spec:
        if self.spec is not None:
            return self.spec
        if self.chainspec is not None:
            return spec_for_block(self.chainspec, number, timestamp)
        return LATEST_SPEC

    def blob_params_for(self, number: int, timestamp: int):
        """Active EIP-4844 parameters (Cancun defaults when the fork
        predates blobs — callers gate on the parent's blob fields)."""
        from .spec import CANCUN_BLOBS

        return self.spec_for(number, timestamp).blob or CANCUN_BLOBS


@dataclass
class TxResult:
    receipt: Receipt
    gas_used: int
    success: bool
    output: bytes = b""


@dataclass
class BlockExecutionOutput:
    """Everything downstream stages need (reference `BlockExecutionOutput`)."""

    receipts: list[Receipt] = field(default_factory=list)
    gas_used: int = 0
    changes: BlockChanges | None = None
    post_accounts: dict[bytes, Account | None] = field(default_factory=dict)
    post_storage: dict[bytes, dict[bytes, int]] = field(default_factory=dict)
    senders: list[bytes] = field(default_factory=list)
    # EIP-7685 execution requests (Prague+): type-prefixed payloads in
    # ascending type order, empty payloads excluded
    requests: list[bytes] = field(default_factory=list)
    # per-tx return data (eth_simulateV1 and tracing consumers)
    tx_outputs: list[bytes] = field(default_factory=list)


def intrinsic_gas(tx: Transaction, spec: Spec = LATEST_SPEC) -> int:
    gas = G_TX
    for b in tx.data:
        gas += G_ZERO_BYTE if b == 0 else spec.g_calldata_nonzero
    if tx.to is None:
        gas += spec.g_tx_create_extra  # 32000 since Homestead (EIP-2)
        if spec.initcode_limit:  # EIP-3860
            gas += G_INITCODE_WORD * ((len(tx.data) + 31) // 32)
    for _addr, slots in tx.access_list:
        gas += G_ACCESS_LIST_ADDR + G_ACCESS_LIST_SLOT * len(slots)
    gas += PER_EMPTY_ACCOUNT_COST * len(tx.authorization_list)  # EIP-7702
    return gas


def calldata_floor_gas(tx: Transaction) -> int:
    """EIP-7623 (Prague): minimum gas a tx pays, from its calldata tokens."""
    tokens = sum(1 if b == 0 else 4 for b in tx.data)
    return G_TX + 10 * tokens


class BlockExecutor:
    """Executes one block against a state source."""

    def __init__(self, source: StateSource, config: EvmConfig | None = None):
        self.source = source
        self.config = config or EvmConfig()

    def _credit_coinbase(self, state: EvmState, env: "BlockEnv", amount: int):
        """Priority-fee credit seam: the BAL wave executor overrides this to
        accumulate a commutative delta instead of writing state (coinbase
        would otherwise conflict every pair of transactions)."""
        state._capture_account_change(env.coinbase)
        state.add_balance(env.coinbase, amount)

    def execute(
        self, block: Block, senders: list[bytes] | None = None,
        block_hashes: dict[int, bytes] | None = None,
        state_hook=None, intermediate_root_fn=None,
    ) -> BlockExecutionOutput:
        """``state_hook(keys)`` is called after every transaction with the
        plain keys it newly touched — 20-byte addresses and
        ``(address, slot)`` pairs — the OnStateHook seam feeding the
        background state-root job (reference crates/evm/evm/src/lib.rs
        OnStateHook -> state_root_task).

        ``intermediate_root_fn(state)`` supplies the post-tx state root for
        pre-Byzantium receipts (the importer owns the trie pipeline, so the
        executor just asks)."""
        header = block.header
        spec = self.config.spec_for(header.number, header.timestamp)
        blob = spec.blob
        env = BlockEnv(
            number=header.number,
            timestamp=header.timestamp,
            coinbase=header.beneficiary,
            gas_limit=header.gas_limit,
            base_fee=header.base_fee_per_gas or 0,
            prev_randao=header.mix_hash,
            chain_id=self.config.chain_id,
            difficulty=header.difficulty,
            block_hashes=block_hashes or {},
            blob_base_fee=blob_base_fee(
                header.excess_blob_gas or 0,
                blob.update_fraction if blob else BLOB_BASE_FEE_UPDATE_FRACTION),
        )
        state = EvmState(self.source)
        out = BlockExecutionOutput()
        if senders is None:
            senders = [tx.recover_sender() for tx in block.transactions]
        out.senders = senders

        # pre-block system calls (reference crates/evm/evm/src/system_calls/)
        if spec.beacon_root_call and header.parent_beacon_block_root is not None:
            self._system_call(state, env, spec, BEACON_ROOTS_ADDRESS,
                              header.parent_beacon_block_root)  # EIP-4788
        if spec.history_contract_call and header.number > 0:
            self._system_call(state, env, spec, HISTORY_STORAGE_ADDRESS,
                              header.parent_hash)  # EIP-2935

        cumulative_gas = 0
        sent_accounts = 0
        sent_slots: dict[bytes, int] = {}

        def flush_hook():
            nonlocal sent_accounts
            # stream only NEWLY touched keys: the changes maps are
            # append-only per block (prev-images capture once), so
            # watermarks over insertion order give exact deltas
            accts = list(state.changes.accounts)
            new = accts[sent_accounts:]
            sent_accounts = len(accts)
            for addr, per in state.changes.storage.items():
                seen = sent_slots.get(addr, 0)
                if len(per) > seen:
                    new += [(addr, s) for s in list(per)[seen:]]
                    sent_slots[addr] = len(per)
            if new:
                state_hook(new)

        for tx, sender in zip(block.transactions, senders):
            result = self._execute_tx(state, env, tx, sender,
                                      header.gas_limit - cumulative_gas,
                                      spec=spec)
            cumulative_gas += result.gas_used
            receipt = Receipt(
                tx_type=tx.tx_type,
                success=result.success,
                cumulative_gas_used=cumulative_gas,
                logs=tuple(result.receipt.logs),
                state_root=(intermediate_root_fn(state)
                            if not spec.receipt_status and intermediate_root_fn
                            else None),
            )
            out.receipts.append(receipt)
            out.tx_outputs.append(result.output)
            if state_hook is not None:
                flush_hook()

        # post-block system calls + EIP-6110 deposit log parsing (Prague)
        if spec.has_requests:
            out.requests = self._collect_requests(state, env, spec, out.receipts)
        # withdrawals (gwei → wei), post-merge; zero-amount does not touch
        for w in block.withdrawals or ():
            if w.amount:
                state._capture_account_change(w.address)
                state.add_balance(w.address, w.amount * 10**9)
        # pre-merge PoW rewards: miner gets R + R/32 per ommer, each ommer
        # miner R*(8-depth)/8 (yellow paper; reference pre-merge executors)
        if spec.block_reward:
            reward = spec.block_reward
            state.add_balance(header.beneficiary,
                              reward + (reward // 32) * len(block.ommers))
            for o in block.ommers:
                r = reward * (8 - (header.number - o.number)) // 8
                if r > 0:
                    state.add_balance(o.beneficiary, r)
        if state_hook is not None:
            flush_hook()  # rewards/withdrawals/system-call keys
        out.gas_used = cumulative_gas
        out.changes = state.changes
        out.post_accounts, out.post_storage = state.final_state()
        return out

    # -- system calls (EIP-4788/2935/7002/7251) ---------------------------

    def _system_call(self, state: EvmState, env: BlockEnv, spec: Spec,
                     target: bytes, data: bytes) -> bytes | None:
        """One system transaction: caller = SYSTEM_ADDRESS, 30M gas, no
        fees, not metered in the block; skipped when the contract is
        absent. Returns the call output (request contracts) or None."""
        code = state.code(target)
        if not code:
            return None
        state.begin_tx()
        interp = Interpreter(
            state, env, TxEnv(origin=SYSTEM_ADDRESS, gas_price=0), spec=spec)
        frame = CallFrame(caller=SYSTEM_ADDRESS, address=target, code=code,
                          data=data, value=0, gas=30_000_000, kind="CALL")
        try:
            ok, _gas_left, out = interp.call(frame)
        except (Revert, Halt) as e:
            # a failed mandatory system call invalidates the BLOCK (the
            # reference's BlockExecutionError / EIP-7002 "call must not
            # fail") — silently returning None here would let a block with
            # a broken system contract slip through with wrong requests
            raise BlockExecutionError(
                f"system call to 0x{target.hex()} "
                f"{type(e).__name__.lower()}ed: {e}") from e
        state.process_destructs()
        if not ok:
            raise BlockExecutionError(
                f"system call to 0x{target.hex()} failed")
        return out

    def _collect_requests(self, state: EvmState, env: BlockEnv, spec: Spec,
                          receipts: list[Receipt]) -> list[bytes]:
        """EIP-7685 requests: 0x00 deposits (EIP-6110, parsed from deposit
        contract logs), 0x01 withdrawals (EIP-7002 system call), 0x02
        consolidations (EIP-7251). Empty payloads are excluded."""
        deposit_contract = MAINNET_DEPOSIT_CONTRACT
        if self.config.chainspec is not None and \
                getattr(self.config.chainspec, "deposit_contract", None):
            deposit_contract = self.config.chainspec.deposit_contract
        deposits = b""
        for receipt in receipts:
            for log in receipt.logs:
                if log.address == deposit_contract and log.topics and \
                        log.topics[0] == DEPOSIT_EVENT_TOPIC:
                    deposits += _decode_deposit_log(log.data)
        requests = []
        if deposits:
            requests.append(b"\x00" + deposits)
        withdrawals = self._system_call(state, env, spec,
                                        WITHDRAWAL_REQUEST_ADDRESS, b"")
        if withdrawals:
            requests.append(b"\x01" + withdrawals)
        consolidations = self._system_call(state, env, spec,
                                           CONSOLIDATION_REQUEST_ADDRESS, b"")
        if consolidations:
            requests.append(b"\x02" + consolidations)
        return requests

    def _execute_tx(
        self, state: EvmState, env: BlockEnv, tx: Transaction, sender: bytes,
        gas_available: int, tracer=None, spec: Spec | None = None,
    ) -> TxResult:
        if spec is None:
            spec = self.config.spec_for(env.number, env.timestamp)
        base_fee = env.base_fee
        # -- validation (reference: EthTransactionValidator + pre-exec checks)
        if tx.tx_type > spec.max_tx_type:
            raise InvalidTransaction(
                f"tx type {tx.tx_type} not active in {spec.name}")
        if tx.chain_id is not None and not spec.eip155:
            raise InvalidTransaction("chain-id signature before EIP-155")
        if tx.gas_limit > gas_available:
            raise InvalidTransaction("block gas limit exceeded")
        if tx.chain_id is not None and tx.chain_id != env.chain_id:
            raise InvalidTransaction("wrong chain id")
        gas_price = tx.effective_gas_price(base_fee)
        if tx.tx_type >= 2 and tx.max_fee_per_gas < base_fee:
            raise InvalidTransaction("max fee below base fee")
        if tx.tx_type < 2 and gas_price < base_fee:  # legacy + EIP-2930
            raise InvalidTransaction("gas price below base fee")
        blob_fee = 0
        if tx.tx_type == EIP4844_TX_TYPE:
            # EIP-4844: blob txs must target a contract and carry blobs
            if tx.to is None:
                raise InvalidTransaction("blob tx cannot create")
            if not tx.blob_versioned_hashes:
                raise InvalidTransaction("blob tx without blobs")
            if any(len(h) != 32 or h[0] != 0x01 for h in tx.blob_versioned_hashes):
                raise InvalidTransaction("malformed blob versioned hash")
            if tx.max_fee_per_blob_gas < env.blob_base_fee:
                raise InvalidTransaction("max blob fee below blob base fee")
            blob_fee = tx.blob_gas() * env.blob_base_fee
        if tx.tx_type == EIP7702_TX_TYPE:
            if tx.to is None:
                raise InvalidTransaction("set-code tx cannot create")
            if not tx.authorization_list:
                raise InvalidTransaction("set-code tx without authorizations")
        acct = state.account_or_empty(sender)
        if acct.nonce != tx.nonce and not self.config.disable_nonce_check:
            raise InvalidTransaction(f"nonce mismatch: acct {acct.nonce} vs tx {tx.nonce}")
        # EIP-3607: reject txs from senders with deployed code (a 7702
        # delegation designator is not "code" for this rule)
        sender_code = state.code(sender)
        if sender_code and not self.config.disable_eip3607 and not (
                sender_code[:3] == DELEGATION_PREFIX and len(sender_code) == 23):
            raise InvalidTransaction("sender is a contract (EIP-3607)")
        max_cost = tx.gas_limit * (tx.max_fee_per_gas if tx.tx_type >= 2 else tx.gas_price)
        max_cost += tx.blob_gas() * tx.max_fee_per_blob_gas
        if acct.balance < max_cost + tx.value:
            raise InvalidTransaction("insufficient funds")
        ig = intrinsic_gas(tx, spec)
        if tx.gas_limit < ig:
            raise InvalidTransaction("intrinsic gas too high")
        if spec.calldata_floor and tx.gas_limit < calldata_floor_gas(tx):
            raise InvalidTransaction("gas limit below EIP-7623 calldata floor")
        if spec.initcode_limit and tx.to is None and len(tx.data) > MAX_INITCODE_SIZE:
            raise InvalidTransaction("initcode too large")

        # -- setup
        state.begin_tx()
        interp = Interpreter(
            state, env,
            TxEnv(origin=sender, gas_price=gas_price,
                  blob_hashes=tuple(tx.blob_versioned_hashes)),
            tracer=tracer, spec=spec,
        )
        # buy gas (+ the blob fee, burned — EIP-4844)
        state.sub_balance(sender, tx.gas_limit * gas_price + blob_fee)
        state.bump_nonce(sender)
        if spec.warm_cold:
            # warm: sender, coinbase (EIP-3651), target, precompiles
            # (EIP-2929 initialises accessed_addresses with them), access list
            state.warm_account(sender)
            if spec.warm_coinbase:
                state.warm_account(env.coinbase)
            for i in range(1, spec.precompiles + 1):
                state.warm_account(b"\x00" * 19 + bytes([i]))
            if tx.to is not None:
                state.warm_account(tx.to)
            for addr, slots in tx.access_list:
                state.warm_account(addr)
                for s in slots:
                    state.warm_slot(addr, s)
        if tx.tx_type == EIP7702_TX_TYPE:
            self._apply_authorizations(state, env, tx)

        gas = tx.gas_limit - ig
        success, output = True, b""
        try:
            if tx.to is None:
                ok, gas_left, _addr, output = interp.create(
                    sender, tx.value, tx.data, gas, 0, tx_nonce=tx.nonce
                )
                success = ok
            else:
                # EIP-7702: a delegated destination executes the delegate's
                # code in tx.to's context. At the TOP level the delegation
                # target joins accessed_addresses for free (the EIP extends
                # EIP-2929's initialization); only CALL-family opcodes charge
                # the extra account access.
                code, target = (resolve_delegation(state, tx.to)
                                if spec.has_setcode else (state.code(tx.to), None))
                if target is not None:
                    state.warm_account(target)
                frame = CallFrame(
                    caller=sender, address=tx.to, code=code,
                    data=tx.data, value=tx.value, gas=gas,
                )
                try:
                    ok, gas_left, output = interp.call(frame)
                    success = ok
                except Revert as r:
                    success, gas_left, output = False, getattr(r, "gas_left", 0), r.output
                except Halt:
                    success, gas_left, output = False, 0, b""
        except PrecompileNotImplemented as e:
            # a silently-stubbed precompile would corrupt the state root
            # without tripping any invariant — fail the BLOCK loudly instead
            raise BlockExecutionError(str(e)) from e

        gas_used = tx.gas_limit - gas_left
        # refunds: capped at 1/2 of used gas pre-London, 1/5 after (EIP-3529).
        # Failed txs keep no refund; pre-Byzantium a "failed" top-level frame
        # consumed everything anyway.
        if success:
            refund = min(state.refund, gas_used // spec.refund_quotient)
            gas_used -= refund
        if spec.calldata_floor:  # EIP-7623: calldata-heavy txs pay the floor
            gas_used = max(gas_used, calldata_floor_gas(tx))
        # refund unused gas, pay coinbase the priority fee, burn base fee
        # (pre-1559 base_fee is 0, so the miner gets the full fee)
        state.add_balance(sender, (tx.gas_limit - gas_used) * gas_price)
        priority = gas_price - base_fee
        if priority > 0:
            self._credit_coinbase(state, env, gas_used * priority)
        # failed frames already popped their logs via journal revert
        logs = state.take_logs()
        state.process_destructs()
        if spec.state_clearing:  # EIP-161
            state.delete_empty_touched()
        else:
            state._touched.clear()
        return TxResult(
            receipt=Receipt(tx_type=tx.tx_type, success=success, logs=tuple(logs)),
            gas_used=gas_used,
            success=success,
            output=output,
        )


    def _apply_authorizations(self, state: EvmState, env: BlockEnv, tx: Transaction):
        """EIP-7702 set-code processing: each valid authorization installs a
        delegation designator (0xef0100 ++ address) as the authority's code.
        Invalid tuples are SKIPPED, never fatal (per spec)."""
        for auth in tx.authorization_list:
            if len(auth.address) != 20:
                continue
            if auth.chain_id not in (0, env.chain_id):
                continue
            if auth.nonce >= 2**64 - 1:
                continue
            if auth.s > SECP256K1_N // 2 or auth.y_parity not in (0, 1):
                continue
            try:
                authority = auth.recover_authority()
            except ValueError:
                continue
            state.warm_account(authority)
            code = state.code(authority)
            if code and not (code[:3] == DELEGATION_PREFIX and len(code) == 23):
                continue  # real contract code cannot be overridden
            if state.nonce(authority) != auth.nonce:
                continue
            if state.exists(authority) and not state.is_empty(authority):
                state.add_refund(PER_EMPTY_ACCOUNT_COST - PER_AUTH_BASE_COST)
            state._capture_account_change(authority)
            if auth.address == b"\x00" * 20:
                state.set_code(authority, b"")  # clear the delegation
            else:
                state.set_code(authority, DELEGATION_PREFIX + auth.address)
            state.set_nonce(authority, auth.nonce + 1)


class ProviderStateSource(StateSource):
    """StateSource over a DatabaseProvider's plain state."""

    def __init__(self, provider):
        self.provider = provider

    def account(self, address: bytes) -> Account | None:
        return self.provider.account(address)

    def storage(self, address: bytes, slot: bytes) -> int:
        return self.provider.storage(address, slot)

    def bytecode(self, code_hash: bytes) -> bytes:
        return self.provider.bytecode(code_hash) or b""


class InMemoryStateSource(StateSource):
    """Dict-backed source for tests and genesis building."""

    def __init__(self, accounts=None, storages=None, codes=None):
        self.accounts = dict(accounts or {})
        self.storages = {a: dict(s) for a, s in (storages or {}).items()}
        self.codes = dict(codes or {})

    def account(self, address: bytes) -> Account | None:
        return self.accounts.get(address)

    def storage(self, address: bytes, slot: bytes) -> int:
        return self.storages.get(address, {}).get(slot, 0)

    def bytecode(self, code_hash: bytes) -> bytes:
        return self.codes.get(code_hash, b"")
