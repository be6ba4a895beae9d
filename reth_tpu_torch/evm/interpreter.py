"""EVM bytecode interpreter (CPU), fork-parameterized Frontier→Prague.

A copy of the JAX package's ``evm/interpreter.py``.

Reference analogue: the revm v41 interpreter (external crate; reth wires
it via `ConfigureEvm`, crates/evm/evm/src/lib.rs:181, and selects a revm
`SpecId` per block — crates/ethereum/evm/src/config.rs:2-3). A
from-scratch stack machine: 256-bit words as Python ints, memory as
bytearray. Everything fork-dependent — opcode availability, the
EIP-2929 warm/cold model vs the flat pre-Berlin gas tables, the three
SSTORE regimes (legacy / EIP-1283-2200 net / post-Berlin), EIP-150
63/64 gas retention, EIP-161 touch semantics, EIP-3529 refunds,
EIP-3860 initcode metering, EIP-1153/5656/6780 — is read from the
active :class:`~reth_tpu_torch.evm.spec.Spec`.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from ..primitives.keccak import keccak256
from ..primitives.rlp import rlp_encode, encode_int
from .spec import LATEST_SPEC, Spec
from .state import EvmState, resolve_delegation

U256 = 1 << 256
MASK = U256 - 1
SIGN_BIT = 1 << 255

MAX_CALL_DEPTH = 1024
MAX_CODE_SIZE = 24576
MAX_INITCODE_SIZE = 2 * MAX_CODE_SIZE

# gas constants
G_ZERO_BYTE = 4
G_NONZERO_BYTE = 16
G_COLD_SLOAD = 2100
G_WARM_ACCESS = 100
G_COLD_ACCOUNT = 2600
G_SSTORE_SET = 20000
G_SSTORE_RESET = 2900
R_SSTORE_CLEAR = 4800
G_KECCAK = 30
G_KECCAK_WORD = 6
G_COPY_WORD = 3
G_LOG = 375
G_LOG_TOPIC = 375
G_LOG_BYTE = 8
G_CREATE = 32000
G_CODE_DEPOSIT = 200
G_CALL_VALUE = 9000
G_CALL_STIPEND = 2300
G_NEW_ACCOUNT = 25000
G_SELFDESTRUCT = 5000
G_INITCODE_WORD = 2
G_EXP_BYTE = 50
G_MEM = 3
G_TX = 21000
G_TX_CREATE = 32000
G_ACCESS_LIST_ADDR = 2400
G_ACCESS_LIST_SLOT = 1900


class Halt(Exception):
    """Exceptional halt: consumes all frame gas."""


class Revert(Exception):
    def __init__(self, output: bytes):
        self.output = output


@dataclass
class BlockEnv:
    number: int = 0
    timestamp: int = 0
    coinbase: bytes = b"\x00" * 20
    gas_limit: int = 30_000_000
    base_fee: int = 0
    prev_randao: bytes = b"\x00" * 32
    blob_base_fee: int = 1
    chain_id: int = 1
    difficulty: int = 0  # pre-merge DIFFICULTY opcode value
    block_hashes: dict[int, bytes] = field(default_factory=dict)


@dataclass
class TxEnv:
    origin: bytes = b"\x00" * 20
    gas_price: int = 0
    blob_hashes: tuple[bytes, ...] = ()


@dataclass
class CallFrame:
    caller: bytes
    address: bytes          # storage/context address
    code: bytes
    data: bytes
    value: int              # CALLVALUE the frame observes
    gas: int
    static: bool = False
    depth: int = 0
    transfer_value: bool = True  # False for DELEGATECALL: value is context-only
    kind: str = "CALL"           # CALL/CALLCODE/DELEGATECALL/STATICCALL (tracers)


class Interpreter:
    """Iterative interpreter: EVM call frames live on an EXPLICIT frame
    stack of suspended generators (the trampoline in :meth:`_drive`), not
    the Python call stack — depth-1024 chains run without touching the
    recursion limit (reference: revm's iterative frame loop behind
    crates/evm/evm/src/lib.rs:181)."""

    def __init__(self, state: EvmState, block: BlockEnv, tx: TxEnv, tracer=None,
                 spec: Spec | None = None):
        self.state = state
        self.block = block
        self.tx = tx
        self.spec = spec if spec is not None else LATEST_SPEC
        self.transient: dict[tuple[bytes, bytes], int] = {}
        # optional per-step hook(pc, op, gas, stack, mem, depth) — the
        # struct-logger seam for debug_traceTransaction (revm Inspector
        # analogue); None costs one branch per opcode
        self.tracer = tracer

    # -- entry points ---------------------------------------------------------

    def call(self, frame: CallFrame) -> tuple[bool, int, bytes]:
        """Execute a message call; returns (success, gas_left, output)."""
        return self._drive(self._call_gen(frame))

    def create(
        self, caller: bytes, value: int, initcode: bytes, gas: int,
        depth: int, salt: bytes | None = None, tx_nonce: int | None = None,
    ) -> tuple[bool, int, bytes, bytes]:
        """CREATE/CREATE2; returns (success, gas_left, address, output)."""
        return self._drive(self._create_gen(caller, value, initcode, gas,
                                            depth, salt, tx_nonce))

    def _drive(self, root):
        """The explicit frame stack: each entry is one EVM frame suspended
        as a generator at its nested CALL/CREATE site. A child frame's
        result resumes its parent via send(); a child's Revert/Halt is
        thrown INTO the parent at the yield point, which preserves the
        exact semantics the recursive form had (`try: self.call(sub)
        except Revert` around the opcode)."""
        stack = [root]
        value = None
        exc: BaseException | None = None
        while stack:
            g = stack[-1]
            try:
                if exc is not None:
                    e, exc = exc, None
                    req = g.throw(e)
                else:
                    req = g.send(value)
                value = None
            except StopIteration as s:
                stack.pop()
                value = s.value
                continue
            except (Revert, Halt) as e:
                stack.pop()
                exc = e
                value = None
                continue
            kind, arg = req
            stack.append(self._call_gen(arg) if kind == "call"
                         else self._create_gen(*arg))
            value = None
        if exc is not None:
            raise exc
        return value

    def _call_gen(self, frame: CallFrame):
        """One message-call frame (prologue + run + epilogue) as a
        generator; nested frames are yielded to the trampoline."""
        if frame.depth > MAX_CALL_DEPTH:
            return False, frame.gas, b""
        on_enter = getattr(self.tracer, "on_enter", None)
        on_exit = getattr(self.tracer, "on_exit", None)
        if on_enter is not None:
            on_enter(frame.kind, frame)
        state = self.state
        snap = state.snapshot()
        ok = True
        gas_left, out, err = frame.gas, b"", None
        try:
            if frame.value and frame.transfer_value:
                if state.balance(frame.caller) < frame.value:
                    ok = False
                    err = "halted"
                    return False, frame.gas, b""
                state.sub_balance(frame.caller, frame.value)
                state.add_balance(frame.address, frame.value)
            elif (frame.transfer_value and self.spec.touch_creates_empty
                  and state.account(frame.address) is None):
                # pre-EIP-161: every message call materializes its target,
                # value or not (the zero-balance precompile accounts on
                # mainnet exist because of exactly this)
                state.add_balance(frame.address, 0)
            pre = _precompile(frame.address, self.spec)
            if pre is not None:
                ok, gas_left, out = pre(frame.data, frame.gas)
                if not ok:
                    state.revert(snap)
                    err = "halted"
            elif frame.code:
                try:
                    gas_left, out = yield from self._run_gen(frame)
                except Revert as r:
                    state.revert(snap)
                    if on_exit is not None:
                        on_exit(frame, False, getattr(r, "gas_left", 0),
                                r.output, "reverted")
                        on_exit = None
                    raise
                except Halt:
                    state.revert(snap)
                    ok, gas_left, out, err = False, 0, b"", "halted"
        finally:
            if on_exit is not None:
                on_exit(frame, ok, gas_left, out, err)
        return ok, gas_left, out

    def _create_gen(
        self, caller: bytes, value: int, initcode: bytes, gas: int,
        depth: int, salt: bytes | None = None, tx_nonce: int | None = None,
    ):
        """One contract-creation frame as a generator.

        ``tx_nonce`` marks a top-level create transaction: the address
        derives from the tx nonce and the sender's nonce is NOT bumped here
        (the transaction itself already did).
        """
        state = self.state
        if depth > MAX_CALL_DEPTH or state.balance(caller) < value:
            return False, gas, b"", b""
        if state.nonce(caller) >= (1 << 64) - 1:
            return False, gas, b"", b""
        if tx_nonce is not None:
            addr = keccak256(rlp_encode([caller, encode_int(tx_nonce)]))[12:]
        elif salt is None:
            addr = keccak256(rlp_encode([caller, encode_int(state.nonce(caller))]))[12:]
        else:
            addr = keccak256(b"\xff" + caller + salt + keccak256(initcode))[12:]
        spec = self.spec
        if tx_nonce is None:
            state.bump_nonce(caller)
        state.warm_account(addr)
        existing = state.account(addr)
        if existing is not None and (existing.nonce > 0 or existing.code_hash != keccak256(b"")):
            return False, 0, b"", b""  # address collision burns gas
        snap = state.snapshot()
        # EIP-161 starts new contracts at nonce 1; before it, nonce 0
        state.create_account(addr, nonce=1 if spec.state_clearing else 0)
        state.sub_balance(caller, value)
        state.add_balance(addr, value)
        frame = CallFrame(caller=caller, address=addr, code=initcode,
                          data=b"", value=value, gas=gas, depth=depth,
                          kind="CREATE")
        try:
            gas_left, out = yield from self._run_gen(frame)
        except Revert as r:
            state.revert(snap)
            return False, getattr(r, "gas_left", 0), b"", r.output
        except Halt:
            state.revert(snap)
            return False, 0, b"", b""
        # code validation + deposit gas apply even if the initcode
        # selfdestructed the account (execution-specs generic_create order)
        if spec.max_code_size is not None and len(out) > spec.max_code_size:
            state.revert(snap)
            return False, 0, b"", b""
        if spec.reject_ef_code and out and out[0] == 0xEF:  # EIP-3541
            state.revert(snap)
            return False, 0, b"", b""
        deposit = G_CODE_DEPOSIT * len(out)
        if gas_left < deposit:
            if spec.create_fail_on_deposit_oog:  # EIP-2 (Homestead)
                state.revert(snap)
                return False, 0, b"", b""
            out = b""  # Frontier: creation succeeds with empty code
        else:
            gas_left -= deposit
        # EIP-6780: if the initcode selfdestructed the account it is None
        # now (create_account made it live; only a fresh destruct kills it)
        # → creation succeeds but the account stays dead, no code deposit.
        # Stale _selfdestructs membership from earlier txs cannot trip this.
        if state.account(addr) is None:
            return True, gas_left, addr, b""
        state.set_code(addr, out)
        return True, gas_left, addr, b""

    # -- main loop ------------------------------------------------------------

    def _run_gen(self, fr: CallFrame):
        state = self.state
        code = fr.code
        stack: list[int] = []
        mem = bytearray()
        pc = 0
        gas = fr.gas
        returndata = b""
        # initcode is deployment-unique: caching it would churn hot
        # contracts out of the bounded analysis cache
        jumpdests = (_jumpdests(code) if fr.kind == "CREATE"
                     else _jumpdests_cached(code))
        push = stack.append

        def use(n):
            nonlocal gas
            if gas < n:
                raise Halt()
            gas -= n

        def pop():
            if not stack:
                raise Halt()
            return stack.pop()

        def mem_expand(offset, size):
            nonlocal gas
            if size == 0:
                return
            end = offset + size
            if end > len(mem):
                new_words = (end + 31) // 32
                old_words = (len(mem) + 31) // 32
                cost = (G_MEM * new_words + new_words * new_words // 512) - (
                    G_MEM * old_words + old_words * old_words // 512
                )
                use(cost)
                mem.extend(b"\x00" * (new_words * 32 - len(mem)))

        def mem_read(offset, size):
            if size == 0:
                return b""
            if offset > 2**32 or size > 2**32:
                raise Halt()
            mem_expand(offset, size)
            return bytes(mem[offset : offset + size])

        def mem_write(offset, data):
            if not data:
                return
            if offset > 2**32:
                raise Halt()
            mem_expand(offset, len(data))
            mem[offset : offset + len(data)] = data

        tracer = self.tracer
        # fork rule set, read into locals once per frame so the hot loop
        # pays attribute access only at entry
        spec = self.spec
        warm_cold = spec.warm_cold
        has_push0 = spec.has_push0
        has_revert = spec.has_revert
        has_shifts = spec.has_shifts
        sstore_net = spec.sstore_net
        sstore_sentry = spec.sstore_sentry
        cold = None  # cold-op dispatch table, built on first cold op

        def _build_cold():
            """Dispatch table for the cold tail: env/context reads, copies,
            logs, transient storage, selfdestruct. Handlers are closures
            over this frame's cell vars (gas/pc/stack/mem), built lazily so
            small hot-only frames never pay for their construction. A
            handler returning non-None ends the frame with that value."""

            def h_sdiv():
                use(5); a, b = _sgn(pop()), _sgn(pop())
                if b == 0:
                    push(0)
                else:
                    q = abs(a) // abs(b)
                    push((q if (a < 0) == (b < 0) else -q) & MASK)

            def h_smod():
                use(5); a, b = _sgn(pop()), _sgn(pop())
                if b == 0:
                    push(0)
                else:
                    r = abs(a) % abs(b)
                    push((-r if a < 0 else r) & MASK)

            def h_addmod():
                use(8); a, b, n = pop(), pop(), pop(); push((a + b) % n if n else 0)

            def h_mulmod():
                use(8); a, b, n = pop(), pop(), pop(); push((a * b) % n if n else 0)

            def h_exp():
                a, e = pop(), pop()
                use(10 + spec.g_exp_byte * ((e.bit_length() + 7) // 8))
                push(pow(a, e, U256))

            def h_signextend():
                use(5); b, x = pop(), pop()
                if b < 31:
                    bit = 8 * (b + 1) - 1
                    if x & (1 << bit):
                        x |= MASK ^ ((1 << (bit + 1)) - 1)
                    else:
                        x &= (1 << (bit + 1)) - 1
                push(x & MASK)

            def h_byte():
                use(3); i, x = pop(), pop()
                push((x >> (8 * (31 - i))) & 0xFF if i < 32 else 0)

            def h_sar():
                use(3); s, x = pop(), _sgn(pop())
                push((x >> s if s < 256 else (0 if x >= 0 else MASK)) & MASK)

            def acct_access(addr, flat):
                """Account-touch cost: EIP-2929 warm/cold after Berlin,
                the fork's flat price before it."""
                if warm_cold:
                    return G_WARM_ACCESS if state.warm_account(addr) else G_COLD_ACCOUNT
                return flat

            def h_balance():
                addr = pop().to_bytes(32, "big")[12:]
                use(acct_access(addr, spec.g_balance))
                push(state.balance(addr))

            def h_origin():
                use(2); push(int.from_bytes(self.tx.origin, "big"))

            def h_codesize():
                use(2); push(len(code))

            def h_gasprice():
                use(2); push(self.tx.gas_price)

            def h_extcodesize():
                addr = pop().to_bytes(32, "big")[12:]
                use(acct_access(addr, spec.g_extcode))
                push(len(state.code(addr)))

            def h_extcodecopy():
                addr = pop().to_bytes(32, "big")[12:]
                d, s, size = pop(), pop(), pop()
                use(acct_access(addr, spec.g_extcode)
                    + G_COPY_WORD * ((size + 31) // 32))
                ext = state.code(addr)
                mem_write(d, ext[s : s + size].ljust(size, b"\x00") if s < len(ext) else b"\x00" * size)

            def h_extcodehash():
                addr = pop().to_bytes(32, "big")[12:]
                use(acct_access(addr, spec.g_extcodehash))
                acc = state.account(addr)
                push(0 if acc is None or acc.is_empty else int.from_bytes(acc.code_hash, "big"))

            def h_blockhash():
                use(20); n = pop()
                h = self.block.block_hashes.get(n, b"")
                push(int.from_bytes(h, "big") if h else 0)

            def h_coinbase():
                use(2); push(int.from_bytes(self.block.coinbase, "big"))

            def h_timestamp():
                use(2); push(self.block.timestamp)

            def h_number():
                use(2); push(self.block.number)

            def h_prevrandao():
                # 0x44: DIFFICULTY before the merge, PREVRANDAO after
                use(2)
                if spec.merge:
                    push(int.from_bytes(self.block.prev_randao, "big"))
                else:
                    push(self.block.difficulty)

            def h_gaslimit():
                use(2); push(self.block.gas_limit)

            def h_chainid():
                use(2); push(self.block.chain_id)

            def h_selfbalance():
                use(5); push(state.balance(fr.address))

            def h_basefee():
                use(2); push(self.block.base_fee)

            def h_blobhash():
                use(3); i = pop()
                push(int.from_bytes(self.tx.blob_hashes[i], "big") if i < len(self.tx.blob_hashes) else 0)

            def h_blobbasefee():
                use(2); push(self.block.blob_base_fee)

            def h_mstore8():
                use(3); off, v = pop(), pop(); mem_write(off, bytes([v & 0xFF]))

            def h_pc():
                use(2); push(pc - 1)

            def h_msize():
                use(2); push(len(mem))

            def h_tload():
                use(100); slot = pop().to_bytes(32, "big")
                push(self.transient.get((fr.address, slot), 0))

            def h_tstore():
                if fr.static:
                    raise Halt()
                use(100); slot, v = pop().to_bytes(32, "big"), pop()
                self.transient[(fr.address, slot)] = v

            def h_mcopy():
                d, s, size = pop(), pop(), pop()
                use(3 + G_COPY_WORD * ((size + 31) // 32))
                data = mem_read(s, size)
                mem_write(d, data)

            def h_selfdestruct():
                if fr.static:
                    raise Halt()
                ben = pop().to_bytes(32, "big")[12:]
                cost = spec.g_selfdestruct
                if warm_cold and not state.warm_account(ben):
                    cost += G_COLD_ACCOUNT
                if spec.selfdestruct_new_account == "absent":  # EIP-150
                    if not state.exists(ben):
                        cost += G_NEW_ACCOUNT
                elif spec.selfdestruct_new_account == "dead_with_value":  # EIP-161
                    if state.balance(fr.address) and state.is_empty(ben):
                        cost += G_NEW_ACCOUNT
                use(cost)
                first = state.selfdestruct(
                    fr.address, ben,
                    same_tx_only=spec.selfdestruct_same_tx_only)
                if first and spec.r_selfdestruct:  # pre-London refund
                    state.add_refund(spec.r_selfdestruct)
                return gas, b""

            table = {
                0x05: h_sdiv, 0x07: h_smod, 0x08: h_addmod, 0x09: h_mulmod,
                0x0A: h_exp, 0x0B: h_signextend, 0x1A: h_byte,
                0x31: h_balance, 0x32: h_origin, 0x38: h_codesize,
                0x3A: h_gasprice, 0x3B: h_extcodesize, 0x3C: h_extcodecopy,
                0x40: h_blockhash, 0x41: h_coinbase,
                0x42: h_timestamp, 0x43: h_number, 0x44: h_prevrandao,
                0x45: h_gaslimit,
                0x53: h_mstore8, 0x58: h_pc, 0x59: h_msize,
                0xFF: h_selfdestruct,
            }
            # fork-gated entries: an absent entry falls through to the
            # invalid-opcode Halt below, which is exactly the pre-fork
            # behavior of an unassigned opcode
            if has_shifts:
                table[0x1D] = h_sar
            if spec.has_extcodehash:
                table[0x3F] = h_extcodehash
            if spec.has_chainid:
                table[0x46] = h_chainid
            if spec.has_selfbalance:
                table[0x47] = h_selfbalance
            if spec.has_basefee:
                table[0x48] = h_basefee
            if spec.has_blob_opcodes:
                table[0x49] = h_blobhash
                table[0x4A] = h_blobbasefee
            if spec.has_transient:
                table[0x5C] = h_tload
                table[0x5D] = h_tstore
            if spec.has_mcopy:
                table[0x5E] = h_mcopy
            return table

        code_len = len(code)
        while pc < code_len:
            op = code[pc]
            if tracer is not None:
                tracer(pc, op, gas, stack, mem, fr.depth)
            pc += 1
            # -- hot tier 1: stack manipulation (the most frequent ops) --
            if 0x5F <= op <= 0x7F:  # PUSH0..PUSH32
                n = op - 0x5F
                if n == 0 and not has_push0:  # EIP-3855
                    raise Halt()
                use(2 if n == 0 else 3)
                if len(stack) >= 1024:
                    raise Halt()
                if pc + n <= code_len:
                    push(int.from_bytes(code[pc : pc + n], "big"))
                else:
                    # truncated PUSH zero-pads on the RIGHT
                    # (execution-specs buffer_read semantics)
                    push(int.from_bytes(code[pc:].ljust(n, b"\x00"), "big"))
                pc += n
                continue
            if 0x80 <= op <= 0x8F:  # DUP1..DUP16
                use(3)
                i = op - 0x7F
                if len(stack) < i or len(stack) >= 1024:
                    raise Halt()
                push(stack[-i])
                continue
            if 0x90 <= op <= 0x9F:  # SWAP1..SWAP16
                use(3)
                i = op - 0x8F
                if len(stack) < i + 1:
                    raise Halt()
                stack[-1], stack[-i - 1] = stack[-i - 1], stack[-1]
                continue

            # -- hot tier 2: control flow, arithmetic, memory, storage --
            # ordered by measured frequency, NOT opcode value; everything
            # else dispatches through the cold table below
            if op == 0x5B:  # JUMPDEST
                use(1)
            elif op == 0x57:  # JUMPI
                use(10); dest, cond = pop(), pop()
                if cond:
                    if dest not in jumpdests:
                        raise Halt()
                    pc = dest
            elif op == 0x56:  # JUMP
                use(8); dest = pop()
                if dest not in jumpdests:
                    raise Halt()
                pc = dest
            elif op == 0x01:  # ADD
                use(3); a, b = pop(), pop(); push((a + b) & MASK)
            elif op == 0x03:  # SUB
                use(3); a, b = pop(), pop(); push((a - b) & MASK)
            elif op == 0x02:  # MUL
                use(5); a, b = pop(), pop(); push((a * b) & MASK)
            elif op == 0x04:  # DIV
                use(5); a, b = pop(), pop(); push(a // b if b else 0)
            elif op == 0x06:  # MOD
                use(5); a, b = pop(), pop(); push(a % b if b else 0)
            elif op == 0x15:  # ISZERO
                use(3); push(1 if pop() == 0 else 0)
            elif op == 0x14:  # EQ
                use(3); push(1 if pop() == pop() else 0)
            elif op == 0x10:  # LT
                use(3); push(1 if pop() < pop() else 0)
            elif op == 0x11:  # GT
                use(3); push(1 if pop() > pop() else 0)
            elif op == 0x12:  # SLT
                use(3); push(1 if _sgn(pop()) < _sgn(pop()) else 0)
            elif op == 0x13:  # SGT
                use(3); push(1 if _sgn(pop()) > _sgn(pop()) else 0)
            elif op == 0x16:  # AND
                use(3); push(pop() & pop())
            elif op == 0x17:  # OR
                use(3); push(pop() | pop())
            elif op == 0x18:  # XOR
                use(3); push(pop() ^ pop())
            elif op == 0x19:  # NOT
                use(3); push(pop() ^ MASK)
            elif op == 0x1B:  # SHL (Constantinople)
                if not has_shifts:
                    raise Halt()
                use(3); s, x = pop(), pop(); push((x << s) & MASK if s < 256 else 0)
            elif op == 0x1C:  # SHR (Constantinople)
                if not has_shifts:
                    raise Halt()
                use(3); s, x = pop(), pop(); push(x >> s if s < 256 else 0)
            elif op == 0x50:  # POP
                use(2); pop()
            elif op == 0x51:  # MLOAD
                use(3); off = pop(); push(int.from_bytes(mem_read(off, 32), "big"))
            elif op == 0x52:  # MSTORE
                use(3); off, v = pop(), pop(); mem_write(off, v.to_bytes(32, "big"))
            elif op == 0x35:  # CALLDATALOAD
                use(3); i = pop()
                push(int.from_bytes(fr.data[i : i + 32].ljust(32, b"\x00"), "big") if i < len(fr.data) else 0)
            elif op == 0x36:  # CALLDATASIZE
                use(2); push(len(fr.data))
            elif op == 0x54:  # SLOAD
                slot = pop().to_bytes(32, "big")
                if warm_cold:
                    use(G_WARM_ACCESS if state.warm_slot(fr.address, slot) else G_COLD_SLOAD)
                else:
                    use(spec.g_sload)
                push(state.sload(fr.address, slot))
            elif op == 0x55:  # SSTORE
                if fr.static:
                    raise Halt()
                if sstore_sentry and gas <= sstore_sentry:  # EIP-2200
                    raise Halt()
                slot, value = pop().to_bytes(32, "big"), pop()
                if not sstore_net:
                    # legacy metering (Frontier; also Petersburg, which
                    # reverted EIP-1283): 20000 zero→nonzero, 5000 otherwise
                    current = state.sload(fr.address, slot)
                    use(G_SSTORE_SET if current == 0 and value != 0 else 5000)
                    if current != 0 and value == 0:
                        state.add_refund(spec.r_sstore_clear)
                    if value != current:
                        state.sstore(fr.address, slot, value)
                else:
                    # net metering: EIP-1283 (load leg 200) / EIP-2200 (800)
                    # / post-Berlin (warm 100 + cold 2100 surcharge)
                    g_load = spec.g_sstore_load
                    reset_cost = G_SSTORE_RESET if warm_cold else 5000
                    cold_extra = 0
                    if warm_cold and not state.warm_slot(fr.address, slot):
                        cold_extra = G_COLD_SLOAD
                    current = state.sload(fr.address, slot)
                    original = state.original_storage(fr.address, slot)
                    if value == current:
                        cost = cold_extra + g_load
                    elif current == original:
                        cost = cold_extra + (G_SSTORE_SET if original == 0 else reset_cost)
                    else:
                        cost = cold_extra + g_load
                    use(cost)
                    r_clear = spec.r_sstore_clear
                    if value != current:
                        if current == original:
                            if original != 0 and value == 0:
                                state.add_refund(r_clear)
                        else:
                            if original != 0:
                                if current == 0:
                                    state.add_refund(-r_clear)
                                elif value == 0:
                                    state.add_refund(r_clear)
                            if value == original:
                                if original == 0:
                                    state.add_refund(G_SSTORE_SET - g_load)
                                else:
                                    state.add_refund(reset_cost - g_load)
                        state.sstore(fr.address, slot, value)
            elif op == 0x20:  # KECCAK256
                off, size = pop(), pop()
                use(G_KECCAK + G_KECCAK_WORD * ((size + 31) // 32))
                push(int.from_bytes(keccak256(mem_read(off, size)), "big"))
            elif op == 0x5A:  # GAS
                use(2); push(gas)
            elif op == 0x33:  # CALLER
                use(2); push(int.from_bytes(fr.caller, "big"))
            elif op == 0x34:  # CALLVALUE
                use(2); push(fr.value)
            elif op == 0x30:  # ADDRESS
                use(2); push(int.from_bytes(fr.address, "big"))
            elif op == 0x37:  # CALLDATACOPY
                d, s, size = pop(), pop(), pop()
                use(3 + G_COPY_WORD * ((size + 31) // 32))
                mem_write(d, fr.data[s : s + size].ljust(size, b"\x00") if s < len(fr.data) else b"\x00" * size)
            elif op == 0x39:  # CODECOPY
                d, s, size = pop(), pop(), pop()
                use(3 + G_COPY_WORD * ((size + 31) // 32))
                mem_write(d, code[s : s + size].ljust(size, b"\x00") if s < len(code) else b"\x00" * size)
            elif 0xA0 <= op <= 0xA4:  # LOG0..LOG4
                if fr.static:
                    raise Halt()
                n = op - 0xA0
                off, size = pop(), pop()
                topics = tuple(pop().to_bytes(32, "big") for _ in range(n))
                use(G_LOG + G_LOG_TOPIC * n + G_LOG_BYTE * size)
                data = mem_read(off, size)
                from ..primitives.types import Log

                state.add_log(Log(fr.address, topics, data))
            elif op == 0x3D:  # RETURNDATASIZE (Byzantium)
                if not has_revert:
                    raise Halt()
                use(2); push(len(returndata))
            elif op == 0x3E:  # RETURNDATACOPY (Byzantium)
                if not has_revert:
                    raise Halt()
                d, s, size = pop(), pop(), pop()
                use(3 + G_COPY_WORD * ((size + 31) // 32))
                if s + size > len(returndata):
                    raise Halt()
                mem_write(d, returndata[s : s + size])
            elif op == 0x00:  # STOP
                return gas, b""
            elif op == 0xF3:  # RETURN
                off, size = pop(), pop()
                return gas, mem_read(off, size)
            elif op == 0xFD:  # REVERT (Byzantium)
                if not has_revert:
                    raise Halt()
                off, size = pop(), pop()
                r = Revert(mem_read(off, size))
                r.gas_left = gas
                raise r
            elif op in (0xF1, 0xF2, 0xF4, 0xFA):  # CALL/CALLCODE/DELEGATECALL/STATICCALL
                if op == 0xF4 and not spec.has_delegatecall:  # Homestead
                    raise Halt()
                if op == 0xFA and not has_revert:  # Byzantium
                    raise Halt()
                g = pop()
                addr = pop().to_bytes(32, "big")[12:]
                value = pop() if op in (0xF1, 0xF2) else 0
                ain, ains, aout, aouts = pop(), pop(), pop(), pop()
                if fr.static and value and op == 0xF1:
                    raise Halt()
                if warm_cold:
                    extra = G_WARM_ACCESS if state.warm_account(addr) else G_COLD_ACCOUNT
                else:
                    extra = spec.g_call
                if value:
                    extra += G_CALL_VALUE
                if op == 0xF1:
                    # new-account surcharge: pre-EIP-161 whenever the target
                    # is absent; after, only for a value transfer to a dead
                    # account
                    if spec.new_account_charge_always:
                        if not state.exists(addr):
                            extra += G_NEW_ACCOUNT
                    elif value and state.is_empty(addr):
                        extra += G_NEW_ACCOUNT
                use(extra)
                if spec.has_setcode:
                    # EIP-7702: a delegation designator executes the
                    # delegate's code (one level, delegate access charged)
                    run_code, tgt = resolve_delegation(state, addr)
                    if tgt is not None:
                        use(G_WARM_ACCESS if state.warm_account(tgt) else G_COLD_ACCOUNT)
                else:
                    run_code = state.code(addr)
                data = mem_read(ain, ains)
                mem_expand(aout, aouts)
                if spec.call_63_64:
                    child_gas = min(g, gas - gas // 64)
                else:  # pre-EIP-150: the requested gas, or out-of-gas
                    child_gas = g
                use(child_gas)
                if value:
                    child_gas += G_CALL_STIPEND
                if op == 0xF1:  # CALL
                    sub = CallFrame(fr.address, addr, run_code, data, value,
                                    child_gas, fr.static, fr.depth + 1, kind="CALL")
                elif op == 0xF2:  # CALLCODE
                    sub = CallFrame(fr.address, fr.address, run_code, data,
                                    value, child_gas, fr.static, fr.depth + 1,
                                    kind="CALLCODE")
                elif op == 0xF4:  # DELEGATECALL: parent's value/caller, NO transfer
                    sub = CallFrame(fr.caller, fr.address, run_code, data,
                                    fr.value, child_gas, fr.static, fr.depth + 1,
                                    transfer_value=False, kind="DELEGATECALL")
                else:  # STATICCALL
                    sub = CallFrame(fr.address, addr, run_code, data, 0,
                                    child_gas, True, fr.depth + 1, kind="STATICCALL")
                try:
                    ok, gas_left, out = yield ("call", sub)
                except Revert as r:
                    # child reverted: its unused gas comes back, output exposed
                    ok, out = False, r.output
                    gas_left = getattr(r, "gas_left", 0)
                gas += gas_left
                returndata = out
                mem[aout : aout + min(aouts, len(out))] = out[: aouts]
                push(1 if ok else 0)
            elif op == 0xF0 or op == 0xF5:  # CREATE / CREATE2
                if op == 0xF5 and not spec.has_create2:  # Constantinople
                    raise Halt()
                if fr.static:
                    raise Halt()
                value = pop(); off = pop(); size = pop()
                salt = pop().to_bytes(32, "big") if op == 0xF5 else None
                words = (size + 31) // 32
                use(G_CREATE
                    + (G_INITCODE_WORD * words if spec.initcode_limit else 0)
                    + (G_KECCAK_WORD * words if op == 0xF5 else 0))
                if spec.initcode_limit and size > MAX_INITCODE_SIZE:
                    raise Halt()
                initcode = mem_read(off, size)
                child_gas = gas - gas // 64 if spec.call_63_64 else gas
                use(child_gas)
                ok, gas_left, addr, out = yield (
                    "create",
                    (fr.address, value, initcode, child_gas, fr.depth + 1, salt),
                )
                gas += gas_left
                returndata = out
                push(int.from_bytes(addr, "big") if ok else 0)
            elif op == 0xFE:  # INVALID
                raise Halt()
            else:
                # -- cold tier: table dispatch ---------------------------
                if cold is None:
                    cold = _build_cold()
                h = cold.get(op)
                if h is None:
                    raise Halt()
                res = h()
                if res is not None:  # SELFDESTRUCT ends the frame
                    return res
        return gas, b""


def _sgn(x: int) -> int:
    return x - U256 if x & SIGN_BIT else x


_JUMPDEST_CACHE: dict[bytes, set[int]] = {}


def _jumpdests_cached(code: bytes) -> set[int]:
    """Per-code jumpdest analysis, cached: the scan is O(len(code)) and a
    hot contract is entered thousands of times per block (revm caches its
    analysis on the bytecode object the same way). Keyed by the code
    bytes — their hash is computed once and cached by CPython."""
    dests = _JUMPDEST_CACHE.get(code)
    if dests is None:
        if len(_JUMPDEST_CACHE) >= 1024:
            _JUMPDEST_CACHE.clear()  # bounded; rebuild is cheap
        dests = _jumpdests(code)
        _JUMPDEST_CACHE[code] = dests
    return dests


def _jumpdests(code: bytes) -> set[int]:
    dests = set()
    i = 0
    n = len(code)
    while i < n:
        op = code[i]
        if op == 0x5B:
            dests.add(i)
        if 0x60 <= op <= 0x7F:
            i += op - 0x5F
        i += 1
    return dests


# -- precompiles --------------------------------------------------------------


def _pre_ecrecover(data: bytes, gas: int):
    if gas < 3000:
        return False, 0, b""
    gas -= 3000
    data = data.ljust(128, b"\x00")[:128]
    h = data[:32]
    v = int.from_bytes(data[32:64], "big")
    r = int.from_bytes(data[64:96], "big")
    s = int.from_bytes(data[96:128], "big")
    if v not in (27, 28):
        return True, gas, b""
    from ..primitives.secp256k1 import ecrecover

    try:
        addr = ecrecover(h, v - 27, r, s, allow_high_s=True)
    except ValueError:
        return True, gas, b""
    return True, gas, addr.rjust(32, b"\x00")


def _pre_sha256(data: bytes, gas: int):
    cost = 60 + 12 * ((len(data) + 31) // 32)
    if gas < cost:
        return False, 0, b""
    return True, gas - cost, hashlib.sha256(data).digest()


def _pre_ripemd160(data: bytes, gas: int):
    cost = 600 + 120 * ((len(data) + 31) // 32)
    if gas < cost:
        return False, 0, b""
    try:
        h = hashlib.new("ripemd160", data).digest()
    except ValueError:
        return False, 0, b""
    return True, gas - cost, h.rjust(32, b"\x00")


def _pre_identity(data: bytes, gas: int):
    cost = 15 + 3 * ((len(data) + 31) // 32)
    if gas < cost:
        return False, 0, b""
    return True, gas - cost, data


def _pre_modexp(data: bytes, gas: int, eip2565: bool = True):
    """0x05 modexp: EIP-2565 pricing (Berlin) or EIP-198 (Byzantium)."""
    data = bytes(data)
    bl = int.from_bytes(data[0:32].ljust(32, b"\x00"), "big")
    el = int.from_bytes(data[32:64].ljust(32, b"\x00"), "big")
    ml = int.from_bytes(data[64:96].ljust(32, b"\x00"), "big")
    if bl > 4096 or el > 4096 or ml > 4096:
        return False, 0, b""
    body = data[96:].ljust(bl + el + ml, b"\x00")
    b_ = int.from_bytes(body[:bl], "big")
    e_ = int.from_bytes(body[bl : bl + el], "big")
    m_ = int.from_bytes(body[bl + el : bl + el + ml], "big")
    # adjusted exponent length (shared by both pricings): full bit length
    # for short exponents, else 8*(len-32) + bits of the leading 32 bytes
    head = int.from_bytes(body[bl : bl + min(32, el)], "big")
    if el <= 32:
        adj = head.bit_length() - 1 if head else 0
    else:
        adj = 8 * (el - 32) + (head.bit_length() - 1 if head else 0)
    if eip2565:
        words = (max(bl, ml) + 7) // 8
        cost = max(200, words * words * max(1, adj) // 3)
    else:  # EIP-198
        x = max(bl, ml)
        if x <= 64:
            mult = x * x
        elif x <= 1024:
            mult = x * x // 4 + 96 * x - 3072
        else:
            mult = x * x // 16 + 480 * x - 199_680
        cost = mult * max(1, adj) // 20
    if gas < cost:
        return False, 0, b""
    out = pow(b_, e_, m_).to_bytes(ml, "big") if m_ else b"\x00" * ml
    return True, gas - cost, out


def _bn_g1_point(data: bytes):
    """64-byte (x, y) -> validated bn254 G1 point; raises on bad input."""
    from ..primitives.pairing import BN254, g1_group

    x = int.from_bytes(data[:32], "big")
    y = int.from_bytes(data[32:64], "big")
    if x == 0 and y == 0:
        return None
    if x >= BN254.p or y >= BN254.p or not g1_group(BN254).on_curve((x, y)):
        raise ValueError("invalid bn254 G1 point")
    return (x, y)


def _pre_bn_add(data: bytes, gas: int, price: int = 150):
    """0x06 alt_bn128 ADD (EIP-196; 500 gas, 150 since EIP-1108)."""
    if gas < price:
        return False, 0, b""
    gas -= price
    from ..primitives.pairing import BN254, g1_group

    data = data.ljust(128, b"\x00")[:128]
    try:
        a = _bn_g1_point(data[0:64])
        b = _bn_g1_point(data[64:128])
    except ValueError:
        return False, 0, b""
    s = g1_group(BN254).padd(a, b)
    if s is None:
        return True, gas, b"\x00" * 64
    return True, gas, s[0].to_bytes(32, "big") + s[1].to_bytes(32, "big")


def _pre_bn_mul(data: bytes, gas: int, price: int = 6000):
    """0x07 alt_bn128 MUL (EIP-196; 40000 gas, 6000 since EIP-1108)."""
    if gas < price:
        return False, 0, b""
    gas -= price
    from ..primitives.pairing import BN254, g1_group

    data = data.ljust(96, b"\x00")[:96]
    try:
        a = _bn_g1_point(data[0:64])
    except ValueError:
        return False, 0, b""
    k = int.from_bytes(data[64:96], "big")
    s = g1_group(BN254).mul_scalar(a, k) if a is not None else None
    if s is None:
        return True, gas, b"\x00" * 64
    return True, gas, s[0].to_bytes(32, "big") + s[1].to_bytes(32, "big")


def _pre_bn_pairing(data: bytes, gas: int, base: int = 45_000, per: int = 34_000):
    """0x08 alt_bn128 pairing check (EIP-197; EIP-1108 gas). G2 Fp2
    coordinates arrive imaginary-part first: [x_c1, x_c0, y_c1, y_c0]."""
    if len(data) % 192 != 0:
        return False, 0, b""
    k = len(data) // 192
    cost = base + per * k
    if gas < cost:
        return False, 0, b""
    gas -= cost
    from ..primitives.pairing import BN254, g2_valid, pairing_product_is_one

    pairs = []
    for i in range(k):
        chunk = data[i * 192 : (i + 1) * 192]
        try:
            p1 = _bn_g1_point(chunk[0:64])
        except ValueError:
            return False, 0, b""
        x = (int.from_bytes(chunk[96:128], "big"), int.from_bytes(chunk[64:96], "big"))
        y = (int.from_bytes(chunk[160:192], "big"), int.from_bytes(chunk[128:160], "big"))
        q2 = None if x == (0, 0) and y == (0, 0) else (x, y)
        if q2 is not None and not g2_valid(q2, BN254):
            return False, 0, b""
        if p1 is not None and q2 is not None:
            pairs.append((p1, q2))
    ok = pairing_product_is_one(pairs, BN254) if pairs else True
    return True, gas, (1 if ok else 0).to_bytes(32, "big")


def _pre_blake2f(data: bytes, gas: int):
    """0x09 blake2b F compression (EIP-152)."""
    if len(data) != 213:
        return False, 0, b""
    rounds = int.from_bytes(data[0:4], "big")
    final = data[212]
    if final not in (0, 1):
        return False, 0, b""
    if gas < rounds:
        return False, 0, b""
    from ..primitives.blake2 import blake2f

    h = [int.from_bytes(data[4 + 8 * i : 12 + 8 * i], "little") for i in range(8)]
    m = [int.from_bytes(data[68 + 8 * i : 76 + 8 * i], "little") for i in range(16)]
    t0 = int.from_bytes(data[196:204], "little")
    t1 = int.from_bytes(data[204:212], "little")
    out = blake2f(rounds, h, m, t0, t1, final == 1)
    return True, gas - rounds, b"".join(v.to_bytes(8, "little") for v in out)


def _pre_point_eval(data: bytes, gas: int):
    """0x0a KZG point evaluation (EIP-4844): verify p(z) == y against a
    versioned-hash-bound commitment."""
    if gas < 50000:
        return False, 0, b""
    gas -= 50000
    if len(data) != 192:
        return False, 0, b""
    from ..primitives import kzg

    versioned_hash = data[0:32]
    z = int.from_bytes(data[32:64], "big")
    y = int.from_bytes(data[64:96], "big")
    commitment_b = data[96:144]
    proof_b = data[144:192]
    if z >= kzg.BLS_MODULUS or y >= kzg.BLS_MODULUS:
        return False, 0, b""
    if kzg.kzg_to_versioned_hash(commitment_b) != versioned_hash:
        return False, 0, b""
    try:
        commitment = kzg.g1_from_bytes(commitment_b)
        proof = kzg.g1_from_bytes(proof_b)
    except kzg.KzgError:
        return False, 0, b""
    if not kzg.verify_kzg_proof(commitment, z, y, proof):
        return False, 0, b""
    out = kzg.FIELD_ELEMENTS_PER_BLOB.to_bytes(32, "big") + kzg.BLS_MODULUS.to_bytes(32, "big")
    return True, gas, out


class PrecompileNotImplemented(NotImplementedError):
    """A precompile in the active fork's address range whose operation this
    repo cannot faithfully implement. Raised INSTEAD of behaving like an
    empty account: a silent stub would produce a wrong-but-plausible state
    root and break the native/interpreter bit-identical invariant without
    anyone noticing (round-5 verdict). The block executor surfaces this as
    a BlockExecutionError — loud, block-invalidating, grep-able."""


def _pre_bls_g1add(data: bytes, gas: int):
    """0x0b BLS12_G1ADD (EIP-2537): 375 gas, no subgroup check."""
    if gas < 375:
        return False, 0, b""
    from ..primitives import bls12381 as bls

    try:
        out = bls.g1add_precompile(bytes(data))
    except bls.BlsError:
        return False, 0, b""
    return True, gas - 375, out


def _pre_bls_g2add(data: bytes, gas: int):
    """0x0d BLS12_G2ADD (EIP-2537): 600 gas, no subgroup check."""
    if gas < 600:
        return False, 0, b""
    from ..primitives import bls12381 as bls

    try:
        out = bls.g2add_precompile(bytes(data))
    except bls.BlsError:
        return False, 0, b""
    return True, gas - 600, out


def _pre_bls_g1msm(data: bytes, gas: int):
    """0x0c BLS12_G1MSM (EIP-2537): discounted per-pair gas, curve AND
    subgroup check on every input point."""
    from ..primitives import bls12381 as bls

    if len(data) == 0 or len(data) % 160 != 0:
        return False, 0, b""
    cost = bls.g1msm_gas(len(data) // 160)
    if gas < cost:
        return False, 0, b""
    try:
        out = bls.g1msm_precompile(bytes(data))
    except bls.BlsError:
        return False, 0, b""
    return True, gas - cost, out


def _pre_bls_g2msm(data: bytes, gas: int):
    """0x0e BLS12_G2MSM (EIP-2537): discounted per-pair gas, curve AND
    subgroup check on every input point."""
    from ..primitives import bls12381 as bls

    if len(data) == 0 or len(data) % 288 != 0:
        return False, 0, b""
    cost = bls.g2msm_gas(len(data) // 288)
    if gas < cost:
        return False, 0, b""
    try:
        out = bls.g2msm_precompile(bytes(data))
    except bls.BlsError:
        return False, 0, b""
    return True, gas - cost, out


def _pre_bls_pairing(data: bytes, gas: int):
    """0x0f BLS12_PAIRING_CHECK (EIP-2537): per-pair gas, curve AND
    subgroup check on every input point, 32-byte 0/1 output."""
    from ..primitives import bls12381 as bls

    if len(data) == 0 or len(data) % 384 != 0:
        return False, 0, b""
    cost = bls.pairing_gas(len(data) // 384)
    if gas < cost:
        return False, 0, b""
    try:
        out = bls.pairing_precompile(bytes(data))
    except bls.BlsError:
        return False, 0, b""
    return True, gas - cost, out


def _pre_bls_map_fp_to_g1(data: bytes, gas: int):
    """0x10 BLS12_MAP_FP_TO_G1 (EIP-2537): 5500 gas, RFC 9380 SSWU +
    11-isogeny + effective-cofactor clearing."""
    from ..primitives import bls12381 as bls

    if gas < bls.MAP_FP_TO_G1_GAS:
        return False, 0, b""
    try:
        out = bls.map_fp_to_g1_precompile(bytes(data))
    except bls.BlsError:
        return False, 0, b""
    return True, gas - bls.MAP_FP_TO_G1_GAS, out


def _pre_bls_map_fp2_to_g2(data: bytes, gas: int):
    """0x11 BLS12_MAP_FP2_TO_G2 (EIP-2537): 23800 gas, RFC 9380 SSWU +
    3-isogeny + effective-cofactor clearing."""
    from ..primitives import bls12381 as bls

    if gas < bls.MAP_FP2_TO_G2_GAS:
        return False, 0, b""
    try:
        out = bls.map_fp2_to_g2_precompile(bytes(data))
    except bls.BlsError:
        return False, 0, b""
    return True, gas - bls.MAP_FP2_TO_G2_GAS, out


_RAW_PRECOMPILES = {
    1: _pre_ecrecover,
    2: _pre_sha256,
    3: _pre_ripemd160,
    4: _pre_identity,
    5: _pre_modexp,
    6: _pre_bn_add,
    7: _pre_bn_mul,
    8: _pre_bn_pairing,
    9: _pre_blake2f,
    10: _pre_point_eval,
    # EIP-2537 (Prague): the full table — affine ADD/MSM with subgroup
    # checks, the pairing check over primitives/pairing.py, and the RFC
    # 9380 SSWU+isogeny maps (primitives/bls12381.py)
    11: _pre_bls_g1add,
    12: _pre_bls_g1msm,
    13: _pre_bls_g2add,
    14: _pre_bls_g2msm,
    15: _pre_bls_pairing,
    16: _pre_bls_map_fp_to_g1,
    17: _pre_bls_map_fp2_to_g2,
}

# -- precompile result cache (reference engine/tree precompile_cache.rs) ------
# Precompiles are pure: (index, input) fully determines the output and the
# charged gas. The expensive ones (modexp, bn254 add/mul/pairing, KZG point
# evaluation, ecrecover) cache their successful results across calls,
# transactions, and blocks; failures are gas-dependent and never cached.

from collections import OrderedDict as _OrderedDict
from threading import Lock as _Lock

_PRECOMPILE_CACHE: "_OrderedDict[tuple[int, bytes], tuple[int, bytes]]" = _OrderedDict()
_PRECOMPILE_CACHE_MAX = 2048
_CACHED_INDICES = frozenset({1, 5, 6, 7, 8, 10, 15, 16, 17})
# prewarm workers overlap canonical execution (engine/tree.py starts
# PrewarmTask without joining), so the LRU bookkeeping must be guarded —
# an unguarded get()+move_to_end can race a popitem eviction
_PRECOMPILE_CACHE_LOCK = _Lock()
precompile_cache_stats = {"hits": 0, "misses": 0}


def _cached_precompile(idx: int, fn, era: str = ""):
    def run(data, gas: int):
        key = (idx, era, bytes(data))
        with _PRECOMPILE_CACHE_LOCK:
            hit = _PRECOMPILE_CACHE.get(key)
            if hit is not None:
                _PRECOMPILE_CACHE.move_to_end(key)
                precompile_cache_stats["hits"] += 1
            else:
                precompile_cache_stats["misses"] += 1
        if hit is not None:
            charged, out = hit
            if gas < charged:
                return False, 0, b""
            return True, gas - charged, out
        ok, gas_left, out = fn(data, gas)
        if ok:
            with _PRECOMPILE_CACHE_LOCK:
                _PRECOMPILE_CACHE[key] = (gas - gas_left, out)
                while len(_PRECOMPILE_CACHE) > _PRECOMPILE_CACHE_MAX:
                    _PRECOMPILE_CACHE.popitem(last=False)
        return ok, gas_left, out

    return run


# per-era dispatch tables: precompile availability and pricing both vary
# by fork (reference: revm builds its precompile set per SpecId)
_ERA_TABLES: dict[tuple, dict] = {}


def _era_table(spec) -> dict:
    key = (min(spec.precompiles, 17), spec.modexp_eip2565, spec.bn_add_gas)
    table = _ERA_TABLES.get(key)
    if table is not None:
        return table
    import functools

    table = {i: _RAW_PRECOMPILES[i] for i in range(1, key[0] + 1)}
    if 5 in table and not spec.modexp_eip2565:
        table[5] = functools.partial(_pre_modexp, eip2565=False)
    if 6 in table and spec.bn_add_gas != 150:
        table[6] = functools.partial(_pre_bn_add, price=spec.bn_add_gas)
        table[7] = functools.partial(_pre_bn_mul, price=spec.bn_mul_gas)
        table[8] = functools.partial(_pre_bn_pairing, base=spec.bn_pair_base,
                                     per=spec.bn_pair_per)
    era = f"{int(spec.modexp_eip2565)}:{spec.bn_add_gas}"
    for i in _CACHED_INDICES:
        if i in table:
            table[i] = _cached_precompile(i, table[i], era)
    _ERA_TABLES[key] = table
    return table


_PRECOMPILES = _era_table(LATEST_SPEC)  # latest-rules table (tests, tools)


def _precompile(address: bytes, spec: Spec | None = None):
    if spec is None:
        spec = LATEST_SPEC
    if address[:19] == b"\x00" * 19 and 1 <= address[19] <= spec.precompiles:
        return _era_table(spec).get(address[19])
    return None
