"""debug_* and trace-adjacent namespaces.

A copy of the JAX package's ``rpc/debug.py``. ``debug_executionWitness``
generates its witness on the tree's committer (kernel 1 on the card). Not
ported yet, and not registered: ``debug_healthCheck``, ``debug_sloStatus``,
``debug_metricsHistory`` (they need the node's health engine),
``debug_fleetMetrics`` (the fleet), and ``debug_flightRecorder``'s
``action="correlated"`` (merged multi-process dumps), which answers as an
unknown action.

Reference analogue: crates/rpc/rpc debug module (Geth-style tracers,
src/debug.rs). `debug_traceTransaction` re-executes the block up to the
target transaction against the parent state, then runs the target with
the opcode struct logger attached (the default Geth tracer shape).
"""

from __future__ import annotations

OPNAMES = {
    0x00: "STOP", 0x01: "ADD", 0x02: "MUL", 0x03: "SUB", 0x04: "DIV",
    0x05: "SDIV", 0x06: "MOD", 0x07: "SMOD", 0x08: "ADDMOD", 0x09: "MULMOD",
    0x0A: "EXP", 0x0B: "SIGNEXTEND", 0x10: "LT", 0x11: "GT", 0x12: "SLT",
    0x13: "SGT", 0x14: "EQ", 0x15: "ISZERO", 0x16: "AND", 0x17: "OR",
    0x18: "XOR", 0x19: "NOT", 0x1A: "BYTE", 0x1B: "SHL", 0x1C: "SHR",
    0x1D: "SAR", 0x20: "KECCAK256", 0x30: "ADDRESS", 0x31: "BALANCE",
    0x32: "ORIGIN", 0x33: "CALLER", 0x34: "CALLVALUE", 0x35: "CALLDATALOAD",
    0x36: "CALLDATASIZE", 0x37: "CALLDATACOPY", 0x38: "CODESIZE",
    0x39: "CODECOPY", 0x3A: "GASPRICE", 0x3B: "EXTCODESIZE",
    0x3C: "EXTCODECOPY", 0x3D: "RETURNDATASIZE", 0x3E: "RETURNDATACOPY",
    0x3F: "EXTCODEHASH", 0x40: "BLOCKHASH", 0x41: "COINBASE",
    0x42: "TIMESTAMP", 0x43: "NUMBER", 0x44: "PREVRANDAO", 0x45: "GASLIMIT",
    0x46: "CHAINID", 0x47: "SELFBALANCE", 0x48: "BASEFEE", 0x49: "BLOBHASH",
    0x4A: "BLOBBASEFEE", 0x50: "POP", 0x51: "MLOAD", 0x52: "MSTORE",
    0x53: "MSTORE8", 0x54: "SLOAD", 0x55: "SSTORE", 0x56: "JUMP",
    0x57: "JUMPI", 0x58: "PC", 0x59: "MSIZE", 0x5A: "GAS", 0x5B: "JUMPDEST",
    0x5C: "TLOAD", 0x5D: "TSTORE", 0x5E: "MCOPY",
    0xF0: "CREATE", 0xF1: "CALL", 0xF2: "CALLCODE", 0xF3: "RETURN",
    0xF4: "DELEGATECALL", 0xF5: "CREATE2", 0xFA: "STATICCALL",
    0xFD: "REVERT", 0xFE: "INVALID", 0xFF: "SELFDESTRUCT",
}
for _n in range(33):
    OPNAMES[0x5F + _n] = f"PUSH{_n}"
for _n in range(16):
    OPNAMES[0x80 + _n] = f"DUP{_n + 1}"
    OPNAMES[0x90 + _n] = f"SWAP{_n + 1}"
for _n in range(5):
    OPNAMES[0xA0 + _n] = f"LOG{_n}"


class StructLogger:
    """Geth default-tracer struct logs (pc/op/gas/depth/stack)."""

    def __init__(self, with_memory: bool = False, limit: int = 100_000):
        self.logs: list[dict] = []
        self.with_memory = with_memory
        self.limit = limit

    def __call__(self, pc, op, gas, stack, mem, depth):
        if len(self.logs) >= self.limit:
            return
        entry = {
            "pc": pc,
            "op": OPNAMES.get(op, f"opcode 0x{op:x}"),
            "gas": gas,
            "depth": depth + 1,
            "stack": [hex(v) for v in stack],
        }
        if self.with_memory:
            entry["memory"] = ["0x" + bytes(mem[i : i + 32]).hex()
                               for i in range(0, len(mem), 32)]
        self.logs.append(entry)


class CallTracer:
    """Geth callTracer: nested call frames (from/to/value/gas/input/output).

    Uses the interpreter's frame enter/exit hooks; opcode steps ignored.
    """

    def __init__(self):
        self.root: dict | None = None
        self._stack: list[dict] = []

    def __call__(self, pc, op, gas, stack, mem, depth):
        pass  # frame-level tracer: per-opcode events unused

    def on_enter(self, kind, frame):
        node = {
            "type": kind,
            "from": "0x" + frame.caller.hex(),
            "to": "0x" + frame.address.hex(),
            "value": hex(frame.value),
            "gas": hex(frame.gas),
            "input": "0x" + frame.data.hex(),
            "calls": [],
        }
        if self._stack:
            self._stack[-1]["calls"].append(node)
        else:
            self.root = node
        self._stack.append(node)

    def on_exit(self, frame, ok, gas_left, output, error):
        node = self._stack.pop()
        node["gasUsed"] = hex(max(0, int(node["gas"], 16) - gas_left))
        node["output"] = "0x" + output.hex()
        if error:
            node["error"] = error

    def result(self) -> dict:
        node = self.root or {}
        _strip_empty_calls(node)
        return node


def _strip_empty_calls(node: dict):
    if not node.get("calls"):
        node.pop("calls", None)
    else:
        for c in node["calls"]:
            _strip_empty_calls(c)


def _flatten_parity(node: dict, trace_address: list, out: list):
    """callTracer tree → Parity trace_transaction flat frames."""
    action = {
        "callType": node["type"].lower(),
        "from": node["from"],
        "to": node["to"],
        "value": node["value"],
        "gas": node["gas"],
        "input": node["input"],
    }
    entry = {
        "action": action,
        "type": "call",
        "traceAddress": list(trace_address),
        "subtraces": len(node.get("calls", [])),
    }
    if "error" in node:
        entry["error"] = node["error"]
    else:
        entry["result"] = {"gasUsed": node.get("gasUsed", "0x0"),
                           "output": node.get("output", "0x")}
    out.append(entry)
    for i, child in enumerate(node.get("calls", [])):
        _flatten_parity(child, trace_address + [i], out)


class DebugApi:
    def __init__(self, eth_api):
        self.eth = eth_api

    def trace_transaction(self, tx_hash):
        """Parity trace_transaction: flat call frames."""
        tracer = CallTracer()
        self._replay(tx_hash, tracer)
        frames: list = []
        if tracer.root is not None:
            _flatten_parity(tracer.result(), [], frames)
        return frames

    def debug_traceTransaction(self, tx_hash, opts=None):
        opts = opts or {}
        from .convert import qty

        tracer, is_call_tracer = self._make_tracer(opts)
        result = self._replay(tx_hash, tracer)
        return self._shape_result(tracer, is_call_tracer, result.gas_used,
                                  result.success, result.output)

    def _replay(self, tx_hash, tracer):
        """Re-execute the block prefix, then the target tx with ``tracer``."""
        from ..evm import BlockExecutor
        from ..evm.state import EvmState
        from ..storage.tables import Tables, from_be64
        from .convert import parse_data, qty
        from .server import RpcError

        h = parse_data(tx_hash)
        p = self.eth._provider()
        raw = p.tx.get(Tables.TransactionHashNumbers.name, h)
        if raw is None:
            raise RpcError(-32000, "transaction not found")
        tx_num = from_be64(raw)
        block_num = self.eth._block_of_tx(p, tx_num)
        if block_num is None:
            raise RpcError(-32000, "transaction not found in any block")
        block = p.block_by_number(block_num)
        idx = p.block_body_indices(block_num)
        target_i = tx_num - idx.first_tx_num

        # parent state through the SAME guards as eth state queries (prune
        # horizon, unknown blocks) — never trace against silently-wrong state
        parent_state = self.eth._state_at(qty(block_num - 1)) if block_num > 0 else p
        executor = BlockExecutor(parent_state, self.eth.tree.config)
        from ..evm.interpreter import BlockEnv

        header = block.header
        block_hashes = {}
        for k in range(max(0, block_num - 256), block_num):
            bh = p.canonical_hash(k)
            if bh:
                block_hashes[k] = bh
        env = BlockEnv(
            number=header.number, timestamp=header.timestamp,
            coinbase=header.beneficiary, gas_limit=header.gas_limit,
            base_fee=header.base_fee_per_gas or 0, prev_randao=header.mix_hash,
            chain_id=self.eth.chain_id, block_hashes=block_hashes,
        )
        state = EvmState(parent_state)
        senders = [p.sender(idx.first_tx_num + i) or block.transactions[i].recover_sender()
                   for i in range(target_i + 1)]
        gas_left_in_block = header.gas_limit
        for i in range(target_i):
            r = executor._execute_tx(state, env, block.transactions[i], senders[i],
                                     gas_left_in_block)
            gas_left_in_block -= r.gas_used

        return executor._execute_tx(
            state, env, block.transactions[target_i], senders[target_i],
            gas_left_in_block, tracer=tracer,
        )

    @staticmethod
    def _make_tracer(opts):
        """Shared tracer selection for every debug_trace* entry point."""
        if opts.get("tracer") == "callTracer":
            return CallTracer(), True
        return StructLogger(with_memory=bool(opts.get("enableMemory"))), False

    @staticmethod
    def _shape_result(tracer, is_call_tracer, gas_used, ok, output):
        from .convert import qty

        if is_call_tracer:
            return tracer.result()
        return {
            "gas": qty(gas_used),
            "failed": not ok,
            "returnValue": output.hex(),
            "structLogs": tracer.logs,
        }

    def debug_traceCall(self, call, tag="latest", opts=None):
        """Run an eth_call-shaped request under a tracer at the given
        block (reference debug_traceCall, rpc-api/src/debug.rs:105)."""
        from ..evm.executor import ProviderStateSource, intrinsic_gas
        from ..evm.interpreter import Interpreter, Revert, TxEnv
        from ..evm.state import EvmState
        from ..primitives.types import Transaction
        from .convert import parse_data

        opts = opts or {}
        p = self.eth._state_at(tag)
        env = self.eth._call_env(tag)
        sender = parse_data(call.get("from", "0x" + "00" * 20))
        state = EvmState(ProviderStateSource(p))
        tracer, is_call_tracer = self._make_tracer(opts)
        interp = Interpreter(state, env, TxEnv(origin=sender),
                             tracer=tracer)
        frame = self.eth._build_call_frame(call, state, env)
        gas = frame.gas
        try:
            ok, gas_left, out = interp.call(frame)
        except Revert as r:
            ok, gas_left, out = False, getattr(r, "gas_left", 0), r.output
        # report tx-shaped gas (intrinsic included) so the number lines
        # up with traceTransaction/receipts for the same action
        fake_tx = Transaction(
            to=frame.address if call.get("to") else None, data=frame.data)
        gas_used = gas - gas_left + intrinsic_gas(fake_tx)
        return self._shape_result(tracer, is_call_tracer, gas_used, ok, out)

    def debug_traceBlockByNumber(self, tag, opts=None):
        """Trace every transaction of a block (reference
        debug_traceBlockByNumber, crates/rpc/rpc/src/debug.rs)."""
        p = self.eth._provider()
        n = self.eth._resolve_number(tag, p)
        return self._trace_block(p, n, opts)

    def debug_traceBlockByHash(self, block_hash, opts=None):
        from .convert import parse_data
        from .server import RpcError

        p = self.eth._provider()
        n = p.block_number(parse_data(block_hash))
        if n is None:
            raise RpcError(-32000, "unknown block")
        return self._trace_block(p, n, opts)

    def _trace_block(self, p, block_num, opts):
        """Execute the block ONCE, attaching a fresh tracer to each tx on
        the shared state — not one whole-prefix replay per tx."""
        from ..evm import BlockExecutor
        from ..evm.interpreter import BlockEnv
        from ..evm.state import EvmState
        from .convert import data, qty
        from .server import RpcError

        opts = opts or {}
        block = p.block_by_number(block_num)
        if block is None or block_num == 0:
            raise RpcError(-32000, "unknown block (or genesis)")
        idx = p.block_body_indices(block_num)
        parent_state = (self.eth._state_at(qty(block_num - 1))
                        if block_num > 0 else p)
        executor = BlockExecutor(parent_state,
                                 self.eth.tree.config)
        header = block.header
        block_hashes = {}
        for k in range(max(0, block_num - 256), block_num):
            bh = p.canonical_hash(k)
            if bh:
                block_hashes[k] = bh
        env = BlockEnv(
            number=header.number, timestamp=header.timestamp,
            coinbase=header.beneficiary, gas_limit=header.gas_limit,
            base_fee=header.base_fee_per_gas or 0,
            prev_randao=header.mix_hash,
            chain_id=self.eth.chain_id, block_hashes=block_hashes,
        )
        state = EvmState(parent_state)
        gas_left_in_block = header.gas_limit
        out = []
        for i, tx in enumerate(block.transactions):
            sender = (p.sender(idx.first_tx_num + i)
                      or tx.recover_sender())
            tracer, is_call_tracer = self._make_tracer(opts)
            result = executor._execute_tx(state, env, tx, sender,
                                          gas_left_in_block, tracer=tracer)
            gas_left_in_block -= result.gas_used
            out.append({"txHash": data(tx.hash),
                        "result": self._shape_result(
                            tracer, is_call_tracer, result.gas_used,
                            result.success, result.output)})
        return out

    def debug_executionWitness(self, tag):
        """Everything needed to re-execute the block statelessly: parent
        trie nodes, bytecodes, touched keys, ancestor headers (reference
        debug_executionWitness, crates/rpc/rpc/src/debug.rs)."""
        from ..engine.witness import generate_witness
        from .server import RpcError

        p = self.eth._provider()
        n = self.eth._resolve_number(tag, p)
        block = p.block_by_number(n)
        if block is None or n == 0:
            raise RpcError(-32000, "unknown block (or genesis)")
        parent_header = p.header_by_number(n - 1)
        # the parent view needs TRIE tables (proof generation), so it comes
        # from the engine tree's overlay chain, not the historical
        # reconstruction (which only rebuilds plain state)
        try:
            parent_state = self.eth.tree.overlay_provider(parent_header.hash)
        except KeyError:
            raise RpcError(
                -32000,
                "witness parent below the in-memory window (trie state "
                "for deep history is not reconstructible)") from None
        idx = p.block_body_indices(n)
        senders = [
            p.sender(idx.first_tx_num + i) or block.transactions[i].recover_sender()
            for i in range(len(block.transactions))
        ]
        hashes = {}
        for k in range(max(0, n - 256), n):
            bh = p.canonical_hash(k)
            if bh:
                hashes[k] = bh
        w = generate_witness(
            parent_state, block, self.eth.tree.committer, senders,
            parent_header, self.eth.tree.config,
            block_hashes=hashes,
            # large witnesses shard their multiproof across the
            # proof-worker pool; each worker opens its own overlay view
            provider_factory=lambda: self.eth.tree.overlay_provider(
                parent_header.hash),
        )
        return w.to_json()

    def debug_getRawHeader(self, tag):
        from .convert import data

        p = self.eth._provider()
        n = self.eth._resolve_number(tag, p)
        h = p.header_by_number(n)
        from .server import RpcError

        if h is None:
            raise RpcError(-32000, "unknown block")
        return data(h.encode())

    def debug_getRawBlock(self, tag):
        from .convert import data

        p = self.eth._provider()
        n = self.eth._resolve_number(tag, p)
        b = p.block_by_number(n)
        from .server import RpcError

        if b is None:
            raise RpcError(-32000, "unknown block")
        return data(b.encode())

    def debug_getRawTransaction(self, tx_hash):
        from .convert import data, parse_data
        from ..storage.tables import Tables

        p = self.eth._provider()
        raw = p.tx.get(Tables.TransactionHashNumbers.name, parse_data(tx_hash))
        if raw is None:
            return None
        tx_raw = p.tx.get(Tables.Transactions.name, raw)
        return data(tx_raw) if tx_raw else None

    # -- block-lifecycle observability (tracing.py) -------------------------

    def debug_blockTimeline(self, tag=None):
        """One block's lifecycle timeline (requires --trace-blocks /
        RETH_TPU_TRACE): every recorded span/event under the block's
        trace plus the wall-budget summary. ``tag``: a 0x block hash, a
        block number/tag resolvable to a canonical hash, or None for the
        most recently traced block."""
        from .. import tracing
        from .server import RpcError

        if not tracing.trace_enabled():
            raise RpcError(-32000, "block tracing is disabled "
                                   "(--trace-blocks / RETH_TPU_TRACE)")
        trace_id = None
        if tag is None:
            traces = tracing.recent_traces()
            if traces:
                trace_id = traces[-1]
        elif isinstance(tag, str) and tag.startswith("0x") and len(tag) == 66:
            trace_id = tag[2:].lower()
        else:
            p = self.eth._provider()
            n = self.eth._resolve_number(tag, p)
            h = p.canonical_hash(n)
            trace_id = h.hex() if h is not None else None
        timeline = (tracing.block_timeline(trace_id)
                    if trace_id is not None else None)
        if not timeline:
            raise RpcError(-32000, f"no timeline recorded for {tag!r}")
        return {
            "traceId": trace_id,
            "summary": tracing.block_summary(trace_id),
            "spans": timeline,
        }

    def debug_flightRecorder(self, action="snapshot", limit=256,
                             correlation_id=None):
        """The in-memory flight recorder: ``action="snapshot"`` returns
        the most recent ``limit`` records; ``action="dump"`` snapshots
        the ring to a JSONL file and returns its path plus every dump
        written so far (breaker opens, watchdog timeouts, fault drills);
        ``action="correlated"`` returns the MERGED multi-process view of
        one correlated incident — every dump in the shared flight
        directory stamped with ``correlation_id`` (default: the most
        recent id this process stamped), records annotated with their
        originating pid/role and time-ordered; not ported yet, so it
        answers as an unknown action."""
        from .. import tracing
        from .server import RpcError

        rec = tracing.flight_recorder()
        if action == "dump":
            path = tracing.flight_dump("rpc_request")
            return {"path": path, "dumps": list(rec.dumps)}
        if action != "snapshot":
            raise RpcError(-32602, f"unknown action {action!r} "
                                   "(snapshot | dump)")
        return {
            "records": rec.snapshot(int(limit)),
            "recorded": rec.recorded,
            "dumps": list(rec.dumps),
        }
