"""Native block execution: ctypes bridge to csrc/evmexec.cpp.

A copy of the JAX package's ``engine/native_exec.py`` on the port's modules.
Its C++ core, ``csrc/evmexec.cpp``, is a copy of the reference's
``native/evmexec.cpp``, built by ``ops/_build.py``'s g++ route into the
port's build directory; the marshalling is the reference's byte for byte.

Reference analogue: revm v41 as reth's native interpreter
(Cargo.toml:430). Maximal runs ("segments") of native-eligible
transactions execute entirely in C++ — wave-parallel speculation on OS
threads, in-order actual-access validation, serial re-run of conflicts,
inter-wave write merging — with ONE marshal round-trip per segment, so
the GIL only sees the per-tx fold into the block output. A transaction
the native core can't take (unsupported opcode, key outside the access
hint, non-latest fork rules, coinbase access) ends the segment and runs
through the Python interpreter instead: the native path either
reproduces the interpreter bit-for-bit (asserted by
tests/test_native_exec.py differential runs and test_bal.py's
serial-equality suite) or it declines.

Two drivers share the marshaling here:

* :func:`native_flow` — the BAL segment flow (engine/bal.py): access
  hints are known up front, segments are clipped to hint-eligible runs;
* the optimistic scheduler (engine/optimistic.py) — no hints: it calls
  :func:`snapshot_buffer` / :func:`txs_buffer` / :func:`call_segment`
  directly with a snapshot grown round-by-round from the read sets the
  results report back (misses keep their partial reads exactly so the
  async storage layer knows what to prefetch before the retry).
"""

from __future__ import annotations

import ctypes
import struct
import threading
from pathlib import Path

from ..evm.executor import calldata_floor_gas, intrinsic_gas
from ..evm.spec import LATEST_SPEC
from ..primitives.types import Account, KECCAK_EMPTY, Log

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "evmexec.cpp"
_lock = threading.Lock()
_lib = None

_u8p = ctypes.POINTER(ctypes.c_uint8)


def load_library():
    """ctypes handle to ``csrc/evmexec.cpp`` (a copy of the reference's
    ``native/evmexec.cpp``), built by g++ into the port's build directory
    on first use (``ops/_build.py``). A failed build raises its
    ``BuildError``; the reference's callers turn its ``RuntimeError`` into
    Python ranks, the port's raise it."""
    global _lib
    if _lib is not None:
        return _lib
    from ..ops._build import load

    lib = load(_SRC)
    with _lock:
        if _lib is None:
            lib.evm_execute_block.restype = _u8p
            lib.evm_execute_block.argtypes = [
                _u8p, ctypes.c_uint64, _u8p, ctypes.c_uint64, _u8p,
                ctypes.c_uint64, _u8p, ctypes.c_uint64, ctypes.c_uint64,
                ctypes.c_int, ctypes.POINTER(ctypes.c_uint64)]
            lib.evm_free.argtypes = [_u8p]
            _lib = lib
        return _lib


def _b32(v: int) -> bytes:
    return v.to_bytes(32, "big")


# -- marshaling (shared by the BAL flow and the optimistic scheduler) --------


def env_buffer(env) -> bytes:
    """Serialize a BlockEnv for the native core."""
    return (env.coinbase
            + struct.pack("<QQQ", env.number, env.timestamp, env.gas_limit)
            + _b32(env.base_fee) + env.prev_randao.rjust(32, b"\x00")
            + struct.pack("<Q", env.chain_id) + _b32(env.blob_base_fee))


def snapshot_buffer(merged, acct_keys, slot_keys):
    """Serialize a state snapshot read through ``merged`` (any StateSource
    with account/storage/bytecode). Returns ``(buf, prev_accounts,
    prev_slots)`` — the previous images the commit fold needs for
    first-touch changesets."""
    prev_accounts: dict[bytes, Account | None] = {}
    code_ids: dict[bytes, int] = {}
    codes: list[bytes] = []
    sparts = [struct.pack("<I", len(acct_keys))]
    for a in acct_keys:
        acc = merged.account(a)
        prev_accounts[a] = acc
        code_id = -1
        if acc is not None and acc.code_hash != KECCAK_EMPTY:
            cid = code_ids.get(acc.code_hash)
            if cid is None:
                cid = len(codes)
                codes.append(merged.bytecode(acc.code_hash))
                code_ids[acc.code_hash] = cid
            code_id = cid
        sparts.append(a + struct.pack("<Q", acc.nonce if acc else 0)
                      + _b32(acc.balance if acc else 0)
                      + struct.pack("<iB", code_id, 1 if acc else 0))
    prev_slots: dict[tuple[bytes, bytes], int] = {}
    sparts.append(struct.pack("<I", len(slot_keys)))
    for a, s in slot_keys:
        v = merged.storage(a, s)
        prev_slots[(a, s)] = v
        sparts.append(a + s + _b32(v))
    sparts.append(struct.pack("<I", len(codes)))
    for c in codes:
        sparts.append(struct.pack("<I", len(c)) + c)
    return b"".join(sparts), prev_accounts, prev_slots


_TX_HEAD = struct.Struct("<I20sB20s32sQQ32s32sQQBI")


def txs_buffer(txs, senders, indices, spec, env) -> bytes:
    """Serialize the transactions at ``indices`` (absolute block ranks)."""
    tparts = [struct.pack("<I", len(indices))]
    floorable = spec.calldata_floor
    for i in indices:
        tx = txs[i]
        eff = tx.effective_gas_price(env.base_fee)
        cap = tx.max_fee_per_gas if tx.tx_type >= 2 else tx.gas_price
        floor = calldata_floor_gas(tx) if floorable else 0
        tparts.append(_TX_HEAD.pack(
            i, senders[i], 1, tx.to, tx.value.to_bytes(32, "big"),
            tx.nonce, tx.gas_limit, eff.to_bytes(32, "big"),
            cap.to_bytes(32, "big"), intrinsic_gas(tx, spec), floor,
            tx.tx_type, len(tx.data)))
        tparts.append(tx.data)
        tparts.append(struct.pack("<I", len(tx.access_list)))
        for addr, slots in tx.access_list:
            tparts.append(addr + struct.pack("<I", len(slots)))
            for s in slots:
                tparts.append(s)
    return b"".join(tparts)


def call_segment(lib, snap_buf: bytes, env_buf: bytes, txs_buf: bytes,
                 wave_sizes, remaining_gas: int, n_threads: int) -> bytes:
    """One evm_execute_block round trip; the call releases the GIL for its
    whole duration (ctypes), so speculation threads AND the async storage
    prefetchers run concurrently with the C++ crunch."""
    waves_buf = struct.pack("<I", len(wave_sizes)) + b"".join(
        struct.pack("<I", s) for s in wave_sizes)
    out_len = ctypes.c_uint64()
    sb = (ctypes.c_uint8 * len(snap_buf)).from_buffer_copy(snap_buf)
    eb = (ctypes.c_uint8 * len(env_buf)).from_buffer_copy(env_buf)
    tb = (ctypes.c_uint8 * len(txs_buf)).from_buffer_copy(txs_buf)
    wb = (ctypes.c_uint8 * len(waves_buf)).from_buffer_copy(waves_buf)
    ptr = lib.evm_execute_block(sb, len(snap_buf), eb, len(env_buf),
                                tb, len(txs_buf), wb, len(waves_buf),
                                remaining_gas, n_threads,
                                ctypes.byref(out_len))
    try:
        return ctypes.string_at(ptr, out_len.value)
    finally:
        lib.evm_free(ptr)


def parse_results(raw: bytes) -> list[dict]:
    """Decode the result buffer: one dict per tx, in submission order.
    Statuses: 0 fail, 1 ok, 2 miss (native declined), 3 not run. Missed /
    not-run txs still carry the partial read sets their speculation
    managed — the optimistic scheduler's prefetch hints."""
    (n_results,) = struct.unpack_from("<I", raw, 0)
    off = 4
    out = []
    for _ in range(n_results):
        idx, status, mode, cb_sens, gas_used = struct.unpack_from(
            "<IBBBQ", raw, off)
        off += 15
        fee_delta = int.from_bytes(raw[off:off + 32], "big"); off += 32
        (olen,) = struct.unpack_from("<I", raw, off); off += 4
        output = raw[off:off + olen]; off += olen
        (nlogs,) = struct.unpack_from("<I", raw, off); off += 4
        logs = []
        for _l in range(nlogs):
            laddr = raw[off:off + 20]; off += 20
            nt = raw[off]; off += 1
            topics = []
            for _t in range(nt):
                topics.append(raw[off:off + 32]); off += 32
            (dlen,) = struct.unpack_from("<I", raw, off); off += 4
            logs.append(Log(laddr, tuple(topics), raw[off:off + dlen]))
            off += dlen
        (nar,) = struct.unpack_from("<I", raw, off); off += 4
        acct_reads = set()
        for _a in range(nar):
            acct_reads.add(raw[off:off + 20]); off += 20
        (naw,) = struct.unpack_from("<I", raw, off); off += 4
        acct_writes = []
        for _a in range(naw):
            wa = raw[off:off + 20]; off += 20
            deleted = raw[off]; off += 1
            (nonce,) = struct.unpack_from("<Q", raw, off); off += 8
            balance = int.from_bytes(raw[off:off + 32], "big"); off += 32
            acct_writes.append((wa, deleted, nonce, balance))
        (nsr,) = struct.unpack_from("<I", raw, off); off += 4
        slot_reads = set()
        for _s in range(nsr):
            ra = raw[off:off + 20]; off += 20
            rs = raw[off:off + 32]; off += 32
            slot_reads.add((ra, rs))
        (nsw,) = struct.unpack_from("<I", raw, off); off += 4
        slot_writes = []
        for _s in range(nsw):
            ka = raw[off:off + 20]; off += 20
            ks = raw[off:off + 32]; off += 32
            v = int.from_bytes(raw[off:off + 32], "big"); off += 32
            slot_writes.append((ka, ks, v))
        out.append({
            "index": idx, "status": status, "mode": mode,
            "coinbase_sensitive": bool(cb_sens), "gas_used": gas_used,
            "fee_delta": fee_delta, "output": output, "logs": tuple(logs),
            "acct_reads": acct_reads, "acct_writes": acct_writes,
            "slot_reads": slot_reads, "slot_writes": slot_writes,
        })
    return out


# -- the BAL segment flow ----------------------------------------------------


def native_flow(block, senders, waves, entries, config, env, merged,
                n_threads, stats, commit_tx, commit_native, run_python,
                remaining_gas) -> bool:
    """Drive the whole block: native segments + Python interludes.
    Returns False when the native core can't participate at all (the
    caller then runs its pure-Python wave loop from scratch)."""
    spec = (config.spec_for(env.number, env.timestamp)
            if config is not None else LATEST_SPEC)
    # compare by fork NAME, not identity: a chainspec blobSchedule yields
    # a replaced Spec copy, but blob params are irrelevant natively
    # (type-3 txs are ineligible) — only the rule set must be >= the
    # latest one the C++ core implements (Osaka adds no EVM delta)
    if not spec.at_least(LATEST_SPEC.name):
        return False
    lib = load_library()

    txs = block.transactions
    n = len(txs)
    eligible = []
    for i in range(n):
        tx = txs[i]
        entry = entries.get(i)
        ok = (entry is not None and not entry.coinbase_sensitive
              and tx.tx_type <= 2 and tx.to is not None
              and not tx.authorization_list
              and (tx.chain_id is None or tx.chain_id == env.chain_id)
              and not (tx.tx_type >= 2 and tx.max_fee_per_gas < env.base_fee)
              and not (tx.tx_type < 2 and tx.gas_price < env.base_fee))
        if ok and env.coinbase in (entry.account_reads | entry.account_writes
                                   | {senders[i], tx.to}):
            ok = False
        if ok:
            snd = merged.account(senders[i])
            # EIP-3607 / delegated senders take the Python path (the code
            # cannot change natively, so block start is authoritative)
            if snd is not None and snd.code_hash != KECCAK_EMPTY:
                ok = False
        eligible.append(ok)

    # one wave count for the whole block, matching the Python loop's
    # accounting (segment re-clipping must not double-count)
    stats["waves"] += len(waves)

    env_buf = env_buffer(env)

    def run_segment(lo: int, hi: int) -> int:
        """Execute txs [lo, hi) natively; returns the next tx index to
        process (== hi when the whole segment committed)."""
        # snapshot from the union of the segment's access hints
        acct_keys: set[bytes] = set()
        slot_keys: set[tuple[bytes, bytes]] = set()
        for i in range(lo, hi):
            e = entries[i]
            acct_keys |= e.account_reads | e.account_writes
            acct_keys.add(senders[i])
            acct_keys.add(txs[i].to)
            slot_keys |= e.slot_reads | e.slot_writes
        snap_buf, prev_accounts, prev_slots = snapshot_buffer(
            merged, acct_keys, slot_keys)
        txs_buf = txs_buffer(txs, senders, range(lo, hi), spec, env)

        # clip the global wave partition to [lo, hi)
        sizes = []
        for w in waves:
            a, b = max(w[0], lo), min(w[-1] + 1, hi)
            if b > a:
                sizes.append(b - a)

        raw = call_segment(lib, snap_buf, env_buf, txs_buf, sizes,
                           remaining_gas(), n_threads)
        upto = hi
        for res in parse_results(raw):
            idx = res["index"]
            if res["status"] >= 2:  # miss (2) or not-run (3)
                if idx < upto:
                    upto = idx
                continue
            stats["native"] += 1
            stats["parallel" if res["mode"] == 0 else "serial"] += 1
            commit_native(txs[idx].tx_type, res["status"] == 1,
                          res["gas_used"], res["fee_delta"], res["logs"],
                          res["acct_writes"], res["slot_writes"],
                          prev_accounts, prev_slots, output=res["output"])
        return upto

    pos = 0
    while pos < n:
        if not eligible[pos]:
            _python_tx(pos, stats, commit_tx, run_python)
            pos += 1
            continue
        end = pos
        while end < n and eligible[end]:
            end += 1
        done_to = run_segment(pos, end)
        pos = done_to
        if pos < end:  # native stopped on a miss: interpreter takes it
            _python_tx(pos, stats, commit_tx, run_python)
            pos += 1
    return True


def _python_tx(i, stats, commit_tx, run_python):
    stats["serial"] += 1
    _acc, state, fee_delta, result = run_python(i)
    commit_tx(i, state, fee_delta, result)
