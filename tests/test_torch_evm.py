"""The port's EVM (evm/, chainspec.py, the precompiles' math in primitives/)
against the JAX package's, on the CPU, tolerance zero.

Each case is one function of a package: it builds its inputs with that
package's own types (the same constructors, keys and bytes on both sides),
runs them and returns what came out, normalised to plain values. The case
runs on both packages and the two results must be equal: the same header
fields and transaction encodings going in; the same receipts (status, gas, logs), gas used,
senders, return data, requests, ``BlockChanges`` and post-state coming out;
or the same exception type and message. The vectors are the reference's
own (tests/test_evm.py, test_evm_edge.py, test_precompiles.py,
test_tx_types.py), with one or two a precompile for the slow pairing, BLS
and KZG ones. KZG runs on a four-point dev setup (``dev_setup(4)``), built by
each package, so that no case pays for the 64-point one.
"""

from __future__ import annotations

import hashlib
import types

import pytest

from _torch_helpers import BLAKE2F_INPUT
from reth_tpu import chainspec as jchainspec
from reth_tpu.evm import executor as jex
from reth_tpu.evm import interpreter as jint
from reth_tpu.evm import spec as jspec
from reth_tpu.evm import state as jstate
from reth_tpu.primitives import bls12381 as jbls
from reth_tpu.primitives import keccak as jkeccak
from reth_tpu.primitives import kzg as jkzg
from reth_tpu.primitives import pairing as jpairing
from reth_tpu.primitives import secp256k1 as jsecp
from reth_tpu.primitives import types as jtypes
from reth_tpu_torch import chainspec as pchainspec
from reth_tpu_torch.evm import executor as pex
from reth_tpu_torch.evm import interpreter as pint
from reth_tpu_torch.evm import spec as pspec
from reth_tpu_torch.evm import state as pstate
from reth_tpu_torch.primitives import bls12381 as pbls
from reth_tpu_torch.primitives import keccak as pkeccak
from reth_tpu_torch.primitives import kzg as pkzg
from reth_tpu_torch.primitives import pairing as ppairing
from reth_tpu_torch.primitives import secp256k1 as psecp
from reth_tpu_torch.primitives import types as ptypes

JAX = types.SimpleNamespace(ex=jex, interp=jint, spec=jspec, state=jstate, types=jtypes,
                            secp=jsecp, keccak=jkeccak.keccak256, kzg=jkzg, bls=jbls,
                            pairing=jpairing, chainspec=jchainspec)
PORT = types.SimpleNamespace(ex=pex, interp=pint, spec=pspec, state=pstate, types=ptypes,
                             secp=psecp, keccak=pkeccak.keccak256, kzg=pkzg, bls=pbls,
                             pairing=ppairing, chainspec=pchainspec)

ALICE_KEY, BOB_KEY = 0xA11CE, 0xB0B
BOB = b"\x0b" * 20
COINBASE = b"\xc0" * 20
A = b"\x0a" * 20
GAS = 10**7
STORE_CODE = bytes.fromhex("5f355f5500")
SSTORE42 = bytes.fromhex("60425f5500")


# -- normalising what comes out ------------------------------------------------


def acc(a):
    return None if a is None else (a.nonce, a.balance, a.storage_root, a.code_hash)


def output(out) -> dict:
    ch = out.changes
    return dict(
        receipts=[r.encode_2718() for r in out.receipts],
        gas_used=out.gas_used, senders=list(out.senders), requests=list(out.requests),
        tx_outputs=[bytes(x) for x in out.tx_outputs],
        changes=dict(accounts={k: acc(v) for k, v in ch.accounts.items()},
                     storage={k: dict(v) for k, v in ch.storage.items()},
                     wiped=sorted(ch.wiped_storage), codes=dict(ch.new_bytecodes)),
        post_accounts={k: acc(v) for k, v in out.post_accounts.items()},
        post_storage={k: dict(v) for k, v in out.post_storage.items()})


def state_out(state) -> dict:
    accounts, storage = state.final_state()
    return dict(accounts={k: acc(v) for k, v in accounts.items()},
                storage={k: dict(v) for k, v in storage.items()},
                logs=[(lg.address, tuple(lg.topics), bytes(lg.data)) for lg in state.take_logs()])


def outcome(case, P):
    try:
        return ("ok", case(P))
    except Exception as e:  # noqa: BLE001 - the exception is the result
        return ("raised", type(e).__name__, str(e))


def same(case):
    got = outcome(case, PORT)
    assert got == outcome(case, JAX)
    return got


# -- building inputs on either package -------------------------------------------


def signed_tx(P, priv=ALICE_KEY, **kw):
    d = dict(tx_type=2, chain_id=1, nonce=0, max_fee_per_gas=10, max_priority_fee_per_gas=2,
             gas_limit=21000, to=BOB, value=1000)
    d.update(kw)
    tx = P.types.Transaction(**d)
    y, r, s = P.secp.sign(tx.signing_hash(), priv)
    return P.types.Transaction(**{**tx.__dict__, "y_parity": y, "r": r, "s": s})


def authorize(P, priv, delegate, nonce, chain_id=1):
    auth = P.types.Authorization(chain_id=chain_id, address=delegate, nonce=nonce)
    y, r, s = P.secp.sign(auth.signing_hash(), priv)
    return P.types.Authorization(chain_id, delegate, nonce, y, r, s)


def block(P, txs, withdrawals=None, **hdr):
    d = dict(number=1, base_fee_per_gas=7, gas_limit=30_000_000, timestamp=1000,
             beneficiary=COINBASE)
    d.update(hdr)
    return P.types.Block(P.types.Header(**d), tuple(txs), (), withdrawals)


def source(P, accounts=None, storages=None, codes=None, alice=10**18):
    accounts = dict(accounts or {})
    if alice is not None:
        accounts.setdefault(P.secp.address_from_priv(ALICE_KEY), alice)
    accs = {}
    for addr, spec in accounts.items():
        if isinstance(spec, int):
            accs[addr] = P.types.Account(balance=spec)
        else:
            code = spec.get("code", b"")
            accs[addr] = P.types.Account(
                nonce=spec.get("nonce", 0), balance=spec.get("balance", 0),
                code_hash=P.keccak(code) if code else P.types.KECCAK_EMPTY)
    codes = dict(codes or {})
    for spec in accounts.values():
        if not isinstance(spec, int) and spec.get("code"):
            codes[P.keccak(spec["code"])] = spec["code"]
    return P.ex.InMemoryStateSource(accs, storages, codes)


def execute(P, src, blk, **config):
    cfg = P.ex.EvmConfig(**config) if config else None
    inputs = dict(header=dict(blk.header.__dict__), txs=[tx.encode() for tx in blk.transactions],
                  withdrawals=None if blk.withdrawals is None else [
                      w.rlp_fields() for w in blk.withdrawals])
    return dict(block=inputs, out=output(P.ex.BlockExecutor(src, cfg).execute(blk)))


def run_code(P, code, value=0, gas=1_000_000, accounts=None, storages=None, codes=None,
             caller=A, addr=b"\x10" * 20, data=b""):
    src = source(P, accounts or {caller: 10**18}, storages, codes, alice=None)
    state = P.state.EvmState(src)
    interp = P.interp.Interpreter(state, P.interp.BlockEnv(), P.interp.TxEnv(origin=caller))
    ok, gas_left, out = interp.call(P.interp.CallFrame(
        caller=caller, address=addr, code=code, data=data, value=value, gas=gas))
    return dict(ok=ok, gas_left=gas_left, out=bytes(out), state=state_out(state))


def initcode_for(runtime: bytes) -> bytes:
    n = len(runtime)
    return bytes([0x60, n, 0x60, 0x0B, 0x5F, 0x39, 0x60, n, 0x5F, 0xF3]) + b"\x00" + runtime


def _enc(*ints: int) -> bytes:
    return b"".join(i.to_bytes(32, "big") for i in ints)


# -- block execution: tests/test_evm.py, test_tx_types.py ------------------------


def _contract(code, **kw):
    return dict(code=code, **kw)


BLOCK_CASES = {
    "simple_transfer": lambda P: execute(P, source(P), block(P, [signed_tx(P)])),
    "insufficient_funds": lambda P: execute(P, source(P, alice=1), block(P, [signed_tx(P)])),
    "bad_nonce": lambda P: execute(P, source(P), block(P, [signed_tx(P, nonce=5)])),
    "two_txs": lambda P: execute(P, source(P), block(P, [
        signed_tx(P, nonce=0), signed_tx(P, nonce=1, value=500)])),
    "create": lambda P: execute(P, source(P), block(P, [
        signed_tx(P, to=None, data=initcode_for(STORE_CODE), gas_limit=200_000)])),
    "call_store": lambda P: execute(P, source(P, {b"\x31" * 20: _contract(STORE_CODE)}), block(
        P, [signed_tx(P, to=b"\x31" * 20, value=0, gas_limit=100_000,
                      data=(0xDEAD).to_bytes(32, "big"))])),
    "revert": lambda P: execute(P, source(P, {b"\x11" * 20: _contract(
        bytes.fromhex("60015f555f5ffd"))}), block(P, [signed_tx(
            P, to=b"\x11" * 20, value=0, gas_limit=100_000)])),
    "sstore_refund": lambda P: execute(P, source(
        P, {b"\x12" * 20: _contract(bytes.fromhex("5f5f5500"))},
        {b"\x12" * 20: {b"\x00" * 32: 99}}), block(P, [signed_tx(
            P, to=b"\x12" * 20, value=0, gas_limit=100_000)])),
    "log": lambda P: execute(P, source(P, {b"\x13" * 20: _contract(
        bytes.fromhex("60425f5fa100"))}), block(P, [signed_tx(
            P, to=b"\x13" * 20, value=0, gas_limit=100_000)])),
    "withdrawals": lambda P: execute(P, source(P, alice=None), P.types.Block(
        P.types.Header(number=1, base_fee_per_gas=7, withdrawals_root=b"\x00" * 32), (), (),
        (P.types.Withdrawal(0, 1, BOB, 3), P.types.Withdrawal(1, 1, BOB, 2)))),
    "delegatecall": lambda P: execute(P, source(P, {
        b"\x1a" * 20: _contract(bytes.fromhex("5f5f5f5f73") + b"\x1b" * 20
                                + bytes.fromhex("5af400")),
        b"\x1b" * 20: _contract(b"\x00")}), block(P, [signed_tx(
            P, to=b"\x1a" * 20, value=10**17, gas_limit=200_000)])),
    "sstore_original": lambda P: execute(P, source(P, {b"\x21" * 20: _contract(STORE_CODE)}),
                                         block(P, [
        signed_tx(P, to=b"\x21" * 20, value=0, gas_limit=100_000, nonce=0, data=_enc(1)),
        signed_tx(P, to=b"\x21" * 20, value=0, gas_limit=100_000, nonce=1, data=_enc(2))])),
    "precompiles_warm": lambda P: execute(P, source(P, {b"\x22" * 20: _contract(
        bytes.fromhex("5f5f5f5f5f60045afa00"))}), block(P, [signed_tx(
            P, to=b"\x22" * 20, value=0, gas_limit=100_000)])),
    "selfdestruct_self": lambda P: execute(P, source(P, {b"\x23" * 20: _contract(
        b"\x73" + b"\x23" * 20 + b"\xff", balance=555)}), block(P, [signed_tx(
            P, to=b"\x23" * 20, value=0, gas_limit=100_000)])),
    "eip2930": lambda P: execute(P, source(P), block(P, [signed_tx(
        P, tx_type=1, gas_price=10**9, gas_limit=50_000, to=b"\x77" * 20, value=1234,
        access_list=((b"\x77" * 20, (b"\x00" * 32,)),))])),
    "legacy_eip155": lambda P: execute(P, source(P), block(P, [signed_tx(
        P, tx_type=0, gas_price=10**9, to=b"\x78" * 20, value=99)])),
    "blob_tx": lambda P: execute(P, source(P, alice=10**21), block(P, [signed_tx(
        P, tx_type=3, max_fee_per_gas=10**9, max_priority_fee_per_gas=1, to=b"\x88" * 20,
        value=0, max_fee_per_blob_gas=100,
        blob_versioned_hashes=(b"\x01" + b"\x00" * 31, b"\x01" + b"\x01" * 31))],
        excess_blob_gas=0, blob_gas_used=2 * 131072)),
    "blob_tx_bad_version": lambda P: execute(P, source(P, alice=10**21), block(P, [signed_tx(
        P, tx_type=3, max_fee_per_gas=10**9, to=b"\x88" * 20, value=0,
        max_fee_per_blob_gas=100, blob_versioned_hashes=(b"\x02" + b"\x00" * 31,))],
        excess_blob_gas=0, blob_gas_used=131072)),
    "blob_fee_too_low": lambda P: execute(P, source(P, alice=10**21), block(P, [signed_tx(
        P, tx_type=3, max_fee_per_gas=10**9, to=b"\x88" * 20, value=0,
        max_fee_per_blob_gas=1, blob_versioned_hashes=(b"\x01" + b"\x00" * 31,))],
        excess_blob_gas=40_000_000, blob_gas_used=131072)),
    "setcode_installs": lambda P: execute(P, source(P, {
        b"\x99" * 20: _contract(SSTORE42), P.secp.address_from_priv(BOB_KEY): 10**18}),
        block(P, [signed_tx(P, tx_type=4, max_fee_per_gas=10**9, max_priority_fee_per_gas=1,
                            gas_limit=200_000, to=P.secp.address_from_priv(BOB_KEY), value=0,
                            authorization_list=(authorize(P, BOB_KEY, b"\x99" * 20, 0),))])),
    "setcode_invalid_auths": lambda P: execute(P, source(P, {
        P.secp.address_from_priv(BOB_KEY): dict(balance=10**18, nonce=5)}),
        block(P, [signed_tx(P, tx_type=4, max_fee_per_gas=10**9, gas_limit=200_000,
                            to=b"\x11" * 20, value=0, authorization_list=(
                                authorize(P, BOB_KEY, b"\x99" * 20, 3),
                                authorize(P, BOB_KEY, b"\x99" * 20, 5, chain_id=999)))])),
    "setcode_no_auths": lambda P: execute(P, source(P), block(P, [signed_tx(
        P, tx_type=4, max_fee_per_gas=10**9, gas_limit=100_000, to=b"\x11" * 20, value=0)])),
    "delegated_call": lambda P: execute(P, source(P, {
        b"\x99" * 20: _contract(SSTORE42),
        b"\xca" * 20: _contract(P.types.DELEGATION_PREFIX + b"\x99" * 20, balance=10**18)}),
        block(P, [signed_tx(P, to=b"\xca" * 20, value=0, gas_limit=200_000)])),
    "precompile_calls_in_block": lambda P: execute(P, source(P, {b"\x24" * 20: _contract(
        bytes.fromhex("602036038060205f3760205f825f5f355afa5f515f355500"))}), block(P, [
            signed_tx(P, nonce=i, to=b"\x24" * 20, value=0, gas_limit=300_000, data=d)
            for i, d in enumerate([
                _enc(2) + b"abc", _enc(3) + b"abc", _enc(4) + b"xyz",
                _enc(5) + _enc(1, 1, 1) + bytes([3, 5, 7]),
                _enc(6) + _enc(1, 2, 1, 2), _enc(7) + _enc(1, 2, 9),
                _enc(9) + bytes.fromhex("0000000c" + "00" * 209)])])),
    "pinned_paris": lambda P: execute(
        P, source(P), block(P, [signed_tx(P, tx_type=0, gas_price=10**9)]),
        spec=P.spec.spec_for_fork(P.chainspec.NETWORK_TO_FORK["Paris"])),
    "chainspec_shanghai": lambda P: execute(
        P, source(P), block(P, [signed_tx(P, to=None, data=initcode_for(STORE_CODE),
                                          gas_limit=200_000)]),
        chainspec=P.chainspec.pinned_spec(P.chainspec.SHANGHAI)),
}


@pytest.mark.parametrize("name", sorted(BLOCK_CASES))
def test_block_execution_equal(name):
    got = same(BLOCK_CASES[name])
    if name in ("insufficient_funds", "bad_nonce", "blob_tx_bad_version", "blob_fee_too_low",
                "setcode_no_auths"):
        assert got[0] == "raised" and got[1] == "InvalidTransaction"
    else:
        assert got[0] == "ok"


# -- the interpreter: tests/test_evm.py, test_evm_edge.py ------------------------


def _create_twice(P):
    src = source(P, {A: dict(balance=10**18, nonce=1)}, alice=None)
    state = P.state.EvmState(src)
    interp = P.interp.Interpreter(state, P.interp.BlockEnv(), P.interp.TxEnv(origin=A))
    first = interp.create(A, 0, bytes.fromhex("5f5ff3"), 1_000_000, 0, salt=b"\x01" * 32)
    second = interp.create(A, 0, bytes.fromhex("5f5ff3"), 1_000_000, 0, salt=b"\x01" * 32)
    return [tuple(first[:3]), tuple(second[:3]), state_out(state)]


def _selfdestruct_created(P):
    src = source(P, {A: 10**18}, alice=None)
    state = P.state.EvmState(src)
    interp = P.interp.Interpreter(state, P.interp.BlockEnv(), P.interp.TxEnv(origin=A))
    ok, gas_left, addr, _ = interp.create(A, 5, bytes.fromhex("33ff"), 1_000_000, 0)
    state.process_destructs()
    return [ok, gas_left, addr, acc(state.account(addr)), state.balance(A), state_out(state)]


def _system_call_revert(P):
    code = bytes.fromhex("60006000fd")
    src = source(P, {P.ex.BEACON_ROOTS_ADDRESS: _contract(code)}, alice=None)
    return P.ex.BlockExecutor(src, P.ex.EvmConfig())._system_call(
        P.state.EvmState(src), P.interp.BlockEnv(), P.spec.LATEST_SPEC,
        P.ex.BEACON_ROOTS_ADDRESS, b"\x11" * 32)


def _deposit_requests(P):
    pubkey, wc = b"\xb0" * 48, b"\x01" + b"\x00" * 11 + b"\x42" * 20
    fields = [pubkey, wc, (32 * 10**9).to_bytes(8, "little"), bytes(range(96)),
              (7).to_bytes(8, "little")]
    head, tail, off = b"", b"", 160
    for f in fields:
        padded = f + b"\x00" * (-len(f) % 32)
        head += off.to_bytes(32, "big")
        tail += len(f).to_bytes(32, "big") + padded
        off += 32 + len(padded)
    log = P.types.Log(address=P.ex.MAINNET_DEPOSIT_CONTRACT,
                      topics=(P.ex.DEPOSIT_EVENT_TOPIC,), data=head + tail)
    receipts = [P.types.Receipt(logs=(log,)), P.types.Receipt(logs=(log,))]
    src = source(P, alice=None)
    return P.ex.BlockExecutor(src, P.ex.EvmConfig())._collect_requests(
        P.state.EvmState(src), P.interp.BlockEnv(), P.spec.LATEST_SPEC, receipts)


INTERP_CASES = {
    "arithmetic": lambda P: run_code(P, bytes.fromhex("60036004016005025f5500")),
    "staticcall_blocks_sstore": lambda P: run_code(
        P, bytes.fromhex("5f5f5f5f73") + b"\x11" * 20 + bytes.fromhex("5afa60015500"),
        accounts={A: 1, b"\x10" * 20: 0, b"\x11" * 20: _contract(bytes.fromhex("60015f5500"))}),
    "nested_revert": lambda P: run_code(
        P, bytes.fromhex("60aa6001555f5f5f5f5f73") + b"\x12" * 20 + bytes.fromhex("5af100"),
        accounts={A: 1, b"\x10" * 20: 0,
                  b"\x12" * 20: _contract(bytes.fromhex("60015f555f5ffd"))}),
    "call_depth_limit": lambda P: run_code(
        P, bytes.fromhex("5f5f5f5f5f73") + b"\x13" * 20 + bytes.fromhex("5af100"),
        accounts={A: 1, b"\x13" * 20: _contract(
            bytes.fromhex("5f5f5f5f5f73") + b"\x13" * 20 + bytes.fromhex("5af100"))},
        addr=b"\x13" * 20, gas=2_000_000),
    "extcodehash_absent": lambda P: run_code(
        P, bytes.fromhex("73") + b"\x77" * 20 + bytes.fromhex("3f5f55")),
    "extcodehash_eoa": lambda P: run_code(
        P, bytes.fromhex("73") + b"\x78" * 20 + bytes.fromhex("3f5f55"),
        accounts={A: 1, b"\x78" * 20: 5}),
    "returndatacopy_oob": lambda P: run_code(P, bytes.fromhex("60205f5f3e00")),
    "memory_expansion": lambda P: run_code(P, bytes.fromhex("600163ffffffff52"), gas=100_000),
    "value_call_revert": lambda P: run_code(
        P, bytes.fromhex("5f5f5f5f600a73") + b"\x14" * 20 + bytes.fromhex("5af100"),
        accounts={A: 1, b"\x10" * 20: 100, b"\x14" * 20: _contract(bytes.fromhex("5f5ffd"))}),
    "gas_63_64": lambda P: run_code(
        P, bytes.fromhex("5f5f5f5f5f73") + b"\x15" * 20 + bytes.fromhex("5af100"),
        accounts={A: 1, b"\x15" * 20: _contract(bytes.fromhex("fe"))}, gas=640_000),
    "create2_collision": _create_twice,
    "selfdestruct_created": _selfdestruct_created,
    "system_call_revert": _system_call_revert,
    "deposit_requests": _deposit_requests,
    "intrinsic_gas": lambda P: [
        P.ex.intrinsic_gas(P.types.Transaction(tx_type=2, chain_id=1, to=BOB, data=b"\x00\x01")),
        P.ex.intrinsic_gas(P.types.Transaction(tx_type=2, chain_id=1, to=None, data=b"\xff" * 33)),
        P.ex.calldata_floor_gas(P.types.Transaction(tx_type=2, chain_id=1, data=b"\x01" * 40))],
    "chainspec": lambda P: [
        P.chainspec.MAINNET.spec_at(15_537_394, 0), P.chainspec.MAINNET.spec_at(20_000_000,
                                                                                1_710_338_135),
        P.chainspec.MAINNET.fork_id(20_000_000, 1_710_338_135),
        P.chainspec.dev_spec().spec_at(1, 1000), P.chainspec.pinned_spec("cancun").to_json(),
        P.spec.spec_for_block(P.chainspec.MAINNET, 12_965_000, 0).name,
        P.spec.CANCUN_BLOBS.target_gas, P.spec.CANCUN_BLOBS.max_gas],
    "blob_fee_math": lambda P: [
        P.ex.blob_base_fee(0), P.ex.blob_base_fee(30 * 131072),
        P.ex.next_excess_blob_gas(0, 6 * 131072), P.ex.next_excess_blob_gas(0, 2 * 131072),
        P.ex.fake_exponential(1, 5_000_000, 3_338_477)],
}


@pytest.mark.parametrize("name", sorted(INTERP_CASES))
def test_interpreter_equal(name):
    got = same(INTERP_CASES[name])
    if name == "system_call_revert":
        assert got[:2] == ("raised", "BlockExecutionError")
    else:
        assert got[0] == "ok"


# -- the precompiles: tests/test_precompiles.py, test_evm.py ----------------------


def _bn_g2(P):
    (x0, x1), (y0, y1) = P.pairing.BN254.g2
    return _enc(x1, x0, y1, y0)


def _ecrecover_input(P, high_s=False, v_offset=27):
    h = P.keccak(b"message")
    y, r, s = P.secp.sign(h, ALICE_KEY)
    if high_s:
        y, s = y ^ 1, P.secp.N - s
    return h + _enc(v_offset + y, r, s)


def _non_subgroup_g1(bls):
    x = 1
    while True:
        rhs = (x * x * x + 4) % bls.P
        y = pow(rhs, (bls.P + 1) // 4, bls.P)
        if y * y % bls.P == rhs and bls.g1_mul((x, y), bls.R) is not None:
            return x, y
        x += 1


# (precompile index, input built on the package, gas)
PRECOMPILE_CASES = {
    "ecrecover": (1, lambda P: _ecrecover_input(P), 10_000),
    "ecrecover_high_s": (1, lambda P: _ecrecover_input(P, high_s=True), 10_000),
    "ecrecover_bad_v": (1, lambda P: _ecrecover_input(P, v_offset=29), 10_000),
    "ecrecover_low_gas": (1, lambda P: _ecrecover_input(P), 2_999),
    "sha256": (2, lambda P: b"abc", 10_000),
    "ripemd160": (3, lambda P: b"abc" * 30, 10_000),
    "identity": (4, lambda P: b"xyz", 10_000),
    "modexp_eip198": (5, lambda P: _enc(1, 32, 32) + b"\x03"
                      + _enc(2**256 - 2**32 - 978, 2**256 - 2**32 - 977), GAS),
    "modexp_zero_mod": (5, lambda P: _enc(1, 1, 0) + bytes([3, 5]), GAS),
    "bn_add_double": (6, lambda P: _enc(1, 2, 1, 2), GAS),
    "bn_add_inverse": (6, lambda P: _enc(1, 2, 1, P.pairing.BN254.p - 2), GAS),
    "bn_add_bad_point": (6, lambda P: _enc(1, 3, 0, 0), GAS),
    "bn_add_short": (6, lambda P: _enc(1, 2), GAS),
    "bn_mul": (7, lambda P: _enc(1, 2, 9), GAS),
    "bn_mul_bad_point": (7, lambda P: _enc(P.pairing.BN254.p, 2, 5), GAS),
    "bn_pairing_inverse": (8, lambda P: _enc(1, 2) + _bn_g2(P) + _enc(1, P.pairing.BN254.p - 2)
                           + _bn_g2(P), GAS),
    "bn_pairing_empty": (8, lambda P: b"", GAS),
    "bn_pairing_bad_length": (8, lambda P: _enc(1, 2, 3), GAS),
    "blake2f_12_rounds": (9, lambda P: BLAKE2F_INPUT, GAS),
    "blake2f_bad_flag": (9, lambda P: bytes.fromhex("0000000c" + "00" * 208 + "02"), GAS),
    "point_eval_valid": (10, lambda P: _point_eval_input(P, [7, 11, 13, 17], 12345), GAS),
    "point_eval_bad_hash": (10, lambda P: _point_eval_input(P, [3, 5], 9,
                                                            vh=b"\x01" + b"\x00" * 31), GAS),
    "point_eval_bad_length": (10, lambda P: b"\x00" * 191, GAS),
    "bls_g1add": (11, lambda P: P.bls.encode_g1(P.bls.G1_GENERATOR) + P.bls.encode_g1(
        P.bls.g1_add(P.bls.G1_GENERATOR, P.bls.G1_GENERATOR)), GAS),
    "bls_g1add_off_curve": (11, lambda P: P.bls.encode_g1(P.bls.G1_GENERATOR)[:-1] + b"\x01"
                            + P.bls.encode_g1(P.bls.G1_GENERATOR), GAS),
    "bls_g1msm": (12, lambda P: P.bls.encode_g1(P.bls.G1_GENERATOR) + _enc(3) + P.bls.encode_g1(
        P.bls.g1_add(P.bls.G1_GENERATOR, P.bls.G1_GENERATOR)) + _enc(5), 10**6),
    "bls_g1msm_not_in_subgroup": (12, lambda P: P.bls.encode_g1(_non_subgroup_g1(P.bls))
                                  + _enc(1), 10**6),
    "bls_g2add": (13, lambda P: P.bls.encode_g2(P.bls.G2_GENERATOR) * 2, GAS),
    "bls_g2msm": (14, lambda P: P.bls.encode_g2(P.bls.G2_GENERATOR) + _enc(7), 10**6),
    "bls_pairing_infinity": (15, lambda P: b"\x00" * 128 + P.bls.encode_g2(P.bls.G2_GENERATOR),
                             GAS),
    "bls_pairing_empty": (15, lambda P: b"", GAS),
    "bls_map_fp_to_g1": (16, lambda P: P.bls._fp_encode(42), GAS),
    "bls_map_fp_bad_pad": (16, lambda P: b"\x01" + P.bls._fp_encode(7)[1:], GAS),
    "bls_map_fp2_to_g2": (17, lambda P: P.bls._fp_encode(4) + P.bls._fp_encode(2), GAS),
    "bls_map_fp2_short": (17, lambda P: P.bls._fp_encode(7), GAS),
}


def _point_eval_input(P, coeffs, z, vh=None):
    y, proof = P.kzg.prove_monomial(coeffs, z)
    cb = P.kzg.g1_to_bytes(P.kzg.commit_monomial(coeffs))
    return ((vh if vh is not None else P.kzg.kzg_to_versioned_hash(cb)) + z.to_bytes(32, "big")
            + y.to_bytes(32, "big") + cb + P.kzg.g1_to_bytes(proof))


@pytest.fixture(scope="module")
def small_kzg_setup():
    """Both packages' active KZG setup: each one's own four-point dev setup
    (the same tau), put back to unset after the module."""
    saved = (jkzg._active_setup, pkzg._active_setup)
    jkzg._active_setup, pkzg._active_setup = jkzg.dev_setup(4), pkzg.dev_setup(4)
    assert pkzg._active_setup.tau_g2 == jkzg._active_setup.tau_g2
    assert pkzg._active_setup.g1_monomial == jkzg._active_setup.g1_monomial
    yield
    jkzg._active_setup, pkzg._active_setup = saved


@pytest.mark.parametrize("name", sorted(PRECOMPILE_CASES))
def test_precompile_equal(name, small_kzg_setup):
    idx, data_fn, gas = PRECOMPILE_CASES[name]

    def case(P):
        data = data_fn(P)
        ok, gas_left, out = P.interp._RAW_PRECOMPILES[idx](data, gas)
        return dict(data=bytes(data), ok=ok, gas_left=gas_left, out=bytes(out))

    got = same(case)
    assert got[0] == "ok"
    if name in ("ecrecover", "sha256", "bn_add_double", "bn_pairing_inverse",
                "blake2f_12_rounds", "point_eval_valid", "bls_g1add", "bls_map_fp_to_g1"):
        assert got[1]["ok"]
    if name == "blake2f_12_rounds":
        assert got[1]["out"] == hashlib.blake2b(b"abc", digest_size=64).digest()
    if name == "sha256":
        assert got[1]["out"] == hashlib.sha256(b"abc").digest()
    if name == "ecrecover":
        assert got[1]["out"][12:] == psecp.address_from_priv(ALICE_KEY)


def test_precompile_tables_equal():
    """The era tables: the same addresses live under each fork's rule set,
    and the cached table serves a repeat call as the reference's does."""
    for fork in ("frontier", "byzantium", "istanbul", "berlin", "cancun", "prague"):
        j, p = jspec.spec_for_fork(fork), pspec.spec_for_fork(fork)
        assert sorted(pint._era_table(p)) == sorted(jint._era_table(j))
        assert repr(p) == repr(j)  # every rule flag and gas parameter
    data = _enc(1, 2, 1, 2)
    assert pint._PRECOMPILES[6](data, 100_000) == jint._PRECOMPILES[6](data, 100_000)
    assert pint._PRECOMPILES[6](data, 10) == jint._PRECOMPILES[6](data, 10) == (False, 0, b"")
    assert pint._precompile(b"\x00" * 19 + b"\x12") is None


def test_load_trusted_setup_equal(tmp_path):
    """The pluggable setup's file route: a setup file in the standard text
    format (the four-point dev setup's G1 points, then G2's generator and
    tau times it, compressed) loads to the same points on both packages."""
    setup = pkzg.dev_setup(4)

    def g2_bytes(pt):
        (x0, x1), (y0, y1) = pt
        p = pkzg.BLS12_381.p
        largest = y1 > (p - 1) // 2 or (y1 == 0 and y0 > (p - 1) // 2)
        raw = x1.to_bytes(48, "big") + x0.to_bytes(48, "big")
        return bytes([raw[0] | 0x80 | (0x20 if largest else 0)]) + raw[1:]

    lines = ["4", "2"] + [pkzg.g1_to_bytes(pt).hex() for pt in setup.g1_monomial] + [
        g2_bytes(pkzg.BLS12_381.g2).hex(), g2_bytes(setup.tau_g2).hex()]
    path = tmp_path / "setup.txt"
    path.write_text("\n".join(lines))
    saved = (jkzg._active_setup, pkzg._active_setup)
    try:
        got, want = pkzg.load_trusted_setup(str(path)), jkzg.load_trusted_setup(str(path))
    finally:
        jkzg._active_setup, pkzg._active_setup = saved
    assert got.tau_g2 == want.tau_g2 == setup.tau_g2
    assert got.g1_monomial == want.g1_monomial == setup.g1_monomial
