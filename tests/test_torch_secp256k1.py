"""The port's secp256k1 (primitives/secp256k1.py, csrc/secp256k1.cpp) against
the JAX package's, on the CPU, tolerance zero: the same keys and hashes
(seeded with numpy) give the same signatures, the same recovered addresses
and the same rejections; the port's native batch, built by g++ into the
port's build directory, equals both the reference's batch and the port's
pure-Python ``ecrecover``. A failed native build raises instead of falling
back.
"""

from __future__ import annotations

import numpy as np
import pytest

from reth_tpu.primitives import secp256k1 as jsecp
from reth_tpu.primitives import types as jtypes
from reth_tpu_torch.ops import _build
from reth_tpu_torch.primitives import secp256k1 as psecp
from reth_tpu_torch.primitives import types as ptypes

N = psecp.N


@pytest.fixture(scope="module")
def signed():
    """24 seeded (key, hash) pairs signed by the reference: recovery ids 0
    and 1 both occur."""
    rng = np.random.default_rng(11)
    out = []
    for _ in range(24):
        priv = int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1
        h = rng.bytes(32)
        out.append((priv, h, jsecp.sign(h, priv)))
    assert {sig[0] for _, _, sig in out} == {0, 1}
    return out


def _recover(mod, *args, **kw):
    try:
        return mod.ecrecover(*args, **kw)
    except ValueError as e:
        return ("ValueError", str(e))


def test_sign_and_addresses_equal(signed):
    for priv, h, sig in signed:
        assert psecp.sign(h, priv) == sig
        assert psecp.address_from_priv(priv) == jsecp.address_from_priv(priv)
        assert psecp.pubkey_from_priv(priv) == jsecp.pubkey_from_priv(priv)


def test_ecrecover_equal(signed):
    for priv, h, (y, r, s) in signed:
        want = jsecp.ecrecover(h, y, r, s)
        assert want == jsecp.address_from_priv(priv)
        assert psecp.ecrecover(h, y, r, s) == want
        assert (psecp.ecrecover(h, y, r, s, return_pubkey=True)
                == jsecp.ecrecover(h, y, r, s, return_pubkey=True))
        # the other recovery id recovers another key, on both
        assert psecp.ecrecover(h, y ^ 1, r, s) == jsecp.ecrecover(h, y ^ 1, r, s) != want


@pytest.mark.parametrize("case", ["r0", "r_n", "s0", "s_n", "y2", "r_off_curve", "high_s",
                                  "high_s_allowed"])
def test_ecrecover_rejections_equal(signed, case):
    _priv, h, (y, r, s) = signed[0]
    x = 1
    while pow((x**3 + 7) % psecp.P, (psecp.P - 1) // 2, psecp.P) == 1:
        x += 1  # an r that is no curve point's x
    args, kw = {
        "r0": ((h, y, 0, s), {}), "r_n": ((h, y, N, s), {}), "s0": ((h, y, r, 0), {}),
        "s_n": ((h, y, r, N), {}), "y2": ((h, 2, r, s), {}),
        "r_off_curve": ((h, y, x, s), {}),
        "high_s": ((h, y ^ 1, r, N - s), {}),
        "high_s_allowed": ((h, y ^ 1, r, N - s), {"allow_high_s": True}),
    }[case]
    got = _recover(psecp, *args, **kw)
    assert got == _recover(jsecp, *args, **kw)
    if case == "high_s_allowed":
        assert got == jsecp.ecrecover(h, y, r, s)  # the same key: (r, N - s) flips the parity
    else:
        assert isinstance(got, tuple)


def test_native_batch_equals_reference_and_plain(signed):
    items = [(h, y, r, s) for _, h, (y, r, s) in signed]
    _, h, (y, r, s) = signed[0]
    x = 5
    while pow((x**3 + 7) % psecp.P, (psecp.P - 1) // 2, psecp.P) == 1:
        x += 1
    items += [(h, y, 0, s), (h, y, r, N), (h, y, r, N - 1), (h, y ^ 1, r, s), (h, 3, r, s),
              (h, y, x, s), (h, y ^ 1, r, N - s)]
    got = psecp.ecrecover_batch(items)
    assert got == jsecp.ecrecover_batch(items)
    for item, addr in zip(items, got):
        plain = _recover(psecp, *item)
        assert addr == (None if isinstance(plain, tuple) else plain)
    assert got[:24] == [psecp.address_from_priv(p) for p, _, _ in signed]
    high = psecp.ecrecover_batch(items, allow_high_s=True)
    assert high == jsecp.ecrecover_batch(items, allow_high_s=True)
    assert high[-1] == got[0] and got[-1] is None
    # the library was built from the port's copy, into the port's build directory
    lib = _build.loaded_from()[_build.PKG_DIR / "csrc" / "secp256k1.cpp"]
    assert lib.parent == _build.BUILD_DIR


def test_failed_native_build_raises(monkeypatch):
    def fail(src, build_missing=True):
        raise _build.BuildError(f"building {src.name} failed: g++ not found")

    monkeypatch.setattr(_build, "load", fail)
    with pytest.raises(_build.BuildError, match="secp256k1.cpp"):
        psecp.ecrecover_batch([(b"\x01" * 32, 0, 1, 1)])
    with pytest.raises(_build.BuildError):
        ptypes.recover_senders([ptypes.Transaction(tx_type=2, chain_id=1, r=1, s=1)])


def test_transaction_and_authorization_recovery_equal(signed):
    priv = signed[3][0]
    txs = []
    for i, tx_type in enumerate((0, 1, 2, 4)):
        kw = dict(tx_type=tx_type, chain_id=1, nonce=i, gas_limit=90_000, to=b"\x42" * 20,
                  value=7, data=b"\x01\x02")
        if tx_type in (0, 1):
            kw["gas_price"] = 3 * 10**9
        else:
            kw.update(max_fee_per_gas=4 * 10**9, max_priority_fee_per_gas=10**9)
        if tx_type == 4:
            auth = jtypes.Authorization(chain_id=1, address=b"\x43" * 20, nonce=5)
            ay, ar, as_ = jsecp.sign(auth.signing_hash(), signed[4][0])
            kw["authorization_list"] = (jtypes.Authorization(1, b"\x43" * 20, 5, ay, ar, as_),)
        tx = jtypes.Transaction(**kw)
        y, r, s = jsecp.sign(tx.signing_hash(), priv)
        txs.append(jtypes.Transaction(**{**tx.__dict__, "y_parity": y, "r": r, "s": s}))
    bad = jtypes.Transaction(**{**txs[2].__dict__, "r": 0})
    port = [ptypes.Transaction.decode(tx.encode()) for tx in txs]
    for jtx, ptx in zip(txs, port):
        assert ptx.signing_hash() == jtx.signing_hash()
        assert ptx.recover_sender() == jtx.recover_sender() == psecp.address_from_priv(priv)
    assert (port[3].authorization_list[0].recover_authority()
            == txs[3].authorization_list[0].recover_authority()
            == psecp.address_from_priv(signed[4][0]))
    pbad = ptypes.Transaction.decode(bad.encode())
    assert (ptypes.recover_senders(port + [pbad])
            == jtypes.recover_senders(txs + [bad])
            == [psecp.address_from_priv(priv)] * 4 + [None])
    with pytest.raises(ValueError, match="signature out of range"):
        pbad.recover_sender()
