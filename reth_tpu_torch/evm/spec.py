"""Per-fork EVM rule sets (revm ``SpecId`` analogue).

A copy of the JAX package's ``evm/spec.py``.

Reference analogue: reth selects a revm ``SpecId`` per block from the
chainspec (crates/ethereum/evm/src/config.rs:2-3 re-exporting
``spec_by_timestamp_and_block_number``); revm then branches its opcode
table, gas schedule, and host rules on it. Here the same idea is a frozen
:class:`Spec` of feature flags + gas parameters, built by layering
per-fork deltas in ``HARDFORK_ORDER`` — each hardfork is literally a diff
against the previous rule set, which is how the EIPs themselves are
written.

``Interpreter`` and ``BlockExecutor`` read everything fork-dependent from
the active ``Spec``; ``ChainSpec.spec_at`` picks the fork name per block.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from ..chainspec import (
    BERLIN,
    BYZANTIUM,
    CANCUN,
    CONSTANTINOPLE,
    FRONTIER,
    HARDFORK_ORDER,
    HOMESTEAD,
    ISTANBUL,
    LONDON,
    OSAKA,
    PARIS,
    PETERSBURG,
    PRAGUE,
    SHANGHAI,
    SPURIOUS_DRAGON,
    TANGERINE,
    BlobParams,
    ChainSpec,
)

ETHER = 10**18

CANCUN_BLOBS = BlobParams(target=3, max=6, update_fraction=3_338_477)
PRAGUE_BLOBS = BlobParams(target=6, max=9, update_fraction=5_007_716)


@dataclass(frozen=True)
class Spec:
    """One fork's complete EVM rule set. Grouped by the subsystem that
    consumes each field; every activation cited to its EIP."""

    name: str = FRONTIER

    # -- opcode availability ------------------------------------------------
    has_delegatecall: bool = False   # Homestead (EIP-7)
    has_revert: bool = False         # Byzantium: REVERT/RETURNDATA*/STATICCALL
    has_shifts: bool = False         # Constantinople (EIP-145)
    has_create2: bool = False        # Constantinople (EIP-1014)
    has_extcodehash: bool = False    # Constantinople (EIP-1052)
    has_chainid: bool = False        # Istanbul (EIP-1344)
    has_selfbalance: bool = False    # Istanbul (EIP-1884)
    has_basefee: bool = False        # London (EIP-3198)
    has_push0: bool = False          # Shanghai (EIP-3855)
    has_transient: bool = False      # Cancun (EIP-1153)
    has_mcopy: bool = False          # Cancun (EIP-5656)
    has_blob_opcodes: bool = False   # Cancun (EIP-4844/7516)
    merge: bool = False              # Paris: PREVRANDAO, no PoW rewards

    # -- account-access pricing --------------------------------------------
    warm_cold: bool = False          # Berlin (EIP-2929); flat costs below until then
    g_sload: int = 50                # 50 → 200 (EIP-150) → 800 (EIP-1884)
    g_balance: int = 20              # 20 → 400 (EIP-150) → 700 (EIP-1884)
    g_extcode: int = 20              # EXTCODESIZE/EXTCODECOPY: 20 → 700 (EIP-150)
    g_extcodehash: int = 400         # 400 (EIP-1052) → 700 (EIP-1884)
    g_call: int = 40                 # CALL family base: 40 → 700 (EIP-150)
    g_selfdestruct: int = 0          # 0 → 5000 (EIP-150)
    g_exp_byte: int = 10             # 10 → 50 (EIP-160, Spurious)

    # -- call / create semantics -------------------------------------------
    call_63_64: bool = False               # EIP-150 gas retention
    new_account_charge_always: bool = True # pre-EIP-161: absent target charges
    touch_creates_empty: bool = True       # pre-EIP-161: calls materialize target
    # SELFDESTRUCT beneficiary new-account charge: "never" (Frontier),
    # "absent" (EIP-150), "dead_with_value" (EIP-161)
    selfdestruct_new_account: str = "never"
    selfdestruct_same_tx_only: bool = False  # Cancun (EIP-6780)
    create_fail_on_deposit_oog: bool = False # Homestead (EIP-2); pre: empty code
    max_code_size: int | None = None         # Spurious (EIP-170)
    reject_ef_code: bool = False             # London (EIP-3541)
    initcode_limit: bool = False             # Shanghai (EIP-3860)

    # -- SSTORE regime ------------------------------------------------------
    sstore_net: bool = False         # EIP-1283 (Constantinople) / 2200 (Istanbul)
    sstore_sentry: int = 0           # EIP-2200 adds the 2300-gas sentry
    g_sstore_load: int = 200         # net-metering "sload leg": 200 → 800 → warm 100
    r_sstore_clear: int = 15_000     # → 4800 (EIP-3529, London)
    r_selfdestruct: int = 24_000     # → 0 (EIP-3529)
    refund_quotient: int = 2         # → 5 (EIP-3529)

    # -- transaction rules --------------------------------------------------
    g_calldata_nonzero: int = 68     # → 16 (EIP-2028, Istanbul)
    g_tx_create_extra: int = 0       # → 32000 (EIP-2, Homestead)
    calldata_floor: bool = False     # Prague (EIP-7623)
    eip155: bool = False             # Spurious: chain-id signatures
    state_clearing: bool = False     # Spurious (EIP-161)
    max_tx_type: int = 0             # 1 Berlin, 2 London, 3 Cancun, 4 Prague
    warm_coinbase: bool = False      # Shanghai (EIP-3651)

    # -- precompiles --------------------------------------------------------
    precompiles: int = 4             # highest address: 8 Byzantium, 9 Istanbul,
    #                                  10 Cancun, 17 Prague (EIP-2537 BLS)
    bn_add_gas: int = 500            # EIP-1108 (Istanbul): 150
    bn_mul_gas: int = 40_000         # EIP-1108: 6000
    bn_pair_base: int = 100_000      # EIP-1108: 45000
    bn_pair_per: int = 80_000        # EIP-1108: 34000
    modexp_eip2565: bool = True      # Berlin repricing (min 200); False = EIP-198

    # -- block rules --------------------------------------------------------
    block_reward: int = 5 * ETHER    # 3 Byzantium, 2 Constantinople, 0 Paris
    receipt_status: bool = False     # Byzantium (EIP-658); pre: post-tx state root
    has_withdrawals: bool = False    # Shanghai (EIP-4895)
    has_setcode: bool = False        # Prague (EIP-7702)
    beacon_root_call: bool = False   # Cancun (EIP-4788) pre-block system call
    history_contract_call: bool = False  # Prague (EIP-2935)
    has_requests: bool = False       # Prague (EIP-7685/6110/7002/7251)
    blob: BlobParams | None = None   # Cancun+

    # -- helpers ------------------------------------------------------------
    def at_least(self, fork: str) -> bool:
        return HARDFORK_ORDER.index(self.name) >= HARDFORK_ORDER.index(fork)


# Each fork is a diff against the previous rule set, applied in order.
_DELTAS: dict[str, dict] = {
    HOMESTEAD: dict(
        has_delegatecall=True, g_tx_create_extra=32_000,
        create_fail_on_deposit_oog=True,
    ),
    # DAO / glacier forks: difficulty-schedule only, no EVM delta
    TANGERINE: dict(  # EIP-150 + EIP-158 precursor semantics stay
        call_63_64=True, g_sload=200, g_call=700, g_balance=400,
        g_extcode=700, g_selfdestruct=5_000,
        selfdestruct_new_account="absent",
    ),
    SPURIOUS_DRAGON: dict(  # EIP-155/160/161/170
        eip155=True, state_clearing=True, touch_creates_empty=False,
        new_account_charge_always=False,
        selfdestruct_new_account="dead_with_value",
        max_code_size=24_576, g_exp_byte=50,
    ),
    BYZANTIUM: dict(  # EIP-140/211/214/658 + precompiles 5-8
        has_revert=True, precompiles=8, receipt_status=True,
        block_reward=3 * ETHER, modexp_eip2565=False,
    ),
    CONSTANTINOPLE: dict(  # EIP-145/1014/1052/1283/1234
        has_shifts=True, has_create2=True, has_extcodehash=True,
        sstore_net=True, g_sstore_load=200, block_reward=2 * ETHER,
    ),
    PETERSBURG: dict(sstore_net=False),  # EIP-1283 removed
    ISTANBUL: dict(  # EIP-152/1108/1344/1884/2028/2200
        sstore_net=True, sstore_sentry=2_300, g_sstore_load=800,
        g_sload=800, g_balance=700, g_extcodehash=700,
        g_calldata_nonzero=16, precompiles=9,
        bn_add_gas=150, bn_mul_gas=6_000, bn_pair_base=45_000,
        bn_pair_per=34_000, has_chainid=True, has_selfbalance=True,
    ),
    BERLIN: dict(  # EIP-2565/2929/2930
        warm_cold=True, g_sstore_load=100, modexp_eip2565=True,
        max_tx_type=1,
    ),
    LONDON: dict(  # EIP-1559/3198/3529/3541
        has_basefee=True, r_sstore_clear=4_800, r_selfdestruct=0,
        refund_quotient=5, max_tx_type=2, reject_ef_code=True,
    ),
    PARIS: dict(merge=True, block_reward=0),
    SHANGHAI: dict(  # EIP-3651/3855/3860/4895
        has_push0=True, warm_coinbase=True, initcode_limit=True,
        has_withdrawals=True,
    ),
    CANCUN: dict(  # EIP-1153/4788/4844/5656/6780/7516
        has_transient=True, has_mcopy=True, has_blob_opcodes=True,
        selfdestruct_same_tx_only=True, precompiles=10, max_tx_type=3,
        beacon_root_call=True, blob=CANCUN_BLOBS,
    ),
    PRAGUE: dict(  # EIP-2537/2935/6110/7002/7251/7623/7691/7702
        has_setcode=True, calldata_floor=True, max_tx_type=4,
        history_contract_call=True, has_requests=True, blob=PRAGUE_BLOBS,
        # EIP-2537 extends the precompile ADDRESS RANGE to 0x11 (warming
        # per EIP-2929 init covers 1..17 — validated against the
        # reference's hive chain). The whole table is implemented in
        # primitives/bls12381.py: ADD/MSM (affine + subgroup checks),
        # PAIRING over primitives/pairing.py, and the RFC 9380
        # SSWU+isogeny maps whose constants are derived offline and
        # pinned by exact polynomial identities + RFC vectors.
        precompiles=17,
    ),
    OSAKA: dict(),
}

_SPECS: dict[str, Spec] = {}


def _build_specs() -> None:
    spec = Spec()
    _SPECS[FRONTIER] = spec
    for fork in HARDFORK_ORDER[1:]:
        delta = _DELTAS.get(fork, {})
        spec = replace(spec, name=fork, **delta)
        _SPECS[fork] = spec


_build_specs()

LATEST_SPEC = _SPECS[PRAGUE]


def spec_for_fork(fork: str) -> Spec:
    return _SPECS[fork]


def spec_for_block(chainspec: ChainSpec, number: int, timestamp: int = 0) -> Spec:
    """Rule set for a block at (number, timestamp) — the per-block SpecId
    selection (reference crates/ethereum/evm/src/config.rs:2-3). Honors a
    chain's blobSchedule overrides when the chainspec carries them."""
    spec = _SPECS[chainspec.spec_at(number, timestamp)]
    if chainspec.blob_schedule and spec.blob is not None:
        params = chainspec.blob_schedule.get(spec.name)
        if params is not None:
            spec = replace(spec, blob=params)
    return spec
