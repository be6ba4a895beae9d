"""Header/body/post-execution validation, fork-aware.

A copy of the JAX package's ``consensus/validation.py``.

Reference analogue: `EthBeaconConsensus` — header-vs-parent checks,
pre-execution body checks (tx/withdrawal roots), post-execution checks
(gas used, receipts root, logs bloom)
(crates/ethereum/consensus/src/lib.rs, crates/consensus/common).

Without a chainspec the post-merge rule set applies (the engine live-tip
path). With one, each check gates on the block's fork: pre-merge blocks
carry nonzero difficulty and ommers, pre-London blocks no base fee,
pre-Cancun no blob fields. Like the reference, PoW seals are NOT
verified on import, and receipts roots are not validated pre-Byzantium
(the receipt format embeds per-tx state roots there; reth skips the
check the same way — state roots still gate every block at MerkleStage).

The ordered trie roots (transactions, withdrawals, receipts) go through the
port's ``trie/state_root.py ordered_trie_root`` on the given committer;
without one it builds ``TrieCommitter(device="cuda")``.
"""

from __future__ import annotations

import torch

from ..primitives.types import (
    Block,
    EMPTY_OMMER_ROOT_HASH,
    Header,
    Receipt,
    logs_bloom,
)
from ..primitives.keccak import keccak256
from ..primitives.rlp import rlp_encode
from ..trie.committer import TrieCommitter
from ..trie.state_root import ordered_trie_root

GAS_LIMIT_BOUND_DIVISOR = 1024
MIN_GAS_LIMIT = 5000
BASE_FEE_MAX_CHANGE_DENOMINATOR = 8
ELASTICITY_MULTIPLIER = 2
MAX_EXTRA_DATA = 32


class ConsensusError(Exception):
    pass


def calc_next_base_fee(parent: Header) -> int:
    """EIP-1559 base fee for the child of ``parent``."""
    base = parent.base_fee_per_gas
    if base is None:
        return 10**9  # activation default (EIP-1559 INITIAL_BASE_FEE)
    target = parent.gas_limit // ELASTICITY_MULTIPLIER
    if parent.gas_used == target:
        return base
    if parent.gas_used > target:
        delta = max(1, base * (parent.gas_used - target) // target // BASE_FEE_MAX_CHANGE_DENOMINATOR)
        return base + delta
    delta = base * (target - parent.gas_used) // target // BASE_FEE_MAX_CHANGE_DENOMINATOR
    return base - delta


def _spec_of(chainspec, header: Header):
    if chainspec is None:
        return None
    from ..evm.spec import spec_for_block

    return spec_for_block(chainspec, header.number, header.timestamp)


def validate_header_against_parent(header: Header, parent: Header,
                                   chainspec=None) -> None:
    spec = _spec_of(chainspec, header)
    if header.number != parent.number + 1:
        raise ConsensusError(f"block number {header.number} not parent+1")
    if header.parent_hash != parent.hash:
        raise ConsensusError("parent hash mismatch")
    if header.timestamp <= parent.timestamp:
        raise ConsensusError("timestamp not after parent")
    # gas limit bounds; at the London activation block the parent limit is
    # scaled by the elasticity multiplier first (EIP-1559 fork transition)
    parent_gas_limit = parent.gas_limit
    if (spec is not None and spec.has_basefee
            and parent.base_fee_per_gas is None):
        parent_gas_limit *= ELASTICITY_MULTIPLIER
    diff = abs(header.gas_limit - parent_gas_limit)
    if diff >= parent_gas_limit // GAS_LIMIT_BOUND_DIVISOR:
        raise ConsensusError("gas limit changed too much")
    if header.gas_limit < MIN_GAS_LIMIT:
        raise ConsensusError("gas limit below minimum")
    # EIP-1559
    if spec is None or spec.has_basefee:
        if header.base_fee_per_gas is None:
            raise ConsensusError("missing base fee")
        expected = calc_next_base_fee(parent)
        if header.base_fee_per_gas != expected:
            raise ConsensusError(f"base fee {header.base_fee_per_gas} != expected {expected}")
    elif header.base_fee_per_gas is not None:
        raise ConsensusError("base fee before London")
    if spec is None or spec.merge:
        # post-merge constants (PoS headers)
        if header.difficulty != 0:
            raise ConsensusError("non-zero difficulty post-merge")
        if header.nonce != b"\x00" * 8:
            raise ConsensusError("non-zero nonce post-merge")
        if header.ommers_hash != EMPTY_OMMER_ROOT_HASH:
            raise ConsensusError("ommers not allowed post-merge")
    else:
        # pre-merge PoW header: difficulty must be set; the seal itself is
        # not verified on import (the reference's importer doesn't either)
        if header.difficulty == 0:
            raise ConsensusError("zero difficulty pre-merge")
    if len(header.extra_data) > MAX_EXTRA_DATA:
        raise ConsensusError("extra data too long")
    # EIP-4844 blob gas accounting (Cancun). Without a chainspec the
    # activation is parent-driven: once the chain carries blob fields they
    # can never be dropped — a child that omits them must be rejected, or a
    # peer could sidestep the whole blob fee market with a field-less header.
    blob_active = (spec.blob is not None if spec is not None else
                   (parent.excess_blob_gas is not None
                    or header.excess_blob_gas is not None))
    if blob_active:
        from ..evm.executor import MAX_BLOB_GAS_PER_BLOCK, next_excess_blob_gas

        target = spec.blob.target_gas if spec is not None else None
        max_gas = spec.blob.max_gas if spec is not None else MAX_BLOB_GAS_PER_BLOCK
        if header.excess_blob_gas is None or header.blob_gas_used is None:
            raise ConsensusError("missing blob gas fields post-Cancun")
        if target is not None:
            want = next_excess_blob_gas(parent.excess_blob_gas or 0,
                                        parent.blob_gas_used or 0, target)
        else:
            want = next_excess_blob_gas(parent.excess_blob_gas or 0,
                                        parent.blob_gas_used or 0)
        if header.excess_blob_gas != want:
            raise ConsensusError(
                f"excess blob gas {header.excess_blob_gas} != expected {want}"
            )
        if header.blob_gas_used > max_gas:
            raise ConsensusError("blob gas used above block maximum")
    elif spec is not None and (header.excess_blob_gas is not None
                               or header.blob_gas_used is not None):
        raise ConsensusError("blob gas fields before Cancun")
    # EIP-4788 parent beacon block root (Cancun) and EIP-7685 requests hash
    # (Prague): fork-mandated presence, rejected pre-fork — same gating
    # shape as the blob fields above. Without a chainspec the activation is
    # parent-driven: once the chain carries a field it can never be
    # dropped (a header that omits it would sidestep the beacon-root
    # system call / requests commitment entirely).
    beacon_active = (spec.beacon_root_call if spec is not None else
                     (parent.parent_beacon_block_root is not None
                      or header.parent_beacon_block_root is not None))
    if beacon_active:
        if header.parent_beacon_block_root is None:
            raise ConsensusError("missing parent beacon block root post-Cancun")
    elif spec is not None and header.parent_beacon_block_root is not None:
        raise ConsensusError("parent beacon block root before Cancun")
    requests_active = (spec.has_requests if spec is not None else
                       (parent.requests_hash is not None
                        or header.requests_hash is not None))
    if requests_active:
        if header.requests_hash is None:
            raise ConsensusError("missing requests hash post-Prague")
    elif spec is not None and header.requests_hash is not None:
        raise ConsensusError("requests hash before Prague")


def validate_block_pre_execution(block: Block, committer=None,
                                 chainspec=None) -> None:
    """Structural checks before execution: body roots match the header."""
    header = block.header
    spec = _spec_of(chainspec, header)
    tx_encodings = [tx.encode() for tx in block.transactions]
    if ordered_trie_root(tx_encodings, committer) != header.transactions_root:
        raise ConsensusError("transactions root mismatch")
    total_blob_gas = sum(tx.blob_gas() for tx in block.transactions)
    if header.blob_gas_used is not None:
        if total_blob_gas != header.blob_gas_used:
            raise ConsensusError(
                f"blob gas used {total_blob_gas} != header {header.blob_gas_used}"
            )
    elif total_blob_gas:
        raise ConsensusError("blob transactions in a block without blob fields")
    if block.withdrawals is not None:
        want = ordered_trie_root(
            [rlp_encode(w.rlp_fields()) for w in block.withdrawals], committer
        )
        if header.withdrawals_root != want:
            raise ConsensusError("withdrawals root mismatch")
    elif header.withdrawals_root is not None:
        raise ConsensusError("header has withdrawals root but body has none")
    if block.ommers:
        if spec is None or spec.merge:
            raise ConsensusError("ommers not allowed post-merge")
        want = keccak256(rlp_encode([o.rlp_fields() for o in block.ommers]))
        if want != header.ommers_hash:
            raise ConsensusError("ommers hash mismatch")
    elif header.ommers_hash != EMPTY_OMMER_ROOT_HASH:
        raise ConsensusError("header ommers hash without body ommers")


def validate_block_post_execution(
    block: Block, receipts: list[Receipt], gas_used: int, committer=None,
    chainspec=None, requests: list[bytes] | None = None,
) -> None:
    header = block.header
    spec = _spec_of(chainspec, header)
    if gas_used != header.gas_used:
        raise ConsensusError(f"gas used {gas_used} != header {header.gas_used}")
    # receipts root: pre-Byzantium receipts embed per-tx state roots the
    # pipeline doesn't compute — skip like the reference, unless the
    # receipts actually carry roots (the conformance replay path does)
    can_check_receipts = (spec is None or spec.receipt_status
                          or all(r.state_root is not None for r in receipts))
    if can_check_receipts:
        receipts_root = ordered_trie_root([r.encode_2718() for r in receipts], committer)
        if receipts_root != header.receipts_root:
            raise ConsensusError("receipts root mismatch")
    bloom = logs_bloom([log for r in receipts for log in r.logs])
    if bloom != header.logs_bloom:
        raise ConsensusError("logs bloom mismatch")
    if requests is not None and header.requests_hash is not None:
        import hashlib

        acc = hashlib.sha256()
        for r in requests:
            if len(r) > 1:
                acc.update(hashlib.sha256(r).digest())
        if acc.digest() != header.requests_hash:
            raise ConsensusError("requests hash mismatch")


class EthBeaconConsensus:
    """Bundles the rule set behind one object (reference `FullConsensus`).
    A chainspec makes every check fork-aware; without one the post-merge
    rules apply (engine live-tip usage). The body and receipts roots hash on
    ``committer``, else on ``TrieCommitter(device=device)``: kernel 1 on the
    card unless ``device="cpu"``."""

    def __init__(self, committer=None, chainspec=None,
                 device: str | torch.device = "cuda"):
        self.committer = committer or TrieCommitter(device=device)
        self.chainspec = chainspec

    def validate_header_against_parent(self, header: Header, parent: Header):
        validate_header_against_parent(header, parent, self.chainspec)

    def validate_block_pre_execution(self, block: Block):
        validate_block_pre_execution(block, self.committer, self.chainspec)

    def validate_block_post_execution(self, block: Block, receipts, gas_used,
                                      requests: list[bytes] | None = None):
        validate_block_post_execution(block, receipts, gas_used, self.committer,
                                      self.chainspec, requests)
