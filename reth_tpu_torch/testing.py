"""Test-chain construction: execute real txs, seal valid blocks.

A copy of the JAX package's ``testing.py``.

Reference analogue: `reth_testing_utils::generators` + the e2e testsuite's
block production (crates/e2e-test-utils) — but here blocks are sealed by
actually executing them, so every header's gas/receipts/state roots are
consensus-valid against this framework's own execution + trie code. Used
by stage/pipeline tests and the dev-mode local miner.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .consensus.validation import calc_next_base_fee
from .evm import BlockExecutor, EvmConfig
from .evm.executor import InMemoryStateSource
from .primitives import secp256k1
from .primitives.keccak import keccak256
from .primitives.rlp import rlp_encode
from .primitives.types import (
    Account,
    Block,
    EMPTY_ROOT_HASH,
    Header,
    Transaction,
    Withdrawal,
    logs_bloom,
)
from .trie.committer import TrieCommitter
from .trie.state_root import ordered_trie_root, state_root

# EIP-7685: sha256 of zero request payloads (Prague empty-requests hash)
import hashlib as _hashlib

_EMPTY_REQUESTS_HASH = _hashlib.sha256().digest()


@dataclass
class Wallet:
    """A funded test account that signs transactions."""

    priv: int
    nonce: int = 0

    @property
    def address(self) -> bytes:
        return secp256k1.address_from_priv(self.priv)

    def transfer(self, to: bytes, value: int, chain_id: int = 1, **kw) -> Transaction:
        return self.sign_tx(Transaction(
            tx_type=2, chain_id=chain_id, nonce=self.nonce,
            max_fee_per_gas=kw.pop("max_fee_per_gas", 100 * 10**9),
            max_priority_fee_per_gas=kw.pop("max_priority_fee_per_gas", 10**9),
            gas_limit=kw.pop("gas_limit", 21_000), to=to, value=value, **kw,
        ))

    def deploy(self, initcode: bytes, chain_id: int = 1, gas_limit: int = 1_000_000) -> Transaction:
        return self.sign_tx(Transaction(
            tx_type=2, chain_id=chain_id, nonce=self.nonce,
            max_fee_per_gas=100 * 10**9, max_priority_fee_per_gas=10**9,
            gas_limit=gas_limit, to=None, data=initcode,
        ))

    def call(self, to: bytes, data: bytes, chain_id: int = 1, gas_limit: int = 200_000,
             value: int = 0) -> Transaction:
        return self.sign_tx(Transaction(
            tx_type=2, chain_id=chain_id, nonce=self.nonce,
            max_fee_per_gas=100 * 10**9, max_priority_fee_per_gas=10**9,
            gas_limit=gas_limit, to=to, value=value, data=data,
        ))

    def sign_tx(self, tx: Transaction, bump_nonce: bool = True) -> Transaction:
        """Sign an arbitrary unsigned tx (any envelope type) with this key."""
        p, r, s = secp256k1.sign(tx.signing_hash(), self.priv)
        if bump_nonce:
            self.nonce += 1
        return Transaction(**{**tx.__dict__, "y_parity": p, "r": r, "s": s})

    def authorize(self, delegate: bytes, nonce: int, chain_id: int = 1):
        """Sign an EIP-7702 authorization delegating this account's code.

        ``nonce`` is explicit on purpose: the authority's ACCOUNT nonce at
        authorization-processing time must match, and when the authority
        also sends the tx its nonce is bumped before processing — a default
        would silently sign stale tuples."""
        from .primitives.types import Authorization

        auth = Authorization(chain_id=chain_id, address=delegate, nonce=nonce)
        p, r, s = secp256k1.sign(auth.signing_hash(), self.priv)
        return Authorization(**{**auth.__dict__, "y_parity": p, "r": r, "s": s})


class ChainBuilder:
    """Builds a consensus-valid chain by executing blocks as it seals them."""

    def __init__(
        self,
        genesis_alloc: dict[bytes, Account] | None = None,
        genesis_storage: dict[bytes, dict[bytes, int]] | None = None,
        codes: dict[bytes, bytes] | None = None,
        chain_id: int = 1,
        committer: TrieCommitter | None = None,
        genesis_gas_limit: int = 30_000_000,
        cancun: bool = False,
        network: str | None = None,
        device: str | torch.device = "cuda",
    ):
        """``network`` pins an ef-tests fork label (e.g. "Paris",
        "Shanghai", "Prague"): blocks execute under exactly that rule set
        and headers carry exactly that fork's fields. Without it, the
        legacy dev shape applies (latest rules, Shanghai-style headers,
        ``cancun=True`` opting into blob fields). Every root hashes on
        ``committer``, else on ``TrieCommitter(device=device)``."""
        self.chain_id = chain_id
        self.network = network
        if network is not None:
            from .chainspec import NETWORK_TO_FORK
            from .evm.spec import spec_for_fork

            self.spec = spec_for_fork(NETWORK_TO_FORK[network])
            cancun = self.spec.blob is not None
        else:
            self.spec = None
        self.cancun = cancun  # blob-gas header fields (EIP-4844)
        self.committer = committer or TrieCommitter(device=device)
        self.accounts: dict[bytes, Account] = dict(genesis_alloc or {})
        self.storages: dict[bytes, dict[bytes, int]] = {
            a: dict(s) for a, s in (genesis_storage or {}).items()
        }
        self.codes: dict[bytes, bytes] = dict(codes or {})
        # frozen genesis images for init_genesis callers
        self.accounts_at_genesis = dict(self.accounts)
        self.storage_at_genesis = {a: dict(s) for a, s in self.storages.items()}
        self.codes_at_genesis = dict(self.codes)
        root, _ = state_root(self.accounts, self.storages, committer=self.committer)
        s = self.spec
        self.genesis = Header(
            number=0,
            state_root=root,
            gas_limit=genesis_gas_limit,
            timestamp=0,
            base_fee_per_gas=10**9 if s is None or s.has_basefee else None,
            withdrawals_root=(EMPTY_ROOT_HASH
                              if s is None or s.has_withdrawals else None),
            blob_gas_used=0 if cancun else None,
            excess_blob_gas=0 if cancun else None,
            parent_beacon_block_root=(b"\x00" * 32
                                      if s is not None and s.beacon_root_call
                                      else None),
            requests_hash=(_EMPTY_REQUESTS_HASH
                           if s is not None and s.has_requests else None),
        )
        self.blocks: list[Block] = [Block(self.genesis, (), (), ())]
        self.block_hashes: dict[int, bytes] = {0: self.genesis.hash}

    @property
    def tip(self) -> Header:
        return self.blocks[-1].header

    def state_source(self) -> InMemoryStateSource:
        return InMemoryStateSource(self.accounts, self.storages, self.codes)

    def build_block(
        self,
        txs: list[Transaction] = (),
        withdrawals: tuple[Withdrawal, ...] = (),
        coinbase: bytes = b"\xfe" * 20,
        timestamp: int | None = None,
    ) -> Block:
        parent = self.tip
        s = self.spec
        base_fee = (calc_next_base_fee(parent)
                    if s is None or s.has_basefee else None)
        blob_kw = {}
        if self.cancun:
            from .evm.executor import next_excess_blob_gas

            target = s.blob.target_gas if s is not None and s.blob else None
            blob_kw = dict(
                blob_gas_used=sum(tx.blob_gas() for tx in txs),
                excess_blob_gas=(next_excess_blob_gas(
                    parent.excess_blob_gas or 0, parent.blob_gas_used or 0,
                    target) if target is not None else next_excess_blob_gas(
                    parent.excess_blob_gas or 0, parent.blob_gas_used or 0)),
            )
            if s is not None and s.beacon_root_call:
                blob_kw["parent_beacon_block_root"] = b"\x00" * 32
        draft = Header(
            parent_hash=parent.hash,
            beneficiary=coinbase,
            number=parent.number + 1,
            gas_limit=parent.gas_limit,
            timestamp=timestamp if timestamp is not None else parent.timestamp + 12,
            base_fee_per_gas=base_fee,
            **blob_kw,
        )
        body_withdrawals = (tuple(withdrawals)
                            if s is None or s.has_withdrawals else None)
        block = Block(draft, tuple(txs), (), body_withdrawals)
        executor = BlockExecutor(
            self.state_source(),
            EvmConfig(chain_id=self.chain_id, spec=s) if s is not None
            else EvmConfig(chain_id=self.chain_id))
        out = executor.execute(block, block_hashes=self.block_hashes)

        # apply post-state to the in-memory world
        for addr, acc in out.post_accounts.items():
            if acc is None:
                self.accounts.pop(addr, None)
            else:
                self.accounts[addr] = acc
        for addr in out.changes.wiped_storage:
            self.storages.pop(addr, None)
        for addr, slots in out.post_storage.items():
            per = self.storages.setdefault(addr, {})
            for slot, val in slots.items():
                if val:
                    per[slot] = val
                else:
                    per.pop(slot, None)
            if not per:
                self.storages.pop(addr, None)
        self.codes.update(out.changes.new_bytecodes)

        root, _ = state_root(self.accounts, self.storages, committer=self.committer)
        extra_kw = {}
        if s is None or s.has_withdrawals:
            extra_kw["withdrawals_root"] = ordered_trie_root(
                [rlp_encode(w.rlp_fields()) for w in withdrawals], self.committer)
        if s is not None and s.has_requests:
            acc = _hashlib.sha256()
            for r in out.requests:
                acc.update(_hashlib.sha256(r).digest())
            extra_kw["requests_hash"] = acc.digest()
        header = Header(
            **{
                **draft.__dict__,
                "state_root": root,
                "transactions_root": ordered_trie_root(
                    [tx.encode() for tx in txs], self.committer
                ),
                "receipts_root": ordered_trie_root(
                    [r.encode_2718() for r in out.receipts], self.committer
                ),
                "logs_bloom": logs_bloom([l for r in out.receipts for l in r.logs]),
                "gas_used": out.gas_used,
                **extra_kw,
            }
        )
        sealed = Block(header, tuple(txs), (), body_withdrawals)
        self.blocks.append(sealed)
        self.block_hashes[header.number] = header.hash
        return sealed

    def export_rlp(self) -> bytes:
        """Chain file for `import` (concatenated block RLP, genesis excluded)."""
        return b"".join(b.encode() for b in self.blocks[1:])
