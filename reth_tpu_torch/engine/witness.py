"""Execution witness generation: everything needed to re-execute a block
statelessly against its parent.

A copy of the JAX package's ``engine/witness.py`` on the port's EVM, proofs
and sparse trie. Format follows the reference's ExecutionWitness: `state`
(parent-state trie nodes), `codes` (touched bytecodes), `keys` (touched
preimages), `headers` (RLP ancestor headers for BLOCKHASH + the parent).

The witness is CLOSED under trie edits: after collecting the touched-key
multiproof, the block's state delta is applied to a sparse trie revealed
from it; any `BlindedNodeError` (a delete collapsing into an unrevealed
sibling) reveals that path from the parent view and adds it to the
witness, so a stateless validator can replay the block without a state
source (reference sparse-trie reveal-on-demand, done ahead of time here
because the consumer has nobody to ask).

One departure, with the reference's witness in every field and order: the
multiproof's nodes hash in one batch on the committer's hasher (on the
``"proof"`` lane, kernel 1 through ``KeccakDevice`` on the card), each
closure round's new nodes in one more, and the block's keys in one; the
reference hashes each node and key on the host, once more for every retry
of the closure loop. The batch's map feeds every reveal
(``SparseTrie.reveal(by_hash=)``) and the key digests
``apply_output_to_trie(digests=)``.

Reference analogue: `debug_executionWitness`
(crates/rpc/rpc/src/debug.rs), the invalid-block witness hook
(crates/engine/invalid-block-hooks/src/witness.rs), and revm's witness
recording (crates/revm/src/witness.rs).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from .. import tracing
from ..evm.executor import BlockExecutor, StateSource
from ..primitives.types import Block, Header
from ..trie.proof import ProofCalculator
from ..trie.sparse import BlindedNodeError, SparseStateTrie
from .stateless import apply_output_to_trie


@dataclass
class ExecutionWitness:
    """Self-contained stateless re-execution input for one block."""

    state: list[bytes] = field(default_factory=list)    # trie node RLPs
    codes: list[bytes] = field(default_factory=list)    # bytecodes
    keys: list[bytes] = field(default_factory=list)     # address/slot preimages
    headers: list[bytes] = field(default_factory=list)  # RLP headers

    def to_json(self) -> dict:
        return {
            "state": ["0x" + n.hex() for n in self.state],
            "codes": ["0x" + c.hex() for c in self.codes],
            "keys": ["0x" + k.hex() for k in self.keys],
            "headers": ["0x" + h.hex() for h in self.headers],
        }

    @classmethod
    def from_json(cls, obj: dict) -> "ExecutionWitness":
        unhex = lambda x: bytes.fromhex(x[2:] if x.startswith("0x") else x)  # noqa: E731
        return cls(
            state=[unhex(n) for n in obj.get("state", [])],
            codes=[unhex(c) for c in obj.get("codes", [])],
            keys=[unhex(k) for k in obj.get("keys", [])],
            headers=[unhex(h) for h in obj.get("headers", [])],
        )


class RecordingStateSource(StateSource):
    """Wraps a provider view, recording every read the EVM makes."""

    def __init__(self, provider):
        self.provider = provider
        self.addresses: set[bytes] = set()
        self.slots: dict[bytes, set[bytes]] = {}
        self.code_hashes: set[bytes] = set()

    def account(self, address: bytes):
        self.addresses.add(address)
        return self.provider.account(address)

    def storage(self, address: bytes, slot: bytes) -> int:
        self.addresses.add(address)
        self.slots.setdefault(address, set()).add(slot)
        return self.provider.storage(address, slot)

    def bytecode(self, code_hash: bytes) -> bytes:
        self.code_hashes.add(code_hash)
        return self.provider.bytecode(code_hash) or b""


class _RecordingHashes(dict):
    """BLOCKHASH window that records which block numbers the EVM read, so
    the witness ships exactly the ancestor headers a stateless replay needs
    (reference ExecutionWitness `headers`)."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.read: set[int] = set()

    def get(self, key, default=None):
        self.read.add(key)
        return super().get(key, default)

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def _add_nodes(nodes: dict[bytes, bytes], batch: list[bytes], hasher) -> bool:
    """Key ``batch``'s nodes into ``nodes`` by their keccak, hashed in one
    call of ``hasher``, in the order the reference inserts them one at a
    time; returns whether any was new."""
    if not batch:
        return False
    before = len(nodes)
    for n, d in zip(batch, hasher(batch)):
        nodes.setdefault(bytes(d), n)
    return len(nodes) > before


def generate_witness(parent_provider, block: Block, committer,
                     senders: list[bytes] | None = None,
                     parent_header: Header | None = None,
                     config=None,
                     block_hashes: dict[int, bytes] | None = None,
                     provider_factory=None,
                     proof_workers: int | None = None,
                     stats: dict | None = None) -> ExecutionWitness:
    """Execute ``block`` against the parent view, recording reads, and
    assemble a closed witness. ``parent_provider`` must present the state
    AS OF the parent block (trie tables + hashed/plain state);
    ``block_hashes`` supplies the BLOCKHASH window when the parent view
    (e.g. a historical provider) cannot. With ``provider_factory`` (a
    zero-arg callable yielding fresh parent views) the touched-key
    multiproof shards by storage trie across the proof-worker pool
    (``trie/proof.py`` ProofWorkerPool) instead of serializing per trie.
    ``stats``, when given, receives the walls of execution, the multiproof,
    the node hashing and the closure, the closure's rounds, and the
    witness's counts and bytes."""
    t0 = time.perf_counter()
    src = RecordingStateSource(parent_provider)
    executor = BlockExecutor(src, config)
    if senders is None:
        senders = [tx.recover_sender() for tx in block.transactions]
    # BLOCKHASH window served (and recorded) from canonical headers
    hashes = _RecordingHashes(block_hashes or {})
    headers: list[bytes] = []
    if parent_header is None and hasattr(parent_provider, "header_by_number"):
        parent_header = parent_provider.header_by_number(block.header.number - 1)
    if parent_header is not None:
        headers.append(parent_header.encode())
    lo = max(0, block.header.number - 256)
    if not hashes and hasattr(parent_provider, "canonical_hash"):
        for n in range(lo, block.header.number):
            h = parent_provider.canonical_hash(n)
            if h is not None:
                hashes[n] = h
    with tracing.span("engine::witness", "witness.execute", txs=len(block.transactions)):
        out = executor.execute(block, senders, hashes)

    # ship the ancestor headers BLOCKHASH actually read — as a contiguous
    # hash-linked chain down from the parent, since a stateless validator
    # can only authenticate header N-k through its child at N-k+1
    read = {n for n in hashes.read if lo <= n < block.header.number - 1}
    if read and hasattr(parent_provider, "header_by_number"):
        for n in range(block.header.number - 2, min(read) - 1, -1):
            hdr = parent_provider.header_by_number(n)
            if hdr is None:
                break
            headers.append(hdr.encode())

    # the executor also writes: fee recipient, withdrawals, created/deleted
    touched = set(src.addresses) | set(out.post_accounts)
    slots = {a: set(s) for a, s in src.slots.items()}
    for a, ps in out.post_storage.items():
        slots.setdefault(a, set()).update(ps)
    targets = {a: sorted(slots.get(a, ())) for a in sorted(touched)}
    t1 = time.perf_counter()

    # witness generation is RPC work: ride the proof (lowest) hash-service
    # lane — its multiproofs coalesce with other clients' batches but
    # never delay the live tip (identity without a service)
    if hasattr(committer, "for_lane"):
        committer = committer.for_lane("proof")
    hasher = committer.hasher
    calc = ProofCalculator(parent_provider, committer)
    with tracing.span("engine::witness", "witness.multiproof", accounts=len(targets)):
        if provider_factory is not None:
            from ..trie.proof import ProofWorkerPool

            pool = ProofWorkerPool(
                lambda: ProofCalculator(provider_factory(), committer),
                workers=proof_workers)
            try:
                proofs = pool.multiproof(targets)
            finally:
                pool.shutdown()
        else:
            proofs = calc.multiproof(targets)
    t2 = time.perf_counter()
    # every proof node and every key of the block, each in one batch
    with tracing.span("engine::witness", "witness.hash_nodes"):
        batch: list[bytes] = []
        for ap in proofs.values():
            batch.extend(ap.proof)
            for sp in ap.storage_proofs:
                batch.extend(sp.proof)
        nodes: dict[bytes, bytes] = {}
        _add_nodes(nodes, batch, hasher)
        key_list = list(dict.fromkeys(
            list(targets) + [s for a in targets for s in targets[a]]
            + list(out.changes.wiped_storage)))
        digests = dict(zip(key_list, (bytes(d) for d in hasher(key_list)))) if key_list else {}
    t3 = time.perf_counter()

    # close the witness under the block's own trie edits: reveal, apply,
    # and feed back any sibling paths a collapse needs
    parent_root = (parent_header.state_root if parent_header is not None
                   else parent_provider.header_by_number(
                       block.header.number - 1).state_root)
    rounds = 0
    with tracing.span("engine::witness", "witness.close"):
        for _attempt in range(64):
            rounds += 1
            st = SparseStateTrie.anchored(parent_root)
            all_nodes = list(nodes.values())
            st.reveal_account(all_nodes, nodes)
            for a in targets:
                ap = proofs.get(a)
                if ap is not None and ap.account is not None:
                    st.reveal_storage(digests[a], ap.storage_root, all_nodes, nodes)
            try:
                apply_output_to_trie(st, out, hasher, digests=digests)
                break
            except BlindedNodeError as e:
                extra = (calc.storage_spine_for_path(e.owner, e.path)
                         if e.owner is not None else calc.spine_for_path(e.path))
                if not _add_nodes(nodes, list(extra), hasher):
                    raise  # witness cannot be closed; bail loudly
    t4 = time.perf_counter()
    codes = []
    seen = set()
    for ch in src.code_hashes:
        code = parent_provider.bytecode(ch)
        if code and ch not in seen:
            seen.add(ch)
            codes.append(code)
    keys = [a for a in targets]
    for a in targets:
        keys.extend(targets[a])
    witness = ExecutionWitness(
        state=list(nodes.values()), codes=codes, keys=keys, headers=headers,
    )
    if stats is not None:
        stats.update(
            execute_s=t1 - t0, multiproof_s=t2 - t1, hash_nodes_s=t3 - t2, close_s=t4 - t3,
            rounds=rounds, nodes=len(witness.state), codes=len(codes), keys=len(keys),
            headers=len(headers),
            bytes=sum(len(x) for part in (witness.state, codes, keys, headers) for x in part))
    return witness
