"""The port's witness generation (engine/witness.py) and stateless
validation (engine/stateless.py) against the JAX package's, on the CPU,
tolerance zero.

Every case of tests/test_witness.py runs as one scenario on both packages
(tests/_torch_block_pkgs.py): the chains are sealed by the reference and
carried across by their RLP and their genesis's plain fields. Each witness
must be equal in all four lists (and in ``to_json``); each stateless root and
each error message must be the reference's, on tampered, incomplete and
unlinked-header witnesses and across the consecutive deletion collapse. The
port's ``StatelessChain`` takes its default route on ``device="cpu"``: the
witness batch through kernel 1's plain version (``KeccakDevice``), the finish
through ``ParallelSparseCommitter``'s (classic, or kernel 4's plain version at
``RETH_TPU_SUBTRIE_LEVELS=8``). The small staged-sync chain (tests/
_torch_helpers.py ``SyncChain`` at ``SYNC_BLOCK_SMALL``) is witnessed with a
proof-worker pool on the card route's committer and validated statelessly
block after block.
"""

from __future__ import annotations

import dataclasses
import types

import pytest

from _torch_block_pkgs import (
    PORT,
    PORT_CARD,
    REF,
    Account,
    ChainBuilder,
    Wallet,
    attempt,
    both,
    genesis_factory,
)
from _torch_helpers import SYNC_BLOCK_SMALL, SyncChain
from reth_tpu import testing as jtesting
from reth_tpu.primitives import keccak as jkeccak
from reth_tpu.primitives import secp256k1 as jsecp
from reth_tpu.primitives import types as jtypes
from reth_tpu_torch.engine.stateless import StatelessChain
from reth_tpu_torch.primitives.keccak import keccak256_batch_np

JAX = types.SimpleNamespace(testing=jtesting, types=jtypes, keccak=jkeccak, secp256k1=jsecp)

# PUSH0 CALLDATALOAD PUSH0 SSTORE STOP — stores calldata word0 at slot 0
STORE_CODE = bytes.fromhex("5f355f5500")
# PUSH0 CALLDATALOAD BLOCKHASH PUSH0 SSTORE STOP — stores BLOCKHASH(word0)
BLOCKHASH_CODE = bytes.fromhex("5f35405f5500")
# stores storage[calldata word0] = calldata word1
KV_CODE = bytes.fromhex("6020355f355500")


def initcode_for(runtime: bytes) -> bytes:
    n = len(runtime)
    return bytes([0x60, n, 0x60, 0x0B, 0x5F, 0x39, 0x60, n, 0x5F, 0xF3]) + b"\x00" + runtime


def contract_of(builder, code: bytes) -> bytes:
    return [a for a, acc in builder.accounts.items()
            if builder.codes.get(acc.code_hash) == code][0]


# -- the reference's chains (tests/test_witness.py), sealed once ---------------


@pytest.fixture(scope="module")
def store_chain():
    """Transfers, a deploy, storage writes and a slot zeroed, five blocks."""
    alice, bob = Wallet(0xA11CE), Wallet(0xB0B)
    builder = ChainBuilder({alice.address: Account(balance=10**21),
                            bob.address: Account(balance=10**21)}, committer=REF.committer())
    builder.build_block([alice.transfer(b"\x0c" * 20, 1000)])
    builder.build_block([alice.deploy(initcode_for(STORE_CODE))])
    contract = contract_of(builder, STORE_CODE)
    builder.build_block([alice.call(contract, (0xBEEF).to_bytes(32, "big")),
                         bob.transfer(alice.address, 7)])
    builder.build_block([alice.call(contract, (0).to_bytes(32, "big"))])
    builder.build_block([bob.transfer(b"\x0d" * 20, 55)])
    return builder


@pytest.fixture(scope="module")
def blockhash_chain():
    """The last block SSTOREs BLOCKHASH(1), three blocks deep."""
    alice = Wallet(0xA11CE)
    builder = ChainBuilder({alice.address: Account(balance=10**21)}, committer=REF.committer())
    builder.build_block([alice.deploy(initcode_for(BLOCKHASH_CODE))])
    contract = contract_of(builder, BLOCKHASH_CODE)
    builder.build_block([alice.transfer(b"\x0c" * 20, 1)])
    builder.build_block([alice.transfer(b"\x0c" * 20, 2)])
    builder.build_block([alice.call(contract, (1).to_bytes(32, "big"))])
    return builder


@pytest.fixture(scope="module")
def collapse_chain():
    """Block n touches slot A only; block n+1 zeroes A, collapsing the
    storage root branch into sibling B's leaf."""
    alice = Wallet(0xA11CE)
    builder = ChainBuilder({alice.address: Account(balance=10**21)}, committer=REF.committer())
    builder.build_block([alice.deploy(initcode_for(KV_CODE))])
    kv = contract_of(builder, KV_CODE)

    def kv_set(key, value):
        return alice.call(kv, key.to_bytes(32, "big") + value.to_bytes(32, "big"))

    builder.build_block([kv_set(1, 0xAA), kv_set(2, 0xBB)])
    builder.build_block([kv_set(1, 0xA2)])
    builder.build_block([kv_set(1, 0)])
    assert builder.storages[kv] == {(2).to_bytes(32, "big"): 0xBB}
    return builder


@pytest.fixture(scope="module")
def sync_chain():
    return SyncChain(JAX, n_accounts=60, n_slots=24, seed=47, n_wallets=4, n_blocks=3,
                     sizes=SYNC_BLOCK_SMALL, committer=REF.committer()).builder


# -- helpers ----------------------------------------------------------------------


class Node:
    """P's database at a chain's genesis, advanced block by block by
    import_chain + the staged pipeline (the reference's tests' stateful
    node)."""

    def __init__(self, P, builder):
        self.P, self.builder = P, builder
        self.factory = genesis_factory(P, builder)
        self.cfg = P.EvmConfig(chain_id=builder.chain_id)
        self.number = 0

    def witness(self, n: int, **kw):
        P = self.P
        with self.factory.provider() as p:
            return P.generate_witness(p, P.block(self.builder.blocks[n]), P.committer(),
                                      parent_header=P.header(self.builder.blocks[n - 1].header),
                                      config=self.cfg, **kw)

    def advance(self, n: int) -> None:
        P = self.P
        P.import_chain(self.factory, [P.block(self.builder.blocks[n])], P.consensus())
        P.Pipeline(self.factory, P.stages()).run(n)
        self.number = n

    def validate(self, chain, n: int, w, block=None):
        P = self.P
        return chain.validate(block if block is not None else P.block(self.builder.blocks[n]),
                              w, P.header(self.builder.blocks[n - 1].header))


def wire(w) -> dict:
    return w.to_json()


# -- tests/test_witness.py --------------------------------------------------------


def sc_closed_chain(P, builder):
    node = Node(P, builder)
    chain = P.stateless(node.cfg)
    out = []
    for n in range(1, len(builder.blocks)):
        w = node.witness(n)
        w2 = P.ExecutionWitness.from_json(w.to_json())
        assert w2 == w
        root = node.validate(chain, n, w2)
        assert root == builder.blocks[n].header.state_root
        out.append((wire(w), root))
        node.advance(n)
    out.append(chain.preserved.hits)
    assert chain.preserved.hits == len(builder.blocks) - 2
    return out


def sc_tampered(P, builder):
    node = Node(P, builder)
    w = node.witness(1)
    block = P.block(builder.blocks[1])
    bad = dataclasses.replace(block, header=dataclasses.replace(block.header,
                                                                 state_root=b"\xde" * 32))
    out = [wire(w), attempt(lambda: node.validate(P.stateless(node.cfg), 1, w, bad))]
    assert out[1][1] == "StatelessValidationError" and "stateless root mismatch" in out[1][2]
    return out


def sc_incomplete(P, builder):
    node = Node(P, builder)
    w = node.witness(1)
    assert len(w.state) > 1
    w.state = w.state[:1]
    out = [attempt(lambda: node.validate(P.stateless(node.cfg), 1, w))]
    assert out[0][1] == "StatelessValidationError"
    return out


def sc_root_node_removed(P, builder):
    """Drill a of the smoke: a needed node (here the parent's account-trie
    root) removed from the witness raises "witness incomplete"."""
    node = Node(P, builder)
    w = node.witness(1)
    root = builder.blocks[0].header.state_root
    w.state = [x for x in w.state if P.keccak.keccak256(x) != root]
    out = [attempt(lambda: node.validate(P.stateless(node.cfg), 1, w))]
    assert out[0][2].startswith("witness incomplete: blinded path")
    return out


def blockhash_setup(P, builder):
    node = Node(P, builder)
    P.import_chain(node.factory, [P.block(b) for b in builder.blocks[1:4]], P.consensus())
    P.Pipeline(node.factory, P.stages()).run(3)
    return node, node.witness(4)


def sc_blockhash_headers(P, builder):
    node, w = blockhash_setup(P, builder)
    root = node.validate(P.stateless(node.cfg), 4, w)
    assert len(w.headers) == 3 and root == builder.blocks[4].header.state_root
    return [wire(w), root]


def sc_unlinked_headers(P, builder):
    node, w = blockhash_setup(P, builder)
    forged = dataclasses.replace(P.types.Header.decode(w.headers[1]), state_root=b"\xfe" * 32)
    w_forged = P.ExecutionWitness(state=w.state, codes=w.codes, keys=w.keys,
                                  headers=[w.headers[0], forged.encode(), w.headers[2]])
    stray = dataclasses.replace(P.header(builder.blocks[2].header), number=9999)
    w_stray = P.ExecutionWitness(state=w.state, codes=w.codes, keys=w.keys,
                                 headers=list(w.headers) + [stray.encode()])
    parent = P.header(builder.blocks[3].header)
    w_fork = P.ExecutionWitness(state=w.state, codes=w.codes, keys=w.keys,
                                headers=[dataclasses.replace(parent, gas_used=1).encode()])
    out = [attempt(lambda: node.validate(P.stateless(node.cfg), 4, w_forged)),
           attempt(lambda: node.validate(P.stateless(node.cfg), 4, w_stray)),
           attempt(lambda: P.stateless(node.cfg).validate(
               P.block(builder.blocks[4]), w, P.header(builder.blocks[2].header))),
           attempt(lambda: node.validate(P.stateless(node.cfg), 4, w_fork))]
    assert "hash-linked" in out[0][2] and "not in ancestor" in out[1][2]
    assert out[2][2] == "witness parent mismatch"
    assert out[3][2] == "witness header forks from parent"
    return out


def sc_touched_codes(P, builder):
    node = Node(P, builder)
    P.import_chain(node.factory, [P.block(b) for b in builder.blocks[1:3]], P.consensus())
    P.Pipeline(node.factory, P.stages()).run(2)
    w = node.witness(3)
    assert STORE_CODE in w.codes
    assert any(len(k) == 20 for k in w.keys) and any(len(k) == 32 for k in w.keys)
    return [wire(w)]


def sc_deletion_collapse(P, builder):
    node = Node(P, builder)
    chain = P.stateless(node.cfg)
    witnesses, out = [], []
    for n in range(1, len(builder.blocks)):
        w = node.witness(n)
        witnesses.append(w)
        root = node.validate(chain, n, w)
        assert root == builder.blocks[n].header.state_root
        out.append((wire(w), root))
        node.advance(n)
    assert chain.preserved.hits == len(builder.blocks) - 2
    last = P.ExecutionWitness.from_json(witnesses[-1].to_json())
    fresh = node.validate(P.stateless(node.cfg), len(builder.blocks) - 1, last)
    prev = {P.keccak.keccak256(x) for x in witnesses[-2].state}
    new = {P.keccak.keccak256(x) for x in witnesses[-1].state} - prev
    assert fresh == builder.blocks[-1].header.state_root and new
    return out + [chain.preserved.hits, fresh, sorted(new)]


def sc_sync_chain(P, builder):
    """The small sync chain: each block's witness from the parent's view
    with a pool of 4 proof workers (``provider_factory=``), validated by one
    StatelessChain from the witnesses alone, the preserved trie carried."""
    node = Node(P, builder)
    chain = P.stateless(node.cfg)
    out = []
    for n in range(1, len(builder.blocks)):
        w = node.witness(n, provider_factory=node.factory.provider, proof_workers=4)
        root = node.validate(chain, n, w)
        assert root == builder.blocks[n].header.state_root
        out.append((wire(w), root, chain.last_output.gas_used))
        node.advance(n)
    assert chain.preserved.hits == len(builder.blocks) - 2
    return out


CHAINS = {"store": sc_closed_chain, "tampered": sc_tampered, "incomplete": sc_incomplete,
          "root node removed": sc_root_node_removed, "touched codes": sc_touched_codes}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_store_chain_matches_reference(store_chain, name):
    both(CHAINS[name], store_chain)


@pytest.mark.parametrize("scenario", [sc_blockhash_headers, sc_unlinked_headers],
                         ids=lambda f: f.__name__[3:])
def test_blockhash_chain_matches_reference(blockhash_chain, scenario):
    both(scenario, blockhash_chain)


def test_deletion_collapse_matches_reference(collapse_chain):
    both(sc_deletion_collapse, collapse_chain)


@pytest.mark.parametrize("port", [PORT, PORT_CARD], ids=["numpy committer", "card route"])
def test_sync_chain_witness_matches_reference(sync_chain, port):
    """With PORT_CARD the whole path runs through the card route's plain
    versions: the multiproofs, the node and key batches and the closure on
    ``TrieCommitter(device="cpu")``, the stateless reveal and finish on
    ``StatelessChain(device="cpu")``."""
    both(sc_sync_chain, sync_chain, port=port)


def test_fused_stateless_finish_matches_reference(collapse_chain, monkeypatch):
    """``RETH_TPU_SUBTRIE_LEVELS=8``: the stateless finish takes the fused
    route, kernel 4's plain version; every root the reference's."""
    want = sc_deletion_collapse(REF, collapse_chain)
    monkeypatch.setenv("RETH_TPU_SUBTRIE_LEVELS", "8")
    chain = PORT.stateless(PORT.EvmConfig(chain_id=collapse_chain.chain_id))
    assert chain.committer.subtrie_levels == 8
    assert sc_deletion_collapse(PORT, collapse_chain) == want


def test_numpy_hasher_matches_the_default_route(store_chain):
    """A hasher of the caller's hashes everything on it, the finish serially
    per trie, as in the reference; roots equal the default route's."""
    node = Node(PORT, store_chain)
    cpu = StatelessChain(config=node.cfg, hasher=keccak256_batch_np)
    dev = StatelessChain(config=node.cfg, device="cpu")
    assert cpu.committer is None and dev.committer is not None
    for n in range(1, len(store_chain.blocks)):
        w = node.witness(n)
        assert node.validate(cpu, n, w) == node.validate(dev, n, w) == \
            store_chain.blocks[n].header.state_root
        node.advance(n)


def test_witness_stats_and_no_host_hashing(store_chain, monkeypatch):
    """``stats=`` names the witness's phases and counts. Neither the witness's
    closure nor the stateless validation hashes a revealed node or a key on
    the host: the batches' maps serve every reveal and every key (the
    reference calls the host keccak for each)."""
    from reth_tpu_torch.engine import stateless as pstateless
    from reth_tpu_torch.trie import sparse as psparse

    node = Node(PORT, store_chain)
    for n in (1, 2, 3):
        node.advance(n)
    host = []

    def counted(real):
        def keccak(data):
            host.append(data)
            return real(data)
        return keccak

    reveals = []
    real_reveal = psparse.SparseTrie.reveal

    def reveal(self, proof_nodes, by_hash=None):
        reveals.append(by_hash is not None or not proof_nodes)
        return real_reveal(self, proof_nodes, by_hash)

    monkeypatch.setattr(psparse.SparseTrie, "reveal", reveal)
    monkeypatch.setattr(pstateless, "keccak256", counted(pstateless.keccak256))
    stats: dict = {}
    w = node.witness(4, stats=stats)
    assert sorted(stats) == ["bytes", "close_s", "codes", "execute_s", "hash_nodes_s", "headers",
                             "keys", "multiproof_s", "nodes", "rounds"]
    assert (stats["nodes"], stats["codes"], stats["keys"], stats["headers"]) == \
        (len(w.state), len(w.codes), len(w.keys), len(w.headers))
    assert stats["rounds"] >= 1 and stats["bytes"] > 0
    chain = PORT.stateless(node.cfg)
    assert node.validate(chain, 4, w) == store_chain.blocks[4].header.state_root
    assert host == [] and reveals and all(reveals)
    assert sorted(chain.last_stats) == ["execute_s", "keys", "nodes", "reveal_s", "root_s"]


def test_witness_matches_reference_on_the_card_route(store_chain):
    """generate_witness on the card route's committer (kernel 1's plain
    version) gives the reference's witness, block by block."""
    both(sc_closed_chain, store_chain, port=PORT_CARD)
