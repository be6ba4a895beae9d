"""Online stages: HeadersStage + BodiesStage pulling from a peer client.

Reference analogue: `HeaderStage`/`BodyStage` + `OnlineStages`
(crates/stages/stages/src/stages/{headers,bodies}.rs, sets.rs:188) —
the pipeline itself drives the download when syncing from the network,
with per-chunk commits and checkpointed resume, instead of a one-shot
import. The ``client`` is anything with ``get_headers(start, limit)``
and ``get_bodies(hashes)`` (a live `PeerConnection`, or a test mock).

A copy of the JAX package's module. A stage that builds its consensus, and
``online_stages``' offline tail, root on ``device``: kernel 1 (and the
Merkle stage's level kernels) on the card unless ``device="cpu"``.
"""

from __future__ import annotations

from ..consensus import ConsensusError, EthBeaconConsensus
from ..storage.provider import DatabaseProvider
from ..storage.tables import Tables, be64
from .api import ExecInput, ExecOutput, Stage, StageError, UnwindInput


class HeadersStage(Stage):
    id = "Headers"

    def __init__(self, client, consensus: EthBeaconConsensus | None = None,
                 max_blocks_per_commit: int = 2048, device="cuda"):
        self.client = client
        self.consensus = consensus or EthBeaconConsensus(device=device)
        self.max_blocks = max_blocks_per_commit

    def execute(self, provider: DatabaseProvider, inp: ExecInput) -> ExecOutput:
        from ..net.downloader import download_headers
        from ..net.p2p import PeerError

        end = min(inp.target, inp.checkpoint + self.max_blocks)
        parent = provider.header_by_number(inp.checkpoint)
        if parent is None:
            raise StageError(f"missing local header {inp.checkpoint}",
                             block=inp.checkpoint)
        try:  # shared fetch helper: batching/contiguity/response caps
            headers = download_headers(self.client, inp.next_block, end)
        except PeerError as e:
            raise StageError(str(e), block=inp.next_block)
        for h in headers:
            try:
                self.consensus.validate_header_against_parent(h, parent)
            except ConsensusError as e:
                raise StageError(f"invalid header {h.number}: {e}", block=h.number)
            provider.insert_header(h)
            parent = h
        return ExecOutput(checkpoint=end, done=end >= inp.target)

    def unwind(self, provider: DatabaseProvider, inp: UnwindInput) -> None:
        for n in range(inp.checkpoint, inp.unwind_to, -1):
            key = be64(n)
            h = provider.tx.get(Tables.CanonicalHeaders.name, key)
            if h is not None:
                provider.tx.delete(Tables.HeaderNumbers.name, h)
            provider.tx.delete(Tables.CanonicalHeaders.name, key)
            provider.tx.delete(Tables.Headers.name, key)


class BodiesStage(Stage):
    id = "Bodies"

    def __init__(self, client, consensus: EthBeaconConsensus | None = None,
                 max_blocks_per_commit: int = 2048, extra_peers: tuple = (),
                 device="cuda"):
        self.client = client
        self.extra_peers = tuple(extra_peers)  # concurrent body windows
        self.consensus = consensus or EthBeaconConsensus(device=device)
        self.max_blocks = max_blocks_per_commit

    def execute(self, provider: DatabaseProvider, inp: ExecInput) -> ExecOutput:
        from ..net.p2p import PeerError

        end = min(inp.target, inp.checkpoint + self.max_blocks)
        headers = []
        for m in range(inp.next_block, end + 1):
            h = provider.header_by_number(m)
            if h is None:
                raise StageError(f"missing header {m} (HeadersStage gap)", block=m)
            headers.append(h)
        try:  # windowed multi-peer fetch (out-of-order reassembly +
            # reputation feedback; reference net/downloaders/src/bodies/)
            from ..net.downloader import BodiesDownloader

            dl = BodiesDownloader([self.client, *self.extra_peers],
                                  consensus=self.consensus)
            blocks = dl.download(headers)
        except PeerError as e:
            raise StageError(str(e), block=inp.next_block)
        for block in blocks:
            if provider.block_body_indices(block.header.number) is not None:
                continue  # already stored (e.g. legacy import): re-inserting
                # would renumber its transactions
            # pre-execution validation already ran inside the downloader
            # (it binds each body to its header per window) — validating
            # again here would hash every body twice per chunk
            provider.insert_block_body(block)
        return ExecOutput(checkpoint=end, done=end >= inp.target)

    def unwind(self, provider: DatabaseProvider, inp: UnwindInput) -> None:
        from ..storage import tables as T

        idx = provider.block_body_indices(inp.unwind_to)
        next_tx = idx.next_tx_num if idx else 0
        # drop the tx rows insert_block_body wrote: hash->num and
        # last-tx->block would otherwise serve WRONG lookups after tx
        # numbers are reassigned on a reorged chain (senders are removed
        # by SenderRecoveryStage.unwind, which runs before us)
        doomed = list(provider.tx.cursor(Tables.Transactions.name).walk(be64(next_tx)))
        for k, raw in doomed:
            tx = T.decode_tx(raw)
            provider.tx.delete(Tables.TransactionHashNumbers.name, tx.hash)
            provider.tx.delete(Tables.Transactions.name, k)
        for k, _ in list(provider.tx.cursor(Tables.TransactionBlocks.name)
                         .walk(be64(next_tx))):
            provider.tx.delete(Tables.TransactionBlocks.name, k)
        for n in range(inp.checkpoint, inp.unwind_to, -1):
            key = be64(n)
            for table in (Tables.BlockBodyIndices.name, Tables.BlockOmmers.name,
                          Tables.BlockWithdrawals.name):
                provider.tx.delete(table, key)


def online_stages(client, committer=None, consensus=None,
                  extra_peers: tuple = (), device="cuda") -> list[Stage]:
    """The full networked stage set: download stages + the offline tail
    (reference `DefaultStages` = online + offline, sets.rs:85).
    ``extra_peers`` join the windowed concurrent body download. Every stage
    that builds a committer or a consensus builds it on ``device``."""
    from . import default_stages

    return [
        HeadersStage(client, consensus=consensus, device=device),
        BodiesStage(client, consensus=consensus, extra_peers=extra_peers,
                    device=device),
        *default_stages(committer=committer, consensus=consensus, device=device),
    ]
