"""Sync downloaders: headers + bodies from a peer into the pipeline.

Reference analogue: crates/net/downloaders — `ReverseHeadersDownloader`
(tip→local batched header download) and `BodiesDownloader`, feeding the
staged pipeline. ``sync_from_peer`` is the full networked-sync flow:
fetch headers to the peer's tip, validate linkage, fetch bodies, insert
via import, run the pipeline.

A copy of the JAX package's ``net/downloader.py``. Every consensus it builds
roots bodies on ``TrieCommitter(device=device)``, kernel 1 on the card
unless ``device="cpu"``. A kernel fault in a body window is not a peer's
failure: the worker stops without penalizing its peer, the other workers
stop claiming, and ``BodiesDownloader.download`` raises the fault once they
are joined. A downloader's ``requeued`` counts the windows a failed peer gave
back, and ``BodiesDownloader.requeued_total`` those of every downloader.
"""

from __future__ import annotations

from ..consensus import EthBeaconConsensus
from ..ops._build import is_kernel_fault
from ..primitives.types import Block
from ..storage.genesis import import_chain
from .p2p import PeerConnection, PeerError

HEADER_BATCH = 192
BODY_BATCH = 128


def download_headers(peer: PeerConnection, from_block: int, to_block: int) -> list:
    """Forward header download [from_block, to_block] in batches."""
    headers = []
    n = from_block
    while n <= to_block:
        limit = min(HEADER_BATCH, to_block - n + 1)
        batch = peer.get_headers(n, limit)[:limit]  # cap over-long responses
        if not batch:
            raise PeerError(f"peer returned no headers at {n}")
        for h in batch:
            if h.number != n:
                raise PeerError(f"non-contiguous header {h.number} != {n}")
            if headers and h.parent_hash != headers[-1].hash:
                raise PeerError(f"broken parent link at {h.number}")
            headers.append(h)
            n += 1
    return headers


def download_bodies(peer: PeerConnection, headers: list) -> list[Block]:
    """Fetch bodies for ``headers``; returns sealed blocks, validated."""
    blocks = []
    for i in range(0, len(headers), BODY_BATCH):
        chunk = headers[i : i + BODY_BATCH]
        bodies = peer.get_bodies([h.hash for h in chunk])
        if len(bodies) != len(chunk):
            raise PeerError("missing bodies in response")
        for header, body in zip(chunk, bodies):
            blocks.append(Block(header, body.transactions, body.ommers, body.withdrawals))
    return blocks


def sync_from_peer(factory, peer: PeerConnection, pipeline=None,
                   consensus: EthBeaconConsensus | None = None,
                   committer=None, extra_peers: tuple = (),
                   device="cuda") -> int:
    """Sync to the peer's head; returns the new local tip.

    With no ``pipeline`` given, the ONLINE stage set drives the whole
    sync — the pipeline's Headers/Bodies stages pull from the peer with
    checkpointed, per-chunk commits (reference OnlineStages). A supplied
    pipeline keeps the legacy flow: bulk download → import → run.
    """
    consensus = consensus or EthBeaconConsensus(committer, device=device)
    with factory.provider() as p:
        local_tip = p.last_block_number()
        finish_cp = p.stage_checkpoint("Finish")
    # peer head number: ask for its head header by hash
    head = peer.get_headers(peer.status.head, 1)
    if not head:
        return local_tip
    target = head[0].number
    if pipeline is None:
        # online path: progress is measured by the PIPELINE (a crash after
        # a Headers chunk leaves last_block_number ahead of the real sync)
        if target <= finish_cp:
            return local_tip
        from ..stages import Pipeline, online_stages

        with factory.provider_rw() as p:
            # a legacy-imported DB holds headers/bodies without download
            # checkpoints: baseline them to what is ACTUALLY present (not
            # the Finish checkpoint — a crash between import and pipeline
            # completion leaves bodies above it, and re-inserting a body
            # renumbers its transactions and corrupts the tx tables)
            if p.stage_checkpoint("Headers") < local_tip:
                p.save_stage_checkpoint("Headers", local_tip)
            b_cp = p.stage_checkpoint("Bodies")
            n = b_cp + 1
            while n <= local_tip and p.block_body_indices(n) is not None:
                n += 1
            if n - 1 > b_cp:
                p.save_stage_checkpoint("Bodies", n - 1)
        Pipeline(factory, online_stages(peer, committer=committer,
                                        consensus=consensus,
                                        extra_peers=extra_peers,
                                        device=device)).run(target)
        return target
    if target <= local_tip:
        return local_tip
    headers = download_headers(peer, local_tip + 1, target)
    blocks = download_bodies(peer, headers)
    tip = import_chain(factory, blocks, consensus)
    pipeline.run(tip)
    return tip


def download_headers_reverse(peer: PeerConnection, tip_hash: bytes,
                             stop_number: int | None = None,
                             batch: int = HEADER_BATCH,
                             count: int | None = None) -> list:
    """Reverse tip→local header download (reference
    `ReverseHeadersDownloader`, crates/net/downloaders/src/headers/
    reverse_headers.rs): start from a TRUSTED tip HASH (forkchoice head —
    its number is unknown up front) and walk parent links downward in
    batches. Every header authenticates by hashing into the previously
    verified child, so a lying peer cannot inject a header anywhere in
    the range. Returns headers ASCENDING. The walk is bounded by EITHER
    ``stop_number`` (first returned number = stop_number + 1) OR ``count``
    headers (the FullBlockClient mode) — exactly one must be given.
    """
    assert (stop_number is None) != (count is None), \
        "give exactly one of stop_number/count"
    out = []  # filled tip-first (descending)
    want = tip_hash
    while True:
        limit = batch if count is None else min(batch, count - len(out))
        hdrs = peer.get_headers(want, limit, reverse=True)
        if not hdrs:
            raise PeerError(f"peer returned no headers for {want.hex()[:16]}")
        for h in hdrs[:limit]:
            if h.hash != want:
                raise PeerError(
                    f"header {h.number} does not hash-link to its child")
            if stop_number is not None and h.number <= stop_number:
                raise PeerError(
                    f"peer walked past the local chain at {h.number}")
            out.append(h)
            want = h.parent_hash
            if (stop_number is not None and h.number == stop_number + 1) \
                    or (count is not None and len(out) == count):
                return list(reversed(out))


class BodiesDownloader:
    """Concurrent body download over MULTIPLE peers with bounded in-flight
    windows (reference crates/net/downloaders/src/bodies/): the header
    range splits into fixed windows, workers (one per peer) claim windows
    from a shared queue, responses arrive out of order and re-assemble by
    index. Each response is validated against its headers (body roots);
    a bad or failing peer is penalized through the reputation sink, its
    worker retires, and its window re-queues to a healthy peer.
    """

    requeued_total = 0  # windows re-queued by every downloader of the process

    def __init__(self, peers: list, window: int = BODY_BATCH,
                 reporter=None, consensus=None, device="cuda"):
        """``peers``: PeerConnection-likes with ``get_bodies``.
        ``reporter(peer, kind)``: reputation sink (kind is a
        REPUTATION_CHANGE key, e.g. "bad_message" / "timeout")."""
        self.peers = list(peers)
        self.window = window
        self.reporter = reporter or (lambda peer, kind: None)
        from ..consensus import EthBeaconConsensus

        self.consensus = consensus or EthBeaconConsensus(device=device)
        self.stats: dict[int, int] = {}  # peer index -> windows served
        self.requeued = 0  # windows a failed peer gave back

    def download(self, headers: list) -> list[Block]:
        if not headers:
            return []
        import threading

        windows = [headers[i:i + self.window]
                   for i in range(0, len(headers), self.window)]
        results: list[list[Block] | None] = [None] * len(windows)
        # window states: "todo" | "inflight" | "done". A failed window
        # returns to "todo"; healthy workers WAIT while anything is
        # inflight elsewhere instead of exiting on an empty claim — a
        # transient failure re-queues to a live peer, never to nobody.
        state = {i: "todo" for i in range(len(windows))}
        cond = threading.Condition()
        faults: list[BaseException] = []  # kernel faults: every worker stops

        def fetch_window(peer, idx: int) -> list[Block]:
            chunk = windows[idx]
            bodies = peer.get_bodies([h.hash for h in chunk])
            if len(bodies) != len(chunk):
                raise PeerError("missing bodies in response")
            out = []
            for header, body in zip(chunk, bodies):
                blk = Block(header, body.transactions, body.ommers,
                            body.withdrawals)
                # roots bind the body to ITS header: a peer cannot serve
                # the wrong (or tampered) body undetected
                from ..consensus import ConsensusError

                try:
                    self.consensus.validate_block_pre_execution(blk)
                except ConsensusError as e:
                    raise PeerError(f"body {header.number} invalid: {e}")
                out.append(blk)
            return out

        def claim() -> int | None:
            """Next todo window; None when every window is done. Blocks
            while windows are only in flight at OTHER workers (they may
            fail and re-queue here)."""
            with cond:
                while True:
                    if faults:
                        return None
                    todo_idx = next((i for i, s in state.items()
                                     if s == "todo"), None)
                    if todo_idx is not None:
                        state[todo_idx] = "inflight"
                        return todo_idx
                    if all(s == "done" for s in state.values()):
                        return None
                    cond.wait(timeout=0.2)

        def worker(pi: int, peer) -> None:
            while True:
                idx = claim()
                if idx is None:
                    return
                try:
                    got = fetch_window(peer, idx)
                except Exception as e:  # noqa: BLE001 — ANY failure must
                    # release the inflight window or waiters starve
                    if is_kernel_fault(e):  # the card's, not the peer's
                        with cond:
                            faults.append(e)
                            cond.notify_all()
                        return
                    # penalize, re-queue the window, retire this peer
                    self.reporter(peer, "bad_message")
                    with cond:
                        state[idx] = "todo"
                        self.requeued += 1
                        BodiesDownloader.requeued_total += 1
                        cond.notify_all()
                    return
                with cond:
                    results[idx] = got
                    state[idx] = "done"
                    self.stats[pi] = self.stats.get(pi, 0) + 1
                    cond.notify_all()

        threads = [threading.Thread(target=worker, args=(i, p), daemon=True)
                   for i, p in enumerate(self.peers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if faults:
            raise faults[0]
        missing = [i for i, r in enumerate(results) if r is None]
        if missing:
            raise PeerError(
                f"{len(missing)} body windows unserved (all peers failed)")
        return [blk for window_result in results for blk in window_result]


class FullBlockClient:
    """Composable full-block fetch over any header+body client.

    Reference analogue: `FullBlockClient` (crates/net/p2p/src/full_block.rs)
    — wraps a client exposing ``get_headers``/``get_bodies`` and returns
    SEALED blocks: the header is guaranteed to match the requested hash,
    bodies are validated against their headers (transaction/ommers/
    withdrawals roots) with bounded retries for mismatched responses.
    The engine uses this to fill parent gaps during live sync.
    """

    MAX_RETRIES = 3

    def __init__(self, client, consensus=None, device="cuda"):
        from ..consensus import EthBeaconConsensus

        self.client = client
        self.device = device
        self.consensus = consensus or EthBeaconConsensus(device=device)

    def get_full_block(self, block_hash: bytes) -> Block:
        """One sealed block by hash; raises PeerError after retries."""
        return self.get_full_block_range(block_hash, 1)[0]

    def get_full_block_range(self, start_hash: bytes,
                             count: int) -> list[Block]:
        """``count`` sealed blocks ending at ``start_hash``, DESCENDING by
        number (reference semantics: walk parent links downward)."""
        headers = list(reversed(download_headers_reverse(
            self.client, start_hash, count=count)))
        blocks: list[Block | None] = [None] * len(headers)
        remaining = list(range(len(headers)))
        from ..consensus import ConsensusError

        from ..trie.state_root import ordered_trie_root

        for _attempt in range(self.MAX_RETRIES):
            want = [headers[i] for i in remaining]
            bodies = self.client.get_bodies([h.hash for h in want])
            # eth GetBlockBodies OMITS unknown hashes (no gaps): align by
            # each body's TRANSACTIONS ROOT instead of position — a
            # mid-list omission skips its header, and a corrupt body that
            # matches no header is discarded instead of starving the scan
            k = 0
            still = []
            pending = list(remaining)
            while pending:
                if k >= len(bodies):
                    still.extend(pending)
                    break
                body = bodies[k]
                tx_root = ordered_trie_root(
                    [tx.encode() for tx in body.transactions], device=self.device)
                j = next((idx for idx, i in enumerate(pending)
                          if headers[i].transactions_root == tx_root), None)
                if j is None:
                    k += 1  # unmatchable (corrupt/foreign) body: discard
                    continue
                # headers skipped over were OMITTED by the peer
                still.extend(pending[:j])
                i = pending[j]
                pending = pending[j + 1:]
                blk = Block(headers[i], body.transactions, body.ommers,
                            body.withdrawals)
                try:
                    self.consensus.validate_block_pre_execution(blk)
                    blocks[i] = blk
                except ConsensusError:
                    still.append(i)  # tx root matched but ommers/blob
                    # gas/withdrawals did not: refetch this one
                k += 1
            remaining = sorted(still)
            if not remaining:
                return blocks
        raise PeerError(
            f"{len(remaining)} bodies failed validation after retries")
