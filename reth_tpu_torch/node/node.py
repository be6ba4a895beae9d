"""The launched node: components + RPC servers + dev miner.

Reference analogue: `EngineNodeLauncher::launch_node`
(crates/node/builder/src/launch/engine.rs:70-419): provider factory →
genesis → components (pool, payload, consensus, executor) → add-ons
(RPC modules, engine API) → launched handle.

A copy of the JAX package's ``node/node.py`` over the port's modules, with
one keyword more and three options that wait for later slices:

- ``Node(config, committer=None, device="cuda")``: without a committer the
  node builds ``TrieCommitter(device=device)``, where the reference builds
  ``TrieCommitter()`` on host numpy; the unwinds of its startup checks, its
  recovery, its engine tree and its network take ``device`` too. So a node
  runs its state commitment on the card unless the caller asks for the CPU
  (the tests pass ``device="cpu"``, the kernels' plain versions);
- ``config.health`` (the health slice), and ``config.fleet`` and
  ``config.ha_peer_feeds`` (the fleet slice; ``ROADMAP.md`` A) raise
  ``NotImplementedError`` before anything is opened.

On the card, startup builds the native secp256k1 batch, the warm-up
manager when ``config.warmup`` asks for one, and runs ``recover_on_startup``
(its root check on the node's committer) before the engine tree, the pool,
the payload service, the dev miner and the servers are wired.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from ..consensus import EthBeaconConsensus
from ..engine import EngineTree
from ..engine.local import LocalMiner
from ..evm import EvmConfig
from ..payload import PayloadBuilderService
from ..pool import TransactionPool
from ..primitives.types import Account, Header
from ..rpc import EngineApi, EthApi, RpcServer
from ..rpc.net import NetApi, TxpoolApi, Web3Api
from ..storage import ProviderFactory
from ..storage.genesis import init_genesis
from ..trie.committer import TrieCommitter


@dataclass
class NodeConfig:
    chain_id: int = 1
    datadir: str | Path | None = None
    dev: bool = False                 # dev mode: local miner enabled
    http_port: int = 0                # 0 = ephemeral
    authrpc_port: int = 0
    persistence_threshold: int = 2
    genesis_header: Header | None = None
    genesis_alloc: dict[bytes, Account] = field(default_factory=dict)
    genesis_storage: dict | None = None
    genesis_codes: dict | None = None
    # data lifecycle: move finalized history to static files once the chain
    # is this many blocks past it (None disables), and prune per modes
    static_file_distance: int | None = None
    prune_modes: object | None = None  # PruneModes | None
    jwt_secret: bytes | None = None   # engine-port JWT (auto from datadir)
    chain_spec: object | None = None  # ChainSpec: hardfork schedule + fork ids
    # memdb | native (C++ WAL) | paged (COW B+tree, the default — the MDBX
    # analogue, reference StorageSettings). An ephemeral node (datadir None)
    # silently runs memdb: the persistent engines need a directory.
    db_backend: str = "paged"
    # storage-v2 split layout (history/lookup tables on a dedicated second
    # store — reference StorageSettings.storage_v2). None = keep the
    # datadir's persisted layout (default v1 for fresh datadirs)
    storage_v2: bool | None = None
    ws_port: int | None = None        # WebSocket RPC (None disables; 0 = any)
    ipc_path: str | None = None       # Unix-socket RPC (None disables)
    enable_admin: bool = False        # admin_ is node control: explicit opt-in
    # devp2p: RLPx listener + discv4 discovery (None disables networking)
    p2p_port: int | None = None       # 0 = ephemeral
    p2p_host: str = "127.0.0.1"       # bind + advertised address
    nat: str = "any"                  # any | none | extip:<ip> | upnp | natpmp
    discovery: bool = True
    node_key: int | None = None       # secp256k1 priv; random when unset
    bootnodes: tuple[str, ...] = ()   # enode:// urls
    bootnodes_v5: tuple[str, ...] = ()  # enr:... text records (discv5/DNS)
    # --sparse-workers / [node] sparse_workers: parallel sparse-commit
    # pool width (None = env RETH_TPU_SPARSE_WORKERS or cpu-derived)
    sparse_workers: int | None = None
    # --parallel-exec / [node] parallel_exec: optimistic parallel EVM
    # execution on the no-BAL newPayload path (engine/optimistic.py);
    # speculation width from RETH_TPU_EXEC_WORKERS
    parallel_exec: bool = False
    # --pipeline-depth / [node] pipeline_depth: cross-block import
    # pipeline (engine/block_pipeline.py); 2 = speculate block N+1
    # while N commits, None = env RETH_TPU_PIPELINE_DEPTH (default 1)
    pipeline_depth: int | None = None
    # --continuous-build / [node] continuous_build: standing block
    # producer (payload/producer.py) — keeps a hot candidate payload
    # incrementally refreshed on pool events and head changes, so
    # getPayload / dev mining seal instead of building from scratch;
    # rides the commit window when the import pipeline is on
    continuous_build: bool = False
    # --hot-state / [node] hot_state: hot-state plane — cross-block
    # trie-node cache (trie/hot_cache.py) feeding sparse reveals
    # without proof fetches, plus a device-resident digest arena
    # (ops/fused_commit.py DigestArena) so sparse finishes upload only
    # dirty rows; False defers to RETH_TPU_HOT_STATE
    hot_state: bool = False
    # --rpc-gateway / [rpc] gateway: route every transport's dispatch
    # through the serving gateway (rpc/gateway.py): admission control
    # with priority classes, in-flight coalescing, and a head-invalidated
    # response cache
    rpc_gateway: bool = False
    # --trace-blocks / [node] trace_blocks: block-lifecycle tracing —
    # per-block span timelines + wall-budget line, Chrome-trace export,
    # and flight-recorder dumps under the datadir (tracing.py)
    trace_blocks: bool = False
    trace_file: str | Path | None = None  # Chrome-trace path override
    # --warmup / [node] warmup: device warm-up manager (ops/warmup.py) —
    # AOT-compile the kernel shape menu behind the supervisor's health
    # probe while serving degraded on the CPU twin ("background"), or
    # finish warm-up before serving ("block"). "off" disables.
    warmup: str = "off"
    # --compile-cache-dir / [node] compile_cache_dir: persistent XLA
    # compilation cache (kernel-source-versioned, probe-verified,
    # quarantine-on-corruption). None = <datadir>/compile-cache when
    # warm-up is on.
    compile_cache_dir: str | Path | None = None
    # --health / [node] health: the node health & SLO engine (health.py)
    # — metric time-series retention, burn-rate SLO evaluation over the
    # default rule table, /health + debug_healthCheck/debug_sloStatus/
    # debug_metricsHistory surfaces, and flight dumps on breach
    health: bool = False
    # [node] slo_interval: seconds between sampler/evaluator passes
    # (<= 0 disables the thread — tests drive HealthEngine.tick())
    slo_interval: float = 1.0
    # [node] slo_window: ring-buffer samples retained per metric series
    slo_window: int = 300
    # --wal / [node] wal: write-ahead log beside the memdb image
    # (storage/wal.py) — every commit fsync-appends its table delta
    # before the in-memory publish, so a kill -9 loses at most
    # persistence_threshold blocks instead of the whole session.
    # Memdb-backed stores only: the native/paged engines carry their
    # own WAL / shadow paging.
    wal: bool = True
    # [node] wal_checkpoint_blocks: persisted blocks between WAL
    # checkpoints (image + fsync'd manifest swap + log truncation)
    wal_checkpoint_blocks: int = 8
    # --no-recovery-verify: skip the startup recovery's state-root
    # recomputation through the committer (storage/recovery.py) —
    # large datadirs can trade the proof for boot time
    recovery_verify_root: bool = True
    # --invalid-cache-size / [node] invalid_cache_size: bound of the
    # engine tree's invalid-header LRU (engine/block_buffer.py) — an
    # invalid-payload flood plateaus here instead of leaking memory.
    # None = RETH_TPU_INVALID_CACHE env or 512.
    invalid_cache_size: int | None = None
    # --fleet / [node] fleet: read-replica fleet mode (fleet/) — start
    # the witness feed server (per-block ExecutionWitness fanout to
    # subscribed stateless replicas), put the RPC gateway in fleet mode
    # (consistent-hash ring routing of pure reads with per-replica
    # draining and replica→ring-neighbor→local failover), and register
    # the fleet_* admin methods. Implies rpc_gateway.
    fleet: bool = False
    # --feed-port: witness feed TCP port (0 = ephemeral)
    feed_port: int = 0
    # --fleet-max-lag: heads a replica may trail the node's head before
    # the ring sheds it (fleet/ring.py prober)
    fleet_max_lag: int = 4
    # --ha-peer-feed: HOST:PORT witness feeds of HA peers (the standby's
    # takeover feed). Probed at startup for epoch fencing: a live peer
    # advertising a HIGHER leader epoch means this node was superseded
    # while it was down — the engine tree fences (refuses stale writes)
    # instead of splitting the brain. The leader also ships its WAL
    # stream to any standby that subscribes on the feed (fleet/standby.py)
    ha_peer_feeds: tuple[str, ...] = ()


class Node:
    """A launched node (in-process; networking arrives as its own layer)."""

    def __init__(self, config: NodeConfig, committer: TrieCommitter | None = None,
                 device: str = "cuda"):
        from ..tasks import TaskExecutor

        # the options whose modules come with later slices (ROADMAP.md A)
        if config.health:
            raise NotImplementedError(
                "--health: the health & SLO engine is not ported yet "
                "(ROADMAP.md A item 1, health)")
        if config.fleet:
            raise NotImplementedError(
                "--fleet: the read-replica fleet is not ported yet "
                "(ROADMAP.md A item 2, the fleet)")
        if config.ha_peer_feeds:
            raise NotImplementedError(
                "--ha-peer-feed: HA epoch fencing is not ported yet "
                "(ROADMAP.md A item 2, the fleet)")
        self.config = config
        self.device = device
        # --trace-blocks: enable block-lifecycle tracing before any
        # component runs; traces + flight dumps live under the datadir
        # (or the cwd for ephemeral nodes). An explicit
        # RETH_TPU_FLIGHT_DIR wins for the dumps: a FLEET shares one
        # flight directory so correlated dumps from every process land
        # together — the datadir default must not override it.
        self.trace_path = None
        if config.trace_blocks:
            import os as _os

            from .. import tracing

            base = Path(config.datadir) if config.datadir else Path(".")
            trace_dir = base / "traces"
            trace_dir.mkdir(parents=True, exist_ok=True)
            self.trace_path = (Path(config.trace_file) if config.trace_file
                               else trace_dir / "blocks.trace.json")
            tracing.init_block_tracing(
                chrome_path=self.trace_path,
                flight_dir=(_os.environ.get("RETH_TPU_FLIGHT_DIR")
                            or trace_dir))
        self.committer = committer or TrieCommitter(device=device)
        # device hasher supervisor (--hasher auto): present when the
        # committer routes through ops/supervisor.py — surfaced on the
        # events dashboard and /metrics
        self.hasher_supervisor = getattr(self.committer, "supervisor", None)
        # shared hash service (--hash-service): present when every keccak
        # client multiplexes over ops/hash_service.py — surfaced on the
        # events dashboard and hash_service_* /metrics
        self.hash_service = getattr(self.committer, "hash_service", None)
        # device mesh (--mesh): the parallel/mesh.py descriptor the turbo
        # committers and the (meshed) hash service shard over — surfaced
        # on the events dashboard and mesh_* /metrics
        self.hash_mesh = (getattr(self.committer, "hash_mesh", None)
                          or getattr(self.hash_service, "mesh", None))
        # device warm-up manager (--warmup): per-shape compile lifecycle +
        # degraded-mode serving (ops/warmup.py). Usually built by the CLI
        # alongside the committer; a directly-constructed Node with
        # config.warmup set builds and starts one here.
        self.warmup = getattr(self.committer, "warmup", None)
        if self.warmup is None and config.warmup and config.warmup != "off":
            from ..ops.warmup import build_warmup

            cache_dir = config.compile_cache_dir
            if not cache_dir and config.datadir:
                cache_dir = Path(config.datadir) / "compile-cache"
            self.warmup = build_warmup(
                supervisor=self.hasher_supervisor, cache_dir=cache_dir,
                device=device)
            self.committer.attach_warmup(self.warmup)
            if config.warmup == "block":
                self.warmup.run()
            else:
                self.warmup.start()
        # warm the native secp build now: a lazy first-use g++ compile
        # inside newPayload would stall a consensus response for seconds
        from ..primitives.secp256k1 import _native_lib

        _native_lib()
        # task runtime (reference crates/tasks): components register their
        # loops here; a critical failure begins shutdown
        def _critical_failed(name, e, tb):
            import sys

            print(f"critical task {name!r} failed: {e}\n{tb}", file=sys.stderr)
            self.tasks.shutdown.signal()

        self.tasks = TaskExecutor(on_critical_failure=_critical_failed)
        # storage-settings switch (reference: the database args picking the
        # backing store): "memdb" = in-process store with snapshot file,
        # "native" = the C++ WAL engine (native/kvstore.cpp), "paged" = the
        # mmap copy-on-write B+tree engine (native/pagedkv.cpp, the MDBX
        # architecture analogue — reference StorageSettings backend choice)
        from ..storage import open_database

        self.factory = ProviderFactory(
            open_database(config.db_backend, config.datadir,
                          storage_v2=config.storage_v2))
        # crash-safe persistence (--wal, storage/wal.py): attach the
        # write-ahead log BEFORE anything reads the store — attaching
        # replays surviving commit records (discarding any torn tail)
        # into the freshly-opened image, so genesis init, chain-spec
        # rebuild, and the engine tree all see the recovered state
        self.durability = None
        if config.datadir and config.wal:
            from ..storage.wal import attach_wal

            static_dir = (Path(config.datadir) / "static_files"
                          if config.static_file_distance is not None else None)
            self.durability = attach_wal(
                self.factory.db, Path(config.datadir) / "wal",
                checkpoint_blocks=config.wal_checkpoint_blocks,
                static_dir=static_dir)
        # storage-v2 startup invariants (reference rocksdb/invariants.rs):
        # reconcile the aux store against the stage checkpoints — prune
        # what's ahead, unwind what's behind
        from ..storage.settings import SplitDb, check_consistency

        if isinstance(self.factory.db, SplitDb):
            target = check_consistency(self.factory)
            if target is not None:
                from ..stages import Pipeline, default_stages

                Pipeline(self.factory,
                         default_stages(committer=self.committer,
                                        device=device)).unwind(target)
        if config.genesis_header is not None:
            init_genesis(
                self.factory, config.genesis_header, config.genesis_alloc,
                config.genesis_storage, config.genesis_codes, self.committer,
            )
        # startup recovery (storage/recovery.py): reconcile the recovered
        # store against stage checkpoints and static-file jar digests,
        # heal interrupted unwinds, and verify the recovered head's state
        # root by recomputation through the committer BEFORE serving —
        # the report lands on the events line, recovery_* metrics, and
        # a health engine's durability component
        self.recovery = None
        if config.datadir:
            import os as _os

            from ..storage.recovery import recover_on_startup

            env = _os.environ.get("RETH_TPU_RECOVERY_VERIFY")
            verify = (config.recovery_verify_root if env is None
                      else env not in ("", "0"))
            self.recovery = recover_on_startup(
                self.factory, durability=self.durability,
                committer=self.committer,
                static_dir=Path(config.datadir) / "static_files",
                verify_root=verify, device=device)
        # chain spec: persist on first launch, rebuild on restart (a node
        # relaunched from a datadir without --genesis must keep advertising
        # the right EIP-2124 fork id)
        from ..storage.tables import Tables

        _SPEC_KEY = b"chain_spec"
        if config.chain_spec is not None:
            with self.factory.provider_rw() as p:
                p.tx.put(Tables.Metadata.name, _SPEC_KEY,
                         config.chain_spec.to_json().encode())
        else:
            with self.factory.provider() as p:
                raw = p.tx.get(Tables.Metadata.name, _SPEC_KEY)
            if raw is not None:
                from ..chainspec import ChainSpec

                config.chain_spec = ChainSpec.from_json(raw.decode())
        exec_spec = (config.chain_spec.execution_spec
                     if config.chain_spec is not None else None)
        self.consensus = EthBeaconConsensus(self.committer,
                                            chainspec=exec_spec)
        self.tree = EngineTree(
            self.factory, self.committer, self.consensus,
            EvmConfig(chain_id=config.chain_id, chainspec=exec_spec),
            persistence_threshold=config.persistence_threshold,
            sparse_workers=config.sparse_workers,
            parallel_exec=config.parallel_exec,
            pipeline_depth=config.pipeline_depth,
            # True forces on; False stays None so RETH_TPU_HOT_STATE decides
            hot_state=config.hot_state or None,
            invalid_cache_size=config.invalid_cache_size,
            device=device,
        )
        # the engine's persistence advance is the durability boundary:
        # with a WAL it drives checkpoint cadence, without one it flushes
        self.tree.durability = self.durability
        # HA epoch fencing (fleet/election.py) comes with the fleet slice:
        # ``ha_peer_feeds`` raised above
        self.fence_report = None
        from ..pool.pool import PoolConfig

        self.pool = TransactionPool(lambda: self.tree.overlay_provider(),
                                    PoolConfig(chain_id=config.chain_id))
        # batched insertion + validation offload: RPC threads enqueue, one
        # worker batch-recovers senders natively and inserts per batch
        # (reference BatchTxProcessor + validation task)
        from ..pool import TxBatcher

        self.tx_batcher = TxBatcher(self.pool)
        with self.factory.provider() as p:
            tip = p.header_by_number(p.last_block_number())
        if tip is not None and tip.base_fee_per_gas is not None:
            self.pool.base_fee = tip.base_fee_per_gas
        self.payload_service = PayloadBuilderService(self.tree, self.pool)
        self.miner = LocalMiner(self.tree, self.pool) if config.dev else None

        # pool maintenance rides canonical-state notifications, so the pool
        # stays correct in CL-driven mode too (reference src/maintain.rs)
        def _maintain_pool(chain):
            if chain:
                from ..consensus.validation import calc_next_base_fee
                from ..evm.executor import blob_base_fee, next_excess_blob_gas

                tip = chain[-1].block.header
                next_blob_fee = None
                if tip.excess_blob_gas is not None:
                    params = self.tree.config.blob_params_for(
                        tip.number + 1, tip.timestamp)
                    next_blob_fee = blob_base_fee(next_excess_blob_gas(
                        tip.excess_blob_gas, tip.blob_gas_used or 0,
                        params.target_gas), params.update_fraction)
                self.pool.on_canonical_state_change(
                    calc_next_base_fee(tip), blob_base_fee=next_blob_fee
                )

        self.tree.canon_listeners.append(_maintain_pool)

        # ExEx manager: durable canonical-state notifications + the
        # FinishedHeight feedback that gates pruning (reference crates/exex)
        from ..exex import CanonStateNotification, ExExManager

        self.exex = ExExManager(config.datadir if config.datadir else None)

        def _notify_exex(chain):
            if chain and self.exex.handles:
                self.exex.notify(CanonStateNotification(
                    tip_number=chain[-1].number, tip_hash=chain[-1].hash,
                    blocks=[(b.number, b.hash) for b in chain]))

        self.tree.canon_listeners.append(_notify_exex)

        # data lifecycle: static-file producer + pruner run after
        # persistence advances (reference: launched after pipeline commits)
        self.static_producer = None
        self.pruner = None
        if config.static_file_distance is not None and config.datadir:
            from ..storage.static_files import StaticFileProducer

            self.static_producer = StaticFileProducer(
                self.factory, Path(config.datadir) / "static_files"
            )
            self.factory.static_files = self.static_producer.static
        if config.prune_modes is not None:
            from ..prune import Pruner

            self.pruner = Pruner(self.factory, config.prune_modes)

        def _lifecycle(chain):
            tip = self.tree.persisted_number
            if self.static_producer is not None:
                target = tip - config.static_file_distance
                if target >= 0:
                    self.static_producer.run(target)
            if self.pruner is not None:
                # FinishedHeight gate: never prune past what every ExEx
                # has finished (reference exex/src/lib.rs:17-24)
                self.pruner.run(min(tip, self.exex.finished_height()))

        if self.static_producer is not None or self.pruner is not None:
            self.tree.canon_listeners.append(_lifecycle)

        # RPC servers: public + auth (engine) — reference serves the engine
        # API on a separate JWT-authed port (rpc-builder auth server)
        import threading

        shared_lock = threading.RLock()
        # payload improvement loops must serialise with engine/RPC handlers
        self.payload_service.lock = shared_lock
        # --continuous-build: the standing producer shares the engine
        # lock, feeds payload jobs AND the dev miner its hot candidate
        self.producer = None
        if config.continuous_build:
            from ..payload import BlockProducer

            self.producer = BlockProducer(self.tree, self.pool,
                                          lock=shared_lock)
            self.payload_service.producer = self.producer
            if self.miner is not None:
                self.miner.producer = self.producer
        # serving gateway (--rpc-gateway): ONE gateway shared by the
        # public and auth servers (one admission domain — engine traffic
        # outranks public debug traffic) and by the WS/IPC transports
        # that wrap the public registry. Response-cache keys embed the
        # canonical head; the canon listener clears dead-head entries.
        # --fleet (witness feed server + fleet router) comes with the fleet
        # slice: ``config.fleet`` raised above
        self.feed_server = None
        self.fleet_router = None
        self.fleet_federation = None
        self._fleet_fault_observer = None
        self.gateway = None
        if config.rpc_gateway or config.fleet:
            from ..rpc.gateway import RpcGateway

            self.gateway = RpcGateway(
                head_supplier=lambda: self.tree.head_hash,
                fleet=self.fleet_router)
            self.tree.canon_listeners.append(self.gateway.on_head_change)
        self.eth_api = EthApi(self.tree, self.pool, config.chain_id,
                              tx_batcher=self.tx_batcher)
        self.rpc = RpcServer(port=config.http_port, lock=shared_lock,
                             gateway=self.gateway)
        self.rpc.register(self.eth_api)
        self.rpc.register(NetApi(config.chain_id))
        self.rpc.register(Web3Api())
        self.rpc.register(TxpoolApi(self.pool))
        from ..rpc.debug import DebugApi
        from ..rpc.flashbots import BundleApi, ValidationApi
        from ..rpc.miner import MinerApi
        from ..rpc.otterscan import OtterscanApi

        debug_api = DebugApi(self.eth_api)
        self.rpc.register(debug_api)
        self.rpc.register(OtterscanApi(self.eth_api, debug_api))
        self.rpc.register(BundleApi(self.eth_api))
        self.rpc.register(ValidationApi(self.eth_api))
        self.rpc.register(MinerApi(self.payload_service, self.pool))
        if self.producer is not None:
            from ..rpc.net import ProducerApi

            self.rpc.register(ProducerApi(self.producer))
        self.engine_api = EngineApi(self.tree, self.payload_service, pool=self.pool)
        # JWT on the engine port (reference auth_layer.rs): explicit secret,
        # else auto-generated jwt.hex under the datadir; dev mode stays open
        # (the reference's --dev also relaxes local tooling friction)
        jwt_secret = config.jwt_secret
        if jwt_secret is None and config.datadir and not config.dev:
            from ..rpc.jwt import load_or_create_secret

            jwt_secret = load_or_create_secret(Path(config.datadir) / "jwt.hex")
        self.authrpc = RpcServer(port=config.authrpc_port, lock=shared_lock,
                                 jwt_secret=jwt_secret, gateway=self.gateway)
        self.authrpc.register(self.engine_api)
        self.authrpc.register(self.eth_api)  # CLs also query eth_ on authrpc

        # WebSocket + IPC transports over the same public method registry
        self.ws = None
        if config.ws_port is not None:
            from ..rpc.ws import WsRpcServer

            self.ws = WsRpcServer(self.rpc, port=config.ws_port)
        self.ipc = None
        if config.ipc_path:
            from ..rpc.ipc import IpcRpcServer

            self.ipc = IpcRpcServer(self.rpc, config.ipc_path)

        # devp2p: encrypted RLPx listener + discv4 (reference: network
        # component wiring in the node builder, launch/engine.rs:145-156)
        self.network = None
        self.discovery = None
        self.discovery_v5 = None
        if config.p2p_port is not None:
            from ..net.p2p import random_node_key
            from ..net.server import NetworkManager
            from ..net.wire import Status

            key = config.node_key or random_node_key()
            with self.factory.provider() as p:
                tip_num = p.last_block_number()
                tip_header = p.header_by_number(tip_num)
                fork_id = (b"\x00" * 4, 0)
                if config.chain_spec is not None:
                    fork_id = config.chain_spec.fork_id(
                        tip_num, tip_header.timestamp if tip_header else 0)
                status = Status(
                    network_id=config.chain_id,
                    head=p.canonical_hash(tip_num),
                    genesis=p.canonical_hash(0),
                    fork_id=fork_id,
                    earliest=0,  # full node: whole history served
                    latest=tip_num,
                )
            self.network = NetworkManager(
                self.factory, status, pool=self.pool, host=config.p2p_host,
                port=config.p2p_port, node_priv=key,
                chain_spec=config.chain_spec,
                head_position=(tip_num, tip_header.timestamp if tip_header else 0),
                provider_fn=lambda: self.tree.overlay_provider(),
                device=device,
            )
            # NAT resolution decides the ADVERTISED address (enode/ENR);
            # binding stays on p2p_host (reference crates/net/nat)
            from ..net.nat import NatResolver

            self.network.advertised_host = NatResolver.parse(
                config.nat).external_ip(config.p2p_host)

            # keep the advertised Status + ForkFilter anchored to the LIVE
            # head: a node that syncs across a fork boundary must start
            # advertising (and enforcing) the post-fork id
            def _track_head(chain, _net=self.network, _spec=config.chain_spec):
                if chain:
                    tip = chain[-1].block.header
                else:
                    # fully persisted head (low persistence threshold /
                    # FCU to a persisted hash): the handshake Status must
                    # still advertise the LIVE tip, or peers dialing in
                    # would sync against a stale head
                    with self.factory.provider() as p:
                        tip = p.header_by_number(p.last_block_number())
                    if tip is None:
                        return
                _net.head_position = (tip.number, tip.timestamp)
                _net.status.head = tip.hash
                _net.status.latest = tip.number
                if _spec is not None:
                    _net.status.fork_id = _spec.fork_id(tip.number, tip.timestamp)
                # eth/69 range gossip replaces TD announcements
                _net.announce_block_range(_net.status.earliest, tip.number,
                                          tip.hash)

            self.tree.canon_listeners.append(_track_head)
        # node health & SLO engine (--health) comes with the health slice:
        # ``config.health`` raised above
        self.health = None

        # human progress dashboard (reference crates/node/events)
        from .events import NodeEventReporter

        self.event_reporter = NodeEventReporter(self)
        self.tree.canon_listeners.append(self.event_reporter.on_canon_change)

        from ..rpc.admin import AdminApi

        self.admin_api = AdminApi(self.network, None, config.chain_id)
        if config.enable_admin:
            # node-control surface: only on explicit opt-in (reference
            # gates admin behind --http.api, never on by default)
            self.rpc.register(self.admin_api)

    def start_network(self) -> int | None:
        """Start the RLPx listener (+ discv4 when enabled); returns the
        TCP port, or None when networking is disabled."""
        if self.network is None:
            return None
        port = self.network.start()
        if self.config.discovery:
            from ..net.discv4 import Discv4
            from ..net.discv5 import Discv5

            self.discovery = Discv4(self.network.node_priv,
                                    host=self.network.host, tcp_port=port)
            self.discovery.start()
            self.admin_api.discovery = self.discovery
            # discv5 runs alongside discv4 (reference: both services feed
            # the same peer set, crates/net/discv5/src/lib.rs)
            self.discovery_v5 = Discv5(self.network.node_priv,
                                       host=self.network.host, tcp_port=port)
            self.discovery_v5.start()
            if self.config.bootnodes:
                self.discovery.bootstrap(list(self.config.bootnodes))
                self.discovery.lookup()
            if self.config.bootnodes_v5:
                self.discovery_v5.bootstrap(list(self.config.bootnodes_v5))

                def _v5_lookup(shutdown, d5=self.discovery_v5, net=self.network):
                    # sessions form asynchronously (1+ UDP round trips) —
                    # a lookup fired synchronously after bootstrap would
                    # find zero session peers and degrade to static peering
                    for _ in range(100):
                        if shutdown.wait(0.1):
                            return
                        if d5.sessions:
                            break
                    known = {p.node_id for p in net.peers}
                    for enr in d5.lookup(rounds=2):
                        # discovered records are dialable RLPx peers
                        if not (enr.ip and enr.tcp_port):
                            continue
                        from ..primitives.secp256k1 import pubkey_to_bytes

                        nid = pubkey_to_bytes(enr.pubkey)
                        if nid in known:
                            continue
                        try:
                            net.connect_to(
                                f"enode://{nid.hex()}@{enr.ip}:{enr.tcp_port}")
                        except Exception:  # noqa: BLE001 — best-effort dial
                            pass

                self.tasks.spawn("discv5-lookup", _v5_lookup)
        elif self.config.bootnodes:
            # static peering: without discovery, dial the bootnodes directly
            for url in self.config.bootnodes:
                try:
                    self.network.connect_to(url)
                except Exception:  # noqa: BLE001 — best-effort static dial
                    pass
        return port

    def start_rpc(self) -> tuple[int, int]:
        """Start the RPC transports; returns (http_port, authrpc_port).
        The WS port (when enabled) is at ``self.ws.port`` after this."""
        self.event_reporter.start()
        if self.producer is not None:
            self.producer.start()
        ports = self.rpc.start(), self.authrpc.start()
        if self.ws is not None:
            self.ws.start()
        if self.ipc is not None:
            self.ipc.start()
        return ports

    def stop(self):
        if self.producer is not None:
            self.producer.stop()
        self.tx_batcher.close()
        self.event_reporter.stop()
        self.tasks.graceful_shutdown()
        self.rpc.stop()
        self.authrpc.stop()
        if self.ws is not None:
            self.ws.stop()
        if self.ipc is not None:
            self.ipc.stop()
        if self.discovery is not None:
            self.discovery.stop()
        if self.discovery_v5 is not None:
            self.discovery_v5.stop()
        if self.network is not None:
            self.network.stop()
        if self.durability is not None:
            # graceful stop = one final checkpoint: image + manifest
            # swapped, log truncated — the next boot replays nothing
            self.durability.checkpoint(
                head=(self.tree.persisted_number, self.tree.persisted_hash))
            self.durability.close()
        elif self.factory.db is not None and hasattr(self.factory.db, "flush"):
            self.factory.db.flush()
        if self.config.trace_blocks:
            # terminate the Chrome trace into a valid JSON array
            from .. import tracing

            tracing.shutdown_chrome_trace()
