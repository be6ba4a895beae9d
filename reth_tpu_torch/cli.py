"""Command-line interface: init / import / node / db / stage commands.

Reference analogue: bin/reth (`Cli::run`, Commands enum —
crates/ethereum/cli/src/interface.rs:284) and crates/cli/commands
(init, import, db stats, stage run…). Genesis files use the geth-style
JSON schema (chainId + alloc).

Run as ``python -m reth_tpu_torch <command> ...``.

A copy of the JAX package's ``cli.py`` over the port's node and modules,
with every subcommand of its ``main``. Departures:

- ``--device {cuda,cpu}`` (default ``cuda``) on every subcommand that builds
  a committer: the card the committer, the node and the stages run on. It
  is the port's counterpart of ``JAX_PLATFORMS``; the tests pass ``cpu``
  (the kernels' plain versions). No path moves to the CPU unless asked, and
  a missing card raises (``device.resolve``). ``--hasher cpu`` is an
  explicit request for the host's numpy hasher, as in the reference;
- ``node --role replica|standby``, ``--fleet`` and ``--ha-peer-feed`` (the
  fleet slice) and ``--health`` (the health slice) raise
  ``NotImplementedError`` naming their ``ROADMAP.md`` A item;
- ``_load_genesis`` takes an account without code's code hash as the
  constant ``KECCAK_EMPTY``, where the reference hashes ``b""`` once an
  account on the host (the same hash).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def _num(v, default=0) -> int:
    """Genesis numeric field: hex string, decimal string, or JSON number
    (geth's math.HexOrDecimal256 accepts all three)."""
    if v is None:
        return default
    if isinstance(v, int):
        return v
    s = str(v)
    if s.startswith(("0x", "0X")):
        return int(s, 16)
    return int(s)


def _resolve_warmup(args) -> tuple[str, str | None]:
    """(mode, cache_dir) for the warm-up manager: flags beat env; the cache
    dir defaults under the datadir once warm-up is on."""
    import os

    mode = (getattr(args, "warmup", None)
            or os.environ.get("RETH_TPU_WARMUP") or "off")
    cache_dir = (getattr(args, "compile_cache_dir", None)
                 or os.environ.get("RETH_TPU_COMPILE_CACHE_DIR"))
    if not cache_dir and mode != "off" and getattr(args, "datadir", None):
        cache_dir = str(Path(args.datadir) / "compile-cache")
    return mode, cache_dir


def _resolve_wal(args) -> bool:
    """memdb write-ahead log: --wal/--no-wal beats RETH_TPU_WAL beats
    the on-by-default (storage/wal.py no-ops for non-memdb engines)."""
    import os

    flag = getattr(args, "wal", None)
    if flag is not None:
        return flag
    env = os.environ.get("RETH_TPU_WAL")
    if env is not None:
        return env not in ("", "0")
    return True


def _resolve_mesh(args) -> int:
    """Device-mesh width: --mesh beats RETH_TPU_MESH beats [node]
    mesh_devices (reth.toml); 0/1 = the mesh layer stays off."""
    import os

    n = getattr(args, "mesh", None)
    if n is None:
        n = os.environ.get("RETH_TPU_MESH") or 0
    return int(n or 0)


def _resolve_subtrie(args) -> int:
    """Whole-subtrie k-level fused kernels: --subtrie-levels beats
    RETH_TPU_SUBTRIE_LEVELS beats [node] subtrie_levels (reth.toml);
    0/1 = per-level dispatching. The resolved k is exported back into
    the env so EVERY consumer (TurboCommitter, ParallelSparseCommitter,
    HashService window requests) picks it up without plumbing."""
    import os

    k = getattr(args, "subtrie_levels", None)
    if k is None:
        k = os.environ.get("RETH_TPU_SUBTRIE_LEVELS") or 0
    k = int(k or 0)
    if k > 1:
        os.environ["RETH_TPU_SUBTRIE_LEVELS"] = str(k)
    return k


def _make_committer(args, device: str = "cuda"):
    """The committer of ``args``'s ``--hasher`` route on ``args.device``
    (``device`` when ``args`` carries none: the card)."""
    from .trie.committer import TrieCommitter

    _resolve_subtrie(args)
    device = getattr(args, "device", device)
    mode = getattr(args, "hasher", "device")
    warm_mode, cache_dir = _resolve_warmup(args)
    mesh_n = _resolve_mesh(args) if mode != "cpu" else 0
    hash_mesh = None
    if mesh_n > 1:
        # --mesh: the real device-mesh descriptor (parallel/mesh.py) —
        # health mask + sub-mesh leases + the partition-rule table. Turbo
        # committers shard fused level windows over it; with
        # --hash-service the service routes every coalesced dispatch
        # through it (per-device breakers, partial-mesh degradation).
        from .parallel.mesh import HashMesh

        hash_mesh = HashMesh.build(mesh_n, device=device)
        mesh_n = hash_mesh.n_devices  # clamped to the available topology
    warmup = None
    if mode != "cpu" and warm_mode != "off":
        # device warm-up manager (ops/warmup.py): the shape menu AOT-
        # compiles under per-shape watchdog budgets while the node serves
        # degraded on the CPU twin; the persistent compile cache (keyed
        # under the datadir, probe-verified) makes restarts near-free
        from .ops.warmup import build_warmup
    if mode == "cpu":
        from .primitives.keccak import keccak256_batch_np

        committer = TrieCommitter(hasher=keccak256_batch_np, device=device)
        committer.turbo_backend = "numpy"  # MerkleStage clean-path backend
    elif mode == "auto":
        # supervised device route (ops/supervisor.py): startup health
        # probe, watchdog-bounded dispatch, circuit breaker with CPU
        # failover — a wedged tunnel degrades the node, never hangs it
        from .ops.supervisor import DeviceSupervisor

        sup = DeviceSupervisor.shared()
        healthy = sup.startup()
        if warm_mode != "off":
            warmup = build_warmup(supervisor=sup, cache_dir=cache_dir,
                                  mesh_size=max(1, mesh_n), device=device)
        committer = TrieCommitter(supervisor=sup, warmup=warmup, device=device)
        committer.turbo_backend = "auto"
        if not healthy:
            print(f"hasher auto: device unhealthy at startup "
                  f"({sup.last_probe.diag}); routing to cpu until a "
                  f"re-probe succeeds", file=sys.stderr)
    else:
        if warm_mode != "off":
            warmup = build_warmup(cache_dir=cache_dir,
                                  mesh_size=max(1, mesh_n), device=device)
        committer = TrieCommitter(warmup=warmup, device=device)
        committer.turbo_backend = "device"
    if warmup is not None:
        committer.warmup = warmup
        if warm_mode == "block":
            # blocking warm-up: nothing dispatches before the menu is warm
            # (offline commands — init/import — prefer determinism)
            warmup.run()
        else:
            warmup.start()
    if hash_mesh is not None:
        # mesh without a service still shards the turbo committers'
        # fused level loops (stages/merkle, incremental full rebuild)
        committer.hash_mesh = hash_mesh
    if getattr(args, "hash_service", False):
        # --hash-service: ONE background service owns the (supervised)
        # hashing backend and multiplexes every client over priority lanes
        # (ops/hash_service.py). The committer's own hasher becomes the
        # live-tip lane client; call sites pick other lanes via for_lane.
        # With --mesh the service owns the MESH: coalesced dispatches
        # route through the partition-rule table, rebuild commits take
        # sub-mesh leases, per-device breakers degrade partially.
        from .ops.hash_service import HashService

        committer.hash_service = HashService(
            backend=committer.hasher,
            supervisor=getattr(committer, "supervisor", None),
            mesh=hash_mesh, warmup=warmup, device=device)
        committer.hasher = committer.hash_service.client("live")
    return committer


# Built-in dev-mode genesis (reference --dev auto-installs a dev chainspec).
# Funded key: the standard dev mnemonic's first account.
DEV_PRIVATE_KEY = 0xAC0974BEC39A17E36BA4A6B4D238FF944BACB478CBED5EFCAE784D7BF4F2FF80


def _dev_genesis_spec() -> dict:
    from .primitives import secp256k1

    addr = secp256k1.address_from_priv(DEV_PRIVATE_KEY)
    return {
        "config": {"chainId": 1337},
        "gasLimit": hex(30_000_000),
        "alloc": {"0x" + addr.hex(): {"balance": hex(10**24)}},
    }


def _load_genesis(path: str | None, committer, spec: dict | None = None):
    from .primitives.types import Account, Header, EMPTY_ROOT_HASH, KECCAK_EMPTY
    from .primitives.keccak import keccak256

    if spec is None:
        spec = json.loads(Path(path).read_text())
    alloc = {}
    storage = {}
    codes = {}
    for addr_hex, entry in spec.get("alloc", {}).items():
        addr = bytes.fromhex(addr_hex.removeprefix("0x"))
        code = bytes.fromhex(entry.get("code", "0x")[2:]) if entry.get("code") else b""
        # the empty code's hash is a constant: no host keccak an account
        code_hash = keccak256(code) if code else KECCAK_EMPTY
        alloc[addr] = Account(
            nonce=_num(entry.get("nonce")),
            balance=_num(entry.get("balance")),
            code_hash=code_hash,
        )
        if code:
            codes[code_hash] = code
        if entry.get("storage"):
            storage[addr] = {
                _num(k).to_bytes(32, "big"): _num(v)
                for k, v in entry["storage"].items()
            }
    config = spec.get("config", {})
    chain_id = _num(config.get("chainId"), 1)
    from .trie.state_root import state_root

    root, _ = state_root(alloc, storage, committer=committer)
    from .chainspec import ChainSpec

    common = dict(
        number=0,
        state_root=root,
        gas_limit=_num(spec.get("gasLimit"), 30_000_000),
        timestamp=_num(spec.get("timestamp")),
        extra_data=bytes.fromhex(spec.get("extraData", "0x")[2:]),
        difficulty=_num(spec.get("difficulty")),
        beneficiary=bytes.fromhex(spec.get("coinbase", "0x" + "00" * 20)[2:]),
        mix_hash=bytes.fromhex(spec.get("mixHash", "0x" + "00" * 32)[2:]),
        nonce=_num(spec.get("nonce")).to_bytes(8, "big"),
    )
    if ChainSpec.config_has_forks(config):
        # explicit schedule: build the genesis header with exactly the
        # fields its genesis-time fork carries (geth's genesis ToBlock)
        cs_tmp = ChainSpec.from_genesis_config(config, chain_id=chain_id)
        from .evm.spec import spec_for_block

        s0 = spec_for_block(cs_tmp, 0, common["timestamp"])
        import hashlib as _hashlib

        header = Header(
            **common,
            base_fee_per_gas=(_num(spec.get("baseFeePerGas"), 10**9)
                              if s0.has_basefee or spec.get("baseFeePerGas")
                              else None),
            withdrawals_root=EMPTY_ROOT_HASH if s0.has_withdrawals else None,
            blob_gas_used=_num(spec.get("blobGasUsed"), 0) if s0.blob else None,
            excess_blob_gas=(_num(spec.get("excessBlobGas"), 0)
                             if s0.blob else None),
            parent_beacon_block_root=(b"\x00" * 32 if s0.beacon_root_call
                                      else None),
            requests_hash=(_hashlib.sha256().digest() if s0.has_requests
                           else None),
        )
    else:
        # dev-style genesis (no schedule): keep the repo's legacy shape
        header = Header(
            **common,
            base_fee_per_gas=_num(spec.get("baseFeePerGas"), 10**9),
            withdrawals_root=None if spec.get("preMerge") else EMPTY_ROOT_HASH,
        )
    chain_spec = ChainSpec.from_genesis_config(
        config, genesis_hash=header.hash, chain_id=chain_id)
    return header, alloc, storage, codes, chain_id, chain_spec


def cmd_init(args):
    from .node import Node, NodeConfig

    committer = _make_committer(args)
    header, alloc, storage, codes, chain_id, chain_spec = _load_genesis(args.genesis, committer)
    cfg = NodeConfig(
        chain_id=chain_id, datadir=args.datadir, genesis_header=header,
        genesis_alloc=alloc, genesis_storage=storage, genesis_codes=codes,
        chain_spec=chain_spec, db_backend=_resolve_backend(args),
        storage_v2=getattr(args, "storage_v2", None),
    )
    node = Node(cfg, committer=committer, device=args.device)
    node.factory.db.flush()
    print(f"genesis initialised: hash=0x{header.hash.hex()} chain_id={chain_id}")
    return 0


def cmd_import(args):
    from .consensus import EthBeaconConsensus
    from .node import Node, NodeConfig
    from .primitives.types import Block
    from .stages import Pipeline, default_stages
    from .storage.genesis import import_chain

    committer = _make_committer(args)
    header, alloc, storage, codes, chain_id, chain_spec = _load_genesis(args.genesis, committer)
    cfg = NodeConfig(chain_id=chain_id, datadir=args.datadir, genesis_header=header,
                     genesis_alloc=alloc, genesis_storage=storage, genesis_codes=codes,
                     chain_spec=chain_spec, db_backend=_resolve_backend(args),
                     storage_v2=getattr(args, "storage_v2", None))
    node = Node(cfg, committer=committer, device=args.device)
    raw = Path(args.file).read_bytes()
    blocks = []
    pos = 0
    from .primitives.rlp import _decode_at

    while pos < len(raw):
        _item, end = _decode_at(raw, pos)
        blocks.append(Block.decode(raw[pos:end]))
        pos = end
    from .evm import EvmConfig as _EvmConfig

    exec_spec = chain_spec.execution_spec
    consensus = EthBeaconConsensus(node.committer, chainspec=exec_spec)
    tip = import_chain(node.factory, blocks, consensus)
    print(f"imported {len(blocks)} blocks, tip={tip}")
    t0 = time.time()
    pipeline = Pipeline(node.factory, default_stages(
        committer=node.committer, consensus=consensus,
        evm_config=_EvmConfig(chain_id=chain_id, chainspec=exec_spec),
        device=args.device))
    pipeline.run(tip)
    node.factory.db.flush()
    print(f"pipeline synced to {tip} in {time.time()-t0:.2f}s")
    return 0


def cmd_import_era(args):
    from .consensus import EthBeaconConsensus
    from .era import import_era, read_era1
    from .node import Node, NodeConfig
    from .stages import Pipeline, default_stages

    committer = _make_committer(args)
    header, alloc, storage, codes, chain_id, chain_spec = _load_genesis(args.genesis, committer)
    cfg = NodeConfig(chain_id=chain_id, datadir=args.datadir, genesis_header=header,
                     genesis_alloc=alloc, genesis_storage=storage, genesis_codes=codes,
                     chain_spec=chain_spec, db_backend=_resolve_backend(args))
    node = Node(cfg, committer=committer, device=args.device)
    consensus = EthBeaconConsensus(node.committer)
    if args.source:
        # checksummed multi-archive source driven by the Era STAGE
        # (reference era-downloader + EraStage)
        from .era_sync import EraDownloader, EraStage, era_source_for

        dl = EraDownloader(era_source_for(args.source),
                           Path(args.datadir) / "era-cache")
        paths = dl.fetch_all()
        tip = max(
            read_era1(p).start_block + len(read_era1(p).blocks) - 1
            for p in paths
        )
        stages = [EraStage(dl, consensus)] + default_stages(committer=node.committer,
                                                            device=args.device)
        print(f"era source verified: {len(paths)} archives, tip={tip}")
        Pipeline(node.factory, stages).run(tip)
    else:
        tip = import_era(node.factory, args.file, consensus)
        print(f"imported era1 file, tip={tip}")
        Pipeline(node.factory, default_stages(committer=node.committer,
                                              device=args.device)).run(tip)
    node.factory.db.flush()
    print(f"pipeline synced to {tip}")
    return 0


def cmd_export_era(args):
    from .era import export_era
    from .storage import ProviderFactory

    factory = ProviderFactory(_open_db(args))
    n = export_era(factory, args.first, args.last, args.file)
    print(f"exported {n} blocks to {args.file}")
    return 0


def _env_trace_enabled() -> bool:
    from .tracing import _env_enabled

    return _env_enabled()


def cmd_node(args):
    from .node import Node, NodeConfig

    # the options whose modules come with later slices (ROADMAP.md A)
    if getattr(args, "role", "full") in ("replica", "standby"):
        raise NotImplementedError(
            f"--role {args.role}: the fleet's replica and standby roles are "
            f"not ported yet (ROADMAP.md A item 2, the fleet)")
    if getattr(args, "fleet", None) or getattr(args, "ha_peer_feeds", None):
        raise NotImplementedError(
            "--fleet / --ha-peer-feed: the read-replica fleet and HA fencing "
            "are not ported yet (ROADMAP.md A item 2, the fleet)")
    if getattr(args, "health", False):
        raise NotImplementedError(
            "--health: the health & SLO engine is not ported yet "
            "(ROADMAP.md A item 1, health)")
    committer = _make_committer(args)
    backend = _resolve_backend(args)
    if args.db_backend in ("paged", "native") and not args.datadir:
        print(f"error: --db {args.db_backend} is a persistent engine and "
              "needs --datadir", file=sys.stderr)
        return 1
    if not args.datadir:
        backend = "memdb"  # ephemeral node: in-process store
    kw = {}
    if args.genesis:
        header, alloc, storage, codes, chain_id, chain_spec = _load_genesis(args.genesis, committer)
        kw = dict(genesis_header=header, genesis_alloc=alloc,
                  genesis_storage=storage, genesis_codes=codes, chain_id=chain_id,
                  chain_spec=chain_spec)
    elif args.dev:
        # reference --dev auto-installs a dev chainspec with a funded key
        header, alloc, storage, codes, chain_id, chain_spec = _load_genesis(
            None, committer, spec=_dev_genesis_spec()
        )
        kw = dict(genesis_header=header, genesis_alloc=alloc,
                  genesis_storage=storage, genesis_codes=codes, chain_id=chain_id,
                  chain_spec=chain_spec)
        print(f"dev genesis: funded key 0x{DEV_PRIVATE_KEY:064x}")
    else:
        # no genesis given: the datadir must already be initialised. The
        # persistent engines are probed by their on-disk artifacts (opening
        # them here would double-open the store the Node is about to own).
        initialised = False
        if args.datadir:
            from .storage import store_initialised

            initialised = store_initialised(backend, args.datadir)
        if not initialised:
            print("error: no genesis — pass --genesis or run `init`, or use --dev",
                  file=sys.stderr)
            return 1
    jwt_secret = None
    if args.authrpc_jwtsecret:
        from .rpc.jwt import load_or_create_secret

        jwt_secret = load_or_create_secret(args.authrpc_jwtsecret)
    warm_mode, warm_cache = _resolve_warmup(args)
    cfg = NodeConfig(datadir=args.datadir, dev=args.dev,
                     http_port=args.http_port, authrpc_port=args.authrpc_port,
                     jwt_secret=jwt_secret, ws_port=args.ws_port,
                     ipc_path=args.ipc_path, enable_admin=args.enable_admin,
                     p2p_port=args.port if not args.disable_p2p else None,
                     p2p_host=args.addr,
                     discovery=not args.no_discovery,
                     nat=args.nat,
                     bootnodes=tuple(args.bootnodes.split(",")) if args.bootnodes else (),
                     bootnodes_v5=tuple(args.bootnodes_v5.split(",")) if args.bootnodes_v5 else (),
                     db_backend=backend,
                     storage_v2=getattr(args, "storage_v2", None),
                     sparse_workers=getattr(args, "sparse_workers", None),
                     parallel_exec=getattr(args, "parallel_exec", False),
                     pipeline_depth=getattr(args, "pipeline_depth", None),
                     continuous_build=getattr(args, "continuous_build",
                                              False),
                     hot_state=getattr(args, "hot_state", False),
                     rpc_gateway=getattr(args, "rpc_gateway", False),
                     warmup=warm_mode,
                     compile_cache_dir=warm_cache,
                     health=getattr(args, "health", False),
                     slo_interval=getattr(args, "slo_interval", 1.0),
                     slo_window=getattr(args, "slo_window", 300),
                     wal=_resolve_wal(args),
                     wal_checkpoint_blocks=getattr(
                         args, "wal_checkpoint_blocks", 8),
                     recovery_verify_root=getattr(
                         args, "recovery_verify_root", True),
                     invalid_cache_size=getattr(
                         args, "invalid_cache_size", None),
                     fleet=bool(getattr(args, "fleet", None)),
                     ha_peer_feeds=tuple(
                         getattr(args, "ha_peer_feeds", None) or ()),
                     feed_port=getattr(args, "feed_port", 0) or 0,
                     fleet_max_lag=(getattr(args, "fleet_max_lag", None)
                                    if getattr(args, "fleet_max_lag", None)
                                    is not None else 4),
                     # --trace-blocks; unset falls back to RETH_TPU_TRACE
                     trace_blocks=(args.trace_blocks
                                   if getattr(args, "trace_blocks", None)
                                   is not None
                                   else _env_trace_enabled()),
                     trace_file=getattr(args, "trace_file", None),
                     **kw)
    node = Node(cfg, committer=committer, device=args.device)
    p2p_port = node.start_network()
    if p2p_port is not None:
        print(f"P2P listening on {node.network.host}:{p2p_port} "
              f"({node.network.enode})")
        if node.discovery is not None:
            print(f"discv4 on udp/{node.discovery.port}")
    http_port, auth_port = node.start_rpc()
    print(f"RPC listening on 127.0.0.1:{http_port}, engine API on 127.0.0.1:{auth_port}")
    if node.feed_server is not None:
        print(f"witness feed on 127.0.0.1:{node.feed_server.port} "
              f"(replicas: --role replica --feed "
              f"127.0.0.1:{node.feed_server.port})")
    if getattr(args, "ethstats", None):
        from .ethstats import EthStatsService

        try:
            stats = EthStatsService(args.ethstats, node)
            stats.start()
            node.ethstats = stats
            print(f"ethstats reporting to {stats.host}:{stats.port} as {stats.node_name}")
        except OSError as e:
            print(f"ethstats connection failed: {e}", file=sys.stderr)
    if node.ws is not None:
        print(f"WebSocket RPC on 127.0.0.1:{node.ws.port}")
    if node.ipc is not None:
        print(f"IPC RPC at {node.ipc.path}")
    if args.dev and args.block_time > 0:
        print(f"dev mode: mining every {args.block_time}s")

        def mine_loop(shutdown):
            while not shutdown.wait(args.block_time):
                block = node.miner.mine_block(timestamp=int(time.time()))
                print(f"mined block {block.header.number} "
                      f"({len(block.transactions)} txs) 0x{block.hash.hex()[:16]}")

        node.tasks.spawn_critical("dev-miner", mine_loop)
    elif args.dev:
        # --block-time 0: geth-dev style instant sealing — mine the moment
        # the pool holds an executable transaction
        print("dev mode: instant sealing (mine on transaction)")

        def mine_on_tx(shutdown):
            while not shutdown.wait(0.05):
                if not node.pool.updated.is_set():
                    continue  # no pool activity since last look: no reads
                node.pool.updated.clear()
                # only seal when something is executable — queued-only
                # (nonce-gapped) pools must not grind out empty blocks
                if next(node.pool.best_transactions(), None) is None:
                    continue
                block = node.miner.mine_block(timestamp=int(time.time()))
                print(f"mined block {block.header.number} "
                      f"({len(block.transactions)} txs) 0x{block.hash.hex()[:16]}")

        node.tasks.spawn_critical("dev-miner", mine_on_tx)
    try:
        while not node.tasks.shutdown.wait(1.0):
            pass
    except KeyboardInterrupt:
        pass
    node.stop()
    errors = node.tasks.critical_errors()
    for name, err in errors:
        print(f"critical task {name} failed: {err}", file=sys.stderr)
    return 1 if errors else 0


def _resolve_backend(args) -> str:
    """Pick the storage backend: an explicit --db always wins; otherwise a
    datadir that already holds a store keeps its engine (legacy datadirs
    must never silently open a brand-new empty default store); otherwise
    the paged default."""
    from .storage import store_initialised

    explicit = getattr(args, "db_backend", None)
    if explicit:
        return explicit
    datadir = getattr(args, "datadir", None)
    if datadir:
        for b in ("paged", "native", "memdb"):
            if store_initialised(b, datadir):
                return b
    return "paged"


def _open_db(args):
    """Open the datadir's database with the selected backend (reference:
    the database args shared by every offline command)."""
    from .storage import open_database

    Path(args.datadir).mkdir(parents=True, exist_ok=True)
    return open_database(_resolve_backend(args), args.datadir,
                         getattr(args, "storage_v2", None))


def cmd_db_get(args):
    """Print one table entry (reference `reth db get`)."""
    db = _open_db(args)
    with db.tx() as tx:
        key = bytes.fromhex(args.key.removeprefix("0x"))
        if args.subkey:
            sub = bytes.fromhex(args.subkey.removeprefix("0x"))
            entry = tx.cursor(args.table).seek_by_key_subkey(key, sub)
            val = entry[1] if entry else None
        else:
            val = tx.get(args.table, key)
    if val is None:
        print("not found", file=sys.stderr)
        return 1
    print("0x" + val.hex())
    return 0


def cmd_db_list(args):
    """List table entries from an offset (reference `reth db list`)."""
    db = _open_db(args)
    with db.tx() as tx:
        cur = tx.cursor(args.table)
        start = bytes.fromhex(args.start.removeprefix("0x")) if args.start else None
        shown = 0
        for key, val in cur.walk(start):
            print(f"0x{key.hex()}  0x{val.hex()[:2 * args.value_bytes]}"
                  + ("…" if len(val) > args.value_bytes else ""))
            shown += 1
            if shown >= args.limit:
                break
        print(f"-- {shown} entr{'y' if shown == 1 else 'ies'} "
              f"(of {tx.entry_count(args.table)})")
    return 0


def cmd_db_diff(args):
    """Compare two databases table-by-table (reference `reth db diff`)."""
    import argparse as _ap

    db_a = _open_db(args)
    db_b = _open_db(_ap.Namespace(datadir=args.other,
                                  db_backend=getattr(args, "db_backend", None)))
    tables = args.table.split(",") if args.table else None
    differences = 0
    with db_a.tx() as ta, db_b.tx() as tb:
        names = tables
        if names is None:
            from .storage.tables import TableDef, Tables

            names = sorted(v.name for v in vars(Tables).values()
                           if isinstance(v, TableDef))
        for name in names:
            ca, cb = ta.entry_count(name), tb.entry_count(name)
            seen = 0
            # keys only; values compared as whole duplicate sets (DUPSORT
            # tables hold several values per key)
            cur = ta.cursor(name)
            entry = cur.first()
            while entry is not None:
                key = entry[0]
                if ta.get_dups(name, key) != tb.get_dups(name, key):
                    differences += 1
                    seen += 1
                    if seen <= args.limit:
                        missing = tb.get(name, key) is None
                        print(f"{name}: 0x{key.hex()} "
                              f"{'missing' if missing else 'differs'}")
                entry = cur.next_no_dup()
            if ca != cb:
                differences += 1
                print(f"{name}: entry count {ca} != {cb}")
    print(f"{differences} difference(s)")
    return 0 if differences == 0 else 1


def cmd_db_repair_trie(args):
    """Rebuild the trie tables from the hashed state and fix divergences
    (reference `reth db repair-trie`): verify first, then clear + recompute
    stored branch nodes so the stored trie matches the leaves."""
    from .ops._build import is_kernel_fault
    from .storage import ProviderFactory
    from .trie.incremental import full_state_root, verify_state_root

    factory = ProviderFactory(_open_db(args))
    committer = _make_committer(args)
    with factory.provider() as p:
        tip = p.stage_checkpoint("MerkleExecute")
        header = p.header_by_number(tip)
        if header is None:
            print("empty database (no merkle checkpoint)", file=sys.stderr)
            return 1
        try:
            root, problems = verify_state_root(p, committer, device=args.device)
        except Exception as e:  # noqa: BLE001 — corrupt nodes may not decode
            if is_kernel_fault(e):
                raise
            root, problems = None, [f"verification failed: {e}"]
        if root == header.state_root and not problems:
            print(f"trie OK at block {tip}: nothing to repair")
            return 0
    for msg in problems:
        print(f"REPAIRING: {msg}", file=sys.stderr)
    with factory.provider_rw() as p:
        from .storage.tables import Tables

        p.tx.clear(Tables.AccountsTrie.name)
        p.tx.clear(Tables.StoragesTrie.name)
        new_root = full_state_root(p, committer, device=args.device)
        if new_root != header.state_root:
            print(f"REPAIR FAILED: rebuilt 0x{new_root.hex()} != header "
                  f"0x{header.state_root.hex()} — hashed state itself is bad",
                  file=sys.stderr)
            return 1
    factory.db.flush()
    print(f"trie repaired at block {tip}: 0x{new_root.hex()}")
    return 0


def cmd_init_state(args):
    """Initialise a database from a state dump at a given block (reference
    `reth init-state`: sync-from-state for chains with huge history)."""
    from .storage import ProviderFactory
    from .storage.genesis import init_genesis
    from .primitives.types import Header

    with open(args.state) as f:
        dump = json.load(f)
    unhex = lambda x: bytes.fromhex(x.removeprefix("0x"))  # noqa: E731
    header = Header.decode(unhex(dump["header"]))
    alloc, storage, codes = {}, {}, {}
    from .primitives.types import Account
    from .primitives.keccak import keccak256

    for addr_hex, acct in dump.get("accounts", {}).items():
        addr = unhex(addr_hex)
        code = unhex(acct["code"]) if acct.get("code") else b""
        if code:
            codes[keccak256(code)] = code
        alloc[addr] = Account(
            nonce=int(acct.get("nonce", "0x0"), 16),
            balance=int(acct.get("balance", "0x0"), 16),
        )
        slots = {unhex(k): int(v, 16)
                 for k, v in acct.get("storage", {}).items()}
        if slots:
            storage[addr] = slots
    factory = ProviderFactory(_open_db(args))
    committer = _make_committer(args)
    got = init_genesis(factory, header, alloc, storage, codes,
                       committer=committer, device=args.device)
    factory.db.flush()
    print(f"state initialised at block {header.number}: 0x{got.hex()}")
    return 0


def cmd_test_vectors(args):
    """Generate deterministic codec/table test vectors (reference
    `reth test-vectors compact|tables`): random typed values round-tripped
    through the codecs, written as JSON for cross-version compatibility
    checks."""
    import numpy as np

    from .primitives.types import Account, Header
    from .storage.tables import (
        decode_account,
        encode_account,
        be64,
        from_be64,
    )

    rng = np.random.default_rng(args.seed)
    vectors = {"accounts": [], "headers": [], "be64": []}
    for _ in range(args.count):
        acct = Account(
            nonce=int(rng.integers(0, 2**40)),
            balance=int(rng.integers(0, 2**60)) * int(rng.integers(1, 2**30)),
            storage_root=bytes(rng.integers(0, 256, 32, dtype=np.uint8)),
            code_hash=bytes(rng.integers(0, 256, 32, dtype=np.uint8)),
        )
        enc = encode_account(acct)
        assert decode_account(enc) == acct
        vectors["accounts"].append("0x" + enc.hex())
        h = Header(
            number=int(rng.integers(0, 2**32)),
            timestamp=int(rng.integers(0, 2**32)),
            gas_limit=int(rng.integers(0, 2**30)),
            gas_used=int(rng.integers(0, 2**30)),
            base_fee_per_gas=int(rng.integers(0, 2**40)),
            state_root=bytes(rng.integers(0, 256, 32, dtype=np.uint8)),
        )
        enc = h.encode()
        assert Header.decode(enc).hash == h.hash
        vectors["headers"].append("0x" + enc.hex())
        n = int(rng.integers(0, 2**63))
        assert from_be64(be64(n)) == n
        vectors["be64"].append(n)
    out = json.dumps(vectors, indent=None)
    if args.out:
        Path(args.out).write_text(out)
        print(f"{args.count} vectors x 3 codecs -> {args.out}")
    else:
        print(out)
    return 0


def cmd_bb_bench(args):
    """Big-block execution benchmark (reference bin/reth-bb): execute one
    synthetic maximum-size block and report Mgas/s — serial vs BAL waves."""
    from .engine.bal import execute_block_bal, record_access_list
    from .evm import BlockExecutor, EvmConfig
    from .evm.executor import InMemoryStateSource
    from .primitives import Account
    from .primitives.keccak import keccak256
    from .primitives.types import Block, Header
    from .testing import Wallet

    n_transfer = args.transfers
    n_store = args.stores
    # PUSH0 CALLDATALOAD PUSH0 SSTORE STOP — a storage write per call
    store_code = bytes.fromhex("5f355f5500")
    wallets = [Wallet(0x10000 + i) for i in range(n_transfer + n_store)]
    accounts = {w.address: Account(balance=10**20) for w in wallets}
    contracts = []
    for i in range(max(1, n_store // 8)):  # 8 callers share a contract
        c = bytes([0x5C]) + i.to_bytes(19, "big")
        accounts[c] = Account(code_hash=keccak256(store_code))
        contracts.append(c)
    src = InMemoryStateSource(accounts, codes={keccak256(store_code): store_code})
    txs = [w.transfer(bytes([0xD0]) + i.to_bytes(19, "big"), 1 + i)
           for i, w in enumerate(wallets[:n_transfer])]
    txs += [w.call(contracts[i % len(contracts)], i.to_bytes(32, "big"))
            for i, w in enumerate(wallets[n_transfer:])]
    header = Header(number=1, gas_limit=2_000_000_000, base_fee_per_gas=7,
                    beneficiary=b"\xcb" * 20)
    block = Block(header, tuple(txs), (), ())
    senders = [w.address for w in wallets]

    cfg = EvmConfig(chain_id=1)
    t0 = time.time()
    out = BlockExecutor(src, cfg).execute(block, senders)
    dt_serial = time.time() - t0
    mgas = out.gas_used / 1e6
    print(f"serial:   {len(txs)} txs, {mgas:.2f} Mgas in {dt_serial:.3f}s "
          f"= {mgas / dt_serial:.2f} Mgas/s")
    bal = record_access_list(src, block, senders, cfg)
    t0 = time.time()
    out2, stats = execute_block_bal(src, block, senders, bal, cfg)
    dt_bal = time.time() - t0
    assert out2.gas_used == out.gas_used
    print(f"bal:      {mgas:.2f} Mgas in {dt_bal:.3f}s = "
          f"{mgas / dt_bal:.2f} Mgas/s  waves={stats['waves']} "
          f"parallel={stats['parallel']} serial={stats['serial']} "
          f"native={stats.get('native', 0)}")
    print(json.dumps({"metric": "execution_mgas_per_sec",
                      "value": round(mgas / dt_serial, 3),
                      "unit": "Mgas/s",
                      "bal_mgas_per_sec": round(mgas / dt_bal, 3)}))
    return 0


def cmd_config(args):
    """Print the effective TOML-style config (reference `reth config`)."""
    from .config import load_config

    cfg = load_config(args.config)
    lines = [
        "[stages.merkle]",
        f"rebuild_threshold = {cfg.stages.merkle.rebuild_threshold}",
        f"incremental_threshold = {cfg.stages.merkle.incremental_threshold}",
        "",
        "[stages.account_hashing]",
        f"clean_threshold = {cfg.stages.account_hashing.clean_threshold}",
        "",
        "[stages.storage_hashing]",
        f"clean_threshold = {cfg.stages.storage_hashing.clean_threshold}",
        "",
        "[stages.execution]",
        f"max_blocks_per_commit = {cfg.stages.execution.max_blocks_per_commit}",
        "",
        "[node]",
        f"persistence_threshold = {cfg.persistence_threshold}",
        f'hasher = "{cfg.hasher}"',
        f"hash_service = {'true' if cfg.hash_service else 'false'}",
        f"mesh_devices = {cfg.mesh_devices}",
        f'warmup = "{cfg.warmup}"',
        f'compile_cache_dir = "{cfg.compile_cache_dir}"',
        f"sparse_workers = {cfg.sparse_workers}",
        f"subtrie_levels = {cfg.subtrie_levels}",
        f"parallel_exec = {'true' if cfg.parallel_exec else 'false'}",
        f"pipeline_depth = {cfg.pipeline_depth}",
        f"continuous_build = {'true' if cfg.continuous_build else 'false'}",
        f"hot_state = {'true' if cfg.hot_state else 'false'}",
        f"trace_blocks = {'true' if cfg.trace_blocks else 'false'}",
        f"health = {'true' if cfg.health else 'false'}",
        f"slo_interval = {cfg.slo_interval}",
        f"slo_window = {cfg.slo_window}",
        f"invalid_cache_size = {cfg.invalid_cache_size}",
        "",
        "[rpc]",
        f"gateway = {'true' if cfg.rpc.gateway else 'false'}",
        f"gateway_cache = {cfg.rpc.gateway_cache}",
        "",
        "[prune]",
    ]
    for seg in ("sender_recovery", "receipts", "transaction_lookup",
                "account_history", "storage_history"):
        mode = getattr(cfg.prune, seg, None)
        if mode is not None and (mode.distance is not None or mode.before is not None):
            which = (f"distance = {mode.distance}" if mode.distance is not None
                     else f"before = {mode.before}")
            lines.append(f"{seg} = {{ {which} }}")
    print("\n".join(lines))
    return 0


def cmd_db_verify_trie(args):
    """Recompute the state root from hashed tables; compare with the tip
    header (reference `reth db repair-trie` / trie verify iterator)."""
    from .storage import ProviderFactory
    from .trie.incremental import verify_state_root

    factory = ProviderFactory(_open_db(args))
    committer = _make_committer(args)
    with factory.provider() as p:
        # the hashed/trie tables are current as of the MERKLE checkpoint,
        # not the canonical tip (a lagging pipeline is not corruption)
        tip = p.stage_checkpoint("MerkleExecute")
        header = p.header_by_number(tip)
        if header is None:
            print("empty database (no merkle checkpoint)", file=sys.stderr)
            return 1
        # READ-ONLY full rebuild + structural cross-checks
        root, problems = verify_state_root(p, committer, device=args.device)
        for msg in problems:
            print(f"PROBLEM: {msg}", file=sys.stderr)
        if root == header.state_root and not problems:
            print(f"trie OK at block {tip}: 0x{root.hex()}")
            return 0
        if root != header.state_root:
            print(f"TRIE MISMATCH at block {tip}: computed 0x{root.hex()} "
                  f"header 0x{header.state_root.hex()}", file=sys.stderr)
        return 1


def cmd_db_stats(args):
    from .storage.tables import Tables

    db = _open_db(args)
    tx = db.tx()
    print(f"{'table':<28}{'entries':>12}")
    from .storage.tables import TableDef

    names = (sorted(db._tables) if hasattr(db, "_tables")
             else sorted(v.name for v in vars(Tables).values()
                         if isinstance(v, TableDef)))
    for name in names:
        print(f"{name:<28}{tx.entry_count(name):>12}")
    return 0


def cmd_stage_run(args):
    from .stages import Pipeline, default_stages
    from .storage import ProviderFactory

    factory = ProviderFactory(_open_db(args))
    committer = _make_committer(args)
    stages = [s for s in default_stages(committer=committer, device=args.device)
              if args.stage in ("all", s.id)]
    if not stages:
        print(f"unknown stage {args.stage}", file=sys.stderr)
        return 1
    with factory.provider() as p:
        target = args.to if args.to is not None else p.last_block_number()
    t0 = time.time()
    Pipeline(factory, stages).run(target)
    factory.db.flush()
    print(f"stage(s) {[s.id for s in stages]} ran to {target} in {time.time()-t0:.2f}s")
    return 0


def cmd_dump_genesis(args):
    """Print the built-in dev genesis JSON (reference `reth dump-genesis`)."""
    print(json.dumps(_dev_genesis_spec(), indent=2))
    return 0


def cmd_prune(args):
    """Run the pruner once to the configured targets (reference `reth prune`)."""
    from .config import load_config
    from .prune import Pruner
    from .storage import ProviderFactory

    cfg = load_config(args.config)
    factory = ProviderFactory(_open_db(args))
    pruner = Pruner(factory, cfg.prune)
    with factory.provider() as p:
        tip = p.last_block_number()
    out = pruner.run(tip)
    factory.db.flush()
    for prog in out:
        print(f"{prog.segment:<24}{prog.pruned:>10} entries pruned"
              + ("" if prog.done else " (more remain)"))
    return 0


def cmd_re_execute(args):
    """Re-execute a block range against historical state and compare
    receipts/gas with what is stored (reference `reth re-execute`)."""
    from .consensus import EthBeaconConsensus
    from .evm import BlockExecutor, EvmConfig
    from .evm.executor import ProviderStateSource
    from .storage import ProviderFactory
    from .storage.historical import HistoricalStateProvider

    factory = ProviderFactory(_open_db(args))
    mismatches = 0
    with factory.provider() as p:
        tip = p.last_block_number()
        first = max(args.from_block if args.from_block is not None else 1, 1)
        last = min(args.to_block if args.to_block is not None else tip, tip)
        if last < first:
            print(f"nothing to re-execute (range [{first}, {last}], tip {tip})")
            return 0
        for n in range(first, last + 1):
            block = p.block_by_number(n)
            parent_state = HistoricalStateProvider(p, n - 1)
            executor = BlockExecutor(ProviderStateSource(parent_state),
                                     EvmConfig())
            out = executor.execute(block)
            if out.gas_used != block.header.gas_used:
                mismatches += 1
                print(f"block {n}: gas {out.gas_used} != header "
                      f"{block.header.gas_used}", file=sys.stderr)
            idx = p.block_body_indices(n)
            for i, r in enumerate(out.receipts):
                stored = p.receipt(idx.first_tx_num + i)
                if stored is not None and (
                        stored.success != r.success
                        or stored.cumulative_gas_used != r.cumulative_gas_used):
                    mismatches += 1
                    print(f"block {n} tx {i}: receipt mismatch", file=sys.stderr)
    span = last - first + 1
    print(f"re-executed {span} blocks: "
          + ("all match" if not mismatches else f"{mismatches} MISMATCHES"))
    return 1 if mismatches else 0


def cmd_p2p(args):
    """Fetch a header/body from a peer over RLPx (reference `reth p2p`)."""
    from .net.p2p import PeerConnection, random_node_key
    from .net.server import parse_enode
    from .net.wire import Status

    pub, host, port = parse_enode(args.enode)
    status = Status(network_id=args.chain_id)
    if args.genesis_hash:
        status.genesis = bytes.fromhex(args.genesis_hash.removeprefix("0x"))
        status.head = status.genesis
    peer = PeerConnection.connect(host, port, status, pub,
                                  node_priv=random_node_key())
    try:
        if args.what == "header":
            start = (bytes.fromhex(args.id.removeprefix("0x"))
                     if args.id.startswith("0x") else int(args.id))
            headers = peer.get_headers(start, 1)
            if not headers:
                print("no header returned", file=sys.stderr)
                return 1
            h = headers[0]
            print(f"number={h.number} hash=0x{h.hash.hex()} "
                  f"state_root=0x{h.state_root.hex()} gas_used={h.gas_used}")
        else:  # body
            bodies = peer.get_bodies([bytes.fromhex(args.id.removeprefix("0x"))])
            if not bodies:
                print("no body returned", file=sys.stderr)
                return 1
            b = bodies[0]
            print(f"transactions={len(b.transactions)} "
                  f"withdrawals={len(b.withdrawals or ())}")
        return 0
    finally:
        peer.close()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="reth-tpu", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    def add_hasher(p):
        p.add_argument("--hasher", choices=["device", "cpu", "auto"],
                       default="device",
                       help="keccak backend: device (the card, through the "
                            "compiled kernel libraries; the "
                            "--state-root.backend analogue), cpu (numpy), "
                            "or auto (device behind the health-probe + "
                            "circuit-breaker supervisor; falls over to cpu "
                            "on wedged dispatches — see RETH_TPU_FAULT_* "
                            "env knobs for drill/testing)")
        p.add_argument("--hash-service", action="store_true", default=None,
                       help="multiplex every keccak client over ONE shared "
                            "background hash service (ops/hash_service.py): "
                            "priority lanes (live > payload > rebuild > "
                            "proof), continuous batching with a coalescing "
                            "window, bounded per-lane backpressure, and an "
                            "exclusive lease for rebuild streaming; "
                            "composes with --hasher auto (breaker trips / "
                            "CPU failover apply to the shared service) — "
                            "see RETH_TPU_FAULT_SERVICE_* drill knobs")
        p.add_argument("--mesh", type=int, default=None,
                       help="shard the hashing data plane over a device "
                            "MESH of this many devices (parallel/mesh.py): "
                            "fused per-depth level windows batch-shard "
                            "across the mesh (digest arena replicated, the "
                            "exchange kernel copies each level's digests "
                            "between replicas) while scalar requests "
                            "stay on one device (partition-rule table); "
                            "with --hash-service the rebuild takes a "
                            "SUB-MESH lease (k of n devices, live lanes "
                            "keep the rest; RETH_TPU_MESH_REBUILD_DEVICES) "
                            "and per-device circuit breakers shrink the "
                            "mesh around a wedged device before any CPU "
                            "failover (RETH_TPU_FAULT_DEVICE_WEDGE drills "
                            "it). Default: RETH_TPU_MESH or off; also "
                            "[node] mesh_devices in reth.toml")
        p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                       help="where the committer, the node and the stages "
                            "run: cuda (the card, the default; a missing "
                            "card is an error) or cpu (the kernels' plain "
                            "PyTorch versions, for tests)")
        p.add_argument("--warmup", choices=["off", "background", "block"],
                       default=None,
                       help="device warm-up manager (ops/warmup.py): AOT-"
                            "compile the declared kernel shape menu one "
                            "shape at a time under per-shape watchdog "
                            "budgets with retry + backoff, sequenced "
                            "behind the supervisor's health probe. "
                            "'background' serves degraded on the CPU twin "
                            "meanwhile, promoting each shape as it warms; "
                            "'block' finishes warm-up before serving. "
                            "Default: RETH_TPU_WARMUP or off. See "
                            "RETH_TPU_FAULT_COMPILE_WEDGE for the drill, "
                            "RETH_TPU_WARMUP_{BUDGET,ATTEMPTS,BACKOFF} "
                            "for the knobs; also [node] warmup in "
                            "reth.toml")
        p.add_argument("--compile-cache-dir", dest="compile_cache_dir",
                       default=None,
                       help="persistent cache of the compiled kernel "
                            "libraries for --warmup (versioned by kernel-source "
                            "digest; corrupt entries are quarantined and "
                            "rebuilt; only enabled after a subprocess "
                            "probe proves the cache loads). Default: "
                            "<datadir>/compile-cache when --warmup is on; "
                            "also RETH_TPU_COMPILE_CACHE_DIR or [node] "
                            "compile_cache_dir in reth.toml")

    def add_db_arg(p):
        # paged (the COW B+tree / MDBX analogue) is the DEFAULT everywhere
        # a datadir exists — memdb is a test fixture (reference: libmdbx is
        # the only production backend)
        p.add_argument("--storage.v2", dest="storage_v2",
                       action="store_true", default=None,
                       help="split layout: history/lookup tables on a "
                            "dedicated second store (reference "
                            "StorageSettings storage-v2); persisted per "
                            "datadir on first init")
        p.add_argument("--db", dest="db_backend",
                       choices=["memdb", "native", "paged"], default=None,
                       help="storage backend (paged = mmap COW B+tree "
                            "engine, the default; native = C++ WAL engine; "
                            "memdb = in-process test store). Unset: an "
                            "initialised datadir keeps its engine")

    p = sub.add_parser("init", help="initialise the database from a genesis file")
    p.add_argument("--datadir", required=True)
    p.add_argument("--genesis", required=True)
    add_hasher(p)
    add_db_arg(p)
    p.set_defaults(fn=cmd_init)

    p = sub.add_parser("import", help="import an RLP chain file and sync")
    p.add_argument("--datadir", required=True)
    p.add_argument("--genesis", required=True)
    p.add_argument("file")
    add_hasher(p)
    add_db_arg(p)
    p.set_defaults(fn=cmd_import)

    p = sub.add_parser("import-era", help="import era1 history archives")
    p.add_argument("--datadir", required=True)
    p.add_argument("--genesis", required=True)
    p.add_argument("file", nargs="?", default=None,
                   help="single era1 file (or use --source)")
    p.add_argument("--source", default=None,
                   help="directory of era1 archives + index.txt checksums")
    add_hasher(p)
    add_db_arg(p)
    p.set_defaults(fn=cmd_import_era)

    p = sub.add_parser("export-era", help="export canonical blocks to era1")
    p.add_argument("--datadir", required=True)
    p.add_argument("--first", type=int, required=True)
    p.add_argument("--last", type=int, required=True)
    p.add_argument("file")
    add_db_arg(p)
    p.set_defaults(fn=cmd_export_era)

    p = sub.add_parser("node", help="run the node (RPC + engine API)")
    p.add_argument("--role", choices=["full", "replica", "standby"],
                   default="full",
                   help="full: the usual node (replica and standby are "
                        "not ported yet and raise NotImplementedError). "
                        "replica: a stateless "
                        "witness-fed read replica (no database) — needs "
                        "--feed HOST:PORT; serves eth_call/eth_estimateGas/"
                        "eth_getProof/eth_getLogs/eth_getBlockBy* from "
                        "witness-backed state (fleet/replica.py). standby: "
                        "a WAL-shipped hot standby — needs --feed and "
                        "--datadir; replays the leader's durable stream and "
                        "promotes itself on heartbeat loss or fleet_promote "
                        "(fleet/standby.py)")
    p.add_argument("--feed", default=None,
                   help="(replica/standby role) HOST:PORT of the full "
                        "node's witness feed")
    p.add_argument("--replica-retention", dest="replica_retention",
                   type=int, default=128,
                   help="(replica role) validated blocks retained")
    p.add_argument("--register", default=None,
                   help="(replica role) full-node RPC URL to self-register "
                        "with (fleet_register)")
    p.add_argument("--takeover-feed-port", dest="takeover_feed_port",
                   type=int, default=0,
                   help="(standby role) feed port the promoted node binds "
                        "(0 = ephemeral)")
    p.add_argument("--no-auto-promote", dest="no_auto_promote",
                   action="store_true",
                   help="(standby role) only promote on explicit "
                        "fleet_promote (no heartbeat-loss trigger)")
    p.add_argument("--heartbeat-timeout", dest="heartbeat_timeout",
                   type=float, default=2.0,
                   help="(standby role) seconds without a leader heartbeat "
                        "before auto-promotion fires")
    p.add_argument("--ha-peer-feed", dest="ha_peer_feeds",
                   action="append", default=None,
                   help="(not ported yet: raises NotImplementedError) "
                        "(full role) HOST:PORT of a peer feed to probe for "
                        "a higher leader epoch at startup — if one is "
                        "serving, this node starts fenced (repeatable)")
    p.add_argument("--fleet", dest="fleet", action="store_true",
                   default=None,
                   help="(not ported yet: raises NotImplementedError) "
                        "read-replica fleet mode: start the witness feed "
                        "server, route gateway reads over a consistent-"
                        "hash replica ring with health-driven draining, "
                        "and expose the fleet_* admin methods (implies "
                        "--rpc-gateway; fleet/)")
    p.add_argument("--feed-port", dest="feed_port", type=int, default=0,
                   help="witness feed TCP port (0 = ephemeral)")
    p.add_argument("--fleet-max-lag", dest="fleet_max_lag", type=int,
                   default=None,
                   help="heads a replica may trail before the ring sheds "
                        "it (default 4)")
    p.add_argument("--datadir", default=None)
    p.add_argument("--genesis", default=None)
    p.add_argument("--dev", action="store_true")
    p.add_argument("--block-time", type=int, default=2)
    p.add_argument("--http-port", type=int, default=8545)
    p.add_argument("--authrpc-port", type=int, default=8551)
    p.add_argument("--ws-port", type=int, default=None,
                   help="WebSocket RPC port (omit to disable)")
    p.add_argument("--enable-admin", action="store_true",
                   help="expose the admin_ namespace (node control)")
    p.add_argument("--ipc-path", default=None,
                   help="Unix-socket RPC path (omit to disable)")
    p.add_argument("--authrpc-jwtsecret", default=None,
                   help="path to the 32-byte hex JWT secret for the engine "
                        "port (default: <datadir>/jwt.hex, created if absent)")
    p.add_argument("--port", type=int, default=30303, help="RLPx TCP port")
    p.add_argument("--addr", default="127.0.0.1",
                   help="P2P bind/advertise address (0.0.0.0 for all)")
    p.add_argument("--disable-p2p", action="store_true")
    p.add_argument("--no-discovery", action="store_true")
    p.add_argument("--bootnodes", default="", help="comma-separated enode urls")
    p.add_argument("--bootnodes-v5", default="", dest="bootnodes_v5",
                   help="comma-separated enr:... records (discv5)")
    p.add_argument("--nat", default="any",
                   help="NAT resolution: any | none | extip:<ip> | upnp | natpmp")
    add_db_arg(p)
    p.add_argument("--ethstats", default=None,
                   help="report to an ethstats server (node:secret@host:port)")
    add_hasher(p)
    p.add_argument("--sparse-workers", dest="sparse_workers", type=int,
                   default=None,
                   help="parallel sparse commit: worker count for the "
                        "live-tip finish path's RLP encode pool AND the "
                        "multiproof proof-worker pool (trie/sparse.py + "
                        "trie/proof.py). Default: RETH_TPU_SPARSE_WORKERS "
                        "or a cpu-derived value; 1 disables the pools "
                        "(the cross-trie packed hash dispatch stays on). "
                        "Also settable as [node] sparse_workers in "
                        "reth.toml")
    p.add_argument("--subtrie-levels", dest="subtrie_levels", type=int,
                   default=None,
                   help="whole-subtrie fused tree-hash kernels "
                        "(ops/fused_commit.py SubtrieFusedEngine): commit "
                        "k packed trie levels per device dispatch — the "
                        "depth loop runs INSIDE one cooperative kernel launch with "
                        "the resident digest buffer as the carry, so "
                        "dispatches per block drop from O(depth) to "
                        "O(depth/k). Applies to the turbo rebuild, the "
                        "parallel sparse finish, and hash-service window "
                        "requests; un-warm k-shapes route to the "
                        "per-level path, and failures replay per-level "
                        "then on the CPU twin, roots bit-identical "
                        "(RETH_TPU_FAULT_SUBTRIE_{WEDGE,ABORT} drills). "
                        "Default: RETH_TPU_SUBTRIE_LEVELS or off (0/1 = "
                        "per-level). Also [node] subtrie_levels in "
                        "reth.toml")
    p.add_argument("--parallel-exec", dest="parallel_exec",
                   action="store_true", default=False,
                   help="optimistic parallel EVM execution on the no-BAL "
                        "newPayload path (engine/optimistic.py): "
                        "Block-STM-style speculation through the native "
                        "wave core with read/write-set validation, "
                        "deterministic serial re-execution of invalidated "
                        "ranks, and async storage prefetch; receipts stay "
                        "bit-identical to the serial executor, any "
                        "scheduler error falls back to it. Speculation "
                        "width: RETH_TPU_EXEC_WORKERS (default "
                        "cpu-derived). Also settable as [node] "
                        "parallel_exec in reth.toml")
    p.add_argument("--pipeline-depth", dest="pipeline_depth", type=int,
                   default=None, metavar="N",
                   help="cross-block import pipeline depth "
                        "(engine/block_pipeline.py): 2 = start optimistic "
                        "execution of payload N+1 over block N's frozen "
                        "commit window while N's fused state-root "
                        "dispatches run, with speculative prewarm + "
                        "multiproof prefetch on a double-buffered hash "
                        "sub-mesh lease; adoption re-runs every consensus "
                        "and root check, so results stay bit-identical to "
                        "serial imports, and fcU reorgs / invalid parents "
                        "abort the speculation through the cooperative "
                        "cancellation ladder. 1 = strictly serial "
                        "(default). Env fallback: RETH_TPU_PIPELINE_DEPTH. "
                        "Also settable as [node] pipeline_depth in "
                        "reth.toml")
    p.add_argument("--continuous-build", dest="continuous_build",
                   action="store_true", default=False,
                   help="standing block producer (payload/producer.py): "
                        "stream the pool's best transactions into a hot "
                        "candidate payload refreshed incrementally on pool "
                        "events and head changes — only ranks a pool delta "
                        "or new head invalidates re-execute, and with "
                        "--pipeline-depth 2 the N+1 candidate builds over "
                        "block N's commit window while N's root dispatches "
                        "run. getPayload / dev mining seal the candidate "
                        "(inclusion set bit-identical to the one-shot "
                        "serial greedy builder) instead of building from "
                        "scratch. producer_status reports the candidate. "
                        "Also settable as [node] continuous_build in "
                        "reth.toml")
    p.add_argument("--hot-state", dest="hot_state", action="store_true",
                   default=False,
                   help="hot-state plane (trie/hot_cache.py): cross-block "
                        "trie-node cache shared across forks — sparse "
                        "root tasks reveal from it before fetching "
                        "proofs, every entry is keccak-validated at "
                        "lookup — plus a device-resident digest arena "
                        "(ops/fused_commit.py) that keeps subtree digest "
                        "rows on the accelerator across blocks so sparse "
                        "finishes upload only dirty rows; roots stay "
                        "bit-identical, any arena fault evicts and "
                        "reruns the full-upload path. Invalidated on "
                        "deep reorgs/storms. Env fallback: "
                        "RETH_TPU_HOT_STATE. Also settable as [node] "
                        "hot_state in reth.toml")
    p.add_argument("--rpc-gateway", dest="rpc_gateway", action="store_true",
                   default=False,
                   help="route every RPC transport (HTTP/WS/IPC + the "
                        "engine port) through the serving gateway "
                        "(rpc/gateway.py): per-class admission control "
                        "with priority engine > eth-read > tx-submit > "
                        "debug and bounded queues (-32005 shedding when "
                        "full), in-flight coalescing of identical reads, "
                        "and a head-invalidated response cache. Also "
                        "settable as [rpc] gateway in reth.toml — see "
                        "RETH_TPU_FAULT_GATEWAY_* drill knobs")
    p.add_argument("--trace-blocks", dest="trace_blocks", action="store_true",
                   default=None,
                   help="block-lifecycle tracing (tracing.py): a trace "
                        "context (trace_id = block hash) propagated across "
                        "every queue/pool handoff yields a per-block span "
                        "timeline — gateway admission, prewarm, execution, "
                        "sparse commit, hash-service queue-wait vs "
                        "dispatch — exported as Chrome-trace JSON under "
                        "<datadir>/traces (open in Perfetto), plus the "
                        "debug_blockTimeline / debug_flightRecorder RPCs "
                        "and a per-block wall-budget events line. Also "
                        "RETH_TPU_TRACE=1 or [node] trace_blocks in "
                        "reth.toml")
    p.add_argument("--trace-file", dest="trace_file", default=None,
                   help="Chrome-trace output path override for "
                        "--trace-blocks (default <datadir>/traces/"
                        "blocks.trace.json)")
    p.add_argument("--health", dest="health", action="store_true",
                   default=False,
                   help="(not ported yet: raises NotImplementedError) "
                        "node health & SLO engine (health.py): sample "
                        "every metric into bounded ring buffers and "
                        "evaluate the burn-rate SLO rule table (block "
                        "import wall, hash-service per-lane p99 wait, "
                        "gateway shed/cache rates, sparse finish wall, "
                        "exec conflict/fallback rate, warm-up failures, "
                        "breaker state); breaches flip the component to "
                        "degraded/failing, dump the flight recorder, "
                        "and surface at GET /health and the "
                        "debug_healthCheck / debug_sloStatus / "
                        "debug_metricsHistory RPCs. Also [node] health "
                        "in reth.toml; RETH_TPU_FAULT_SLO_BREACH drills "
                        "a forced breach")
    p.add_argument("--slo-interval", dest="slo_interval", type=float,
                   default=1.0,
                   help="seconds between health sampler/evaluator "
                        "passes (default 1.0; also RETH_TPU_SLO_INTERVAL "
                        "/ [node] slo_interval)")
    p.add_argument("--slo-window", dest="slo_window", type=int,
                   default=300,
                   help="retained ring-buffer samples per metric series "
                        "(default 300 = 5 min at 1 Hz; also "
                        "RETH_TPU_SLO_WINDOW / [node] slo_window)")
    p.add_argument("--wal", dest="wal", action="store_true", default=None,
                   help="write-ahead log for the memdb store (default ON "
                        "with a datadir): every commit fsync-appends its "
                        "table delta to <datadir>/wal/<gen>.wal before "
                        "publish, checkpoints (image + fsync'd manifest) "
                        "truncate the log — a kill -9 loses at most "
                        "persistence_threshold blocks. Also [node] wal / "
                        "RETH_TPU_WAL; the native/paged engines carry "
                        "their own durability")
    p.add_argument("--no-wal", dest="wal", action="store_false",
                   help="disable the memdb write-ahead log (durability "
                        "falls back to image flushes at each persistence "
                        "advance)")
    p.add_argument("--wal-checkpoint-blocks", dest="wal_checkpoint_blocks",
                   type=int, default=8,
                   help="persisted blocks between WAL checkpoints "
                        "(default 8; also [node] wal_checkpoint_blocks)")
    p.add_argument("--no-recovery-verify", dest="recovery_verify_root",
                   action="store_false", default=True,
                   help="skip the startup recovery's full state-root "
                        "recomputation through the committer (large "
                        "datadirs trade the proof for boot time; also "
                        "RETH_TPU_RECOVERY_VERIFY=0)")
    p.add_argument("--invalid-cache-size", dest="invalid_cache_size",
                   type=int, default=None,
                   help="bound of the engine tree's invalid-header LRU "
                        "(default 512): an invalid-payload flood plateaus "
                        "here instead of leaking memory. Also "
                        "RETH_TPU_INVALID_CACHE / [node] invalid_cache_size")
    p.set_defaults(fn=cmd_node)

    p = sub.add_parser("dump-genesis", help="print the dev genesis JSON")
    p.set_defaults(fn=cmd_dump_genesis)

    p = sub.add_parser("prune", help="prune history per the config's targets")
    p.add_argument("--datadir", required=True)
    p.add_argument("--config", default=None, help="reth.toml path")
    add_db_arg(p)
    p.set_defaults(fn=cmd_prune)

    p = sub.add_parser("re-execute",
                       help="re-run blocks against historical state and "
                            "compare receipts/gas")
    p.add_argument("--datadir", required=True)
    p.add_argument("--from", dest="from_block", type=int, default=None)
    p.add_argument("--to", dest="to_block", type=int, default=None)
    add_db_arg(p)
    p.set_defaults(fn=cmd_re_execute)

    p = sub.add_parser("p2p", help="fetch a header/body from a peer")
    p.add_argument("what", choices=["header", "body"])
    p.add_argument("id", help="block number, or 0x hash")
    p.add_argument("--enode", required=True)
    p.add_argument("--chain-id", dest="chain_id", type=int, default=1)
    p.add_argument("--genesis-hash", dest="genesis_hash", default=None)
    p.set_defaults(fn=cmd_p2p)

    p = sub.add_parser("db", help="database tools")
    dbsub = p.add_subparsers(dest="db_command", required=True)

    def add_db_args(sp):
        sp.add_argument("--datadir", required=True)
        add_db_arg(sp)

    ps = dbsub.add_parser("stats")
    add_db_args(ps)
    ps.set_defaults(fn=cmd_db_stats)
    pv = dbsub.add_parser("verify-trie")
    add_db_args(pv)
    add_hasher(pv)
    pv.set_defaults(fn=cmd_db_verify_trie)
    pg = dbsub.add_parser("get", help="print one table entry")
    add_db_args(pg)
    pg.add_argument("table")
    pg.add_argument("key")
    pg.add_argument("--subkey", default=None)
    pg.set_defaults(fn=cmd_db_get)
    pl = dbsub.add_parser("list", help="list table entries")
    add_db_args(pl)
    pl.add_argument("table")
    pl.add_argument("--start", default=None)
    pl.add_argument("--limit", type=int, default=20)
    pl.add_argument("--value-bytes", dest="value_bytes", type=int, default=32)
    pl.set_defaults(fn=cmd_db_list)
    pd = dbsub.add_parser("diff", help="compare two databases")
    add_db_args(pd)
    pd.add_argument("other", help="second datadir")
    pd.add_argument("--table", default=None, help="comma-separated subset")
    pd.add_argument("--limit", type=int, default=10)
    pd.set_defaults(fn=cmd_db_diff)
    pr2 = dbsub.add_parser("repair-trie", help="rebuild trie tables from hashed state")
    add_db_args(pr2)
    add_hasher(pr2)
    pr2.set_defaults(fn=cmd_db_repair_trie)

    p = sub.add_parser("init-state",
                       help="initialise from a state dump at a block")
    p.add_argument("state", help="state dump JSON")
    p.add_argument("--datadir", required=True)
    add_db_arg(p)
    add_hasher(p)
    p.set_defaults(fn=cmd_init_state)

    p = sub.add_parser("test-vectors", help="generate codec test vectors")
    p.add_argument("--count", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_test_vectors)

    p = sub.add_parser("bb-bench",
                       help="big-block execution benchmark (reth-bb analogue)")
    p.add_argument("--transfers", type=int, default=400)
    p.add_argument("--stores", type=int, default=100)
    p.set_defaults(fn=cmd_bb_bench)

    p = sub.add_parser("config", help="print the effective config")
    p.add_argument("--config", default=None)
    p.set_defaults(fn=cmd_config)

    p = sub.add_parser("stage", help="run a single stage")
    stsub = p.add_subparsers(dest="stage_command", required=True)
    pr = stsub.add_parser("run")
    pr.add_argument("--datadir", required=True)
    pr.add_argument("--stage", default="all")
    pr.add_argument("--to", type=int, default=None)
    add_hasher(pr)
    add_db_arg(pr)
    pr.set_defaults(fn=cmd_stage_run)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
