"""TOML node configuration (reth.toml analogue).

A copy of the JAX package's ``config.py``. ``hasher = "device"`` (the
default) means the card: the kernels of ``ops/csrc`` through the compiled
kernel libraries.

Reference analogue: crates/config — `reth.toml` with per-stage
thresholds (`StageConfig`/`MerkleConfig`, src/config.rs:22-537) and
prune settings. Read with stdlib tomllib; flags override file values.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from .prune import PruneMode, PruneModes

try:  # stdlib since 3.11; keep 3.10 importable (the mini parser below
    import tomllib  # covers this file's flat table/int/str/bool schema)
except ModuleNotFoundError:  # pragma: no cover - version-dependent
    tomllib = None


def _mini_toml(text: str) -> dict:
    """Fallback parser for the subset reth.toml actually uses: ``[a.b]``
    tables, int/float/bool/quoted-string values, ``#`` comments, and
    single-line inline tables (``k = { distance = 100 }``)."""

    def _value(raw: str):
        raw = raw.strip()
        if raw.startswith("{") and raw.endswith("}"):
            out = {}
            body = raw[1:-1].strip()
            for part in filter(None, (p.strip() for p in body.split(","))):
                k, _, v = part.partition("=")
                out[k.strip()] = _value(v)
            return out
        if len(raw) >= 2 and raw[0] == raw[-1] and raw[0] in "\"'":
            return raw[1:-1]
        if raw in ("true", "false"):
            return raw == "true"
        try:
            return int(raw)
        except ValueError:
            return float(raw)

    root: dict = {}
    table = root
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        if line.startswith("[") and line.endswith("]"):
            table = root
            for part in line[1:-1].split("."):
                table = table.setdefault(part.strip(), {})
            continue
        key, sep, raw = line.partition("=")
        if not sep:
            raise ValueError(f"unparseable TOML line: {line!r}")
        table[key.strip()] = _value(raw)
    return root


def _parse_toml(text: str) -> dict:
    if tomllib is not None:
        return tomllib.loads(text)
    return _mini_toml(text)


@dataclass
class MerkleConfig:
    # reference: rebuild_threshold=100_000, incremental_threshold=7_000
    rebuild_threshold: int = 50_000
    incremental_threshold: int = 7_000


@dataclass
class HashingConfig:
    clean_threshold: int = 100_000


@dataclass
class ExecutionConfig:
    max_blocks_per_commit: int = 1000


@dataclass
class StageConfig:
    merkle: MerkleConfig = field(default_factory=MerkleConfig)
    account_hashing: HashingConfig = field(default_factory=HashingConfig)
    storage_hashing: HashingConfig = field(default_factory=HashingConfig)
    execution: ExecutionConfig = field(default_factory=ExecutionConfig)


@dataclass
class RpcConfig:
    # route every transport's dispatch through the serving gateway
    # (rpc/gateway.py): admission control with priority classes,
    # in-flight coalescing of identical reads, and a head-invalidated
    # response cache (--rpc-gateway CLI equivalent)
    gateway: bool = False
    # response-cache capacity in entries (0 disables the cache while
    # keeping admission + coalescing on)
    gateway_cache: int = 1024


@dataclass
class RethTpuConfig:
    stages: StageConfig = field(default_factory=StageConfig)
    prune: PruneModes = field(default_factory=PruneModes)
    rpc: RpcConfig = field(default_factory=RpcConfig)
    persistence_threshold: int = 2
    hasher: str = "device"  # device (the card) | cpu | auto (supervised card)
    # multiplex every keccak client over the shared background hash
    # service (ops/hash_service.py): priority lanes + continuous batching
    hash_service: bool = False
    # device mesh width (--mesh CLI / RETH_TPU_MESH env equivalent): the
    # hash service + turbo committers then shard coalesced dispatches and
    # fused level windows over this many devices (parallel/mesh.py),
    # with sub-mesh rebuild leases and per-device circuit breakers.
    # 0/1 = single-device (the mesh layer stays off)
    mesh_devices: int = 0
    # device warm-up manager (--warmup CLI equivalent, ops/warmup.py):
    # "off" | "background" (serve degraded on the CPU twin while the shape
    # menu AOT-compiles, promoting shapes as they warm) | "block" (finish
    # warm-up before serving)
    warmup: str = "off"
    # persistent cache of the compiled kernel libraries for warm-up
    # (versioned by kernel-source digest, probe-verified before enabling;
    # corrupt entries quarantined + rebuilt). Empty =
    # <datadir>/compile-cache when warm-up is on (--compile-cache-dir CLI
    # equivalent)
    compile_cache_dir: str = ""
    # parallel sparse commit: width of the live-tip finish path's RLP
    # encode pool AND the proof-worker pool (trie/sparse.py +
    # trie/proof.py). 0 = auto (env RETH_TPU_SPARSE_WORKERS or
    # cpu-derived); 1 = pools off, cross-trie packed dispatch stays on
    sparse_workers: int = 0
    # whole-subtrie fused kernels (--subtrie-levels CLI / env
    # RETH_TPU_SUBTRIE_LEVELS): k > 1 collapses the committers' per-depth
    # device dispatch loop into ONE dispatch per k packed levels
    # (ops/fused_commit.SubtrieFusedEngine — the depth loop runs inside
    # one cooperative kernel launch, digest buffer as the carry). 0/1 =
    # per-level
    subtrie_levels: int = 0
    # optimistic parallel EVM execution on the no-BAL newPayload path
    # (--parallel-exec CLI equivalent): Block-STM-style speculation with
    # read/write-set validation, async storage prefetch, and serial
    # fallback (engine/optimistic.py). Speculation width comes from
    # RETH_TPU_EXEC_WORKERS (default cpu-derived).
    parallel_exec: bool = False
    # cross-block import pipeline depth (--pipeline-depth CLI
    # equivalent, engine/block_pipeline.py): 2 = execute block N+1 over
    # N's frozen commit window while N's fused root dispatches run;
    # 1 = strictly serial imports. Env RETH_TPU_PIPELINE_DEPTH is the
    # fallback when unset.
    pipeline_depth: int = 1
    # standing block producer (--continuous-build CLI equivalent,
    # payload/producer.py): hot candidate payload incrementally
    # refreshed on pool events and head changes; getPayload / dev
    # mining seal it instead of building from scratch
    continuous_build: bool = False
    # hot-state plane (--hot-state CLI equivalent, trie/hot_cache.py):
    # cross-block trie-node cache feeding sparse reveals without proof
    # fetches + device-resident digest arena with delta uploads
    # (ops/fused_commit.py); env RETH_TPU_HOT_STATE is the fallback
    hot_state: bool = False
    # block-lifecycle tracing (--trace-blocks CLI equivalent): record
    # per-block span timelines, export Chrome-trace JSON under the
    # datadir, and point flight-recorder dumps there (tracing.py)
    trace_blocks: bool = False
    # node health & SLO engine (--health CLI equivalent, health.py):
    # metric time-series retention + burn-rate SLO evaluation over the
    # default rule table, served at /health and the debug health RPCs
    health: bool = False
    # seconds between health sampler/evaluator passes (<= 0 disables the
    # background thread; also RETH_TPU_SLO_INTERVAL)
    slo_interval: float = 1.0
    # ring-buffer samples retained per metric series (5 min at the
    # default 1 Hz; also RETH_TPU_SLO_WINDOW)
    slo_window: int = 300
    # write-ahead log for the memdb-backed stores (--wal CLI equivalent,
    # storage/wal.py): fsync'd per-commit records + checkpoint manifest,
    # so a kill -9 loses at most persistence_threshold blocks
    wal: bool = True
    # persisted blocks between WAL checkpoints (image + manifest swap +
    # log truncation; --wal-checkpoint-blocks CLI equivalent)
    wal_checkpoint_blocks: int = 8
    # verify the recovered head's state root by recomputation through
    # the committer at startup (--no-recovery-verify opts out)
    recovery_verify_root: bool = True
    # bound of the engine tree's invalid-header LRU (--invalid-cache-size
    # CLI / RETH_TPU_INVALID_CACHE env): an invalid-payload flood
    # plateaus at this many cached rejections instead of leaking memory
    invalid_cache_size: int = 512
    # read-replica fleet mode (--fleet CLI equivalent, fleet/): witness
    # feed server + consistent-hash gateway ring over registered
    # stateless replicas, with health-driven per-replica draining
    fleet: bool = False
    # witness feed TCP port (--feed-port; 0 = ephemeral)
    feed_port: int = 0
    # heads a replica may trail the node's head before the ring sheds
    # it (--fleet-max-lag)
    fleet_max_lag: int = 4


def _prune_mode(d: dict) -> PruneMode:
    return PruneMode(distance=d.get("distance"), before=d.get("before"))


def load_config(path: str | Path | None) -> RethTpuConfig:
    cfg = RethTpuConfig()
    if path is None or not Path(path).exists():
        return cfg
    raw = _parse_toml(Path(path).read_text())
    stages = raw.get("stages", {})
    if "merkle" in stages:
        cfg.stages.merkle = MerkleConfig(**stages["merkle"])
    if "account_hashing" in stages:
        cfg.stages.account_hashing = HashingConfig(**stages["account_hashing"])
    if "storage_hashing" in stages:
        cfg.stages.storage_hashing = HashingConfig(**stages["storage_hashing"])
    if "execution" in stages:
        cfg.stages.execution = ExecutionConfig(**stages["execution"])
    prune = raw.get("prune", {})
    for seg in ("sender_recovery", "receipts", "transaction_lookup",
                "account_history", "storage_history"):
        if seg in prune:
            setattr(cfg.prune, seg, _prune_mode(prune[seg]))
    node = raw.get("node", {})
    cfg.persistence_threshold = node.get("persistence_threshold", cfg.persistence_threshold)
    cfg.hasher = node.get("hasher", cfg.hasher)
    cfg.hash_service = bool(node.get("hash_service", cfg.hash_service))
    cfg.mesh_devices = int(node.get("mesh_devices", cfg.mesh_devices))
    cfg.warmup = str(node.get("warmup", cfg.warmup))
    cfg.compile_cache_dir = str(node.get("compile_cache_dir",
                                         cfg.compile_cache_dir))
    cfg.sparse_workers = int(node.get("sparse_workers", cfg.sparse_workers))
    cfg.subtrie_levels = int(node.get("subtrie_levels", cfg.subtrie_levels))
    cfg.parallel_exec = bool(node.get("parallel_exec", cfg.parallel_exec))
    cfg.pipeline_depth = int(node.get("pipeline_depth", cfg.pipeline_depth))
    cfg.continuous_build = bool(node.get("continuous_build",
                                         cfg.continuous_build))
    cfg.hot_state = bool(node.get("hot_state", cfg.hot_state))
    cfg.trace_blocks = bool(node.get("trace_blocks", cfg.trace_blocks))
    cfg.health = bool(node.get("health", cfg.health))
    cfg.slo_interval = float(node.get("slo_interval", cfg.slo_interval))
    cfg.slo_window = int(node.get("slo_window", cfg.slo_window))
    cfg.wal = bool(node.get("wal", cfg.wal))
    cfg.wal_checkpoint_blocks = int(node.get("wal_checkpoint_blocks",
                                             cfg.wal_checkpoint_blocks))
    cfg.recovery_verify_root = bool(node.get("recovery_verify_root",
                                             cfg.recovery_verify_root))
    cfg.invalid_cache_size = int(node.get("invalid_cache_size",
                                          cfg.invalid_cache_size))
    cfg.fleet = bool(node.get("fleet", cfg.fleet))
    cfg.feed_port = int(node.get("feed_port", cfg.feed_port))
    cfg.fleet_max_lag = int(node.get("fleet_max_lag", cfg.fleet_max_lag))
    rpc = raw.get("rpc", {})
    cfg.rpc.gateway = bool(rpc.get("gateway", cfg.rpc.gateway))
    cfg.rpc.gateway_cache = int(rpc.get("gateway_cache", cfg.rpc.gateway_cache))
    return cfg
