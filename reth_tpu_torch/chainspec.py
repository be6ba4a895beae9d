"""Chain specification: hardfork activation schedule + EIP-2124 fork IDs.

A copy of the JAX package's ``chainspec.py``.

Reference analogue: crates/chainspec/src/spec.rs (`ChainSpec` with its
ordered `ChainHardforks`), crates/ethereum/hardforks/src/hardfork/ethereum.rs
(`EthereumHardfork` + the mainnet activation table), and the ForkId /
ForkFilter machinery the reference pulls from alloy (EIP-2124): the CRC32
rolling fork hash that lets two peers reject each other during the Status
handshake before wasting a sync on an incompatible chain.

Activation conditions come in three shapes, exactly as the reference
models them: block number (pre-merge), total terminal difficulty (the
merge itself), and timestamp (post-merge). TTD forks are EXCLUDED from
the fork-id checksum per EIP-2124; timestamp forks follow all block forks.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field

# Ordered oldest -> newest. Order matters: spec_at() returns the last
# active entry, and fork-id folds activations in this order.
FRONTIER = "frontier"
HOMESTEAD = "homestead"
DAO = "dao"
TANGERINE = "tangerine"
SPURIOUS_DRAGON = "spurious_dragon"
BYZANTIUM = "byzantium"
CONSTANTINOPLE = "constantinople"
PETERSBURG = "petersburg"
ISTANBUL = "istanbul"
MUIR_GLACIER = "muir_glacier"
BERLIN = "berlin"
LONDON = "london"
ARROW_GLACIER = "arrow_glacier"
GRAY_GLACIER = "gray_glacier"
PARIS = "paris"
SHANGHAI = "shanghai"
CANCUN = "cancun"
PRAGUE = "prague"
OSAKA = "osaka"

HARDFORK_ORDER = [
    FRONTIER, HOMESTEAD, DAO, TANGERINE, SPURIOUS_DRAGON, BYZANTIUM,
    CONSTANTINOPLE, PETERSBURG, ISTANBUL, MUIR_GLACIER, BERLIN, LONDON,
    ARROW_GLACIER, GRAY_GLACIER, PARIS, SHANGHAI, CANCUN, PRAGUE, OSAKA,
]


@dataclass(frozen=True)
class BlobParams:
    """EIP-4844 fee-market parameters for one fork (reference
    `BlobScheduleItem`, crates/chainspec — geth-genesis ``blobSchedule``)."""

    target: int
    max: int
    update_fraction: int

    @property
    def target_gas(self) -> int:
        return self.target * (1 << 17)

    @property
    def max_gas(self) -> int:
        return self.max * (1 << 17)


@dataclass(frozen=True)
class ForkCondition:
    """When a hardfork activates (reference `ForkCondition`, one of
    Block / Timestamp / TTD / Never)."""

    block: int | None = None
    timestamp: int | None = None
    ttd: int | None = None  # merge-style: active once total difficulty >= ttd
    never: bool = False
    # a TTD fork's block number folds into the EIP-2124 fork hash ONLY when
    # it was scheduled as an explicit netsplit block (testnets set
    # mergeNetsplitBlock); mainnet's organic merge block does NOT fold
    merge_netsplit: bool = False

    def active_at(self, number: int, timestamp: int,
                  total_difficulty: int | None = None) -> bool:
        if self.never:
            return False
        if self.ttd is not None:
            # merge fork: resolved by the recorded activation block when the
            # merge already happened (mainnet: 15537394), by live TD when a
            # TD oracle is tracking it, and at-genesis when ttd == 0
            if self.block is not None:
                return number >= self.block
            if total_difficulty is not None:
                return total_difficulty >= self.ttd
            return self.ttd == 0
        if self.block is not None:
            return number >= self.block
        if self.timestamp is not None:
            return timestamp >= self.timestamp
        return False


@dataclass
class ChainSpec:
    """Chain id + genesis + the ordered hardfork schedule."""

    chain_id: int = 1
    hardforks: dict[str, ForkCondition] = field(default_factory=dict)
    genesis_hash: bytes = b"\x00" * 32
    deposit_contract: bytes | None = None
    # per-fork EIP-4844 parameter overrides (geth-genesis blobSchedule)
    blob_schedule: dict[str, BlobParams] = field(default_factory=dict)
    # True when the schedule was synthesized for a dev chain (bare genesis
    # config): fork queries work, but execution/validation must NOT pin
    # header shapes on it — dev chains keep the repo's legacy dev format
    dev: bool = False

    @property
    def execution_spec(self) -> "ChainSpec | None":
        """The chainspec to thread into executors/validators: None for a
        synthesized dev schedule (legacy post-merge defaults apply)."""
        return None if self.dev else self

    # -- activation queries ------------------------------------------------
    def is_active(self, fork: str, number: int, timestamp: int = 0) -> bool:
        cond = self.hardforks.get(fork)
        return cond is not None and cond.active_at(number, timestamp)

    def spec_at(self, number: int, timestamp: int = 0) -> str:
        """Latest active hardfork name at (number, timestamp)."""
        current = FRONTIER
        for name in HARDFORK_ORDER:
            if self.is_active(name, number, timestamp):
                current = name
        return current

    def is_at_least(self, fork: str, number: int, timestamp: int = 0) -> bool:
        active = self.spec_at(number, timestamp)
        return HARDFORK_ORDER.index(active) >= HARDFORK_ORDER.index(fork)

    # -- EIP-2124 fork id --------------------------------------------------
    def _fork_activations(self) -> list[int]:
        """Deduped, ordered activation values folded into the fork hash:
        block-gated forks by block, then timestamp-gated forks. TTD forks
        are skipped, as are genesis activations (value 0)."""
        blocks, times = [], []
        for name in HARDFORK_ORDER:
            cond = self.hardforks.get(name)
            if cond is None or cond.never:
                continue
            if cond.ttd is not None and not cond.merge_netsplit:
                continue  # EIP-2124: TTD forks don't fold into the hash
            if cond.block is not None and cond.block > 0:
                blocks.append(cond.block)
            elif cond.timestamp is not None and cond.timestamp > 0:
                times.append(cond.timestamp)
        out: list[int] = []
        for v in sorted(blocks) + sorted(times):
            if not out or out[-1] != v:
                out.append(v)
        return out

    def fork_id(self, head_number: int, head_timestamp: int = 0) -> tuple[bytes, int]:
        """(FORK_HASH, FORK_NEXT) for the eth Status handshake."""
        crc = zlib.crc32(self.genesis_hash)
        activations = self._fork_activations()
        for v in activations:
            # block forks compare against head number, time forks against
            # head timestamp; a fork value larger than a sane block count
            # is a timestamp (same heuristic the ecosystem uses: mainnet
            # timestamps dwarf any block height)
            head = head_timestamp if v > 1_000_000_000 else head_number
            if head < v:
                return crc.to_bytes(4, "big"), v
            crc = zlib.crc32(v.to_bytes(8, "big"), crc)
        return crc.to_bytes(4, "big"), 0

    def validate_fork_id(self, remote: tuple[bytes, int], head_number: int,
                         head_timestamp: int = 0) -> None:
        """EIP-2124 ForkFilter: raise ValueError on incompatible remote."""
        remote_hash, remote_next = remote
        activations = self._fork_activations()
        # rolling checksum at every fork boundary, genesis first
        sums = [zlib.crc32(self.genesis_hash)]
        for v in activations:
            sums.append(zlib.crc32(v.to_bytes(8, "big"), sums[-1]))
        checksums = [s.to_bytes(4, "big") for s in sums]
        local_hash, _ = self.fork_id(head_number, head_timestamp)
        if remote_hash == local_hash:
            # same fork: reject if remote announces a next fork we already
            # passed locally without it being in our schedule (remote stale)
            if remote_next != 0:
                head = head_timestamp if remote_next > 1_000_000_000 else head_number
                if head >= remote_next and remote_next not in activations:
                    raise ValueError("remote announces fork we passed without activating")
            return
        if remote_hash in checksums:
            li = checksums.index(local_hash)
            ri = checksums.index(remote_hash)
            if ri > li:
                return  # remote is ahead on OUR schedule: we're the stale one
            # remote is behind us: it must announce the next fork we know
            # follows its head (it will upgrade in time)
            if ri < len(activations) and remote_next == activations[ri]:
                return
            raise ValueError("remote is on an old fork and not announcing the upgrade")
        raise ValueError("incompatible fork id (different chain history)")

    # -- persistence (Metadata table: a node restarted from a datadir must
    # rebuild the same spec without the genesis file) ----------------------
    def to_json(self) -> str:
        import json

        forks = {}
        for name, c in self.hardforks.items():
            forks[name] = {k: v for k, v in (
                ("block", c.block), ("timestamp", c.timestamp), ("ttd", c.ttd),
                ("never", c.never or None),
                ("merge_netsplit", c.merge_netsplit or None)) if v is not None}
        doc = {"chain_id": self.chain_id,
               "genesis_hash": self.genesis_hash.hex(),
               "hardforks": forks}
        if self.dev:
            doc["dev"] = True
        if self.blob_schedule:
            doc["blob_schedule"] = {
                name: {"target": p.target, "max": p.max,
                       "baseFeeUpdateFraction": p.update_fraction}
                for name, p in self.blob_schedule.items()}
        return json.dumps(doc)

    @classmethod
    def from_json(cls, text: str) -> "ChainSpec":
        import json

        d = json.loads(text)
        forks = {name: ForkCondition(
            block=f.get("block"), timestamp=f.get("timestamp"),
            ttd=f.get("ttd"), never=f.get("never", False),
            merge_netsplit=f.get("merge_netsplit", False))
            for name, f in d["hardforks"].items()}
        return cls(chain_id=d["chain_id"],
                   hardforks={n: forks[n] for n in HARDFORK_ORDER if n in forks},
                   genesis_hash=bytes.fromhex(d["genesis_hash"]),
                   blob_schedule=_parse_blob_schedule(d.get("blob_schedule")),
                   # round-4 datadirs persisted bare dev configs as a
                   # frontier-only schedule: treat those as dev too
                   dev=d.get("dev", len(d.get("hardforks", {})) <= 1))

    # -- construction ------------------------------------------------------
    @staticmethod
    def config_has_forks(config: dict) -> bool:
        """True when the geth-genesis config stanza carries an explicit
        hardfork schedule (any fork key or a TTD)."""
        keys = ("terminalTotalDifficulty", "homesteadBlock", "eip150Block",
                "eip155Block", "eip158Block", "byzantiumBlock",
                "constantinopleBlock", "petersburgBlock", "istanbulBlock",
                "berlinBlock", "londonBlock", "shanghaiTime", "cancunTime",
                "pragueTime", "osakaTime")
        return any(k in config for k in keys)

    @classmethod
    def from_genesis_config(cls, config: dict, genesis_hash: bytes = b"\x00" * 32,
                            chain_id: int | None = None) -> "ChainSpec":
        """Build from a geth-genesis `config` stanza (reference
        crates/chainspec/src/spec.rs `from_genesis`). A stanza with no
        fork schedule at all means a dev chain: everything active at
        genesis (geth's --dev does the same)."""
        if not cls.config_has_forks(config):
            spec = dev_spec(chain_id=chain_id or int(config.get("chainId", 1)),
                            genesis_hash=genesis_hash)
            spec.blob_schedule = _parse_blob_schedule(config.get("blobSchedule"))
            spec.dev = True
            return spec
        keymap_block = {
            "homesteadBlock": HOMESTEAD, "daoForkBlock": DAO,
            "eip150Block": TANGERINE, "eip155Block": SPURIOUS_DRAGON,
            "eip158Block": SPURIOUS_DRAGON, "byzantiumBlock": BYZANTIUM,
            "constantinopleBlock": CONSTANTINOPLE, "petersburgBlock": PETERSBURG,
            "istanbulBlock": ISTANBUL, "muirGlacierBlock": MUIR_GLACIER,
            "berlinBlock": BERLIN, "londonBlock": LONDON,
            "arrowGlacierBlock": ARROW_GLACIER, "grayGlacierBlock": GRAY_GLACIER,
        }
        keymap_time = {
            "shanghaiTime": SHANGHAI, "cancunTime": CANCUN,
            "pragueTime": PRAGUE, "osakaTime": OSAKA,
        }
        forks: dict[str, ForkCondition] = {FRONTIER: ForkCondition(block=0)}
        for key, name in keymap_block.items():
            if key in config and config[key] is not None:
                if name not in forks or forks[name].block is None \
                        or config[key] < forks[name].block:
                    forks[name] = ForkCondition(block=int(config[key]))
        if "terminalTotalDifficulty" in config:
            merge_block = config.get("mergeNetsplitBlock")
            forks[PARIS] = ForkCondition(
                ttd=int(config["terminalTotalDifficulty"]),
                block=int(merge_block) if merge_block is not None else None,
                merge_netsplit=merge_block is not None)
        for key, name in keymap_time.items():
            if key in config and config[key] is not None:
                forks[name] = ForkCondition(timestamp=int(config[key]))
        ordered = {n: forks[n] for n in HARDFORK_ORDER if n in forks}
        return cls(chain_id=chain_id or int(config.get("chainId", 1)),
                   hardforks=ordered, genesis_hash=genesis_hash,
                   blob_schedule=_parse_blob_schedule(config.get("blobSchedule")))


def _parse_blob_schedule(raw: dict | None) -> dict[str, BlobParams]:
    """geth-genesis ``blobSchedule`` stanza → {fork name: BlobParams}."""
    out: dict[str, BlobParams] = {}
    for fork, p in (raw or {}).items():
        fork = fork.lower()
        if fork in HARDFORK_ORDER:
            out[fork] = BlobParams(
                target=int(p["target"]), max=int(p["max"]),
                update_fraction=int(p.get("baseFeeUpdateFraction")
                                    or p.get("update_fraction")))
    return out


def _mainnet_forks() -> dict[str, ForkCondition]:
    b, t = (lambda n: ForkCondition(block=n)), (lambda s: ForkCondition(timestamp=s))
    return {
        FRONTIER: b(0), HOMESTEAD: b(1_150_000), DAO: b(1_920_000),
        TANGERINE: b(2_463_000), SPURIOUS_DRAGON: b(2_675_000),
        BYZANTIUM: b(4_370_000), CONSTANTINOPLE: b(7_280_000),
        PETERSBURG: b(7_280_000), ISTANBUL: b(9_069_000),
        MUIR_GLACIER: b(9_200_000), BERLIN: b(12_244_000),
        LONDON: b(12_965_000), ARROW_GLACIER: b(13_773_000),
        GRAY_GLACIER: b(15_050_000),
        PARIS: ForkCondition(ttd=58_750_000_000_000_000_000_000, block=15_537_394),
        SHANGHAI: t(1_681_338_455), CANCUN: t(1_710_338_135),
        PRAGUE: t(1_746_612_311),
    }


MAINNET_GENESIS_HASH = bytes.fromhex(
    "d4e56740f876aef8c010b86a40d5f56745a118d0906a34e69aec8c0db1cb8fa3")

MAINNET = ChainSpec(chain_id=1, hardforks=_mainnet_forks(),
                    genesis_hash=MAINNET_GENESIS_HASH)


def dev_spec(chain_id: int = 1337, genesis_hash: bytes = b"\x00" * 32) -> ChainSpec:
    """Everything active at genesis (reference `DEV` chainspec)."""
    return ChainSpec(
        chain_id=chain_id, genesis_hash=genesis_hash,
        hardforks={n: ForkCondition(block=0) for n in HARDFORK_ORDER
                   if n not in (PARIS, OSAKA)}
                  | {PARIS: ForkCondition(ttd=0)},
    )


def pinned_spec(fork: str, chain_id: int = 1,
                genesis_hash: bytes = b"\x00" * 32) -> ChainSpec:
    """A chain frozen at ``fork``: every hardfork up to and including it
    active at genesis, nothing after (ef-tests network names pin forks
    this way — reference testing/ef-tests `ForkSpec`)."""
    idx = HARDFORK_ORDER.index(fork)
    active = HARDFORK_ORDER[: idx + 1]
    forks = {n: ForkCondition(block=0) for n in active if n != PARIS}
    if PARIS in active:
        forks[PARIS] = ForkCondition(ttd=0)
    return ChainSpec(chain_id=chain_id, hardforks=forks,
                     genesis_hash=genesis_hash)


# ef-tests network label -> hardfork name (reference ForkSpec parsing)
NETWORK_TO_FORK = {
    "Frontier": FRONTIER, "Homestead": HOMESTEAD,
    "EIP150": TANGERINE, "Tangerine": TANGERINE,
    "EIP158": SPURIOUS_DRAGON, "SpuriousDragon": SPURIOUS_DRAGON,
    "Byzantium": BYZANTIUM, "Constantinople": CONSTANTINOPLE,
    "ConstantinopleFix": PETERSBURG, "Petersburg": PETERSBURG,
    "Istanbul": ISTANBUL, "MuirGlacier": MUIR_GLACIER, "Berlin": BERLIN,
    "London": LONDON, "ArrowGlacier": ARROW_GLACIER,
    "GrayGlacier": GRAY_GLACIER, "Merge": PARIS, "Paris": PARIS,
    "Shanghai": SHANGHAI, "Cancun": CANCUN, "Prague": PRAGUE,
    "Osaka": OSAKA,
}
