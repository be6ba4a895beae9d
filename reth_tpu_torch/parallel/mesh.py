"""The member mesh for the sharded hashing data plane.

Port of the JAX package's ``parallel/mesh.py``. The reference's mesh is a
``jax.sharding.Mesh`` with one ``data`` axis; a level of N nodes shards
N/devices a chip, and each level's digests are scattered into a REPLICATED
digest buffer, after which XLA inserts the all-gather. The port has no
``Mesh`` / ``NamedSharding`` and keeps the same plan by hand:

- **Roster and members**: :class:`HashMesh` holds a list of
  ``torch.device`` s, the roster. It may name one card more than once; each
  entry is a *member* with its own CUDA stream (a CPU member has none). A
  membership is a :class:`Mesh`: a tuple of roster indices, cached per tuple
  (``_mesh_for``), as the reference caches one jax ``Mesh`` per membership.
- **Batch-shard**: a batch is padded to a tier that is a multiple of the live
  member count (:func:`mesh_tier`) and split into equal row ranges in roster
  order (:meth:`Mesh.ranges`); each member hashes the real rows of its range
  on its stream. **Replicated**: one replica a member.
- **Health mask**: per-member alive bits, flipped by the per-member breakers
  (``ops/supervisor.py DeviceBreakerBoard``); a shed member shrinks the mesh
  and the in-flight batch replays on the survivors.
- **Sub-mesh lease** (:meth:`HashMesh.lease_submesh`): the rebuild claims k
  members from the roster's tail while the live lanes keep the head.
- **Partition-rule table** (:data:`DEFAULT_PARTITION_RULES`,
  :meth:`HashMesh.spec_for`): ``(lane/program, rows)`` decides whether a
  coalesced dispatch shards over the live members (spec ``("data",)``) or
  stays on the first live member (spec ``()``), as the reference's
  ``P(axis)`` / ``P()``.

The members' work is ordered by CUDA events (``Stream.wait_stream``), never
by host syncs: :meth:`Mesh.fork` makes every member stream wait for the
caller's stream, :meth:`Mesh.join` the caller's stream for every member.
"""

from __future__ import annotations

import contextlib
import re
import threading

import numpy as np
import torch

from .. import tracing
from ..device import resolve

# -- partition-rule table -------------------------------------------------------

# (regex over "lane/program", min rows PER MEMBER before sharding pays off;
# None = never partition). First match wins. The reference's table.
DEFAULT_PARTITION_RULES: list[tuple[str, int | None]] = [
    # fused level windows (rebuild pipeline / live sparse commit)
    (r"^(rebuild|live|payload)/fused\.", 1),
    # explicit scalar programs (single-key probes): never pay the scatter
    (r"/scalar$", None),
    # whole-subtrie k-level windows (any lane)
    (r"/fused\.subtrie$", 1),
    # coalesced keccak batches: shard once every member gets a real shard
    (r"/keccak\.", 4),
    # default: small batches stay on one member
    (r".", 8),
]


def match_partition_rule(rules, name: str, rows: int, n_devices: int) -> str:
    """``"batch"`` (shard over the mesh) or ``"single"`` (one member) for one
    dispatch, by the first rule whose pattern matches ``name``."""
    if n_devices <= 1:
        return "single"
    for pattern, min_rows in rules:
        if re.search(pattern, name):
            if min_rows is None:
                return "single"
            return "batch" if rows >= min_rows * n_devices else "single"
    return "single"


class MeshExhausted(RuntimeError):
    """Every member of the mesh is unhealthy (or leased away): the caller
    takes the next rung (the numpy twin)."""


class Mesh:
    """One membership of a :class:`HashMesh`: roster ``indices``, their
    ``devices`` and ``streams`` (None on the CPU). ``size`` is the member
    count (the reference's ``mesh.devices.size``)."""

    __slots__ = ("indices", "devices", "streams", "axis")

    def __init__(self, indices: tuple[int, ...], devices: tuple, streams: tuple, axis: str):
        self.indices = indices
        self.devices = devices
        self.streams = streams
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.indices)

    def ranges(self, n: int, shard: int | None = None) -> list[tuple[int, int]]:
        """Each member's row range of an ``n``-row batch, in roster order:
        ``shard`` rows a member (default ``ceil(n / size)``), cut at ``n``;
        a range past ``n`` is empty."""
        m = self.size
        if shard is None:
            shard = -(-n // m) if n else 0
        return [(min(j * shard, n), min((j + 1) * shard, n)) for j in range(m)]

    @contextlib.contextmanager
    def on(self, j: int):
        """Member ``j``'s stream (and card) as the current one."""
        s = self.streams[j]
        if s is None:
            yield
            return
        with torch.cuda.stream(s):
            yield

    def fork(self) -> None:
        """Every member stream waits for its card's current stream (the work
        the caller queued before, uploads and allocations among it)."""
        for d, s in zip(self.devices, self.streams):
            if s is not None:
                s.wait_stream(torch.cuda.current_stream(d))

    def join(self) -> None:
        """Each card's current stream waits for every member stream on it."""
        for d, s in zip(self.devices, self.streams):
            if s is not None:
                torch.cuda.current_stream(d).wait_stream(s)

    def keep(self, t: torch.Tensor) -> None:
        """Mark ``t`` (made on the caller's stream) as used by every member
        stream on its card, so the allocator does not reuse it early."""
        if t.device.type != "cuda":
            return
        for d, s in zip(self.devices, self.streams):
            if s is not None and d == t.device:
                t.record_stream(s)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Mesh(members={list(self.indices)})"


class _SubMeshLease:
    """k members carved out of the mesh (the rebuild claims them; the live
    lanes keep the rest). ``mesh`` is the :class:`Mesh` over the leased
    members; ``release()`` is idempotent."""

    __slots__ = ("_owner", "indices", "mesh", "what", "_released")

    def __init__(self, owner: "HashMesh", indices: tuple[int, ...], mesh: Mesh, what: str):
        self._owner = owner
        self.indices = indices
        self.mesh = mesh
        self.what = what
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._owner._release_lease(self)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"_SubMeshLease({self.what!r}, devices={list(self.indices)})"


class HashMesh:
    """The 1-axis member mesh: roster + health mask + sub-mesh lease
    accounting + the partition-rule table (see the module docstring).

    ``devices``: the roster, any list of devices (``"cuda:0"`` four times is
    a roster of four members on one card); None takes every visible card of
    ``device``'s type (one member for ``"cpu"``). Each CUDA member gets a
    stream of its own."""

    def __init__(self, devices=None, axis: str = "data", rules=None, registry=None,
                 device: str | torch.device = "cuda"):
        if devices is None:
            dev = resolve(device)
            devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                       if dev.type == "cuda" else [dev])
        devices = [resolve(d) for d in devices]
        if not devices:
            raise ValueError("HashMesh needs at least one device")
        self.axis = axis
        self.devices = devices
        self.streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None
                        for d in devices]
        self.rules = list(rules if rules is not None else DEFAULT_PARTITION_RULES)
        self._lock = threading.Lock()
        self._healthy = [True] * len(devices)
        self._leased: set[int] = set()
        self._meshes: dict[tuple[int, ...], Mesh] = {}
        from ..metrics import MeshMetrics

        self.metrics = MeshMetrics(registry)
        self.shrinks = 0
        self.recoveries = 0
        self.submesh_leases = 0
        # the full-roster membership (sharded_keccak's)
        self.mesh = self._mesh_for(tuple(range(len(devices))))
        self._publish_locked()

    @classmethod
    def build(cls, n_devices: int, device: str | torch.device = "cuda", **kw) -> "HashMesh":
        """Mesh over the first ``n_devices`` cards, clamped to the cards
        there are (a mesh larger than the topology degrades, not crashes).
        A roster that repeats a card is made only by passing one."""
        dev = resolve(device)
        avail = torch.cuda.device_count() if dev.type == "cuda" else 1
        n = max(1, min(int(n_devices), avail))
        if n < n_devices:
            tracing.event("parallel::mesh", "mesh_clamped", requested=n_devices, available=avail)
        if dev.type != "cuda":
            return cls([dev], **kw)
        return cls([torch.device("cuda", i) for i in range(n)], **kw)

    # -- topology ------------------------------------------------------------

    @property
    def n_devices(self) -> int:
        """Total roster size (healthy or not)."""
        return len(self.devices)

    @property
    def healthy_count(self) -> int:
        with self._lock:
            return sum(self._healthy)

    def is_healthy(self, idx: int) -> bool:
        with self._lock:
            return self._healthy[idx]

    def _live_indices_locked(self) -> tuple[int, ...]:
        return tuple(i for i in range(len(self.devices))
                     if self._healthy[i] and i not in self._leased)

    def _mesh_for(self, indices: tuple[int, ...]) -> Mesh:
        """The cached :class:`Mesh` of one membership tuple."""
        mesh = self._meshes.get(indices)
        if mesh is None:
            mesh = Mesh(indices, tuple(self.devices[i] for i in indices),
                        tuple(self.streams[i] for i in indices), self.axis)
            self._meshes[indices] = mesh
        return mesh

    def live_snapshot(self) -> tuple[Mesh | None, tuple[int, ...]]:
        """(the :class:`Mesh` of the healthy, unleased members, their
        indices); (None, ()) when every member is dead or leased away."""
        with self._lock:
            live = self._live_indices_locked()
            if not live:
                return None, ()
            return self._mesh_for(live), live

    def spec_for(self, lane: str, program: str, rows: int) -> tuple[tuple | None, Mesh | None]:
        """Partition-rule decision for ONE dispatch: (spec, Mesh). Spec
        ``(axis,)`` over the live mesh = batch-shard; ``()`` over a one-member
        mesh = unpartitioned on the first live member. ``(None, None)`` when
        no member is live (the caller takes the CPU rung)."""
        with self._lock:
            live = self._live_indices_locked()
        if not live:
            return None, None
        kind = match_partition_rule(self.rules, f"{lane}/{program}", rows, len(live))
        if kind == "batch" and len(live) > 1:
            return (self.axis,), self._mesh_for(live)
        return (), self._mesh_for(live[:1])

    # -- health mask (the per-member breakers flip these) ---------------------

    def mark_unhealthy(self, idx: int, reason: str = "") -> bool:
        """Shed one member (a breaker trip). True when this call shrank the
        live set."""
        with self._lock:
            if not self._healthy[idx]:
                return False
            self._healthy[idx] = False
            self.shrinks += 1
            left = sum(self._healthy)
            self._publish_locked()
        self.metrics.record_shrink()
        tracing.fault_event("mesh_device_shed", target="parallel::mesh", device=idx,
                            healthy_left=left, reason=reason[:200])
        return True

    def mark_healthy(self, idx: int) -> bool:
        """Re-admit a member (its breaker's half-open trial)."""
        with self._lock:
            if self._healthy[idx]:
                return False
            self._healthy[idx] = True
            self.recoveries += 1
            self._publish_locked()
        self.metrics.record_recovery()
        tracing.event("parallel::mesh", "mesh_device_recovered", device=idx)
        return True

    # -- sub-mesh lease -------------------------------------------------------

    def lease_submesh(self, k: int, what: str = "rebuild") -> _SubMeshLease:
        """Carve ``k`` healthy, unleased members out for an exclusive claimant;
        they come from the TAIL of the roster, so the live lanes keep the
        head. Raises :class:`MeshExhausted` when fewer than ``k + 1`` members
        are available (the live side keeps at least one)."""
        with self._lock:
            avail = self._live_indices_locked()
            if len(avail) < k + 1:
                raise MeshExhausted(f"cannot lease {k} of {len(avail)} live devices "
                                    f"(live lanes must keep at least one)")
            take = avail[-k:]
            self._leased.update(take)
            self.submesh_leases += 1
            mesh = self._mesh_for(take)
            self._publish_locked()
        self.metrics.record_submesh_lease()
        tracing.event("parallel::mesh", "submesh_lease", what=what, devices=list(take))
        return _SubMeshLease(self, take, mesh, what)

    def _release_lease(self, lease: _SubMeshLease) -> None:
        with self._lock:
            self._leased.difference_update(lease.indices)
            self._publish_locked()
        tracing.event("parallel::mesh", "submesh_release", what=lease.what,
                      devices=list(lease.indices))

    # -- observability --------------------------------------------------------

    def _publish_locked(self) -> None:
        self.metrics.set_topology(total=len(self.devices), healthy=sum(self._healthy),
                                  leased=len(self._leased))

    def snapshot(self) -> dict:
        with self._lock:
            healthy = sum(self._healthy)
            return {
                "total": len(self.devices),
                "healthy": healthy,
                "unhealthy": len(self.devices) - healthy,
                "leased": len(self._leased),
                "live": len(self._live_indices_locked()),
                "shrinks": self.shrinks,
                "recoveries": self.recoveries,
                "submesh_leases": self.submesh_leases,
            }


def mesh_tier(n: int, min_tier: int, mult: int, ceiling: int | None = None) -> int:
    """Batch tier of a mesh dispatch: the x2 ladder from ``min_tier`` rounded
    up to a member-count multiple, optionally clamped to the largest LADDER
    tier <= ``ceiling`` (never to an off-ladder value)."""
    mult = max(1, mult)
    t = -(-max(1, min_tier) // mult) * mult
    cap = None
    if ceiling is not None:
        cap = t
        while cap * 2 <= ceiling:
            cap *= 2
    while t < n and (cap is None or t < cap):
        t *= 2
    if cap is not None and t > cap:
        t = cap
    assert t % mult == 0, f"mesh tier {t} not divisible by {mult}"
    return t


def _shard_rows(mesh: Mesh, n: int, shard: int, launch) -> np.ndarray:
    """Run ``launch(lo, hi, device)`` (returning (hi - lo, 8) u32 digests on
    ``device``) on each member's rows of ``shard``-row ranges, each on its
    stream, and gather the digests on the host in row order."""
    mesh.fork()
    outs = []
    for j, (lo, hi) in enumerate(mesh.ranges(n, shard)):
        if hi > lo:
            with mesh.on(j):
                outs.append(launch(lo, hi, mesh.devices[j]))
    mesh.join()
    return np.concatenate([o.cpu().numpy() for o in outs]) if outs else np.zeros((0, 8), np.uint32)


class MeshKeccak:
    """Sharded batch front-end over a :class:`HashMesh`: the mesh's
    counterpart of ``ops/keccak.py KeccakDevice``. Buckets by block count as
    the reference does (one ``block_tier`` bucket, pow2 block tiers above),
    takes each bucket's tier over the live members (:func:`mesh_tier`) and
    hashes each member's range with kernel 1 on its stream. A shape a
    warm-up manager has not warmed ("keccak.masked", block tier, batch
    tier, member count) is hashed on the host while it warms; so is a bucket
    above the menu's block ceiling, as ``KeccakDevice`` does (the reference
    hashes those on the host always)."""

    MAX_BATCH_TIER = 16384
    MAX_BLOCK_TIER = 32

    def __init__(self, hash_mesh: HashMesh, min_tier: int = 1024, block_tier: int = 4,
                 warmup=None):
        self.hash_mesh = hash_mesh
        self.min_tier = min_tier
        self.block_tier = block_tier
        self.warmup = warmup
        self.host_hashed = 0  # messages hashed on the host since construction

    def _bucket_key(self, nb: int) -> int:
        if nb <= self.block_tier:
            return self.block_tier
        t = 2 * self.block_tier
        while t < nb:
            t *= 2
        return t

    def hash_sharded(self, msgs: list[bytes], mesh: Mesh) -> list[bytes]:
        """Hash ``msgs`` with every bucket sharded over ``mesh`` (a live
        membership; a one-member mesh is the unpartitioned route). Digest
        order matches input order."""
        from ..primitives.keccak import bucketed_hash

        cap = mesh_tier(1, self.min_tier, mesh.size, self.MAX_BATCH_TIER)
        while cap * 2 <= self.MAX_BATCH_TIER:
            cap *= 2
        out: list[bytes] = []
        for lo in range(0, len(msgs), cap):
            out.extend(bucketed_hash(
                msgs[lo:lo + cap],
                lambda sub, key, counts: self._hash_bucket(sub, key, counts, mesh),
                bucket_key=self._bucket_key))
        return out

    def _hash_bucket(self, sub: list[bytes], key: int, counts: np.ndarray,
                     mesh: Mesh) -> np.ndarray:
        from ..ops.keccak import keccak256_words_masked
        from ..primitives.keccak import keccak256_words_masked_np, pad_batch

        n = len(sub)
        ndev = mesh.size
        batch_tier = mesh_tier(n, self.min_tier, ndev, self.MAX_BATCH_TIER)
        if self.warmup is not None and not self.warmup.route_bucket(
                "keccak.masked", key, batch_tier, ndev):
            self.host_hashed += n
            return keccak256_words_masked_np(pad_batch(sub, counts), int(counts.max()), counts)
        words = pad_batch(sub, counts, pad_to_blocks=key).view("<u4")
        cnt = counts.astype(np.int32)

        def launch(lo, hi, dev):
            return keccak256_words_masked(torch.from_numpy(words[lo:hi]).to(dev),
                                          torch.from_numpy(cnt[lo:hi]).to(dev))

        return _shard_rows(mesh, n, batch_tier // ndev, launch)


def sharded_keccak(hash_mesh: HashMesh, words: np.ndarray) -> np.ndarray:
    """Hash a padded single-block batch sharded across the whole roster.

    ``words``: (N, 34) uint32, N divisible by the member count. Each member
    hashes its N / members rows with kernel 1 on its stream; no exchange.
    Returns the (N, 8) uint32 digests on the host."""
    from ..ops.keccak import keccak256_words

    words = np.ascontiguousarray(words, dtype=np.uint32)
    mesh = hash_mesh.mesh
    n = words.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not divide over {mesh.size} members")
    return _shard_rows(mesh, n, n // mesh.size,
                       lambda lo, hi, dev: keccak256_words(torch.from_numpy(words[lo:hi]).to(dev),
                                                           1))
