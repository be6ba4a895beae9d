"""Device warm-up: the kernels' build as a versioned compile cache, the shape
menu walked one launch at a time under a watchdog, and degraded serving on
the CPU twin until each shape is warm.

Port of the JAX package's ``ops/warmup.py``, with the same constants, menu,
states, snapshot keys and env knobs (``RETH_TPU_WARMUP_BUDGET`` /
``_ATTEMPTS`` / ``_BACKOFF``). What a compile is differs on this card: a
JAX program compiles per shape, while the port has one ``nvcc`` build per
kernel source and each kernel takes any row count. So the lifecycle maps:

- **Compile cache** (:class:`CompileCache`): the directory
  ``<base>/cuda-<digest>`` holds the built kernel libraries, the digest
  taken over ``ops/csrc/*.cu`` and ``*.cuh``, the ``nvcc --version`` text
  and ``NVCC_FLAGS`` (:func:`kernel_source_digest`), so a kernel edit or a
  toolkit upgrade lands in a fresh directory. ``validate()`` quarantines
  the directory when a file in it is empty or unreadable, or a library
  does not open with ``ctypes`` (in a child process) or lacks its entry
  symbols. ``probe()`` is
  the supervisor's child probe (kernel 1 on the card) loading its library
  from the directory; ``enable()`` points the kernel build directory
  (``ops/_build.py``) there for every kernel library not yet loaded.
- **The build**: :meth:`WarmupManager.run` first builds every library the
  menu needs, all ``nvcc`` runs at once, outside any watchdog. A failed
  build raises out of ``run()``: it is not a device fault, so it is neither
  retried nor parked as FAILED. A shape is a cache hit when its library was
  in the directory when ``run()`` began, a miss when ``run()`` built it.
- **Per-shape warm-up**: then the menu, one shape at a time, each under the
  watchdog ``budget`` with retries, exponential backoff and the
  supervisor's breaker, as in the reference. The step loads the shape's
  library (never builds it), makes one launch at exactly that shape and
  waits for it: ``keccak.*`` launches kernel 1 (``keccak256_absorb``) on
  ``batch_tier`` rows of ``block_tier`` rate blocks, ``fused.plain``
  kernel 2 (``packed_level``) without holes, ``fused.splice`` kernel 2 with
  four holes a row (the template levels' route), ``fused.subtrie`` kernel 4
  (``subtrie_levels``) through a real ``SubtrieFusedEngine``, a packed and
  a branch step in one launch.
- **Degraded serving**: while a manager is active, ``route_bucket`` sends a
  bucket whose shape is not WARM to the CPU twin (``KeccakDevice``'s host
  bucket; ``SubtrieFusedEngine`` runs such a flush one level a launch, still
  on the card), counted in ``cpu_routed``, and ``device_ready`` keeps the
  supervised fused commits on the twin. A launch fault in a WARM shape is
  handled as it always is.

- **The mesh's variants** (``mesh_sizes``, a shape's ``mesh_size`` > 1,
  keyed ``@m{n}``): the same shapes with each batch tier rounded up to a
  multiple of the member count, warmed through the mesh front-ends
  (``MeshKeccak``'s sharded launch, ``FusedMeshEngine``,
  ``SubtrieMeshEngine``) over the first ``mesh_size`` members of the
  manager's ``HashMesh`` roster, so a roster that names one card more than
  once warms on that card. Without a roster that large the step raises, as
  the reference's does when too few devices are found. The compile cache's
  directory gains ``-m{n}``, as the reference's does.
"""

from __future__ import annotations

import functools
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .. import tracing
from ..device import resolve
from ..metrics import WarmupMetrics
from . import _build

COLD = "cold"
COMPILING = "compiling"
WARM = "warm"
FAILED = "failed"

# the declared ceilings of the menu: KeccakDevice chunks batches above the
# batch ceiling; a bucket above the block ceiling is off the menu, so
# route_bucket sends it to the host while the menu warms
DEFAULT_MIN_TIER = 1024
DEFAULT_BLOCK_TIER = 4
DEFAULT_MAX_BATCH_TIER = 16384
DEFAULT_MAX_BLOCK_TIER = 32
# the row tier the k-level engines route against
DEFAULT_SUBTRIE_TIER = 2048
# the k ladder declared for the k-level programs
DEFAULT_SUBTRIE_KS: tuple[int, ...] = (8,)

# the kernel source each menu program launches
PROGRAM_SOURCE = {"keccak.masked": "keccak.cu", "keccak.exact": "keccak.cu",
                  "fused.plain": "fused_level.cu", "fused.splice": "fused_level.cu",
                  "fused.subtrie": "fused_level.cu"}
# the C entries a kernel library must export (by library stem)
ENTRY_SYMBOLS = {"keccak": ("keccak256_absorb", "keccak256_absorb_rows_per_block"),
                 "fused_level": ("packed_level", "branch_level", "subtrie_levels",
                                 "subtrie_levels_resident", "exchange_slots")}


@dataclass(frozen=True)
class MenuShape:
    """One declared launch shape.

    ``program``: "keccak.masked" | "keccak.exact" | "fused.plain" |
    "fused.splice" | "fused.subtrie", the kind strings the dispatch sites
    route by. ``mesh_size`` > 1 names the mesh's variant, sharded over that
    many members."""

    program: str
    block_tier: int
    batch_tier: int
    mesh_size: int = 1

    def key(self) -> tuple:
        return (self.program, self.block_tier, self.batch_tier, self.mesh_size)

    def __str__(self) -> str:  # events/log form
        base = f"{self.program}:{self.block_tier}x{self.batch_tier}"
        return base if self.mesh_size == 1 else f"{base}@m{self.mesh_size}"


def default_menu(min_tier: int = DEFAULT_MIN_TIER,
                 block_tier: int = DEFAULT_BLOCK_TIER,
                 max_batch_tier: int = DEFAULT_MAX_BATCH_TIER,
                 max_block_tier: int = DEFAULT_MAX_BLOCK_TIER,
                 include_fused: bool = True,
                 mesh_sizes: tuple[int, ...] = (),
                 subtrie_ks: tuple[int, ...] = DEFAULT_SUBTRIE_KS) -> list[MenuShape]:
    """The reference's grid: one masked keccak shape per pow2 batch tier for
    trie-node-sized messages (<= ``block_tier`` rate blocks), the pow2
    block-tier ladder at the base batch tier for larger messages, clamped at
    the ceilings; with ``include_fused`` the level kernels' shapes at the
    base tier and one k-level shape per k > 1 of ``subtrie_ks`` (its
    ``block_tier`` slot carries k). ``mesh_sizes`` adds each size's mesh
    variants (above 1): the batch ladder from ``min_tier`` rounded up to a
    member-count multiple (the tiers ``parallel/mesh.py mesh_tier`` and the
    mesh engines' rounded floors mint)."""
    shapes: list[MenuShape] = []
    t = min_tier
    while t <= max_batch_tier:
        shapes.append(MenuShape("keccak.masked", block_tier, t))
        t *= 2
    bt = 2 * block_tier
    while bt <= max_block_tier:
        shapes.append(MenuShape("keccak.masked", bt, min_tier))
        bt *= 2
    if include_fused:
        shapes.append(MenuShape("fused.plain", block_tier, min_tier))
        shapes.append(MenuShape("fused.splice", block_tier, min_tier))
        for k in subtrie_ks:
            if k > 1:
                shapes.append(MenuShape("fused.subtrie", k, DEFAULT_SUBTRIE_TIER))
    for m in mesh_sizes:
        if m <= 1:
            continue
        floor = -(-min_tier // m) * m
        t = floor
        while t <= max_batch_tier:
            shapes.append(MenuShape("keccak.masked", block_tier, t, m))
            t *= 2
        if include_fused:
            shapes.append(MenuShape("fused.plain", block_tier, floor, m))
            shapes.append(MenuShape("fused.splice", block_tier, floor, m))
            for k in subtrie_ks:
                if k > 1:
                    shapes.append(MenuShape("fused.subtrie", k,
                                            -(-DEFAULT_SUBTRIE_TIER // m) * m, m))
    return shapes


def _mesh_for_shape(shape: MenuShape, mesh):
    """The membership a mesh shape warms over: the first ``mesh_size``
    members of ``mesh`` (a ``parallel/mesh.py`` HashMesh)."""
    found = 0 if mesh is None else mesh.n_devices
    if found < shape.mesh_size:
        raise ValueError(f"menu shape needs {shape.mesh_size} devices, found {found}")
    if shape.batch_tier % shape.mesh_size:
        raise ValueError(f"mesh menu tier {shape.batch_tier} not divisible by "
                         f"mesh size {shape.mesh_size}")
    return mesh._mesh_for(tuple(range(shape.mesh_size)))


def _warm_subtrie(eng) -> None:
    """One commit of one packed and one branch level through a k-level
    engine, staged into one chunk: the k-level shape's launch."""
    eng.begin(4)
    s1, s2 = eng.alloc_slot(), eng.alloc_slot()
    row = b"\x01" * 40
    eng.dispatch_packed(np.frombuffer(row, dtype=np.uint8), np.zeros((1,), dtype=np.uint32),
                        np.array([len(row)], dtype=np.uint32), np.array([s1], dtype=np.int32),
                        None, 4)
    eng.dispatch_branch(np.array([0x0001], dtype=np.uint16), np.array([s2], dtype=np.int32),
                        np.array([[0], [0], [s1]], dtype=np.int32))
    eng.finish()


def _warm_level(eng, rows: int, holes_per_row: int, b: int) -> None:
    """One commit of one level of ``rows`` packed rows of ``b`` rate blocks,
    ``holes_per_row`` holes a row, through a level engine."""
    from ..primitives.keccak import RATE

    length = b * RATE - 1
    eng.begin(rows)
    slots = np.array([eng.alloc_slot() for _ in range(rows)], dtype=np.int64)
    holes = np.stack([np.repeat(np.arange(rows), holes_per_row),
                      np.tile(np.arange(holes_per_row) * 32, rows),
                      np.zeros(rows * holes_per_row, dtype=np.int64)]) if holes_per_row else None
    eng.dispatch_packed(np.zeros(rows * length, dtype=np.uint8),
                        np.arange(rows, dtype=np.int64) * length,
                        np.full(rows, length, dtype=np.int32), slots, holes, b)
    eng.finish()


def build_shape(shape: MenuShape, device: str | torch.device = "cuda", mesh=None) -> None:
    """One launch of ``shape``'s kernel at exactly that shape on ``device``,
    waited for. On the card the kernel's library is loaded, never built (the
    manager builds before it walks the menu); on the CPU the kernel's plain
    version runs. A mesh shape (``mesh_size`` > 1) runs over the first
    ``mesh_size`` members of ``mesh`` (a HashMesh) instead: ``keccak.*``
    through ``MeshKeccak``'s sharded launch of ``batch_tier`` rows,
    ``fused.*`` through ``FusedMeshEngine`` / ``SubtrieMeshEngine``."""
    from ..primitives.keccak import RATE
    from .fused_commit import (FusedMeshEngine, SubtrieFusedEngine, SubtrieMeshEngine,
                               packed_level)
    from .keccak import WORDS_PER_BLOCK, keccak256_words_masked

    dev = resolve(device)
    src = PROGRAM_SOURCE.get(shape.program)
    if src is None:
        raise ValueError(f"unknown menu program {shape.program!r}")
    n, b = shape.batch_tier, shape.block_tier
    if shape.mesh_size > 1:
        sub = _mesh_for_shape(shape, mesh)
        if any(d.type == "cuda" for d in sub.devices):
            _build.load_kernel(src, build_missing=False)
        if shape.program.startswith("keccak."):
            from ..parallel.mesh import MeshKeccak

            count = b if shape.program == "keccak.exact" else 1
            msgs = [b"\x00" * (count * RATE - 1)] * n
            MeshKeccak(mesh, min_tier=n, block_tier=b).hash_sharded(msgs, sub)
        elif shape.program == "fused.subtrie":
            _warm_subtrie(SubtrieMeshEngine(sub, min_tier=64, k=b))
        else:
            _warm_level(FusedMeshEngine(sub, min_tier=64), n,
                        4 if shape.program == "fused.splice" else 0, b)
        return
    if dev.type == "cuda":
        _build.load_kernel(src, build_missing=False)
    if shape.program.startswith("keccak."):
        words = torch.zeros((n, b * WORDS_PER_BLOCK), dtype=torch.uint32, device=dev)
        count = b if shape.program == "keccak.exact" else 1
        counts = torch.full((n,), count, dtype=torch.int32, device=dev)
        keccak256_words_masked(words, counts).cpu()
        return
    if shape.program in ("fused.plain", "fused.splice"):
        length = b * RATE - 1  # b rate blocks a row
        row_off = torch.arange(n, dtype=torch.int64, device=dev) * length
        row_len = torch.full((n,), length, dtype=torch.int32, device=dev)
        slots = torch.arange(1, n + 1, dtype=torch.int64, device=dev)
        holes = 4 * n if shape.program == "fused.splice" else 0
        per_row = holes // n
        hole_start = torch.arange(n + 1, dtype=torch.int64, device=dev) * per_row
        hole_off = (torch.arange(holes, dtype=torch.int32, device=dev) % max(per_row, 1)) * 32
        hole_src = torch.zeros((holes,), dtype=torch.int64, device=dev)
        buf = torch.zeros((n + 1, 32), dtype=torch.uint8, device=dev)
        packed_level(torch.zeros((n * length,), dtype=torch.uint8, device=dev), row_off,
                     row_len, slots, hole_start, hole_off, hole_src, buf)
        buf.cpu()
        return
    # fused.subtrie: one packed and one branch level through the engine the
    # runtime uses, staged into one launch of kernel 4
    _warm_subtrie(SubtrieFusedEngine(min_tier=64, k=b, device=dev))


def kernel_source_digest(paths: list[str | Path] | None = None) -> str:
    """The compile cache's version: a digest of the kernel sources
    (``ops/csrc/*.cu`` and ``*.cuh`` by default), the ``nvcc --version``
    text and ``NVCC_FLAGS``. A kernel edit or a toolkit upgrade lands in a
    fresh directory."""
    if paths is None:
        paths = sorted(_build.CUDA_SRC_DIR.glob("*.cu")) + sorted(_build.CUDA_SRC_DIR.glob("*.cuh"))
    h = hashlib.sha256()
    for p in paths:
        try:
            h.update(Path(p).read_bytes())
        except OSError:
            h.update(str(p).encode())
    h.update(_build.toolkit_version().encode())
    h.update(" ".join(_build.NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _is_entry(p: Path) -> bool:
    """A cache entry: any file but a build log or a build in progress."""
    return p.is_file() and not p.name.endswith((".log", ".tmp"))


# the child that opens a library and looks up its symbols: a corrupt file
# can crash the loader, and a file this process has loaded would be answered
# from the loader's cache without being read again
_OPEN_CODE = ("import ctypes, sys\n"
              "lib = ctypes.CDLL(sys.argv[1])\n"
              "missing = [s for s in sys.argv[2:] if not hasattr(lib, s)]\n"
              "sys.exit('missing ' + ' '.join(missing) if missing else 0)\n")


def _library_ok(p: Path) -> bool:
    """Does the kernel library ``p`` open, with its entry symbols? Checked
    in a child process."""
    stem = p.name[3:].rsplit("-", 1)[0] if p.name.startswith("lib") else ""
    try:
        r = subprocess.run([sys.executable, "-c", _OPEN_CODE, str(p), *ENTRY_SYMBOLS.get(stem, ())],
                           capture_output=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return False
    return r.returncode == 0


class CompileCache:
    """The versioned on-disk build of the kernel libraries.

    The directory is ``<base>/cuda-<source digest>``, so restarts against
    the same kernels and toolkit load what was built, while a change never
    loads a stale library. ``validate()`` quarantines the whole directory
    (renamed aside, a fresh one made) on any corrupt entry: an empty or
    unreadable file, or a library that does not open or lacks its entry
    symbols. ``probe()`` checks in a child process that kernel 1 loads from
    the directory and hashes on the card; ``enable()`` points this
    process's kernel build directory there."""

    def __init__(self, base_dir: str | Path, sources=None, *,
                 probe_budget: float | None = None, mesh_size: int = 1):
        self.base = Path(base_dir)
        self.digest = kernel_source_digest(sources)
        self.mesh_size = mesh_size
        # the key gains the mesh size, as the reference's does
        suffix = f"-m{mesh_size}" if mesh_size != 1 else ""
        self.dir = self.base / f"cuda-{self.digest}{suffix}"
        self.probe_budget = probe_budget
        self.enabled = False
        self.quarantined = 0
        self.last_report: dict | None = None

    def entry_count(self) -> int:
        try:
            return sum(1 for p in self.dir.rglob("*") if _is_entry(p))
        except OSError:
            return 0

    def validate(self) -> dict:
        """Scan for corrupt entries; quarantine and recreate on any. Returns
        ``{"entries", "corrupt", "quarantined"}`` (0 entries after a
        quarantine: the next run rebuilds into the fresh directory)."""
        corrupt: list[str] = []
        entries = 0
        if self.dir.is_dir():
            for p in sorted(self.dir.rglob("*")):
                if not _is_entry(p):
                    continue
                entries += 1
                try:
                    if p.stat().st_size == 0:
                        corrupt.append(p.name)
                        continue
                    with open(p, "rb") as f:
                        f.read(16)
                except OSError:
                    corrupt.append(p.name)
                    continue
                if p.suffix == ".so" and not _library_ok(p):
                    corrupt.append(p.name)
        if corrupt:
            k = self.quarantined
            while True:
                dest = self.dir.with_name(f"{self.dir.name}.quarantine-{k}")
                if not dest.exists():
                    break
                k += 1
            try:
                self.dir.rename(dest)
            except OSError:  # cross-device or a racing writer: drop it in place
                shutil.rmtree(self.dir, ignore_errors=True)
                dest = None
            self.quarantined += 1
            entries = 0
            tracing.event("ops::warmup", "cache_quarantine", dir=str(self.dir),
                          corrupt=len(corrupt), moved_to=str(dest) if dest else "removed")
        self.dir.mkdir(parents=True, exist_ok=True)
        self.last_report = {"entries": entries, "corrupt": len(corrupt),
                            "quarantined": bool(corrupt)}
        return self.last_report

    def probe(self, injector=None) -> bool:
        """Child-process check that kernel 1 loads from this directory and
        hashes on the card."""
        from .supervisor import probe_device

        return probe_device(self.probe_budget, cache_dir=str(self.dir), injector=injector).ok

    def enable(self) -> bool:
        _build.set_kernel_dir(self.dir)
        self.enabled = True
        return True

    def disable(self) -> None:
        if not self.enabled:
            return
        _build.set_kernel_dir(None)
        self.enabled = False

    def loaded_elsewhere(self) -> int:
        """Kernel libraries this process loaded from another directory."""
        return sum(1 for src, path in _build.loaded_from().items()
                   if src.suffix == ".cu" and path.parent != self.dir)

    def summary(self) -> dict:
        rep = self.last_report or {}
        state = "off"
        if self.enabled:
            state = "warm" if rep.get("entries", 0) else "cold"
        return {"mode": state, "dir": str(self.dir), "entries": rep.get("entries", 0),
                "quarantined": self.quarantined, "loaded_elsewhere": self.loaded_elsewhere()}


class WarmupManager:
    """Owns the kernels' warm-up lifecycle on ``device``.

    ``run()`` (or ``start()`` on a background thread) builds the libraries
    the menu needs, then walks the menu one shape at a time: each step runs
    in a worker thread under ``budget`` seconds; a timeout abandons the
    thread, counts a breaker failure on the attached supervisor and retries
    with exponential backoff. Shapes settle WARM or FAILED; ``route_bucket``
    and ``device_ready`` serve degraded until everything is warm, and
    ``on_device_recovered()`` (the supervisor's half-open probe success)
    re-runs FAILED shapes. ``builder(shape)`` replaces the per-shape launch
    (:func:`build_shape` on ``device``), ``compiler(sources, build_dir)``
    the build (``_build.build`` on the card; on the CPU nothing is built).
    ``mesh`` (a ``parallel/mesh.py`` HashMesh) is the roster the menu's
    mesh shapes warm over."""

    def __init__(self, menu: list[MenuShape] | None = None, *,
                 supervisor=None, cache: CompileCache | None = None,
                 budget: float | None = None, attempts: int | None = None,
                 backoff: float | None = None, builder=None, injector=None,
                 verify_cache: bool = True, enable_cache: bool = True,
                 registry=None, compiler=None, mesh=None, device: str | torch.device = "cuda"):
        self.device = resolve(device)
        self.menu = list(menu if menu is not None else default_menu())
        self.mesh = mesh
        self.sup = supervisor
        self.cache = cache
        if budget is None:
            budget = float(os.environ.get("RETH_TPU_WARMUP_BUDGET", "240"))
        self.budget = budget
        if attempts is None:
            attempts = int(os.environ.get("RETH_TPU_WARMUP_ATTEMPTS", "3"))
        self.attempts = max(1, attempts)
        if backoff is None:
            backoff = float(os.environ.get("RETH_TPU_WARMUP_BACKOFF", "2"))
        self.backoff = backoff
        self.verify_cache = verify_cache
        # enable_cache=False: validate and quarantine only, never point the
        # process's kernel directory at the cache (unit-test scope)
        self.enable_cache = enable_cache
        self._builder = builder or functools.partial(build_shape, device=self.device, mesh=mesh)
        if compiler is None and self.device.type == "cuda":
            compiler = _build.build
        self._compiler = compiler
        if injector is None and supervisor is not None:
            injector = supervisor.injector
        if injector is None:
            from .supervisor import FaultInjector

            injector = FaultInjector.from_env()
        self.injector = injector
        self.metrics = WarmupMetrics(registry)
        self._lock = threading.Lock()
        self.states: dict[tuple, str] = {s.key(): COLD for s in self.menu}
        self.compile_walls: dict[tuple, float] = {}
        self.retries = 0
        self.wedges = 0
        self.cpu_routed = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.builds = 0  # libraries run() had to build
        self.build_error: BaseException | None = None
        self._present: dict[str, bool] | None = None  # source -> built before run()
        self._current: MenuShape | None = None
        self._active = False  # gating applies from start() onward
        self._retrying = False
        self._done = threading.Event()
        self._thread: threading.Thread | None = None
        if supervisor is not None:
            supervisor.warmup = self
        self._publish()

    # -- routing queries (hot path) -----------------------------------------

    def device_ready(self) -> bool:
        """May a whole fused commit claim the card? True before warm-up ever
        starts (no gating), and once every menu shape is WARM."""
        if not self._active:
            return True
        return self._done.is_set() and all(s == WARM for s in self.states.values())

    def route_bucket(self, program: str, block_tier: int, batch_tier: int,
                     mesh_size: int = 1) -> bool:
        """Per-dispatch routing: True = the card, False = the CPU twin. A
        WARM shape always gets the card; while warming (or degraded) any
        other shape is routed to the twin and counted in ``cpu_routed``."""
        if not self._active:
            return True
        if self.states.get((program, block_tier, batch_tier, mesh_size)) == WARM:
            return True
        if self.device_ready():
            return True  # fully warm: off-menu stragglers ride the watchdog
        with self._lock:
            self.cpu_routed += 1
        self.metrics.record_cpu_routed()
        return False

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Run warm-up on a background thread (degraded serving meanwhile)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._thread = threading.Thread(target=self._run_quietly, daemon=True,
                                            name="device-warmup")
        self._thread.start()

    def _run_quietly(self) -> None:
        try:
            self.run()
        except Exception:  # noqa: BLE001 — kept in build_error, raised by wait()
            pass

    def wait(self, timeout: float | None = None) -> bool:
        """Wait for the pass to end; re-raises a build failure of ``run()``."""
        done = self._done.wait(timeout)
        if self.build_error is not None:
            raise self.build_error
        return done

    def run(self) -> dict:
        """Blocking warm-up pass: the cache, the build, then the menu one
        shape at a time. Returns the final snapshot. A failed build raises:
        gating is lifted (nothing is parked FAILED) and the next load of the
        kernel raises in its caller as well."""
        self._active = True
        self._done.clear()
        self.build_error = None
        t0 = time.monotonic()
        self._publish()
        try:
            self._present = None
            self._setup_cache()
            if self._present is None:
                self._prebuild(self.cache.dir if self.cache is not None and self.cache.enabled
                               else None)
        except _build.BuildError as e:
            self.build_error = e
            self._active = False
            self._done.set()
            self._publish()
            tracing.event("ops::warmup", "build_failed", error=str(e)[:300])
            raise
        for shape in self.menu:
            if self.states.get(shape.key()) != WARM:
                self._compile_shape(shape)
        self._done.set()
        self._publish()
        snap = self.snapshot()
        tracing.event("ops::warmup", "warmup_done", state=snap["state"], warm=snap["warm"],
                      failed=snap["failed"], total=snap["total"],
                      wall_s=round(time.monotonic() - t0, 3),
                      compile_wall_s=snap["compile_wall_s"], cache=snap["cache"]["mode"])
        return snap

    def retry_failed(self) -> int:
        """Re-run FAILED shapes (promotion after a fault clears); returns how
        many became WARM. Re-entrancy guarded: the supervisor's half-open
        probe success may fire mid-retry too."""
        with self._lock:
            if self._retrying:
                return 0
            self._retrying = True
        try:
            failed = [s for s in self.menu if self.states.get(s.key()) == FAILED]
            if not failed:
                return 0
            self._done.clear()
            self._publish()
            promoted = 0
            for shape in failed:
                if self._compile_shape(shape):
                    promoted += 1
            self._done.set()
            self._publish()
            return promoted
        finally:
            with self._lock:
                self._retrying = False

    def on_device_recovered(self) -> None:
        """Supervisor hook: a half-open probe just closed the breaker; promote
        FAILED shapes in the background."""
        if not self._active or self.device_ready():
            return
        if not any(s == FAILED for s in self.states.values()):
            return
        threading.Thread(target=self.retry_failed, daemon=True,
                         name="device-warmup-retry").start()

    # -- internals -----------------------------------------------------------

    def _prebuild(self, build_dir: Path | None) -> None:
        """Note which libraries of the menu are built in ``build_dir`` (None:
        the kernel directory) and build the missing ones, all at once."""
        srcs = sorted({PROGRAM_SOURCE[s.program] for s in self.menu
                       if s.program in PROGRAM_SOURCE})
        paths = [_build.CUDA_SRC_DIR / s for s in srcs]
        self._present = {s: _build.library_path(p, build_dir).exists()
                         for s, p in zip(srcs, paths)}
        missing = [p for s, p in zip(srcs, paths) if not self._present[s]]
        if missing and self._compiler is not None:
            t0 = time.perf_counter()
            self._compiler(missing, build_dir)
            self.builds += len(missing)
            tracing.event("ops::warmup", "built", libraries=len(missing),
                          wall_s=round(time.perf_counter() - t0, 3))

    def _setup_cache(self) -> None:
        if self.cache is None:
            return
        report = self.cache.validate()
        self.metrics.set_cache_entries(report["entries"])
        if report["quarantined"]:
            self.metrics.record_quarantine()
        if not self.enable_cache:
            return
        if self.verify_cache:
            # the probe's child loads kernel 1 from the directory, never
            # builds it: build first
            self._prebuild(self.cache.dir)
            if not self.cache.probe(injector=self.injector):
                # a directory the probe cannot load through is not wired into
                # this process: warm-up proceeds on the kernel directory
                tracing.event("ops::warmup", "cache_disabled", dir=str(self.cache.dir),
                              reason="subprocess cache probe failed")
                self._present = None
                return
        self.cache.enable()
        tracing.event("ops::warmup", "cache_enabled", dir=str(self.cache.dir),
                      entries=report["entries"], state="warm" if report["entries"] else "cold")

    def _set_state(self, shape: MenuShape, state: str) -> None:
        with self._lock:
            self.states[shape.key()] = state
            self._current = shape if state == COMPILING else None
        self._publish()

    def _cache_hit(self, shape: MenuShape) -> bool | None:
        """Was the shape's library built before ``run()``? None without an
        enabled cache."""
        if self.cache is None or not self.cache.enabled or self._present is None:
            return None
        return self._present.get(PROGRAM_SOURCE.get(shape.program, ""), False)

    def _compile_shape(self, shape: MenuShape) -> bool:
        for attempt in range(1, self.attempts + 1):
            if self.sup is not None and not self.sup.allows_device():
                # breaker open: serving stays on the twin; the shape parks
                # FAILED until a half-open probe succeeds
                self._set_state(shape, FAILED)
                tracing.event("ops::warmup", "shape_deferred", shape=str(shape),
                              reason="breaker open")
                return False
            self._set_state(shape, COMPILING)
            t0 = time.perf_counter()
            ok, err = self._guarded_build(shape)
            wall = time.perf_counter() - t0
            if ok:
                hit = self._cache_hit(shape)
                with self._lock:
                    if hit is True:
                        self.cache_hits += 1
                    elif hit is False:
                        self.cache_misses += 1
                    self.compile_walls[shape.key()] = round(wall, 6)
                self._set_state(shape, WARM)
                self.metrics.record_compile(wall, cache_hit=hit)
                if self.sup is not None:
                    self.sup.breaker.record_success()
                tracing.event("ops::warmup", "shape_warm", shape=str(shape),
                              wall_s=round(wall, 4), attempt=attempt, cache_hit=hit)
                return True
            with self._lock:
                self.wedges += 1
            self.metrics.record_wedge()
            if self.sup is not None:
                # a wedged warm-up launch is a device failure like any other:
                # repeated wedges trip the breaker instead of freezing startup
                if self.sup.breaker.record_failure():
                    self.sup.metrics.record_trip()
                self.sup._publish()
            tracing.event("ops::warmup", "shape_wedged", shape=str(shape), attempt=attempt,
                          budget_s=self.budget, error=str(err)[:200])
            if attempt < self.attempts:
                with self._lock:
                    self.retries += 1
                self.metrics.record_retry()
                time.sleep(self.backoff * (2 ** (attempt - 1)))
        self._set_state(shape, FAILED)
        return False

    def _guarded_build(self, shape: MenuShape) -> tuple[bool, object]:
        """One attempt in a worker thread under the watchdog budget (a wedged
        launch cannot be cancelled: the thread is abandoned and the shape
        retried or failed, as a supervised dispatch is). The worker holds no
        lock and runs no compiler."""
        box: list = [False, None]
        injector = self.injector

        def _call():
            try:
                if injector is not None:
                    injector.on_compile(self.budget)
                self._builder(shape)
                box[0] = True
            except BaseException as e:  # noqa: BLE001 — reported below
                box[1] = e

        t = threading.Thread(target=_call, daemon=True, name=f"warmup-{shape.program}")
        t.start()
        t.join(self.budget)
        if t.is_alive():
            tracing.fault_event("warmup_compile_timeout", target="ops::warmup",
                                shape=str(shape), budget_s=self.budget)
            return False, f"compile exceeded {self.budget}s watchdog budget"
        if not box[0]:
            return False, box[1]
        return True, None

    # -- observability -------------------------------------------------------

    def _counts(self) -> tuple[int, int, int]:
        vals = list(self.states.values())
        return (sum(1 for s in vals if s == WARM), sum(1 for s in vals if s == FAILED),
                len(vals))

    def overall_state(self) -> str:
        if not self._active:
            return "off"
        warm, _failed, total = self._counts()
        if not self._done.is_set():
            return "warming"
        if warm == total:
            return "warm"
        return "degraded"

    def snapshot(self) -> dict:
        with self._lock:
            states = dict(self.states)
            walls = dict(self.compile_walls)
            current = self._current
        warm = sum(1 for s in states.values() if s == WARM)
        failed = sum(1 for s in states.values() if s == FAILED)
        return {
            "state": self.overall_state(),
            "warm": warm,
            "failed": failed,
            "total": len(states),
            "compiling": str(current) if current is not None else None,
            "compile_wall_s": round(sum(walls.values()), 4),
            "retries": self.retries,
            "wedges": self.wedges,
            "cpu_routed": self.cpu_routed,
            "cache": (self.cache.summary() if self.cache is not None
                      else {"mode": "off", "entries": 0, "quarantined": 0}),
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "shapes": {(f"{k[0]}:{k[1]}x{k[2]}" + (f"@m{k[3]}" if k[3] != 1 else "")): v
                       for k, v in states.items()},
        }

    def _publish(self) -> None:
        warm, failed, total = self._counts()
        self.metrics.set_progress(total=total, warm=warm, failed=failed)
        self.metrics.set_state(self.overall_state())


def build_warmup(supervisor=None, cache_dir: str | Path | None = None,
                 menu: list[MenuShape] | None = None, registry=None,
                 mesh_size: int = 1, **kw) -> WarmupManager:
    """The shared constructor: a manager over the default menu, with the
    compile cache under ``cache_dir`` when one is given. ``mesh_size`` > 1
    adds the mesh's menu variants and keys the cache by the mesh size; pass
    the roster they warm over as ``mesh=``."""
    if menu is None and mesh_size > 1:
        menu = default_menu(mesh_sizes=(mesh_size,))
    cache = CompileCache(cache_dir, mesh_size=mesh_size) if cache_dir else None
    return WarmupManager(menu=menu, supervisor=supervisor, cache=cache, registry=registry, **kw)
