"""Build and load the port's native code: CUDA kernels with ``nvcc`` and the
host trie sweep with ``g++``, each as a shared library with a plain C
interface, loaded with ``ctypes``.

A library's file name carries a digest of its sources (the ``.cu`` or
``.cpp`` file plus every header beside it), so an edited source builds anew
and an unchanged one is loaded as it is. Builds write to a temporary name
and rename, so concurrent builders never load a half-written file. A failed
build raises :class:`BuildError` with the compiler's output; there is no
fallback.

Libraries go to ``reth_tpu_torch/build/`` unless a caller names another
directory. The kernel libraries (the ``.cu`` sources) follow the process's
kernel directory (:func:`set_kernel_dir`): the warm-up's versioned compile
cache (``ops/warmup.py CompileCache.enable``) points it at its own
directory, for every kernel library this process has not loaded yet. A
library is loaded once per process; no lock is held while a compiler runs,
so a build abandoned by a watchdog can never block a later load.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG_DIR / "build"
CUDA_SRC_DIR = Path(__file__).resolve().parent / "csrc"
# one shared library per kernel source
KERNEL_SOURCES = ("keccak.cu", "fused_level.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_loaded: dict[Path, ctypes.CDLL] = {}  # source -> its loaded library
_loaded_from: dict[Path, Path] = {}  # source -> the library file it was loaded from
_kernel_dir: Path | None = None  # None: BUILD_DIR


class BuildError(RuntimeError):
    """A native source failed to build, or its compiler is missing. Never a
    device fault: nothing retries it or replays it on a CPU twin."""


def set_kernel_dir(path: str | Path | None) -> None:
    """Build and load the kernel libraries in ``path`` from now on (None:
    ``BUILD_DIR``). Libraries this process already loaded stay loaded."""
    global _kernel_dir
    _kernel_dir = None if path is None else Path(path)


def kernel_dir() -> Path:
    """Where kernel libraries are built and loaded from now."""
    return _kernel_dir if _kernel_dir is not None else BUILD_DIR


def loaded_from() -> dict[Path, Path]:
    """Each loaded source's library file."""
    with _lock:
        return dict(_loaded_from)


def _digest(src: Path) -> str:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")) + sorted(src.parent.glob("*.h")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def library_path(src: Path, build_dir: str | Path | None = None) -> Path:
    """The library ``src`` builds to: in ``build_dir``, else the kernel
    directory for a ``.cu`` source and ``BUILD_DIR`` for any other."""
    if build_dir is None:
        build_dir = kernel_dir() if src.suffix == ".cu" else BUILD_DIR
    return Path(build_dir) / f"lib{src.stem}-{_digest(src)}.so"


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise BuildError("nvcc not found: the CUDA kernels build only where the "
                         "CUDA toolkit is installed")
    return found


@functools.lru_cache(maxsize=1)
def toolkit_version() -> str:
    """``nvcc --version``'s text, or "" where there is no CUDA toolkit."""
    try:
        return subprocess.run([nvcc(), "--version"], capture_output=True, text=True,
                              timeout=60).stdout
    except (BuildError, OSError, subprocess.SubprocessError):
        return ""


def _command(src: Path, out: Path) -> list[str]:
    if src.suffix == ".cu":
        return [nvcc(), *NVCC_FLAGS, str(src), "-o", str(out)]
    return ["g++", *GXX_FLAGS, str(src), "-o", str(out)]


def build(sources: list[Path], build_dir: str | Path | None = None) -> list[Path]:
    """Compile every source whose library is missing (in ``build_dir``, see
    :func:`library_path`), all compilers running at once; returns the
    library paths in order. The compiler's output is kept beside each
    library as ``<library>.log``."""
    outs = [library_path(s, build_dir) for s in sources]
    procs = []
    for src, out in zip(sources, outs):
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.Popen(_command(src, tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs.append((src, out, tmp, proc))
    failures = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_name(out.name + ".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"building {src.name} failed:\n{log}")
        else:
            os.replace(tmp, out)
    if failures:
        raise BuildError("\n".join(failures))
    return outs


def load(src: Path, build_missing: bool = True) -> ctypes.CDLL:
    """The loaded library of ``src``, built first if needed (with
    ``build_missing=False`` a missing library raises :class:`BuildError`
    instead). A process loads each source once: its digest is taken at the
    first call, and later calls (one per kernel launch) return the loaded
    library. The build runs outside the lock."""
    lib = _loaded.get(src)
    if lib is not None:
        return lib
    path = library_path(src)
    if not path.exists():
        if not build_missing:
            raise BuildError(f"{src.name} is not built in {path.parent}")
        build([src])
    with _lock:
        lib = _loaded.get(src)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            _loaded[src] = lib
            _loaded_from[src] = path
        return lib


def load_kernel(name: str, build_missing: bool = True) -> ctypes.CDLL:
    """Load the kernel library built from ``ops/csrc/<name>``."""
    return load(CUDA_SRC_DIR / name, build_missing)


class LaunchError(RuntimeError):
    """A kernel's C entry returned a CUDA error."""


def check_launch(err: int, kernel: str) -> None:
    """Raise :class:`LaunchError` if a kernel's C entry returned a CUDA
    error (its launch was refused or an earlier asynchronous fault
    surfaced)."""
    if err != 0:
        raise LaunchError(f"{kernel}: CUDA error {err} at launch")


def _device_error_types() -> tuple:
    """PyTorch's own types of a device fault, those this build has."""
    import torch

    return tuple(t for t in (getattr(torch, "AcceleratorError", None),
                             getattr(torch, "OutOfMemoryError", None)) if t is not None)


def is_kernel_fault(err: BaseException | None) -> bool:
    """Whether ``err`` or an error in its ``__cause__`` / ``__context__``
    chain is a kernel fault: a failed build (:class:`BuildError`) or a
    device fault, that is a refused launch (:class:`LaunchError`), one of
    PyTorch's device errors (``torch.AcceleratorError``,
    ``torch.OutOfMemoryError``), or a ``RuntimeError`` / ``AssertionError``
    whose message names CUDA in any case (an illegal address, a device
    mismatch, no card). Paths that keep the reference's fallbacks re-raise
    these instead of taking a slower route."""
    device_errors = _device_error_types()
    seen: set[int] = set()
    while err is not None and id(err) not in seen:
        seen.add(id(err))
        if isinstance(err, (BuildError, LaunchError) + device_errors):
            return True
        if isinstance(err, (RuntimeError, AssertionError)) and "cuda" in str(err).lower():
            return True
        err = err.__cause__ or err.__context__
    return False
