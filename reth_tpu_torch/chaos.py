"""Crash points: kill the process at an exact code location.

A copy of the crash-point half of the JAX package's ``chaos.py``: the named
points (``CRASH_POINTS``), the drill's parse of ``RETH_TPU_FAULT_CRASH_AT``
and ``crash_point``, which the engine tree, the WAL and the NippyJar writer
call between a commit and the bookkeeping that follows it, and
``inject_bad_crc_record``, the bit-rot shape startup recovery must catch.
The campaigns, scenario vocabulary, invariant suite and orchestration are
not ported yet (ROADMAP A).
"""

from __future__ import annotations

import os
import pickle
import struct
import sys
import zlib
from pathlib import Path

CRASH_POINTS = (
    "wal-append",          # record fsync'd, publish pending (storage/wal.py)
    "checkpoint-swap",     # image swapped, manifest/truncate pending
    "advance-persistence", # persistence committed, tree bookkeeping pending
    "unwind",              # pipeline unwound, canonical surgery pending
    "jar-rename",          # jar bytes fsync'd, atomic rename pending
)

_hits: dict[str, int] = {}


def reset_crash_counts() -> None:
    """Test hook: forget per-point hit counters (they are process-wide)."""
    _hits.clear()


def crash_spec() -> tuple[str, int] | None:
    """Parse ``RETH_TPU_FAULT_CRASH_AT=<point>[:nth]`` (nth default 1)."""
    spec = os.environ.get("RETH_TPU_FAULT_CRASH_AT", "")
    if not spec:
        return None
    name, _, nth = spec.partition(":")
    try:
        return name, max(1, int(nth or 1))
    except ValueError:
        return name, 1


def crash_point(point: str) -> None:
    """Die here (``os._exit(137)``) when the drill says so.

    A real crash flushes nothing and runs no handlers — ``os._exit``
    is the honest simulation of ``kill -9`` at an exact code location.
    """
    spec = crash_spec()
    if spec is None or spec[0] != point:
        return
    _hits[point] = _hits.get(point, 0) + 1
    if _hits[point] != spec[1]:
        return
    try:  # flight-record the drill like every other injector, best-effort
        from . import tracing

        tracing.fault_event("RETH_TPU_FAULT_CRASH_AT", target="chaos",
                            point=point, nth=spec[1])
    except Exception:  # noqa: BLE001 - dying is the point
        pass
    sys.stderr.write(f"chaos: crash point {point!r} firing (os._exit)\n")
    sys.stderr.flush()
    os._exit(137)


def inject_bad_crc_record(wal_dir: str | Path, delta: dict) -> None:
    """Append a record whose CRC is deliberately wrong to the newest WAL
    segment — the bit-rot shape. A correct reader discards it as a torn
    tail; the ``RETH_TPU_FAULT_WAL_ACCEPT_TORN`` broken reader applies
    it, and startup recovery's root check must then catch the corruption
    (proving the check can fail)."""
    segs = sorted(Path(wal_dir).glob("*.wal"))
    if not segs:
        raise FileNotFoundError(f"no WAL segments under {wal_dir}")
    payload = pickle.dumps({"seq": 1 << 40, "tables": delta},
                           protocol=pickle.HIGHEST_PROTOCOL)
    bad_crc = (zlib.crc32(payload) ^ 0xDEADBEEF) & 0xFFFFFFFF
    with open(segs[-1], "ab") as f:
        f.write(struct.pack("<II", len(payload), bad_crc) + payload)
        f.flush()
        os.fsync(f.fileno())
