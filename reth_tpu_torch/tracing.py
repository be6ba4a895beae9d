"""Span timing, trace context and the flight recorder of the port.

Port of the part of the JAX package's ``tracing.py`` that the state
commitment reports through: timed spans (``span``, ``record_span``), instant
events (``event``), the trace context carried across queue and pool handoffs
(``TraceContext``, ``current_context``, ``use_context``), and the bounded
flight recorder that a fault drill snapshots to JSONL (``fault_event``,
``flight_dump``). Records have the reference's fields and names, so the same
drill leaves the same record.

Since the engine tree: per-block timelines (``trace_block``, the root span
of one block's import, and ``ensure_timeline`` for spans recorded before it
opens) and their wall-budget summaries (``block_summary``).
Block production and stateless validation record their phases as spans of
their own (the reference records none there), which join the caller's
trace: ``payload.select`` / ``payload.state_root`` /
``payload.ordered_roots`` (``payload/builder.py``), ``witness.execute`` /
``witness.multiproof`` / ``witness.hash_nodes`` / ``witness.close``
(``engine/witness.py``) and ``stateless.reveal`` / ``stateless.execute`` /
``stateless.root`` (``engine/stateless.py``). A block summary keeps the
reference's keys.

Since the RPC: the consumer half of the wire form (``context_from_wire``,
the ``traceparent`` member a request may carry) and ``recent_traces``
(``debug_blockTimeline``).

Since the node: the Chrome trace-event exporter of ``--trace-blocks``
(``ChromeTraceExporter``, ``init_chrome_trace``, ``shutdown_chrome_trace``,
``init_block_tracing``, ``shutdown_block_tracing``), the last closed block's
wall budget and its one-line form (``last_block_summary``,
``format_wall_budget``) and the closed blocks' window
(``recent_block_summaries``).

Not ported here: the OTLP exporter and merged dumps (the health slice), and
the rest of cross-process correlation (the fleet slice: the producer half of
the wire form, process roles, fault observers, trace stitching).

Span recording is off unless ``RETH_TPU_TRACE`` is set truthy or
``set_trace_enabled(True)`` ran; then ``span()`` costs one DEBUG log call.
Events always land in the flight recorder.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import tempfile
import threading
import time
from collections import OrderedDict, deque
from pathlib import Path

_FALSY = ("", "0", "false", "off", "no")


def _env_enabled() -> bool:
    return os.environ.get("RETH_TPU_TRACE", "").lower() not in _FALSY


_TRACE_ON = _env_enabled()
_tls = threading.local()
_span_ids = itertools.count(1)

# span ids carry this process's pid in their high bits, as in the
# reference, so ids from several processes never collide
_SPAN_PID_SHIFT = 40
_SPAN_PID_BITS = os.getpid() & 0x3FFFFF
# the process's role in the flight records and the Chrome trace's process
# metadata (the reference's default; its setter comes with the fleet)
_ROLE = os.environ.get("RETH_TPU_ROLE", "") or "node"


def _new_span_id() -> int:
    return (_SPAN_PID_BITS << _SPAN_PID_SHIFT) | next(_span_ids)


def tracer(target: str) -> logging.Logger:
    """Logger for a target (``trie::sparse`` style)."""
    return logging.getLogger(f"reth_tpu_torch.{target}")


class TraceContext:
    """A propagated trace position: ``trace_id`` (block hash hex for block
    lifecycles) + the current span id (None at the trace root)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str | None, span_id: int | None = None):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"TraceContext({self.trace_id!r}, span={self.span_id})"


def context_from_wire(wire) -> TraceContext | None:
    """Decode a wire-form dict (``{"t": trace_id, "s": span_id, ...}``) back
    into an adoptable context. Tolerates None/garbage — a malformed
    traceparent must never fail the request it rode in on."""
    if not isinstance(wire, dict):
        return None
    trace = wire.get("t")
    if trace is not None and not (isinstance(trace, str) and trace):
        return None
    span = wire.get("s")
    if span is not None and not isinstance(span, int):
        return None
    if trace is None and span is None:
        return None
    return TraceContext(trace, span)


def set_trace_enabled(on: bool) -> None:
    """Master switch for span recording (``RETH_TPU_TRACE``)."""
    global _TRACE_ON
    _TRACE_ON = bool(on)


def trace_enabled() -> bool:
    return _TRACE_ON


def current_context() -> TraceContext | None:
    """The calling thread's trace position (None outside any span, or with
    tracing disabled). Capture it before handing work to a queue or pool;
    the consumer adopts it with :func:`use_context`."""
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def use_context(ctx: TraceContext | None):
    """Adopt a propagated context in a worker thread for the duration of
    the block."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev


@contextlib.contextmanager
def span(target: str, name: str, level: int = logging.DEBUG, **fields):
    """Timed span: logs entry fields and duration; with tracing enabled it
    joins the current thread's trace (parent/child ids) and records into
    the flight recorder."""
    log = tracer(target)
    t0 = time.time()
    parent = None
    ctx = None
    if _TRACE_ON:
        parent = getattr(_tls, "ctx", None)
        ctx = TraceContext(parent.trace_id if parent is not None else None, _new_span_id())
        _tls.ctx = ctx
    err = None
    try:
        yield ctx
    except BaseException as e:
        err = type(e).__name__
        raise
    finally:
        dt = time.time() - t0
        if ctx is not None:
            _tls.ctx = parent
        extra = " ".join(f"{k}={v}" for k, v in fields.items())
        log.log(level, "%s %s took %.3fms", name, extra, dt * 1e3)
        if ctx is not None:
            _record({
                "kind": "span", "target": target, "name": name,
                "ts": t0, "dur_ms": round(dt * 1e3, 3),
                "trace": ctx.trace_id, "span": ctx.span_id,
                "parent": parent.span_id if parent is not None else None,
                "thread": threading.current_thread().name,
                "fields": fields, "error": err,
            })


def record_span(target: str, name: str, start: float, duration: float, *,
                ctx: TraceContext | None = None, fields: dict | None = None,
                error: str | None = None) -> None:
    """Record an already-timed span under ``ctx``: the attribution path for
    work done on another thread than the one that captured the context."""
    if not _TRACE_ON:
        return
    _record({
        "kind": "span", "target": target, "name": name,
        "ts": start, "dur_ms": round(duration * 1e3, 3),
        "trace": ctx.trace_id if ctx is not None else None,
        "span": _new_span_id(),
        "parent": ctx.span_id if ctx is not None else None,
        "thread": threading.current_thread().name,
        "fields": fields or {}, "error": error,
    })


def event(target: str, name: str, **fields) -> None:
    """Instant event (a fault firing). Always lands in the flight
    recorder."""
    ctx = getattr(_tls, "ctx", None) if _TRACE_ON else None
    _record({
        "kind": "event", "target": target, "name": name,
        "ts": time.time(), "dur_ms": 0.0,
        "trace": ctx.trace_id if ctx is not None else None,
        "span": None,
        "parent": ctx.span_id if ctx is not None else None,
        "thread": threading.current_thread().name,
        "fields": fields, "error": None,
    }, always=True)


def _record(rec: dict, always: bool = False) -> None:
    if _TRACE_ON or always:
        _RECORDER.record(rec)
    if _chrome is not None and (_TRACE_ON or always):
        _chrome.export(rec)
    trace = rec.get("trace")
    if trace is None:
        return
    with _TL_LOCK:
        tl = _TIMELINES.get(trace)
        if tl is not None and len(tl) < _MAX_TIMELINE_RECORDS:
            tl.append(rec)


# -- per-block timelines -------------------------------------------------------

_TL_LOCK = threading.Lock()
_TIMELINES: OrderedDict[str, list] = OrderedDict()
_SUMMARIES: OrderedDict[str, dict] = OrderedDict()
_MAX_TRACES = 64
_last_summary: dict | None = None
_MAX_TIMELINE_RECORDS = 8192


@contextlib.contextmanager
def trace_block(trace_id: str, name: str = "block",
                target: str = "engine::block", **fields):
    """Root span of one block lifecycle: ``trace_id`` (the block hash
    hex) seeds every child span on this thread and every explicitly
    propagated context; closing computes the wall-budget summary."""
    if not _TRACE_ON:
        yield None
        return
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = TraceContext(trace_id, None)  # trace seed: root has no parent
    with _TL_LOCK:
        _TIMELINES.setdefault(trace_id, [])
        _TIMELINES.move_to_end(trace_id)
        while len(_TIMELINES) > _MAX_TRACES:
            dead, _ = _TIMELINES.popitem(last=False)
            _SUMMARIES.pop(dead, None)
    try:
        with span(target, name, **fields) as ctx:
            yield ctx
    finally:
        _tls.ctx = prev
        _finalize_block(trace_id)


def ensure_timeline(trace_id: str) -> None:
    """Pre-register a trace timeline so spans recorded BEFORE the block's
    root ``trace_block`` opens still land in it — cross-block speculation
    executes N+1 while N commits, ahead of N+1's own lifecycle."""
    if not _TRACE_ON:
        return
    with _TL_LOCK:
        _TIMELINES.setdefault(trace_id, [])
        _TIMELINES.move_to_end(trace_id)
        while len(_TIMELINES) > _MAX_TRACES:
            dead, _ = _TIMELINES.popitem(last=False)
            _SUMMARIES.pop(dead, None)


def block_timeline(trace_id: str) -> list[dict] | None:
    """All records of one trace (block), oldest first; None if unknown."""
    with _TL_LOCK:
        tl = _TIMELINES.get(trace_id)
        return list(tl) if tl is not None else None


def recent_traces() -> list[str]:
    """Known trace ids, oldest first."""
    with _TL_LOCK:
        return list(_TIMELINES)


def _sum_field(records, names, field) -> float:
    return sum(float(r["fields"].get(field, 0.0)) for r in records
               if r["name"] in names)


def _summarize(trace_id: str, records: list[dict]) -> dict | None:
    root = next((r for r in records
                 if r["kind"] == "span" and r["parent"] is None), None)
    if root is None:
        return None

    def dur_of(name: str) -> float:
        return sum(r["dur_ms"] for r in records
                   if r["kind"] == "span" and r["name"] == name)

    spans = [r for r in records if r["kind"] == "span"]
    # accounted wall: union of direct-child intervals over the root span
    children = sorted(((r["ts"], r["ts"] + r["dur_ms"] / 1e3)
                       for r in spans if r["parent"] == root["span"]))
    covered, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in children:
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                covered += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        covered += cur_hi - cur_lo
    total_ms = root["dur_ms"]
    summary = {
        "trace": trace_id,
        "number": root["fields"].get("number"),
        # closing wall-clock time: the health engine's block-wall SLO rule
        # windows summaries by when the block finished
        "ts": root["ts"] + total_ms / 1e3,
        "total_ms": total_ms,
        "prewarm_ms": round(dur_of("prewarm"), 3),
        # an adopted speculation ran its execute leg as speculate.exec
        # inside the parent's commit window; count it as the exec wall
        "exec_ms": round(dur_of("execute") or dur_of("speculate.exec"), 3),
        "root_ms": round(dur_of("state_root"), 3),
        # hash-service attribution: queue-wait vs device dispatch (with no
        # service the direct hash.dispatch spans carry the dispatch wall)
        "wait_ms": round(_sum_field(records, ("hashsvc.request",), "wait_ms"), 3),
        "dispatch_ms": round(
            _sum_field(records, ("hashsvc.request",), "service_ms")
            if any(r["name"] == "hashsvc.request" for r in records)
            else dur_of("hash.dispatch"), 3),
        "encode_ms": round(dur_of("sparse.encode"), 3),
        "spans": len(spans),
        "coverage": round(covered * 1e3 / total_ms, 4) if total_ms else 1.0,
    }
    return summary


def _finalize_block(trace_id: str) -> None:
    global _last_summary
    records = block_timeline(trace_id)
    if not records:
        return
    summary = _summarize(trace_id, records)
    if summary is None:
        return
    with _TL_LOCK:
        _SUMMARIES[trace_id] = summary
        while len(_SUMMARIES) > _MAX_TRACES:
            _SUMMARIES.popitem(last=False)
    _last_summary = summary


def block_summary(trace_id: str) -> dict | None:
    """Wall-budget summary of one closed block trace."""
    with _TL_LOCK:
        s = _SUMMARIES.get(trace_id)
    if s is not None:
        return s
    records = block_timeline(trace_id)
    return _summarize(trace_id, records) if records else None


def last_block_summary() -> dict | None:
    """The most recently closed block's wall budget (events dashboard)."""
    return _last_summary


def recent_block_summaries(n: int | None = None) -> list[dict]:
    """Closed-block wall budgets, oldest first (bounded by the timeline
    ring) — the health engine's block-import SLO rule averages these over
    its evaluation window."""
    with _TL_LOCK:
        out = list(_SUMMARIES.values())
    return out[-n:] if n else out


def format_wall_budget(s: dict) -> str:
    """The one-line per-block budget operators read:
    ``block N total=Xms = prewarm a + exec b + root c (wait d, dispatch
    e, encode f)``."""
    return (f"block {s.get('number', '?')} total={s['total_ms']:.1f}ms = "
            f"prewarm {s['prewarm_ms']:.1f} + exec {s['exec_ms']:.1f} + "
            f"root {s['root_ms']:.1f} (wait {s['wait_ms']:.1f}, "
            f"dispatch {s['dispatch_ms']:.1f}, encode {s['encode_ms']:.1f})")


# -- flight recorder ----------------------------------------------------------


class FlightRecorder:
    """Bounded ring of recent spans and events, snapshotted to JSONL when a
    RETH_TPU_FAULT_* drill fires, or on demand. Dumps go to ``directory``,
    else ``RETH_TPU_FLIGHT_DIR``, else ``reth_tpu_flight`` under the
    process's temporary directory."""

    def __init__(self, capacity: int = 4096, directory: str | Path | None = None):
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=capacity)
        self.directory = directory
        self.dumps: list[str] = []  # paths written, oldest first
        self.recorded = 0

    def record(self, rec: dict) -> None:
        with self._lock:
            self._buf.append(rec)
            self.recorded += 1

    def snapshot(self, n: int | None = None) -> list[dict]:
        with self._lock:
            out = list(self._buf)
        return out[-n:] if n else out

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def _dir(self) -> Path:
        d = Path(self.directory or os.environ.get("RETH_TPU_FLIGHT_DIR")
                 or Path(tempfile.gettempdir()) / "reth_tpu_flight")
        d.mkdir(parents=True, exist_ok=True)
        return d

    def dump(self, reason: str, path: str | Path | None = None, *,
             correlation_id: str | None = None,
             window: tuple | list | None = None) -> str | None:
        """Write the ring (oldest first) as JSONL: a header line
        ``{"kind": "flight_snapshot", "reason", "ts", "records", "pid",
        "role", "correlation_id", "window"}``, then one line per record;
        ``window`` ([t0, t1] wall seconds) keeps the records of that period.
        Returns the path, or None for an empty ring. Never raises: a
        diagnostics failure must not fail the caller."""
        try:
            records = self.snapshot()
            if window:
                t0, t1 = float(window[0]), float(window[1])
                records = [r for r in records if t0 - 1.0 <= r.get("ts", 0.0) <= t1 + 1.0]
            if not records:
                return None
            if path is None:
                safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in reason)[:60]
                path = self._dir() / f"flight-{safe}-{int(time.time() * 1e3)}-{os.getpid()}.jsonl"
            path = Path(path)
            with open(path, "w") as f:
                f.write(json.dumps({
                    "kind": "flight_snapshot", "reason": reason,
                    "ts": time.time(), "records": len(records),
                    "pid": os.getpid(), "role": _ROLE,
                    "correlation_id": correlation_id,
                    "window": list(window) if window else None}) + "\n")
                for rec in records:
                    f.write(json.dumps(rec, default=str) + "\n")
            self.dumps.append(str(path))
            return str(path)
        except Exception:  # noqa: BLE001 — diagnostics only
            return None


_RECORDER = FlightRecorder()


def flight_recorder() -> FlightRecorder:
    return _RECORDER


def flight_snapshot(n: int | None = None) -> list[dict]:
    return _RECORDER.snapshot(n)


def flight_dump(reason: str, path: str | Path | None = None, *,
                correlation_id: str | None = None,
                window: tuple | list | None = None) -> str | None:
    """Snapshot the flight recorder to JSONL now."""
    return _RECORDER.dump(reason, path, correlation_id=correlation_id, window=window)


def load_flight_dump(path: str | Path) -> tuple[dict, list[dict]]:
    """Parse a flight-recorder dump -> (header, records); a torn last line
    (a process killed mid-write) is dropped."""
    lines = Path(path).read_text().splitlines()
    header = json.loads(lines[0])
    records = []
    for line in lines[1:]:
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError:
            break
    return header, records


_corr_counter = itertools.count(1)
# a fault's dump keeps the records of the CORRELATION_WINDOW_S before it
CORRELATION_WINDOW_S = 30.0
_fault_lock = threading.Lock()
_fault_last_dump: dict[str, float] = {}
FAULT_DUMP_INTERVAL_S = 5.0


def new_correlation_id() -> str:
    """Incident id stamped on a fault's dump: wall-ms + pid + a counter."""
    return f"{int(time.time() * 1e3):x}-{os.getpid():x}-{next(_corr_counter):x}"


def reset_fault_dump_limits() -> None:
    """Forget the per-drill dump rate limits."""
    with _fault_lock:
        _fault_last_dump.clear()


def fault_event(drill: str, target: str = "fault", **fields) -> str | None:
    """A RETH_TPU_FAULT_* drill (or a real failure) fired: record the event
    and snapshot the flight recorder, at most once per
    ``FAULT_DUMP_INTERVAL_S`` per drill name. The dump carries a fresh
    correlation id and the incident's window. Returns the dump's path when
    one was written."""
    event(target, drill, **fields)
    now = time.monotonic()
    with _fault_lock:
        if now - _fault_last_dump.get(drill, 0.0) < FAULT_DUMP_INTERVAL_S:
            return None
        _fault_last_dump[drill] = now
    wall = time.time()
    return flight_dump(drill, correlation_id=new_correlation_id(),
                       window=(wall - CORRELATION_WINDOW_S, wall + 5.0))


# -- Chrome trace-event exporter ------------------------------------------------
# one "X" (complete) event per span, instant events as "i". Written one
# event per line so the file doubles as JSON-lines for tooling; close()
# terminates it into a fully valid JSON array.

_chrome = None


class ChromeTraceExporter:
    """Spans/events as Chrome trace-event JSON (``--trace-blocks``)."""

    def __init__(self, path: str | Path):
        self._lock = threading.Lock()
        self.path = str(path)
        self._f = open(path, "w", buffering=1)
        self._f.write("[\n")
        self._tids: dict[str, int] = {}
        self.exported = 0
        self._named = False  # process metadata emitted?

    def _tid(self, thread_name: str) -> int:
        # caller holds the lock. Distinct pid/tid metadata events per
        # process so MERGED multi-process traces show named, separate
        # process/thread tracks instead of anonymous numeric ids.
        if not self._named:
            self._named = True
            self._f.write(json.dumps(
                {"name": "process_name", "ph": "M", "pid": os.getpid(),
                 "tid": 0, "args": {"name": f"{_ROLE}-{os.getpid()}"}})
                + ",\n")
        tid = self._tids.get(thread_name)
        if tid is None:
            tid = self._tids[thread_name] = len(self._tids) + 1
            self._f.write(json.dumps(
                {"name": "thread_name", "ph": "M", "pid": os.getpid(),
                 "tid": tid, "args": {"name": thread_name}}) + ",\n")
        return tid

    def export(self, rec: dict) -> None:
        args = {k: str(v) for k, v in rec.get("fields", {}).items()}
        if rec.get("trace"):
            args["trace_id"] = rec["trace"]
        if rec.get("span") is not None:
            args["span_id"] = rec["span"]
        if rec.get("parent") is not None:
            args["parent_id"] = rec["parent"]
        if rec.get("error"):
            args["error"] = rec["error"]
        ev = {
            "name": rec["name"],
            "cat": rec["target"],
            "ph": "X" if rec["kind"] == "span" else "i",
            "ts": round(rec["ts"] * 1e6, 1),
            "pid": os.getpid(),
            "args": args,
        }
        if rec["kind"] == "span":
            ev["dur"] = round(rec["dur_ms"] * 1e3, 1)
        else:
            ev["s"] = "p"  # process-scoped instant
        with self._lock:
            ev["tid"] = self._tid(rec.get("thread", "main"))
            self._f.write(json.dumps(ev) + ",\n")
            self.exported += 1

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                # terminate the array so the file is strictly valid JSON
                self._f.write(json.dumps(
                    {"name": "trace_end", "ph": "i", "ts": time.time() * 1e6,
                     "pid": os.getpid(), "tid": 0, "s": "g", "args": {}})
                    + "\n]\n")
                self._f.close()


def init_chrome_trace(path: str | Path) -> ChromeTraceExporter:
    """Install the Chrome trace-event exporter for every recorded span."""
    global _chrome
    _chrome = ChromeTraceExporter(path)
    return _chrome


def shutdown_chrome_trace() -> None:
    global _chrome
    if _chrome is not None:
        _chrome.close()
        _chrome = None


def init_block_tracing(chrome_path: str | Path | None = None,
                       flight_dir: str | Path | None = None,
                       capacity: int | None = None) -> None:
    """The ``--trace-blocks`` bundle: install the Chrome exporter, point
    flight-recorder dumps at a directory, and THEN enable span recording —
    the exporter must exist before the first span can close, or a busy
    worker thread slips whole spans into the gap: recorded in the ring but
    missing from the exported trace. (The reference's ``otlp_path`` comes
    with the OTLP exporter, in the health slice.)"""
    if chrome_path is not None:
        init_chrome_trace(chrome_path)
    if flight_dir is not None:
        _RECORDER.directory = flight_dir
    if capacity is not None and capacity != _RECORDER._buf.maxlen:
        with _RECORDER._lock:
            _RECORDER._buf = deque(_RECORDER._buf, maxlen=capacity)
    set_trace_enabled(True)


def shutdown_block_tracing() -> None:
    shutdown_chrome_trace()
    set_trace_enabled(_env_enabled())
