"""Task runtime: spawned + critical tasks with graceful shutdown.

A copy of the JAX package's ``tasks.py``; it runs no device work.

Reference analogue: crates/tasks (TaskExecutor/TaskManager: panic-
tolerant critical tasks, shutdown signals, spawn_os_thread). The node's
long-running components (network accept loop, discovery, miner, payload
improvement loops) register here so shutdown is one call that signals
every task and joins it, and a CRITICAL task dying is surfaced instead
of silently stopping (the reference shuts the node down; here the
failure is recorded and an optional callback fires).
"""

from __future__ import annotations

import threading
import traceback


class Shutdown:
    """A one-shot shutdown signal tasks poll or wait on (reference
    crates/tasks/src/shutdown.rs)."""

    def __init__(self):
        self._event = threading.Event()

    def is_set(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._event.wait(timeout)

    def signal(self) -> None:
        self._event.set()


class TaskHandle:
    __slots__ = ("name", "critical", "thread", "error")

    def __init__(self, name: str, critical: bool, thread: threading.Thread):
        self.name = name
        self.critical = critical
        self.thread = thread
        self.error: BaseException | None = None

    @property
    def alive(self) -> bool:
        return self.thread.is_alive()


class TaskExecutor:
    """Spawns named tasks bound to one shutdown signal.

    ``fn`` receives the Shutdown as its first argument and should return
    promptly once it is signalled. A raised exception is captured on the
    handle; for CRITICAL tasks ``on_critical_failure`` also fires (the
    node uses it to begin shutdown, mirroring the reference's
    panicked-task => shutdown behavior)."""

    def __init__(self, on_critical_failure=None):
        self.shutdown = Shutdown()
        self.handles: list[TaskHandle] = []
        self.on_critical_failure = on_critical_failure
        self._lock = threading.Lock()

    def _spawn(self, name: str, critical: bool, fn, args) -> TaskHandle:
        handle: TaskHandle = None  # type: ignore[assignment]

        def run():
            try:
                fn(self.shutdown, *args)
            except BaseException as e:  # noqa: BLE001 — captured, never lost
                handle.error = e
                handle_tb = traceback.format_exc()
                if critical:
                    cb = self.on_critical_failure
                    if cb is not None:
                        cb(name, e, handle_tb)

        thread = threading.Thread(target=run, name=f"reth-tpu/{name}", daemon=True)
        handle = TaskHandle(name, critical, thread)
        with self._lock:
            self.handles.append(handle)
        thread.start()
        return handle

    def spawn(self, name: str, fn, *args) -> TaskHandle:
        return self._spawn(name, critical=False, fn=fn, args=args)

    def spawn_critical(self, name: str, fn, *args) -> TaskHandle:
        return self._spawn(name, critical=True, fn=fn, args=args)

    def critical_errors(self) -> list[tuple[str, BaseException]]:
        with self._lock:
            return [(h.name, h.error) for h in self.handles
                    if h.critical and h.error is not None]

    def graceful_shutdown(self, timeout: float = 10.0) -> list[str]:
        """Signal shutdown and join everything; returns names of tasks
        that failed to stop within the timeout."""
        self.shutdown.signal()
        stuck = []
        with self._lock:
            handles = list(self.handles)
        for h in handles:
            h.thread.join(timeout=timeout)
            if h.thread.is_alive():
                stuck.append(h.name)
        return stuck
