"""CUDA kernels of the state commitment and their PyTorch wrappers.

Each kernel lives in its own source under ``csrc/``; each wrapper launches
it for a CUDA tensor, runs the plain PyTorch version beside it for a CPU
tensor, and counts its launches in a plain integer (``<wrapper>.launches``).

The package also holds the device control plane around them: the
supervisor (``supervisor.py``), warm-up and its compile cache
(``warmup.py``) and the shared hash service (``hash_service.py``).
"""

from .hash_service import (
    HashClient,
    HashFuture,
    HashService,
    LaneOverloaded,
    ServiceFaultInjector,
)
from .keccak import KeccakDevice
from .supervisor import (
    CircuitBreaker,
    DeviceSupervisor,
    FaultInjector,
    SupervisedBackend,
    SupervisedHasher,
    probe_device,
    probe_device_retrying,
)
from .warmup import (
    CompileCache,
    MenuShape,
    WarmupManager,
    build_warmup,
    default_menu,
)

__all__ = [
    "CompileCache",
    "MenuShape",
    "WarmupManager",
    "build_warmup",
    "default_menu",
    "KeccakDevice",
    "CircuitBreaker",
    "DeviceSupervisor",
    "FaultInjector",
    "SupervisedBackend",
    "SupervisedHasher",
    "probe_device",
    "probe_device_retrying",
    "HashClient",
    "HashFuture",
    "HashService",
    "LaneOverloaded",
    "ServiceFaultInjector",
]
