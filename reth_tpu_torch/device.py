"""Device selection for the port.

Every entry point takes ``device="cuda"`` by default and runs on the card;
it runs on the CPU only when the caller passes ``device="cpu"`` (the tests
do). A CUDA device must be a Hopper card (compute capability 9.0): the
kernels are compiled for ``sm_90a`` only. There is no fallback — a missing
or wrong card raises.
"""

from __future__ import annotations

import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` to run on, checked: ``cpu``, or a Hopper ``cuda``
    device with its index (``"cuda"`` is the current card), so that it
    compares equal to the device of the tensors made on it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        require_sm90(dev)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: expected 'cuda' or 'cpu'")
    return dev


def require_sm90(dev: torch.device) -> None:
    """Raise unless ``dev`` is a visible compute-capability 9.0 card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (pass device='cpu' to run "
                           "the plain PyTorch versions)")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"no CUDA device {index}: {torch.cuda.device_count()} visible")
    cap = torch.cuda.get_device_capability(index)
    if cap != (9, 0):
        raise RuntimeError(
            f"{torch.cuda.get_device_name(index)} has compute capability "
            f"{cap[0]}.{cap[1]}; the kernels are built for sm_90a (Hopper)")


def stream_handle(t: torch.Tensor) -> int:
    """The raw ``cudaStream_t`` of the current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
