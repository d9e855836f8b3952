"""Device resolution for every entry point of the port.

The port runs on the card unless the caller asks for the CPU: the
default ``device=None`` means ``"cuda"``, and a machine without CUDA
raises :class:`DeviceUnavailableError` instead of quietly running the
plain PyTorch versions on the host.  ``device="cpu"`` is the explicit
request for those plain versions (the CPU tests pass it).
"""

from __future__ import annotations

import torch


class DeviceUnavailableError(RuntimeError):
    """The requested device cannot run the port (no CUDA, or a device
    type the port has no path for)."""


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; ``cuda`` only when CUDA is available;
    ``cpu`` only when asked for.  Returns a ``torch.device``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                "CUDA is not available on this machine: the port runs "
                "on the card by default; pass device=\"cpu\" to run its "
                "plain PyTorch versions on the CPU")
        return dev
    if dev.type == "cpu":
        return dev
    raise DeviceUnavailableError(
        f"device {dev} is not supported: the port runs on 'cuda', or "
        f"on 'cpu' when asked for")
