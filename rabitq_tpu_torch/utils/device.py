"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None") -> torch.device:
    """``None`` means the card. Asking for CUDA where there is none raises:
    the entry points never drop to the CPU on their own; a caller that
    wants the CPU passes ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
