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


def rows_on_device(data, data_dev=None, device=None) -> torch.Tensor:
    """The f32 rows a build step works on, as the JAX package's ``data`` /
    ``data_dev`` pair: ``data_dev`` (the same rows already uploaded) where
    given, else ``data`` (a host array or a tensor). The device is
    ``device`` where given, else the tensor's own, else the card."""
    rows = data if data_dev is None else data_dev
    if device is None and isinstance(rows, torch.Tensor):
        dev = rows.device
    else:
        dev = resolve_device(device)
    return torch.as_tensor(rows, dtype=torch.float32, device=dev)


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
