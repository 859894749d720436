"""Host->device dataset upload with reduced-precision encoding (port of
``rabitq_tpu/utils/transfer.py``).

Builds quantize residuals whose magnitude dwarfs the rounding of a cheaper
upload encoding, so a large host dataset crosses the link in fewer bytes:

- ``bf16`` halves the bytes (round to nearest even, as numpy's bfloat16);
- ``int8`` quarters them with a per-row symmetric scale;
- ``auto`` keeps datasets up to 512 MB exact (f32) and sends larger ones
  bf16, as the JAX package does.

The device copy is always f32, decoded on the device, so every consumer is
encoding-agnostic and decodes to the values the JAX package's upload gives.
A tensor already on the target device crosses no link and is used as is.
``warm_session`` pays the process's device set-up before timed work.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .device import resolve_device, synchronize
from .logging import get_logger

_AUTO_THRESHOLD_BYTES = 512 * 1024 * 1024


def warm_session(device: "str | torch.device | None" = None) -> float:
    """Pay the process's one-time device set-up (on the card: the CUDA
    context and the first launch) before timed work, so that it lands in
    an explicit figure; returns the seconds spent, rounded to 0.01 as the
    JAX package's ``warm_session`` does. ``device=None`` means the card."""
    dev = resolve_device(device)
    t0 = time.time()
    torch.zeros((8, 128), dtype=torch.float32, device=dev).sum().item()
    synchronize(dev)
    return round(time.time() - t0, 2)


def resolve_encoding(data, encoding: str = "auto") -> str:
    """The encoding ``upload_dataset`` uses for ``data`` (an array or a
    tensor): ``auto`` is bf16 above 512 MB, f32 below."""
    if encoding == "auto":
        nbytes = data.nbytes if isinstance(data, np.ndarray) else data.numel() * data.element_size()
        return "bf16" if nbytes > _AUTO_THRESHOLD_BYTES else "f32"
    if encoding not in ("f32", "bf16", "int8"):
        raise ValueError(f"unknown dataset upload encoding {encoding!r}")
    return encoding


def upload_dataset(
    data, encoding: str = "auto", chunk_rows: int = 262_144, *,
    device: "str | torch.device | None" = None,
) -> tuple[torch.Tensor, dict]:
    """Upload [N, dim] rows to ``device`` (``None``: the card); returns (f32
    tensor, report dict with ``encoding``, ``bytes``, ``seconds``,
    ``mb_per_s``).

    Host rows are converted and copied ``chunk_rows`` at a time, which bounds
    the host memory an mmap-backed input costs. A tensor already on
    ``device`` is returned as it is (f32), with ``encoding`` "resident" and
    no bytes sent."""
    device = resolve_device(device)
    if isinstance(data, torch.Tensor):
        if device.type == "cuda" and device.index is None and data.is_cuda:
            device = torch.device("cuda", torch.cuda.current_device())  # "cuda": this card
        if data.device == device:
            return data.to(torch.float32), {
                "encoding": "resident", "bytes": 0, "seconds": 0.0, "mb_per_s": 0.0}
        data = data.detach().cpu().numpy()
    requested = encoding
    encoding = resolve_encoding(data, encoding)
    if requested == "auto" and encoding != "f32":
        get_logger("transfer").info(
            "dataset upload auto-selected %s encoding (%.0f MB > %d MB threshold); pass "
            "data_upload='f32' for bit-exact uploads",
            encoding, data.nbytes / 1e6, _AUTO_THRESHOLD_BYTES // (1024 * 1024),
        )
    n = data.shape[0]
    if n == 0:
        return torch.zeros(data.shape, dtype=torch.float32, device=device), {
            "encoding": encoding, "bytes": 0, "seconds": 0.0, "mb_per_s": 0.0}
    t0 = time.time()
    sent_bytes = 0
    out = torch.empty(data.shape, dtype=torch.float32, device=device)
    for s in range(0, n, chunk_rows):
        blk = np.ascontiguousarray(data[s : s + chunk_rows], np.float32)
        # torch.from_numpy refuses to share a read-only buffer (an mmap)
        blk = torch.from_numpy(blk if blk.flags.writeable else blk.copy())
        if encoding == "f32":
            enc, scale = blk, None
        elif encoding == "bf16":
            enc, scale = blk.to(torch.bfloat16), None
        else:  # int8, symmetric per-row scale
            sc = np.maximum(np.abs(blk.numpy()).max(axis=1), 1e-30) / 127.0
            q = np.clip(np.rint(blk.numpy() / sc[:, None]), -127, 127).astype(np.int8)
            enc, scale = torch.from_numpy(q), torch.from_numpy(sc.astype(np.float32))
        sent_bytes += enc.numel() * enc.element_size()
        dec = enc.to(device).to(torch.float32)
        if scale is not None:
            dec = dec * scale.to(device)[:, None]
        out[s : s + blk.shape[0]] = dec
    synchronize(device)
    dt = time.time() - t0
    report = {
        "encoding": encoding,
        "bytes": int(sent_bytes),
        "seconds": round(dt, 2),
        "mb_per_s": round(sent_bytes / 1e6 / max(dt, 1e-9), 1),
    }
    return out, report
