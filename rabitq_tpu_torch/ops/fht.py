"""Fast Walsh-Hadamard transform: plain version and CUDA kernel.

Counterpart of ``rabitq_tpu/ops/pallas_fht.py``. :func:`fht` is what the
rotators call: a CUDA tensor goes to the hand-written kernel
(``csrc/fht.cu``), a CPU tensor to :func:`fht_plain`. Both run the
reference butterfly (``rotation.rs:292-312``): stage h maps each pair
(j, j + h) with ``j & h == 0`` to ``(x[j] + x[j+h], x[j] - x[j+h])``, one f32
add or subtract per element, so kernel and plain results are bitwise equal.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda


def _log2(n: int) -> int:
    if n <= 0 or n & (n - 1):
        raise ValueError(f"FHT requires a power-of-2 length, got {n}")
    return n.bit_length() - 1


def fht_plain(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized FHT along the last axis as log2(n) butterflies (the
    port's copy of ``rabitq_tpu.ops.rotation.fht``); any device."""
    n = x.shape[-1]
    batch_shape = x.shape[:-1]
    for step in range(_log2(n)):
        h = 1 << step
        y = x.reshape(*batch_shape, n // (2 * h), 2, h)
        a = y[..., 0, :]
        b = y[..., 1, :]
        x = torch.stack([a + b, a - b], dim=-2).reshape(*batch_shape, n)
    return x


def fht_np(x: np.ndarray) -> np.ndarray:
    """Host numpy FHT mirroring :func:`fht_plain` (host-side build flows)."""
    n = x.shape[-1]
    batch_shape = x.shape[:-1]
    for step in range(_log2(n)):
        h = 1 << step
        y = x.reshape(*batch_shape, n // (2 * h), 2, h)
        a = y[..., 0, :]
        b = y[..., 1, :]
        x = np.stack([a + b, a - b], axis=-2).reshape(*batch_shape, n)
    return x


def fht_supported(n: int) -> bool:
    """Whether the kernel takes rows of length ``n``: any power of two (rows
    longer than 32768 finish their last stages in device memory)."""
    return n >= 1 and n & (n - 1) == 0


def fht_kernel(x: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel on a contiguous f32 CUDA tensor ``[..., n]`` of any
    size. ``fht_kernel.launches`` counts its launches."""
    n = x.shape[-1]
    if not x.is_cuda:
        raise ValueError("fht_kernel needs a CUDA tensor")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("fht_kernel needs a contiguous float32 tensor")
    _log2(n)
    if x.data_ptr() % 16:
        x = x.clone()  # the kernel reads rows as 16-byte vectors
    out = torch.empty_like(x)
    rows = x.numel() // n
    if rows:
        fn = _cuda.entry("fht")
        err = fn(
            x.data_ptr(), out.data_ptr(), rows, n,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        _cuda.check_launch(err, "fht")
        fht_kernel.launches += 1
    return out


fht_kernel.launches = 0


def fht(x: torch.Tensor) -> torch.Tensor:
    """FHT along the last axis: the kernel for a CUDA tensor, the plain
    butterflies for a CPU tensor."""
    if x.is_cuda:
        return fht_kernel(x.contiguous())
    if x.device.type != "cpu":
        raise ValueError(f"no FHT for device {x.device}")
    return fht_plain(x)
