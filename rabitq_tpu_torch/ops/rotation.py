"""Random rotators (port of ``rabitq_tpu/ops/rotation.py``).

* ``FhtKacRotator`` -- 4 rounds of (sign flip -> FHT -> rescale), with Kac's
  walk mixing for non-power-of-2 dims, padding to a multiple of 64
  (reference ``rotation.rs:238-400``). The FHT goes through
  :func:`..ops.fht.fht`: the CUDA kernel on the card, plain butterflies on
  the CPU.
* ``MatrixRotator`` -- a random orthonormal matrix applied as one matmul.

Both draw their randomness from numpy with the reference package's seeds and
serialize byte-compatibly with it, so a rotator carried across from the JAX
package rotates identically.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import InvalidPersistence
from ..types import RotatorType
from .fht import fht, fht_np


def _floor_log2(x: int) -> int:
    return x.bit_length() - 1


def kacs_walk(x: torch.Tensor) -> torch.Tensor:
    """Kac's walk mixing step (``rotation.rs:315-324``): halves (a, b) ->
    (a + b, a - b)."""
    half = x.shape[-1] // 2
    a = x[..., :half]
    b = x[..., half:]
    return torch.cat([a + b, a - b], dim=-1)


def _pad_last(x: torch.Tensor, width: int) -> torch.Tensor:
    pad = width - x.shape[-1]
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


class FhtKacRotator:
    """FHT + Kac-walk rotator (``rotation.rs:238-511``). Flip bits live on
    the host; the sign vectors are copied to each device on first use."""

    rotator_type = RotatorType.FhtKacRotator

    def __init__(self, dim: int, seed: int | None = 0, flip: np.ndarray | None = None):
        padded_dim = RotatorType.FhtKacRotator.padding_requirement(dim)
        self.dim = dim
        self.padded_dim = padded_dim
        flip_bytes = 4 * padded_dim // 8
        if flip is None:
            rng = np.random.default_rng(seed)
            flip = rng.integers(0, 256, size=flip_bytes, dtype=np.uint8)
        else:
            flip = np.asarray(flip, dtype=np.uint8)
            if flip.size != flip_bytes:
                raise InvalidPersistence("FHT rotator flip bits length mismatch")
        self.flip = flip
        # LSB-first bit order within each byte (rotation.rs:278-289).
        bits = np.unpackbits(flip.reshape(4, padded_dim // 8), axis=-1, bitorder="little")
        self._signs_np = (1.0 - 2.0 * bits.astype(np.float32)).astype(np.float32)
        self._signs: dict[torch.device, torch.Tensor] = {}
        self.trunc_dim = 1 << _floor_log2(dim)
        self.fac = 1.0 / float(np.sqrt(self.trunc_dim))

    def serialize(self) -> bytes:
        return self.flip.tobytes()

    @staticmethod
    def deserialize(dim: int, padded_dim: int, data: bytes) -> "FhtKacRotator":
        if len(data) != 4 * padded_dim // 8:
            raise InvalidPersistence("FHT rotator flip bits length mismatch")
        return FhtKacRotator(dim, flip=np.frombuffer(data, dtype=np.uint8).copy())

    def signs(self, device: torch.device) -> torch.Tensor:
        s = self._signs.get(device)
        if s is None:
            s = self._signs[device] = torch.from_numpy(self._signs_np).to(device)
        return s

    def rotate(self, x: torch.Tensor) -> torch.Tensor:
        """Forward rotation: [..., dim] -> [..., padded_dim]
        (``rotation.rs:350-401``)."""
        x = x.to(torch.float32)
        if x.shape[-1] != self.dim:
            raise ValueError(f"rotate expects width {self.dim}, got {x.shape[-1]}")
        signs = self.signs(x.device)
        out = _pad_last(x, self.padded_dim)
        trunc, padded, fac = self.trunc_dim, self.padded_dim, self.fac
        if trunc == padded:
            for r in range(4):
                out = out * signs[r]
                out = fht(out) * fac
            return out
        start = padded - trunc
        for r in range(4):
            out = out * signs[r]
            if r % 2 == 0:
                head = fht(out[..., :trunc].contiguous()) * fac
                out = torch.cat([head, out[..., trunc:]], dim=-1)
            else:
                tail = fht(out[..., start:].contiguous()) * fac
                out = torch.cat([out[..., :start], tail], dim=-1)
            out = kacs_walk(out)
        return out * 0.25

    def rotate_np(self, x: np.ndarray) -> np.ndarray:
        """Host numpy forward rotation, numerically mirroring :meth:`rotate`."""
        x = np.ascontiguousarray(x, np.float32)
        pad = self.padded_dim - x.shape[-1]
        if pad:
            x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
        out = x
        signs = self._signs_np
        trunc, padded, fac = self.trunc_dim, self.padded_dim, self.fac
        if trunc == padded:
            for r in range(4):
                out = (out * signs[r]).astype(np.float32)
                out = (fht_np(out) * np.float32(fac)).astype(np.float32)
            return out
        start = padded - trunc
        for r in range(4):
            out = (out * signs[r]).astype(np.float32)
            if r % 2 == 0:
                head = (fht_np(out[..., :trunc]) * np.float32(fac)).astype(np.float32)
                out = np.concatenate([head, out[..., trunc:]], axis=-1)
            else:
                tail = (fht_np(out[..., start:]) * np.float32(fac)).astype(np.float32)
                out = np.concatenate([out[..., :start], tail], axis=-1)
            a = out[..., : padded // 2]
            b = out[..., padded // 2 :]
            out = np.concatenate([a + b, a - b], axis=-1).astype(np.float32)
        return (out * np.float32(0.25)).astype(np.float32)

    def inverse_rotate(self, y: torch.Tensor) -> torch.Tensor:
        """Inverse rotation: [..., padded_dim] -> [..., dim]
        (``rotation.rs:410-480``)."""
        y = y.to(torch.float32)
        if y.shape[-1] != self.padded_dim:
            raise ValueError(f"inverse_rotate expects width {self.padded_dim}")
        signs = self.signs(y.device)
        trunc, padded, fac = self.trunc_dim, self.padded_dim, self.fac
        out = y
        if trunc == padded:
            for r in reversed(range(4)):
                out = fht(out / fac) / float(padded)
                out = out * signs[r]
            return out[..., : self.dim]
        start = padded - trunc
        out = out * 4.0
        for r in reversed(range(4)):
            out = kacs_walk(out * 0.5)
            if r % 2 == 0:
                head = fht((out[..., :trunc] / fac).contiguous()) / float(trunc)
                out = torch.cat([head, out[..., trunc:]], dim=-1)
            else:
                tail = fht((out[..., start:] / fac).contiguous()) / float(trunc)
                out = torch.cat([out[..., :start], tail], dim=-1)
            out = out * signs[r]
        return out[..., : self.dim]


class MatrixRotator:
    """Random orthonormal matrix rotator (``rotation.rs:73-233``), drawn by
    QR of a numpy Gaussian matrix exactly as the JAX package draws it."""

    rotator_type = RotatorType.MatrixRotator

    def __init__(self, dim: int, seed: int | None = 0, matrix: np.ndarray | None = None):
        padded_dim = RotatorType.MatrixRotator.padding_requirement(dim)
        self.dim = dim
        self.padded_dim = padded_dim
        if matrix is None:
            rng = np.random.default_rng(seed)
            g = rng.standard_normal((padded_dim, padded_dim)).astype(np.float64)
            q, r = np.linalg.qr(g)
            q = q * np.sign(np.diag(r))[None, :]
            matrix = q.T.astype(np.float32)  # rows orthonormal
        else:
            matrix = np.asarray(matrix, dtype=np.float32).reshape(padded_dim, padded_dim)
        self._matrix_np = matrix
        self._matrix: dict[torch.device, torch.Tensor] = {}

    def serialize(self) -> bytes:
        return self._matrix_np.astype("<f4").tobytes()

    @staticmethod
    def deserialize(dim: int, padded_dim: int, data: bytes) -> "MatrixRotator":
        if len(data) != padded_dim * padded_dim * 4:
            raise InvalidPersistence("rotator matrix length mismatch")
        m = np.frombuffer(data, dtype="<f4").reshape(padded_dim, padded_dim).copy()
        return MatrixRotator(dim, matrix=m)

    def matrix(self, device: torch.device) -> torch.Tensor:
        m = self._matrix.get(device)
        if m is None:
            m = self._matrix[device] = torch.from_numpy(self._matrix_np).to(device)
        return m

    def rotate(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        if x.shape[-1] != self.dim:
            raise ValueError(f"rotate expects width {self.dim}, got {x.shape[-1]}")
        # output[row] = sum_j matrix[row, j] * x[j]  ->  x @ M^T
        return _pad_last(x, self.padded_dim) @ self.matrix(x.device).T

    def rotate_np(self, x: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x, np.float32)
        pad = self.padded_dim - self.dim
        if pad:
            x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
        return x @ self._matrix_np.T

    def inverse_rotate(self, y: torch.Tensor) -> torch.Tensor:
        y = y.to(torch.float32)
        return (y @ self.matrix(y.device))[..., : self.dim]


Rotator = FhtKacRotator | MatrixRotator


def make_rotator(dim: int, rotator_type: RotatorType, seed: int | None = 0) -> Rotator:
    """Factory matching the reference ``DynamicRotator::new``."""
    if rotator_type == RotatorType.MatrixRotator:
        return MatrixRotator(dim, seed)
    return FhtKacRotator(dim, seed)


def deserialize_rotator(
    dim: int, padded_dim: int, rotator_type: RotatorType, data: bytes
) -> Rotator:
    """Matches ``DynamicRotator::deserialize`` (``rotation.rs:591-605``)."""
    if rotator_type == RotatorType.MatrixRotator:
        return MatrixRotator.deserialize(dim, padded_dim, data)
    return FhtKacRotator.deserialize(dim, padded_dim, data)
