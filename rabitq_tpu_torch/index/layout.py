"""Device layout assembler (port of ``rabitq_tpu/index/layout.py``).

Codes live on the device as dense int8 planes ``[Np, Dpad]`` plus flat
per-row factor vectors, rows grouped by cluster, padded to a multiple of
``row_pad`` with invalid tail rows. The fused scan keeps the rows
cluster-sorted (``permute=False``, ``row_pad=TN``), width-pads the refine
plane to 128 columns and adds the packed bit planes; ``permute=True``
scatters rows pseudorandomly (``device_row_permutation``) as the JAX
package's approximate-top-k paths need. :func:`assemble_host_chunks` lays
the same rows out as host slabs for the streamed tier.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.fused_scan import TN, tile_cluster_blocks
from ..ops.packed_scan import pack_bitplanes, pack_bitplanes_np
from ..utils.device import resolve_device
from .scan import device_row_permutation, ex_plane_is_total, make_refine_plane

_ROW_PAD = 128  # default device row padding multiple


def pad_rows(n: int, row_pad: int = _ROW_PAD) -> int:
    """Total device rows for ``n`` real rows."""
    return max(row_pad, ((n + row_pad - 1) // row_pad) * row_pad)


def cluster_of_rows(cluster_sizes: np.ndarray, n_pad: int) -> np.ndarray:
    """Per-row cluster id for cluster-sorted rows ([C] sizes -> [n_pad])."""
    sizes = np.asarray(cluster_sizes, np.int64)
    out = np.zeros(n_pad, np.int32)
    out[: int(sizes.sum())] = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
    return out


def refine_plane_dtype(ex_bits: int) -> torch.dtype:
    """int8 when the refine plane fits (total codes <= 127 or raw ex <=
    127), else int32."""
    return torch.int8 if ex_bits <= 7 else torch.int32


@dataclass
class DeviceLayout:
    """Device-resident arrays in the scan's layout. ``binary`` is None for
    fused layouts whose refine plane holds TOTAL codes (no reader)."""

    binary: torch.Tensor | None  # [Np, Dpad] int8 {0,1}
    ex: torch.Tensor  # [Np, Dpad(+128 pad)] refine plane (scan.make_refine_plane)
    f_add: torch.Tensor  # [Np] f32
    f_rescale: torch.Tensor
    f_error: torch.Tensor
    f_add_ex: torch.Tensor
    f_rescale_ex: torch.Tensor
    cluster_of: torch.Tensor  # [Np] int32
    valid: torch.Tensor  # [Np] bool
    ids: torch.Tensor  # [Np] int32 original ids (-1 on padding)
    centroids: torch.Tensor  # [C, Dpad] f32
    perm: np.ndarray  # host->device row permutation actually used
    delta: torch.Tensor | None = None
    vl: torch.Tensor | None = None
    packed: torch.Tensor | None = None  # [Np, Db] uint8 bit planes (fused layouts)

    def scan_args(self) -> tuple:
        """The positional arguments ``binary`` .. ``ids`` of
        ``scan.scan_kernel``, in order, with ``valid`` as the row mask."""
        return (
            self.binary, self.ex, self.f_add, self.f_rescale, self.f_error, self.f_add_ex,
            self.f_rescale_ex, self.cluster_of, self.valid, self.ids,
        )


def host_order_planes(lay: DeviceLayout, n: int, padded_dim: int, ex_bits: int) -> dict:
    """The first ``n`` rows of a layout in cluster-sorted (host) order, on
    the layout's device, as the raw planes :func:`assemble_device_layout`
    takes: the row permutation undone, the refine plane's width pad dropped,
    ``binary = total >> ex_bits`` where a fused layout dropped the binary
    plane, and ``ex = total - (binary << ex_bits)`` where the refine plane
    holds TOTAL codes. ``delta`` and ``vl`` are left out where the layout
    holds none."""
    pos_of_row = np.empty_like(lay.perm)
    pos_of_row[lay.perm] = np.arange(lay.perm.shape[0])
    take = torch.from_numpy(pos_of_row[:n]).to(lay.ex.device)

    def rows(x):
        return x.index_select(0, take)

    ex = rows(lay.ex)[:, :padded_dim]
    binary = rows(lay.binary) if lay.binary is not None else (ex >> ex_bits).to(torch.int8)
    if ex_plane_is_total(ex_bits):
        ex = ex - (binary << ex_bits)
    names = ("f_add", "f_rescale", "f_error", "f_add_ex", "f_rescale_ex", "delta", "vl")
    planes = {name: rows(getattr(lay, name)) for name in names if getattr(lay, name) is not None}
    return {"binary": binary, "ex": ex, **planes}


def _tensor(x, device) -> torch.Tensor:
    """A tensor on ``device`` from a tensor or a host array (unsigned
    16-bit codes widen to int32 on the device)."""
    if isinstance(x, np.ndarray):
        # a copy: host arrays may be read-only views
        t = torch.from_numpy(x.copy()).to(device)
        return t.to(torch.int32) if t.dtype == torch.uint16 else t
    return torch.as_tensor(x).to(device)


def _pad_permute(x, n: int, n_pad: int, perm: torch.Tensor, dtype, device) -> torch.Tensor:
    """Trim to ``n`` rows, zero-pad to ``n_pad``, apply the permutation."""
    x = _tensor(x[:n], device).to(dtype)
    out = torch.zeros((n_pad, *x.shape[1:]), dtype=dtype, device=device)
    out[:n] = x
    return out.index_select(0, perm)


def assemble_device_layout(
    *,
    n: int,
    ex_bits: int,
    binary,  # [>=n, Dpad] {0,1} codes (numpy or tensor)
    ex,  # [>=n, Dpad] RAW ex codes (not the refine plane)
    f_add,
    f_rescale,
    f_add_ex,
    f_rescale_ex,
    f_error=None,  # omit (or zero_f_error=True) -> zeros, as MSTG's scan wants
    cluster_sizes: np.ndarray,  # [C] rows per cluster, cluster-sorted order
    ids: np.ndarray,  # [n] original ids
    centroids,  # [C, Dpad] f32
    delta=None,
    vl=None,
    zero_f_error: bool = False,
    row_pad: int = _ROW_PAD,
    permute: bool = True,
    keep_binary: bool = False,  # keep the dense binary plane in fused layouts
    # too (with stage-2 refinement off, the 1-bit re-score reads it)
    device: "torch.device | str | None" = None,
) -> DeviceLayout:
    """Build the padded (and, with ``permute``, scattered) device layout
    from cluster-sorted rows, on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    n_pad = pad_rows(n, row_pad)
    perm = (
        device_row_permutation(n, n_pad) if permute else np.arange(n_pad, dtype=np.int64)
    )
    perm_t = torch.from_numpy(perm).to(device)

    cluster_of = cluster_of_rows(cluster_sizes, n_pad)
    valid = np.zeros(n_pad, bool)
    valid[:n] = True
    ids_pad = np.full(n_pad, -1, np.int32)
    ids_pad[:n] = np.asarray(ids)[:n].astype(np.int32)

    binary_t = _tensor(binary[:n], device)
    plane = make_refine_plane(binary_t, _tensor(ex[:n], device), ex_bits)

    def scalar(x):
        return _pad_permute(x, n, n_pad, perm_t, torch.float32, device)

    binary_dev = _pad_permute(binary_t, n, n_pad, perm_t, torch.int8, device)
    packed_dev = None
    if not permute:
        packed_dev = pack_bitplanes(binary_dev, binary_dev.shape[1])
        if ex_plane_is_total(ex_bits) and not keep_binary:
            binary_dev = None  # nothing on the fused TOTAL path reads it

    ex_dev = _pad_permute(plane, n, n_pad, perm_t, refine_plane_dtype(ex_bits), device)
    if not permute and ex_dev.shape[1] % 128:
        # width-pad to 128 columns; zero columns never change a dot
        ex_dev = torch.nn.functional.pad(ex_dev, (0, (-ex_dev.shape[1]) % 128))

    def host_vec(x):
        return torch.from_numpy(x[perm]).to(device)

    return DeviceLayout(
        binary=binary_dev,
        packed=packed_dev,
        ex=ex_dev.contiguous(),
        f_add=scalar(f_add),
        f_rescale=scalar(f_rescale),
        f_error=torch.zeros(n_pad, dtype=torch.float32, device=device)
        if (zero_f_error or f_error is None)
        else scalar(f_error),
        f_add_ex=scalar(f_add_ex),
        f_rescale_ex=scalar(f_rescale_ex),
        cluster_of=host_vec(cluster_of),
        valid=host_vec(valid),
        ids=host_vec(ids_pad),
        centroids=_tensor(centroids, device).to(torch.float32),
        perm=perm,
        delta=scalar(delta) if delta is not None else None,
        vl=scalar(vl) if vl is not None else None,
    )


def assemble_host_chunks(
    *,
    n: int,
    ex_bits: int,
    binary: np.ndarray,
    ex: np.ndarray,
    f_add: np.ndarray,
    f_rescale: np.ndarray,
    f_error: np.ndarray,
    f_add_ex: np.ndarray,
    f_rescale_ex: np.ndarray,
    cluster_sizes: np.ndarray,
    ids: np.ndarray,
    chunk_rows: int,
    zero_f_error: bool = False,
    row_pad: int = _ROW_PAD,
    fused: bool = False,
) -> list[dict]:
    """The device layout as host slabs of ``chunk_rows`` rows (numpy arrays,
    each slab padded with invalid rows), for the streamed tier
    (``index/streaming.py``); the same arrays as the JAX package's.

    Dense scans: one global pseudorandom scatter of the rows
    (``device_row_permutation``), cut into slabs padded to 128 rows.
    ``fused=True``: rows stay cluster-sorted, slabs pad to the bin
    kernels' ``TN`` row tiles, and each
    carries its ``packed`` 1-bit planes and ``cblk`` cluster windows; where
    the refine plane holds TOTAL codes the dense binary plane is left out
    (stage 2 never reads it, and the tier pays for every uploaded byte).
    ``zero_f_error`` zeroes the ``f_error`` slab (MSTG's scan wants none);
    ``row_pad`` pads the dense scans' slabs."""
    if fused:
        row_pad = TN
        perm = np.arange(n, dtype=np.int64)
    else:
        perm = device_row_permutation(n, n)[:n]
    cluster_of = cluster_of_rows(cluster_sizes, n)[perm]
    ids_p = np.asarray(ids).astype(np.int32)[perm]
    binary_p = np.asarray(binary)[perm]
    plane = np.asarray(make_refine_plane(binary_p, np.asarray(ex)[perm], ex_bits))
    ex_dt = np.int8 if ex_bits <= 7 else np.int32  # refine_plane_dtype, as numpy
    scal = {
        "f_add": np.asarray(f_add, np.float32)[perm],
        "f_rescale": np.asarray(f_rescale, np.float32)[perm],
        "f_error": np.zeros(n, np.float32)
        if zero_f_error
        else np.asarray(f_error, np.float32)[perm],
        "f_add_ex": np.asarray(f_add_ex, np.float32)[perm],
        "f_rescale_ex": np.asarray(f_rescale_ex, np.float32)[perm],
    }

    chunks = []
    for s in range(0, n, chunk_rows):
        e = min(s + chunk_rows, n)
        rows = e - s
        m = rows + ((-rows) % row_pad)

        def pad2(x, dtype):
            out = np.zeros((m, x.shape[1]), dtype)
            out[:rows] = x[s:e]
            return out

        def pad1(x, fill=0):
            out = np.full(m, fill, x.dtype)
            out[:rows] = x[s:e]
            return out

        valid = np.zeros(m, bool)
        valid[:rows] = True
        chunk = dict(
            binary=pad2(binary_p, np.int8),
            ex=pad2(plane, ex_dt),
            cluster_of=pad1(cluster_of),
            ids=pad1(ids_p, fill=-1),
            valid=valid,
            **{k: pad1(v) for k, v in scal.items()},
        )
        if fused:
            chunk["packed"] = pack_bitplanes_np(chunk["binary"], chunk["binary"].shape[1])
            chunk["cblk"] = tile_cluster_blocks(chunk["cluster_of"], valid)
            if ex_plane_is_total(ex_bits):
                del chunk["binary"]
        chunks.append(chunk)
    return chunks
