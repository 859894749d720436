"""Query encoding on the card: plain version and CUDA kernel.

Raw f32 query rows become the upload encoding that the fused search decodes
(``index/scan.decode_queries``): symmetric int8 codes, or int4 nibble pairs
(low nibble the even dim), with each row's f32 scale, zero-padded to the
block's rows. :func:`encode_rows_kernel` (``csrc/encode_queries.cu``) and
:func:`encode_rows_plain` give bit for bit what the host's numpy encoding
gives (``index/scan._encode``, ``pack_int4_queries``): the scale is
``max(max |x|, 1e-30) / qmax`` in f32 (a NaN kept), the code is ``x / scale``
rounded half to even and clipped to ``+-qmax``, and a code that comes out NaN
is 0. An index on the card encodes its query blocks with the kernel
(``index/scan.QueryStage``); an index on the CPU keeps the numpy encoding.
"""

from __future__ import annotations

import torch

from . import _cuda

BITS = {"int8": 8, "int4": 4}  # upload encodings with codes and a scale


def _qmax(bits: int) -> int:
    if bits not in (8, 4):
        raise ValueError(f"query codes are 8 or 4 bits, got {bits}")
    return (1 << (bits - 1)) - 1


def encode_rows_plain(rows: torch.Tensor, b_pad: int, bits: int):
    """The plain version of :func:`encode_rows_kernel`, torch ops on ``rows``'
    device."""
    qmax = _qmax(bits)
    rows = rows.detach().to(torch.float32)
    n, dim = rows.shape
    x = torch.zeros((b_pad, dim), dtype=torch.float32, device=rows.device)
    x[:n] = rows
    amax = x.abs().amax(dim=1)
    # tensor divisors: a scalar one may be taken as a product with its inverse
    scale = torch.maximum(amax, torch.full_like(amax, 1e-30)) / torch.full_like(amax, qmax)
    r = torch.round(x / scale[:, None]).clamp(-qmax, qmax)
    codes = torch.where(torch.isnan(r), 0.0, r).to(torch.int8)
    if bits == 8:
        return codes, scale
    c = torch.nn.functional.pad(codes, (0, dim % 2)).to(torch.int32)
    return ((c[:, 0::2] & 0xF) | ((c[:, 1::2] & 0xF) << 4)).to(torch.uint8), scale


def encode_rows_kernel(rows: torch.Tensor, b_pad: int, bits: int):
    """The CUDA kernel on ``rows`` [n, dim] f32 on the card, ``n <= b_pad``:
    (codes [b_pad, dim] int8, or [b_pad, ceil(dim / 2)] uint8 nibble pairs for
    ``bits`` 4; scale [b_pad] f32), rows from ``n`` on padding. One launch,
    no host sync. ``encode_rows_kernel.launches`` counts its launches."""
    _qmax(bits)
    if not rows.is_cuda or rows.dim() != 2:
        raise ValueError("encode_rows_kernel needs [n, dim] rows on the card")
    dev = rows.device
    rows = rows.contiguous()
    _cuda.check_inputs([(rows, torch.float32)], dev, "encode_rows_kernel")
    n, dim = rows.shape
    if n > b_pad:
        raise ValueError(f"encode_rows_kernel: {n} rows padded to {b_pad}")
    width, dtype = (dim, torch.int8) if bits == 8 else ((dim + 1) // 2, torch.uint8)
    codes = torch.empty((b_pad, width), dtype=dtype, device=dev)
    scale = torch.empty(b_pad, dtype=torch.float32, device=dev)
    if b_pad and dim:
        err = _cuda.entry("encode_queries")(
            rows.data_ptr(), codes.data_ptr(), scale.data_ptr(), n, b_pad, dim, bits,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _cuda.check_launch(err, "encode_queries")
        encode_rows_kernel.launches += 1
    return codes, scale


encode_rows_kernel.launches = 0


def encode_rows(rows: torch.Tensor, b_pad: int, upload_dtype: str):
    """(q, qscale | None) of ``rows`` [n, dim] f32 on the card zero-padded to
    ``b_pad`` rows in the upload encoding: "int8" / "int4" the kernel, "bf16"
    a cast, f32 for any other value."""
    if not rows.is_cuda:
        raise ValueError("encode_rows needs rows on the card (an index on the CPU encodes "
                         "with numpy: index/scan.encode_queries)")
    bits = BITS.get(upload_dtype)
    if bits is not None:
        return encode_rows_kernel(rows, b_pad, bits)
    q = torch.nn.functional.pad(rows, (0, 0, 0, b_pad - rows.shape[0]))
    return (q.to(torch.bfloat16) if upload_dtype == "bf16" else q), None
