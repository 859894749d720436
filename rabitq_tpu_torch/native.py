"""ctypes loader for the native C++ host codecs (counterpart of
``rabitq_tpu/native.py``).

``native/packing.cpp`` (bit packing, the 2-/6-bit C++ ex-code packings, the
FastScan batch transpose, CRC32) is compiled with ``g++`` into
``_build/librbq_native-<hash>.so`` (the hash is of the source, so an edited
source builds anew). Opt-in, as in the JAX package: the library is used
once it is built, by :func:`load` with ``build=True`` or an earlier process;
otherwise ``ops/packing.py`` runs its numpy codecs. Both give the same
bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG.parent / "native" / "packing.cpp"
BUILD_DIR = _PKG / "_build"

_LIB = None
_TRIED = False


def library_path() -> Path | None:
    """Where the library of the current source lives; None without the
    source (an installed package without the repository's ``native/``)."""
    if not SOURCE.exists():
        return None
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"librbq_native-{digest}.so"


def _build(path: Path) -> bool:
    """Compile the source into ``path`` (through a temporary file and a
    rename, so that a concurrent build never loads a half-written library).
    No ``-march=native``: the library may be loaded on another host than the
    one that built it. False where ``g++`` is missing or refuses."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-o", tmp, str(SOURCE)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load(build: bool = False):
    """The loaded library, or None. ``build=True`` compiles it first where
    it is missing."""
    global _LIB, _TRIED
    if _LIB is not None:
        return _LIB
    if _TRIED and not build:
        return None
    _TRIED = True
    path = library_path()
    if path is None:
        return None
    if not path.exists() and build:
        _build(path)
    if not path.exists():
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    if lib.rbq_native_abi_version() != 1:
        return None

    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    sz = ctypes.c_size_t
    lib.rbq_pack_binary.argtypes = [u8p, sz, sz, u8p]
    lib.rbq_unpack_binary.argtypes = [u8p, sz, sz, u8p]
    lib.rbq_pack_ex_generic.argtypes = [u16p, sz, sz, ctypes.c_int, u8p]
    lib.rbq_unpack_ex_generic.argtypes = [u8p, sz, sz, ctypes.c_int, u16p]
    lib.rbq_pack_ex_2bit.argtypes = [u16p, sz, sz, u8p]
    lib.rbq_unpack_ex_2bit.argtypes = [u8p, sz, sz, u16p]
    lib.rbq_pack_ex_6bit.argtypes = [u16p, sz, sz, u8p]
    lib.rbq_unpack_ex_6bit.argtypes = [u8p, sz, sz, u16p]
    lib.rbq_pack_codes.argtypes = [u8p, sz, sz, u8p]
    lib.rbq_unpack_codes.argtypes = [u8p, sz, sz, u8p]
    lib.rbq_crc32.argtypes = [ctypes.c_uint32, u8p, sz]
    lib.rbq_crc32.restype = ctypes.c_uint32
    for fn in ("rbq_pack_binary", "rbq_unpack_binary", "rbq_pack_ex_generic",
               "rbq_unpack_ex_generic", "rbq_pack_ex_2bit", "rbq_unpack_ex_2bit",
               "rbq_pack_ex_6bit", "rbq_unpack_ex_6bit", "rbq_pack_codes", "rbq_unpack_codes"):
        getattr(lib, fn).restype = None
    _LIB = lib
    return lib


def available() -> bool:
    return load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _rows(a: np.ndarray) -> int:
    return int(np.prod(a.shape[:-1])) if a.ndim > 1 else 1


# --- numpy-facing wrappers (each makes its input contiguous) ---------------

def pack_binary(bits: np.ndarray) -> np.ndarray:
    """[..., D] {0,1} -> [..., ceil(D/8)] bytes, MSB-first."""
    lib = load()
    bits = np.ascontiguousarray(bits, np.uint8)
    dim = bits.shape[-1]
    out = np.empty((*bits.shape[:-1], (dim + 7) // 8), np.uint8)
    lib.rbq_pack_binary(_ptr(bits, ctypes.c_uint8), _rows(bits), dim, _ptr(out, ctypes.c_uint8))
    return out


def unpack_binary(packed: np.ndarray, dim: int) -> np.ndarray:
    lib = load()
    packed = np.ascontiguousarray(packed, np.uint8)
    out = np.empty((*packed.shape[:-1], dim), np.uint8)
    lib.rbq_unpack_binary(
        _ptr(packed, ctypes.c_uint8), _rows(packed), dim, _ptr(out, ctypes.c_uint8)
    )
    return out


def pack_ex_generic(ex: np.ndarray, ex_bits: int) -> np.ndarray:
    """LSB-first bitstream of ``ex_bits`` bits a code."""
    lib = load()
    ex = np.ascontiguousarray(ex, np.uint16)
    dim = ex.shape[-1]
    out = np.empty((*ex.shape[:-1], (dim * ex_bits + 7) // 8), np.uint8)
    lib.rbq_pack_ex_generic(
        _ptr(ex, ctypes.c_uint16), _rows(ex), dim, ex_bits, _ptr(out, ctypes.c_uint8)
    )
    return out


def unpack_ex_generic(packed: np.ndarray, dim: int, ex_bits: int) -> np.ndarray:
    lib = load()
    packed = np.ascontiguousarray(packed, np.uint8)
    out = np.empty((*packed.shape[:-1], dim), np.uint16)
    lib.rbq_unpack_ex_generic(
        _ptr(packed, ctypes.c_uint8), _rows(packed), dim, ex_bits, _ptr(out, ctypes.c_uint16)
    )
    return out


def pack_ex_cpp(ex: np.ndarray, ex_bits: int) -> np.ndarray:
    """The C++-compatible 2- or 6-bit packing (``dim % 16 == 0``)."""
    lib = load()
    ex = np.ascontiguousarray(ex, np.uint16)
    dim = ex.shape[-1]
    out = np.empty((*ex.shape[:-1], dim // 16 * (4 if ex_bits == 2 else 12)), np.uint8)
    fn = lib.rbq_pack_ex_2bit if ex_bits == 2 else lib.rbq_pack_ex_6bit
    fn(_ptr(ex, ctypes.c_uint16), _rows(ex), dim, _ptr(out, ctypes.c_uint8))
    return out


def unpack_ex_cpp(packed: np.ndarray, dim: int, ex_bits: int) -> np.ndarray:
    lib = load()
    packed = np.ascontiguousarray(packed, np.uint8)
    out = np.zeros((*packed.shape[:-1], dim), np.uint16)
    fn = lib.rbq_unpack_ex_2bit if ex_bits == 2 else lib.rbq_unpack_ex_6bit
    fn(_ptr(packed, ctypes.c_uint8), _rows(packed), dim, _ptr(out, ctypes.c_uint16))
    return out


def pack_codes(rows: np.ndarray) -> np.ndarray:
    """FastScan transpose of ``[num_batches, 32, dim_bytes]`` packed rows."""
    lib = load()
    rows = np.ascontiguousarray(rows, np.uint8)
    nb, bs, dim_bytes = rows.shape
    if bs != 32:
        raise ValueError(f"FastScan batches hold 32 rows, not {bs}")
    out = np.empty((nb, dim_bytes * 32), np.uint8)
    lib.rbq_pack_codes(_ptr(rows, ctypes.c_uint8), nb, dim_bytes, _ptr(out, ctypes.c_uint8))
    return out


def unpack_codes(packed: np.ndarray, dim_bytes: int) -> np.ndarray:
    lib = load()
    packed = np.ascontiguousarray(packed, np.uint8)
    nb = packed.shape[0]
    out = np.empty((nb, 32, dim_bytes), np.uint8)
    lib.rbq_unpack_codes(_ptr(packed, ctypes.c_uint8), nb, dim_bytes, _ptr(out, ctypes.c_uint8))
    return out


def crc32(data: bytes, crc: int = 0) -> int:
    """zlib-compatible CRC-32 of ``data``, continuing from ``crc``."""
    lib = load()
    buf = np.frombuffer(data, np.uint8)
    if buf.size == 0:
        return crc
    return int(lib.rbq_crc32(ctypes.c_uint32(crc), _ptr(buf, ctypes.c_uint8), buf.size))
