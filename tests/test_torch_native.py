"""The port's native host codecs (``rabitq_tpu_torch/native.py``, built with
g++ from ``native/packing.cpp``) against the port's numpy codecs and the
JAX package's bytes: every codec bitwise equal, and an RBQ1 file written
with the native codecs byte-identical to one written without them and to
the JAX package's. Where g++ is missing, the tests skip with that reason."""

from __future__ import annotations

import zlib

import numpy as np
import pytest

import rabitq_tpu as jr
import rabitq_tpu_torch as tr
from rabitq_tpu.ops import packing as jpacking
from rabitq_tpu_torch import native
from rabitq_tpu_torch.ops import packing


@pytest.fixture(scope="module")
def lib():
    """The built library; skips the module's tests where g++ cannot build it."""
    if native.load(build=True) is None:
        pytest.skip("the native codec library could not be built (no g++, or it refused)")
    return native


@pytest.fixture
def numpy_only(monkeypatch):
    """The port's codecs with the native library switched off."""
    monkeypatch.setattr(native, "available", lambda: False)


def test_library_path_and_opt_in(lib):
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("librbq_native-")
    assert native.available() and native.load() is native.load()


def test_binary_codecs(lib, numpy_only):
    rng = np.random.default_rng(0)
    bits = (rng.random((17, 130)) < 0.5).astype(np.uint8)
    packed = lib.pack_binary(bits)
    np.testing.assert_array_equal(packed, packing.pack_binary(bits))
    np.testing.assert_array_equal(packed, np.packbits(bits, axis=-1, bitorder="big"))
    np.testing.assert_array_equal(lib.unpack_binary(packed, 130), packing.unpack_binary(packed, 130))
    np.testing.assert_array_equal(lib.unpack_binary(packed, 130), bits)


@pytest.mark.parametrize("ex_bits", [1, 2, 3, 5, 6, 7, 9, 16])
@pytest.mark.parametrize("dim", [64, 72])
def test_ex_codecs(lib, ex_bits, dim, monkeypatch):
    """The port's ``pack_ex`` / ``unpack_ex`` dispatch (C++-compatible
    packings for 2 and 6 bits at dim % 16 == 0, the generic stream
    otherwise) with and without the library, and the JAX package's bytes."""
    rng = np.random.default_rng(ex_bits)
    ex = rng.integers(0, 1 << ex_bits, size=(9, dim)).astype(np.uint16)
    with_lib = packing.pack_ex(ex, ex_bits)
    monkeypatch.setattr(native, "available", lambda: False)
    without = packing.pack_ex(ex, ex_bits)
    np.testing.assert_array_equal(with_lib, without)
    np.testing.assert_array_equal(with_lib, jpacking.pack_ex(ex, ex_bits))
    np.testing.assert_array_equal(packing.unpack_ex(without, dim, ex_bits), ex)
    monkeypatch.undo()
    np.testing.assert_array_equal(packing.unpack_ex(with_lib, dim, ex_bits), ex)


def test_fastscan_transpose(lib, numpy_only):
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 256, size=(3, 32, 8)).astype(np.uint8)
    want = packing.pack_codes(rows)
    np.testing.assert_array_equal(lib.pack_codes(rows), want)
    np.testing.assert_array_equal(lib.pack_codes(rows), jpacking.pack_codes(rows))
    np.testing.assert_array_equal(lib.unpack_codes(want, 8), rows)
    np.testing.assert_array_equal(packing.unpack_codes(want, 8), rows)
    with pytest.raises(ValueError):
        lib.pack_codes(rows[:, :16])


def test_crc32_matches_zlib(lib):
    data = np.random.default_rng(4).integers(0, 256, 10_000).astype(np.uint8).tobytes()
    assert lib.crc32(data) == zlib.crc32(data)
    assert lib.crc32(data[5000:], lib.crc32(data[:5000])) == zlib.crc32(data)
    assert lib.crc32(b"", 7) == 7


@pytest.mark.parametrize("total_bits", [3, 7])
def test_rbq1_bytes_with_and_without_native(lib, tmp_path, monkeypatch, total_bits):
    data = np.random.default_rng(5).standard_normal((300, 64)).astype(np.float32)
    jidx = jr.IvfRabitqIndex.train(data, nlist=4, total_bits=total_bits, seed=1, scan_dtype="f32")
    jidx.save_to_path(tmp_path / "jax.rbq")
    tidx = tr.load_index(tmp_path / "jax.rbq", scan_dtype="f32", device="cpu").as_ivf()
    tidx.save_to_path(tmp_path / "native.rbq")
    monkeypatch.setattr(native, "available", lambda: False)
    tidx.save_to_path(tmp_path / "numpy.rbq")
    want = (tmp_path / "jax.rbq").read_bytes()
    assert (tmp_path / "native.rbq").read_bytes() == want
    assert (tmp_path / "numpy.rbq").read_bytes() == want
    monkeypatch.undo()
    again = tr.load_index(tmp_path / "native.rbq", scan_dtype="f32", device="cpu").as_ivf()
    np.testing.assert_array_equal(again.host.ex_codes, tidx.host.ex_codes)
    np.testing.assert_array_equal(again.host.binary_bits, tidx.host.binary_bits)
