"""PyTorch port: the native codecs (``data/native/codecs.cpp``, the LZ4 block
codec and the byte shuffle behind ``data/codecs.py``) against the JAX
package's native codecs and against the port's own Python codecs.

- The library builds into the package's ``_build/`` under a name keyed by
  the source, the Makefile and the host's CPU, and nothing is built beside
  either package's source by the port's build.
- The port's native LZ4 encoder gives the JAX native encoder's bytes (the
  same source) on seeded and hypothesis-drawn inputs, and both of the port's
  decoders give the original bytes back from the frames of both JAX
  encoders.
- The byte shuffle is equal across backends for typesize 1-16 at lengths
  that are not a multiple of it; ``blosc_compress`` frames (lz4 and zlib,
  shuffle on and off) equal the JAX native ones.
- A corrupt block raises ``ValueError`` on both backends.
- ``artifacts/eval_bigtown.zip`` (Blosc-lz4, byte shuffle) read through
  ``WDNDataset`` is bit-equal across backends and equal to the JAX
  ``WDNDataset``.
- ``set_backend("native")`` raises when the build fails; without it a
  failed build warns once and the Python codecs serve.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from gnn_pressure_estimation_tpu.data import codecs as jcodecs
from gnn_pressure_estimation_tpu.data.dataset import WDNDataset as JaxWDNDataset
from gnn_pressure_estimation_tpu_torch import native_build
from gnn_pressure_estimation_tpu_torch.data import codecs
from gnn_pressure_estimation_tpu_torch.data.dataset import WDNDataset

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
STORE = ROOT / "artifacts" / "eval_bigtown.zip"
INP = ROOT / "inputs" / "bigtown.inp"
BACKENDS = ["native", "python"]


@pytest.fixture
def on(monkeypatch):
    """``on(name)``: the port on that codec backend until the test ends."""
    monkeypatch.setitem(codecs._BACKEND, "impl", None)

    def switch(name):
        codecs.set_backend(name)
        assert codecs.backend() == name
    return switch


def payloads():
    rng = np.random.default_rng(21)
    smooth = (50 + np.cumsum(rng.standard_normal(6000)) * 0.01).astype(np.float32).tobytes()
    return {
        "empty": b"",
        "one": b"\x07",
        "twelve": b"abcabcabcabc",
        "zeros": bytes(5000),
        "repetitive": b"pressure" * 900 + b"head" * 333,
        "random": rng.integers(0, 256, 7000, dtype=np.uint8).tobytes(),
        "smooth f32": smooth,
        "1 MiB": (np.sin(np.arange(1 << 18) * 0.001) * 40).astype(np.float32).tobytes(),
    }


def test_library_builds_outside_the_source_trees(tmp_path, monkeypatch):
    """The library goes to the package's ``_build/``; a rebuild writes
    nothing beside the port's source or the JAX package's; an edited source
    gets another name."""
    jax_dir = Path(jcodecs.__file__).parent / "native"
    before = sorted(p.name for p in jax_dir.iterdir())
    so = codecs.build()
    assert so.parent == native_build.BUILD_DIR and so.name.startswith("libcodecs-")
    assert so == codecs.library_path() and so.exists()
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    fresh = codecs.build()
    assert fresh.parent == tmp_path / "build" and fresh.name == so.name
    assert sorted(p.name for p in codecs.SRC_DIR.iterdir()) == ["Makefile", "codecs.cpp"]
    assert sorted(p.name for p in jax_dir.iterdir()) == before
    edited = tmp_path / "src"
    shutil.copytree(codecs.SRC_DIR, edited)
    (edited / "codecs.cpp").write_bytes((edited / "codecs.cpp").read_bytes() + b"\n")
    assert native_build.library_path(edited, "libcodecs", codecs._FILES).name != so.name
    assert codecs.backend() == "native"


@pytest.mark.parametrize("name", sorted(payloads()))
def test_native_lz4_equals_jax_native(name, on):
    data = payloads()[name]
    assert jcodecs._native() is not None
    on("native")
    comp = codecs.lz4_compress(data)
    assert comp == jcodecs.lz4_compress(data)
    for backend in BACKENDS:
        on(backend)
        assert codecs.lz4_decompress(comp, len(data)) == data


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(st.one_of(st.binary(max_size=64), st.binary(min_size=100, max_size=3000),
                 st.builds(lambda b, k: b * k, st.binary(min_size=1, max_size=9),
                           st.integers(1, 400))))
def test_native_lz4_equals_jax_native_drawn(on, data):
    on("native")
    comp = codecs.lz4_compress(data)
    assert comp == jcodecs.lz4_compress(data)
    assert codecs.lz4_decompress(comp, len(data)) == data


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("encoder", ["jax python", "jax native"])
def test_port_decoders_read_both_jax_encoders(backend, encoder, on):
    encode = jcodecs._lz4_compress_py if encoder == "jax python" else jcodecs.lz4_compress
    on(backend)
    for name, data in payloads().items():
        assert codecs.lz4_decompress(encode(data), len(data)) == data, name


@pytest.mark.parametrize("typesize", list(range(1, 17)))
def test_shuffle_equal_across_backends(typesize, on):
    rng = np.random.default_rng(typesize)
    for length in (typesize * 37 + typesize // 2 + 1, 5, 1001):
        data = rng.integers(0, 256, length, dtype=np.uint8).tobytes()
        got = {}
        for backend in BACKENDS:
            on(backend)
            got[backend] = (codecs.shuffle_bytes(data, typesize),
                            codecs.unshuffle_bytes(data, typesize))
            assert codecs.unshuffle_bytes(got[backend][0], typesize) == data
        assert got["native"] == got["python"]
        assert got["native"][0] == jcodecs.shuffle_bytes(data, typesize)


@pytest.mark.parametrize("codec", ["lz4", "zlib"])
@pytest.mark.parametrize("shuffle", [True, False])
def test_blosc_frames_equal_jax_native(codec, shuffle, on):
    """Frames of several blocks (past 64 KiB), the last one short."""
    rng = np.random.default_rng(3)
    data = (50 + rng.standard_normal(40_001) * 0.1).astype(np.float32).tobytes() + b"\x05" * 4
    on("native")
    frame = codecs.blosc_compress(data, 4, codec=codec, do_shuffle=shuffle)
    assert frame == jcodecs.blosc_compress(data, 4, codec=codec, do_shuffle=shuffle)
    for backend in BACKENDS:
        on(backend)
        assert codecs.blosc_decompress(frame) == data


def _corrupt_blocks():
    data = b"abcd" * 300 + b"xyz" * 50
    comp = jcodecs._lz4_compress_py(data)
    return {
        "truncated in the last literals": (comp[:-1], len(data)),
        "truncated in a match": (comp[:4], len(data)),
        "truncated in a length extension": (bytes([0xF0]), 20),
        "zero offset": (bytes([0x14]) + b"a" + b"\x00\x00" + b"\x00", 10),
        "offset before the start": (bytes([0x14]) + b"a" + b"\x05\x00" + bytes([0x50]) + b"abcde",
                                    14),
        "dest_size too large": (comp, len(data) + 3),
        "dest_size too small": (comp, len(data) - 3),
    }


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", sorted(_corrupt_blocks()))
def test_corrupt_blocks_raise(backend, case, on):
    src, size = _corrupt_blocks()[case]
    on(backend)
    with pytest.raises(ValueError):
        codecs.lz4_decompress(src, size)


def test_eval_store_bit_equal_across_backends_and_jax(on):
    jax_ds = JaxWDNDataset([str(STORE)], [str(INP)], from_set="train")
    arrays = {}
    for backend in BACKENDS:
        on(backend)
        ds = WDNDataset([str(STORE)], [str(INP)], from_set="train")
        arrays[backend] = ds.members[0].array
        assert ds.stats.to_dict() == jax_ds.stats.to_dict()
    assert arrays["native"].dtype == np.float32 and arrays["native"].shape[0] == 40
    np.testing.assert_array_equal(arrays["native"], arrays["python"])
    np.testing.assert_array_equal(arrays["native"], jax_ds.members[0].array)


def test_failed_build_warns_or_raises(tmp_path, monkeypatch):
    """No ``make``: the default path warns once and serves the Python
    codecs; ``set_backend("native")`` raises with the build's message."""
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_build, "MAKE", str(tmp_path / "no-make"))
    monkeypatch.setattr(codecs, "_NATIVE", None)
    monkeypatch.setattr(codecs, "_NATIVE_TRIED", False)
    monkeypatch.setitem(codecs._BACKEND, "impl", None)
    with pytest.warns(RuntimeWarning, match="libcodecs build failed"):
        assert codecs.backend() == "python"
    data = b"abc" * 100
    assert codecs.lz4_compress(data) == jcodecs._lz4_compress_py(data)
    with pytest.raises(RuntimeError, match="libcodecs build failed"):
        codecs.set_backend("native")
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())
    with pytest.raises(ValueError, match="codec backend"):
        codecs.set_backend("c")
