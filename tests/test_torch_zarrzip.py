"""PyTorch port: the zarr-v2 zip store and its codecs against the JAX
package's: a store written by either package reads the same in the other,
and the codecs give the same bytes.

Both packages encode through their native LZ4 encoder
(``data/native/codecs.cpp``, the port's a copy of the JAX package's) when it
is built, and through their Python codecs otherwise. The two encoders make
other (equally valid) matches on some inputs, so byte equality is held
path for path: with both packages on their Python codecs
(``python_codecs``), and with both on their native ones
(``test_native_written_entries_equal_jax``); either path's frames must
decode in the other package."""

import os

import numpy as np
import pytest

from gnn_pressure_estimation_tpu.data import codecs as jcodecs
from gnn_pressure_estimation_tpu.data.zarrzip import ZarrZipReader as JaxReader
from gnn_pressure_estimation_tpu.data.zarrzip import ZarrZipWriter as JaxWriter
from gnn_pressure_estimation_tpu.data.zarrzip import zip_directory_store as jax_zip_dir
from gnn_pressure_estimation_tpu_torch.data import codecs
from gnn_pressure_estimation_tpu_torch.data.zarrzip import ZarrZipReader, ZarrZipWriter
from gnn_pressure_estimation_tpu_torch.data.zarrzip import zip_directory_store

PACKAGES = {"jax": (JaxWriter, JaxReader), "port": (ZarrZipWriter, ZarrZipReader)}


def on_python_codecs(monkeypatch):
    """Both packages on their Python codecs until the test ends."""
    monkeypatch.setattr(jcodecs, "_native", lambda: None)
    monkeypatch.setitem(codecs._BACKEND, "impl", None)
    codecs.set_backend("python")


@pytest.fixture
def python_codecs(monkeypatch):
    on_python_codecs(monkeypatch)


def arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "pressure/train": (50 + 8 * rng.standard_normal((23, 37))).astype(np.float32),
        "pressure/test": rng.standard_normal((5, 37)),                       # f8
        "ids": rng.integers(-1000, 1000, size=(11, 6)).astype(np.int32),
        "flat": np.arange(9, dtype=np.float64),
    }


def write_store(writer_cls, path, compressor, data):
    with writer_cls(path, compressor=compressor) as w:
        w.create_group("pressure")
        w.set_attrs("", {"ordered_names_by_attr": {"pressure": [f"J{i}" for i in range(37)]},
                         "config": {"general": {"num_scenarios": "28"}}})
        w.set_attrs("pressure", {"mean": 50.0, "std": 8.0})
        # partial edge chunks on both axes, and a 1-D array
        w.write_array("pressure/train", data["pressure/train"], chunks=(10, 16))
        w.write_array("pressure/test", data["pressure/test"], chunks=(4, -1))
        w.write_array("ids", data["ids"], chunks=(4, 4))
        w.write_array("flat", data["flat"], chunks=(4,))


@pytest.mark.parametrize("compressor", [None, "zlib", "blosc"])
@pytest.mark.parametrize("direction", [("jax", "port"), ("port", "jax"), ("port", "port")])
@pytest.mark.parametrize("suffix", [".zip", ""])
def test_store_round_trip(tmp_path, compressor, direction, suffix):
    data = arrays()
    path = str(tmp_path / f"store{suffix}")
    write_store(PACKAGES[direction[0]][0], path, compressor, data)
    with PACKAGES[direction[1]][1](path) as r:
        root = r.root()
        assert root.attrs["ordered_names_by_attr"]["pressure"][3] == "J3"
        assert root.attrs["config"] == {"general": {"num_scenarios": "28"}}
        assert root["pressure"].attrs == {"mean": 50.0, "std": 8.0}
        assert root.group_keys() == ["pressure"] and root.array_keys() == ["flat", "ids"]
        assert root["pressure"].array_keys() == ["test", "train"]
        for key, ref in data.items():
            got = r.read_array(key)
            assert got.dtype == ref.dtype and got.shape == ref.shape
            np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(root["pressure"]["train"][2:5], data["pressure/train"][2:5])
        with pytest.raises(KeyError):
            root["missing"]


@pytest.mark.parametrize("compressor", [None, "zlib", "blosc"])
def test_written_entries_equal_jax(tmp_path, compressor, python_codecs):
    """The two writers put the same bytes under the same keys."""
    import zipfile

    data = arrays(1)
    write_store(JaxWriter, str(tmp_path / "j.zip"), compressor, data)
    write_store(ZarrZipWriter, str(tmp_path / "p.zip"), compressor, data)
    with zipfile.ZipFile(tmp_path / "j.zip") as j, zipfile.ZipFile(tmp_path / "p.zip") as p:
        assert j.namelist() == p.namelist()
        for name in j.namelist():
            assert j.read(name) == p.read(name), name


@pytest.mark.parametrize("compressor", [None, "zlib", "blosc"])
def test_native_written_entries_equal_jax(tmp_path, compressor):
    """The two writers on their native codecs put the same bytes under the
    same keys."""
    import zipfile

    assert jcodecs._native() is not None and codecs.backend() == "native"
    data = arrays(1)
    write_store(JaxWriter, str(tmp_path / "j.zip"), compressor, data)
    write_store(ZarrZipWriter, str(tmp_path / "p.zip"), compressor, data)
    with zipfile.ZipFile(tmp_path / "j.zip") as j, zipfile.ZipFile(tmp_path / "p.zip") as p:
        assert j.namelist() == p.namelist()
        for name in j.namelist():
            assert j.read(name) == p.read(name), name


def test_directory_store_zipped(tmp_path):
    data = arrays(2)
    src = str(tmp_path / "dir_store")
    write_store(ZarrZipWriter, src, "blosc", data)
    zip_directory_store(src, str(tmp_path / "port.zip"))
    jax_zip_dir(src, str(tmp_path / "jax.zip"))
    for z in ("port.zip", "jax.zip"):
        for reader in (ZarrZipReader, JaxReader):
            with reader(str(tmp_path / z)) as r:
                np.testing.assert_array_equal(r.read_array("ids"), data["ids"])
    zip_directory_store(src, str(tmp_path / "moved.zip"), remove_src=True)
    assert not os.path.exists(src)


def payloads():
    rng = np.random.default_rng(5)
    smooth = (50 + np.cumsum(rng.standard_normal(4000)) * 0.01).astype(np.float32).tobytes()
    return {
        "empty": b"",
        "short": b"abc",
        "repeats": b"abcd" * 3000 + b"xyz",
        "random": rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
        "runs": bytes(1000) + b"\x01" * 300 + bytes(70_000),          # a match past 64 KiB of input
        "smooth f32": smooth,
    }


@pytest.mark.parametrize("name", sorted(payloads()))
def test_lz4_bytes_equal_jax(name, monkeypatch):
    data = payloads()[name]
    native = jcodecs.lz4_compress(data)             # the native encoder's, when built
    assert codecs.lz4_decompress(native, len(data)) == data
    on_python_codecs(monkeypatch)
    comp = codecs.lz4_compress(data)
    assert comp == jcodecs.lz4_compress(data)
    assert codecs.lz4_decompress(comp, len(data)) == data
    assert jcodecs.lz4_decompress(comp, len(data)) == data


@pytest.mark.parametrize("typesize", [1, 2, 4, 8, 3])
def test_shuffle_bytes_equal_jax(typesize, python_codecs):
    data = np.random.default_rng(typesize).integers(0, 256, 1003, dtype=np.uint8).tobytes()
    sh = codecs.shuffle_bytes(data, typesize)
    assert sh == jcodecs.shuffle_bytes(data, typesize)
    assert codecs.unshuffle_bytes(sh, typesize) == data == jcodecs.unshuffle_bytes(sh, typesize)


@pytest.mark.parametrize("codec", ["lz4", "zlib"])
@pytest.mark.parametrize("typesize,shuffle", [(4, True), (8, True), (4, False), (1, True)])
def test_blosc_frames_equal_jax(codec, typesize, shuffle, monkeypatch):
    """Frames of several blocks (past 64 KiB), the last block short."""
    rng = np.random.default_rng(typesize)
    data = (50 + rng.standard_normal(70_003 // typesize * typesize // 4) * 0.1).astype(
        np.float32).tobytes()
    data = data[: len(data) // typesize * typesize] + b"\x07" * typesize
    native = jcodecs.blosc_compress(data, typesize, codec=codec, do_shuffle=shuffle)
    assert codecs.blosc_decompress(native) == data
    on_python_codecs(monkeypatch)
    frame = codecs.blosc_compress(data, typesize, codec=codec, do_shuffle=shuffle)
    assert frame == jcodecs.blosc_compress(data, typesize, codec=codec, do_shuffle=shuffle)
    assert codecs.blosc_decompress(frame) == data == jcodecs.blosc_decompress(frame)


def test_decode_chunk_and_refusals():
    raw = np.arange(100, dtype=np.float32).tobytes()
    lz4_chunk = len(raw).to_bytes(4, "little") + codecs.lz4_compress(raw)
    for comp in (None, {"id": "zlib"}, {"id": "lz4"}, {"id": "blosc"}):
        chunk = {None: raw, "zlib": __import__("zlib").compress(raw), "lz4": lz4_chunk,
                 "blosc": codecs.blosc_compress(raw, 4)}[comp and comp["id"]]
        assert codecs.decode_chunk(chunk, comp, np.float32) == raw
        assert jcodecs.decode_chunk(chunk, comp, np.float32) == raw
    with pytest.raises(ValueError, match="unsupported zarr compressor"):
        codecs.decode_chunk(raw, {"id": "bz2"}, np.float32)
    bitshuffled = bytearray(codecs.blosc_compress(raw, 4))
    bitshuffled[2] |= 0x4
    with pytest.raises(ValueError, match="bit-shuffle"):
        codecs.blosc_decompress(bytes(bitshuffled))
