"""Minimal self-contained zarr-v2 store over zip/directory — no zarr dependency.

The reference persists datasets as zarr DirectoryStores copied into ZipStores
(scenegenv7.py:464-483, :723-725) and reads them back with
``zarr.open(zip_path)`` (DataLoader.py:212). This module reimplements exactly
the subset of the v2 spec that layout needs, so datasets written here are
readable by stock ``zarr`` (and vice versa):

- groups (``.zgroup``), arrays (``.zarray``), JSON attrs (``.zattrs``)
- C-order little-endian numeric dtypes, regular chunk grids
- compressors: write ``null`` (raw), ``zlib`` (stdlib) or ``blosc``
  (the reference's own Blosc-lz4+shuffle chunk encoding,
  TokenGeneratorByRange.py:592, via the in-repo codec in
  :mod:`gnn_pressure_estimation_tpu_torch.data.codecs`); read additionally
  accepts gzip, standalone lz4 and zstd chunks, and blosc frames whose
  inner codec is lz4, zlib or zstd — i.e. any store the reference
  actually produces loads here.

Storage is not the compute path, so plain Python + NumPy codecs are the
right tool here; the C++ effort goes into the hydraulic solver instead.

A copy of ``gnn_pressure_estimation_tpu/data/zarrzip.py``: a store written by
either package reads the same in the other.
"""

from __future__ import annotations

import json
import os
import shutil
import zipfile
import zlib
from typing import Any, Iterator, Optional

import numpy as np

_DTYPE_MAP = {
    "f4": np.float32, "f8": np.float64,
    "i1": np.int8, "i2": np.int16, "i4": np.int32, "i8": np.int64,
    "u1": np.uint8, "u2": np.uint16, "u4": np.uint32, "u8": np.uint64,
    "b1": np.bool_,
}


def _dtype_str(dt: np.dtype) -> str:
    dt = np.dtype(dt)
    if dt == np.bool_:
        return "|b1"
    kind = dt.kind + str(dt.itemsize)
    return "<" + kind


def _parse_dtype(s: str) -> np.dtype:
    if s in ("|b1", "b1"):
        return np.dtype(np.bool_)
    core = s.lstrip("<>|=")
    if core not in _DTYPE_MAP:
        raise ValueError(f"unsupported zarr dtype {s!r}")
    if s.startswith(">"):
        return np.dtype(_DTYPE_MAP[core]).newbyteorder(">")
    return np.dtype(_DTYPE_MAP[core])


class ZarrZipWriter:
    """Write a zarr-v2 hierarchy into a zip file (or a directory).

    Usage::

        with ZarrZipWriter("out.zip") as w:
            w.create_group("pressure")
            w.write_array("pressure/train", arr, chunks=(1024, -1))
            w.set_attrs("", {"config": {...}})
    """

    def __init__(self, path: str, compressor: Optional[str] = "zlib", clevel: int = 5):
        assert compressor in (None, "zlib", "blosc")
        self.path = path
        self.compressor = compressor
        self.clevel = clevel
        self._is_zip = path.endswith(".zip")
        self._attrs: dict[str, dict] = {}
        if self._is_zip:
            self._zf = zipfile.ZipFile(path, "w", zipfile.ZIP_STORED)
        else:
            os.makedirs(path, exist_ok=True)
            self._zf = None
        self._write_json("", ".zgroup", {"zarr_format": 2})

    # -- low-level ---------------------------------------------------------
    def _put(self, key: str, data: bytes):
        if self._zf is not None:
            self._zf.writestr(key, data)
        else:
            full = os.path.join(self.path, key)
            os.makedirs(os.path.dirname(full), exist_ok=True)
            with open(full, "wb") as f:
                f.write(data)

    def _write_json(self, prefix: str, name: str, obj: Any):
        key = f"{prefix}/{name}" if prefix else name
        self._put(key, json.dumps(obj, indent=2).encode())

    # -- public ------------------------------------------------------------
    def create_group(self, path: str):
        self._write_json(path, ".zgroup", {"zarr_format": 2})

    def set_attrs(self, path: str, attrs: dict):
        self._write_json(path, ".zattrs", attrs)

    def write_array(self, path: str, arr: np.ndarray, chunks=None,
                    compressor: str = "default"):
        """``compressor`` overrides the writer default for this one array
        (None | "zlib" | "blosc"), e.g. the reference stores its ``token``
        parameter array Blosc-lz4 regardless of the rest of the store."""
        arr = np.ascontiguousarray(arr)
        if chunks is None:
            chunks = arr.shape if arr.ndim else (1,)
        chunks = tuple(
            arr.shape[i] if c in (-1, None) else min(int(c), max(arr.shape[i], 1))
            for i, c in enumerate(chunks)
        )
        comp_name = self.compressor if compressor == "default" else compressor
        if comp_name == "blosc":
            # the reference's own chunk encoding (numcodecs Blosc lz4+shuffle)
            comp = {"id": "blosc", "cname": "lz4", "clevel": self.clevel,
                    "shuffle": 1, "blocksize": 0}
        elif comp_name:
            comp = {"id": "zlib", "level": self.clevel}
        else:
            comp = None
        meta = {
            "zarr_format": 2,
            "shape": list(arr.shape),
            "chunks": list(chunks),
            "dtype": _dtype_str(arr.dtype),
            "compressor": comp,
            "fill_value": 0,
            "filters": None,
            "order": "C",
        }
        self._write_json(path, ".zarray", meta)
        grid = [max(1, -(-s // c)) for s, c in zip(arr.shape, chunks)] or [1]
        for idx in np.ndindex(*grid):
            slices = tuple(
                slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(idx, chunks, arr.shape)
            )
            block = arr[slices]
            # pad partial edge chunks to full chunk shape (zarr convention)
            if block.shape != chunks:
                pad = np.zeros(chunks, arr.dtype)
                pad[tuple(slice(0, d) for d in block.shape)] = block
                block = pad
            raw = np.ascontiguousarray(block).tobytes()
            if comp_name == "blosc":
                from gnn_pressure_estimation_tpu_torch.data.codecs import blosc_compress

                raw = blosc_compress(raw, typesize=arr.dtype.itemsize)
            elif comp_name:
                raw = zlib.compress(raw, self.clevel)
            name = ".".join(map(str, idx)) if idx else "0"
            self._put(f"{path}/{name}", raw)

    def close(self):
        if self._zf is not None:
            self._zf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _Node:
    """Lazy handle to a group or array inside a reader (zarr-like API)."""

    def __init__(self, reader: "ZarrZipReader", path: str):
        self._r = reader
        self._path = path

    @property
    def attrs(self) -> dict:
        return self._r.read_attrs(self._path)

    def __getitem__(self, key):
        if isinstance(key, str):
            sub = f"{self._path}/{key}" if self._path else key
            if self._r.is_array(sub):
                return self._r.read_array(sub)
            if self._r.is_group(sub):
                return _Node(self._r, sub)
            raise KeyError(key)
        # numeric indexing on an array node
        return self._r.read_array(self._path)[key]

    def group_keys(self) -> list[str]:
        return self._r.list_children(self._path, arrays=False)

    def array_keys(self) -> list[str]:
        return self._r.list_children(self._path, arrays=True)


class ZarrZipReader:
    """Read a zarr-v2 hierarchy from a zip file or directory."""

    def __init__(self, path: str):
        self.path = path
        self._is_zip = os.path.isfile(path) and zipfile.is_zipfile(path)
        if self._is_zip:
            self._zf = zipfile.ZipFile(path, "r")
            self._names = set(self._zf.namelist())
        else:
            if not os.path.isdir(path):
                raise FileNotFoundError(path)
            self._zf = None
            self._names = set()
            for root, _, files in os.walk(path):
                rel = os.path.relpath(root, path)
                for f in files:
                    key = f if rel == "." else f"{rel}/{f}".replace(os.sep, "/")
                    self._names.add(key)

    def _get(self, key: str) -> bytes:
        if self._zf is not None:
            return self._zf.read(key)
        with open(os.path.join(self.path, key), "rb") as f:
            return f.read()

    def root(self) -> _Node:
        return _Node(self, "")

    def is_array(self, path: str) -> bool:
        return f"{path}/.zarray" in self._names

    def is_group(self, path: str) -> bool:
        return f"{path}/.zgroup" in self._names or (path == "" and ".zgroup" in self._names)

    def list_children(self, path: str, arrays: bool) -> list[str]:
        prefix = f"{path}/" if path else ""
        out = set()
        for n in self._names:
            if not n.startswith(prefix):
                continue
            rest = n[len(prefix):]
            parts = rest.split("/")
            if len(parts) == 2:
                if arrays and parts[1] == ".zarray":
                    out.add(parts[0])
                if not arrays and parts[1] == ".zgroup":
                    out.add(parts[0])
        return sorted(out)

    def read_attrs(self, path: str) -> dict:
        key = f"{path}/.zattrs" if path else ".zattrs"
        if key not in self._names:
            return {}
        return json.loads(self._get(key))

    def read_array(self, path: str) -> np.ndarray:
        from gnn_pressure_estimation_tpu_torch.data.codecs import decode_chunk

        meta = json.loads(self._get(f"{path}/.zarray"))
        comp = meta.get("compressor")
        if meta.get("filters"):
            raise ValueError(f"array {path!r} uses zarr filters (unsupported)")
        dtype = _parse_dtype(meta["dtype"])
        shape = tuple(meta["shape"])
        chunks = tuple(meta["chunks"])
        out = np.zeros(shape, dtype)
        grid = [max(1, -(-s // c)) for s, c in zip(shape, chunks)] or [1]
        for idx in np.ndindex(*grid):
            name = ".".join(map(str, idx)) if idx else "0"
            key = f"{path}/{name}"
            if key not in self._names:
                continue  # missing chunk = fill_value
            raw = decode_chunk(self._get(key), comp, dtype)
            block = np.frombuffer(raw, dtype).reshape(chunks)
            slices = tuple(
                slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(idx, chunks, shape)
            )
            out[slices] = block[tuple(slice(0, sl.stop - sl.start) for sl in slices)]
        return out

    def close(self):
        if self._zf is not None:
            self._zf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def zip_directory_store(src_dir: str, zip_path: str, remove_src: bool = False):
    """Copy a directory store into a zip store (reference scenegenv7.py:723-725
    ``zarr.copy_store`` to ZipStore equivalent)."""
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_STORED) as zf:
        for root, _, files in os.walk(src_dir):
            rel = os.path.relpath(root, src_dir)
            for f in files:
                key = f if rel == "." else f"{rel}/{f}".replace(os.sep, "/")
                zf.write(os.path.join(root, f), key)
    if remove_src:
        shutil.rmtree(src_dir)
