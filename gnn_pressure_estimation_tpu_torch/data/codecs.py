"""Pure-Python Blosc-v1 / LZ4 codecs for zarr interop — no C dependency.

The reference compresses its zarr chunks with numcodecs' default
``Blosc(cname="lz4", clevel=5, shuffle=SHUFFLE)`` (its writer builds zarr
arrays via ``zarr.open``/``copy_store`` — generator/EPYNET/TokenGeneratorByRange.py:592,618 —
and reads them back at DataLoader.py:212).  numcodecs/blosc/lz4 are not
installed in this image, so this module implements the subset of the c-blosc1
container format and the LZ4 *block* format needed to read (and write) those
chunks:

- c-blosc1 16-byte header: version, versionlz, flags, typesize, nbytes,
  blocksize, cbytes; flags bit0 = byte-shuffle, bit1 = memcpyed,
  bit2 = bit-shuffle (unsupported), bit4 = dont-split, bits5-7 = codec id
  (0 blosclz [unsupported], 1 lz4/lz4hc, 3 zlib, 4 zstd)
- block starts table (uint32 LE per block), each block a sequence of
  ``nsplits`` streams (``typesize`` streams for shuffled split blocks, 1
  otherwise), each stream prefixed with an int32 compressed size; a stream
  whose csize equals its uncompressed size is stored raw
- byte-shuffle applied per block (trailing ``blocksize % typesize`` bytes
  stay unshuffled), vectorized here as a NumPy transpose
- LZ4 block format: token(lit len | match len-4), LSIC length extensions,
  literals, 2-byte LE match offset, overlapping match copy

The compressor side exists so tests can build genuinely Blosc-compressed
fixtures (and so ``ZarrZipWriter(compressor="blosc")`` can emit stores in the
reference's own encoding).  The LZ4 encoder is a simple greedy hash-table
matcher — valid, deterministic, not ratio-optimal.  Throughput is test/IO
grade (storage is not the compute path; SURVEY §2.3).

A copy of ``gnn_pressure_estimation_tpu/data/codecs.py`` with its native
fast path: the LZ4 block codec and the byte shuffle of
``data/native/codecs.cpp`` (a copy of the JAX package's source and Makefile,
a plain C ABI through ``ctypes``), built at first use into the package's
``_build/`` by ``native_build``, as the hydraulic solver is. The Python
codecs stay, as the fallback and the behavioural reference. Without a
compiler the Python path serves, after one warning that carries make's
output; :func:`backend` says which path serves and :func:`set_backend`
chooses one (``"native"`` raises if the library cannot be built).
"""

from __future__ import annotations

import ctypes as ct
import struct
import threading
import warnings
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

from gnn_pressure_estimation_tpu_torch import native_build

# c-blosc1 flag bits / codec ids
_DOSHUFFLE = 0x1
_MEMCPYED = 0x2
_DOBITSHUFFLE = 0x4
_DONT_SPLIT = 0x10
_CODEC_BLOSCLZ, _CODEC_LZ4, _CODEC_SNAPPY, _CODEC_ZLIB, _CODEC_ZSTD = 0, 1, 2, 3, 4
_MAX_SPLITS = 16
_MIN_BUFFERSIZE = 128


# ---------------------------------------------------------------------------
# native fast path (data/native/codecs.cpp, plain C ABI via ctypes — same
# pattern as the hydraulic solver; Python implementations below remain the
# always-available fallback and the behavioral reference)
# ---------------------------------------------------------------------------

SRC_DIR = Path(__file__).resolve().parent / "native"
_FILES = ("codecs.cpp", "Makefile")
_lock = threading.Lock()
_NATIVE = None
_NATIVE_TRIED = False
_BACKEND = {"impl": None}  # None: native when it builds | "native" | "python"


def library_path() -> Path:
    return native_build.library_path(SRC_DIR, "libcodecs", _FILES)


def build() -> Path:
    """Build ``libcodecs`` for this source and host if it is not built;
    raises ``RuntimeError`` with make's output if the build fails."""
    return native_build.build(SRC_DIR, "libcodecs", _FILES)


def _load(strict: bool = False):
    """The loaded library; after a failed build None and one warning, or
    with ``strict`` the build's ``RuntimeError``."""
    global _NATIVE, _NATIVE_TRIED
    with _lock:
        if _NATIVE is not None or (_NATIVE_TRIED and not strict):
            return _NATIVE
        _NATIVE_TRIED = True
        try:
            lib = ct.CDLL(str(build()))
        except (OSError, RuntimeError) as e:
            if strict:
                raise RuntimeError(f"the native codecs are unavailable: {e}") from e
            warnings.warn(f"native codecs unavailable, the Python codecs serve: {e}",
                          RuntimeWarning, stacklevel=3)
            return None
        lib.lz4_block_decompress.restype = ct.c_int
        lib.lz4_block_decompress.argtypes = [ct.c_char_p, ct.c_int,
                                             ct.c_void_p, ct.c_int]
        lib.lz4_block_compress.restype = ct.c_int
        lib.lz4_block_compress.argtypes = [ct.c_char_p, ct.c_int,
                                           ct.c_void_p, ct.c_int]
        for f in (lib.byte_shuffle, lib.byte_unshuffle):
            f.restype = None
            f.argtypes = [ct.c_char_p, ct.c_void_p, ct.c_int, ct.c_int]
        _NATIVE = lib
        return lib


def _native():
    if _BACKEND["impl"] == "python":
        return None
    return _load()


def backend() -> str:
    """``"native"`` when the C codecs serve, else ``"python"``."""
    return "python" if _native() is None else "native"


def set_backend(name: Optional[str]) -> None:
    """Force ``"native"`` (raises ``RuntimeError`` if the library cannot be
    built) or ``"python"``; None resets to the default, native when it
    builds."""
    if name not in (None, "native", "python"):
        raise ValueError(f"codec backend {name!r}: None, 'native' or 'python'")
    if name == "native":
        _load(strict=True)
    _BACKEND["impl"] = name


# ---------------------------------------------------------------------------
# LZ4 block format
# ---------------------------------------------------------------------------

def lz4_decompress(src: bytes, dest_size: int) -> bytes:
    """Decode one LZ4 *block* (not frame) into exactly ``dest_size`` bytes."""
    lib = _native()
    if lib is not None:
        dst = ct.create_string_buffer(max(dest_size, 1))
        got = lib.lz4_block_decompress(src, len(src), dst, dest_size)
        if got != dest_size:
            raise ValueError(
                f"LZ4 block decoded {got} bytes, expected {dest_size}"
            )
        return dst.raw[:dest_size]
    return _lz4_decompress_py(src, dest_size)


def _lz4_decompress_py(src: bytes, dest_size: int) -> bytes:
    # the bounds checks are the native decoder's: a truncated block or one
    # that overruns dest_size raises, as every other corrupt block does
    truncated = "corrupt LZ4 block: truncated or past its decoded size"
    dst = bytearray(dest_size)
    si, di, n = 0, 0, len(src)
    while si < n:
        token = src[si]
        si += 1
        # literals
        lit = token >> 4
        if lit == 15:
            while True:
                if si >= n:
                    raise ValueError(truncated)
                b = src[si]
                si += 1
                lit += b
                if b != 255:
                    break
        if lit:
            if si + lit > n or di + lit > dest_size:
                raise ValueError(truncated)
            dst[di : di + lit] = src[si : si + lit]
            si += lit
            di += lit
        if si >= n:
            break  # last sequence: literals only
        # match
        if si + 2 > n:
            raise ValueError(truncated)
        offset = src[si] | (src[si + 1] << 8)
        si += 2
        if offset == 0:
            raise ValueError("corrupt LZ4 block: zero match offset")
        mlen = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                if si >= n:
                    raise ValueError(truncated)
                b = src[si]
                si += 1
                mlen += b
                if b != 255:
                    break
        ref = di - offset
        if ref < 0:
            raise ValueError("corrupt LZ4 block: offset before start")
        if di + mlen > dest_size:
            raise ValueError(truncated)
        if offset >= mlen:
            dst[di : di + mlen] = dst[ref : ref + mlen]
            di += mlen
        else:
            for _ in range(mlen):  # overlapping copy must go byte-wise
                dst[di] = dst[ref]
                di += 1
                ref += 1
    if di != dest_size:
        raise ValueError(f"LZ4 block decoded {di} bytes, expected {dest_size}")
    return bytes(dst)


def _write_lsic(base: int, value: int) -> bytes:
    """Length extension bytes for values >= base-threshold (LSIC scheme)."""
    out = bytearray()
    value -= base
    while value >= 255:
        out.append(255)
        value -= 255
    out.append(value)
    return bytes(out)


def lz4_compress(src: bytes) -> bytes:
    """Greedy LZ4 block encoder (hash table over 4-byte prefixes).

    Honors the format's end-of-block rules: the final 5 bytes are always
    literals and no match starts within the last 12 bytes.
    """
    lib = _native()
    if lib is not None:
        cap = len(src) + len(src) // 255 + 64
        dst = ct.create_string_buffer(cap)
        got = lib.lz4_block_compress(src, len(src), dst, cap)
        if got > 0:
            return dst.raw[:got]
        # fall through on capacity failure (shouldn't happen)
    return _lz4_compress_py(src)


def _lz4_compress_py(src: bytes) -> bytes:
    n = len(src)
    out = bytearray()
    if n == 0:
        return b"\x00"  # one empty-literal token

    def emit(lit_start: int, lit_end: int, mlen: int = 0, moff: int = 0):
        lit = lit_end - lit_start
        tok_lit = 15 if lit >= 15 else lit
        tok_m = 0
        if mlen:
            m = mlen - 4
            tok_m = 15 if m >= 15 else m
        out.append((tok_lit << 4) | tok_m)
        if lit >= 15:
            out.extend(_write_lsic(15, lit))
        out.extend(src[lit_start:lit_end])
        if mlen:
            out.append(moff & 0xFF)
            out.append(moff >> 8)
            if mlen - 4 >= 15:
                out.extend(_write_lsic(15, mlen - 4))

    table: dict[bytes, int] = {}
    anchor = 0
    i = 0
    match_limit = n - 5   # matches may not cover the last 5 bytes
    start_limit = n - 12  # no match may start past here
    while i <= start_limit:
        key = src[i : i + 4]
        cand = table.get(key)
        table[key] = i
        if cand is not None and i - cand <= 0xFFFF and src[cand : cand + 4] == key:
            # extend the match forward
            mlen = 4
            while i + mlen < match_limit and src[cand + mlen] == src[i + mlen]:
                mlen += 1
            emit(anchor, i, mlen, i - cand)
            i += mlen
            anchor = i
        else:
            i += 1
    emit(anchor, n)  # trailing literals
    return bytes(out)


# ---------------------------------------------------------------------------
# byte shuffle
# ---------------------------------------------------------------------------

def _native_shuffle(fn_name: str, data: bytes, typesize: int):
    lib = _native()
    if lib is None:
        return None
    dst = ct.create_string_buffer(max(len(data), 1))
    getattr(lib, fn_name)(data, dst, len(data), typesize)
    return dst.raw[: len(data)]


def shuffle_bytes(data: bytes, typesize: int) -> bytes:
    """c-blosc byte shuffle: group byte k of every item together."""
    if typesize <= 1 or len(data) < typesize:
        return bytes(data)
    native = _native_shuffle("byte_shuffle", data, typesize)
    if native is not None:
        return native
    n_items = len(data) // typesize
    body = n_items * typesize
    a = np.frombuffer(data[:body], np.uint8).reshape(n_items, typesize)
    return a.T.tobytes() + data[body:]


def unshuffle_bytes(data: bytes, typesize: int) -> bytes:
    if typesize <= 1 or len(data) < typesize:
        return bytes(data)
    native = _native_shuffle("byte_unshuffle", data, typesize)
    if native is not None:
        return native
    n_items = len(data) // typesize
    body = n_items * typesize
    a = np.frombuffer(data[:body], np.uint8).reshape(typesize, n_items)
    return a.T.tobytes() + data[body:]


# ---------------------------------------------------------------------------
# blosc1 container
# ---------------------------------------------------------------------------

def _stream_decompress(codec: int, payload: bytes, dest_size: int) -> bytes:
    if codec == _CODEC_LZ4:
        return lz4_decompress(payload, dest_size)
    if codec == _CODEC_ZLIB:
        return zlib.decompress(payload)
    if codec == _CODEC_ZSTD:
        import zstandard

        return zstandard.ZstdDecompressor().decompress(
            payload, max_output_size=dest_size
        )
    names = {0: "blosclz", 2: "snappy"}
    raise ValueError(
        f"blosc codec {names.get(codec, codec)!r} is not supported "
        "(supported: lz4, zlib, zstd)"
    )


def blosc_decompress(frame: bytes) -> bytes:
    """Decode one c-blosc1 frame (one zarr chunk) to raw bytes."""
    if len(frame) < 16:
        raise ValueError("blosc frame shorter than its 16-byte header")
    version, _versionlz, flags, typesize = frame[0], frame[1], frame[2], frame[3]
    nbytes, blocksize, cbytes = struct.unpack_from("<III", frame, 4)
    if version < 1:
        raise ValueError(f"unsupported blosc version {version}")
    if flags & _DOBITSHUFFLE:
        raise ValueError("blosc bit-shuffle filter is not supported")
    if nbytes == 0:
        return b""
    if flags & _MEMCPYED:
        return bytes(frame[16 : 16 + nbytes])

    codec = (flags >> 5) & 0x7
    doshuffle = bool(flags & _DOSHUFFLE) and typesize > 1
    dont_split = bool(flags & _DONT_SPLIT)
    nblocks = -(-nbytes // blocksize)
    bstarts = struct.unpack_from(f"<{nblocks}I", frame, 16)

    out = bytearray(nbytes)
    for bi in range(nblocks):
        boff = bstarts[bi]
        bsize = min(blocksize, nbytes - bi * blocksize)
        leftover = bsize != blocksize
        # c-blosc's blosc_d splits into typesize streams whenever the header's
        # DONT_SPLIT flag is clear and the block is full-size — independent of
        # the shuffle flag (lz4 NOSHUFFLE frames with typesize>1 are split too)
        nsplits = typesize if (not dont_split and not leftover) else 1
        neblock = bsize // nsplits
        block = bytearray()
        off = boff
        for _ in range(nsplits):
            (csize,) = struct.unpack_from("<i", frame, off)
            off += 4
            payload = frame[off : off + csize]
            off += csize
            if csize == neblock:
                block += payload  # stored raw
            elif csize == 0:
                block += b"\x00" * neblock
            else:
                block += _stream_decompress(codec, payload, neblock)
        if doshuffle:
            block = unshuffle_bytes(bytes(block), typesize)
        out[bi * blocksize : bi * blocksize + bsize] = block
    return bytes(out)


def _pick_blocksize(nbytes: int, typesize: int) -> int:
    """A valid (typesize-aligned) block size; mirrors c-blosc's scale-by-
    clevel spirit without its exact table."""
    target = 1 << 16  # 64 KiB
    if nbytes <= target:
        bs = nbytes
    else:
        bs = target
    bs -= bs % max(typesize, 1)
    return max(bs, typesize)


def blosc_compress(
    data: bytes,
    typesize: int,
    codec: str = "lz4",
    do_shuffle: bool = True,
    blocksize: int = 0,
) -> bytes:
    """Encode raw bytes as a c-blosc1 frame (split heuristics per c-blosc)."""
    codec_id = {"lz4": _CODEC_LZ4, "zlib": _CODEC_ZLIB, "zstd": _CODEC_ZSTD}[codec]
    nbytes = len(data)
    typesize = max(1, typesize)
    if typesize > 255:
        typesize = 1
    blocksize = blocksize or _pick_blocksize(nbytes, typesize)
    doshuffle = do_shuffle and typesize > 1
    # c-blosc splits blosclz/lz4 blocks into per-byte-lane streams whenever
    # typesize allows — independent of the shuffle filter (split_block())
    split = (
        codec_id == _CODEC_LZ4
        and typesize > 1
        and typesize <= _MAX_SPLITS
        and blocksize // typesize >= _MIN_BUFFERSIZE
    )
    flags = (codec_id << 5) | (_DOSHUFFLE if doshuffle else 0)
    if not split:
        flags |= _DONT_SPLIT

    if nbytes == 0:
        header = struct.pack("<BBBBIII", 2, 1, flags | _MEMCPYED, typesize, 0, blocksize, 16)
        return header

    nblocks = -(-nbytes // blocksize)
    blocks = []
    for bi in range(nblocks):
        raw = data[bi * blocksize : (bi + 1) * blocksize]
        bsize = len(raw)
        leftover = bsize != blocksize
        if doshuffle:
            raw = shuffle_bytes(raw, typesize)
        nsplits = typesize if (split and not leftover) else 1
        neblock = bsize // nsplits
        parts = bytearray()
        for si in range(nsplits):
            stream = raw[si * neblock : (si + 1) * neblock]
            if codec_id == _CODEC_LZ4:
                comp = lz4_compress(stream)
            elif codec_id == _CODEC_ZLIB:
                comp = zlib.compress(stream, 5)
            else:
                import zstandard

                comp = zstandard.ZstdCompressor(level=3).compress(stream)
            if len(comp) >= neblock:
                comp = stream  # store raw; csize == neblock marks it
            parts += struct.pack("<i", len(comp)) + comp
        blocks.append(bytes(parts))

    header_size = 16 + 4 * nblocks
    bstarts, off = [], header_size
    for b in blocks:
        bstarts.append(off)
        off += len(b)
    cbytes = off
    if cbytes >= nbytes + 16:
        # incompressible: fall back to the memcpy frame
        header = struct.pack(
            "<BBBBIII", 2, 1, flags | _MEMCPYED, typesize, nbytes, blocksize, nbytes + 16
        )
        return header + data
    frame = struct.pack("<BBBBIII", 2, 1, flags, typesize, nbytes, blocksize, cbytes)
    frame += struct.pack(f"<{nblocks}I", *bstarts)
    return frame + b"".join(blocks)


# ---------------------------------------------------------------------------
# numcodecs-style standalone codecs (zarr "compressor" ids)
# ---------------------------------------------------------------------------

def decode_chunk(raw: bytes, comp: dict | None, dtype: np.dtype) -> bytes:
    """Decode one zarr chunk per its ``compressor`` metadata.

    Supports null, zlib/gzip, blosc (lz4/zlib/zstd inner codecs), numcodecs
    LZ4 (4-byte LE original-size header + LZ4 block) and Zstd frames.
    """
    comp_id = comp["id"] if comp else None
    if comp_id is None:
        return raw
    if comp_id in ("zlib", "gzip"):
        return zlib.decompress(raw)
    if comp_id == "blosc":
        return blosc_decompress(raw)
    if comp_id == "lz4":
        (orig,) = struct.unpack_from("<I", raw, 0)
        return lz4_decompress(raw[4:], orig)
    if comp_id == "zstd":
        import zstandard

        return zstandard.ZstdDecompressor().decompress(raw)
    raise ValueError(
        f"unsupported zarr compressor {comp_id!r} "
        "(supported: null, zlib, gzip, blosc[lz4|zlib|zstd], lz4, zstd)"
    )
