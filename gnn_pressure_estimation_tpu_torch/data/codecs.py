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

A copy of ``gnn_pressure_estimation_tpu/data/codecs.py`` without its native
fast path (``data/native/codecs.cpp``): the Python codecs, the JAX package's
fallback and behavioural reference, are the only ones here, so reading a
store builds no library and the PyTorch package imports nothing of the JAX
package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# c-blosc1 flag bits / codec ids
_DOSHUFFLE = 0x1
_MEMCPYED = 0x2
_DOBITSHUFFLE = 0x4
_DONT_SPLIT = 0x10
_CODEC_BLOSCLZ, _CODEC_LZ4, _CODEC_SNAPPY, _CODEC_ZLIB, _CODEC_ZSTD = 0, 1, 2, 3, 4
_MAX_SPLITS = 16
_MIN_BUFFERSIZE = 128


# ---------------------------------------------------------------------------
# LZ4 block format
# ---------------------------------------------------------------------------

def lz4_decompress(src: bytes, dest_size: int) -> bytes:
    """Decode one LZ4 *block* (not frame) into exactly ``dest_size`` bytes."""
    dst = bytearray(dest_size)
    si, di, n = 0, 0, len(src)
    while si < n:
        token = src[si]
        si += 1
        # literals
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[si]
                si += 1
                lit += b
                if b != 255:
                    break
        if lit:
            dst[di : di + lit] = src[si : si + lit]
            si += lit
            di += lit
        if si >= n:
            break  # last sequence: literals only
        # match
        offset = src[si] | (src[si + 1] << 8)
        si += 2
        if offset == 0:
            raise ValueError("corrupt LZ4 block: zero match offset")
        mlen = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = src[si]
                si += 1
                mlen += b
                if b != 255:
                    break
        ref = di - offset
        if ref < 0:
            raise ValueError("corrupt LZ4 block: offset before start")
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

def shuffle_bytes(data: bytes, typesize: int) -> bytes:
    """c-blosc byte shuffle: group byte k of every item together."""
    if typesize <= 1 or len(data) < typesize:
        return bytes(data)
    n_items = len(data) // typesize
    body = n_items * typesize
    a = np.frombuffer(data[:body], np.uint8).reshape(n_items, typesize)
    return a.T.tobytes() + data[body:]


def unshuffle_bytes(data: bytes, typesize: int) -> bytes:
    if typesize <= 1 or len(data) < typesize:
        return bytes(data)
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
