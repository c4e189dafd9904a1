"""Minimal OpenEXR scanline codec (pure numpy + stdlib zlib).

A copy of lupinpathtracer_tpu/io/exr.py (the port imports nothing of the
JAX package).

Covers the reference's EXR usage (lupin_loader/src/loader.rs:209-293 loads
EXR textures via the `image` crate; :1775-1879 saves rgba16f renders as
EXR): single-part scanline images, HALF/FLOAT/UINT channels, NONE / RLE /
ZIPS / ZIP compression on read; writes HALF RGB(A) scanlines with ZIP
compression. Tiled, deep, and PIZ/B44/DWA files raise a clear error.

Format reference: the OpenEXR file layout documentation (openexr.com,
"Technical Documentation > OpenEXR File Layout").
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"\x76\x2f\x31\x01"

# pixel types
_UINT, _HALF, _FLOAT = 0, 1, 2
_TYPE_DTYPE = {_UINT: np.uint32, _HALF: np.float16, _FLOAT: np.float32}
_TYPE_SIZE = {_UINT: 4, _HALF: 2, _FLOAT: 4}

# compression ids -> scanlines per block (None = unsupported)
_BLOCK_LINES = {0: 1, 1: 1, 2: 1, 3: 16}
_COMP_NAMES = {4: "PIZ", 5: "PXR24", 6: "B44", 7: "B44A", 8: "DWAA", 9: "DWAB"}


def _read_cstr(buf: memoryview, pos: int):
    end = pos
    while buf[end] != 0:
        end += 1
    return bytes(buf[pos:end]).decode("latin-1"), end + 1


def _reconstruct(data: np.ndarray) -> np.ndarray:
    """Inverse of the ZIP/RLE byte predictor: d[i] += d[i-1] - 128 with
    uint8 wraparound, expressed as one cumsum."""

    d = data.astype(np.int64)
    # out[i] = d[0] + sum_{1..i}(d[k] - 128) = sum_{0..i} d[k] - 128*i
    out = (np.cumsum(d) - 128 * np.arange(len(d))) % 256
    return out.astype(np.uint8)


def _deinterleave(data: np.ndarray) -> np.ndarray:
    n = len(data)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = data[:half]
    out[1::2] = data[half:]
    return out


def _interleave(data: np.ndarray) -> np.ndarray:
    n = len(data)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[:half] = data[0::2]
    out[half:] = data[1::2]
    return out


def _predict(data: np.ndarray) -> np.ndarray:
    """Forward byte predictor for ZIP compression (delta + 128 bias)."""

    d = data.astype(np.int64)
    out = np.empty(len(d), np.int64)
    out[0] = d[0]
    out[1:] = (d[1:] - d[:-1] + 128) % 256
    return out.astype(np.uint8)


def _rle_decode(data: bytes, expected: int) -> np.ndarray:
    out = np.empty(expected, np.uint8)
    src = np.frombuffer(data, np.uint8)
    i = o = 0
    n = len(src)
    while i < n and o < expected:
        count = src[i].astype(np.int8)
        i += 1
        if count < 0:
            cnt = int(-count)
            out[o : o + cnt] = src[i : i + cnt]
            i += cnt
        else:
            cnt = int(count) + 1
            out[o : o + cnt] = src[i]
            i += 1
        o += cnt
    if o != expected:
        raise ValueError(f"EXR RLE block decoded {o} of {expected} bytes")
    return out


def _decompress_block(comp: int, payload: bytes, raw_size: int) -> bytes:
    if comp == 0 or len(payload) >= raw_size:
        # NO_COMPRESSION, or the writer stored the block raw because
        # compression didn't shrink it (the format allows this).
        return payload
    if comp in (2, 3):  # ZIPS / ZIP
        raw = np.frombuffer(zlib.decompress(payload), np.uint8)
    elif comp == 1:  # RLE
        raw = _rle_decode(payload, raw_size)
    else:
        raise NotImplementedError(
            f"EXR compression {_COMP_NAMES.get(comp, comp)} not supported"
        )
    return _deinterleave(_reconstruct(raw)).tobytes()


def read_exr(path) -> np.ndarray:
    """Read a single-part scanline EXR into (H, W, 4) float32 (alpha = 1
    where absent). Channels other than R/G/B/A/Y are ignored; a Y-only
    (luminance) image broadcasts into RGB."""

    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    version = struct.unpack_from("<i", data, 4)[0]
    if version & 0x200:
        raise NotImplementedError("tiled EXR not supported")
    if version & (0x800 | 0x1000):
        raise NotImplementedError("deep/multi-part EXR not supported")

    buf = memoryview(data)
    pos = 8
    attrs = {}
    while True:
        name, pos = _read_cstr(buf, pos)
        if not name:
            break
        atype, pos = _read_cstr(buf, pos)
        size = struct.unpack_from("<i", data, pos)[0]
        pos += 4
        attrs[name] = (atype, bytes(buf[pos : pos + size]))
        pos += size

    # channels
    chan_raw = attrs["channels"][1]
    channels = []  # (name, pixel_type) in file (alphabetical) order
    cpos = 0
    cbuf = memoryview(chan_raw)
    while cbuf[cpos] != 0:
        cname, cpos = _read_cstr(cbuf, cpos)
        ptype, _plin, xs, ys = struct.unpack_from("<iBxxxii", chan_raw, cpos)
        cpos += 16
        if xs != 1 or ys != 1:
            raise NotImplementedError("subsampled EXR channels not supported")
        channels.append((cname, ptype))

    comp = attrs["compression"][1][0]
    if comp not in _BLOCK_LINES:
        raise NotImplementedError(
            f"EXR compression {_COMP_NAMES.get(comp, comp)} not supported"
        )
    block_lines = _BLOCK_LINES[comp]
    xmin, ymin, xmax, ymax = struct.unpack("<4i", attrs["dataWindow"][1])
    W = xmax - xmin + 1
    H = ymax - ymin + 1
    line_order = attrs["lineOrder"][1][0]

    n_blocks = -(-H // block_lines)
    # skip the offset table; chunks follow it sequentially
    pos += 8 * n_blocks

    bytes_per_px = sum(_TYPE_SIZE[t] for _, t in channels)
    planes = {n: np.zeros((H, W), np.float32) for n, _ in channels}
    for _ in range(n_blocks):
        y0, size = struct.unpack_from("<ii", data, pos)
        pos += 8
        payload = data[pos : pos + size]
        pos += size
        y0 -= ymin
        nlines = min(block_lines, H - y0)
        raw = _decompress_block(comp, payload, nlines * W * bytes_per_px)
        off = 0
        for li in range(nlines):
            y = y0 + li
            if line_order == 1:  # DECREASING_Y
                y = H - 1 - y
            for cname, ptype in channels:
                nbytes = W * _TYPE_SIZE[ptype]
                row = np.frombuffer(raw, _TYPE_DTYPE[ptype], W, off)
                planes[cname][y] = row.astype(np.float32)
                off += nbytes

    out = np.zeros((H, W, 4), np.float32)
    out[..., 3] = 1.0
    if "Y" in planes and "R" not in planes:
        out[..., 0] = out[..., 1] = out[..., 2] = planes["Y"]
    else:
        for i, cname in enumerate(("R", "G", "B", "A")):
            if cname in planes:
                out[..., i] = planes[cname]
    return out


def _attr(name: str, atype: str, payload: bytes) -> bytes:
    return (
        name.encode() + b"\0" + atype.encode() + b"\0"
        + struct.pack("<i", len(payload)) + payload
    )


def write_exr(path, rgb: np.ndarray) -> None:
    """Write (H, W, 3|4) float32 as half-float scanline EXR with ZIP
    compression (matching save_texture's rgba16f->exr, loader.rs:1775-1879;
    alpha is dropped there and here)."""

    rgb = np.asarray(rgb, np.float32)[..., :3]
    H, W = rgb.shape[:2]
    halves = rgb.astype(np.float16)

    chan = b""
    for cname in ("B", "G", "R"):  # alphabetical, as required
        chan += cname.encode() + b"\0" + struct.pack("<iBxxxii", _HALF, 0, 1, 1)
    chan += b"\0"
    box = struct.pack("<4i", 0, 0, W - 1, H - 1)

    header = _MAGIC + struct.pack("<i", 2)
    header += _attr("channels", "chlist", chan)
    header += _attr("compression", "compression", bytes([3]))  # ZIP
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", bytes([0]))
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    block_lines = _BLOCK_LINES[3]
    n_blocks = -(-H // block_lines)
    chunks = []
    for b in range(n_blocks):
        y0 = b * block_lines
        nlines = min(block_lines, H - y0)
        rows = []
        for li in range(nlines):
            y = y0 + li
            for ci in (2, 1, 0):  # B, G, R
                rows.append(halves[y, :, ci].tobytes())
        raw = b"".join(rows)
        packed = zlib.compress(
            _predict(_interleave(np.frombuffer(raw, np.uint8))).tobytes()
        )
        if len(packed) >= len(raw):
            packed = raw  # store raw when compression doesn't help
        chunks.append(struct.pack("<ii", y0, len(packed)) + packed)

    table_start = len(header)
    data_start = table_start + 8 * n_blocks
    offsets = []
    off = data_start
    for c in chunks:
        offsets.append(off)
        off += len(c)

    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{n_blocks}Q", *offsets))
        for c in chunks:
            f.write(c)
