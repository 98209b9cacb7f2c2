"""Minimal OpenEXR scanline codec (pure Python, numpy + zlib).

The reference reads depth/confidence maps from EXR via the OpenEXR package or
cv2's EXR backend (`test_Dataloader.py:47-54`, `:205`); ``dffx`` carries its own
reader instead (``dffx/data/exr.py``), and the port this copy of it, for the
subset the datasets use: single-part scanline images, HALF/FLOAT channels,
NONE/ZIP/ZIPS compression — plus a writer (NONE or ZIP) used by tests and the
simulator.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

_MAGIC = 20000630
_PIXEL_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}
_PT_FROM_DTYPE = {np.dtype(np.uint32): 0, np.dtype(np.float16): 1, np.dtype(np.float32): 2}
# scanlines per chunk by compression id
_BLOCK_LINES = {0: 1, 1: 1, 2: 1, 3: 16, 4: 32, 5: 16, 6: 32}


def _read_cstr(buf: memoryview, off: int) -> Tuple[str, int]:
    end = off
    while buf[end] != 0:
        end += 1
    return bytes(buf[off:end]).decode("latin-1"), end + 1


def _unpredict(data: bytearray) -> bytes:
    """Inverse of OpenEXR zip predictor: delta-decode then de-interleave.
    The format stores d[0], then d[i] - d[i-1] + 128 — i.e. a mod-256 cumsum."""
    raw = np.frombuffer(bytes(data), dtype=np.uint8).astype(np.int64)
    raw[1:] -= 128
    dec = np.cumsum(raw).astype(np.uint8)
    # de-interleave: first half holds even positions, second half odd
    n = len(dec)
    half = (n + 1) // 2
    out = np.empty(n, dtype=np.uint8)
    out[0::2] = dec[:half]
    out[1::2] = dec[half:]
    return out.tobytes()


def _predict(data: bytes) -> bytes:
    """Forward zip predictor: interleave then delta-encode."""
    arr = np.frombuffer(data, dtype=np.uint8)
    n = len(arr)
    half = (n + 1) // 2
    inter = np.empty(n, dtype=np.uint8)
    inter[:half] = arr[0::2]
    inter[half:] = arr[1::2]
    d = inter.astype(np.int16)
    d[1:] = d[1:] - d[:-1] + 128
    return d.astype(np.uint8).tobytes()


def read(path: str) -> Dict[str, np.ndarray]:
    """Read an EXR file → dict of channel name → (H, W) array."""
    with open(path, "rb") as f:
        data = memoryview(f.read())
    magic, version = struct.unpack_from("<ii", data, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise NotImplementedError("multi-part EXR not supported")
    off = 8

    channels = []  # (name, pixel_type)
    compression = None
    data_window = None
    while True:
        name, off = _read_cstr(data, off)
        if not name:
            break
        attr_type, off = _read_cstr(data, off)
        (size,) = struct.unpack_from("<i", data, off)
        off += 4
        payload = data[off : off + size]
        off += size
        if name == "channels":
            p = 0
            while payload[p] != 0:
                ch_name, p = _read_cstr(payload, p)
                (ptype,) = struct.unpack_from("<i", payload, p)
                p += 16  # type + pLinear/reserved + xSampling + ySampling
                channels.append((ch_name, ptype))
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            data_window = struct.unpack_from("<4i", payload, 0)

    xmin, ymin, xmax, ymax = data_window
    width = xmax - xmin + 1
    height = ymax - ymin + 1
    if compression not in (0, 2, 3):
        raise NotImplementedError(f"EXR compression id {compression} not supported")
    lines_per_block = _BLOCK_LINES[compression]
    n_blocks = -(-height // lines_per_block)

    # channels are stored sorted by name within each scanline
    chans_sorted = sorted(channels, key=lambda c: c[0])
    dtypes = {n: _PIXEL_DTYPES[t] for n, t in chans_sorted}
    out = {n: np.empty((height, width), dtype=dtypes[n]) for n, _ in chans_sorted}

    # skip offset table
    off += 8 * n_blocks
    for _ in range(n_blocks):
        y, nbytes = struct.unpack_from("<ii", data, off)
        off += 8
        chunk = bytes(data[off : off + nbytes])
        off += nbytes
        y0 = y - ymin
        n_lines = min(lines_per_block, height - y0)
        line_bytes = sum(width * np.dtype(dtypes[n]).itemsize for n, _ in chans_sorted)
        raw_size = line_bytes * n_lines
        if compression == 0 or nbytes == raw_size:
            raw = chunk
        else:
            raw = _unpredict(bytearray(zlib.decompress(chunk)))
        p = 0
        for line in range(n_lines):
            for nme, _t in chans_sorted:
                nb = width * np.dtype(dtypes[nme]).itemsize
                out[nme][y0 + line] = np.frombuffer(raw[p : p + nb], dtype=dtypes[nme])
                p += nb
    return out


def read_depth(path: str, channel: str = "R") -> np.ndarray:
    """Read one channel as float32 (the reference reads the R channel of its
    depth EXRs as float16 and reshapes — `test_Dataloader.py:47-54`)."""
    return read(path)[channel].astype(np.float32)


def write(path: str, channels: Dict[str, np.ndarray], *, compression: str = "zip") -> None:
    """Write a scanline EXR (HALF/FLOAT channels), for tests/simulator output."""
    names = sorted(channels)
    h, w = channels[names[0]].shape
    comp_id = {"none": 0, "zips": 2, "zip": 3}[compression]
    lines_per_block = _BLOCK_LINES[comp_id]

    def attr(name: str, typ: str, payload: bytes) -> bytes:
        return (
            name.encode() + b"\0" + typ.encode() + b"\0" + struct.pack("<i", len(payload)) + payload
        )

    chlist = b""
    for n in names:
        pt = _PT_FROM_DTYPE[channels[n].dtype]
        chlist += n.encode() + b"\0" + struct.pack("<i", pt) + b"\0\0\0\0" + struct.pack("<ii", 1, 1)
    chlist += b"\0"

    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = b"".join(
        [
            attr("channels", "chlist", chlist),
            attr("compression", "compression", bytes([comp_id])),
            attr("dataWindow", "box2i", box),
            attr("displayWindow", "box2i", box),
            attr("lineOrder", "lineOrder", b"\0"),
            attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
            attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0)),
            attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
            b"\0",
        ]
    )

    chunks = []
    for y0 in range(0, h, lines_per_block):
        n_lines = min(lines_per_block, h - y0)
        raw = b"".join(
            channels[n][y0 + line].tobytes()
            for line in range(n_lines)
            for n in names
        )
        if comp_id == 0:
            payload = raw
        else:
            payload = zlib.compress(_predict(raw))
            if len(payload) >= len(raw):
                payload = raw
        chunks.append((y0, payload))

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))
        f.write(header)
        offset = 8 + len(header) + 8 * len(chunks)
        for y0, payload in chunks:
            f.write(struct.pack("<Q", offset))
            offset += 8 + len(payload)
        for y0, payload in chunks:
            f.write(struct.pack("<ii", y0, len(payload)))
            f.write(payload)
