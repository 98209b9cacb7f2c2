"""Minimal TensorBoard event writer (pure Python, no tensorboard dependency).

The reference logs train/validation scalars through
``torch.utils.tensorboard.SummaryWriter`` (`train_code_DDFF.py:33,128-136`);
``dffx`` writes the same tags into standard ``events.out.tfevents.*`` files
so existing TensorBoard setups read them unchanged, and the port this copy of
its writer (``dffx/utils/tensorboard.py``); each package reads the other's
files.  Implements just what's
needed: TFRecord framing with masked CRC32C and hand-encoded Event/Summary
protos (scalar values).
"""

from __future__ import annotations

import os
import struct
import time

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven
# ---------------------------------------------------------------------------

_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# protobuf wire helpers (just varint / fixed / length-delimited)
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _field_varint(num: int, val: int) -> bytes:
    return _varint(num << 3) + _varint(val)


def _field_double(num: int, val: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", val)


def _field_float(num: int, val: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", val)


def _field_bytes(num: int, val: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(val)) + val


def _event(wall_time: float, step: int, body: bytes = b"") -> bytes:
    return _field_double(1, wall_time) + _field_varint(2, step) + body


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    summary = _field_bytes(1, val)
    return _field_bytes(5, summary)


class SummaryWriter:
    """Drop-in for the scalar subset of torch's SummaryWriter."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.dffx_torch"
        self._f = open(os.path.join(log_dir, fname), "ab")
        self._write(_event(time.time(), 0, _field_bytes(3, b"brain.Event:2")))

    def _write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", _masked_crc(record)))
        self._f.flush()

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._write(_event(time.time(), int(step), _scalar_summary(tag, float(value))))

    def close(self) -> None:
        self._f.close()


def read_scalars(path: str):
    """Parse an event file back (used by tests; also handy for quick greps)."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        (length,) = struct.unpack_from("<Q", data, off)
        (hcrc,) = struct.unpack_from("<I", data, off + 8)
        assert hcrc == _masked_crc(data[off : off + 8]), "header crc mismatch"
        rec = data[off + 12 : off + 12 + length]
        (dcrc,) = struct.unpack_from("<I", data, off + 12 + length)
        assert dcrc == _masked_crc(rec), "data crc mismatch"
        off += 12 + length + 4
        item = _parse_event(rec)
        if item is not None:
            out.append(item)
    return out


def _read_varint(buf, p):
    n = shift = 0
    while True:
        b = buf[p]
        p += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, p
        shift += 7


def _parse_event(rec: bytes):
    p = 0
    step = 0
    tag = None
    value = None
    while p < len(rec):
        key, p = _read_varint(rec, p)
        num, wire = key >> 3, key & 7
        if wire == 1:
            payload = rec[p : p + 8]
            p += 8
        elif wire == 5:
            payload = rec[p : p + 4]
            p += 4
        elif wire == 0:
            v, p = _read_varint(rec, p)
            payload = v
        elif wire == 2:
            ln, p = _read_varint(rec, p)
            payload = rec[p : p + ln]
            p += ln
        else:
            raise ValueError(f"wire type {wire}")
        if num == 2 and wire == 0:
            step = payload
        elif num == 5 and wire == 2:
            q = 0
            while q < len(payload):
                k2, q = _read_varint(payload, q)
                if (k2 >> 3) == 1 and (k2 & 7) == 2:
                    ln, q = _read_varint(payload, q)
                    val_msg = payload[q : q + ln]
                    q += ln
                    r = 0
                    while r < len(val_msg):
                        k3, r = _read_varint(val_msg, r)
                        if (k3 >> 3) == 1 and (k3 & 7) == 2:
                            ln3, r = _read_varint(val_msg, r)
                            tag = val_msg[r : r + ln3].decode()
                            r += ln3
                        elif (k3 >> 3) == 2 and (k3 & 7) == 5:
                            (value,) = struct.unpack_from("<f", val_msg, r)
                            r += 4
                        else:
                            break
    if tag is not None:
        return (tag, step, value)
    return None
