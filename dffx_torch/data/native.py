"""Host-side decode and normalisation of the loaders, through the port's own
C++ library.

The library is built from ``dffx_torch/csrc/host`` with ``g++`` at first use
(``data/_host_build.py``) and bound here with ``ctypes``, which releases the
GIL for each call.  It is the JAX package's ``csrc/dffxio.cc`` split into
units, and this module keeps ``dffx/data/native.py``'s API: the
normalisation (uint8 -> ``x/127.5 - 1``, the pad to multiples of 32, the
layout change) always runs in the library, in threads; JPEG, PNG and TIFF
decode there where the unit that decodes the format was built (``formats()``).

``cv2`` decodes a file in two cases only, counted in ``decodes`` under the
file's format (``jpeg``, ``png``, ``tiff`` or ``other``) and the route:

* ``cv2-punt``: a file that ``dffx``'s decoder also hands to ``cv2``, since
  libjpeg, libpng or libtiff would decode it otherwise than ``cv2.imread``:
  a JPEG with an EXIF orientation other than 1 (or a CMYK or YCCK JPEG,
  which libjpeg does not convert to BGR), a PNG with alpha or 16 bits
  in ``imread``, palette, alpha, interlace or another layout in
  ``imread_unchanged``, a TIFF that is not 8-bit gray or RGB in ``imread``
  (or whose compression libtiff was built without), or a file of another
  format;
* ``cv2-absent``: the format's unit was not built (its header was missing).

A file the library reads as ``native`` is byte-equal to ``cv2.imread``
(``tests/test_torch_native.py``).  A decode error in the library raises
``FileNotFoundError``, as ``cv2`` returning ``None`` does; a failed build
raises ``_host_build.BuildError``.  The numpy versions of the normalisation
stay as ``*_plain``, the reference the tests hold the library to.

``cv2`` is imported by the functions that need it, never when this module is
imported; where it is not installed they raise ``ImportError`` naming it and
the reader that needed it (``require``).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import importlib
import threading
from typing import Optional, Tuple

import numpy as np

from dffx_torch.data import _host_build

#: decodes since the last ``reset_decodes()``: (format, route) -> files
decodes: collections.Counter = collections.Counter()
_count_lock = threading.Lock()
#: the C decoders' return code for a file that ``cv2`` must decode (-5: a row
#: layout the unchanged reads do not expect)
_PUNTS = (-4, -5)
#: unchanged-decode ``kind`` codes shared with the C units (dtype, channels)
_KIND = {1: (np.uint8, 1), 2: (np.uint16, 1), 3: (np.float32, 1),
         4: (np.uint8, 3), 5: (np.uint16, 3)}
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def require(module: str, user: str):
    """Import ``module`` for ``user`` (a reader or writer and the command line
    that runs it); raise ``ImportError`` naming both where it is missing."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"{user} needs the package {module.split('.')[0]!r}, which is not "
                          f"installed") from e


def reset_decodes() -> None:
    with _count_lock:
        decodes.clear()


def _count(fmt: str, route: str) -> None:
    with _count_lock:
        decodes[(fmt, route)] += 1


@dataclasses.dataclass(frozen=True)
class HostLibrary:
    cdll: ctypes.CDLL
    build: _host_build.HostBuild


def _declare(lib: ctypes.CDLL, formats) -> None:
    i64, f32, i32 = ctypes.c_int64, ctypes.c_float, ctypes.c_int
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    pi64 = ctypes.POINTER(ctypes.c_int64)
    sigs = {"dffxio_normalize_pad_stack": ([u8p, f32p, *[i64] * 6, f32, i32], None),
            "dffxio_normalize_pad_stack_f32": ([f32p, f32p, *[i64] * 6, f32, i32], None),
            "dffxio_hwcn_to_nhwc_normalize": ([f64p, f32p, *[i64] * 4, i32], None)}
    if "jpeg" in formats:
        sigs.update({"dffxio_jpeg_info": ([u8p, i64, pi64, pi64], i32),
                     "dffxio_jpeg_decode": ([u8p, i64, u8p, i64, i64], i32),
                     "dffxio_png_info": ([u8p, i64, pi64, pi64], i32),
                     "dffxio_png_decode": ([u8p, i64, u8p, i64, i64], i32),
                     "dffxio_png_info_unchanged": ([u8p, i64, pi64, pi64, pi64], i32),
                     "dffxio_png_decode_unchanged": ([u8p, i64, ctypes.c_void_p, i64, i64, i64],
                                                     i32)})
    if "tiff" in formats:
        sigs.update({"dffxio_tiff_info": ([u8p, i64, pi64, pi64, pi64], i32),
                     "dffxio_tiff_decode_bgr": ([u8p, i64, u8p, i64, i64], i32),
                     "dffxio_tiff_decode_raw": ([u8p, i64, ctypes.c_void_p, i64, i64, i64],
                                                i32)})
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype


@functools.lru_cache(maxsize=None)
def library() -> HostLibrary:
    """The loaded host library, built at the first call."""
    built = _host_build.build()
    lib = ctypes.CDLL(str(built.path))
    _declare(lib, built.formats)
    return HostLibrary(lib, built)


def available() -> bool:
    """``dffx.data.native.available``'s name, kept for its callers: always True
    once ``library()`` has built and loaded the library (a failed build
    raises, where ``dffx`` returned False)."""
    return library() is not None


def formats() -> frozenset:
    """What the library holds: ``normalize`` always, ``jpeg`` and ``png``
    with the codec unit, ``tiff`` with the TIFF unit."""
    return library().build.formats


# ---------------------------------------------------------------------------
# normalisation
# ---------------------------------------------------------------------------


def _padded(h: int, w: int) -> Tuple[int, int]:
    return h + (32 - h % 32) % 32, w + (32 - w % 32) % 32


def normalize_pad_stack(stack: np.ndarray, pad_value: float = -1.0,
                        threads: int = 4) -> np.ndarray:
    """(N, H, W, C) uint8/float32 -> (N, Hp, Wp, C) float32, normalized
    ``x/127.5 - 1`` and padded at the bottom and right to multiples of 32 with
    ``pad_value``, in ``threads`` threads over the slices."""
    if stack.ndim != 4:
        raise ValueError(f"normalize_pad_stack takes (N, H, W, C), got {stack.shape}")
    n, h, w, c = stack.shape
    hp, wp = _padded(h, w)
    lib = library().cdll
    dst = np.empty((n, hp, wp, c), dtype=np.float32)
    if stack.dtype == np.uint8:
        lib.dffxio_normalize_pad_stack(np.ascontiguousarray(stack), dst, n, h, w, c, hp, wp,
                                       pad_value, threads)
    else:
        lib.dffxio_normalize_pad_stack_f32(np.ascontiguousarray(stack, dtype=np.float32), dst,
                                           n, h, w, c, hp, wp, pad_value, threads)
    return dst


def hwcn_to_nhwc_normalize(stack: np.ndarray, threads: int = 4) -> np.ndarray:
    """(H, W, C, N) float64 -> (N, H, W, C) float32 normalized ``x/127.5-1``."""
    if stack.ndim != 4:
        raise ValueError(f"hwcn_to_nhwc_normalize takes (H, W, C, N), got {stack.shape}")
    h, w, c, n = stack.shape
    dst = np.empty((n, h, w, c), dtype=np.float32)
    library().cdll.dffxio_hwcn_to_nhwc_normalize(
        np.ascontiguousarray(stack, dtype=np.float64), dst, h, w, c, n, threads)
    return dst


def normalize_pad_stack_plain(stack: np.ndarray, pad_value: float = -1.0) -> np.ndarray:
    """``normalize_pad_stack`` in numpy: the reference of the tests."""
    _, h, w, _ = stack.shape
    hp, wp = _padded(h, w)
    out = np.asarray(stack, dtype=np.float32) / 127.5 - 1.0
    return np.pad(out, ((0, 0), (0, hp - h), (0, wp - w), (0, 0)), constant_values=pad_value)


def hwcn_to_nhwc_normalize_plain(stack: np.ndarray) -> np.ndarray:
    """``hwcn_to_nhwc_normalize`` in numpy: the reference of the tests."""
    return np.ascontiguousarray((stack / 127.5 - 1.0).transpose(3, 0, 1, 2)).astype(np.float32)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _jpeg_exif_orientation(buf: bytes) -> int:
    """EXIF Orientation (1 when absent/unparseable).  libjpeg ignores EXIF
    but cv2.imread auto-rotates; oriented files must take the cv2 path or
    the two decoders disagree by a rotation."""
    try:
        i, n = 2, len(buf)
        while i + 4 <= n and buf[i] == 0xFF:
            marker = buf[i + 1]
            if marker == 0x01 or 0xD0 <= marker <= 0xD8:
                i += 2
                continue
            if marker == 0xDA:  # start of scan — no EXIF seen
                break
            seglen = int.from_bytes(buf[i + 2 : i + 4], "big")
            if marker == 0xE1 and buf[i + 4 : i + 10] == b"Exif\x00\x00":
                t = i + 10
                bo = "little" if buf[t : t + 2] == b"II" else "big"
                p = t + int.from_bytes(buf[t + 4 : t + 8], bo)
                cnt = int.from_bytes(buf[p : p + 2], bo)
                for k in range(cnt):
                    e = p + 2 + 12 * k
                    if int.from_bytes(buf[e : e + 2], bo) == 0x0112:
                        return int.from_bytes(buf[e + 8 : e + 10], bo) or 1
                return 1
            i += 2 + seglen
    except Exception:
        pass
    return 1


def _read_buf(path: str) -> np.ndarray:
    try:
        with open(path, "rb") as f:
            return np.frombuffer(f.read(), np.uint8)
    except OSError as e:
        raise FileNotFoundError(f"cannot decode image {path!r}: {e.strerror}") from e


def _format(head: bytes) -> str:
    if head[:4] in (b"II*\x00", b"MM\x00*"):
        return "tiff"
    if head[:2] == b"\xff\xd8":
        return "jpeg"
    if head == _PNG_MAGIC:
        return "png"
    return "other"


def _checked(rc: int, fmt: str, path: str) -> bool:
    """True where the library decoded; False where ``cv2`` must (a punt);
    raises on a decode error."""
    if rc == 0:
        return True
    if rc in _PUNTS:
        return False
    raise FileNotFoundError(f"cannot decode image {path!r}: the {fmt} decoder returned {rc}")


def _decode(path: str, unchanged: bool) -> Tuple[str, Optional[np.ndarray], str]:
    """(format, the image or ``None`` where ``cv2`` decodes it, route)."""
    buf = _read_buf(path)
    fmt = _format(buf[:8].tobytes())
    if fmt == "other" or (unchanged and fmt == "jpeg"):
        return fmt, None, "cv2-punt"
    if fmt not in formats():
        return fmt, None, "cv2-absent"
    lib = library().cdll
    h, w, k = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    dims = (ctypes.byref(h), ctypes.byref(w))
    if unchanged:
        info, dec = ((lib.dffxio_tiff_info, lib.dffxio_tiff_decode_raw) if fmt == "tiff" else
                     (lib.dffxio_png_info_unchanged, lib.dffxio_png_decode_unchanged))
        if not _checked(info(buf, len(buf), *dims, ctypes.byref(k)), fmt, path):
            return fmt, None, "cv2-punt"
        dtype, ch = _KIND[k.value]
        out = np.empty((h.value, w.value) if ch == 1 else (h.value, w.value, ch), dtype)
        ok = _checked(dec(buf, len(buf), out.ctypes.data, h.value, w.value, k.value), fmt, path)
        return fmt, out if ok else None, "native" if ok else "cv2-punt"
    if fmt == "tiff":
        # cv2 parity only for 8-bit gray and RGB (kinds 1 and 4)
        if not _checked(lib.dffxio_tiff_info(buf, len(buf), *dims, ctypes.byref(k)), fmt,
                        path) or k.value not in (1, 4):
            return fmt, None, "cv2-punt"
        dec = lib.dffxio_tiff_decode_bgr
    elif fmt == "jpeg":
        if _jpeg_exif_orientation(buf.tobytes()) != 1:
            return fmt, None, "cv2-punt"
        if not _checked(lib.dffxio_jpeg_info(buf, len(buf), *dims), fmt, path):
            return fmt, None, "cv2-punt"
        dec = lib.dffxio_jpeg_decode
    else:
        if not _checked(lib.dffxio_png_info(buf, len(buf), *dims), fmt, path):
            return fmt, None, "cv2-punt"
        dec = lib.dffxio_png_decode
    out = np.empty((h.value, w.value, 3), np.uint8)
    ok = _checked(dec(buf, len(buf), out, h.value, w.value), fmt, path)
    return fmt, out if ok else None, "native" if ok else "cv2-punt"


def imread(path: str) -> Optional[np.ndarray]:
    """``cv2.imread``-compatible decode, ``(H, W, 3)`` uint8 **BGR**, through
    the library; ``None`` where ``cv2`` must decode the file (a punt or an
    absent unit, module docstring)."""
    fmt, img, route = _decode(path, unchanged=False)
    if img is not None:
        _count(fmt, route)
    return img


def imread_unchanged(path: str) -> Optional[np.ndarray]:
    """``cv2.imread(path, IMREAD_UNCHANGED)``-compatible decode of a PNG or
    TIFF through the library: gray ``(H, W)`` and color ``(H, W, 3)`` BGR in
    the file's own dtype; ``None`` where ``cv2`` must decode the file."""
    fmt, img, route = _decode(path, unchanged=True)
    if img is not None:
        _count(fmt, route)
    return img


def _decoded(img, path: str) -> np.ndarray:
    if img is None:  # cv2 returns None for a missing or undecodable file
        raise FileNotFoundError(f"cannot decode image {path!r}")
    return img


def _compat(path: str, user: str, unchanged: bool) -> np.ndarray:
    fmt, img, route = _decode(path, unchanged)
    if img is None:
        cv2 = require("cv2", user)
        img = _decoded(cv2.imread(path, cv2.IMREAD_UNCHANGED) if unchanged else cv2.imread(path),
                       path)
    _count(fmt, route)
    return img


def imread_compat(path: str, user: str) -> np.ndarray:
    """``imread``, or ``cv2.imread`` where ``cv2`` must decode the file:
    ``(H, W, 3)`` uint8 **BGR**, as the reference reads."""
    return _compat(path, user, unchanged=False)


def imread_unchanged_compat(path: str, user: str) -> np.ndarray:
    """``imread_unchanged``, or ``cv2.imread(path, IMREAD_UNCHANGED)`` where
    ``cv2`` must decode the file: the file's own dtype, gray as ``(H, W)`` and
    color as BGR (the reference's raw ground-truth reads)."""
    return _compat(path, user, unchanged=True)
