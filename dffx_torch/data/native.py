"""Host-side decode and normalisation of the loaders, in numpy and ``cv2``.

The JAX package's ``dffx/data/native.py`` binds a C++ library
(``csrc/dffxio.cc``) that fuses the uint8 -> ``x/127.5 - 1`` normalisation, the
pad to multiples of 32 and the image decode, and falls back to the numpy and
``cv2`` paths below when the library is not built; its tests hold the two
bit-equal.  The port has one decoder, these paths, and loads no C++ library.

``cv2`` is imported by the functions that decode, never when this module is
imported; where it is not installed they raise ``ImportError`` naming it and
the reader that needed it (``require``).
"""

from __future__ import annotations

import importlib

import numpy as np


def require(module: str, user: str):
    """Import ``module`` for ``user`` (a reader or writer and the command line
    that runs it); raise ``ImportError`` naming both where it is missing."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"{user} needs the package {module.split('.')[0]!r}, which is not "
                          f"installed") from e


def normalize_pad_stack(stack: np.ndarray, pad_value: float = -1.0) -> np.ndarray:
    """(N, H, W, C) uint8/float32 -> (N, Hp, Wp, C) float32, normalized
    ``x/127.5 - 1`` and padded at the bottom and right to multiples of 32 with
    ``pad_value``."""
    _, h, w, _ = stack.shape
    hp = h + (32 - h % 32) % 32
    wp = w + (32 - w % 32) % 32
    out = np.asarray(stack, dtype=np.float32) / 127.5 - 1.0
    return np.pad(out, ((0, 0), (0, hp - h), (0, wp - w), (0, 0)), constant_values=pad_value)


def hwcn_to_nhwc_normalize(stack: np.ndarray) -> np.ndarray:
    """(H, W, C, N) float64 -> (N, H, W, C) float32 normalized ``x/127.5-1``."""
    return np.ascontiguousarray((stack / 127.5 - 1.0).transpose(3, 0, 1, 2)).astype(np.float32)


def _decoded(img, path: str) -> np.ndarray:
    if img is None:  # cv2 returns None for a missing or undecodable file
        raise FileNotFoundError(f"cannot decode image {path!r}")
    return img


def imread_compat(path: str, user: str) -> np.ndarray:
    """``cv2.imread``: ``(H, W, 3)`` uint8 **BGR**, as the reference reads."""
    cv2 = require("cv2", user)
    return _decoded(cv2.imread(path), path)


def imread_unchanged_compat(path: str, user: str) -> np.ndarray:
    """``cv2.imread(path, IMREAD_UNCHANGED)``: the file's own dtype, gray as
    ``(H, W)`` and color as BGR (the reference's raw ground-truth reads)."""
    cv2 = require("cv2", user)
    return _decoded(cv2.imread(path, cv2.IMREAD_UNCHANGED), path)
