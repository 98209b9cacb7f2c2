"""Bilinear 2D upsampling, torch-1.6 ``F.upsample(mode='bilinear')`` semantics
(`Depth_Estimation_Network.py:86,111,113`): ``align_corners=False``; and
``dffx``'s 1-D interpolation matrix (``bilinear_matrix``)."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def bilinear_matrix(n_in: int, n_out: int, align_corners: bool = False) -> np.ndarray:
    """(n_out, n_in) row-stochastic 1D bilinear interpolation matrix, float32:
    source coordinate ``(o + 0.5) * in/out - 0.5`` (or ``o * (in-1)/(out-1)``
    with ``align_corners``) clamped to the edges.  Cached, so frozen: every
    caller gets the same array."""
    m = np.zeros((n_out, n_in), dtype=np.float64)
    if align_corners and n_out > 1:
        src = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    else:
        src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    src = np.clip(src, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    w_hi = src - lo
    m[np.arange(n_out), lo] += 1.0 - w_hi
    m[np.arange(n_out), hi] += w_hi
    out = m.astype(np.float32)
    out.setflags(write=False)
    return out


def upsample_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Resize the two trailing axes of a ``(B, N, H, W)`` cost volume."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)
