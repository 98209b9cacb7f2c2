"""Bilinear 2D upsampling, torch-1.6 ``F.upsample(mode='bilinear')`` semantics
(`Depth_Estimation_Network.py:86,111,113`): ``align_corners=False``;
``dffx``'s 1-D interpolation matrix (``bilinear_matrix``); and DFV's
resizes of ``(B, C, N, H, W)`` features, which keep an NDHWC input NDHWC:
trilinear to a given size (``align_corners=False``) and nearest x2 over H
and W (HSM's ``nn.Upsample(scale_factor=2)`` on each slice)."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from dffx_torch.ops.conv import is_ndhwc, layout_of, per_slice


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


@functools.lru_cache(maxsize=None)
def _device_matrix(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """``bilinear_matrix`` on ``device``, copied there once (a copy from
    pageable host memory waits for the card to finish its queue), and made
    outside inference mode so that a forward autograd records may read it."""
    with torch.inference_mode(False):
        return torch.tensor(bilinear_matrix(n_in, n_out), device=device)


def resize_trilinear(x: torch.Tensor, size, *, memory_format=None) -> torch.Tensor:
    """``F.interpolate(x, size, mode="trilinear", align_corners=False)`` of
    ``x (B, C, N, H, W)``, laid out as ``memory_format`` (default: x's).

    NDHWC results are made without ATen's trilinear kernel, which loops over
    B * C in each thread: a resize that keeps N is the bilinear one of each
    slice (the weights along N are 1 and 0), run on the channels-last slices
    with no copy; any other (DFV's pooled branches, from a few values a
    channel) is three products with ``bilinear_matrix`` in fp32, along W, H
    and N, on x's channels-last ``(B, N, H, W, C)`` view, the last one
    writing the result NDHWC."""
    size = tuple(int(v) for v in size)
    fmt = layout_of(x) if memory_format is None else memory_format
    if fmt != torch.channels_last_3d:
        return F.interpolate(x, size=size, mode="trilinear", align_corners=False).contiguous(
            memory_format=fmt)
    if size[0] == x.shape[2] and x.is_contiguous(memory_format=fmt):
        return per_slice(x, lambda y: F.interpolate(y, size=size[1:], mode="bilinear",
                                                    align_corners=False))
    b, c, n, h, w = x.shape
    d_out, h_out, w_out = size
    md, mh, mw = (_device_matrix(i, o, x.device)
                  for i, o in ((n, d_out), (h, h_out), (w, w_out)))
    y = x.permute(0, 2, 3, 4, 1).float().reshape(b * n * h, w, c)
    y = torch.matmul(mw, y).reshape(b * n, h, w_out * c)
    y = torch.matmul(mh, y).reshape(b, n, h_out * w_out * c)
    y = torch.matmul(md, y).to(x.dtype)
    return y.view(b, d_out, h_out, w_out, c).permute(0, 4, 1, 2, 3)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """Each slice of ``x (B, C, N, H, W)`` doubled in H and W by repeating
    its pixels (``nn.Upsample(scale_factor=2)``, mode nearest), in x's
    layout."""
    if is_ndhwc(x):
        return per_slice(x, lambda y: F.interpolate(y, scale_factor=2, mode="nearest"))
    return F.interpolate(x, scale_factor=(1, 2, 2), mode="nearest")
