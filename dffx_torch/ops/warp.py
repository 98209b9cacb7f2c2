"""Focal-stack warping by per-slice scale-about-centre plus translation.

The counterpart of ``dffx/ops/warp.py`` (reference
`End_to_End/End_to_End.py:106-134`, ``grid_sample`` with
``align_corners=True`` and zero padding over an identity z-grid).  The map is
axis-separable, so the warp is two per-slice interpolation-matrix products:

    out[b, n] = M_y[b, n] @ x[b, n] @ M_x[b, n]^T,   M[o, i] = relu(1 - |src(o) - i|)

The lattice, flow and matrices are built in fp32 exactly as the JAX package
builds them and cast to the activation dtype for the two products, which are
plain ``torch.einsum`` (cuBLAS on the card, as XLA did on the TPU).
"""

from __future__ import annotations

from typing import Tuple

import torch


def _lattice(n: int, device) -> torch.Tensor:
    """``jnp.linspace(-1, 1, n, dtype=float32)`` with JAX's rounding:
    ``-1 * (1 - s) + 1 * s`` at ``s = i / (n - 1)``, the last point exactly 1."""
    if n == 1:
        return torch.full((1,), -1.0, device=device)
    step = torch.arange(n - 1, dtype=torch.float32, device=device) / (n - 1)
    head = -1.0 * (1.0 - step) + 1.0 * step
    return torch.cat([head, torch.ones(1, device=device)])


def affine_warp_matrices(fov: torch.Tensor, shift: torch.Tensor, n: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Interpolation matrix and flow for one axis of length ``n``.

    ``flow[o] = (n // 2) * (fov - 1) * l[o] + shift`` (pixels, ``l`` the
    ``[-1, 1]`` lattice) and ``src[o] = o - flow[o]``.  fov, shift ``(...)``
    -> ``M (..., n, n)`` and ``flow (..., n)``, both fp32."""
    lin = _lattice(n, fov.device)
    flow = (n // 2) * (fov.float()[..., None] - 1.0) * lin + shift.float()[..., None]
    src = torch.arange(n, dtype=torch.float32, device=fov.device) - flow
    idx = torch.arange(n, dtype=torch.float32, device=fov.device)
    return torch.clamp(1.0 - (src[..., None] - idx).abs(), min=0.0), flow


def warp_cf(x: torch.Tensor, fov: torch.Tensor, beta: torch.Tensor, gamma: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The warp in the port's ``(B, C, N, H, W)`` layout.

    Returns ``(warped, flow_x (B, N, W), flow_y (B, N, H))``; the flows are
    fp32 and constant along the other axis."""
    h, w = x.shape[-2:]
    mx, flow_x = affine_warp_matrices(fov, beta, w)   # (B,N,W,W), (B,N,W)
    my, flow_y = affine_warp_matrices(fov, gamma, h)  # (B,N,H,H), (B,N,H)
    y = torch.einsum("bnoh,bcnhw->bcnow", my.to(x.dtype), x)
    y = torch.einsum("bcnow,bnpw->bcnop", y, mx.to(x.dtype))
    return y, flow_x, flow_y


def flow_cf(flow_x: torch.Tensor, flow_y: torch.Tensor, dtype) -> torch.Tensor:
    """The per-pixel (x, y) shifts as a ``(B, 2, N, H, W)`` channel block."""
    b, n, w = flow_x.shape
    h = flow_y.shape[-1]
    fx = flow_x[:, None, :, None, :].expand(b, 1, n, h, w)
    fy = flow_y[:, None, :, :, None].expand(b, 1, n, h, w)
    return torch.cat([fx, fy], dim=1).to(dtype)


def affine_warp_stack(x: torch.Tensor, fov: torch.Tensor, beta: torch.Tensor,
                      gamma: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dffx.ops.affine_warp_stack`` in the JAX layout.

    x ``(B, N, H, W, C)``; fov (the effective field-of-view factor), beta (x
    shift) and gamma (y shift) ``(B, N)``.  Returns ``(warped, flow)``:
    ``warped`` shaped like x, ``flow (B, N, H, W, 2)`` holding the (x, y)
    pixel shifts, both in x.dtype."""
    y, fx, fy = warp_cf(x.permute(0, 4, 1, 2, 3), fov, beta, gamma)
    return y.permute(0, 2, 3, 4, 1), flow_cf(fx, fy, x.dtype).permute(0, 2, 3, 4, 1)
