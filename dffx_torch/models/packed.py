"""Exact space-to-depth ("packed") evaluation of DFFNet's full-resolution
stage and of its two EFD downsamplers: the counterpart of
``dffx/models/packed.py``, eval mode only.

The last decoder stage (``deconv_3``, the ``dres4`` hourglass, ``classif3``)
runs 3D convs with 8 and 16 channels at full resolution.  Here the same
arithmetic runs on the half-resolution lattice with four times the channels:

* a full-resolution tensor ``(B, C, N, H, W)`` is stored packed as ``(B, 4C,
  N, H/2, W/2)`` with channel ``phase * C + c``, ``phase = (y % 2) * 2 + (x %
  2)`` (``F.pixel_unshuffle`` orders channels ``c * 4 + phase``: it is not
  ``pack``);
* every conv and deconv weight is scattered into an equivalent kernel over
  the packed lattice (the derivation stands in each transform's docstring).
  The transforms are exact, a reparameterisation and no approximation;
  ``tests/test_torch_packed.py`` holds them against the unpacked modules and,
  bit for bit, against the JAX package's.

A stride-1 3x3 conv becomes a (kd,3,3) packed conv with four times the
channels both ways, three quarters of its weights structural zeros; strided
convs and the deconvs map with no expansion onto (kd,2,2) kernels.  The
transforms take and return torch-layout weights; the index maps address the
weight as ``(kd, kh, kw, Cin, Cout)``, as the JAX package's do.

Packed weights are derived, never stored: the state_dict is that of the
unpacked model.  A caller keeps them in a ``ParamCache`` (``DFFNet`` does),
which holds them on a CUDA device, in the activation dtype, until a source
weight changes; for a CPU tensor they are built on every call.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

#: whether ``DFFNet`` (and ``load_params_auto``) runs packed unless told
#: otherwise, on the CPU as on the card.  Measured on an NVIDIA H100 80GB HBM3
#: (700 W) with ``dffx_torch/bench.py``: packed, a DFFNet forward at 10 x 384 x
#: 384 takes 16 ms against 25-27 in fp32 at batch 1 and 21 against 60-61 in
#: bf16 at batch 4; an end-to-end forward at 10 x 608 x 1088 takes 81-82 ms
#: against 121-122 in fp32 and 38 against 83-84 in bf16 (``PERF.md``)
PACKED_DEFAULT = True

Affine = Tuple[torch.Tensor, torch.Tensor]
#: ``F.pad`` arguments (W, H, N; left, right): one cell after H and W for a
#: packed deconv, one before for a packed strided conv, N padded by 1 each side
_PAD_DECONV = (0, 1, 0, 1, 1, 1)
_PAD_S2 = (1, 0, 1, 0, 1, 1)


def pack(x: torch.Tensor) -> torch.Tensor:
    """(B, C, N, H, W) -> (B, 4C, N, H/2, W/2), channel = phase * C + c."""
    b, c, n, h, w = x.shape
    x = x.reshape(b, c, n, h // 2, 2, w // 2, 2)
    return x.permute(0, 4, 6, 1, 2, 3, 5).reshape(b, 4 * c, n, h // 2, w // 2)


def unpack(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack`."""
    b, c4, n, hh, wh = x.shape
    x = x.reshape(b, 2, 2, c4 // 4, n, hh, wh)
    return x.permute(0, 3, 4, 5, 1, 6, 2).reshape(b, c4 // 4, n, 2 * hh, 2 * wh)


def pack_affine(scale: torch.Tensor, shift: torch.Tensor, dtype: torch.dtype) -> Affine:
    """Per-channel affine -> packed channels (the same values in each phase),
    in the activation dtype and shaped to broadcast over (B, 4C, N, H, W)."""
    return tuple(v.to(dtype).repeat(4).view(1, -1, 1, 1, 1) for v in (scale, shift))


def _in_index(in_groups):
    """Packed input channel index for original channel ``ci`` at phase ``p``.

    ``in_groups=[c0, c1, ...]``: the packed input is a channel-concat of
    independently packed tensors of those widths (packed concat != packed of
    concat, so the weight scatter absorbs the permutation).
    """

    def idx(p, ci):
        off = 0
        for g in in_groups:
            if ci < g:
                return off + p * g + ci
            ci -= g
            off += 4 * g
        raise IndexError(ci)

    return idx


# Each transform is one gather: a numpy index map (dy, dx, ci, co) -> source
# tap (or masked zero), built once per shape, then ``w[:, dy, dx, ci, co] * mask``.


@functools.lru_cache(maxsize=None)
def _s1_index_map(ci: int, co: int, groups: tuple):
    idx = _in_index(list(groups))
    shape = (3, 3, 4 * ci, 4 * co)
    dym = np.zeros(shape, np.int32)
    dxm = np.zeros(shape, np.int32)
    cim = np.zeros(shape, np.int32)
    com = np.zeros(shape, np.int32)
    mask = np.zeros(shape, np.float32)
    cos = np.arange(co)
    for qy in (0, 1):
        for qx in (0, 1):
            q = qy * 2 + qx
            for dy in range(3):
                for dx in range(3):
                    py, dy_c = (qy + dy - 1) % 2, (qy + dy - 1) // 2
                    px, dx_c = (qx + dx - 1) % 2, (qx + dx - 1) // 2
                    p_in = py * 2 + px
                    for c0 in range(ci):
                        j = idx(p_in, c0)
                        sl = (dy_c + 1, dx_c + 1, j, slice(q * co, (q + 1) * co))
                        dym[sl], dxm[sl], cim[sl], com[sl] = dy, dx, c0, cos
                        mask[sl] = 1.0
    return dym, dxm, cim, com, mask


@functools.lru_cache(maxsize=None)
def _s2_index_map(ci: int, co: int):
    shape = (2, 2, 4 * ci, co)
    dym = np.zeros(shape, np.int32)
    dxm = np.zeros(shape, np.int32)
    cim = np.zeros(shape, np.int32)
    com = np.zeros(shape, np.int32)
    mask = np.zeros(shape, np.float32)
    cis, cos = np.arange(ci)[:, None], np.arange(co)[None, :]
    for dy in range(3):
        for dx in range(3):
            py, dy_c = (dy - 1) % 2, (dy - 1) // 2
            px, dx_c = (dx - 1) % 2, (dx - 1) // 2
            p_in = py * 2 + px
            sl = (dy_c + 1, dx_c + 1, slice(p_in * ci, (p_in + 1) * ci), slice(None))
            dym[sl], dxm[sl], cim[sl], com[sl] = dy, dx, cis, cos
            mask[sl] = 1.0
    return dym, dxm, cim, com, mask


@functools.lru_cache(maxsize=None)
def _deconv_index_map(ci: int, co: int):
    taps = {(0, 0): 1, (1, 0): 2, (1, 1): 0}  # (phase, window tap) -> w index
    shape = (2, 2, ci, 4 * co)
    dym = np.zeros(shape, np.int32)
    dxm = np.zeros(shape, np.int32)
    cim = np.zeros(shape, np.int32)
    com = np.zeros(shape, np.int32)
    mask = np.zeros(shape, np.float32)
    cis, cos = np.arange(ci)[:, None], np.arange(co)[None, :]
    for qy in (0, 1):
        for qx in (0, 1):
            q = qy * 2 + qx
            for ty in (0, 1):
                for tx in (0, 1):
                    iy = taps.get((qy, ty))
                    ix = taps.get((qx, tx))
                    if iy is None or ix is None:
                        continue
                    sl = (ty, tx, slice(None), slice(q * co, (q + 1) * co))
                    dym[sl], dxm[sl], cim[sl], com[sl] = iy, ix, cis, cos
                    mask[sl] = 1.0
    return dym, dxm, cim, com, mask


@functools.lru_cache(maxsize=None)
def _conv1x1_index_map(ci: int, co: int):
    shape = (1, 1, 4 * ci, 4 * co)
    cim = np.zeros(shape, np.int32)
    com = np.zeros(shape, np.int32)
    mask = np.zeros(shape, np.float32)
    cis, cos = np.arange(ci)[:, None], np.arange(co)[None, :]
    for p in range(4):
        sl = (0, 0, slice(p * ci, (p + 1) * ci), slice(p * co, (p + 1) * co))
        cim[sl], com[sl] = cis, cos
        mask[sl] = 1.0
    return np.zeros(shape, np.int32), np.zeros(shape, np.int32), cim, com, mask


def _scatter(w_dhwio: torch.Tensor, index_map) -> torch.Tensor:
    """``w[:, dy, dx, ci, co] * mask`` on a ``(kd, kh, kw, Cin, Cout)`` view of
    a weight, returned as a conv weight ``(Cout', Cin', kd, kh', kw')``."""
    *maps, mask = (torch.from_numpy(a).to(w_dhwio.device) for a in index_map)
    dym, dxm, cim, com = (m.long() for m in maps)
    out = w_dhwio[:, dym, dxm, cim, com] * mask.to(w_dhwio.dtype)
    return out.permute(4, 3, 0, 1, 2).contiguous()


def _conv_dhwio(w: torch.Tensor) -> torch.Tensor:
    """Conv weight ``(Cout, Cin, kd, kh, kw)`` viewed as ``(kd, kh, kw, Cin, Cout)``."""
    return w.permute(2, 3, 4, 1, 0)


def pack_conv_s1(w: torch.Tensor, in_groups: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Stride-1 ``(kd,3,3)`` conv (pad 1) ``(Co, Ci, kd, 3, 3)`` -> packed
    ``(4Co, 4Ci, kd, 3, 3)``.

    out[2Y+qy] = sum_dy w[dy] x[2Y+qy+dy-1]; the input lands at packed cell
    Y + DY, phase py with DY = floor((qy+dy-1)/2), py = (qy+dy-1) mod 2, so
    kernel tap (DY+1) carries w[dy] for that (phase_in, phase_out) block.
    Apply with padding (pd, 1, 1) on the packed lattice.
    """
    co, ci, _, kh, kw = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"pack_conv_s1 takes (kd, 3, 3) kernels, got {tuple(w.shape)}")
    groups = tuple(in_groups or [ci])
    if sum(groups) != ci:
        raise ValueError(f"in_groups {groups} do not sum to Cin = {ci}")
    return _scatter(_conv_dhwio(w), _s1_index_map(ci, co, groups))


def pack_conv_s2(w: torch.Tensor) -> torch.Tensor:
    """Strided ``(kd,3,3)`` s(1,2,2) conv (pad 1) ``(Co, Ci, kd, 3, 3)`` ->
    packed ``(Co, 4Ci, kd, 2, 2)`` producing the half-resolution (unpacked)
    output directly.

    out[Y] = sum_dy w[dy] x[2Y+dy-1]: cells {Y-1, Y} -> kernel 2, pad-left 1
    on the packed lattice (``_PAD_S2``).
    """
    co, ci, _, kh, kw = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"pack_conv_s2 takes (kd, 3, 3) kernels, got {tuple(w.shape)}")
    return _scatter(_conv_dhwio(w), _s2_index_map(ci, co))


def pack_deconv(w: torch.Tensor) -> torch.Tensor:
    """``ConvTranspose3d(k3, s(1,2,2), p1, op(0,1,1))`` weight ``(Ci, Co, kd,
    3, 3)`` -> an ordinary conv weight ``(4Co, Ci, kd, 2, 2)`` consuming the
    half-resolution input, emitting packed full resolution.

    Per spatial dim: out[2Y] = w[1] x[Y]; out[2Y+1] = w[2] x[Y] + w[0] x[Y+1]
    -> cells {Y, Y+1}, kernel 2, pad-right 1 (``_PAD_DECONV``); the focus axis
    is the usual flipped-kernel stride-1 transposed conv, pad 1.
    """
    ci, co, _, kh, kw = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"pack_deconv takes (kd, 3, 3) kernels, got {tuple(w.shape)}")
    wf = w.permute(2, 3, 4, 0, 1).flip(0)  # DHWIO; focus-axis correlation flip
    return _scatter(wf, _deconv_index_map(ci, co))


def pack_conv_1x1(w: torch.Tensor) -> torch.Tensor:
    """1x1x1 conv ``(Co, Ci, 1, 1, 1)`` -> packed block-diagonal ``(4Co, 4Ci, 1, 1, 1)``."""
    co, ci, *k = w.shape
    if tuple(k) != (1, 1, 1):
        raise ValueError(f"pack_conv_1x1 takes 1x1x1 kernels, got {tuple(w.shape)}")
    return _scatter(_conv_dhwio(w), _conv1x1_index_map(ci, co))


def _affine(x: torch.Tensor, aff: Affine) -> torch.Tensor:
    return x * aff[0] + aff[1]


# ---------------------------------------------------------------------------
# EFD on a packed input
# ---------------------------------------------------------------------------


def efd_params(x: torch.Tensor, w_stride: torch.Tensor) -> torch.Tensor:
    """What ``packed_efd`` derives from an EFD's weights, for a ``ParamCache``:
    the strided conv's packed weight in x's dtype."""
    return pack_conv_s2(w_stride.to(x.dtype))


def packed_efd(efd, xp: torch.Tensor, w_s2: torch.Tensor) -> torch.Tensor:
    """``EFD`` (`Depth_Estimation_Network.py:306-315`) consuming a PACKED
    input ``xp``, with ``w_s2 = efd_params(xp, ...)``.

    * strided-conv branch: the packed stride-2 kernel emits the
      half-resolution (natural) output directly;
    * maxpool branch: ``MaxPool3d((1,2,2))`` windows are exactly the aligned
      2x2 phase blocks, so the pool is a max over the 4 phase channel groups.
    """
    a = efd.stride_conv[1](F.conv3d(F.pad(xp, _PAD_S2), w_s2))
    b, c4, n, hh, wh = xp.shape
    mp = xp.reshape(b, 4, c4 // 4, n, hh, wh).amax(1)
    return torch.relu(a + efd.max_pooling[1](mp))


# ---------------------------------------------------------------------------
# One decoder stage on the packed lattice
# ---------------------------------------------------------------------------


def stage_params(x: torch.Tensor, w_up, aff_up: Affine, w0, aff0: Affine, w1, w6,
                 aff6: Affine, w_classif) -> tuple:
    """What ``packed_stage`` derives from the stage's weights and fused BN
    affines, for a ``ParamCache``, in x's dtype (cast before the gather: the
    structural zeros stay exact): the up-deconv and its affine, the
    hourglass's conv0 (its input is the concat of two packed tensors of
    ``c`` channels each), conv1 (strided), conv6 (deconv) and its affine, and
    the 1x1 head."""
    dt = x.dtype
    c = w_up.shape[1]
    return (pack_deconv(w_up.to(dt)), pack_affine(*aff_up, dt),
            pack_conv_s1(w0.to(dt), in_groups=[c, c]), pack_affine(*aff0, dt),
            pack_conv_s2(w1.to(dt)), pack_deconv(w6.to(dt)), pack_affine(*aff6, dt),
            pack_conv_1x1(w_classif.to(dt)))


def stage_sources(deconv, hg, classif) -> tuple:
    """``stage_params``'s arguments after x, from the stage's modules
    (``DeconvBN3d``, ``Hourglass``, the bias-free 1x1 ``Conv3d``)."""
    return (deconv[0].weight, deconv[1].fused_affine(),
            hg.conv0[0][0].weight, hg.conv0[0][1].fused_affine(),
            hg.conv1[0][0].weight, hg.conv6[0].weight, hg.conv6[1].fused_affine(),
            classif.weight)


def packed_stage(hg, out_in: torch.Tensor, skip_packed: torch.Tensor,
                 presqu: Optional[torch.Tensor], postsqu: Optional[torch.Tensor],
                 params: tuple) -> torch.Tensor:
    """One decoder stage (an up-deconv, the ``Hourglass`` ``hg`` and a 1x1
    head: ``deconv_3``, ``dres4``, ``classif3``) on the packed lattice of the
    stage's resolution, with ``params = stage_params(out_in, ...)``.

    Packed pieces: the up-deconv, the hourglass's conv0 (stage resolution),
    conv1 (strided back down, emitting the natural interior resolution) and
    conv6 (deconv back up), the residual add, and the head.  The hourglass
    interior (conv2..conv5) already runs at half the stage resolution and
    below and stays on the ordinary modules; ``out_in`` and the
    cross-hourglass skip state (presqu, postsqu) come in natural layout,
    the long skip (``fm``) packed.  Returns the cost ``(B, N, H, W)``.
    """
    w_up, aff_up, w0, aff0, w1, w6, aff6, w_classif = params
    x = _affine(F.conv3d(F.pad(out_in, _PAD_DECONV), w_up), aff_up)  # packed 4c
    cat = torch.cat([x, skip_packed], dim=1)  # source-major packed 2c
    pre_1 = torch.relu(_affine(F.conv3d(cat, w0, padding=1), aff0))
    out = F.conv3d(F.pad(pre_1, _PAD_S2), w1)  # natural, half the stage resolution
    out = hg.interior(torch.relu(hg.conv1[0][1](out)), presqu, postsqu)
    o6 = _affine(F.conv3d(F.pad(out, _PAD_DECONV), w6), aff6)
    return unpack(F.conv3d(x + o6, w_classif))[:, 0]
