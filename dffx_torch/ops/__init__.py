"""dffx_torch.ops — the JAX package's numerics kit in PyTorch, ``(B, C, N, H, W)``.

* ``conv3d`` / ``deconv3d``     — Conv3d / ConvTranspose3d (any kernel, stride, padding and
                                  output padding; defaults DFFNet's k3 deconv, output_padding
                                  (0,1,1); DDFFNet's (1,4,4) upconvs per slice on NDHWC)
* ``batch_norm``, ``bn_fused_affine`` — eval BatchNorm with running statistics
* ``batch_norm_train``          — train BatchNorm: batch statistics, new running ones
* ``max_pool3d`` / ``avg_pool3d`` — MaxPool3d / AvgPool3d, no padding (DDFFNet's (1,2,2)
                                  max-pools; DFV's averages, over N too); both keep NDHWC
* ``adaptive_avg_pool_focus``   — the motion heads' AdaptiveAvgPool3d((10,1,1))
* ``upsample_bilinear``         — F.upsample(mode='bilinear'), align_corners=False
* ``resize_trilinear`` / ``upsample_nearest2x`` — DFV's resizes of (B, C, N, H, W)
* ``bilinear_matrix``           — ``dffx``'s 1-D interpolation matrix (numpy)
* ``affine_warp_matrices`` / ``affine_warp_stack`` — the separable per-slice
                                  affine warp (E2E, the simulator), ``dffx``'s layout
* ``grid_sample_2d``            — F.grid_sample align_corners=True, zeros pad, (B, H, W, C)
* ``softplus_argmax``           — softplus -> normalise over N -> soft-argmax
* ``softmax_argmax``            — DFV's softmax over N -> depth and its spread
* ``kernels``                   — the CUDA kernels and their plain twins: the five
                                  ported ones and the eval BN's one pass (``bn_act``,
                                  which ``norm.affine_act`` sends 16-bit eval BNs to)
* ``halo``                      — the kernels' chains H-sharded over a spatial group

Every name of ``dffx.ops.__all__`` is here; the warps keep ``dffx``'s layout,
the rest take the port's channel-first one.
"""

from dffx_torch.ops.conv import conv3d, deconv3d
from dffx_torch.ops.norm import batch_norm, batch_norm_train, bn_fused_affine
from dffx_torch.ops.pool import adaptive_avg_pool_focus, avg_pool3d, max_pool3d
from dffx_torch.ops.resize import (bilinear_matrix, resize_trilinear, upsample_bilinear,
                                   upsample_nearest2x)
from dffx_torch.ops.softargmax import softmax_argmax, softplus_argmax
from dffx_torch.ops.warp import affine_warp_matrices, affine_warp_stack, grid_sample_2d

__all__ = [
    "conv3d",
    "deconv3d",
    "batch_norm",
    "batch_norm_train",
    "bn_fused_affine",
    "avg_pool3d",
    "max_pool3d",
    "adaptive_avg_pool_focus",
    "bilinear_matrix",
    "upsample_bilinear",
    "resize_trilinear",
    "upsample_nearest2x",
    "affine_warp_matrices",
    "affine_warp_stack",
    "grid_sample_2d",
    "softplus_argmax",
    "softmax_argmax",
]
