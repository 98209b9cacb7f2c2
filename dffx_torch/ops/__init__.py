"""dffx_torch.ops — the JAX package's numerics kit in PyTorch, ``(B, C, N, H, W)``.

* ``conv3d`` / ``deconv3d``     — Conv3d / ConvTranspose3d (output_padding (0,1,1))
* ``batch_norm``, ``bn_fused_affine`` — eval BatchNorm with running statistics
* ``max_pool3d`` / ``avg_pool3d`` — (1,k,k) pooling
* ``upsample_bilinear``         — F.upsample(mode='bilinear'), align_corners=False
* ``softplus_argmax``           — softplus -> normalise over N -> soft-argmax
* ``pool.adaptive_avg_pool_focus`` — the motion heads' AdaptiveAvgPool3d((10,1,1))
* ``warp``                      — the separable per-slice affine warp (E2E)
* ``kernels``                   — the five CUDA kernels and their plain twins
"""

from dffx_torch.ops.conv import conv3d, deconv3d
from dffx_torch.ops.norm import batch_norm, bn_fused_affine
from dffx_torch.ops.pool import avg_pool3d, max_pool3d
from dffx_torch.ops.resize import upsample_bilinear
from dffx_torch.ops.softargmax import softplus_argmax

__all__ = [
    "conv3d",
    "deconv3d",
    "batch_norm",
    "bn_fused_affine",
    "avg_pool3d",
    "max_pool3d",
    "upsample_bilinear",
    "softplus_argmax",
]
