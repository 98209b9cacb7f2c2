"""Evaluation metrics — one module, formulas and names matching the reference
`Depth_Estimation_Test/metrics.py` (byte-identical copy also in train_codes/)
so printed numbers are directly comparable.

The port's copy of ``dffx/metrics.py``.  Host-side numpy by design: metrics
run on fetched predictions once per sample, off the card's hot path.  ``get_bumpiness`` reproduces the Scharr-based Hessian
Frobenius norm (`metrics.py:41-61`) without skimage-version drift by using the
same 3x3 Scharr kernels.
"""

from __future__ import annotations

import numpy as np

# skimage.filters.scharr_v/h kernels (normalized), used by the reference for
# bumpiness.  scharr_v detects vertical edges (d/dx), scharr_h horizontal (d/dy).
_SCHARR_V = (
    np.array([[3, 0, -3], [10, 0, -10], [3, 0, -3]], dtype=np.float64) / 32.0
)
_SCHARR_H = _SCHARR_V.T


def _filter2_same_reflect(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Correlate with skimage's 'reflect' boundary (= numpy 'symmetric':
    the edge sample is included in the reflection), matching scharr_*."""
    pad = 1
    padded = np.pad(img, pad, mode="symmetric")
    h, w = img.shape
    out = np.zeros_like(img, dtype=np.float64)
    for dy in range(3):
        for dx in range(3):
            out += kernel[dy, dx] * padded[dy : dy + h, dx : dx + w]
    return out


def mask_abs_rel(est, gt, mask):
    return np.mean(np.abs(gt[mask] - est[mask]) / gt[mask])


def mask_sq_rel(est, gt, mask):
    return np.mean(np.power(gt[mask] - est[mask], 2) / gt[mask])


def mask_mse(est, gt, mask):
    return np.mean(np.power(gt[mask] - est[mask], 2))


def mask_mae(est, gt, mask):
    return np.mean(np.abs(gt[mask] - est[mask]))


def mask_rmse(est, gt, mask):
    return np.sqrt(np.mean(np.power(est[mask] - gt[mask], 2)))


def mask_rmse_log(est, gt, mask):
    lg = np.log(gt[mask])
    le = np.log(est[mask])
    return np.sqrt(np.mean(np.power(lg - le, 2)))


def mask_accuracy_k(est, gt, k, mask):
    a = est[mask] / gt[mask]
    b = gt[mask] / est[mask]
    thresh = np.maximum(a, b)
    return np.sum(np.where(thresh < 1.25**k, 1, 0)) / np.sum(mask)


def mask_mse_w_conf(est, gt, conf, mask):
    return np.sum(conf[mask] * np.power(gt[mask] - est[mask], 2)) / np.sum(conf[mask])


def mask_mae_w_conf(est, gt, conf, mask):
    return np.sum(conf[mask] * np.abs(gt[mask] - est[mask])) / np.sum(conf[mask])


def get_bumpiness(gt, algo_result, mask, clip=0.05, factor=100):
    """Clipped Frobenius norm of the Hessian of (pred - gt), x100."""
    diff = np.asarray(algo_result, dtype="float64") - np.asarray(gt, dtype="float64")
    dx = _filter2_same_reflect(diff, _SCHARR_V)
    dy = _filter2_same_reflect(diff, _SCHARR_H)
    dxx = _filter2_same_reflect(dx, _SCHARR_V)
    dxy = _filter2_same_reflect(dx, _SCHARR_H)
    dyy = _filter2_same_reflect(dy, _SCHARR_H)
    dyx = _filter2_same_reflect(dy, _SCHARR_V)
    bumpiness = np.sqrt(
        np.square(dxx) + np.square(dxy) + np.square(dyy) + np.square(dyx)
    )
    bumpiness = np.clip(bumpiness, 0, clip)
    return np.mean(bumpiness[mask]) * factor
