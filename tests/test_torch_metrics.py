"""The port's metrics (``dffx_torch.metrics``) against ``dffx.metrics`` to
1e-12 relative on the same predictions, ground truth, masks and confidences,
and its numpy jet colormap byte for byte against ``dffx``'s (matplotlib)."""

import numpy as np
import pytest

from dffx import metrics as JM
from dffx.eval.common import jet_colormap as jet_ref
from dffx_torch import metrics as M
from dffx_torch.eval.common import jet_colormap


@pytest.fixture(scope="module")
def maps():
    rng = np.random.default_rng(0)
    gt = rng.uniform(0.1, 1.5, (37, 53)).astype(np.float32)
    est = (gt + rng.normal(0, 0.2, gt.shape)).clip(0.05, None).astype(np.float32)
    conf = rng.uniform(0, 1, gt.shape).astype(np.float32)
    return est, gt, conf, rng.random(gt.shape) > 0.3


@pytest.mark.parametrize("name", ["mask_abs_rel", "mask_sq_rel", "mask_mse", "mask_mae",
                                  "mask_rmse", "mask_rmse_log"])
def test_masked_metric_matches_dffx(maps, name):
    est, gt, _, mask = maps
    np.testing.assert_allclose(getattr(M, name)(est, gt, mask), getattr(JM, name)(est, gt, mask),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_accuracy_matches_dffx(maps, k):
    est, gt, _, mask = maps
    np.testing.assert_allclose(M.mask_accuracy_k(est, gt, k, mask),
                               JM.mask_accuracy_k(est, gt, k, mask), rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", ["mask_mse_w_conf", "mask_mae_w_conf"])
def test_confidence_weighted_metric_matches_dffx(maps, name):
    est, gt, conf, mask = maps
    np.testing.assert_allclose(getattr(M, name)(est, gt, conf, mask),
                               getattr(JM, name)(est, gt, conf, mask), rtol=1e-12, atol=0)


def test_bumpiness_matches_dffx(maps):
    est, gt, _, mask = maps
    np.testing.assert_allclose(M.get_bumpiness(gt, est, mask), JM.get_bumpiness(gt, est, mask),
                               rtol=1e-12, atol=0)


def test_jet_colormap_is_byte_equal_to_dffx():
    """Over [0, 1] at every entry boundary, out of range on both sides, the
    ends, inf and NaN, in float32 and float64, in 1-D and 2-D."""
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(-0.5, 1.5, 20000), np.linspace(0, 1, 4097),
                        np.arange(257) / 256, [np.nan, -np.inf, np.inf, 0.0, 1.0, 1 - 1e-12]])
    for arr in (x, x.astype(np.float32), x[:20000].reshape(100, 200)):
        got = jet_colormap(arr)
        assert got.dtype == np.uint8 and got.shape == arr.shape + (3,)
        np.testing.assert_array_equal(got, jet_ref(arr))
