"""The port's thin-lens simulator (``dffx_torch.sim``) against ``dffx.sim`` on
the CPU: the same numpy inputs from a seed through both.

Bounds: the optics tables, ``coc_layers``, ``disc_kernel``, the camera
settings and focus distances exactly; rendered uint8 images |d| <= 1 at more
than 99.9 % of the pixels with a median of 0 (the bound ``dffx``'s own test
holds its render to: XLA's and torch's convolutions sum in different orders,
so ``floor`` and ``round`` may flip by 1 at ties); disparity and depth to
rtol 1e-4 / atol 1e-3 (``inf`` where the warped depth is 0 must match).
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import dffx.sim as jsim
import dffx_torch.sim as tsim
from dffx.sim import simulator as jsimulator
from dffx_torch.sim import simulator as tsimulator

#: tests/test_simulator.py's slice parameters (its fused-against-per-slice test)
SLICE_PARAMS = [
    dict(fov=1.0, beta=0.0, gamma=0.0, coc_scale=30.0, fd_px=0.4e4,
         layers=[(0, 0.1, 0.5), (3, 0.5, 1.2)]),
    dict(fov=1.02, beta=1.5, gamma=-0.7, coc_scale=45.0, fd_px=0.7e4,
         layers=[(-2, 0.1, 0.4), (1, 0.4, 0.8), (6, 0.8, 1.2)]),
    dict(fov=0.98, beta=-2.0, gamma=0.3, coc_scale=20.0, fd_px=0.9e4,
         layers=[(-7, 0.1, 0.6), (2, 0.6, 1.2)]),
]
FOCAL_LAYERS = [(0, 0.1, 0.4), (2, 0.4, 0.7), (-3, 0.7, 0.9), (5, 0.9, 1.2)]
RTOL, ATOL = 1e-4, 1e-3


def assert_u8_close(got, want):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert (d <= 1).mean() > 0.999, (d.max(), (d > 1).sum())
    assert np.median(d) == 0


def scene_inputs(rng, h=24, w=40):
    image = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    depth = rng.uniform(0.1, 1.1, (h, w))
    return image, depth, depth * 1e4


def test_device_profiles_equal():
    assert [dataclasses.astuple(p) for p in tsim.DEVICE_PROFILES] == [
        dataclasses.astuple(p) for p in jsim.DEVICE_PROFILES]
    assert [f.name for f in dataclasses.fields(tsim.DeviceProfile)] == [
        f.name for f in dataclasses.fields(jsim.DeviceProfile)]


@pytest.mark.parametrize("coc_scale,focus_dist,lo,hi,planes", [
    (35.0, 0.4, 0.1, 1.1, 500), (12.5, 0.1, 0.1, 1.1, 2000), (61.0, 0.9, 0.2, 0.8, 200),
    (7.3, 0.25, 0.1, 1.1, 37)])
def test_coc_layers_equal(coc_scale, focus_dist, lo, hi, planes):
    assert tsim.coc_layers(coc_scale, focus_dist, lo, hi, planes) == jsim.coc_layers(
        coc_scale, focus_dist, lo, hi, planes)


@pytest.mark.parametrize("size", [1, 3, 5, 9, 15, 19, 33])
def test_disc_kernel_bit_equal(size):
    got = tsim.disc_kernel(size)
    np.testing.assert_array_equal(got, jsim.disc_kernel(size))
    assert got.dtype == np.float64 and not got.flags.writeable
    assert tsim.disc_kernel(size) is got  # memoised


def test_buckets_equal():
    for n in range(1, 200):
        assert tsimulator._bucket(n) == jsimulator._bucket(n)
        assert tsimulator._bucket_odd(n) == jsimulator._bucket_odd(n)


@pytest.mark.parametrize("fov,beta,gamma", [(1.02, 3.0, -2.0), (0.97, -1.5, 0.8),
                                            (1.0, 0.0, 0.0), (1.035, -4.2, 2.6)])
def test_warp_2d_matches(rng, fov, beta, gamma):
    img = rng.uniform(0, 255, (40, 56, 3)).astype(np.float32)
    got = tsim.warp_2d(img, fov, beta, gamma, device="cpu")
    assert got.shape == img.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, jsim.warp_2d(img, fov, beta, gamma), rtol=0, atol=1e-3)
    depth_px = (rng.uniform(0.1, 1.1, (40, 56)) * 61626.0).astype(np.float32)
    got = tsim.warp_2d(depth_px, fov, beta, gamma, device="cpu")
    assert got.shape == depth_px.shape
    np.testing.assert_allclose(got, jsim.warp_2d(depth_px, fov, beta, gamma), rtol=1e-5,
                               atol=0)


def test_render_focal_slice_matches(rng):
    image, depth, _ = scene_inputs(rng, 32, 48)
    got = tsim.render_focal_slice(image, depth, FOCAL_LAYERS, device="cpu")
    assert_u8_close(got, jsim.render_focal_slice(image, depth, FOCAL_LAYERS))


@pytest.mark.parametrize("j", range(len(SLICE_PARAMS)))
def test_render_slice_fused_matches(rng, j):
    image, depth, depth_px = scene_inputs(rng)
    p = SLICE_PARAMS[j]
    args = (image, depth, depth_px, p["fov"], p["beta"], p["gamma"], p["layers"],
            p["coc_scale"], p["fd_px"])
    img, disp = tsim.render_slice_fused(*args, device="cpu")
    want_img, want_disp = jsim.render_slice_fused(*args)
    assert_u8_close(img, want_img)
    assert disp.dtype == np.float32
    np.testing.assert_allclose(disp, want_disp, rtol=RTOL, atol=ATOL)


def test_render_scene_fused_matches(rng):
    image, depth, depth_px = scene_inputs(rng)
    imgs, disp = tsim.render_scene_fused(image, depth, depth_px, SLICE_PARAMS, device="cpu")
    want_imgs, want_disp = jsim.render_scene_fused(image, depth, depth_px, SLICE_PARAMS)
    assert imgs.shape == (3, 24, 40, 3)
    assert_u8_close(imgs, want_imgs)
    np.testing.assert_allclose(disp, want_disp, rtol=RTOL, atol=ATOL)


def test_scene_fused_equals_per_slice(rng):
    """The port's whole-scene program equals its per-slice programs (other
    buckets, one slice a batch): images exactly, disparity to rtol 1e-4, the
    property ``dffx``'s own test asserts of its ``vmap``."""
    image, depth, depth_px = scene_inputs(rng)
    imgs, disp = tsim.render_scene_fused(image, depth, depth_px, SLICE_PARAMS, device="cpu")
    for j, p in enumerate(SLICE_PARAMS):
        want_img, want_disp = tsim.render_slice_fused(
            image, depth, depth_px, p["fov"], p["beta"], p["gamma"], p["layers"],
            p["coc_scale"], p["fd_px"], device="cpu")
        np.testing.assert_array_equal(imgs[j], want_img, err_msg=f"slice {j}")
        np.testing.assert_allclose(disp[j], want_disp, rtol=RTOL, atol=ATOL,
                                   err_msg=f"slice {j}")


@pytest.mark.parametrize("n,p", [(12, 16), (5, 4), (5, 13), (3, 2), (1, 3), (2, 7), (9, 0)])
def test_reflect_pad_is_numpys(n, p):
    x = torch.arange(2 * n * (n + 1), dtype=torch.float32).reshape(2, n, n + 1)
    got = tsimulator._reflect_pad(x, p).numpy()
    np.testing.assert_array_equal(got, np.pad(x.numpy(), ((0, 0), (p, p), (p, p)),
                                              mode="reflect"))


def test_reflect_pad_at_or_above_height_matches(rng):
    """A CoC of 9 gives a kernel of 19, bucketed to 33: a pad of 16 on a
    12-row image, which ``F.pad(mode="reflect")`` refuses and numpy reflects
    again."""
    image, depth, depth_px = scene_inputs(rng, 12, 40)
    layers = [(1, 0.1, 0.5), (9, 0.5, 1.2)]
    got = tsim.render_focal_slice(image, depth, layers, device="cpu")
    assert_u8_close(got, jsim.render_focal_slice(image, depth, layers))
    params = [dict(SLICE_PARAMS[1], layers=layers), dict(SLICE_PARAMS[2], layers=layers[:1])]
    imgs, disp = tsim.render_scene_fused(image, depth, depth_px, params, device="cpu")
    want_imgs, want_disp = jsim.render_scene_fused(image, depth, depth_px, params)
    assert_u8_close(imgs, want_imgs)
    np.testing.assert_allclose(disp, want_disp, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("profile", range(len(jsim.DEVICE_PROFILES)),
                         ids=[p.name for p in jsim.DEVICE_PROFILES])
def test_generate_scene_matches(rng, profile):
    image = rng.uniform(0, 255, (32, 48, 3)).astype(np.float32)
    depth = rng.uniform(0.1, 1.1, (32, 48))
    kw = dict(pixel_vs_meter=1 / 0.0000014 * 48 / 4080, num_imgs=4, num_planes=200)
    got = tsim.generate_scene(image, depth, profile=tsim.DEVICE_PROFILES[profile],
                              rng=np.random.default_rng(profile), device="cpu", **kw)
    want = jsim.generate_scene(image, depth, profile=jsim.DEVICE_PROFILES[profile],
                               rng=np.random.default_rng(profile), **kw)
    assert got["camera_setting"] == want["camera_setting"]
    np.testing.assert_array_equal(got["focus_dists"], want["focus_dists"])
    assert len(got["imgs"]) == 4
    assert_u8_close(np.stack(got["imgs"]), np.stack(want["imgs"]))
    assert got["disparity"].shape == (32, 48, 4) and got["disparity"].dtype == np.float64
    np.testing.assert_allclose(got["disparity"], want["disparity"], rtol=RTOL, atol=ATOL)
    assert got["depth"].shape == (32, 48)
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=RTOL, atol=ATOL)


def test_generate_scene_draws_like_dffx(rng):
    """The generator is left where ``dffx`` leaves it (two draws a moved
    slice), and one slice keeps the unwarped depth."""
    image = rng.uniform(0, 255, (16, 24, 3)).astype(np.float32)
    depth = rng.uniform(0.1, 1.1, (16, 24))
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    kw = dict(profile=tsim.DEVICE_PROFILES[2], pixel_vs_meter=3000.0, num_imgs=3, num_planes=50)
    tsim.generate_scene(image, depth, rng=a, device="cpu", **kw)
    jsim.generate_scene(image, depth, rng=b, **dict(kw, profile=jsim.DEVICE_PROFILES[2]))
    assert a.random() == b.random()
    one = tsim.generate_scene(image, depth, rng=a, device="cpu", **dict(kw, num_imgs=1))
    np.testing.assert_array_equal(one["depth"], depth)


def test_load_nyu_v2_matches(tmp_path, rng):
    h5py = pytest.importorskip("h5py")
    path = str(tmp_path / "nyu.mat")
    with h5py.File(path, "w") as f:
        f["images"] = rng.integers(0, 256, (2, 3, 56, 40), dtype=np.uint8)
        f["depths"] = rng.uniform(0.5, 5.0, (2, 56, 40)).astype(np.float32)
    got, want = tsimulator.load_nyu_v2(path), jsimulator.load_nyu_v2(path)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (8, 24, 3, 2) and got[1].shape == (8, 24, 2)


@pytest.mark.parametrize("name", ["warp_2d", "render_focal_slice", "render_slice_fused",
                                  "render_scene_fused", "generate_scene"])
def test_entry_points_default_to_the_card(name, rng):
    """Every entry point renders on the card unless asked for the CPU, and
    raises where there is none; it does not carry on on the CPU."""
    fn = getattr(tsim, name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is here: the GPU tests run the simulator on it")
    image, depth, depth_px = scene_inputs(rng, 8, 8)
    p = SLICE_PARAMS[1]
    call = {
        "warp_2d": lambda: fn(depth, 1.01, 0.5, 0.5),
        "render_focal_slice": lambda: fn(image, depth, FOCAL_LAYERS),
        "render_slice_fused": lambda: fn(image, depth, depth_px, p["fov"], p["beta"],
                                         p["gamma"], p["layers"], p["coc_scale"], p["fd_px"]),
        "render_scene_fused": lambda: fn(image, depth, depth_px, SLICE_PARAMS),
        "generate_scene": lambda: fn(image, depth, profile=tsim.DEVICE_PROFILES[0],
                                     rng=np.random.default_rng(0), pixel_vs_meter=3000.0),
    }[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_render_restores_the_tf32_flags(monkeypatch, rng):
    """On the card the render turns TF32 off for its own block only; on the
    CPU it leaves the flags alone."""
    image, depth, depth_px = scene_inputs(rng, 8, 8)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    seen = []
    conv2d = tsimulator.F.conv2d

    def watched(*args, **kw):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv2d(*args, **kw)

    monkeypatch.setattr(tsimulator.F, "conv2d", watched)
    with tsimulator._fp32_exact(torch.device("cuda")):
        inside = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    assert inside == (False, False) and torch.backends.cudnn.allow_tf32
    tsim.render_scene_fused(image, depth, depth_px, SLICE_PARAMS, device="cpu")
    assert seen == [True] * len(SLICE_PARAMS)  # one conv a slice
