"""Thin-lens defocus simulator: "in the wild" focal stacks (focus breathing
and hand shake) rendered from RGB-D images, on the card.

The port of ``dffx/sim/simulator.py`` (which rebuilds
`Simulator/synthetic_blur_movement.py`): the same optics (thin-lens
``lens_to_sensor = f*d/(d-f)``, per-device FOV-against-diopter error lines,
Gaussian translation jitter, disc circle-of-confusion PSFs, equal-CoC
depth-plane merging, binary compositing), the same random draws, files and
flags.  The host keeps the optics in numpy; the card renders a whole scene in
one batched program (``render_program``):

* both warps of every slice (image and depth in pixels together) through
  ``dffx_torch.ops.warp``'s interpolation matrices, the slices as one axis of
  the batch (``dffx`` maps its per-slice program over them with ``vmap``);
* each slice's disc blurs as one ``F.conv2d``: the colours are the batch,
  the slice's CoC layers the output channels (``dffx`` scans the layers with
  ``lax.scan`` inside the ``vmap``);
* ``torch.round`` and ``jnp.round`` both round half to even, and both
  convolutions are cross-correlations.

On the card the render runs with TF32 off for cuDNN's convolutions and for
matmuls (``_fp32_exact``): the warp multiplies depths of up to 7e4 pixels and
the discs weigh 1/area, so a 10-bit mantissa would move disparities by tens
of pixels and flip the uint8 rounding.  Entry points run on ``device="cuda"``
unless asked for the CPU, and raise without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dffx_torch.data.native import require
from dffx_torch.ops.warp import affine_warp_stack, warp_cf

USER = "python -m dffx_torch.sim.simulator"


# ---------------------------------------------------------------------------
# Device profiles (measured FOV-error lines + shake stats; `:121-168`)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    name: str
    native_width: int  # sensor pixel width the shake stats were measured at
    alpha_slope: float
    y_intercept: float
    beta_mean: float
    beta_var: float
    gamma_mean: float
    gamma_var: float
    focal_length: float  # meters
    f_num: float


DEVICE_PROFILES: Tuple[DeviceProfile, ...] = (
    DeviceProfile("pixel4_XL", 4032, -0.00266, 0.019155, -4.45515, 7.18485,
                  -9.9504701, 8.04556863, 0.0044, 1.7),
    DeviceProfile("pixel6", 4080, -0.00429249, 0.00330253, 0.470281, 6.2634662,
                  2.69174424, 6.859772247, 0.0068, 1.9),
    DeviceProfile("galaxy_S8+", 4032, -0.00203839, 0.0166955, 4.430173117,
                  4.60067699, 3.695449964, 3.589144555, 0.0043, 1.5),
    DeviceProfile("galaxy_note10", 4032, -0.00402384, 0.0247385, -4.315575939,
                  2.9198626, -0.9456601, 0.153538997, 0.0048, 1.7),
)


# ---------------------------------------------------------------------------
# Where the render runs
# ---------------------------------------------------------------------------


def sim_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card raises
    (the simulator does not carry on on the CPU unless asked)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA device is available; "
                           "pass device='cpu' (--device cpu) to render on the CPU")
    return dev


@contextlib.contextmanager
def _fp32_exact(dev: torch.device):
    """TF32 off for cuDNN's convolutions and for matmuls on the card for the
    block, then as before."""
    if dev.type != "cuda":
        yield
        return
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _f32(a, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32))).to(dev)


# ---------------------------------------------------------------------------
# Geometry: 2D scale-about-center + translate warp (separable matmuls)
# ---------------------------------------------------------------------------


def warp_2d(img: np.ndarray, fov: float, beta: float, gamma: float, *,
            device="cuda") -> np.ndarray:
    """The simulator's warp (`:15-71`): sampling offset
    ``flow_x = (W//2)*(fov-1)*linspace(-1,1,W) - beta`` (note the minus: the
    simulator's sign convention differs from the model's), bilinear
    align_corners=True with zeros padding.  Takes (H, W) or (H, W, C);
    returns float32 of the same shape."""
    dev = sim_device(device)
    squeeze = img.ndim == 2
    x = img[..., None] if squeeze else img
    motion = [torch.full((1, 1), v, dtype=torch.float32, device=dev)
              for v in (fov, -beta, -gamma)]
    with _fp32_exact(dev):
        out, _ = affine_warp_stack(_f32(x, dev)[None, None], *motion)
    out = out[0, 0].cpu().numpy()
    return out[..., 0] if squeeze else out


# ---------------------------------------------------------------------------
# Circle-of-confusion machinery
# ---------------------------------------------------------------------------


_DISC_CACHE = {}


def disc_kernel(blur_size: int) -> np.ndarray:
    """Normalized disc PSF, identical to ``create_blur`` (`:81-87`):
    cv2.circle(radius=blur_size//2, filled) on a blur_size^2 canvas.
    Memoized (a scene asks for ~30 distinct sizes hundreds of times) and
    frozen, since every caller shares it."""
    cached = _DISC_CACHE.get(blur_size)
    if cached is None:
        cv2 = require("cv2", f"disc_kernel ({USER})")
        canvas = np.zeros((blur_size, blur_size), dtype=np.float64)
        cv2.circle(canvas, (blur_size // 2, blur_size // 2), blur_size // 2,
                   (1, 1, 1), -1)
        kern = canvas / np.sum(canvas)
        kern.setflags(write=False)
        cached = _DISC_CACHE.setdefault(blur_size, kern)
    return cached


def coc_layers(
    coc_scale: float,
    focus_dist: float,
    min_scene_depth: float,
    max_scene_depth: float,
    num_planes: int,
) -> List[Tuple[int, float, float]]:
    """Merge ``num_planes`` uniform depth planes into runs of equal integer CoC
    (`:230-245`).  Returns [(coc_size, min_dis, max_dis)] with the last run's
    max extended by 0.1 (the reference's last-iteration fudge)."""
    out: List[Tuple[int, float, float]] = []
    span = max_scene_depth - min_scene_depth
    for k in range(num_planes):
        min_dis = k / num_planes * span + min_scene_depth
        max_dis = (k + 1) / num_planes * span + min_scene_depth
        sub_dis = min_dis + (max_dis - min_dis) / 2
        # python round() on a numpy double = round-half-to-even
        coc_size = int(np.rint(coc_scale * (sub_dis - focus_dist) / sub_dis))
        if k > 0 and max_dis == max_scene_depth:
            max_dis += 0.1
        if out and out[-1][0] == coc_size:
            out[-1] = (out[-1][0], out[-1][1], max_dis)
        else:
            out.append((coc_size, min_dis, max_dis))
    return out


def _bucket(n: int) -> int:
    """Round up to a small set of sizes, so that few distinct shapes reach
    the convolution (and cuDNN's plan cache stays small)."""
    for b in (1, 2, 4, 8, 16, 32, 64, 128):
        if n <= b:
            return b
    return n


def _bucket_odd(n: int) -> int:
    """Kernel-size bucket: must stay odd so 'same' padding is symmetric."""
    for b in (1, 3, 5, 9, 17, 33, 65, 129):
        if n <= b:
            return b
    return n if n % 2 else n + 1


def _ksize(coc: int) -> int:
    return 2 * abs(coc if coc != 0 else 1) + 1


def _reflect_index(n: int, p: int, dev: torch.device) -> torch.Tensor:
    """Source index of each of ``n + 2p`` padded positions under numpy's
    ``mode="reflect"`` (edge not repeated), which reflects again where the
    pad reaches the size: the period-``2(n-1)`` triangle wave.  A pad at or
    above ``n`` is legal here, where ``F.pad(mode="reflect")`` raises."""
    i = torch.arange(-p, n + p, device=dev)
    if n == 1:
        return torch.zeros_like(i)
    m = torch.remainder(i, 2 * (n - 1))
    return torch.where(m >= n, 2 * (n - 1) - m, m)


def _reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Reflect-pad the two trailing axes of ``x`` by ``p`` (REFLECT_101,
    cv2.filter2D's default border), numpy's semantics at any ``p``."""
    h, w = x.shape[-2:]
    x = x.index_select(-2, _reflect_index(h, p, x.device))
    return x.index_select(-1, _reflect_index(w, p, x.device))


def _layer_operands(layers_per_slice: Sequence[Sequence[Tuple[int, float, float]]]):
    """Zero-padded disc kernels ``(S, L, kmax, kmax)`` and layer bounds
    ``(S, L, 2)`` (float32), kernel size and layer count bucketed over all
    slices; padding rows have zero kernels and ``[inf, inf)`` bounds and
    contribute nothing."""
    all_ksizes = [[_ksize(k) for k, _, _ in layers] for layers in layers_per_slice]
    kmax = _bucket_odd(max(max(ks) for ks in all_ksizes))
    n_layers = _bucket(max(len(layers) for layers in layers_per_slice))
    s = len(layers_per_slice)
    kernels = np.zeros((s, n_layers, kmax, kmax), dtype=np.float32)
    bounds = np.full((s, n_layers, 2), np.inf, dtype=np.float32)
    for j, (layers, ksizes) in enumerate(zip(layers_per_slice, all_ksizes)):
        for i, ((_, lo, hi), ks) in enumerate(zip(layers, ksizes)):
            pad = (kmax - ks) // 2
            kernels[j, i, pad : pad + ks, pad : pad + ks] = disc_kernel(ks)
            bounds[j, i] = (lo, hi)
    return kernels, bounds


# ---------------------------------------------------------------------------
# The render program
# ---------------------------------------------------------------------------


def _blur_layers(wimg: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Every slice's layered disc blur, rounded and saturated as
    cv2.filter2D does on uint8: wimg (3, S, H, W), kernels (S, L, k, k) ->
    (3, S, L, H, W).  One convolution a slice, 1 -> L channels with the
    colours as the batch (cuDNN's).  One grouped convolution (the slices as
    groups) computes the same bits, but PyTorch sends it to its own fp32
    depthwise kernel, which took 1.8x as long on an H100 (``PERF.md``)."""
    k = kernels.shape[-1]
    padded = _reflect_pad(wimg, k // 2)
    blur = torch.stack([F.conv2d(padded[:, j:j + 1], kernels[j][:, None])
                        for j in range(kernels.shape[0])], dim=1)
    return torch.clamp(torch.round(blur), 0.0, 255.0)


def render_program(image, depth, depth_px, fovs, betas, gammas, kernels, bounds,
                   cocs, fd_px):
    """A whole scene's render on one device (``dffx``'s
    ``_slice_program_impl`` batched over slices): warp image and depth
    together, thin-lens disparity from the warped depth, per-layer disc blur
    of the truncated warped image, and the composite masked by the *unwarped*
    metric depth (the reference's own mismatch).

    image (H, W, 3) float 0..255; depth (H, W) metres (mask source,
    unwarped); depth_px (H, W) pixels; fovs, betas, gammas, cocs, fd_px (S,);
    kernels (S, L, k, k) zero-padded discs; bounds (S, L, 2).  All float32
    tensors.  Returns (composited (S, H, W, 3) float, disparity (S, H, W))."""
    s = kernels.shape[0]
    h, w, _ = image.shape
    # (1, C=4, N=S, H, W): the image and the depth in pixels, one copy a slice
    stack = torch.cat([image.permute(2, 0, 1), depth_px[None]])[None, :, None]
    warped, _, _ = warp_cf(stack.expand(1, 4, s, h, w), fovs[None], -betas[None],
                           -gammas[None])
    wimg = torch.floor(torch.clamp(warped[0, :3], 0.0, 255.0))  # (3, S, H, W): uint8 truncation
    wdepth_px = warped[0, 3]
    disparity = torch.abs(cocs[:, None, None] * (wdepth_px - fd_px[:, None, None]) / wdepth_px)

    blur = _blur_layers(wimg, kernels)  # (3, S, L, H, W)
    lo, hi = bounds[..., 0, None, None], bounds[..., 1, None, None]  # (S, L, 1, 1)
    mask = (depth >= lo) & (depth < hi)  # (S, L, H, W), disjoint over L
    out = (blur * mask).sum(dim=2)  # (3, S, H, W)
    return out.permute(1, 2, 3, 0), disparity


def scene_operands(image, depth, depth_px, slice_params, device):
    """``render_program``'s operands on ``device`` from host arrays and the
    per-slice dicts of ``render_scene_fused``."""
    dev = sim_device(device)
    kernels, bounds = _layer_operands([p["layers"] for p in slice_params])
    per_slice = [_f32([p[key] for p in slice_params], dev)
                 for key in ("fov", "beta", "gamma")]
    return (_f32(image, dev), _f32(depth, dev), _f32(depth_px, dev), *per_slice,
            _f32(kernels, dev), _f32(bounds, dev),
            _f32([p["coc_scale"] for p in slice_params], dev),
            _f32([p["fd_px"] for p in slice_params], dev))


def render_scene_fused(image, depth, depth_px, slice_params, *, device="cuda"):
    """Render every slice of a scene in one program.

    ``slice_params`` is a list of dicts with keys ``fov, beta, gamma, layers,
    coc_scale, fd_px`` (one per slice).  Kernel-size and layer-count buckets
    are taken over the whole scene.  Returns ``(imgs_u8 (S, H, W, 3) BGR,
    disparity (S, H, W) float32)``, equal to per-slice ``render_slice_fused``
    calls up to fp32 accumulation order."""
    operands = scene_operands(image, depth, depth_px, slice_params, device)
    with _fp32_exact(operands[0].device):
        out, disparity = render_program(*operands)
    return out.cpu().numpy().astype(np.uint8), disparity.cpu().numpy()


def render_slice_fused(image, depth, depth_px, fov, beta, gamma, layers,
                       coc_scale, fd_px, *, device="cuda"):
    """One slice: ``render_scene_fused`` of a one-slice scene, with that
    slice's own buckets.  Returns ``(img_u8 (H, W, 3), disparity (H, W))``."""
    imgs, disparity = render_scene_fused(
        image, depth, depth_px,
        [dict(fov=fov, beta=beta, gamma=gamma, layers=layers, coc_scale=coc_scale,
              fd_px=fd_px)], device=device)
    return imgs[0], disparity[0]


def render_focal_slice(
    image: np.ndarray,
    depth: np.ndarray,
    layers: Sequence[Tuple[int, float, float]],
    *,
    device="cuda",
) -> np.ndarray:
    """Depth-layered disc blur + back-to-front binary composite (`:250-270`),
    as one convolution: all K disc PSFs (padded to a common size) are the
    output channels of a single conv over the image.

    ``image`` is float (0..255 uint8 range), ``depth`` the *unwarped* depth the
    masks are computed from, in float64 as the reference compares it.
    Returns uint8 (H, W, 3) in the image's own channel order."""
    dev = sim_device(device)
    kernels, _ = _layer_operands([layers])
    k = kernels.shape[-1]
    # the reference blurs `image.astype(np.uint8)` (truncation): match it
    x = _f32(image.astype(np.uint8).transpose(2, 0, 1)[:, None], dev)  # (3, 1, H, W)
    with _fp32_exact(dev):
        blurred = F.conv2d(_reflect_pad(x, k // 2), _f32(kernels[0][:, None], dev))
    # cv2.filter2D on uint8 saturates and rounds each layer before compositing
    blurred = torch.clamp(torch.round(blurred), 0.0, 255.0).to(torch.uint8)  # (3, K, H, W)
    d = torch.from_numpy(np.asarray(depth, dtype=np.float64)).to(dev)
    out = torch.zeros((3,) + tuple(d.shape), dtype=torch.uint8, device=dev)
    for i, (_, min_dis, max_dis) in enumerate(layers):
        out = torch.where((d >= min_dis) & (d < max_dis), blurred[:, i], out)
    return out.permute(1, 2, 0).cpu().numpy()


# ---------------------------------------------------------------------------
# Scene generation
# ---------------------------------------------------------------------------


def plan_scene(
    depth: np.ndarray,
    *,
    profile: DeviceProfile,
    rng: np.random.Generator,
    pixel_vs_meter: float,
    num_imgs: int = 10,
    num_planes: int = 2000,
    min_focus_dist: float = 0.1,
    max_focus_dist: float = 0.9,
):
    """``generate_scene``'s host prepass (`:171-245`): per-slice motion and CoC
    layers in the reference's exact draw order (`:186-200`; two draws from
    ``rng`` a slice after the first, whose warp is the identity).  Returns
    ``(slice_params, camera_setting, focus_dists)``, ``slice_params`` as
    ``render_scene_fused`` takes them."""
    size_ratio = depth.shape[1] / profile.native_width
    focal_length = profile.focal_length * pixel_vs_meter
    lens_dia = focal_length / profile.f_num
    max_scene_depth = float(np.max(depth))
    min_scene_depth = float(np.min(depth))

    focus_dists = 1.0 / np.linspace(1 / max_focus_dist, 1 / min_focus_dist, num_imgs)
    min_fd_px = min_focus_dist * pixel_vs_meter
    max_fd_px = max_focus_dist * pixel_vs_meter
    min_afov = 1 / (focal_length * min_fd_px / (min_fd_px - focal_length))
    max_afov = 1 / (focal_length * max_fd_px / (max_fd_px - focal_length))
    origin_max_afov = (
        max_afov / min_afov + profile.alpha_slope * (1 / max_scene_depth) + profile.y_intercept
    )
    camera_setting = {
        "focal_length": focal_length,
        "aperture_size": lens_dia,
        "pixel_mm": pixel_vs_meter,
        "max_focus_dist": max_scene_depth,
        "min_focus_dist": min_scene_depth,
    }

    slice_params = []
    for num in range(num_imgs):
        focus_dist = focus_dists[num]
        fd_px = pixel_vs_meter * focus_dist
        lens_to_sensor = focal_length * fd_px / (fd_px - focal_length)
        if num != 0:
            alpha = profile.alpha_slope * (1 / focus_dist) + profile.y_intercept
            origin_fov = (1 / lens_to_sensor) / min_afov + alpha
            fov = origin_max_afov / origin_fov
            beta = rng.normal(profile.beta_mean, profile.beta_var) * size_ratio
            gamma = rng.normal(profile.gamma_mean, profile.gamma_var) * size_ratio
        else:
            fov, beta, gamma = 1.0, 0.0, 0.0  # identity warp, exact

        coc_scale = lens_to_sensor * lens_dia / fd_px
        layers = coc_layers(coc_scale, focus_dist, min_scene_depth, max_scene_depth, num_planes)
        slice_params.append(dict(fov=fov, beta=beta, gamma=gamma, layers=layers,
                                 coc_scale=coc_scale, fd_px=fd_px))

    return slice_params, camera_setting, focus_dists


def generate_scene(
    image: np.ndarray,
    depth: np.ndarray,
    *,
    profile: DeviceProfile,
    rng: np.random.Generator,
    pixel_vs_meter: float,
    num_imgs: int = 10,
    num_planes: int = 2000,
    min_focus_dist: float = 0.1,
    max_focus_dist: float = 0.9,
    device="cuda",
):
    """Render one scene's focal stack (`:171-277`) on ``device``.

    Args:
      image: (H, W, 3) float in 0..255, BGR (cv2 order, like the reference).
      depth: (H, W) float64 depth in meters (already ranged, e.g. [0.1, 1.1]).

    Returns dict with ``imgs`` (N x uint8 RGB), ``depth`` (final-slice-warped
    original depth), ``disparity`` (H, W, N absolute pixel CoC: the
    reference's quirk of storing per-slice |CoC| as "defocus"),
    ``camera_setting`` and ``focus_dists``.  The random draws are ``rng``'s,
    in the reference's order; torch draws nothing.
    """
    dev = sim_device(device)
    slice_params, camera_setting, focus_dists = plan_scene(
        depth, profile=profile, rng=rng, pixel_vs_meter=pixel_vs_meter, num_imgs=num_imgs,
        num_planes=num_planes, min_focus_dist=min_focus_dist, max_focus_dist=max_focus_dist)
    last = slice_params[-1]
    depth_pixel = depth * pixel_vs_meter
    stack_u8, disp_s = render_scene_fused(image, depth, depth_pixel, slice_params, device=dev)
    imgs = [stack_u8[num, :, :, ::-1] for num in range(num_imgs)]  # BGR -> RGB (`:265`)
    disparity = disp_s.transpose(1, 2, 0).astype(np.float64)

    # "assume last one has smallest FOV" (`:272`)
    origin_depth = (
        warp_2d(depth.astype(np.float32), last["fov"], last["beta"], last["gamma"], device=dev)
        if num_imgs > 1 else depth
    )
    return {
        "imgs": imgs,
        "depth": np.asarray(origin_depth),
        "disparity": disparity,
        "camera_setting": camera_setting,
        "focus_dists": focus_dists,
    }


def load_nyu_v2(path: str):
    """NYU-v2 labeled .mat (v7.3 HDF5) via h5py; images (H, W, 3, B) uint8 and
    depths (H, W, B) like mat73 returned them, with 16px borders cropped."""
    h5py = require("h5py", f"load_nyu_v2 ({USER} --nyu-mat)")
    with h5py.File(path, "r") as f:
        # v7.3 stores transposed: images (B, 3, W, H), depths (B, W, H)
        images = np.asarray(f["images"]).transpose(3, 2, 1, 0)
        depths = np.asarray(f["depths"]).transpose(2, 1, 0).astype(np.float64)
    return images[16:-16, 16:-16], depths[16:-16, 16:-16]


def main(argv=None):
    parser = argparse.ArgumentParser(description="Synthetic dataset with scene movements")
    parser.add_argument("--dataset", default="NYU_move_out_0_1/", type=str)
    parser.add_argument("--nyu-mat", default="nyu_depth_v2_labeled.mat", type=str)
    parser.add_argument("--focal_length", default=0.028, type=float)
    parser.add_argument("--F_num", default=2.0, type=float)
    parser.add_argument("--pixel_vs_meter", default=1 / 0.0000014 * 352 / 4080, type=float)
    parser.add_argument("--num_imgs", default=10, type=int)
    parser.add_argument("--num_planes", default=2000, type=int)
    parser.add_argument("--max_depth", default=1.0, type=float)
    parser.add_argument("--min_depth", default=0.1, type=float)
    parser.add_argument("--limit", default=None, type=int, help="scene cap (debug)")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the scenes render; 'cpu' only when asked")
    args = parser.parse_args(argv)

    from dffx_torch.eval.common import cli_device

    device = cli_device(args.device)
    cv2 = require("cv2", USER)
    sio = require("scipy.io", USER)
    height, width = 224, 352
    images, depths = load_nyu_v2(args.nyu_mat)
    n_scenes = images.shape[3] if args.limit is None else min(args.limit, images.shape[3])
    rng = np.random.default_rng(args.seed)
    start = time.time()

    def write_scene(save_path, img_idx, out):
        # host-side PNG encode + .mat writes, overlapped with the next scene's
        # render (cv2.imwrite releases the GIL while encoding)
        for num, img in enumerate(out["imgs"]):
            cv2.imwrite(save_path + f"img{num}.png", img)
        if np.min(out["depth"]) == 0:
            print(f"[dffx_torch.sim] scene {img_idx}: warped depth hit zero — kept anyway "
                  "(the reference aborted here)")
        sio.savemat(save_path + "depth.mat", {"depth": out["depth"], "defocus": out["disparity"]})
        sio.savemat(save_path + "camera_param.mat", out["camera_setting"])

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=2) as pool:
        pending = []
        for img_idx in range(n_scenes):
            profile = DEVICE_PROFILES[int(rng.integers(0, len(DEVICE_PROFILES)))]
            save_path = os.path.join(args.dataset, str(img_idx)) + "/"
            os.makedirs(save_path, exist_ok=True)

            depth = cv2.resize(depths[:, :, img_idx], (width, height))
            depth = args.max_depth * (depth - depth.min()) / (depth.max() - depth.min())
            depth = depth + args.min_depth
            image = cv2.resize(images[:, :, :, img_idx].astype(np.float32), (width, height))
            image = image[:, :, ::-1]  # RGB -> BGR, the reference pipeline's cv2 order

            out = generate_scene(
                image,
                depth,
                profile=profile,
                rng=rng,
                pixel_vs_meter=args.pixel_vs_meter,
                num_imgs=args.num_imgs,
                num_planes=args.num_planes,
                device=device,
            )
            pending.append(pool.submit(write_scene, save_path, img_idx, out))
            while len(pending) > 4:  # bound memory; surface write errors early
                pending.pop(0).result()
        for f in pending:
            f.result()

    n = max(n_scenes, 1)
    print("avg_time: ", (time.time() - start) / n)


if __name__ == "__main__":
    main()
