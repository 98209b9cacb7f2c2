"""Train-time augmentation — ONE module (the reference keeps two near-identical
copies; SURVEY.md §1), math matching `train_codes/augmentation.py` exactly.
The port's copy of ``dffx/data/augmentation.py``: ``Seeds.draw`` draws from the
generator in the same order, so a seed gives the same crops and flips in both
packages.

All functions operate on host numpy in the loaders' native layout:
``x`` is ``(H, W, C, N)`` (or ``(H, W, C)``), ``depth``/``conf`` are ``(H, W)``.
Random draws live in ``Seeds`` with the reference's exact distributions
(`train_Dataloader.py:140-141`): contrast U(0.4,1.6), brightness U(-0.1,0.1),
gamma U(0.5,2.0), flips U(0,1) > 0.5, rotation k ∈ {0..3}.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Seeds:
    contrast: float
    brightness: float
    gamma: float
    flip_x: float
    flip_y: float
    angle: int
    y_crop: int = 0
    x_crop: int = 0

    @staticmethod
    def draw(rng: np.random.Generator, crop_interval: Optional[Tuple[int, int]] = None) -> "Seeds":
        y_crop = x_crop = 0
        if crop_interval is not None:
            # random.randint(0, n-1) is inclusive on both ends
            y_crop = int(rng.integers(0, crop_interval[0]))
            x_crop = int(rng.integers(0, crop_interval[1]))
        return Seeds(
            contrast=float(rng.uniform(0.4, 1.6)),
            brightness=float(rng.uniform(-0.1, 0.1)),
            gamma=float(rng.uniform(0.5, 2.0)),
            flip_x=float(rng.uniform(0, 1.0)),
            flip_y=float(rng.uniform(0, 1.0)),
            angle=int(rng.integers(0, 4)),
            y_crop=y_crop,
            x_crop=x_crop,
        )


def image_augmentation(x: np.ndarray, contrast: float, brightness: float, gamma: float,
                       *, lut_dtype=np.float32) -> np.ndarray:
    """Photometric jitter: uint8-range input → [-1, 1] output (`augmentation.py:4-15`).

    A ``uint8`` input takes only 256 values, so the elementwise chain is
    precomputed as a LUT and applied as one gather — bit-identical to running
    the float chain on the cast array (same scalar ops per value), and it
    removes the ``np.power`` over every pixel that otherwise dominates
    host-side loader time.  ``lut_dtype`` selects which cast the caller used
    to take: float32 for the h5/jpg loaders, float64 where the reference's
    uint8→float64 numpy promotion is the parity contract (DefocusNet,
    FlyingThings).  Float inputs take the original path unchanged."""
    if x.dtype == np.uint8:
        return _photometric(np.arange(256, dtype=lut_dtype), contrast, brightness, gamma)[x]
    return _photometric(x, contrast, brightness, gamma)


def _photometric(x, contrast: float, brightness: float, gamma: float):
    x = x / 255.0
    x = (0.5 + contrast * (x - 0.5)) + brightness
    x = np.clip(x, 0.0, 1.0)
    x = np.power(x, gamma)
    x = np.clip(x, 0.0, 1.0)
    return x / 0.5 - 1.0


def horizontal_flip(x, depth, random_val):
    if random_val > 0.5:
        x = np.flip(x, 1).copy()
        depth = np.flip(depth, 1).copy()
    return x, depth


def vertical_flip(x, depth, random_val):
    if random_val > 0.5:
        x = np.flip(x, 0).copy()
        depth = np.flip(depth, 0).copy()
    return x, depth


def rotate(x, depth, degree):
    return np.rot90(x, degree, axes=(0, 1)).copy(), np.rot90(depth, degree, axes=(0, 1)).copy()


def randcrop_3d(x, depth, x_seed, y_seed, interval_x, interval_y):
    """Crop to (H - interval_y, W - interval_x) at offset (y_seed, x_seed)."""
    x = x[y_seed : y_seed - interval_y, x_seed : x_seed - interval_x]
    depth = depth[y_seed : y_seed - interval_y, x_seed : x_seed - interval_x]
    return x, depth


def apply_standard(x, depth, s: Seeds, *, crop_interval=None, lut_dtype=np.float32):
    """The shared train pipeline: [randcrop] + photometric + flips + rot90.

    For uint8 input the photometric LUT runs AFTER the flips/rot90 — a gather
    commutes bitwise with permutations, and flipping/rotating 1-byte pixels
    quarters the copy traffic that dominates host loader time."""
    if crop_interval is not None:
        x, depth = randcrop_3d(x, depth, s.x_crop, s.y_crop, crop_interval[1], crop_interval[0])
    u8 = x.dtype == np.uint8
    if not u8:
        x = image_augmentation(x, s.contrast, s.brightness, s.gamma)
    x, depth = horizontal_flip(x, depth, s.flip_x)
    x, depth = vertical_flip(x, depth, s.flip_y)
    x, depth = rotate(x, depth, s.angle)
    if u8:
        x = image_augmentation(x, s.contrast, s.brightness, s.gamma, lut_dtype=lut_dtype)
    return x, depth


def apply_with_conf(x, depth, conf, s: Seeds, *, crop_interval=None):
    """Smartphone variant: confidence map transported with the image/GT."""
    if crop_interval is not None:
        x = x[s.y_crop : s.y_crop - crop_interval[0], s.x_crop : s.x_crop - crop_interval[1]]
        depth = depth[s.y_crop : s.y_crop - crop_interval[0], s.x_crop : s.x_crop - crop_interval[1]]
        conf = conf[s.y_crop : s.y_crop - crop_interval[0], s.x_crop : s.x_crop - crop_interval[1]]
    u8 = x.dtype == np.uint8  # LUT after the permutations (bitwise-commuting)
    if not u8:
        x = image_augmentation(x, s.contrast, s.brightness, s.gamma)
    if s.flip_x > 0.5:
        x, depth, conf = np.flip(x, 1).copy(), np.flip(depth, 1).copy(), np.flip(conf, 1).copy()
    if s.flip_y > 0.5:
        x, depth, conf = np.flip(x, 0).copy(), np.flip(depth, 0).copy(), np.flip(conf, 0).copy()
    x = np.rot90(x, s.angle, axes=(0, 1)).copy()
    depth = np.rot90(depth, s.angle, axes=(0, 1)).copy()
    conf = np.rot90(conf, s.angle, axes=(0, 1)).copy()
    if u8:
        x = image_augmentation(x, s.contrast, s.brightness, s.gamma)
    return x, depth, conf


def ddff_apply(x, depth, s: Seeds):
    """DDFF variant: stack layout is (N, H, W, C) so spatial axes are 1/2
    (`train_Dataloader.py:14-28`)."""
    u8 = x.dtype == np.uint8  # LUT after the permutations (bitwise-commuting)
    if not u8:
        x = image_augmentation(x, s.contrast, s.brightness, s.gamma)
    if s.flip_x > 0.5:
        x, depth = np.flip(x, 2).copy(), np.flip(depth, 1).copy()
    if s.flip_y > 0.5:
        x, depth = np.flip(x, 1).copy(), np.flip(depth, 0).copy()
    x = np.rot90(x, s.angle, axes=(1, 2)).copy()
    depth = np.rot90(depth, s.angle, axes=(0, 1)).copy()
    if u8:
        x = image_augmentation(x, s.contrast, s.brightness, s.gamma)
    return x, depth
