"""Loader for simulator-generated scenes (the training data for the
end-to-end alignment model).

The port's copy of ``dffx/data/simulated.py``.  The simulator (``dffx.sim``,
rebuilding `Simulator/synthetic_blur_movement.py`) writes per-scene
directories::

    <root>/<idx>/img0.png ... img{N-1}.png   warped+defocused slices (RGB-as-BGR
                                             bytes, exactly like the reference)
    <root>/<idx>/depth.mat                   {"depth": final-warp depth,
                                              "defocus": (H, W, N) |CoC| px}
    <root>/<idx>/camera_param.mat            thin-lens camera constants

The reference ships no end-to-end train script (its smartphone recipe computes
FOVs but never uses them — `train_Dataloader.py:289-291`); this loader provides
the stack + GT + per-slice relative FOVs that ``make_train_step(e2e=True)``
consumes, with the same focus-distance schedule the simulator rendered
(uniform in inverse depth over [0.1, 0.9] m — `synthetic_blur_movement.py:184-186`).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from dffx_torch.data import augmentation as aug
from dffx_torch.data.native import require

_USER = "SimulatedScenesDataset (python -m dffx_torch.train.cli --recipe Simulated)"


class SimulatedScenesDataset:
    """NYU-v2 synthetic focal stacks with hand-shake motion (E2E training)."""

    def __init__(self, root: str, mode: str = "train", num_imgs: int = 10,
                 crop: int = 224, seed: int = 0,
                 min_focus_dist: float = 0.1, max_focus_dist: float = 0.9):
        self.root = root
        self.mode = mode
        self.num_imgs = num_imgs
        self.crop = crop
        self.rng = np.random.default_rng(seed)
        self.scenes = sorted(
            (d for d in os.listdir(root) if d.isdigit() and
             os.path.exists(os.path.join(root, d, "depth.mat"))),
            key=int,
        )
        # the simulator's focus schedule: uniform in inverse depth
        fd = 1.0 / np.linspace(1 / max_focus_dist, 1 / min_focus_dist, num_imgs)
        self.focus_dists_m = fd.astype(np.float32)
        self.focus_dists = (1.0 / fd).astype(np.float32)  # diopters, like E2E eval

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        cv2 = require("cv2", _USER)
        sio = require("scipy.io", _USER)

        path = os.path.join(self.root, self.scenes[idx])
        imgs = [
            cv2.imread(os.path.join(path, f"img{i}.png")).astype(np.float64)
            for i in range(self.num_imgs)
        ]
        stack = np.stack(imgs, axis=-1)  # (H, W, 3, N)
        mats = sio.loadmat(os.path.join(path, "depth.mat"))
        depth = np.asarray(mats["depth"], dtype=np.float32)
        cam = sio.loadmat(os.path.join(path, "camera_param.mat"))
        focal_px = float(np.squeeze(cam["focal_length"]))
        pixel_vs_meter = float(np.squeeze(cam["pixel_mm"]))
        focal_m = focal_px / pixel_vs_meter

        # relative per-slice FOV exactly like the real-scene loader
        # (`End_to_End/Test_dataloader.py:44-45`)
        rel_fov = 1.0 / focal_m - 1.0 / self.focus_dists_m
        rel_fov = (rel_fov / np.min(rel_fov)).astype(np.float32)

        if self.mode == "train":
            h, w = depth.shape
            y0 = int(self.rng.integers(0, max(h - self.crop, 0) + 1))
            x0 = int(self.rng.integers(0, max(w - self.crop, 0) + 1))
            stack = stack[y0 : y0 + self.crop, x0 : x0 + self.crop]
            depth = depth[y0 : y0 + self.crop, x0 : x0 + self.crop]
            s = aug.Seeds.draw(self.rng)
            stack = aug.image_augmentation(stack, s.contrast, s.brightness, s.gamma)
        else:
            stack = stack / 127.5 - 1.0

        mask = depth > 0.0
        fs = np.ascontiguousarray(stack.transpose(3, 0, 1, 2)).astype(np.float32)
        return {
            "fs": fs,
            "depth": depth.astype(np.float32),
            "focus_dists": self.focus_dists,
            "fovs": rel_fov,
            "mask": mask,
            "unpadded": depth.shape,
        }
