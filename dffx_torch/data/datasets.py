"""Dataset readers for every dataset family the reference supports
(SURVEY.md §2.2), with byte-matching preprocessing (BGR channel order from cv2
is deliberately kept, normalization ``x/127.5 - 1``, pad-to-x32 with -1,
per-dataset clamp/mask rules and focus-distance tables).

The port's copy of ``dffx/data/datasets.py``: the same readers, draws and
sample dicts (a seed gives the same crops and flips in both packages), with
every decode and normalisation through the port's host library
(``dffx_torch.data.native``), which leaves some files to ``cv2``.

Layout contract (``dffx``'s, vs the reference's ``(3, N, H, W)``):

* ``fs``          ``(N, H, W, 3)`` float32, padded to multiples of 32
* ``focus_dists`` ``(N,)`` float32 (the reference tiles this to (N,H,W) —
                  pure broadcast waste we drop)
* ``depth``       ``(H0, W0)`` float32 ground truth, unpadded
* ``mask``        ``(H0, W0)`` bool
* ``conf``        optional confidence map, ``fovs`` optional per-slice FOV
* ``unpadded``    (H0, W0) of the prediction crop

Everything is host-side numpy; the card never sees a file format.  ``h5py``
and ``cv2`` are imported by the reader that needs them, when it is built or
reads (``native.require``); ``cv2`` only for the files the host library
leaves to it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from dffx_torch.data import augmentation as aug
from dffx_torch.data import exr, native

#: the command lines that run each reader, named where a package is missing
_EVAL = "python -m dffx_torch.eval.test --dataset"
_TRAIN = "python -m dffx_torch.train.cli --recipe"


def _pad32(fs: np.ndarray, value: float = -1.0) -> np.ndarray:
    """Pad (N, H, W, 3) on the bottom/right to multiples of 32."""
    _, h, w, _ = fs.shape
    ph = (32 - h % 32) % 32
    pw = (32 - w % 32) % 32
    if ph or pw:
        fs = np.pad(fs, ((0, 0), (0, ph), (0, pw), (0, 0)), constant_values=value)
    return fs


def _read_depth_any(path: str, user: str) -> np.ndarray:
    if path.endswith(".exr"):
        return exr.read_depth(path)
    return np.asarray(native.imread_unchanged_compat(path, user), dtype=np.float32)


def _hwcn_to_nhwc(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.transpose(3, 0, 1, 2)).astype(np.float32)


class DefocusNetDataset:
    """DefocusNet 5-slice stacks ("fs_6"): ``*All.tif`` + ``*Dpt.exr``
    (`test_Dataloader.py:13-54`, `train_Dataloader.py:81-141`)."""

    FOCUS_DISTS = np.array([0.1, 0.15, 0.3, 0.7, 1.5], dtype=np.float32)
    USER = f"DefocusNetDataset ({_EVAL} DefocusNet or FlyingThings3D, {_TRAIN} Defocus)"

    def __init__(self, root: str = "Datasets/fs_6/", mode: str = "test", seed: int = 0):
        self.root = os.path.join(root, mode) + "/"
        self.mode = mode
        files = sorted(os.listdir(self.root))
        self.imglist_all = [f for f in files if f.endswith("All.tif")]
        self.imglist_dpt = [f for f in files if f.endswith("Dpt.exr")]
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.imglist_dpt)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        # the reference clamps while the depth is still float16
        # (`test_Dataloader.py:37-38,52`); keep that dtype through the clamps
        depth = exr.read(self.root + self.imglist_dpt[index])["R"]
        # uint8 through the aug; the float64 LUT reproduces the reference's
        # uint8→float64 numpy-promotion chain bit-for-bit
        imgs = [
            native.imread_compat(self.root + self.imglist_all[index * 5 + i], self.USER)
            for i in range(5)
        ]
        stack = np.stack(imgs, axis=-1)  # (H, W, 3, N) BGR uint8

        if self.mode == "train":
            s = aug.Seeds.draw(self.rng)
            stack, depth = aug.apply_standard(stack, depth, s, lut_dtype=np.float64)
            depth = depth.copy()
            depth[depth < 0.0] = 0.0
            depth[depth > 2.0] = 0.0
        else:
            stack = stack / 127.5 - 1.0
            depth = depth.copy()
            depth[depth < 0.1] = 0.0
            depth[depth > 1.5] = 0.0

        mask = depth != 0.0
        return {
            "fs": _hwcn_to_nhwc(stack),
            "depth": depth.astype(np.float32),
            "focus_dists": self.FOCUS_DISTS,
            "mask": mask,
            "unpadded": depth.shape,
        }


class HCIDataset:
    """4D Light Field benchmark h5 (`test_Dataloader.py:55-91`,
    `train_Dataloader.py:216-268`)."""

    def __init__(
        self,
        h5_path: str = "Datasets/HCI/HCI_FS_trainval.h5",
        split: str = "val",
        seed: int = 0,
    ):
        h5py = native.require("h5py", f"HCIDataset ({_EVAL} 4D_Light_Field, {_TRAIN} HCI)")
        self.hdf5 = h5py.File(h5_path, "r")
        self.split = split
        self.stack_key = f"stack_{split}"
        self.disp_key = f"disp_{split}"
        fd = np.squeeze(np.asarray(self.hdf5["focus_position_disp"]), axis=0)
        self.focus_dists = fd.astype(np.float32)
        self.min_dist = float(np.min(fd))
        self.max_dist = float(np.max(fd))
        self.rng = np.random.default_rng(seed)
        self.crop = 256  # train random-crop size

    def __len__(self):
        return self.hdf5[self.stack_key].shape[0]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        # uint8 into the augmentation → LUT fast path (bit-identical, no pow)
        fs = np.asarray(self.hdf5[self.stack_key][idx])  # (N,H,W,3) uint8
        gt = np.asarray(self.hdf5[self.disp_key][idx], dtype=np.float32)
        stack = fs.transpose(1, 2, 3, 0)  # (H, W, 3, N)

        if self.split == "train":
            h, w = gt.shape
            interval = (h - self.crop, w - self.crop)
            s = aug.Seeds.draw(self.rng, crop_interval=interval)
            stack, gt = aug.apply_standard(stack, gt, s, crop_interval=interval)
        else:
            stack = stack.astype(np.float32) / 127.5 - 1.0
            gt = gt.copy()
            gt[gt < self.min_dist] = -3.0
            gt[gt > self.max_dist] = -3.0

        mask = gt != -3.0
        return {
            "fs": _hwcn_to_nhwc(stack),
            "depth": gt.astype(np.float32),
            "focus_dists": self.focus_dists,
            "mask": mask,
            "unpadded": gt.shape,
        }


def ddff_focus_dists() -> np.ndarray:
    """The DDFF-12 camera model constants (`test_Dataloader.py:105-109`)."""
    focal_length = 521.4052
    k2 = 1982.0250823695178
    flens = 7317.020641763665
    baseline = k2 / flens * 1e-3
    return np.linspace(
        baseline * focal_length / 0.5, baseline * focal_length / 7, num=10
    ).astype(np.float32)


class DDFFBenchmark:
    """DDFF-12-Scene test h5 — 120 stacks, no GT (benchmark submission)
    (`test_Dataloader.py:93-147`)."""

    HEIGHT, WIDTH = 383, 552

    def __init__(self, h5_path: str = "Datasets/DDFF/ddff-dataset-test.h5"):
        h5py = native.require("h5py", f"DDFFBenchmark ({_EVAL} DDFF)")
        self.hdf5 = h5py.File(h5_path, "r")
        self.focus_dists = ddff_focus_dists()

    def __len__(self):
        return self.hdf5["stack_test"].shape[0]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        raw = np.asarray(self.hdf5["stack_test"][idx])  # (N, H, W, 3)
        if raw.dtype == np.uint8:
            fs = native.normalize_pad_stack(raw)
        else:
            fs = _pad32(np.asarray(raw, np.float32) / 127.5 - 1.0)
        h, w = self.hdf5["stack_test"].shape[2:4]
        return {
            "fs": fs.astype(np.float32),
            "focus_dists": self.focus_dists,
            "unpadded": (h, w),
        }


class DDFFTrainval:
    """DDFF trainval h5 reader; GT and focus_dists normalized to [0, 1] over the
    disparity range (`train_Dataloader.py:31-80`).

    Train samples are random-cropped to ``crop`` AFTER augmentation.  The
    reference omits this crop but clearly intended it (the dead
    ``H,W=(224,224)`` line, `train_Dataloader.py:73`): its rot90 augmentation
    swaps H/W per sample, so `train_code_DDFF.py:69`'s batch-4 DataLoader
    crashes in collate on any real (non-square) stack mix — a reference bug,
    fixed here the way every other reference recipe already works (HCI crops
    256^2, Smartphone/FlyingThings crop in-loader).  A fixed crop also gives
    XLA one static train shape instead of two orientations.  ``crop=None``
    restores the reference's literal full-frame behaviour (batch 1 only).
    The crop must be square: rot90 swaps H/W per sample, so a non-square
    window cannot produce a static batchable shape either way.

    The ``val`` split pads ``fs`` to multiples of 32 with -1 (``unpadded`` is
    the ground truth's shape), which ``dffx``'s copy does not: the network
    takes multiples of 32 only, so without the pad the DDFF recipe's
    validation fails on the real 383x552 stacks in both packages.
    """

    def __init__(
        self,
        h5_path: str = "Datasets/DDFF/ddff-dataset-trainval.h5",
        split: str = "train",
        seed: int = 0,
        crop: Optional[Tuple[int, int]] = (224, 224),
    ):
        h5py = native.require("h5py", f"DDFFTrainval ({_TRAIN} DDFF)")
        self.hdf5 = h5py.File(h5_path, "r")
        self.split = split
        self.stack_key = f"stack_{split}"
        self.disp_key = f"disp_{split}"
        fd = ddff_focus_dists()
        self.min_dist = float(fd.min())
        self.max_dist = float(fd.max())
        self.focus_dists = (fd - self.min_dist) / (self.max_dist - self.min_dist)
        if crop is not None and crop[0] != crop[1]:
            raise ValueError(
                f"crop must be square (rot90 swaps H/W per sample), got {crop}"
            )
        self.crop = crop
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.hdf5[self.stack_key].shape[0]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        # kept uint8 into the augmentation: image_augmentation's LUT fast path
        # is bit-identical to the float32 chain and skips the per-pixel pow
        fs = np.asarray(self.hdf5[self.stack_key][idx])  # (N,H,W,3) uint8
        gt = np.asarray(self.hdf5[self.disp_key][idx], dtype=np.float32)
        if gt.ndim == 3:
            gt = gt[..., 0] if gt.shape[-1] == 1 else gt[0]
        if self.split == "train":
            s = aug.Seeds.draw(self.rng)
            if self.crop is not None:
                # a square crop commutes with the flips/rot90 (uniform offset
                # in either orientation ⇒ the same output distribution), so
                # crop the uint8 first and run the whole aug on 224^2 instead
                # of 383x552 — the flip/rot copies shrink ~6x
                fs, gt = self._rand_crop(fs, gt)
            fs, gt = aug.ddff_apply(fs, gt, s)
        else:
            # padded to x32 with -1 as DDFFBenchmark pads: the network takes
            # multiples of 32 and the real 383x552 stacks are none
            fs = _pad32(fs.astype(np.float32) / 127.5 - 1.0)
        mask = gt != 0.0
        gt = (gt - self.min_dist) / (self.max_dist - self.min_dist)
        return {
            "fs": np.ascontiguousarray(fs, dtype=np.float32),
            "depth": gt.astype(np.float32),
            "focus_dists": self.focus_dists.astype(np.float32),
            "mask": mask,
            "unpadded": gt.shape,
        }

    def _rand_crop(self, fs, gt):
        ch, cw = self.crop
        h, w = gt.shape
        y = int(self.rng.integers(0, h - ch + 1))
        x = int(self.rng.integers(0, w - cw + 1))
        return fs[:, y : y + ch, x : x + cw], gt[y : y + ch, x : x + cw]


# Google "Learning to Autofocus" focus-distance table in mm
# (`test_Dataloader.py:158-160`).
SMARTPHONE_FOCUS_TABLE_MM = [
    3910.92, 2289.27, 1508.71, 1185.83, 935.91, 801.09, 700.37, 605.39, 546.23,
    486.87, 447.99, 407.40, 379.91, 350.41, 329.95, 307.54, 291.72, 274.13,
    261.53, 247.35, 237.08, 225.41, 216.88, 207.10, 198.18, 191.60, 183.96,
    178.29, 171.69, 165.57, 160.99, 155.61, 150.59, 146.81, 142.35, 138.98,
    134.99, 131.23, 127.69, 124.99, 121.77, 118.73, 116.40, 113.63, 110.99,
    108.47, 106.54, 104.23, 102.01,
]


class SmartphoneDataset:
    """Google smartphone autofocus dataset: 49-slice sweep subsampled to
    ``num_imgs``; GT from merged depth PNG, confidence from EXR
    (`test_Dataloader.py:148-229`, `train_Dataloader.py:269-379`)."""

    MAX_DEPTH = 1 / 0.10201  # diopters
    MIN_DEPTH = 1 / 3.91092
    CENTER_CROP = (336, 252)
    RAND_CROP = (224, 224)
    MARGINS = (84, 63)
    USER = f"SmartphoneDataset ({_EVAL} Smartphone, {_TRAIN} Smartphone)"

    def __init__(self, root: str = "Datasets/Real_data_DP/", mode: str = "test",
                 num_imgs: int = 10, seed: int = 0):
        self.root = root
        self.mode = mode
        self.num_imgs = num_imgs
        self.indexes = np.rint(np.linspace(0, 48, num_imgs, endpoint=True)).astype(int)
        fd_m = np.asarray([SMARTPHONE_FOCUS_TABLE_MM[i] for i in self.indexes]) * 0.001
        self.focus_dists_m = fd_m.astype(np.float32)  # meters
        self.focus_dists = (1.0 / fd_m).astype(np.float32)  # diopters (model input)
        fovs = (1 / 0.00444) - (1 / fd_m)
        self.fovs = (fovs / np.min(fovs)).astype(np.float32)
        self.rng = np.random.default_rng(seed)

        self.depths: List[str] = []
        self.confids: List[str] = []
        self.stacks: List[List[str]] = []
        shards = [f"train{i}" for i in range(1, 8)] if mode == "train" else ["test"]
        for shard in shards:
            path = os.path.join(root, shard) + "/"
            for scene in sorted(os.listdir(path + "scaled_images/")):
                self.depths.append(
                    path + "merged_depth/" + scene + "/result_merged_depth_center.png"
                )
                self.confids.append(
                    path + "merged_conf/" + scene + "/result_merged_conf_center.exr"
                )
                self.stacks.append(
                    [
                        path + f"scaled_images/{scene}/{j}/result_scaled_image_center.jpg"
                        for j in self.indexes
                    ]
                )

    def __len__(self):
        return len(self.depths)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        my, mx = self.MARGINS
        # uint8 into the augmentation → LUT fast path (bit-identical, no pow)
        imgs = [native.imread_compat(p, self.USER)[my:-my, mx:-mx] for p in self.stacks[idx]]
        stack = np.stack(imgs, axis=-1)  # (H,W,3,N) uint8

        gt = native.imread_unchanged_compat(self.depths[idx], self.USER).astype(np.float32)[
            my:-my, mx:-mx
        ]
        gt = gt / 255.0
        gt = 20.0 / (100.0 - (100.0 - 0.2) * gt)
        gt = 1.0 / gt
        conf = exr.read(self.confids[idx])["R"][my:-my, mx:-mx].astype(np.float32)
        conf = np.minimum(conf, 1.0)

        if self.mode == "train":
            cc, rc = self.CENTER_CROP, self.RAND_CROP
            interval = (cc[0] - rc[0], cc[1] - rc[1])
            s = aug.Seeds.draw(self.rng, crop_interval=interval)
            stack, gt, conf = aug.apply_with_conf(stack, gt, conf, s, crop_interval=interval)
            pad_value = 0.0  # reference train pads with zeros (train_Dataloader.py:373)
        else:
            stack = stack.astype(np.float32) / 127.5 - 1.0
            pad_value = -1.0
        gt = gt.copy()
        gt[gt < self.MIN_DEPTH] = 0.0
        gt[gt > self.MAX_DEPTH] = 0.0
        mask = gt != 0.0

        fs = _pad32(_hwcn_to_nhwc(stack), value=pad_value)
        return {
            "fs": fs,
            "depth": gt.astype(np.float32),
            "focus_dists": self.focus_dists,
            "mask": mask,
            "conf": conf,
            "fovs": self.fovs,
            "unpadded": gt.shape,
        }


class _PathListStacks:
    """Shared reader for the path-list datasets (Middlebury, FlyingThings3D):
    each line = N image paths + 1 disparity path; ``USER`` is the subclass's."""

    def __init__(self, list_file: str, num_imgs: int):
        self.num_imgs = num_imgs
        self.rgb_paths: List[List[str]] = [[] for _ in range(num_imgs)]
        self.disp_paths: List[str] = []
        with open(list_file) as f:
            for line in f:
                tmp = line.strip().split()
                if not tmp:
                    continue
                for i in range(num_imgs):
                    self.rgb_paths[i].append(tmp[i])
                self.disp_paths.append(tmp[-1])

    def read_stack(self, idx: int) -> np.ndarray:
        # uint8; consumers divide by 127.5 (→ float64, identical to the old
        # astype(float64) read) or run the float64-LUT augmentation
        imgs = [native.imread_compat(x[idx], self.USER) for x in self.rgb_paths]
        return np.stack(imgs, axis=-1)  # (H, W, 3, N)


class MiddleburyDataset(_PathListStacks):
    """Middlebury 15-slice stacks, focus linspace(10, 60, 15)
    (`test_Dataloader.py:231-284`)."""

    USER = f"MiddleburyDataset ({_EVAL} FlyingThings3D)"

    def __init__(self, list_file: str = "Datasets/Middlebury_FS/focal_stack/Middlebury_path.txt"):
        super().__init__(list_file, 15)
        self.focus_dists = np.linspace(10, 60, 15).astype(np.float32)
        self.low_bound, self.high_bound = 10, 60

    def __len__(self):
        return len(self.disp_paths)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        depth = _read_depth_any(self.disp_paths[idx], self.USER)
        stack = self.read_stack(idx) / 127.5 - 1.0
        depth = depth.copy()
        depth[depth < self.low_bound] = 0.0
        depth[depth > self.high_bound] = 0.0
        mask = depth != 0.0
        return {
            "fs": _pad32(_hwcn_to_nhwc(stack)),
            "depth": depth.astype(np.float32),
            "focus_dists": self.focus_dists,
            "mask": mask,
            "unpadded": depth.shape,
        }


class FlyingThings3DDataset(_PathListStacks):
    """FlyingThings3D focal stacks, focus linspace(10, 100, 15)
    (`train_Dataloader.py:143-215`)."""

    USER = f"FlyingThings3DDataset ({_TRAIN} FlyingThings)"

    def __init__(self, root: str = "Datasets/FlyingThings3D_FS/", mode: str = "train",
                 seed: int = 0):
        super().__init__(os.path.join(root, mode, "flyingthings3d_FS_path.txt"), 15)
        self.mode = mode
        self.train_size = (256, 256)
        self.focus_dists = np.linspace(10, 100, 15).astype(np.float32)
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.disp_paths)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        depth = _read_depth_any(self.disp_paths[idx], self.USER)
        stack = self.read_stack(idx)
        if self.mode == "train":
            h, w = depth.shape
            interval = (h - self.train_size[0], w - self.train_size[1])
            s = aug.Seeds.draw(self.rng, crop_interval=interval)
            stack, depth = aug.apply_standard(
                stack, depth, s, crop_interval=interval, lut_dtype=np.float64
            )
        else:
            stack = stack / 127.5 - 1.0
        depth = depth.copy()
        depth[depth < 0.0] = 0.0
        mask = depth != 0.0
        return {
            "fs": _pad32(_hwcn_to_nhwc(stack)),
            "depth": depth.astype(np.float32),
            "focus_dists": self.focus_dists,
            "mask": mask,
            "unpadded": depth.shape,
        }


class RealScenesDataset:
    """Any folder of >= 10 png/jpg slices + focus_distance.txt + focal_length.txt
    (`End_to_End/Test_dataloader.py:8-75`); the bundled sample scene is
    ``balls/``.  Crops 1/12 borders, builds relative FOVs and diopter focus
    distances, pads to x32 with -1."""

    USER = "RealScenesDataset (python -m dffx_torch.eval.real_scenes)"

    def __init__(self, root: str = "Datasets/", num_imgs: int = 10):
        self.root = root
        self.num_imgs = num_imgs
        self.dirs = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )

    def __len__(self):
        return len(self.dirs)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        path = os.path.join(self.root, self.dirs[idx]) + "/"
        files = sorted(
            f for f in os.listdir(path) if f.endswith(".png") or f.endswith("jpg")
        )
        first = native.imread_compat(path + files[0], self.USER)
        h0, w0 = first.shape[:2]
        cy, cx = h0 // 12, w0 // 12

        with open(path + "focus_distance.txt") as f:
            focus_dists = np.asarray(
                [float(f.readline()) for _ in range(self.num_imgs)], dtype=np.float64
            )
        with open(path + "focal_length.txt") as f:
            focal_length = float(f.readline())

        rel_fov = 1 / focal_length - 1 / focus_dists
        rel_fov = rel_fov / np.min(rel_fov)

        imgs = [
            native.imread_compat(path + files[i], self.USER)[cy:-cy, cx:-cx]
            for i in range(self.num_imgs)
        ]
        raw = np.stack(imgs, axis=0)  # (N, H, W, 3) uint8
        unpadded = raw.shape[1:3]
        fs = native.normalize_pad_stack(raw)
        return {
            "fs": fs,
            "focus_dists": (1.0 / focus_dists).astype(np.float32),
            "fovs": rel_fov.astype(np.float32),
            "unpadded": unpadded,
        }
