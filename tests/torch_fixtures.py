"""Small dataset files in every format the readers take, written from a seed
with numpy, ``cv2``, ``h5py``, ``scipy.io`` and the EXR writer: the fixtures of
``tests/test_torch_data.py`` and the CLI tests of the port.  Each writer takes
the directory to write into and returns the path a reader is given.
``run_cli`` runs a command line's ``main`` in-process; ``recording_train`` and
``recording_forwards`` keep what a command line computes, which it does not
return.  ``chip_smoke.py`` drives the command lines through the same helpers."""

import contextlib
import io
import os
import time

import numpy as np

from dffx_torch.data import exr

SMARTPHONE_SHAPE = (504, 378)  # the readers crop 84 / 63 px margins to 336 x 252


def one_thread():
    """A generator for a module-scoped fixture: torch on one CPU thread for the
    module, then as before.  The suite's workers share the CPUs, where torch's
    own thread pool in each of them slows these small-tensor runs many times
    over."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def run_cli(main, argv) -> str:
    """``main(argv)`` with its prints captured; returns them."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@contextlib.contextmanager
def recording_train(cli):
    """The train command line (``dffx_torch.train.cli``) with its train step
    and its validation watched for the block.  Yields a dict that collects
    each step's ``losses`` and host ``step_seconds`` (to the loss read back,
    which waits for the step), the ``state`` after the last step, and per
    validated epoch each forward's ``val_pred3`` (the padded map, float32)
    and ``val_seconds`` (synchronised)."""
    ran = {"losses": [], "step_seconds": [], "state": None, "val_pred3": {}, "val_seconds": {}}
    make_train_step, validate = cli.make_train_step, cli._validate

    def watched_make_train_step(*args, **kw):
        step = make_train_step(*args, **kw)

        def run(state, batch):
            t0 = time.perf_counter()
            state, logs = step(state, batch)
            ran["losses"].append(float(logs["loss"]))
            ran["step_seconds"].append(time.perf_counter() - t0)
            ran["state"] = state
            return state, logs

        return run

    def watched_validate(eval_fn, model, dataset, recipe, writer, epoch, device):
        preds = ran["val_pred3"].setdefault(epoch, [])
        seconds = ran["val_seconds"].setdefault(epoch, [])

        def fwd(model, batch):
            t0 = time.perf_counter()
            outs = eval_fn(model, batch)
            cli._sync(device)
            seconds.append(time.perf_counter() - t0)
            preds.append(outs[3].float().cpu().numpy()[0])
            return outs

        return validate(fwd, model, dataset, recipe, writer, epoch, device)

    cli.make_train_step, cli._validate = watched_make_train_step, watched_validate
    try:
        yield ran
    finally:
        cli.make_train_step, cli._validate = make_train_step, validate


@contextlib.contextmanager
def recording_forwards(module):
    """``module.TimedForward`` (an eval command line's) replaced for the block
    by a subclass that keeps each call's outputs as float32 arrays; yields
    the list of them, one tuple a call."""
    timed_forward, kept = module.TimedForward, []

    class Recording(timed_forward):
        def __call__(self, *args):
            outs = super().__call__(*args)
            kept.append(tuple(o.float().cpu().numpy() for o in outs))
            return outs

    module.TimedForward = Recording
    try:
        yield kept
    finally:
        module.TimedForward = timed_forward


def write_fs6(root, *, modes=("test", "train"), stacks=2, size=64, seed=0):
    """DefocusNet ``fs_6/{mode}/``: ``{s}Dpt.exr`` and five ``{s}_{i}All.tif``."""
    import cv2

    r = np.random.default_rng(seed)
    for mode in modes:
        d = os.path.join(root, "fs_6", mode)
        os.makedirs(d, exist_ok=True)
        for s in range(stacks):
            depth = r.uniform(0.0, 1.8, (size, size)).astype(np.float16)
            exr.write(os.path.join(d, f"{s:02d}Dpt.exr"), {c: depth for c in "RGB"})
            for i in range(5):
                cv2.imwrite(os.path.join(d, f"{s:02d}_{i}All.tif"),
                            r.integers(0, 256, (size, size, 3), dtype=np.uint8))
    return os.path.join(root, "fs_6") + "/"


def write_hci(root, *, size=48, seed=1):
    import h5py

    r = np.random.default_rng(seed)
    path = os.path.join(root, "HCI", "HCI_FS_trainval.h5")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with h5py.File(path, "w") as f:
        for split, n in (("train", 2), ("val", 1)):
            f[f"stack_{split}"] = r.integers(0, 256, (n, 10, size, size, 3), dtype=np.uint8)
            f[f"disp_{split}"] = r.uniform(-3.2, 3.2, (n, size, size)).astype(np.float32)
        f["focus_position_disp"] = np.linspace(-2.5, 2.5, 10)[None].astype(np.float32)
    return path


def write_ddff_test(root, *, stacks=2, h=47, w=72, seed=2):
    """DDFF-12's test h5 (``stack_test``), uint8 stacks without ground truth."""
    import h5py

    r = np.random.default_rng(seed)
    path = os.path.join(root, "DDFF", "ddff-dataset-test.h5")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with h5py.File(path, "w") as f:
        f["stack_test"] = r.integers(0, 256, (stacks, 10, h, w, 3), dtype=np.uint8)
    return path


def write_ddff_trainval(root, *, train=4, val=2, h=48, w=72, seed=3):
    import h5py

    r = np.random.default_rng(seed)
    path = os.path.join(root, "DDFF", "ddff-dataset-trainval.h5")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with h5py.File(path, "w") as f:
        for split, n in (("train", train), ("val", val)):
            f[f"stack_{split}"] = r.integers(0, 256, (n, 10, h, w, 3), dtype=np.uint8)
            f[f"disp_{split}"] = r.uniform(0.0, 0.3, (n, h, w)).astype(np.float32)
    return path


def _smartphone_scene(shard_dir, scene, r):
    import cv2

    indexes = np.rint(np.linspace(0, 48, 10, endpoint=True)).astype(int)
    for j in indexes:
        d = os.path.join(shard_dir, "scaled_images", scene, str(j))
        os.makedirs(d)
        cv2.imwrite(os.path.join(d, "result_scaled_image_center.jpg"),
                    r.integers(0, 256, SMARTPHONE_SHAPE + (3,), dtype=np.uint8))
    d = os.path.join(shard_dir, "merged_depth", scene)
    os.makedirs(d)
    cv2.imwrite(os.path.join(d, "result_merged_depth_center.png"),
                r.integers(0, 256, SMARTPHONE_SHAPE, dtype=np.uint8))
    d = os.path.join(shard_dir, "merged_conf", scene)
    os.makedirs(d)
    conf = r.uniform(0, 1.4, SMARTPHONE_SHAPE).astype(np.float16)
    exr.write(os.path.join(d, "result_merged_conf_center.exr"), {c: conf for c in "RGB"})


def write_smartphone(root, *, seed=4):
    """``test/`` with one scene, ``train1/`` with one, ``train2..7/`` empty."""
    r = np.random.default_rng(seed)
    base = os.path.join(root, "Real_data_DP")
    _smartphone_scene(os.path.join(base, "test"), "scene0", r)
    _smartphone_scene(os.path.join(base, "train1"), "scene0", r)
    for i in range(2, 8):
        os.makedirs(os.path.join(base, f"train{i}", "scaled_images"))
    return base + "/"


def _path_list(d, n_imgs, h, w, r, depth_ext):
    import cv2

    os.makedirs(d, exist_ok=True)
    paths = []
    for i in range(n_imgs):
        p = os.path.join(d, f"im{i}.png")
        cv2.imwrite(p, r.integers(0, 256, (h, w, 3), dtype=np.uint8))
        paths.append(p)
    dp = os.path.join(d, f"disp.{depth_ext}")
    if depth_ext == "exr":
        exr.write(dp, {"R": r.uniform(-5, 110, (h, w)).astype(np.float32)})
    else:
        cv2.imwrite(dp, r.integers(0, 80, (h, w), dtype=np.uint8))
    return " ".join(paths + [dp])


def write_middlebury(root, *, h=40, w=56, seed=5):
    r = np.random.default_rng(seed)
    line = _path_list(os.path.join(root, "midd"), 15, h, w, r, "png")
    path = os.path.join(root, "Middlebury_path.txt")
    with open(path, "w") as f:
        f.write(line + "\n")
    return path


def write_flyingthings(root, *, h=40, w=56, seed=6):
    r = np.random.default_rng(seed)
    base = os.path.join(root, "FlyingThings3D_FS")
    for mode in ("train", "val"):
        line = _path_list(os.path.join(base, mode, "s0"), 15, h, w, r, "exr")
        with open(os.path.join(base, mode, "flyingthings3d_FS_path.txt"), "w") as f:
            f.write(line + "\n")
    return base + "/"


def exif_oriented(jpeg: bytes, orientation: int) -> bytes:
    """``jpeg`` with an EXIF APP1 segment right after SOI that holds one
    Orientation tag (little-endian TIFF header, one IFD entry): ``cv2.imread``
    rotates such a file, libjpeg does not."""
    import struct

    ifd = struct.pack("<2sHI", b"II", 42, 8) + struct.pack("<H", 1)
    ifd += struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack("<I", 0)
    body = b"Exif\x00\x00" + ifd
    return jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + jpeg[2:]


def write_real_scene(root, *, h=48, w=72, n=10, seed=7, name="scene0"):
    """One hand-held scene: ``n`` JPEG slices, ``focus_distance.txt`` (metres,
    one a line) and ``focal_length.txt``; the reader crops 1/12 borders."""
    import cv2

    r = np.random.default_rng(seed)
    d = os.path.join(root, name)
    os.makedirs(d)
    base = cv2.GaussianBlur(r.integers(0, 256, (h, w, 3), dtype=np.uint8), (0, 0), 2)
    for i in range(n):
        noise = r.integers(-8, 9, (h, w, 3))
        cv2.imwrite(os.path.join(d, f"{i:02d}.jpg"),
                    np.clip(base.astype(int) + noise, 0, 255).astype(np.uint8))
    with open(os.path.join(d, "focus_distance.txt"), "w") as f:
        f.write("\n".join(f"{x:.6f}" for x in np.linspace(0.12, 0.9, n)) + "\n")
    with open(os.path.join(d, "focal_length.txt"), "w") as f:
        f.write("0.00444\n")
    return root


def write_simulated(root, *, h=48, w=64, n=10, seed=8):
    """One simulator scene: ``img{i}.png``, ``depth.mat``, ``camera_param.mat``."""
    import cv2
    import scipy.io as sio

    r = np.random.default_rng(seed)
    d = os.path.join(root, "0")
    os.makedirs(d)
    for i in range(n):
        cv2.imwrite(os.path.join(d, f"img{i}.png"), r.integers(0, 256, (h, w, 3), dtype=np.uint8))
    sio.savemat(os.path.join(d, "depth.mat"),
                {"depth": r.uniform(0.05, 1.0, (h, w)), "defocus": r.uniform(0, 3, (h, w, n))})
    sio.savemat(os.path.join(d, "camera_param.mat"),
                {"focal_length": np.array([[30.0]]), "pixel_mm": np.array([[6000.0]])})
    return root
