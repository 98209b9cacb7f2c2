"""The simulator's command line in both packages on the same NYU-v2 file:
``dffx.sim.simulator.main`` and ``dffx_torch.sim.simulator.main --device
cpu``, ``--limit 2 --num_planes 200 --seed 0``, at the command line's own
224 x 352 and 10 slices.

The file is a tiny labeled ``.mat`` in NYU-v2's v7.3 layout (HDF5:
``images (B, 3, W, H)`` uint8, ``depths (B, W, H)``), raw 64 x 96, written
with ``h5py``.  Bounds as ``tests/test_torch_sim.py``'s: PNG bytes |d| <= 1 at
more than 99.9 % of the pixels with a median of 0, ``depth.mat`` to rtol
1e-4 / atol 1e-3, ``camera_param.mat`` to 1e-12; the port's
``SimulatedScenesDataset`` reads both directories alike.
"""

import os

import numpy as np
import pytest

from dffx.sim import simulator as jsimulator
from dffx_torch.data import SimulatedScenesDataset
from dffx_torch.sim import simulator as tsimulator
from torch_fixtures import run_cli

ARGV = ["--limit", "2", "--num_planes", "200", "--seed", "0"]
SCENES, SLICES = 2, 10
RTOL, ATOL = 1e-4, 1e-3


def write_nyu_mat(path, *, scenes=SCENES, h=64, w=96, seed=0):
    """A labeled NYU-v2 ``.mat`` (v7.3 layout) of smooth images and depths
    with an edge, from a seed."""
    import cv2
    import h5py

    r = np.random.default_rng(seed)
    images = np.stack([cv2.GaussianBlur(r.integers(0, 256, (h, w, 3), dtype=np.uint8), (0, 0), 3)
                       for _ in range(scenes)])
    depths = np.stack([cv2.GaussianBlur(r.uniform(0.7, 4.0, (h, w)), (0, 0), 5)
                       for _ in range(scenes)])
    depths[:, :, w // 2:] += 1.5  # a depth edge
    with h5py.File(path, "w") as f:
        f["images"] = images.transpose(0, 3, 2, 1)
        f["depths"] = depths.transpose(0, 2, 1).astype(np.float32)
    return path


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """(dffx's directory, the port's directory, the port's prints)."""
    pytest.importorskip("h5py")
    root = tmp_path_factory.mktemp("sim_cli")
    mat = write_nyu_mat(str(root / "nyu_depth_v2_labeled.mat"))
    jdir, tdir = str(root / "dffx") + "/", str(root / "port") + "/"
    run_cli(jsimulator.main, ["--nyu-mat", mat, "--dataset", jdir, *ARGV])
    out = run_cli(tsimulator.main, ["--nyu-mat", mat, "--dataset", tdir, "--device", "cpu",
                                    *ARGV])
    return jdir, tdir, out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_same_files(outputs):
    jdir, tdir, out = outputs
    names = [f"{s}/{n}" for s in range(SCENES) for n in
             ["camera_param.mat", "depth.mat", *(f"img{i}.png" for i in range(SLICES))]]
    assert _files(tdir) == _files(jdir) == sorted(names)
    assert out.startswith("avg_time: ") and float(out.split(":", 1)[1]) > 0


@pytest.mark.parametrize("scene", range(SCENES))
def test_pngs_within_the_uint8_bound(outputs, scene):
    import cv2

    jdir, tdir, _ = outputs
    got = np.stack([cv2.imread(f"{tdir}{scene}/img{i}.png") for i in range(SLICES)])
    want = np.stack([cv2.imread(f"{jdir}{scene}/img{i}.png") for i in range(SLICES)])
    assert got.shape == want.shape == (SLICES, 224, 352, 3)
    d = np.abs(got.astype(int) - want.astype(int))
    assert (d <= 1).mean() > 0.999 and np.median(d) == 0, d.max()


@pytest.mark.parametrize("scene", range(SCENES))
def test_mats_match(outputs, scene):
    import scipy.io as sio

    jdir, tdir, _ = outputs
    got, want = (sio.loadmat(f"{d}{scene}/depth.mat") for d in (tdir, jdir))
    for key in ("depth", "defocus"):
        assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL, err_msg=key)
    assert got["defocus"].shape == (224, 352, SLICES)
    got, want = (sio.loadmat(f"{d}{scene}/camera_param.mat") for d in (tdir, jdir))
    keys = sorted(k for k in want if not k.startswith("__"))
    assert sorted(k for k in got if not k.startswith("__")) == keys
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12, atol=0, err_msg=key)


def test_reader_reads_both_alike(outputs):
    jdir, tdir, _ = outputs
    got, want = (SimulatedScenesDataset(d, mode="val") for d in (tdir, jdir))
    assert len(got) == len(want) == SCENES
    for i in range(SCENES):
        a, b = got[i], want[i]
        assert a["fs"].shape == (SLICES, 224, 352, 3)
        d = np.abs(a["fs"] - b["fs"]) * 127.5  # back to uint8 steps
        assert (d <= 1 + 1e-3).mean() > 0.999 and np.median(d) == 0
        np.testing.assert_allclose(a["depth"], b["depth"], rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(a["fovs"], b["fovs"])
        np.testing.assert_array_equal(a["focus_dists"], b["focus_dists"])
        np.testing.assert_array_equal(a["mask"], b["mask"])


def test_cli_defaults_to_the_card(tmp_path):
    """Without ``--device`` the command line renders on the card; where there
    is none it raises before it reads or writes anything."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here: chip_smoke.py runs the command line on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsimulator.main(["--nyu-mat", str(tmp_path / "missing.mat"),
                         "--dataset", str(tmp_path / "out") + "/"])
    assert not (tmp_path / "out").exists()
