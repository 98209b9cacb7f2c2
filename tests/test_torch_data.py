"""The port's data modules against ``dffx``'s on files the tests write: every
reader in train and eval mode gives bit-equal sample dicts for the same seed,
``Loader`` the same batches in the same order, EXR files and TensorBoard event
files cross between the packages both ways, and the prefetch moves a batch
unchanged (on the CPU; its CUDA path is in ``tests/test_torch_gpu.py``)."""

import os
import threading

import numpy as np
import pytest
import torch

import dffx.data as jdata
from dffx.data import exr as jexr
from dffx.data import native as jnative
from dffx.utils import tensorboard as jtb
from dffx_torch import data as tdata
from dffx_torch.data import exr as texr
from dffx_torch.data import native
from dffx_torch.utils import sanitize as tsan
from dffx_torch.utils import tensorboard as ttb

import torch_fixtures as fx


@pytest.fixture(scope="module", autouse=True)
def _whole_reference_library():
    """``dffx``'s host library built and loadable before this module's first
    ``dffx`` reader or ``dffx.data.native`` call (``fx.reference_host_library``)."""
    fx.reference_host_library(jnative._SO, jnative._REQUIRED_VERSION)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_data"))
    paths = {
        "fs6": fx.write_fs6(root),
        "hci": fx.write_hci(root),
        "ddff_test": fx.write_ddff_test(root),
        "ddff_trainval": fx.write_ddff_trainval(root),
        "phone": fx.write_smartphone(root),
        "midd": fx.write_middlebury(root),
        "ft3d": fx.write_flyingthings(root),
        "sim": fx.write_simulated(os.path.join(root, "NYU_move_out_0_1")),
    }
    paths["scenes"] = fx.write_real_scene(os.path.join(root, "scenes"))
    paths["root"] = root
    return paths


def _hci_train(m, p):
    ds = m.HCIDataset(p["hci"], split="train", seed=3)
    ds.crop = 32  # the reader's 256 crop, cut to the fixture's 48 px
    return ds


def _ft3d_train(m, p):
    ds = m.FlyingThings3DDataset(p["ft3d"], mode="train", seed=4)
    ds.train_size = (32, 32)  # the reader's 256 crop, cut to the fixture's 40 x 56
    return ds


def _pad32(fs):
    _, h, w, _ = fs.shape
    return np.pad(fs, ((0, 0), (0, -h % 32), (0, -w % 32), (0, 0)), constant_values=-1.0)


#: (reader and mode, its constructor over a data package, the port's sample
#: from dffx's where the port deliberately differs)
READERS = [
    ("defocusnet_test", lambda m, p: m.DefocusNetDataset(p["fs6"], mode="test"), None),
    ("defocusnet_train", lambda m, p: m.DefocusNetDataset(p["fs6"], mode="train", seed=1), None),
    ("hci_val", lambda m, p: m.HCIDataset(p["hci"], split="val"), None),
    ("hci_train", _hci_train, None),
    ("ddff_benchmark", lambda m, p: m.DDFFBenchmark(p["ddff_test"]), None),
    ("ddff_trainval_train", lambda m, p: m.DDFFTrainval(p["ddff_trainval"], split="train",
                                                        seed=2, crop=(32, 32)), None),
    # the port pads the val split to x32 (DDFFTrainval's docstring)
    ("ddff_trainval_val", lambda m, p: m.DDFFTrainval(p["ddff_trainval"], split="val"),
     lambda s: {**s, "fs": _pad32(s["fs"])}),
    ("smartphone_test", lambda m, p: m.SmartphoneDataset(p["phone"], mode="test"), None),
    ("smartphone_train", lambda m, p: m.SmartphoneDataset(p["phone"], mode="train", seed=5),
     None),
    ("middlebury", lambda m, p: m.MiddleburyDataset(p["midd"]), None),
    ("flyingthings_val", lambda m, p: m.FlyingThings3DDataset(p["ft3d"], mode="val"), None),
    ("flyingthings_train", _ft3d_train, None),
    ("real_scenes", lambda m, p: m.RealScenesDataset(p["scenes"]), None),
    ("simulated_val", lambda m, p: m.SimulatedScenesDataset(p["sim"], mode="val"), None),
    ("simulated_train", lambda m, p: m.SimulatedScenesDataset(p["sim"], mode="train", crop=32,
                                                              seed=6), None),
]


def _assert_samples_equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        g = got[k]
        if k == "unpadded":  # a tuple in a sample, a (B, 2) array in a batch
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=what)
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k, g.dtype, w.dtype, g.shape)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


@pytest.mark.parametrize("name,make,expect", READERS, ids=[r[0] for r in READERS])
def test_reader_is_bit_equal_to_dffx(files, name, make, expect):
    """Two passes over the dataset, so that train modes draw their second
    crops and flips from the generator as well."""
    ours, ref = make(tdata, files), make(jdata, files)
    assert len(ours) == len(ref) > 0
    for _ in range(2):
        for i in range(len(ref)):
            want = ref[i]
            _assert_samples_equal(ours[i], expect(want) if expect else want, f"{name}[{i}]")


@pytest.mark.parametrize("recipe", ["DDFF", "HCI", "Defocus", "FlyingThings", "Smartphone",
                                    "Simulated"])
def test_recipe_datasets_are_dffx_readers(files, recipe):
    """``Recipe.make_datasets`` opens the same readers at the same paths under
    the data root; the validation set's first sample is bit-equal (the DDFF
    validation stacks padded, as ``test_reader_is_bit_equal_to_dffx``)."""
    from dffx.train.recipes import RECIPES as JRECIPES
    from dffx_torch.train.recipes import RECIPES

    ours = RECIPES[recipe].make_datasets(files["root"], 3)
    ref = JRECIPES[recipe].make_datasets(files["root"], 3)
    for got, want in zip(ours, ref):
        assert type(got).__name__ == type(want).__name__ and len(got) == len(want) > 0
    want = ref[1][0]
    if recipe == "DDFF":
        want = {**want, "fs": _pad32(want["fs"])}
    _assert_samples_equal(ours[1][0], want, recipe)


def test_ddff_focus_dists_and_augmentation_draws_match(rng):
    np.testing.assert_array_equal(tdata.ddff_focus_dists(), jdata.ddff_focus_dists())
    from dffx.data import augmentation as jaug
    from dffx_torch.data import augmentation as taug

    a, b = np.random.default_rng(9), np.random.default_rng(9)
    for crop in (None, (5, 7)):
        assert vars(taug.Seeds.draw(a, crop)) == vars(jaug.Seeds.draw(b, crop))
    x = rng.integers(0, 256, (6, 8, 3, 2), dtype=np.uint8)
    d = rng.uniform(0, 2, (6, 8)).astype(np.float32)
    s = taug.Seeds.draw(np.random.default_rng(1), (2, 3))
    for got, want in zip(taug.apply_standard(x, d, s, crop_interval=(2, 3)),
                         jaug.apply_standard(x, d, jaug.Seeds(**vars(s)), crop_interval=(2, 3))):
        np.testing.assert_array_equal(got, want)


def test_native_paths_match_dffx(rng):
    stack = rng.integers(0, 256, (3, 47, 72, 3), dtype=np.uint8)
    np.testing.assert_array_equal(native.normalize_pad_stack(stack),
                                  jnative.normalize_pad_stack(stack))
    hwcn = rng.uniform(0, 255, (8, 9, 3, 2))
    np.testing.assert_array_equal(native.hwcn_to_nhwc_normalize(hwcn),
                                  jnative.hwcn_to_nhwc_normalize(hwcn))
    with pytest.raises(FileNotFoundError, match="cannot decode"):
        native.imread_compat("/nonexistent/x.png", "a test")


def test_missing_package_raises_naming_it_and_the_command(monkeypatch, tmp_path):
    import sys

    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py now raises
    with pytest.raises(ImportError, match=r"DDFFBenchmark \(python -m dffx_torch\.eval\.test "
                                          r"--dataset DDFF\) needs the package 'h5py'"):
        tdata.DDFFBenchmark(str(tmp_path / "x.h5"))


#: a train-mode reader draws its crops and flips from one generator in the
#: order its samples are decoded, which is the sample order with one decode
#: thread only (in both packages); eval mode draws nothing
@pytest.mark.parametrize("mode,threads,shuffle,drop_last,batch",
                         [("test", 3, False, False, 3), ("test", 3, True, True, 2),
                          ("train", 1, True, True, 2)])
def test_loader_gives_dffx_batches_in_order(files, mode, threads, shuffle, drop_last, batch):
    def batches(m):
        ds = m.DefocusNetDataset(files["fs6"], mode=mode, seed=1)
        ds.imglist_dpt = ds.imglist_dpt * 3  # six samples from the two stacks
        ds.imglist_all = ds.imglist_all * 3
        return list(m.Loader(ds, batch, shuffle=shuffle, drop_last=drop_last,
                             num_threads=threads, seed=7))

    ours, ref = batches(tdata), batches(jdata)
    assert len(ours) == len(ref) == (3 if drop_last else 2)
    for i, (g, w) in enumerate(zip(ours, ref)):
        _assert_samples_equal(g, w, f"batch {i}")


def test_loader_is_deterministic_and_leaks_no_thread(files):
    def factory(threads):
        ds = tdata.DefocusNetDataset(files["fs6"], mode="test")
        return tdata.Loader(ds, 1, shuffle=True, num_threads=threads, seed=3)

    with tsan.thread_guard():
        assert tsan.check_loader_determinism(factory) == 2
        for _ in tdata.device_prefetch(iter(factory(2)), "cpu", ("fs",)):
            break


def test_prefetch_on_the_cpu_keeps_values_and_raises_loader_errors():
    batch = {"fs": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
             "mask": np.array([True, False]), "unpadded": np.array([[3, 4], [3, 4]])}
    (host, dev), = list(tdata.device_prefetch(iter([batch]), "cpu", ("fs", "mask", "x")))
    assert host is batch and sorted(dev) == ["fs", "mask"]
    assert torch.equal(dev["fs"], torch.from_numpy(batch["fs"])) and dev["mask"].dtype == torch.bool

    class Bad:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise RuntimeError("decode boom")
            return {"fs": np.zeros((2, 32, 32, 3), np.float32)}

    with pytest.raises(RuntimeError, match="decode boom"):
        for _ in tdata.device_prefetch(iter(tdata.Loader(Bad(), 2, num_threads=1)), "cpu",
                                       ("fs",)):
            pass


def test_prefetch_releases_its_producer_on_early_exit():
    done = threading.Event()

    def source():
        try:
            for i in range(1000):
                yield {"x": np.full((4,), i, np.float32)}
        finally:
            done.set()

    gen = tdata.device_prefetch(source(), "cpu", ("x",), size=2)
    next(gen)
    gen.close()
    assert done.wait(5.0), "producer still blocked after the consumer left"


@pytest.mark.parametrize("compression", ["none", "zips", "zip"])
def test_exr_crosses_between_the_packages(tmp_path, rng, compression):
    chans = {"R": rng.uniform(0, 2, (37, 21)).astype(np.float16),
             "G": rng.standard_normal((37, 21)).astype(np.float32),
             "Z": rng.integers(0, 2**31, (37, 21)).astype(np.uint32)}
    for name, (write, read) in {"port_to_dffx": (texr.write, jexr.read),
                                "dffx_to_port": (jexr.write, texr.read)}.items():
        path = str(tmp_path / f"{name}.exr")
        write(path, chans, compression=compression)
        back = read(path)
        assert sorted(back) == sorted(chans)
        for k, v in chans.items():
            assert back[k].dtype == v.dtype
            np.testing.assert_array_equal(back[k], v)
    np.testing.assert_array_equal(texr.read_depth(path), chans["R"].astype(np.float32))


def test_tensorboard_events_cross_between_the_packages(tmp_path):
    scalars = [("Loss/train/Total loss", 0, 0.5), ("Loss/validation/DFF/Avg_mse", 3, 1e-3)]
    for name, (writer, reader) in {"port": (ttb.SummaryWriter, jtb.read_scalars),
                                   "dffx": (jtb.SummaryWriter, ttb.read_scalars)}.items():
        w = writer(str(tmp_path / name))
        for tag, step, value in scalars:
            w.add_scalar(tag, value, step)
        w.close()
        (event_file,) = os.listdir(tmp_path / name)
        got = reader(str(tmp_path / name / event_file))
        assert [(t, s) for t, s, _ in got] == [(t, s) for t, s, _ in scalars]
        np.testing.assert_allclose([v for *_, v in got], [v for *_, v in scalars], rtol=1e-7)


def test_sanitizer_names_the_bad_tensors():
    from dffx.utils import sanitize as jsan

    trees = {"grads": {"a.weight": torch.tensor([1.0, float("nan"), float("inf")]),
                       "b.bias": torch.zeros(2)},
             "batch": {"fs": np.array([[np.nan]], np.float32), "mask": np.ones(2, bool)}}
    with pytest.raises(tsan.NonFiniteError) as got:
        tsan.raise_nonfinite("non-finite numerics at step 3", trees)
    with pytest.raises(jsan.NonFiniteError) as want:
        jsan.raise_nonfinite("non-finite numerics at step 3",
                             {g: {k: np.asarray(v) for k, v in t.items()}
                              for g, t in trees.items()})
    assert str(got.value) == str(want.value)
    assert got.value.report == {"grads": {"['a.weight']": (2, 3)}, "batch": {"['fs']": (1, 1)}}
