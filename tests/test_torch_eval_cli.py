"""The port's eval command lines against ``dffx``'s on files the tests write,
on the CPU (``--device cpu``), random weights from seed 0 in both:

* ``dffx_torch.eval.test`` on a DefocusNet fixture (5 x 64 x 64) and a DDFF-12
  test file (10 x 47 x 72, padded to 64 x 96): the metric prints within 1e-4
  relative of ``dffx``'s and DDFF's ``predictions.npy`` within 1e-4, the same
  JPEG names, and ``--batch_size 8`` equal to ``--batch_size 1``;
* ``dffx_torch.eval.real_scenes`` on one scene of ten 48 x 72 JPEGs: depth
  and warped stack within 1e-4 of ``dffx``'s forward, the same files;
* an unknown ``--dataset`` exits as ``dffx``'s does, and each command line
  runs on the card by default and raises without one.

``dffx`` runs once per fixture (module-scoped)."""

import os

import numpy as np
import pytest
import torch

import torch_fixtures as fx

ATOL = RTOL = 1e-4


def _parse(out: str) -> dict:
    vals = {}
    for line in out.splitlines():
        key, sep, value = line.partition(":")
        if sep and key.strip().startswith(("Avg_", "AVG_")):
            vals[key.strip()] = float(value)
    return vals



@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from fx.one_thread()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_eval_cli"))
    fx.write_fs6(root, modes=("test",))
    fx.write_ddff_test(root)
    return root + "/"


def _eval_argv(data, results, dataset, *extra):
    return ["--dataset", dataset, "--data-root", data, "--results-root", results,
            "--allow-random-init", *extra]


@pytest.fixture(scope="module")
def dffx_runs(data, tmp_path_factory):
    from dffx.eval import test as JT

    runs = {}
    for dataset in ("DefocusNet", "DDFF"):
        results = str(tmp_path_factory.mktemp(f"dffx_{dataset}")) + "/"
        out = fx.run_cli(JT.main, _eval_argv(data, results, dataset))
        runs[dataset] = (_parse(out), results)
    return runs


def _port_eval(data, results, dataset, batch):
    from dffx_torch.eval import test as T

    out = fx.run_cli(T.main, _eval_argv(data, str(results) + "/", dataset, "--device",
                                        "cpu", "--batch_size", str(batch)))
    return _parse(out)


def _outputs(results, dataset):
    root = os.path.join(results, dataset)
    jpgs = sorted(os.listdir(os.path.join(root, "Depth")))
    preds = os.path.join(root, "predictions.npy")
    return jpgs, (np.load(preds) if os.path.exists(preds) else None)


@pytest.mark.parametrize("dataset", ["DefocusNet", "DDFF"])
def test_eval_cli_matches_dffx_and_batch_one(data, dffx_runs, tmp_path, dataset):
    want, dffx_results = dffx_runs[dataset]
    want_jpgs, want_preds = _outputs(dffx_results, dataset)
    got = {b: _port_eval(data, tmp_path / f"b{b}", dataset, b) for b in (8, 1)}
    keys = sorted(k for k in want if k != "AVG_time")
    assert "AVG_time" in got[8] and len(keys) == (9 if dataset == "DefocusNet" else 0)
    for b, metrics in got.items():
        assert sorted(k for k in metrics if k != "AVG_time") == keys, b
        for k in keys:
            np.testing.assert_allclose(metrics[k], want[k], rtol=RTOL, err_msg=f"b{b} {k}")
        jpgs, preds = _outputs(str(tmp_path / f"b{b}"), dataset)
        assert jpgs == want_jpgs == ["0.jpg", "1.jpg"]
        if want_preds is not None:
            assert preds.shape == want_preds.shape and preds.dtype == want_preds.dtype
            np.testing.assert_allclose(preds, want_preds, atol=ATOL, rtol=0, err_msg=f"b{b}")
    if want_preds is not None:
        np.testing.assert_allclose(_outputs(str(tmp_path / "b8"), dataset)[1],
                                   _outputs(str(tmp_path / "b1"), dataset)[1], atol=ATOL, rtol=0)


def test_real_scenes_cli_matches_dffx(tmp_path, monkeypatch):
    import cv2

    from dffx.eval import common as jcommon
    from dffx.eval import real_scenes as JRS
    from dffx_torch.eval import real_scenes as RS

    scenes = fx.write_real_scene(str(tmp_path / "scenes"))
    forwards = []

    class Recording(jcommon.TimedForward):
        def __call__(self, *args):
            outs = super().__call__(*args)
            forwards.append([np.asarray(o, np.float32) for o in outs])
            return outs

    monkeypatch.setattr(JRS, "TimedForward", Recording)
    argv = ["--data-root", scenes, "--allow-random-init"]
    want_out = fx.run_cli(JRS.main, argv + ["--out", str(tmp_path / "dffx") + "/"])
    with fx.recording_forwards(RS) as got:
        got_out = fx.run_cli(RS.main, argv + ["--out", str(tmp_path / "port") + "/",
                                              "--device", "cpu"])
    assert "AVG_time" in want_out and "AVG_time" in got_out
    (depth, warped), = [(f[3][0], f[4][0]) for f in forwards]
    (got_depth, got_warped), = [(f[3][0], f[4][0]) for f in got]
    h, w = cv2.imread(str(tmp_path / "port" / "warped_result" / "0" / "0.png")).shape[:2]
    assert (h, w) == (40, 60) and got_warped.shape == warped.shape == (10, *depth.shape, 3)
    np.testing.assert_allclose(got_depth, depth, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_warped, warped, atol=ATOL, rtol=0)
    for sub in ("depth", os.path.join("warped_result", "0")):
        names = sorted(os.listdir(tmp_path / "port" / sub))
        assert names == sorted(os.listdir(tmp_path / "dffx" / sub)), sub
    for i in range(10):  # PNGs of values within 1e-4: at most one level apart
        a, b = (cv2.imread(str(tmp_path / p / "warped_result" / "0" / f"{i}.png")).astype(int)
                for p in ("port", "dffx"))
        assert np.abs(a - b).max() <= 1


def test_unknown_dataset_exits_as_dffx_does(tmp_path):
    from dffx.eval import test as JT
    from dffx_torch.eval import test as T

    with pytest.raises(SystemExit) as want:
        JT.main(["--dataset", "KITTI", "--results-root", str(tmp_path)])
    with pytest.raises(SystemExit) as got:
        T.main(["--dataset", "KITTI", "--results-root", str(tmp_path), "--device", "cpu"])
    assert str(got.value) == str(want.value) == "unknown --dataset 'KITTI'"


@pytest.mark.parametrize("module,argv", [
    ("dffx_torch.eval.test", ["--dataset", "DDFF", "--results-root"]),
    ("dffx_torch.eval.real_scenes", ["--out"]),
    ("dffx_torch.train.cli", ["--recipe", "DDFF", "--lr", "1e-4", "--saveroot"]),
], ids=["test", "real_scenes", "train"])
def test_command_lines_default_to_the_card(module, argv, tmp_path):
    """Each command line takes ``--device`` with default ``cuda`` and, where
    there is no card, raises before it reads or writes anything."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        importlib.import_module(module).main(argv + [str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
