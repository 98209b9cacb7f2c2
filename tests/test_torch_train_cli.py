"""The port's train command line against ``dffx``'s, both on one in-memory
dataset of 5 x 32 x 32 stacks (``Recipe.make_datasets`` replaced, as
``tests/test_train_cli.py`` does), the DDFF recipe, batch 8 (``dffx``'s mesh
spans the suite's 8 CPU devices), one step an epoch, on the CPU:

* epoch 0's validation prints within 1e-4 relative and the first step's loss
  within 1e-5 relative;
* each package's ``models/1.ckpt`` opens in the other (``dffx.checkpoint.load``;
  the port's ``--load_epoch -1``), the TensorBoard tags are ``dffx``'s;
* auto-resume restores the state bit for bit (epoch 1 validates as the run
  that saved it did);
* ``--sanitize`` raises ``NonFiniteError`` on a NaN, and running out of device
  memory on the first step without ``--remat`` names ``--remat``.

``dffx`` and the port run once each (module-scoped)."""

import os
import shutil

import numpy as np
import pytest
import torch

from dffx import checkpoint as jckpt
from dffx.train import cli as jcli
from dffx.train.recipes import Recipe as JRecipe
from dffx.utils.tensorboard import read_scalars
from dffx_torch.train import cli
from dffx_torch.train.recipes import Recipe
from dffx_torch.utils.sanitize import NonFiniteError

import torch_fixtures as fx

BATCH = 8


class _TinyDS:
    def __init__(self, n, seed=0, nan=False):
        rng = np.random.default_rng(seed)
        self._samples = [
            {
                "fs": rng.uniform(-1, 1, (5, 32, 32, 3)).astype(np.float32),
                "depth": rng.uniform(0.1, 1.5, (32, 32)).astype(np.float32),
                "focus_dists": np.linspace(0.1, 1.5, 5, dtype=np.float32),
                "mask": np.ones((32, 32), bool),
                "unpadded": (32, 32),
            }
            for _ in range(n)
        ]
        if nan:
            for s in self._samples:
                s["fs"][0, 3, 3, 0] = np.nan

    def __len__(self):
        return len(self._samples)

    def __getitem__(self, i):
        return self._samples[i]


def _datasets(self, root, seed):
    return _TinyDS(BATCH), _TinyDS(1, seed=1)


def _argv(root, *extra):
    return ["--recipe", "DDFF", "--lr", "1e-4", "--saveroot", root, "--batch_size",
            str(BATCH), "--cpus", "2", "--steps-per-epoch", "1", "--max_epoch", "1", *extra]


def _first_epoch_prints(out: str) -> dict:
    """Epoch 0's validation metrics (``Avg_mse(0)``, ...) and its mean loss,
    which with one step an epoch is the first step's."""
    vals = {}
    for line in out.splitlines():
        key, sep, value = line.partition(":")
        key = key.strip()
        if sep and (key.endswith("(0)") or key == "AVG_DFF_TotalLoss"):
            vals.setdefault(key, float(value))
    return vals



@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from fx.one_thread()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(stdout, saveroot) of ``dffx``'s run and the port's, and what the
    port's run computed (``torch_fixtures.recording_train``)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(JRecipe, "make_datasets", _datasets)
    mp.setattr(Recipe, "make_datasets", _datasets)
    try:
        jroot = str(tmp_path_factory.mktemp("dffx_train")) + "/"
        jout = fx.run_cli(jcli.main, _argv(jroot))
        troot = str(tmp_path_factory.mktemp("port_train")) + "/"
        with fx.recording_train(cli) as ran:
            tout = fx.run_cli(cli.main, _argv(troot, "--device", "cpu"))
    finally:
        mp.undo()
    return {"dffx": (jout, jroot), "port": (tout, troot), "ran": ran}


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(Recipe, "make_datasets", _datasets)


def test_epoch_zero_validation_and_first_loss_match_dffx(runs):
    want = _first_epoch_prints(runs["dffx"][0])
    got = _first_epoch_prints(runs["port"][0])
    assert sorted(got) == sorted(want) and len(want) == 10, (got, want)
    for k, w in want.items():
        rtol = 1e-5 if k == "AVG_DFF_TotalLoss" else 1e-4
        np.testing.assert_allclose(got[k], w, rtol=rtol, err_msg=k)
    assert runs["ran"]["losses"][0] == pytest.approx(want["AVG_DFF_TotalLoss"], rel=1e-5)


def test_checkpoints_open_in_both_packages(runs, tiny, tmp_path):
    """The port's ``1.ckpt`` loads in ``dffx`` against a train-state template;
    ``dffx``'s resumes in the port (``--load_epoch -1``) and trains on."""
    from dffx.models import init_params, network_specs
    from dffx.train import create_train_state

    state = create_train_state(init_params(network_specs(), seed=1), 1e-4)
    blob = jckpt.load(os.path.join(runs["port"][1], "models", "1.ckpt"),
                      template={"step": state.step, "params": state.params,
                                "opt_state": state.opt_state})
    assert int(blob["step"]) == 1 and int(blob["opt_state"].inner_state[0].count) == 1

    jroot = str(tmp_path / "from_dffx") + "/"
    shutil.copytree(runs["dffx"][1], jroot)
    with fx.recording_train(cli) as ran:
        out = fx.run_cli(cli.main, _argv(jroot, "--device", "cpu", "--max_epoch", "2",
                                         "--load_epoch", "-1"))
    assert "auto-resume from epoch 1" in out
    assert ran["state"].step == 3  # dffx's one step, then one in each of epochs 1 and 2
    assert int(jckpt.load(os.path.join(jroot, "models", "2.ckpt"))["step"]) == 2


def test_auto_resume_restores_the_state_bit_for_bit(runs, tiny, tmp_path):
    root = str(tmp_path / "resume") + "/"
    shutil.copytree(runs["port"][1], root)
    with fx.recording_train(cli) as ran:
        out = fx.run_cli(cli.main, _argv(root, "--device", "cpu", "--max_epoch", "2",
                                         "--load_epoch", "-1"))
    assert "auto-resume from epoch 1" in out
    first = runs["ran"]["val_pred3"][1]
    for got, want in zip(ran["val_pred3"][1], first):
        np.testing.assert_array_equal(got, want)
    assert ran["state"].step == 3
    assert int(jckpt.load(os.path.join(root, "models", "2.ckpt"))["step"]) == 2


def test_tensorboard_tags_are_dffx_tags(runs):
    def tags(root):
        logs = os.path.join(root, "logs")
        (event_file,) = os.listdir(logs)
        return sorted((t, s) for t, s, _ in read_scalars(os.path.join(logs, event_file)))

    assert tags(runs["port"][1]) == tags(runs["dffx"][1])


def test_sanitize_raises_on_a_nan(monkeypatch, tmp_path):
    monkeypatch.setattr(Recipe, "make_datasets",
                        lambda self, root, seed: (_TinyDS(BATCH, nan=True), _TinyDS(1)))
    with pytest.raises(NonFiniteError, match=r"non-finite numerics at step 1") as err:
        fx.run_cli(cli.main, _argv(str(tmp_path) + "/", "--device", "cpu", "--sanitize"))
    assert "['fs']" in err.value.report["batch"]


def test_remat_hint_on_out_of_memory():
    def oom_step(state, batch):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

    with pytest.raises(RuntimeError, match=r"rerun with --remat"):
        cli._with_remat_hint(oom_step, remat=False, batch_size=128)(None, None)
    with pytest.raises(torch.cuda.OutOfMemoryError):  # remat already on: nothing to suggest
        cli._with_remat_hint(oom_step, remat=True, batch_size=128)(None, None)

    def other_step(state, batch):
        raise ValueError("shape mismatch")

    with pytest.raises(ValueError, match="shape mismatch"):
        cli._with_remat_hint(other_step, remat=False, batch_size=128)(None, None)

    calls = []

    def flaky_step(state, batch):
        calls.append(1)
        if len(calls) > 1:
            raise torch.cuda.OutOfMemoryError("mid-train")
        return "state", {}

    wrapped = cli._with_remat_hint(flaky_step, remat=False, batch_size=128)
    assert wrapped(None, None)[0] == "state"
    with pytest.raises(torch.cuda.OutOfMemoryError, match="mid-train"):
        wrapped(None, None)
