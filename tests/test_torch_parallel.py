"""The port's process group, mesh, process-sharded ``Loader`` and the command
lines' multi-process flags, on the CPU:

* ``distributed.initialize``: arguments before ``DFFX_*`` variables before
  ``torchrun``'s, a single process joins no group, the backend rule;
* ``make_mesh``'s asserts and rank layout (``dffx``'s ``reshape(data,
  spatial)``);
* ``Loader(process_id=, process_count=)`` bit-equal to ``dffx.data.Loader``'s
  rows;
* the train command line as two ranks (``--coordinator``, ``--num_processes``,
  ``--process_id``, ``--bn_mode sync`` and ``per_shard``): the same state on
  both ranks, ``sync``'s first loss that of one process, and rank 1 writes no
  checkpoint and no log;
* both eval command lines with ``--spatial 2`` as two ranks (the group from
  ``DFFX_*`` variables): rank 0's results those of one process within 1e-4,
  and rank 1 writes and prints nothing; ``--spatial-pallas`` with
  ``--spatial-xla`` gives ``dffx``'s error; ``TimedForward(spatial=2)`` in one
  process names the launch.

The ranks are processes of their own in a gloo group
(``tests/torch_dist_worker.py``), started while this module runs the
one-process references."""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from dffx_torch.data import Loader
from dffx_torch.parallel import distributed, make_mesh
from dffx_torch.parallel.mesh import DATA_AXIS, SPATIAL_AXIS

import torch_dist_worker as w
import torch_fixtures as fx

RTOL = ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from fx.one_thread()


# ---------------------------------------------------------------------------
# initialize, the backend rule, the mesh
# ---------------------------------------------------------------------------

TORCHRUN = {"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29400", "WORLD_SIZE": "8", "RANK": "5"}
DFFX_ENV = {"DFFX_COORDINATOR": "host0:1234", "DFFX_NUM_PROCESSES": "4",
            "DFFX_PROCESS_ID": "3"}


@pytest.mark.parametrize("args,env,want", [
    ((None, None, None), {}, (None, None, None)),
    (("h:1", 2, 1), {**DFFX_ENV, **TORCHRUN}, ("h:1", 2, 1)),
    ((None, None, None), {**DFFX_ENV, **TORCHRUN}, ("host0:1234", 4, 3)),
    ((None, None, None), TORCHRUN, ("env://", 8, 5)),
    ((None, 2, None), TORCHRUN, ("env://", 2, 5)),
    (("file:///tmp/rdv", None, 0), DFFX_ENV, ("file:///tmp/rdv", 4, 0)),
], ids=["nothing", "arguments", "dffx_env", "torchrun", "mixed", "file_url"])
def test_group_arguments_precedence(args, env, want):
    assert distributed.group_arguments(*args, env) == want


def test_single_process_joins_no_group(monkeypatch):
    for k in (*DFFX_ENV, *TORCHRUN):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize(device="cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    assert distributed.is_primary()


def test_a_group_needs_a_process_id(monkeypatch):
    for k in (*DFFX_ENV, *TORCHRUN):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="process id"):
        distributed.initialize("h:1", 2, device="cpu")
    assert not torch.distributed.is_initialized()


def test_backend_rule(monkeypatch):
    """NCCL when every rank of a host has a card of its own, gloo otherwise."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = torch.device("cuda", 0)
    assert distributed.backend_for(cuda, 4) == "nccl"
    assert distributed.backend_for(cuda, 1) == "nccl"
    assert distributed.backend_for(cuda, 8) == "gloo"  # ranks share cards
    assert distributed.backend_for(torch.device("cpu"), 1) == "gloo"


def test_make_mesh_without_a_group():
    mesh = make_mesh()
    assert mesh.shape == {DATA_AXIS: 1, SPATIAL_AXIS: 1}
    assert mesh.group(DATA_AXIS) is None and mesh.index(SPATIAL_AXIS) == 0
    with pytest.raises(AssertionError):
        make_mesh(spatial=2)  # one rank does not split in two
    with pytest.raises(AssertionError):
        make_mesh(data=2, spatial=1)


# ---------------------------------------------------------------------------
# Loader process shards
# ---------------------------------------------------------------------------


class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.int64(i), "x": np.full((2, 3), i, dtype=np.float32)}


@pytest.mark.parametrize("count,batch,n", [(2, 4, 18), (4, 8, 35), (3, 6, 12)])
def test_loader_process_shards_equal_dffx(count, batch, n):
    from dffx.data import Loader as JLoader

    for pid in range(count):
        kw = dict(shuffle=True, drop_last=False, num_threads=2, seed=7, process_id=pid,
                  process_count=count)
        got, want = list(Loader(_Indexed(n), batch, **kw)), list(JLoader(_Indexed(n), batch, **kw))
        assert len(got) == len(want) == n // batch
        for g, h in zip(got, want):
            assert g.keys() == h.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], h[k])
    # the processes' slices of each batch, in rank order, are the batch
    whole = list(Loader(_Indexed(n), batch, shuffle=True, drop_last=True, seed=7))
    parts = [list(Loader(_Indexed(n), batch, shuffle=True, seed=7, process_id=p,
                         process_count=count)) for p in range(count)]
    for k, b in enumerate(whole):
        np.testing.assert_array_equal(np.concatenate([p[k]["i"] for p in parts]), b["i"])


def test_loader_batch_must_divide_over_processes():
    with pytest.raises(AssertionError):
        Loader(_Indexed(8), 3, process_id=0, process_count=2)


# ---------------------------------------------------------------------------
# the command lines as two ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_data")
    fx.write_fs6(str(root), modes=("test",))
    scenes = fx.write_real_scene(str(root / "scenes"))
    return str(root) + "/", scenes


def _eval_runs(data):
    root, scenes = data
    return [{"cli": "test", "argv": ["--dataset", "DefocusNet", "--data-root", root,
                                     "--results-root", "{out}/", "--allow-random-init",
                                     "--device", "cpu", "--batch_size", "1", "--spatial", "2"]},
            {"cli": "real_scenes", "argv": ["--data-root", scenes, "--out", "{out}/",
                                            "--allow-random-init", "--device", "cpu",
                                            "--spatial", "2", "--spatial-pallas"]}]


@pytest.fixture(scope="module")
def launched(tmp_path_factory, data):
    """The train command line's and the eval command lines' ranks, started
    at once."""
    tmp = tmp_path_factory.mktemp("parallel_cli")
    with ThreadPoolExecutor(2) as pool:
        yield {"train": pool.submit(w.launch, "train_cli", 2, tmp / "train", timeout=240),
               "eval": pool.submit(w.launch, "eval_cli", 2, tmp / "eval", timeout=240,
                                   runs=_eval_runs(data))}


@pytest.fixture(scope="module")
def one_process_train(launched, tmp_path_factory, monkeypatch_module):
    """The train command line in this process, on the same data: (prints,
    losses)."""
    from dffx_torch.train import cli
    from dffx_torch.train.recipes import Recipe

    monkeypatch_module.setattr(Recipe, "make_datasets", w._tiny_datasets)
    root = str(tmp_path_factory.mktemp("one_train")) + "/"
    argv = ["--recipe", "DDFF", "--lr", "1e-4", "--saveroot", root, "--batch_size", "8",
            "--cpus", "2", "--steps-per-epoch", "1", "--max_epoch", "1", "--device", "cpu"]
    with fx.recording_train(cli) as ran:
        out = fx.run_cli(cli.main, argv)
    return out, ran["losses"]


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.fixture(scope="module")
def train_ranks(launched, one_process_train):
    return launched["train"].result()


@pytest.mark.parametrize("mode", ["sync", "per_shard"])
def test_train_cli_ranks_agree_and_only_rank_zero_writes(train_ranks, mode):
    r0, r1 = (r[mode] for r in train_ranks)
    assert "models/1.ckpt" in r0["files"] and any(f.startswith("logs/") for f in r0["files"])
    assert r1["files"] == [] and r1["out"] == ""
    assert "AVG_DFF_TotalLoss" in r0["out"] and "backend gloo" in r0["out"]
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 2
    assert all(np.isfinite(r0["losses"]))
    assert all(torch.equal(r0["model"][k], r1["model"][k]) for k in r0["model"])


def test_train_cli_sync_first_loss_is_one_process(train_ranks, one_process_train):
    """The global batch of 8 over two ranks: sync's first loss is that of the
    same command line in one process; per_shard's is not (its statistics
    come from 4 rows)."""
    _, losses = one_process_train
    np.testing.assert_allclose(train_ranks[0]["sync"]["losses"][0], losses[0], rtol=1e-5)
    assert train_ranks[0]["per_shard"]["losses"][0] != pytest.approx(losses[0], rel=1e-5)


def _parse(out: str) -> dict:
    vals = {}
    for line in out.splitlines():
        key, sep, value = line.partition(":")
        if sep and key.strip().startswith(("Avg_", "AVG_")):
            vals[key.strip()] = float(value)
    return vals


@pytest.fixture(scope="module")
def eval_ranks(launched, data, tmp_path_factory):
    """(the ranks' runs, one process's runs of the same command lines)."""
    from dffx_torch.eval import real_scenes, test

    want = []
    for i, run in enumerate(_eval_runs(data)):
        out = str(tmp_path_factory.mktemp(f"one_eval{i}"))
        argv = [a.replace("{out}", out) for a in run["argv"]]
        argv = argv[:argv.index("--spatial")]
        module = real_scenes if run["cli"] == "real_scenes" else test
        with fx.recording_forwards(module) as kept:
            printed = fx.run_cli(module.main, argv)
        want.append({"out": printed, "kept": kept})
    return launched["eval"].result(), want


@pytest.mark.parametrize("run", [0, 1], ids=["test", "real_scenes"])
def test_spatial_eval_cli_matches_one_process(eval_ranks, run):
    ranks, want = eval_ranks
    got, quiet = ranks[0][run], ranks[1][run]
    assert quiet["files"] == [] and quiet["out"] == ""
    assert got["files"] and "AVG_time" in got["out"]
    metrics, ref = _parse(got["out"]), _parse(want[run]["out"])
    assert sorted(metrics) == sorted(ref)
    for k in ref:
        if k != "AVG_time":
            np.testing.assert_allclose(metrics[k], ref[k], rtol=RTOL, err_msg=k)
    assert len(got["kept"]) == len(want[run]["kept"]) == len(quiet["kept"])
    for g, q, r in zip(got["kept"], quiet["kept"], want[run]["kept"]):
        for a, b, c in zip(g, q, r):
            np.testing.assert_allclose(a, c, atol=ATOL, rtol=0)
            np.testing.assert_array_equal(a, b)  # both ranks hold the whole output


def test_torchrun_launch_joins_through_its_variables(data, tmp_path):
    """``torchrun --nproc_per_node 2 -m dffx_torch.eval.test --spatial 2``:
    the ranks join the group from torchrun's variables (``env://``, the store
    torchrun's agent serves) and rank 0 writes the results."""
    import subprocess
    import sys

    root, _ = data
    env = {**os.environ, "PYTHONPATH": str(w.ROOT), "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "dffx_torch.eval.test", "--dataset", "DefocusNet", "--data-root", root,
           "--results-root", f"{tmp_path}/", "--allow-random-init", "--device", "cpu",
           "--batch_size", "1", "--spatial", "2"]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "backend gloo" in proc.stdout and proc.stdout.count("AVG_time") == 1
    assert sorted(os.listdir(tmp_path / "DefocusNet" / "Depth")) == ["0.jpg", "1.jpg"]


@pytest.mark.parametrize("module", ["test", "real_scenes"])
def test_spatial_flags_exclude_each_other_as_in_dffx(module, capsys):
    import importlib

    argv = ["--spatial", "2", "--spatial-pallas", "--spatial-xla"]
    errors = []
    for pkg in ("dffx", "dffx_torch"):
        main = importlib.import_module(f"{pkg}.eval.{module}").main
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2
        errors.append(capsys.readouterr().err.splitlines()[-1].split("error: ")[-1])
    assert errors[0] == errors[1] == "--spatial-pallas and --spatial-xla are mutually exclusive"


def test_spatial_needs_as_many_processes():
    from dffx_torch.eval import TimedForward

    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2 -m dffx_torch.eval.test"):
        TimedForward(w.new_model(False), spatial=2)
