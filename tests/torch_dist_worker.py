"""One rank of the port's multi-process tests: a process of its own that imports
torch and dffx_torch only, joins a gloo group on the CPU, runs one task and
writes what it computed to ``{out}/{task}_{rank}.pt``.

    python tests/torch_dist_worker.py '{"rdv": "/tmp/x/rdv", "world": 2,
        "rank": 0, "task": "train", "out": "/tmp/x"}'

The tests (``tests/test_torch_parallel.py``, ``test_torch_dp_train.py``,
``test_torch_halo.py``) start the ranks with ``launch`` and hold what they
wrote against ``dffx`` and against the port in one process.  The inputs come
from the seeded input functions here, which the tests call too."""

from __future__ import annotations

import copy
import datetime
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
#: every group's timeout, well under ``launch``'s
GROUP_TIMEOUT_S = 60
LR = 1e-3


def launch(task: str, world: int, tmp: Path, timeout: float = 120, **extra) -> list:
    """Run ``task`` on ``world`` ranks (one process each, started together),
    wait for all of them and return each rank's result; raises with the
    ranks' output if one fails."""
    tmp.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT), str(ROOT / "tests")]),
           "OMP_NUM_THREADS": "1"}
    procs = []
    for rank in range(world):
        spec = {"rdv": str(tmp / f"rdv_{task}"), "world": world, "rank": rank, "task": task,
                "out": str(tmp), **extra}
        procs.append(subprocess.Popen([sys.executable, __file__, json.dumps(spec)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if any(p.returncode for p in procs):
        raise RuntimeError("\n".join(f"--- rank {r} (rc {p.returncode}) ---\n{o}"
                                     for r, (p, o) in enumerate(zip(procs, outs))))
    return [torch.load(tmp / f"{task}_{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# seeded inputs, shared with the tests
# ---------------------------------------------------------------------------


def train_batch(seed=0, b=2, n=5, h=32, w=32, e2e=False):
    """A global train batch as numpy (``tests/test_train.py``'s at seed 0)."""
    rng = np.random.default_rng(seed)
    batch = {
        "fs": rng.uniform(-1, 1, (b, n, h, w, 3)).astype(np.float32),
        "depth": rng.uniform(0.1, 1.5, (b, h, w)).astype(np.float32),
        "focus_dists": np.tile(np.linspace(0.1, 1.5, n, dtype=np.float32), (b, 1)),
        "mask": rng.random((b, h, w)) > 0.2,
    }
    if e2e:
        batch["fovs"] = np.tile(np.linspace(1.0, 1.02, n, dtype=np.float32), (b, 1))
    return batch


E2E_BATCH = {"b": 2, "n": 10, "h": 32, "w": 32, "e2e": True}


def chain_inputs(s: int):
    """Inputs of the three chain sites at ``s`` spatial ranks, channel-first:
    the FM chain's stack, FlowNetwork's full-resolution pyramid level's and
    the full-resolution motion head's volume; H = 32 * s, so that each rank
    holds 32 rows, the least an edge rank's strip needs."""
    rng = np.random.default_rng(100 + s)
    h, w = 32 * s, 32
    return {"fm": rng.uniform(-1, 1, (1, 3, 2, h, w)).astype(np.float32),
            "of": rng.uniform(-1, 1, (1, 3, 2, h, w)).astype(np.float32),
            "head": rng.uniform(-1, 1, (1, 18, 10, h, w)).astype(np.float32)}


def stock_chain_inputs(s: int):
    """A two-conv chain's input and weight (``halo_sharded_chain`` alone)."""
    rng = np.random.default_rng(200 + s)
    x = rng.uniform(-1, 1, (1, 4, 3, 32 * s, 64)).astype(np.float32)
    k = (rng.standard_normal((4, 4, 1, 3, 3)) * 0.2).astype(np.float32)
    return x, k


def stock_chain(x, k):
    """Two zero-padded (1,3,3) convs with a ReLU between: radius 2, bleed 1."""
    y = torch.relu(torch.nn.functional.conv3d(x, k, padding=(0, 1, 1)))
    return torch.nn.functional.conv3d(y, k, padding=(0, 1, 1))


def forward_inputs(e2e: bool, h: int, w: int):
    """An eval forward's inputs (numpy): fs, focus distances, and fovs (E2E)."""
    rng = np.random.default_rng(300 + h + e2e)
    n = 10 if e2e else 5
    args = [rng.uniform(-1, 1, (1, n, h, w, 3)).astype(np.float32),
            (1.0 / np.linspace(0.2, 3.0, n)).astype(np.float32)[None]]
    if e2e:
        args.append(np.linspace(1.0, 1.02, n, dtype=np.float32)[None])
    return args


#: the rows each of two ranks holds in the unequal sync-BN task
BN_ROWS = (1, 3)


def bn_rows_inputs(dtype=np.float32):
    """Train-mode BatchNorm's operands at ``sum(BN_ROWS)`` rows: x (B, C, N,
    H, W) off zero, the gradient the loss sends into y, running statistics
    and the affine."""
    rng = np.random.default_rng(400)
    b, c = sum(BN_ROWS), 6
    return {"x": (rng.uniform(-1, 1, (b, c, 3, 5, 7)) * 2 + 0.5).astype(dtype),
            "dy": rng.uniform(-1, 1, (b, c, 3, 5, 7)).astype(dtype),
            "running_mean": rng.uniform(-0.1, 0.1, c).astype(np.float32),
            "running_var": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "weight": rng.uniform(0.5, 1.5, c).astype(dtype),
            "bias": rng.uniform(-0.5, 0.5, c).astype(dtype)}


def bn_rows_step(inputs: dict, rows: slice, group=None, device="cpu") -> dict:
    """``batch_norm_train`` on ``rows`` of ``inputs`` (over ``group``'s ranks
    where one is given) and the backward of ``sum(y * dy)``: y, the new
    running statistics and x's gradient."""
    from dffx_torch.ops import batch_norm_train

    t = {k: torch.from_numpy(v).to(device) for k, v in inputs.items()}
    x = t["x"][rows].clone().requires_grad_()
    y, mean, var = batch_norm_train(x, t["running_mean"], t["running_var"], t["weight"],
                                    t["bias"], group=group)
    (y * t["dy"][rows]).sum().backward()
    return {"y": y.detach(), "running_mean": mean, "running_var": var, "dx": x.grad}


def new_model(e2e: bool, seed: int = 0):
    from dffx_torch.checkpoint import load_jax_params
    from dffx_torch.models import E2ENetwork, Network, e2e_init_params, init_params

    net = E2ENetwork() if e2e else Network()
    return load_jax_params(net, (e2e_init_params if e2e else init_params)(seed))


def torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def in_float64(batch: dict) -> dict:
    """A numpy batch with its fp32 arrays in float64."""
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in batch.items()}


def step_record(state, logs) -> dict:
    """What the tests compare after a step: the logs, every gradient and every
    BN statistic, and the whole state (model and optimizer), from which the
    next step can be taken again in one process."""
    sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    return {"logs": {k: float(v) for k, v in logs.items()},
            "grads": {k: p.grad.detach().clone() for k, p in state.model.named_parameters()},
            "stats": {k: v for k, v in sd.items()
                      if k.endswith(("running_mean", "running_var", "num_batches_tracked"))},
            "model": sd, "optimizer": copy.deepcopy(state.optimizer.state_dict())}


# ---------------------------------------------------------------------------
# tasks
# ---------------------------------------------------------------------------


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _train_run(mesh, batches, device, *, e2e=False, bn_mode="sync", remat=False,
               dtype=torch.float32):
    from dffx_torch.parallel import shard_batch
    from dffx_torch.train import LossConfig, create_train_state, make_train_step

    state = create_train_state(new_model(e2e).to(device, dtype), LR)
    step = make_train_step(LR, LossConfig(), e2e=e2e, compute_dtype=dtype, remat=remat,
                           bn_mode=bn_mode, mesh=mesh)
    records = []
    for batch in batches:
        state, logs = step(state, shard_batch(batch, mesh, device))
        records.append(_cpu(step_record(state, logs)))
    return records


def _bn_rows(mesh, device) -> dict:
    """Sync BN with ``BN_ROWS[rank]`` rows a rank, fp32 and float64; with the
    all-reduces the layer made and their bytes."""
    from dffx_torch.ops import norm
    from dffx_torch.parallel import distributed
    from dffx_torch.parallel.mesh import DATA_AXIS

    rank = distributed.process_index()
    rows = slice(sum(BN_ROWS[:rank]), sum(BN_ROWS[:rank + 1]))
    calls = []

    def counted(t, group):
        calls.append(t.numel())
        return distributed.all_reduce_(t, group)

    out = {}
    norm.all_reduce_, plain = counted, norm.all_reduce_
    try:
        for dtype in (np.float32, np.float64):
            calls.clear()
            distributed.reset_traffic()
            rec = bn_rows_step(bn_rows_inputs(dtype), rows, mesh.group(DATA_AXIS), device)
            out[np.dtype(dtype).name] = {**rec, "all_reduces": list(calls),
                                         "bytes": distributed.traffic["all_reduce"]}
    finally:
        norm.all_reduce_ = plain
    return _cpu(out)


def task_train(spec, mesh):
    """DFFNet: sync for three steps (in fp32, and in float64), per_shard for
    three, remat sync for one; E2E: sync for one; sync BN alone on unequal
    rows (``_bn_rows``)."""
    batches = [train_batch(seed) for seed in range(3)]
    dev = spec["device"]
    return {"bn_rows": _bn_rows(mesh, dev),
            "sync": _train_run(mesh, batches, dev),
            "sync64": _train_run(mesh, [in_float64(b) for b in batches], dev,
                                 dtype=torch.float64),
            "per_shard": _train_run(mesh, batches, dev, bn_mode="per_shard"),
            "remat": _train_run(mesh, batches[:1], dev, remat=True),
            "e2e": _train_run(mesh, [train_batch(0, **E2E_BATCH)], dev, e2e=True)}


def task_halo(spec, mesh):
    """``halo_sharded_chain`` on a stock chain, and the three chain sites
    under ``spatial_serving`` (kernels' twins on the CPU, and stock layers)."""
    from dffx_torch.models.layers import spatial_serving
    from dffx_torch.ops import kernels as tk
    from dffx_torch.ops.halo import halo_sharded_chain
    from dffx_torch.parallel import distributed, spatial_sharding

    s, dev = mesh.spatial, spec["device"]
    x, k = (torch.from_numpy(a).to(dev) for a in stock_chain_inputs(s))
    rows = spatial_sharding(mesh, x.shape[3])
    local = halo_sharded_chain(lambda t: stock_chain(t, k), x[:, :, :, rows].contiguous(), mesh,
                               edge_fn=lambda t: stock_chain(t, k), bleed=1)
    from dffx_torch.parallel.mesh import SPATIAL_AXIS

    out = {"stock": distributed.all_gather_cat(local, 3, mesh.group(SPATIAL_AXIS))}
    dff, e2e = new_model(False).to(dev).eval(), new_model(True).to(dev).eval()
    flow = e2e.optical_flow_aggregation
    sites = {"fm": dff.DFF_net.FM_measure, "of": flow.OF_feature, "head": flow.conv3}
    inputs = {name: torch.from_numpy(a).to(dev) for name, a in chain_inputs(s).items()}
    distributed.reset_traffic()
    with torch.no_grad():
        for kernels in (True, False):
            tk.reset_launches()
            with spatial_serving(mesh, kernels=kernels):
                for name, module in sites.items():
                    out[f"{name}_{'kernels' if kernels else 'stock'}"] = module(inputs[name])
            out[f"launches_{'kernels' if kernels else 'stock'}"] = dict(tk.launches)
    out["traffic"] = dict(distributed.traffic)
    return _cpu(out)


def task_forward(spec, mesh):
    """Whole forwards through ``TimedForward(spatial=s)``: DFFNet at
    5 x (32 s) x 64, E2E at 10 x 64 x 96; the kernels' twins and stock.  Keys
    ``(e2e, h, w, kernels)``; ``("traffic", e2e, h, w)`` the bytes the
    kernels' forward moved."""
    from dffx_torch.eval.common import TimedForward
    from dffx_torch.ops import kernels as tk
    from dffx_torch.parallel import distributed

    s = mesh.spatial
    out = {}
    for e2e, h, w in ((False, 32 * s, 64), (True, 64, 96)):
        model = new_model(e2e).to(spec["device"]).eval()
        args = forward_inputs(e2e, h, w)
        for pallas in (True, False):
            distributed.reset_traffic()
            tk.reset_launches()
            outs = TimedForward(model, spatial=s, spatial_pallas=pallas)(*args)
            out[(e2e, h, w, pallas)] = [o.clone() for o in outs]
            out[("launches", e2e, h, w, pallas)] = dict(tk.launches)
            if pallas:
                out[("traffic", e2e, h, w)] = dict(distributed.traffic)
    return _cpu(out)


class TinyDS:
    """``n`` samples of 5 x 32 x 32 (``tests/test_torch_train_cli.py``'s)."""

    def __init__(self, n, seed=0):
        rng = np.random.default_rng(seed)
        self._samples = [
            {"fs": rng.uniform(-1, 1, (5, 32, 32, 3)).astype(np.float32),
             "depth": rng.uniform(0.1, 1.5, (32, 32)).astype(np.float32),
             "focus_dists": np.linspace(0.1, 1.5, 5, dtype=np.float32),
             "mask": np.ones((32, 32), bool), "unpadded": (32, 32)}
            for _ in range(n)]

    def __len__(self):
        return len(self._samples)

    def __getitem__(self, i):
        return self._samples[i]


def _tiny_datasets(self, root, seed):
    return TinyDS(8), TinyDS(1, seed=1)


def task_train_cli(spec, mesh):
    """The train command line once for each ``--bn_mode``, two epochs of one
    step, with ``dffx``'s flags naming the group (a fresh rendezvous file a
    run); each rank writes under its own ``--saveroot``."""
    from dffx_torch.train import cli
    from dffx_torch.train.recipes import Recipe
    from torch_fixtures import recording_train, run_cli

    Recipe.make_datasets = _tiny_datasets
    runs = {}
    for mode in ("sync", "per_shard"):
        root = Path(spec["out"]) / f"{mode}{spec['rank']}"
        argv = ["--recipe", "DDFF", "--lr", "1e-4", "--saveroot", f"{root}/",
                "--batch_size", "8", "--cpus", "2", "--steps-per-epoch", "1",
                "--max_epoch", "1", "--device", "cpu", "--bn_mode", mode,
                "--coordinator", f"file://{spec['rdv']}_{mode}",
                "--num_processes", str(spec["world"]), "--process_id", str(spec["rank"])]
        with recording_train(cli) as ran:
            printed = run_cli(cli.main, argv)
        runs[mode] = {"out": printed, "losses": ran["losses"],
                      "model": {k: v.clone() for k, v in ran["state"].model.state_dict().items()},
                      "files": sorted(str(p.relative_to(root)) for p in root.rglob("*")
                                      if p.is_file())}
    return runs


def task_eval_cli(spec, mesh):
    """The eval command lines of ``spec["runs"]`` (``{"cli": "test" |
    "real_scenes", "argv": [...]}``), one after the other, each joining a
    group of its own from ``DFFX_*`` variables; ``{out}`` in an argument is
    this rank's own results directory for the run."""
    from dffx_torch.eval import real_scenes, test
    from torch_fixtures import recording_forwards, run_cli

    runs = []
    for i, run in enumerate(spec["runs"]):
        os.environ.update({"DFFX_COORDINATOR": f"file://{spec['rdv']}_{i}",
                           "DFFX_NUM_PROCESSES": str(spec["world"]),
                           "DFFX_PROCESS_ID": str(spec["rank"])})
        module = real_scenes if run["cli"] == "real_scenes" else test
        out = Path(spec["out"]) / f"results{i}_{spec['rank']}"
        with recording_forwards(module) as kept:
            printed = run_cli(module.main, [a.replace("{out}", str(out)) for a in run["argv"]])
        runs.append({"out": printed, "kept": kept,
                     "files": sorted(str(p.relative_to(out)) for p in out.rglob("*")
                                     if p.is_file()) if out.exists() else []})
    return runs


TASKS = {"train": task_train, "halo": task_halo, "forward": task_forward,
         "train_cli": task_train_cli, "eval_cli": task_eval_cli}
#: tasks whose command line joins the group itself
SELF_JOINING = {"train_cli", "eval_cli"}


def main(spec: dict) -> int:
    from dffx_torch.parallel import distributed, make_mesh

    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    task = spec["task"]
    if task in SELF_JOINING:
        result = TASKS[task](spec, None)
    else:
        spec["device"] = distributed.initialize(
            f"file://{spec['rdv']}", spec["world"], spec["rank"], device=spec.get("device", "cpu"),
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        mesh = make_mesh(spatial=spec.get("spatial", 1))
        result = TASKS[task](spec, mesh)
        distributed.shutdown()
    torch.save(result, Path(spec["out"]) / f"{task}_{spec['rank']}.pt")
    return 0


if __name__ == "__main__":
    sys.exit(main(json.loads(sys.argv[1])))
