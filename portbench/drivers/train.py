"""Training steps: the program's train step (``make_train_step``, the DDFF
loss, Adam) fed through its ``device_prefetch`` from pinned host batches
made from the seed, on one process or, with ``world`` > 1, as one rank of a
data-parallel group (``train_dp``).  The network module
(``portbench/networks``) gives the step's arguments, the batch's keys
beyond the DDFF batch, the heads compared and the reference's loss.

Set-up builds the step with its model and optimizer state and drives it
through its first ``FOLLOWED`` steps on distinct batches through the
window's own call and feed; the window then goes on with that same state.
The reference follows those first steps from the same weights on the same
global batches (``reference/train.py``) once the window has closed.

Traffic keys: ``batch`` (global), ``dtype`` (compute), ``lr``, ``pool``
(distinct host batches, cycled), ``trace_calls``.  End to end:
``train_stacks_per_s``, the global stacks of every step of the window over
the window's seconds, ending in a synchronise (on several ranks, and a
barrier).  Spans: the host's wait in ``next()`` on the prefetch iterator;
counters: collective bytes a step on rank 0."""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Dict, Sequence

import torch

from portbench import core
from portbench.core import Run
from portbench.drivers import common
from portbench.inputs import train_batches
from portbench.reference import lowp
from portbench.reference import train as rtrain

FOLLOWED = 3  # steps the reference follows
#: a leaf whose reference gradient is under this share of the median leaf's
#: moves by round-off alone under Adam and is left out of the comparison
NOUGHT = 1e-3


def run(r: Run) -> None:
    from dffx_torch.data.pipeline import device_prefetch
    from dffx_torch.parallel import distributed, make_mesh
    from dffx_torch.train import create_train_state, make_train_step
    from dffx_torch.train.cli import CUDNN_BENCHMARK

    cfg, tr = r.cell.config, r.cell.traffic
    network = common.network(r)
    b, lr, dtype = int(tr["batch"]), float(tr["lr"]), common.DTYPES[tr["dtype"]]
    if b % r.world:
        raise ValueError(f"a global batch of {b} does not split over {r.world} ranks")
    local = b // r.world
    control = None
    if r.world > 1:
        import torch.distributed as dist

        r.device = distributed.initialize(r.coordinator, r.world, r.rank, device=r.device.type)
        control = dist.new_group(backend="gloo")
    mesh = make_mesh() if r.world > 1 else None
    common.program_device(r)
    if r.cuda:
        torch.backends.cudnn.benchmark = CUDNN_BENCHMARK
    start = common.draw_weights(r)
    r.mark("weights")
    net = common.program_network(cfg, start, r.device)
    state = create_train_state(net, lr)
    step = make_train_step(lr, compute_dtype=dtype, mesh=mesh, **network.train_step_args())
    r.mark("model and optimizer")
    batches = train_batches(cfg, b, int(tr["pool"]), r.device, r.generator("inputs"))
    r.mark("host batches")
    rows = slice(r.rank * local, (r.rank + 1) * local)
    mine = [{k: v[rows] for k, v in batch.items()} for batch in batches]

    def cycle():
        i = 0
        while True:
            yield mine[i % len(mine)]
            i += 1

    feed = device_prefetch(cycle(), r.device, tuple(batches[0]))
    first = followed_steps(state, step, feed, len(network.TRAIN_HEADS))
    r.mark("followed steps")

    bad = torch.zeros((), dtype=torch.int32, device=r.device)
    go = torch.ones(1, dtype=torch.int32)
    wait = 0.0
    steps = 0
    distributed.reset_traffic()
    r.end_setup()
    if control is not None:
        dist.barrier(group=control)
    t0 = time.perf_counter()
    while True:
        if control is None:
            if time.perf_counter() - t0 >= r.seconds:
                break
        else:  # rank 0's clock decides for every rank, over the host
            go[0] = int(time.perf_counter() - t0 < r.seconds)
            dist.broadcast(go, 0, group=control)
            if not go[0]:
                break
        w0 = time.perf_counter()
        _, on_device = next(feed)
        wait += time.perf_counter() - w0
        state, logs = step(state, on_device)
        bad += (~torch.isfinite(logs["loss"])).int()
        steps += 1
    r.sync()
    if control is not None:
        dist.barrier(group=control)
    window = time.perf_counter() - t0
    r.e2e["train_stacks_per_s"] = steps * b / window
    r.attempted, r.failed = steps, int(bad)
    r.values["prefetch_wait_ms"] = wait / max(steps, 1) * 1e3
    moved = sum(v for k, v in distributed.traffic.items() if k != "host_staged")
    r.values["collective_mb"] = moved / max(steps, 1) / 1e6
    r.values["steps"] = steps
    r.read_memory()

    if r.trace:
        k = int(tr["trace_calls"])

        def body() -> int:
            for _ in range(k):
                _, on_device = next(feed)
                step(state, on_device)
            return k * b

        r.profile(body, k)
        r.read_memory()
    feed.close()
    if control is not None:
        gathered = [None] * r.world
        mine_busy = r.slice.busy_s if r.slice else None
        dist.all_gather_object(gathered, (mine_busy, r.memory_peak), group=control)
        r.busy_s = [g[0] for g in gathered if g[0] is not None]
        r.memory_peak = max(g[1] for g in gathered)
        distributed.shutdown()
    del state, step, net, feed
    core.release()
    if r.rank == 0:
        train_checks(r, network, start, batches[:FOLLOWED], first, lr)


def followed_steps(state, step, feed, heads_count: int) -> dict:
    """The first steps through the window's call and feed, with what the
    comparison reads from them: each step's loss, the first step's first
    ``heads_count`` outputs (the depth heads) as the model returned them
    inside the step, the first gradient as Adam got it (its first moment
    after one step over 1 - beta1) and the parameters and statistics after
    the last."""
    losses = []
    grad1 = {}
    heads = []
    hook = state.model.register_forward_hook(
        lambda module, args, outs: heads.append(
            tuple(o.detach().float() for o in outs[:heads_count])))
    for i in range(FOLLOWED):
        _, on_device = next(feed)
        state, logs = step(state, on_device)
        if i == 0:
            hook.remove()
        losses.append(logs["loss"].detach().clone())
        if i == 0:
            opt = state.optimizer
            grad1 = {k: opt.state[p]["exp_avg"].detach() / (1 - rtrain.BETAS[0])
                     for k, p in state.model.named_parameters()}
    after = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    return {"losses": [float(v) for v in losses], "grad1": grad1, "after": after,
            "heads": heads[0]}


def reference_steps(network, start: Dict[str, torch.Tensor], batches, lr: float,
                    device, compute=contextlib.nullcontext) -> dict:
    """The plain reference's first steps of the network module ``network``
    from ``start`` on the global ``batches``: the same readings as
    ``followed_steps``."""
    params = {k: v.clone() for k, v in start.items()}
    opt = rtrain.Adam(lr)
    losses, grad1, heads = [], {}, ()
    for i, batch in enumerate(batches):
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        loss, grads, outs = rtrain.step(network, params, batch, opt, compute)
        losses.append(loss)
        if i == 0:
            grad1, heads = grads, outs
    return {"losses": losses, "grad1": grad1, "after": params, "heads": heads}


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's gap between the two norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    norms = {k: (float(got[k].float().norm()), float(want[k].float().norm())) for k in want}
    median = statistics.median(w for _, w in norms.values())
    return {k: abs(g - w) / max(w, median) for k, (g, w) in norms.items()}


def worst(gaps: Dict[str, float], count: int = 3) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:count])


def train_checks(r: Run, network, start, batches, program: dict, lr: float) -> None:
    """Hold the followed steps to the reference's (``readings``); with
    ``r.control`` the reference one precision below the cell's
    (``lowp.control``) is read the same way."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    want = reference_steps(network, start, batches, lr, r.device)
    rows = slice(r.rank * len(program["heads"][0]), (r.rank + 1) * len(program["heads"][0]))
    r.checks.update(readings(start, program, want, r.leaves, rows, network.TRAIN_HEADS))
    if r.control:
        low = reference_steps(network, start, batches, lr, r.device,
                              lambda: lowp.control(r.cell.traffic["dtype"]))
        low["heads"] = tuple(h[rows] for h in low["heads"])  # this rank's, as the program's
        leaves = {}
        r.control_checks.update(readings(start, low, want, leaves, rows, network.TRAIN_HEADS))
        r.leaves.update({f"control_{k}": v for k, v in leaves.items()})


def readings(start, got: dict, want: dict, leaves: Dict[str, str], rows: slice,
             heads: Sequence[str]) -> Dict[str, float]:
    """``<head>_rms``: each depth head (named by ``heads``) of the first
    step's forward against the reference's on this rank's ``rows``, as
    ``common.rms_gap``;
    ``loss``: the largest gap of a followed step's loss over the
    reference's (``loss1``..``loss3`` each step's); ``grad1`` and
    ``change``: the worst leaf's gap
    (``leaf_gaps``) of the first gradient and of the change of the
    parameters and BN statistics after the followed steps;
    ``grad1_median``: the median leaf's gap of the first gradient (the
    worst leaves go into ``leaves``).  Leaves whose reference gradient is
    nought to rounding (``NOUGHT``) are left out."""
    median = statistics.median(float(g.norm()) for g in want["grad1"].values())
    moving = [k for k, g in want["grad1"].items() if float(g.norm()) >= NOUGHT * median]
    kept = moving + [k for k in start if k.endswith(("running_mean", "running_var"))]
    grad1 = leaf_gaps({k: got["grad1"][k] for k in moving}, {k: want["grad1"][k] for k in moving})
    change = leaf_gaps({k: got["after"][k].float() - start[k] for k in kept},
                       {k: want["after"][k] - start[k] for k in kept})
    leaves["grad1"], leaves["change"] = worst(grad1), worst(change)
    losses = [abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"])]
    gaps = {}
    for name, g, w in zip(heads, got["heads"], want["heads"]):
        w = w[rows]
        gaps[f"{name}_rms"] = common.rms_gap(g, w) if g.shape == w.shape else float("inf")
    return {**gaps, "loss": max(losses), **{f"loss{i + 1}": v for i, v in enumerate(losses)},
            "grad1": max(grad1.values()), "change": max(change.values()),
            "grad1_median": statistics.median(grad1.values())}
