"""Training CLI — the port of ``dffx/train/cli.py``, one command line for every
recipe.

    python -m dffx_torch.train.cli --recipe DDFF --lr 1e-4
        [--saveroot train_test/] [--max_epoch N] [--load_epoch N]
        [--batch_size 4] [--cpus 10] [--data-root Datasets/] [--seed 0]
        [--steps-per-epoch N] [--remat] [--sanitize] [--device cuda|cpu]

Flag names follow the reference scripts (`train_code_DDFF.py:22-29`).  The
train step is ``dffx_torch.train.loop``'s on ``--device`` (default ``cuda``;
without a card the command raises, and ``--device cpu`` trains on the CPU);
checkpoints are written per epoch as ``saveroot/models/{epoch}.ckpt`` in
``dffx``'s format v2 (each package resumes from the other's), and TensorBoard
scalars under ``saveroot/logs`` with the reference's tag names.  On the card
cuDNN searches its convolution algorithms once per shape
(``torch.backends.cudnn.benchmark``, ``CUDNN_BENCHMARK``): the train crop is
one shape, so the search is paid once.

Not ported: ``--coordinator``, ``--num_processes``, ``--process_id`` and
``--bn_mode per_shard`` (data-parallel training over several processes,
which waits for the port of ``dffx/parallel/``; one device trains with
``dffx``'s default ``--bn_mode sync`` statistics), and ``dffx``'s persistent
compilation cache, which has no counterpart in PyTorch's eager step.
"""

from __future__ import annotations

import argparse
import math
import os
import time

import torch

from dffx_torch import checkpoint as ckpt
from dffx_torch import metrics as M
from dffx_torch.checkpoint import load_jax_params
from dffx_torch.data import Loader, device_prefetch
from dffx_torch.eval.common import cli_device
from dffx_torch.models import E2ENetwork, Network, e2e_init_params, init_params
from dffx_torch.train.loop import create_train_state, make_eval_fn, make_train_step
from dffx_torch.train.recipes import RECIPES
from dffx_torch.utils.tensorboard import SummaryWriter

#: ``torch.backends.cudnn.benchmark`` for training on the card
CUDNN_BENCHMARK = True
TRAIN_KEYS = ("fs", "depth", "focus_dists", "mask", "conf", "fovs")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _validate(eval_fn, model, dataset, recipe, writer, epoch, device):
    """Validation metrics over ``dataset``, printed and logged as ``dffx``'s."""
    sums = {m: 0.0 for m in recipe.val_metrics}
    val_time = 0.0
    n = len(dataset)
    for idx in range(n):
        s = dataset[idx]
        batch = {"fs": torch.from_numpy(s["fs"][None]).to(device),
                 "focus_dists": torch.from_numpy(s["focus_dists"][None]).to(device)}
        if recipe.e2e:
            batch["fovs"] = torch.from_numpy(s["fovs"][None]).to(device)
        _sync(device)
        t0 = time.time()
        outs = eval_fn(model, batch)
        _sync(device)
        val_time += time.time() - t0
        pred = outs[3].float().cpu().numpy()[0]
        h, w = s["unpadded"]
        pred = pred[:h, :w]
        if recipe.val_crop_rows:
            pred = pred[: recipe.val_crop_rows]
            gt = s["depth"][: recipe.val_crop_rows]
            mask = s["mask"][: recipe.val_crop_rows]
        else:
            gt, mask = s["depth"], s["mask"]
        for m in recipe.val_metrics:
            if m == "bumpiness":
                sums[m] += M.get_bumpiness(gt, pred, mask)
            elif m.startswith("accuracy"):
                sums[m] += M.mask_accuracy_k(pred, gt, int(m[-1]), mask)
            elif recipe.loss.conf_weighted:
                fn = {"mse": M.mask_mse_w_conf, "mae": M.mask_mae_w_conf}[m]
                sums[m] += fn(pred, gt, s["conf"], mask)
            else:
                sums[m] += getattr(M, f"mask_{m}")(pred, gt, mask)
    for m in recipe.val_metrics:
        label = "Avg_Bulmp" if m == "bumpiness" else f"Avg_{m}"
        print(f"{label}({epoch}) : ", sums[m] / n)
        writer.add_scalar(f"Loss/validation/DFF/{label}", sums[m] / n, epoch)
    print("AVG_time:", val_time / n)


def _with_remat_hint(step_fn, *, remat, batch_size):
    """Wrap the train step so that running out of device memory on the first
    step without ``--remat`` raises an actionable message instead of the raw
    ``torch.cuda.OutOfMemoryError``; any other error, and any error after a
    step has run, passes through unchanged."""
    ran_once = False

    def run(state, batch):
        nonlocal ran_once
        try:
            out = step_fn(state, batch)
        except torch.cuda.OutOfMemoryError as e:
            if not ran_once and not remat:
                raise RuntimeError(
                    f"[dffx_torch] train step does not fit in device memory at "
                    f"batch_size={batch_size} without rematerialization — rerun with "
                    "--remat (the stages recompute their activations in the "
                    "backward).  Original error:\n" + str(e)[:800]
                ) from e
            raise
        ran_once = True
        return out

    return run


def _new_model(recipe, seed: int, device: torch.device):
    net = E2ENetwork() if recipe.e2e else Network()
    load_jax_params(net, (e2e_init_params if recipe.e2e else init_params)(seed))
    return net.to(device)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train code: Depth from focus (dffx_torch)")
    parser.add_argument("--recipe", type=str, required=True, choices=sorted(RECIPES))
    parser.add_argument("--saveroot", default="train_test/", type=str)
    parser.add_argument("--lr", type=float, required=True)
    parser.add_argument("--max_epoch", default=None, type=int)
    parser.add_argument("--load_epoch", default=0, type=int,
                        help="epoch to resume from; -1 resumes the latest checkpoint")
    parser.add_argument("--batch_size", default=4, type=int)
    parser.add_argument("--cpus", default=10, type=int, help="decoder threads")
    parser.add_argument("--data-root", default="Datasets/", type=str)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--steps-per-epoch", default=None, type=int,
                        help="cap train steps per epoch (smoke tests)")
    parser.add_argument("--remat", nargs="?", const="on", default="off", choices=["on"],
                        help="recompute stage activations in the backward "
                             "(torch.utils.checkpoint around dffx's stages): less "
                             "device memory a step, for larger batches")
    parser.add_argument("--sanitize", action="store_true",
                        help="count NaN/Inf in the gradients every step and fail "
                             "fast with the offending tensors' names instead of "
                             "training on into garbage (dffx_torch.utils.sanitize)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the model trains; 'cpu' only when asked")
    args = parser.parse_args(argv)

    device = cli_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = CUDNN_BENCHMARK
    recipe = RECIPES[args.recipe]
    max_epoch = args.max_epoch if args.max_epoch is not None else recipe.max_epoch
    root = args.saveroot
    os.makedirs(os.path.join(root, "models"), exist_ok=True)
    writer = SummaryWriter(os.path.join(root, "logs"))

    train_ds, val_ds = recipe.make_datasets(args.data_root, args.seed)

    auto_resume = args.load_epoch == -1
    if auto_resume:
        # crash recovery: resume from the newest checkpoint on disk
        existing = sorted(
            (int(f.split(".")[0]) for f in os.listdir(os.path.join(root, "models"))
             if f.endswith(".ckpt") and f.split(".")[0].isdigit()),
            reverse=True,
        )
        args.load_epoch = existing[0] if existing else 0
        print(f"[dffx_torch] auto-resume from epoch {args.load_epoch}")
    # Auto-resume loads ANY saved epoch (>= 1); only the explicit reference
    # flag keeps the reference's `load_epoch > 1` quirk (train_code_DDFF.py:63)
    # — otherwise a crash right after the first save would silently restart
    # from random weights while printing "auto-resume from epoch 1".
    state = create_train_state(_new_model(recipe, args.seed, device), lr=args.lr)
    if args.load_epoch >= 1 if auto_resume else args.load_epoch > 1:
        ckpt.restore(os.path.join(root, "models", f"{args.load_epoch}.ckpt"), state)

    remat = args.remat == "on"
    step_fn = make_train_step(args.lr, recipe.loss, e2e=recipe.e2e, remat=remat,
                              sanitize=args.sanitize)
    step_fn = _with_remat_hint(step_fn, remat=remat, batch_size=args.batch_size)
    eval_fn = make_eval_fn(e2e=recipe.e2e)

    start = time.time()
    # loss sums accumulate across print_epoch epochs, like the reference
    # (train_code_HCI.py prints/averages every 10 epochs)
    sums = dict(total=0.0, mid=0.0, l1=0.0, l2=0.0, l3=0.0, steps=0.0)
    pending_save = None
    for epoch in range(args.load_epoch, max_epoch + 1):
        if epoch % recipe.save_epoch == 0 and epoch != args.load_epoch:
            if pending_save is not None:
                pending_save.wait()
            pending_save = ckpt.save_async(os.path.join(root, "models", f"{epoch}.ckpt"), state)
        if epoch % recipe.test_epoch == 0:
            _validate(eval_fn, state.model, val_ds, recipe, writer, epoch, device)

        loader = Loader(train_ds, args.batch_size, shuffle=True, drop_last=True,
                        num_threads=args.cpus, seed=args.seed + epoch)
        steps = 0
        for _, batch in device_prefetch(iter(loader), device, TRAIN_KEYS):
            state, logs = step_fn(state, batch)
            loss = float(logs["loss"])
            if args.sanitize and (not math.isfinite(loss) or int(logs["nonfinite_grads"])):
                from dffx_torch.utils.sanitize import raise_nonfinite

                named = dict(state.model.named_parameters())
                raise_nonfinite(
                    f"non-finite numerics at step {state.step} "
                    f"(loss={loss}, nonfinite grad elements={int(logs['nonfinite_grads'])})",
                    {"grads": {k: p.grad for k, p in named.items()}, "batch": batch,
                     "params": named},
                )
            sums["total"] += loss
            sums["mid"] += float(logs["mid_loss"])
            sums["l1"] += float(logs["loss1"])
            sums["l2"] += float(logs["loss2"])
            sums["l3"] += float(logs["loss3"])
            sums["steps"] += 1.0
            steps += 1
            if args.steps_per_epoch and steps >= args.steps_per_epoch:
                break

        if epoch % recipe.print_epoch == 0:
            # actual accumulated steps, not num_train * print_epoch — the two
            # agree in the reference-shaped run, but --steps-per-epoch caps an
            # epoch short and would otherwise deflate the printed average
            denom = max(sums["steps"], 1.0)
            print("Epoch:", epoch)
            print("AVG_DFF_TotalLoss:", sums["total"] / denom)
            print("Time:", time.time() - start)
            writer.add_scalar("Loss/train/Total loss", sums["total"] / denom, epoch)
            writer.add_scalar("Loss/train/Mid loss", sums["mid"] / denom, epoch)
            writer.add_scalar("Loss/train/First/L1 loss", sums["l1"] / denom, epoch)
            writer.add_scalar("Loss/train/Second/L1 loss", sums["l2"] / denom, epoch)
            writer.add_scalar("Loss/train/Third/L1 loss", sums["l3"] / denom, epoch)
            start = time.time()
            sums = dict(total=0.0, mid=0.0, l1=0.0, l2=0.0, l3=0.0, steps=0.0)

    if pending_save is not None:
        pending_save.wait()
    writer.close()


if __name__ == "__main__":
    main()
