"""Eval CLI — the port of ``dffx/eval/test.py`` (the reference's
`Depth_Estimation_Test/test.py`).

    python -m dffx_torch.eval.test --dataset DDFF [--data-root Datasets/]
        [--results-root Results_test/] [--checkpoint path.pth|path.ckpt]
        [--dtype fp32|bf16] [--allow-random-init] [--batch_size 8] [--cpus 4]
        [--device cuda|cpu] [--spatial S [--spatial-pallas | --spatial-xla]]

Same dataset dispatch, constants, metric prints (including the FlyingThings3D
second pass over DefocusNet), jet-colormap depth JPEGs (``Depth/{idx}.jpg``)
and DDFF's ``predictions.npy``.  With ``--batch_size`` above 1 the samples are
decoded by the ``Loader``'s threads, copied to the card ahead of use
(``device_prefetch``) and run through ``TimedForward`` in batches.  The
forward runs on ``--device`` (default ``cuda``; without a card the command
raises, and ``--device cpu`` runs it on the CPU).

``--spatial S`` serves each forward over S processes, one rank each, which
run the kernels' chains on their rows of H behind one halo exchange and the
rest of the forward whole (``TimedForward``, ``dffx_torch/ops/halo.py``):

    torchrun --nproc_per_node 2 -m dffx_torch.eval.test --spatial 2 --dataset DDFF ...

(or ``DFFX_COORDINATOR`` / ``DFFX_NUM_PROCESSES`` / ``DFFX_PROCESS_ID`` in
each rank's environment).  ``--spatial-pallas`` runs the kernels on the
shards (the default on the card), ``--spatial-xla`` their stock layers.
Rank 0 alone writes results and prints.  Every rank runs the rest of the
forward whole, so ``--spatial`` saves no memory and was slower than one card
at every shape measured (``PERF.md``): it is not a way to serve faster.

Not ported: ``dffx``'s persistent compilation cache, which has no
counterpart in PyTorch's eager forward.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from dffx_torch import metrics as M
from dffx_torch.data import (
    DDFFBenchmark,
    DefocusNetDataset,
    HCIDataset,
    Loader,
    MiddleburyDataset,
    SmartphoneDataset,
    device_prefetch,
)
from dffx_torch.eval.common import (
    TimedForward,
    checkpoint_or_seed,
    cli_device,
    load_params_auto,
    save_jet,
)
from dffx_torch.parallel import distributed

USER = "python -m dffx_torch.eval.test"
METRIC_NAMES = [
    ("Avg_abs_rel", M.mask_abs_rel),
    ("Avg_sq_rel", M.mask_sq_rel),
    ("Avg_mse", M.mask_mse),
    ("Avg_mae", M.mask_mae),
    ("Avg_rmse", M.mask_rmse),
    ("Avg_rmse_log", M.mask_rmse_log),
]


def _pred3(outs) -> np.ndarray:
    return outs[3].float().cpu().numpy()


def iter_preds(fwd: TimedForward, dataset, *, batch_size=1, num_threads=4):
    """Yield ``(idx, sample, pred3)`` in dataset order.

    ``batch_size > 1`` runs the forward over stacked samples: the ``Loader``
    decodes them in threads, ``device_prefetch`` copies each batch's ``fs``
    and ``focus_dists`` to the model's device while the previous batch runs.
    Each eval dataset has one fixed shape, so no shape bucketing is needed
    (Middlebury's ragged path-list shapes stay at batch 1).  Per-sample
    metric/print behaviour is unchanged; AVG_time amortizes the batch
    (TimedForward counts samples)."""
    if batch_size <= 1:
        for idx in range(len(dataset)):
            s = dataset[idx]
            yield idx, s, _pred3(fwd(s["fs"][None], s["focus_dists"][None]))[0]
        return
    loader = Loader(dataset, batch_size, shuffle=False, num_threads=num_threads)
    idx = 0
    for batch, on_device in device_prefetch(iter(loader), fwd.device, ("fs", "focus_dists")):
        p3 = _pred3(fwd(on_device["fs"], on_device["focus_dists"]))
        for b in range(p3.shape[0]):
            sample = {k: v[b] for k, v in batch.items()}
            if "unpadded" in sample:
                sample["unpadded"] = tuple(int(v) for v in sample["unpadded"])
            yield idx, sample, p3[b]
            idx += 1


def _silent(*args, **kwargs) -> None:
    """``print`` and ``save_jet`` on the ranks other than 0."""


def run_masked_eval(fwd, dataset, *, save_root, min_depth, max_depth, crop=True,
                    batch_size=1, num_threads=4, primary=True):
    sums = {name: 0.0 for name, _ in METRIC_NAMES}
    acc = {f"Avg_accuracy_{k}": 0.0 for k in (1, 2, 3)}
    n = 0
    for idx, sample, pred in iter_preds(fwd, dataset, batch_size=batch_size,
                                        num_threads=num_threads):
        gt, mask = sample["depth"], sample["mask"]
        if crop:
            h, w = sample["unpadded"]
            pred = pred[:h, :w]
        (save_jet if primary else _silent)(
            os.path.join(save_root, "Depth", f"{idx}.jpg"),
            (pred - min_depth) / (max_depth - min_depth), USER,
        )
        for name, fn in METRIC_NAMES:
            sums[name] += fn(pred, gt, mask)
        for k in (1, 2, 3):
            acc[f"Avg_accuracy_{k}"] += M.mask_accuracy_k(pred, gt, k, mask)
        n += 1
    say = print if primary else _silent
    for name, _ in METRIC_NAMES:
        say(f"{name} : ", sums[name] / n)
    for k in (1, 2, 3):
        say(f"Avg_accuracy_{k} : ", acc[f"Avg_accuracy_{k}"] / n)
    return n


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Test code: Learning Depth from focus in the wild (dffx_torch)"
    )
    parser.add_argument("--dataset", type=str, help="Test dataset")
    parser.add_argument("--data-root", type=str, default="Datasets/")
    parser.add_argument("--results-root", type=str, default="Results_test/")
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--dtype", choices=["fp32", "bf16"], default="fp32")
    parser.add_argument("--allow-random-init", action="store_true")
    parser.add_argument("--batch_size", type=int, default=8,
                        help="eval forward batch (fixed-shape datasets); "
                             "1 reproduces the reference's sample-at-a-time loop")
    parser.add_argument("--cpus", type=int, default=4, help="decoder threads")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the forward runs; 'cpu' only when asked")
    add_spatial_flags(parser)
    args = parser.parse_args(argv)
    spatial_pallas = spatial_choice(parser, args)

    device = distributed.initialize(device=cli_device(args.device))
    try:
        _evaluate(args, device, spatial_pallas)
    finally:
        distributed.shutdown()


def add_spatial_flags(parser: argparse.ArgumentParser) -> None:
    """``dffx``'s ``--spatial``, ``--spatial-pallas`` and ``--spatial-xla``."""
    parser.add_argument("--spatial", type=int, default=1,
                        help="shard each forward's H axis over this many processes, "
                             "one rank each (torchrun --nproc_per_node S): the "
                             "kernels' chains run on each rank's rows behind one "
                             "halo exchange, the rest of the forward whole; it saves "
                             "no memory and was slower than one card at every "
                             "measured shape, so it is not a way to serve faster")
    parser.add_argument("--spatial-pallas", action="store_true",
                        help="with --spatial: run the kernels on each rank's rows "
                             "(the default on the card; needs H %% (32*spatial) "
                             "== 0 at a chain, which otherwise runs whole)")
    parser.add_argument("--spatial-xla", action="store_true",
                        help="with --spatial: run the chains' stock layers in place "
                             "of the kernels (no kernel launches)")


def spatial_choice(parser: argparse.ArgumentParser, args):
    """``TimedForward``'s ``spatial_pallas`` from the flags: True, False or None
    (the default); both flags at once is ``dffx``'s error."""
    if args.spatial_pallas and args.spatial_xla:
        parser.error("--spatial-pallas and --spatial-xla are mutually exclusive")
    return True if args.spatial_pallas else (False if args.spatial_xla else None)


def _evaluate(args, device, spatial_pallas) -> None:
    primary = distributed.is_primary()
    say = print if primary else _silent
    jet = save_jet if primary else _silent
    dtype = torch.float32 if args.dtype == "fp32" else torch.bfloat16
    droot = args.data_root
    bs, cpus = args.batch_size, args.cpus

    def make_fwd(root):
        path = args.checkpoint or os.path.join(root, "check_point.pth")
        source = checkpoint_or_seed(path, allow_random=args.allow_random_init)
        return TimedForward(load_params_auto(source, device=device), dtype=dtype,
                            spatial=args.spatial, spatial_pallas=spatial_pallas)

    if args.dataset == "DefocusNet":
        root = os.path.join(args.results_root, "DefocusNet/")
        fwd = make_fwd(root)
        dataset = DefocusNetDataset(root=os.path.join(droot, "fs_6/"), mode="test")
        run_masked_eval(fwd, dataset, save_root=root, min_depth=0.1, max_depth=1.5,
                        crop=False, batch_size=bs, num_threads=cpus, primary=primary)
        say("AVG_time:", fwd.avg_time)

    elif args.dataset == "4D_Light_Field":
        root = os.path.join(args.results_root, "4D_Light_Field/")
        fwd = make_fwd(root)
        dataset = HCIDataset(h5_path=os.path.join(droot, "HCI/HCI_FS_trainval.h5"), split="val")
        run_masked_eval(fwd, dataset, save_root=root, min_depth=-2.5, max_depth=2.5,
                        crop=False, batch_size=bs, num_threads=cpus, primary=primary)
        say("AVG_time:", fwd.avg_time)

    elif args.dataset == "DDFF":
        root = os.path.join(args.results_root, "DDFF/")
        fwd = make_fwd(root)
        dataset = DDFFBenchmark(h5_path=os.path.join(droot, "DDFF/ddff-dataset-test.h5"))
        focal_length = 521.4052
        baseline = 1982.0250823695178 / 7317.020641763665 * 1e-3
        max_depth = baseline * focal_length / 0.5
        min_depth = baseline * focal_length / 7
        preds = []
        for idx, _sample, pred in iter_preds(fwd, dataset, batch_size=bs,
                                             num_threads=cpus):
            pred = pred[: dataset.HEIGHT, : dataset.WIDTH]
            preds.append(pred)
            jet(
                os.path.join(root, "Depth", f"{idx}.jpg"),
                (pred - min_depth) / (max_depth - min_depth), USER,
            )
        say("AVG_time:", fwd.avg_time)
        if primary:
            np.save(os.path.join(root, "predictions.npy"), np.stack(preds))

    elif args.dataset == "Smartphone":
        root = os.path.join(args.results_root, "Smartphone/")
        fwd = make_fwd(root)
        dataset = SmartphoneDataset(root=os.path.join(droot, "Real_data_DP/"), mode="test")
        avg_mse = avg_mae = 0.0
        n = 0
        for idx, sample, pred in iter_preds(fwd, dataset, batch_size=bs,
                                            num_threads=cpus):
            h, w = sample["unpadded"]
            pred = pred[:h, :w]
            gt, mask, conf = sample["depth"], sample["mask"], sample["conf"]
            valid = gt[conf == 1.0]
            max_depth, min_depth = np.max(valid), np.min(valid)
            jet(
                os.path.join(root, "Depth", f"{idx}.jpg"),
                (pred - min_depth) / (max_depth - min_depth), USER,
            )
            avg_mse += M.mask_mse_w_conf(pred, gt, conf, mask)
            avg_mae += M.mask_mae_w_conf(pred, gt, conf, mask)
            n += 1
        say("Avg_mse: ", avg_mse / n)
        say("Avg_mae: ", avg_mae / n)
        say("AVG_time:", fwd.avg_time)

    elif args.dataset == "FlyingThings3D":
        root = os.path.join(args.results_root, "FlyingThings3D/")
        fwd = make_fwd(root)
        dataset = MiddleburyDataset(
            list_file=os.path.join(droot, "Middlebury_FS/focal_stack/Middlebury_path.txt")
        )
        run_masked_eval(
            fwd, dataset, save_root=os.path.join(root, "Middlebury/"),
            min_depth=10, max_depth=60,
            # path-list scenes have per-scene shapes — stay sample-at-a-time
            batch_size=1, primary=primary,
        )
        say("AVG_time:", fwd.avg_time)
        # second pass over DefocusNet with range [0.1, 1.5] (`test.py:182-241`)
        dataset2 = DefocusNetDataset(root=os.path.join(droot, "fs_6/"), mode="test")
        run_masked_eval(
            fwd, dataset2, save_root=os.path.join(root, "DefocusNet/"),
            min_depth=0.1, max_depth=1.5, crop=False,
            batch_size=bs, num_threads=cpus, primary=primary,
        )
    else:
        raise SystemExit(f"unknown --dataset {args.dataset!r}")


if __name__ == "__main__":
    main()
