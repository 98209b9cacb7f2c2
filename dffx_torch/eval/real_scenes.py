"""End-to-end eval CLI — the port of ``dffx/eval/real_scenes.py`` (the
reference's `End_to_End/test_real_scenes.py`): alignment + depth on real
focal-stack folders; writes per-slice warped PNGs and a min-max-normalized jet
depth JPEG.

    python -m dffx_torch.eval.real_scenes [--data-root Datasets/]
        [--checkpoint check_point.pth] [--out test/] [--dtype fp32|bf16]
        [--allow-random-init] [--device cuda|cpu]

The forward runs on ``--device`` (default ``cuda``; without a card the command
raises, and ``--device cpu`` runs it on the CPU).  Not ported: ``--spatial``,
``--spatial-pallas`` and ``--spatial-xla`` (the H-sharded multi-device
forward, which waits for the port of ``dffx/ops/halo.py``), and ``dffx``'s
persistent compilation cache, which has no counterpart in PyTorch's eager
forward.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from dffx_torch.data import RealScenesDataset
from dffx_torch.data.native import require
from dffx_torch.eval.common import (
    TimedForward,
    checkpoint_or_seed,
    cli_device,
    load_params_auto,
    save_jet,
)

USER = "python -m dffx_torch.eval.real_scenes"


def main(argv=None):
    parser = argparse.ArgumentParser(description="dffx_torch end-to-end real-scene eval")
    parser.add_argument("--data-root", type=str, default="Datasets/")
    parser.add_argument("--checkpoint", type=str, default="check_point.pth")
    parser.add_argument("--out", type=str, default="test/")
    parser.add_argument("--dtype", choices=["fp32", "bf16"], default="fp32")
    parser.add_argument("--allow-random-init", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the forward runs; 'cpu' only when asked")
    args = parser.parse_args(argv)

    device = cli_device(args.device)
    cv2 = require("cv2", f"the warped PNGs of {USER}")
    source = checkpoint_or_seed(args.checkpoint, allow_random=args.allow_random_init)
    dtype = torch.float32 if args.dtype == "fp32" else torch.bfloat16
    fwd = TimedForward(load_params_auto(source, device=device, e2e=True), dtype=dtype)
    dataset = RealScenesDataset(root=args.data_root)

    for idx in range(len(dataset)):
        sample = dataset[idx]
        outs = fwd(sample["fs"][None], sample["focus_dists"][None], sample["fovs"][None])
        depth = outs[3].float().cpu().numpy()[0]
        warped = outs[4].float().cpu().numpy()[0]  # (N, H, W, 3)
        h, w = sample["unpadded"]

        wr_dir = os.path.join(args.out, "warped_result", str(idx))
        os.makedirs(wr_dir, exist_ok=True)
        warped_u8 = np.clip(127.5 * (warped + 1.0), 0, 255).astype(np.uint8)
        for i in range(warped.shape[0]):
            cv2.imwrite(os.path.join(wr_dir, f"{i}.png"), warped_u8[i, :h, :w])

        dmin, dmax = float(depth.min()), float(depth.max())
        norm = (depth - dmin) / max(dmax - dmin, 1e-12)
        save_jet(os.path.join(args.out, "depth", f"{idx}.jpg"), norm[:h, :w], USER)
    print("AVG_time:", fwd.avg_time)


if __name__ == "__main__":
    main()
