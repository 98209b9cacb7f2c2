"""Per-layer readings from a run's traced slice and its spans and counters,
which the readers of ``metrics/`` return.  Each returns None where the run
has nothing to read (no trace, no device work, no such kernel), never 0 for
a share of a roofline or of a peak."""

from __future__ import annotations

from typing import Optional

from portbench import yardstick
from portbench.core import Run


def _training(r: Run) -> bool:
    return r.cell.traffic["driver"].startswith("train")


def _device_slice(r: Run):
    s = r.slice
    return s if s is not None and s.busy_s > 0 and s.kernels else None


def device_idle_pct(r: Run) -> Optional[float]:
    """Share of the traced slice in which nothing ran on the card (rank 0's)."""
    s = _device_slice(r)
    return None if s is None else 100.0 * (1.0 - s.busy_s / s.window_s)


def mfu_pct(r: Run) -> Optional[float]:
    """The reference's convolution FLOPs of the slice's stacks (three times a
    forward's for a train step) over the slice's seconds at the cards' peak
    in the cell's precision (bf16 tensor cores; fp32 outside them)."""
    s = _device_slice(r)
    if s is None:
        return None
    cfg = r.cell.config
    stack = tuple(cfg["train_stack"] if _training(r) else cfg["stack"])
    flops = yardstick.conv_flops_per_stack(cfg["network"], stack) * (3 if _training(r) else 1)
    peak = yardstick.PEAK_FLOP_PER_S[r.cell.traffic["dtype"]] * r.cell.chips
    return 100.0 * flops * s.items / (s.window_s * peak)


def _seconds(r: Run, which) -> float:
    return sum(dur for name, _, dur in r.slice.kernels if which(name)) / 1e6


def _port_kernel(r: Run):
    """Whether a device kernel's name is one of the program's own hand
    kernels, by the cell's network (``yardstick.port_kernels``)."""
    kernels = yardstick.port_kernels(r.cell.config["network"])
    return lambda name: yardstick.is_port_kernel(name, kernels)


def kernels_roofline_pct(r: Run) -> Optional[float]:
    """The hand kernels' least time (``yardstick.forward_bound_s``) over the
    slice's forwards, over their device time in the slice."""
    s = _device_slice(r)
    if s is None:
        return None
    spent = _seconds(r, _port_kernel(r))
    if spent <= 0:
        return None
    cfg, tr = r.cell.config, r.cell.traffic
    bound = yardstick.forward_bound_s(cfg["network"], int(tr["batch"]), tuple(cfg["stack"]),
                                      tr["dtype"] == "bfloat16")
    return 100.0 * bound * s.calls / spent


def stock_ops_ms(r: Run) -> Optional[float]:
    """Device time of every kernel that is neither the program's own nor
    NCCL's: a stack's when serving, a step's when training."""
    s = _device_slice(r)
    if s is None:
        return None
    own = _port_kernel(r)
    spent = _seconds(r, lambda n: not (own(n) or yardstick.is_nccl_kernel(n)))
    per = s.calls if _training(r) else s.items
    return spent / per * 1e3


def collective_ms(r: Run) -> Optional[float]:
    """Device time of NCCL's kernels a step on rank 0."""
    s = _device_slice(r)
    if s is None:
        return None
    spent = _seconds(r, yardstick.is_nccl_kernel)
    return spent / s.calls * 1e3 if spent > 0 else None


def value(r: Run, key: str) -> Optional[float]:
    v = r.values.get(key)
    return None if v is None else float(v)
