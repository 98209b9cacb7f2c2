"""Numerics and concurrency sanitizers: the host half of
``dffx/utils/sanitize.py``.

* **Non-finite detection** counts in the train step
  (``make_train_step(sanitize=True)`` -> ``logs["nonfinite_grads"]``, one
  reduction on the device); only a triggered failure pays for the walk over
  the tensors that names the bad ones (``finite_report``, ``raise_nonfinite``).
* **Race detection is differential**: the threaded ``Loader`` must be bitwise
  equal to its own single-threaded execution and to a re-run of itself
  (``check_loader_determinism``); ``thread_guard`` catches worker threads
  leaked across an epoch (the failure mode of a prefetch that does not release
  its producer on early exit).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch


# --------------------------------------------------------------------------
# numerics
# --------------------------------------------------------------------------


def _leaves(tree: Any, path: str = ""):
    """``(keystr-like path, leaf)`` of nested dicts, lists and tuples, with
    ``dffx``'s path format (``['fs']``, ``[0]``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def finite_report(tree: Any) -> Dict[str, Tuple[int, int]]:
    """``{leaf_path: (n_nonfinite, size)}`` for every floating tensor or array
    of ``tree`` (nested dicts, lists, tuples) that holds a NaN or Inf.  Copies
    each floating leaf to the host: call it after a trigger, never per step."""
    bad: Dict[str, Tuple[int, int]] = {}
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().float().cpu().numpy() if leaf.is_floating_point() else None
        arr = None if leaf is None else np.asarray(leaf)
        if arr is None or not np.issubdtype(arr.dtype, np.floating):
            continue
        n = int(np.sum(~np.isfinite(arr)))
        if n:
            bad[path] = (n, arr.size)
    return bad


class NonFiniteError(RuntimeError):
    """Raised by the train-loop sanitizer; carries the per-leaf report."""

    def __init__(self, message: str, report: Dict[str, Dict[str, Tuple[int, int]]]):
        self.report = report
        lines = [message]
        for group, leaves in report.items():
            for name, (n, size) in sorted(leaves.items(), key=lambda kv: -kv[1][0]):
                lines.append(f"  {group}{name}: {n}/{size} non-finite")
        if len(lines) == 1:
            lines.append(
                "  (no non-finite leaf found in the inspected trees — the bad "
                "value was transient, e.g. an inf loss from a zero mask "
                "denominator; inspect the batch source)"
            )
        super().__init__("\n".join(lines))


def raise_nonfinite(message: str, trees: Dict[str, Any]) -> None:
    """Diagnose the named trees and raise :class:`NonFiniteError`.

    ``trees`` maps a group label (``"grads"``, ``"batch"``, ``"params"``) to a
    dict of tensors; the error message lists every offending leaf, worst
    first, so the failure names the tensor — not just "loss is NaN at step k"."""
    report = {g: r for g, t in trees.items() if (r := finite_report(t))}
    raise NonFiniteError(message, report)


# --------------------------------------------------------------------------
# concurrency
# --------------------------------------------------------------------------


@contextlib.contextmanager
def thread_guard(grace_seconds: float = 2.0):
    """Assert no threads leak across the guarded block.

    Snapshot ``threading.enumerate()`` on entry; on clean exit, any *new*
    thread still alive after ``grace_seconds`` (daemon or not — a pinned
    daemon producer is still a leak, it holds its closure's buffers) raises
    ``RuntimeError`` naming the threads."""
    before = set(threading.enumerate())
    yield
    leaked = [t for t in threading.enumerate() if t not in before and t.is_alive()]
    for t in leaked:
        t.join(timeout=max(grace_seconds, 0.01))
    leaked = [t for t in leaked if t.is_alive()]
    if leaked:
        raise RuntimeError(
            "leaked threads after guarded block: "
            + ", ".join(repr(t.name) for t in leaked)
        )


def _batches_equal(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> bool:
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


def check_loader_determinism(
    loader_factory: Callable[[int], Any],
    *,
    n_batches: Optional[int] = None,
) -> int:
    """Differential race detector for threaded loaders.

    ``loader_factory(num_threads)`` must build a fresh, identically-seeded
    loader.  Three executions are compared batch-for-batch bitwise: threaded,
    threaded again (run-to-run determinism — catches unsynchronized shared
    state like a dataset-level cache or RNG), and ``num_threads=1``
    (ordering — catches completion-order yields).  Returns the number of
    batches compared; raises ``AssertionError`` naming the first divergent
    batch and keys."""

    def take(loader):
        out = []
        for i, b in enumerate(loader):
            if n_batches is not None and i >= n_batches:
                break
            out.append(b)
        return out

    threaded_a = take(loader_factory(4))
    threaded_b = take(loader_factory(4))
    serial = take(loader_factory(1))

    for tag, other in (("run-to-run", threaded_b), ("threaded-vs-serial", serial)):
        if len(threaded_a) != len(other):
            raise AssertionError(
                f"loader {tag} batch-count mismatch: {len(threaded_a)} vs {len(other)}"
            )
        for i, (x, y) in enumerate(zip(threaded_a, other)):
            if not _batches_equal(x, y):
                keys = [k for k in x if not np.array_equal(x[k], y.get(k))]
                raise AssertionError(
                    f"loader {tag} divergence at batch {i}, keys {keys} — "
                    "a decode-pool ordering or shared-state race"
                )
    return len(threaded_a)
