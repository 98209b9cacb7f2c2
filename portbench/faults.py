"""Faults planted under the timed path, to show that the comparison catches
them: the CPU tests plant each fault a cell can have and see ``correct``
come out false; ``calibrate.py`` reads them on the card at the cell's own
size.  ``plant(name, ...)`` patches the program in this process and returns
the function that takes the patch out.

* ``answer``: each forward's depth map (the network's output ``DEPTH``,
  pred3 of DFFNet and E2E) altered where it is produced: moved by a
  twentieth of the focus range;
* ``half``: half of the batch left out: a forward computes the first half
  and repeats it; a train step runs on the first half's rows alone, its
  loss the mean over them;
* ``unchanged``: a train step that returns its state unchanged: parameters
  and BatchNorm statistics as they were before it;
* ``exchange``: the exchange between cards left out: each rank keeps its own
  gradients (no all-reduce of the gradients).
"""

from __future__ import annotations

from typing import Callable

import torch

FAULTS = ("answer", "half", "unchanged", "exchange")


def _serving(fault: str, depth: int) -> Callable[[], None]:
    from dffx_torch.eval.common import TimedForward

    real = TimedForward.__call__

    def broken(self, fs, focus_dists, *extra):
        if fault == "half" and len(fs) > 1:
            h = len(fs) // 2
            outs = real(self, fs[:h], focus_dists[:h], *[e[:h] for e in extra])
            return tuple(torch.cat([o, o[: len(fs) - h]]) for o in outs)
        outs = list(real(self, fs, focus_dists, *extra))
        fd = torch.as_tensor(focus_dists)
        outs[depth] = outs[depth] + ((fd.max() - fd.min()) / 20).to(outs[depth])
        return tuple(outs)

    TimedForward.__call__ = broken

    def undo():
        TimedForward.__call__ = real

    return undo


def _train(fault: str) -> Callable[[], None]:
    import dffx_torch.train as train_pkg

    real_make = train_pkg.make_train_step

    def make(*args, **kw):
        real = real_make(*args, **kw)

        def step(state, batch):
            if fault == "half":
                h = len(batch["fs"]) // 2
                return real(state, {k: v[:h] for k, v in batch.items()})
            kept = {k: v.clone() for k, v in state.model.state_dict().items()}
            state, logs = real(state, batch)
            state.model.load_state_dict(kept)
            return state, logs

        return step

    train_pkg.make_train_step = make

    def undo():
        train_pkg.make_train_step = real_make

    return undo


def _exchange() -> Callable[[], None]:
    from dffx_torch.train import loop

    real = loop._sum_grads
    loop._sum_grads = lambda params, group: None

    def undo():
        loop._sum_grads = real

    return undo


def plant(name: str, training: bool, depth: int) -> Callable[[], None]:
    """Patch fault ``name`` into the program's serving entry or train step;
    ``depth``: the index of the depth map among a forward's outputs."""
    if name not in FAULTS:
        raise ValueError(f"no fault {name!r}; the faults are {FAULTS}")
    if name == "exchange":
        return _exchange()
    return _train(name) if training else _serving(name, depth)
