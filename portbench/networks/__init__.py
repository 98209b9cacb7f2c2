"""The networks the benchmark runs, one module each, found by the ``network``
name of a configuration (``load``).  A network joins the benchmark as new
files alone: ``networks/<name>.py`` and its plain reference under
``reference/``; the drivers, readers, inputs and yardstick look it up here
and branch on no name.

A network module has:

* ``SERVED``: the names of the outputs held to the reference, in the order
  in which the program and the reference return them; ``DEPTH``: the index
  of the depth map among them (what a hand-held client copies back, and
  what the ``answer`` fault alters);
* ``specs()``: every weight's key, shape and draw (``reference/weights.py``);
* ``reference(params, inputs, *, train=False)``: the plain forward, which in
  training mode updates the BatchNorm running statistics in ``params``;
* ``probe_inputs(stack, device)``: the inputs of one stack (N, H, W) that
  ``specs`` and ``yardstick.conv_flops_per_stack`` feed the reference, on
  the CPU or on ``meta`` tensors;
* ``program(config, params, device)``: the program's ``nn.Module`` on the
  benchmark's weights, in eval mode;
* ``serving_inputs(config, b, dtype, dev, gen)``: one request or batch,
  drawn from ``gen``;
* ``launches(b, stack)``: the hand kernels of one eval forward, as
  (kernel, input shape, weight shapes); ``WORK``: the work of each kernel it
  launches that ``yardstick.WORK`` does not hold, in that table's form;
  ``KERNELS``: the device-name substrings of those kernels;
* for a training cell: ``INPUT_KEYS``, the batch keys of the forward's
  inputs, in order; ``train_extras(config, b, dev)``, the batch's tensors
  beyond the DDFF batch (``inputs.train_batches``); ``train_step_args()``,
  the keyword arguments of the program's ``make_train_step`` beside ``lr``,
  ``compute_dtype`` and ``mesh``; ``TRAIN_HEADS``, the names of the first
  outputs, which the train checks compare; and ``reference_loss(outs,
  batch)``.
"""

from __future__ import annotations

import importlib
import re
from pathlib import Path
from types import ModuleType
from typing import List

NAME = re.compile(r"[a-z0-9_]+")


def available() -> List[str]:
    """The names of the network modules of this folder."""
    return sorted(p.stem for p in Path(__file__).parent.glob("*.py") if p.stem != "__init__")


def load(name: str) -> ModuleType:
    """The module ``portbench.networks.<name>``."""
    if not NAME.fullmatch(name) or name not in available():
        raise KeyError(f"no network {name!r} in portbench/networks; it has {available()}")
    return importlib.import_module(f"{__name__}.{name}")
