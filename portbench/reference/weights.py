"""The benchmark's own seeded draw of a network's weights, under the
reference's state-dict keys, made on the device in a few large calls.

Distributions (the published code's init): DFFNet's convolutions
N(0, sqrt(2 / (prod(k) * Cout))) (its MSRA loop); every other convolution
and its bias torch's default U(+-1 / sqrt(fan_in)); deconvolutions
U(+-1 / sqrt(Cout * prod(k))).  BatchNorm is drawn away from the identity,
so that folding it is exercised: weight U[0.8, 1.2), bias U[-0.1, 0.1),
running mean U[-0.1, 0.1), running variance U[0.8, 1.2).
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch

#: (low, high) of the BatchNorm draws
BN_RANGES = {"bn_weight": (0.8, 1.2), "bn_bias": (-0.1, 0.1), "bn_mean": (-0.1, 0.1),
             "bn_var": (0.8, 1.2)}


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def draw(specs: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """fp32 tensors for every key of ``specs`` (a network module's
    ``specs()``, ``portbench/networks``); counts are int64 zeros.  One
    normal and one uniform draw cover every tensor."""
    gen = generator(seed, "weights", device)
    normal = [k for k, (_, kind) in specs.items() if kind[0] == "msra"]
    uniform = [k for k, (_, kind) in specs.items() if kind[0] not in ("msra", "count")]
    sizes = {k: math.prod(specs[k][0]) for k in specs}
    z = torch.randn(sum(sizes[k] for k in normal), generator=gen, device=device)
    u = torch.rand(sum(sizes[k] for k in uniform), generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    for keys, flat in ((normal, z), (uniform, u)):
        for key, part in zip(keys, flat.split([sizes[k] for k in keys])):
            shape, kind = specs[key]
            out[key] = _scale(part, shape, kind).reshape(shape)
    for key, (shape, kind) in specs.items():
        if kind[0] == "count":
            out[key] = torch.zeros(shape, dtype=torch.int64, device=device)
    return {k: out[k] for k in specs}


def _scale(part: torch.Tensor, shape: tuple, kind: tuple) -> torch.Tensor:
    name = kind[0]
    if name == "msra":  # (Cout, Cin, *k)
        return part * math.sqrt(2.0 / (math.prod(shape[2:]) * shape[0]))
    if name in BN_RANGES:
        lo, hi = BN_RANGES[name]
        return part * (hi - lo) + lo
    bound = 1.0 / math.sqrt(kind[1])  # default, bias, deconv: U(+-1 / sqrt(fan))
    return part * (2 * bound) - bound
