"""Several processes, one rank each: the process group, the rank's device, and
the collectives the port runs on tensors of that device.

The port's counterpart of ``dffx/parallel/distributed.py``.  ``dffx`` runs one
controller per host and compiles its collectives from shardings; PyTorch runs
one process per rank, each with its own device, and calls the collectives
itself (``torch.distributed``).  Usage, one process a rank:

    from dffx_torch.parallel import distributed, make_mesh
    device = distributed.initialize("host0:1234", num_processes=4,
                                    process_id=rank)   # or DFFX_* / torchrun's
    mesh = make_mesh()                                  # all ranks on ``data``
    batch = distributed.global_batch(local_batch, device)

or ``torchrun --nproc_per_node 4 -m dffx_torch.train.cli ...``, whose
variables ``initialize`` reads when no argument and no ``DFFX_*`` variable
names the group.

**The backend rule** (``backend_for``): NCCL when every rank has a card of its
own, gloo otherwise: on the CPU, and where the ranks of one host outnumber its
cards and so share them.  NCCL refuses two ranks on one card.

**Gloo carries host tensors.**  Gloo's point-to-point calls and most of its
collectives take no CUDA tensor, so on a gloo group every collective of this
module copies a CUDA payload to the host, runs there and copies the result
back (``traffic["host_staged"]`` counts those bytes).  The compute stays on
the card; this is the transport the backend rule implies, not a fallback.
NCCL moves CUDA tensors directly.

``traffic`` counts the bytes each kind of collective moved on this rank since
``reset_traffic()``; each all-reduce, broadcast and all-gather is also the
span ``collective.<kind>`` (``utils/profiling.py``).
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dffx_torch.utils import profiling

_ENV_COORD = "DFFX_COORDINATOR"
_ENV_NPROC = "DFFX_NUM_PROCESSES"
_ENV_PID = "DFFX_PROCESS_ID"

#: a rendezvous or collective that waits longer than this fails instead of
#: hanging; above the longest validation the primary runs while the other
#: ranks wait in their next collective (``train/cli.py``)
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)

#: bytes moved by this rank since ``reset_traffic()``: payloads of all-reduces,
#: broadcasts, all-gathers (this rank's part) and halo rows sent; and the
#: bytes copied to the host and back for gloo (``_staged``)
traffic = {"all_reduce": 0, "broadcast": 0, "all_gather": 0, "halo": 0, "host_staged": 0}



def reset_traffic() -> None:
    for k in traffic:
        traffic[k] = 0


def backend_for(device: torch.device, ranks_on_host: int) -> str:
    """NCCL when every rank of this host has a card of its own, else gloo
    (the CPU, or ranks that share a card)."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if ranks_on_host <= torch.cuda.device_count() else "gloo"


def _init_method(coordinator: str) -> str:
    """``host:port`` as ``dffx`` takes it, or an init URL (``file://...``)."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def group_arguments(coordinator: Optional[str], num_processes: Optional[int],
                    process_id: Optional[int], env) -> tuple:
    """``(coordinator, num_processes, process_id)``: each argument, else its
    ``DFFX_*`` variable in ``env``, else ``torchrun``'s (``WORLD_SIZE``,
    ``RANK``; its ``MASTER_ADDR`` and ``MASTER_PORT`` as ``env://``, which
    joins the store torchrun's agent already serves there), else None."""
    coordinator = coordinator or env.get(_ENV_COORD)
    if coordinator is None and "MASTER_ADDR" in env:
        coordinator = "env://"
    if num_processes is None:
        num_processes = next((int(env[k]) for k in (_ENV_NPROC, "WORLD_SIZE") if k in env), None)
    if process_id is None:
        process_id = next((int(env[k]) for k in (_ENV_PID, "RANK") if k in env), None)
    return coordinator, num_processes, process_id


def initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device="cuda",
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """Join the process group and return this rank's device; a single process
    (no coordinator and no process count anywhere) joins none and gets
    ``device`` back.

    Each argument falls back to ``DFFX_COORDINATOR`` / ``DFFX_NUM_PROCESSES``
    / ``DFFX_PROCESS_ID``, and those to the variables ``torchrun`` sets
    (``group_arguments``).  ``coordinator`` is ``host:port`` (rank 0 serves
    the rendezvous there) or an init URL (``file:///path``, ``env://``).  On ``device``
    "cuda" rank r runs on ``cuda:(local_rank % device_count)``, local_rank
    being torchrun's ``LOCAL_RANK`` or else r; the backend follows
    ``backend_for``, with the host's rank count from ``LOCAL_WORLD_SIZE`` or
    else all ranks, and rank 0 prints it once.  ``timeout`` bounds the
    rendezvous and every collective."""
    env = os.environ
    coordinator, num_processes, process_id = group_arguments(coordinator, num_processes,
                                                             process_id, env)
    device = torch.device(device)
    if coordinator is None and num_processes is None:
        return device
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(f"a process group needs a coordinator, a process count and a "
                         f"process id; got {coordinator!r}, {num_processes!r}, {process_id!r}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda: no CUDA device is available")
        local = int(env.get("LOCAL_RANK", process_id))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = backend_for(device, int(env.get("LOCAL_WORLD_SIZE", num_processes)))
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=_init_method(coordinator),
                            world_size=num_processes, rank=process_id, timeout=timeout, **kw)
    if process_id == 0:
        print(f"[dffx_torch] {num_processes} processes, backend {backend} "
              f"({'a card a rank' if backend == 'nccl' else 'host tensors'})", flush=True)
    return device


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that writes checkpoints, logs and results: rank 0."""
    return process_index() == 0


def global_batch(local: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """This rank's slice of the global batch on its device.  PyTorch has no
    global tensor spread over processes (``dffx`` assembles one with
    ``jax.make_array_from_process_local_data``): each rank keeps its own rows,
    the ranks' slices concatenating in rank order, and the collectives of the
    train step make the result that of the global batch."""
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in local.items()}


# ---------------------------------------------------------------------------
# collectives on this rank's tensors
# ---------------------------------------------------------------------------


def _on_host(group) -> bool:
    return dist.get_backend(group) == dist.Backend.GLOO


def _staged(t: torch.Tensor, group, run, kind: str) -> torch.Tensor:
    """``run(payload)`` on ``t``'s data, as the span ``collective.<kind>``;
    on a gloo group a CUDA tensor goes to the host for it and back (the
    backend takes host tensors).  Returns the payload as ``run`` left it, on
    ``t``'s device."""
    with profiling.span(f"collective.{kind}", t.device):
        if t.is_cuda and _on_host(group):
            host = t.detach().cpu()
            run(host)
            traffic["host_staged"] += 2 * host.numel() * host.element_size()
            return host.to(t.device)
        payload = t.contiguous()
        run(payload)
        return payload


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns it."""
    traffic["all_reduce"] += t.numel() * t.element_size()
    out = _staged(t, group, lambda p: dist.all_reduce(p, group=group), "all_reduce")
    if out is not t:
        t.copy_(out)
    return t


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` of global rank ``src`` into ``t`` of every rank of ``group``."""
    traffic["broadcast"] += t.numel() * t.element_size()
    out = _staged(t, group, lambda p: dist.broadcast(p, src=src, group=group),
                  "broadcast")
    if out is not t:
        t.copy_(out)
    return t


def all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` (all of one shape), concatenated along ``dim`` in
    group-rank order."""
    traffic["all_gather"] += t.numel() * t.element_size()
    n = dist.get_world_size(group)
    parts: List[torch.Tensor] = []

    def gather(p):
        parts[:] = [torch.empty_like(p) for _ in range(n)]
        dist.all_gather(parts, p, group=group)

    _staged(t, group, gather, "all_gather")
    if t.is_cuda and _on_host(group):
        traffic["host_staged"] += (n - 1) * t.numel() * t.element_size()
        return torch.cat(parts, dim).to(t.device)
    return torch.cat(parts, dim)


def exchange(sends: Sequence, recvs: Sequence, group) -> None:
    """Point-to-point: each ``(tensor, global rank)`` of ``sends`` goes to that
    rank, each ``(tensor, global rank)`` of ``recvs`` is filled from it, all
    posted at once and waited for.  On a gloo group the tensors are staged
    through the host."""
    staged = _on_host(group)
    sbufs, rbufs = [], []
    for t, _ in sends:
        traffic["halo"] += t.numel() * t.element_size()
        sbufs.append(t.detach().cpu() if staged and t.is_cuda else t.contiguous())
    for t, _ in recvs:
        rbufs.append(torch.empty(t.shape, dtype=t.dtype) if staged and t.is_cuda else t)
    traffic["host_staged"] += sum(b.numel() * b.element_size()
                                  for b, (t, _) in zip(sbufs + rbufs, list(sends) + list(recvs))
                                  if b.device != t.device)
    ops = [dist.P2POp(dist.isend, b, peer, group) for b, (_, peer) in zip(sbufs, sends)]
    ops += [dist.P2POp(dist.irecv, b, peer, group) for b, (_, peer) in zip(rbufs, recvs)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for b, (t, _) in zip(rbufs, recvs):
        if b is not t:
            t.copy_(b)
