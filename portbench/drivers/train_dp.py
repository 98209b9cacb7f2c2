"""Data-parallel training on ``ranks`` processes, one card each: the train
driver's steps under the program's ``parallel.initialize`` (NCCL on the
card), sync BatchNorm and the summed gradients, on each rank's rows of the
global batch.

The run's own process is rank 0: it starts the other ranks as child
processes of the same command (``--rank``, ``--world``, ``--coordinator``
at a free port of this host), runs its rank, waits for them, and alone
prints the result.  Traffic keys: the train driver's and ``ranks``."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

from portbench.core import ROOT, Run
from portbench.drivers import train

#: seconds a rank may take to end after rank 0's window and reference
JOIN_SECONDS = 120


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(r: Run) -> None:
    world = int(r.cell.traffic["ranks"])
    if r.coordinator is not None:  # a child rank
        r.world = world
        train.run(r)
        return
    r.world, r.coordinator = world, f"localhost:{free_port()}"
    argv = [sys.executable, "-m", "portbench.run", "--workload", r.cell.name,
            "--seed", str(r.seed), "--seconds", repr(r.seconds), "--trace", str(int(r.trace)),
            "--world", str(world), "--coordinator", r.coordinator,
            "--device", r.device.type]
    if r.overrides:
        argv += ["--overrides", json.dumps(r.overrides)]
    if r.fault:
        argv += ["--fault", r.fault]
    children = [subprocess.Popen(argv + ["--rank", str(k)], cwd=ROOT, env=dict(os.environ),
                                 stdout=sys.stderr)
                for k in range(1, world)]
    try:
        train.run(r)
        for child in children:
            code = child.wait(timeout=JOIN_SECONDS)
            if code != 0:
                raise RuntimeError(f"rank {children.index(child) + 1} exited with {code}")
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
