"""``python -m dffx_torch doctor`` — one-screen environment report for the port.

The questions that gate the port on a machine: is torch built for CUDA, is
there a card (its name and power limit, as ``nvidia-smi`` gives them), is
``nvcc`` there to build the kernels, is the kernel library already built for
the current sources, which units of the host library (the loaders' C++
decode and normalisation) this machine's headers allow, which optional data
packages are importable, and does the EXR codec round-trip.

The checks are light: nothing here builds the kernels or runs a model; the
host library is built (about a second with ``g++``) or found built.  The
exit code is 0 when every *core* row (torch, the CUDA device, ``nvcc``, the
host library, numpy, the EXR codec) is healthy; the port's entry points run
on the card and raise without one, so on a machine without a card
``doctor`` exits 1 and says why.  The host library warns where a codec unit
is absent (``cv2`` then decodes that format).  Optional rows only warn: the
reader or writer that needs a missing package raises when it runs, naming
it.
"""

from __future__ import annotations

import argparse
import platform
import subprocess
import sys
from typing import List, Tuple

OK, WARN, FAIL = "ok", "warn", "FAIL"
SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
#: optional packages and what needs each
OPTIONAL = (
    ("h5py", "the DDFF-12 and HCI readers, the simulator's NYU-v2 .mat (--nyu-mat)"),
    ("cv2", "every image reader, the simulator, the warped PNGs"),
    ("scipy", "the simulated scenes' .mat files (reader and simulator)"),
    ("imageio", "the eval command lines' depth JPEGs"),
)


def _row(name: str, status: str, detail: str) -> Tuple[str, str, str]:
    return (name, status, detail)


def _device_row(torch) -> Tuple[str, str, str]:
    if not torch.cuda.is_available():
        why = ("torch is a CPU-only build" if torch.version.cuda is None
               else "torch.cuda.is_available() is False")
        return _row("cuda device", FAIL,
                    f"no CUDA device ({why}): the port's entry points default to "
                    "the card and raise without one (pass --device cpu)")
    names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    try:
        smi = subprocess.run(SMI_QUERY, capture_output=True, text=True, timeout=30,
                             check=True).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi failed: {e}"
    return _row("cuda device", OK, f"{len(names)} device(s): {', '.join(names)} [{smi}]")


def _nvcc_row() -> Tuple[str, str, str]:
    from dffx_torch.ops import _build

    try:
        nvcc = _build.find_nvcc()
        version = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                                 timeout=60, check=True).stdout.strip().splitlines()[-1]
    except (_build.BuildError, OSError, subprocess.SubprocessError) as e:
        return _row("nvcc", FAIL, f"{e}".splitlines()[0])
    return _row("nvcc", OK, f"{nvcc}: {version}")


def _library_row() -> Tuple[str, str, str]:
    from dffx_torch.ops import _build

    lib = _build.library_path()
    if lib.is_file():
        return _row("kernel library", OK, f"built for the current sources: {lib}")
    return _row("kernel library", WARN,
                f"not built for the current sources ({lib.name}): nvcc builds it at the "
                "first kernel launch")


def _host_library_row() -> Tuple[str, str, str]:
    from dffx_torch.data import _host_build, native

    try:
        built = native.library().build
    except _host_build.BuildError as e:
        return _row("host library", FAIL, f"cannot build: {e}".splitlines()[0])
    detail = f"{built.path} with {', '.join(built.units)}"
    if not built.absent:
        return _row("host library", OK, detail)
    missing = "; ".join(f"{unit} (no {', '.join(headers)})"
                        for unit, headers in built.absent.items())
    return _row("host library", WARN, f"{detail}; absent: {missing}: cv2 decodes "
                f"{', '.join(sorted(f for u in built.absent for f in _host_build.UNITS[u].formats))}")


def _exr_row() -> Tuple[str, str, str]:
    import os
    import tempfile

    import numpy as np

    from dffx_torch.data import exr

    img = (np.arange(12, dtype=np.float32).reshape(3, 4) / 7.0).astype(np.float16)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "probe.exr")
        exr.write(p, {"R": img})
        back = exr.read(p)["R"]
    if np.array_equal(back.astype(np.float16), img):
        return _row("exr codec", OK, "fp16 round-trip exact")
    return _row("exr codec", FAIL, "round-trip mismatch")


def collect() -> List[Tuple[str, str, str]]:
    """Run every check; returns (name, status, detail) rows."""
    import dffx_torch

    rows = [_row("dffx_torch", OK, f"{dffx_torch.__version__} ({sys.prefix})"),
            _row("python", OK, f"{platform.python_version()} on {platform.machine()}")]
    try:
        import torch
    except ImportError as e:
        return rows + [_row("torch", FAIL, str(e))]
    rows.append(_row("torch", OK, f"{torch.__version__}, CUDA build "
                     f"{torch.version.cuda or 'none (CPU only)'}"))
    rows.append(_device_row(torch))
    rows.append(_nvcc_row())
    rows.append(_library_row())
    rows.append(_host_library_row())
    try:
        import numpy

        rows.append(_row("numpy", OK, numpy.__version__))
    except ImportError as e:
        rows.append(_row("numpy", FAIL, str(e)))
    try:
        rows.append(_exr_row())
    except Exception as e:  # the report goes on: one row says what broke
        rows.append(_row("exr codec", FAIL, f"{type(e).__name__}: {e}"))
    for mod, why in OPTIONAL:
        try:
            m = __import__(mod)
            rows.append(_row(mod, OK, getattr(m, "__version__", "?")))
        except ImportError:
            rows.append(_row(mod, WARN, f"not importable — needed only for: {why}"))
    return rows


def main(argv=None) -> int:
    argparse.ArgumentParser(
        prog="python -m dffx_torch doctor",
        description="Report whether this machine can run the port: torch, the CUDA "
                    "device, nvcc, the kernel library, the host library and the data "
                    "packages.").parse_args(argv)
    rows = collect()
    width = max(len(n) for n, _, _ in rows)
    worst = 0
    for name, status, detail in rows:
        print(f"  {name:<{width}}  [{status:^4}]  {detail}")
        if status == FAIL:
            worst = 1
    print("doctor:", "environment healthy" if worst == 0 else "CORE CHECKS FAILED")
    return worst


if __name__ == "__main__":
    raise SystemExit(main())
