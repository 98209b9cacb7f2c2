"""Build the port's CUDA kernels from ``dffx_torch/csrc`` and load them.

``nvcc`` compiles every ``.cu`` source into one shared library with a plain
C interface for ``sm_90a`` (Hopper), loaded with ``ctypes``: one compile per
source, all started together, then one link.  The library
lands in ``build/kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of the sources, so an edited source builds
a new library at the first launch after the edit.  There is no fallback: a
missing ``nvcc`` or a failed compile raises, with the compiler's output.

``nvcc`` is looked up as ``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``),
then on ``PATH``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C signature of each kernel's entry point in the library
SIGNATURES = {
    # x, params, y, B, N, H, W, dtype, stream
    "dffx_fm_conv_bn_relu": [_P] * 3 + [_I] * 5 + [_P],
    # x, w1, s1, b1, w2, s2, b2, y, B, C, N, H, W, dtype, stream
    "dffx_rb2d_residual": [_P] * 8 + [_I] * 6 + [_P],
    # f, wn, w1, y, B, C, N, H, W, dtype, stream
    "dffx_srd_attention_residual": [_P] * 4 + [_I] * 6 + [_P],
    # x, params, y, B, Cin, Cout, nblocks, N, H, W, dtype, stream
    "dffx_rb_of_chain": [_P] * 3 + [_I] * 8 + [_P],
    # x, params, y, B, Cin, C, N, H, W, dtype, stream
    "dffx_motion_head_conv_chain": [_P] * 3 + [_I] * 7 + [_P],
}


class BuildError(RuntimeError):
    """``nvcc`` is missing or refused the sources."""


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdffx_torch_{h.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise BuildError(
            f"nvcc not found (looked for {cand} and on PATH): the dffx_torch CUDA "
            "kernels are built with the CUDA toolkit on the machine with the GPU"
        )
    return found


def _compile_all(nvcc: str, srcs: list[Path], out_dir: Path) -> tuple[list[Path], str]:
    """One ``nvcc -c`` per source, all running at once; raises with every failure."""
    objs = [out_dir / f"{src.stem}.o" for src in srcs]
    procs = []
    for src, obj in zip(srcs, objs):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((src, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    if failed:
        raise BuildError("\n".join(failed))
    return objs, "".join(logs)


def build() -> tuple[Path, float, str]:
    """Compile the library unless it exists; returns (path, seconds, nvcc log)."""
    out = library_path()
    log_path = out.with_suffix(".log")
    if out.is_file():
        return out, 0.0, log_path.read_text() if log_path.is_file() else ""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        objs, log = _compile_all(nvcc, [s for s in sources() if s.suffix == ".cu"],
                                 Path(tmp_dir))
        tmp = Path(tmp_dir) / out.name
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
               *(str(o) for o in objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise BuildError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                             f"{proc.stdout}{proc.stderr}")
        log_path.write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out, time.perf_counter() - t0, log


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at the first call."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
