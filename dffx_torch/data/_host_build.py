"""Build the port's host library from ``dffx_torch/csrc/host`` with ``g++``.

The library is the loaders' normalisation and image decode in C++
(``data/native.py`` binds it with ``ctypes``), in three translation units:

* ``normalize.cc``: the uint8 -> ``x/127.5 - 1`` normalisation, the pad to
  x32 and the layout change; the C++ standard library and threads only;
  always built;
* ``codec.cc``: JPEG and PNG through libjpeg and libpng, built where ``g++``
  finds ``jpeglib.h`` and ``png.h``;
* ``tiff.cc``: TIFF through libtiff, built where it finds ``tiffio.h``.

A unit is chosen before anything compiles, by a one-line include probe
(``g++ -E``) for each header it needs; a unit whose header is missing is left
out, and ``HostBuild.absent`` names the header.  A chosen unit that fails to
compile or link raises ``BuildError`` with the compiler's output, and a
missing ``g++`` raises naming it: nothing falls back to another path.

The library lands in ``build/host/`` at the repository root (listed in
``.gitignore``), named by a hash of the chosen units' sources, the flags and
the units, so an edited source builds a new library at the first use after
the edit.  Several processes may build at once (the tests run in several
workers): a lock file serialises them, and each compiles to a temporary
name that ``os.replace`` moves into place.
"""

from __future__ import annotations

import dataclasses
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Tuple

HOST = Path(__file__).resolve().parent.parent / "csrc" / "host"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX = "g++"
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall"]


@dataclasses.dataclass(frozen=True)
class Unit:
    source: str
    headers: Tuple[str, ...]  # what the include probe must find
    libs: Tuple[str, ...]  # link flags
    formats: Tuple[str, ...]  # what the unit gives ``native.formats()``


#: the library's translation units, in link order
UNITS = {
    "normalize": Unit("normalize.cc", (), (), ("normalize",)),
    "codec": Unit("codec.cc", ("jpeglib.h", "png.h"), ("-ljpeg", "-lpng"), ("jpeg", "png")),
    "tiff": Unit("tiff.cc", ("tiffio.h",), ("-ltiff",), ("tiff",)),
}


class BuildError(RuntimeError):
    """``g++`` is missing or refused a chosen unit."""


@dataclasses.dataclass(frozen=True)
class HostBuild:
    path: Path
    units: Tuple[str, ...]  # the units the library holds
    absent: Dict[str, Tuple[str, ...]]  # unit left out -> the headers the probe missed
    seconds: float  # the compile's (0.0 where the library was already built)

    @property
    def formats(self) -> frozenset:
        return frozenset(f for u in self.units for f in UNITS[u].formats)


def find_cxx() -> str:
    found = shutil.which(CXX)
    if found is None:
        raise BuildError(f"{CXX} not found on PATH: the port's host library "
                         f"(dffx_torch/csrc/host) is built with it at first use")
    return found


def has_header(cxx: str, header: str) -> bool:
    """Whether ``cxx`` finds ``header`` on its include path (``-E`` of one
    ``#include``)."""
    proc = subprocess.run([cxx, "-E", "-x", "c++", "-"], input=f"#include <{header}>\n",
                          capture_output=True, text=True)
    return proc.returncode == 0


def choose_units(cxx: str) -> Tuple[Tuple[str, ...], Dict[str, Tuple[str, ...]]]:
    """(the units to build, {unit left out: its missing headers})."""
    chosen, absent = [], {}
    for name, unit in UNITS.items():
        missing = tuple(h for h in unit.headers if not has_header(cxx, h))
        if missing:
            absent[name] = missing
        else:
            chosen.append(name)
    return tuple(chosen), absent


def library_path(units: Tuple[str, ...]) -> Path:
    h = hashlib.sha256(" ".join([*CXXFLAGS, *units]).encode())
    for name in units:
        h.update((HOST / UNITS[name].source).read_bytes())
        h.update(" ".join(UNITS[name].libs).encode())
    return BUILD_DIR / f"libdffx_torch_host_{h.hexdigest()[:16]}.so"


def _run(cmd) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _compile(cxx: str, units: Tuple[str, ...], tmp: Path, out: Path) -> None:
    """One ``g++ -c`` per unit, all at once, then one link into ``out``."""
    objs = [tmp / f"{name}.o" for name in units]
    procs = [(cmd, _run(cmd)) for cmd in (
        [cxx, *CXXFLAGS, "-c", "-o", str(obj), str(HOST / UNITS[name].source)]
        for name, obj in zip(units, objs))]
    failed = []
    for cmd, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{CXX} failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    if failed:
        raise BuildError("\n".join(failed))
    cmd = [cxx, "-shared", "-pthread", "-o", str(out), *map(str, objs),
           *(lib for name in units for lib in UNITS[name].libs)]
    proc = _run(cmd)
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise BuildError(f"{CXX} failed ({proc.returncode}): {' '.join(cmd)}\n{log}")


def build() -> HostBuild:
    """Compile the library for the units this machine's headers allow,
    unless it exists."""
    cxx = find_cxx()
    units, absent = choose_units(cxx)
    out = library_path(units)
    if out.is_file():
        return HostBuild(out, units, absent, 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.is_file():  # another process built it while this one waited
            return HostBuild(out, units, absent, 0.0)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            part = Path(tmp) / out.name
            _compile(cxx, units, Path(tmp), part)
            os.replace(part, out)  # a reader never loads a partial file
        return HostBuild(out, units, absent, time.perf_counter() - t0)
