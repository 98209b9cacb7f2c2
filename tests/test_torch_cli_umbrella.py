"""``python -m dffx_torch``, the port's front door, and its ``doctor``.

Dispatch reaches each of the five subcommands' real parsers; usage,
``--version`` and an unknown command exit 0, 0 and 2.  ``doctor`` on a
machine without a card fails its device row with the reason and exits 1,
and imports no JAX; its host-library row warns where a codec unit is absent
and fails where the library cannot build.
"""

import subprocess
import sys
from pathlib import Path

import pytest

from dffx_torch.__main__ import _COMMANDS
from dffx_torch.__main__ import main as umbrella
from dffx_torch.data import _host_build, native
from dffx_torch.utils import doctor

ROOT = Path(__file__).resolve().parent.parent
COMMANDS = ("eval", "real-scenes", "train", "simulate", "doctor")


def test_usage_and_version_exit_zero(capsys):
    assert umbrella([]) == 0
    out = capsys.readouterr().out
    assert "usage: python -m dffx_torch" in out
    for cmd in COMMANDS:
        assert f"  {cmd}" in out
    assert umbrella(["--version"]) == 0
    assert capsys.readouterr().out.strip() == "dffx_torch 0.1.0"


def test_unknown_command_exits_two(capsys):
    assert umbrella(["frobnicate"]) == 2
    assert "unknown command: 'frobnicate'" in capsys.readouterr().err


def test_commands_route_to_the_port():
    assert tuple(_COMMANDS) == COMMANDS
    assert {cmd: mod for cmd, (mod, _) in _COMMANDS.items()} == {
        "eval": "dffx_torch.eval.test", "real-scenes": "dffx_torch.eval.real_scenes",
        "train": "dffx_torch.train.cli", "simulate": "dffx_torch.sim.simulator",
        "doctor": "dffx_torch.utils.doctor"}


@pytest.mark.parametrize("cmd", COMMANDS)
def test_dispatch_reaches_the_real_parser(cmd, capsys):
    """argparse's --help exits 0 from inside the dispatched module's parser:
    the lazy import and the ``main(rest)`` handoff reach the real command."""
    with pytest.raises(SystemExit) as e:
        umbrella([cmd, "--help"])
    assert e.value.code == 0
    assert "--device" in capsys.readouterr().out or cmd == "doctor"


def test_module_execution_prints_the_version():
    proc = subprocess.run([sys.executable, "-m", "dffx_torch", "--version"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "dffx_torch 0.1.0"


def test_doctor_rows_on_this_machine(capsys):
    import torch

    rows = {name: (status, detail) for name, status, detail in doctor.collect()}
    for core in ("dffx_torch", "python", "torch", "numpy", "exr codec"):
        assert rows[core][0] == doctor.OK, (core, rows[core])
    assert "jax" not in rows and "csrc/libdffxio" not in rows
    assert set(rows) >= {"cuda device", "nvcc", "kernel library", "host library", "h5py",
                         "cv2", "scipy", "imageio"}
    status, detail = rows["host library"]
    built = native.library().build
    assert str(built.path) in detail and all(u in detail for u in built.units)
    assert status == (doctor.WARN if built.absent else doctor.OK), detail
    if torch.cuda.is_available():
        pytest.skip("a card is here: chip_smoke.py runs doctor on it")
    status, detail = rows["cuda device"]
    assert status == doctor.FAIL and "no CUDA device" in detail and "--device cpu" in detail
    assert umbrella(["doctor"]) == 1
    out = capsys.readouterr().out
    assert "[FAIL]  no CUDA device" in out and out.rstrip().endswith("CORE CHECKS FAILED")


@pytest.mark.parametrize("absent,status", [({}, doctor.OK),
                                           ({"tiff": ("tiffio.h",)}, doctor.WARN),
                                           ({"codec": ("jpeglib.h", "png.h"),
                                             "tiff": ("tiffio.h",)}, doctor.WARN),
                                           (None, doctor.FAIL)])
def test_doctor_host_library_row(monkeypatch, absent, status):
    """The row names the library, its units and each absent unit's missing
    headers and the formats ``cv2`` decodes instead; a failed build fails it."""
    def library():
        if absent is None:
            raise _host_build.BuildError("g++ not found on PATH: ...")
        units = tuple(u for u in _host_build.UNITS if u not in absent)
        return native.HostLibrary(None, _host_build.HostBuild(Path("/x/lib.so"), units,
                                                              absent, 0.0))

    monkeypatch.setattr(native, "library", library)
    name, got, detail = doctor._host_library_row()
    assert (name, got) == ("host library", status)
    if absent is None:
        assert detail == "cannot build: g++ not found on PATH: ..."
        return
    assert detail.startswith("/x/lib.so with normalize")
    for unit, headers in absent.items():
        assert f"{unit} (no {', '.join(headers)})" in detail
    assert ("cv2 decodes" in detail) == bool(absent)
    if "codec" in absent:
        assert detail.endswith("cv2 decodes jpeg, png, tiff")


def test_doctor_imports_no_jax():
    """``python -m dffx_torch doctor`` in a process of its own: it exits 1
    without a card and leaves ``jax`` out of ``sys.modules``."""
    code = ("import sys; from dffx_torch.__main__ import main; rc = main(['doctor']); "
            "print('jax loaded:', 'jax' in sys.modules); sys.exit(rc)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert "jax loaded: False" in proc.stdout, proc.stdout + proc.stderr
    import torch

    assert proc.returncode == (0 if torch.cuda.is_available() else 1), proc.stdout
