"""Guards on the port's boundaries: dffx_torch imports no JAX and no dffx, and
the kernel build raises, without a fallback, when there is no nvcc."""

import ast
import os
import pathlib

import pytest
import torch

from dffx_torch.ops import _build
from dffx_torch.ops import kernels as tk
from dffx_torch.parallel import distributed

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "dffx_torch"
FORBIDDEN = {"jax", "jaxlib", "optax", "dffx"}


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_no_dffx():
    """Every module of the port, ``chip_smoke.py`` (which runs where there is
    no JAX), the test helpers it imports (``tests/torch_fixtures.py``) and the
    multi-process tests' rank (``tests/torch_dist_worker.py``)."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "tests" / "torch_fixtures.py",
                                         ROOT / "tests" / "torch_dist_worker.py"]
    assert len(files) >= 49
    for new in ("models/packed.py", "sim/simulator.py", "sim/__init__.py", "__main__.py",
                "utils/doctor.py", "utils/profiling.py", "parallel/__init__.py",
                "parallel/distributed.py", "parallel/mesh.py", "ops/halo.py",
                "data/_host_build.py", "headline.py"):
        assert PKG / new in files, new
    bad = {(f.relative_to(ROOT).as_posix(), m) for f in files for m in _imported_roots(f)
           if m in FORBIDDEN}
    assert not bad, bad


#: what a file of the port would name to load the JAX package's host library
ROOT_HOST_LIBRARY = ("libdffxio", "dffxio.cc", "csrc/Makefile")


def _code_strings(path: pathlib.Path):
    """The string constants of a module but its docstrings."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs:
            yield node.value


def test_port_loads_nothing_of_the_root_csrc():
    """No module of the port (nor ``chip_smoke.py``) names the JAX package's
    host library or its sources in code, and the port's C++ sources include
    only system headers: the port's decoder is built from
    ``dffx_torch/csrc/host`` alone."""
    from dffx_torch.data import _host_build

    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = {(f.relative_to(ROOT).as_posix(), s) for f in files for s in _code_strings(f)
           if any(name in s for name in ROOT_HOST_LIBRARY)}
    assert not bad, bad
    assert _host_build.HOST == PKG / "csrc" / "host"
    sources = sorted(_host_build.HOST.glob("*.cc"))
    assert [p.name for p in sources] == sorted(u.source for u in _host_build.UNITS.values())
    for src in sources:
        includes = [ln for ln in src.read_text().splitlines() if ln.startswith("#include")]
        assert includes and all(ln.startswith("#include <") for ln in includes), (src, includes)
    # the kernel build stays CUDA-only: the host sources are not its sources
    assert not {p for p in _build.sources() if _build.CSRC / "host" in p.parents}


def test_port_process_maps_its_own_host_library_only(tmp_path):
    """In a process of its own, the port normalises a stack and decodes a PNG
    and a JPEG: the library it maps is its own build under ``build/host``,
    and no ``libdffxio`` is mapped."""
    import subprocess
    import sys

    code = (
        "import numpy as np, cv2, sys\n"
        "from dffx_torch.data import native\n"
        "img = np.zeros((8, 8, 3), np.uint8)\n"
        "for ext in ('png', 'jpg'):\n"
        "    cv2.imwrite(f'{sys.argv[1]}/x.{ext}', img)\n"
        "    native.imread_compat(f'{sys.argv[1]}/x.{ext}', 'a test')\n"
        "native.normalize_pad_stack(np.zeros((1, 4, 4, 3), np.uint8))\n"
        "print(native.library().build.path)\n"
        "print(open('/proc/self/maps').read())\n")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    path, maps = proc.stdout.split("\n", 1)
    assert pathlib.Path(path).parent == ROOT / "build" / "host" and path in maps
    assert "libdffxio" not in maps


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "kernels").exists()


def test_build_reports_nvcc_failure(monkeypatch, tmp_path):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: no such target' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(_build.BuildError, match="(?s)nvcc failed.*no such target"):
        _build.build()
    assert not list((tmp_path / "kernels").glob("*.so"))


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", src)
    first = _build.library_path()
    (src / "a.cu").write_text("// two\n")
    assert _build.library_path() != first
    assert [p.name for p in _build.sources()] == ["a.cu"]


#: the CUDA sources that replace no TPU kernel, by name: the 16-bit eval BN's
#: pass, which XLA fuses into the conv on the TPU
REPLACE_NO_TPU_KERNEL = {"bn_act.cu"}


def test_sources_are_the_three_kernels():
    names = {p.name for p in _build.sources()}
    assert {"fm_conv.cu", "rb2d.cu", "srd_attention.cu", "rb_of.cu", "motion_head.cu",
            "common.cuh", "mma.cuh", "res_block.cuh"} | REPLACE_NO_TPU_KERNEL <= names
    for p in _build.sources():
        if p.suffix == ".cu":
            text = p.read_text()
            if p.name in REPLACE_NO_TPU_KERNEL:
                assert "Replaces no TPU kernel:" in text, p
            else:
                assert "Replaces the TPU kernel dffx/ops/pallas_kernels.py::" in text, p
            assert "What bounds it on the card" in text, p


def test_load_params_auto_defaults_to_the_card():
    """The entry point runs on the GPU unless asked for the CPU: its default
    device is "cuda", and where there is no card it raises; it does not
    carry on on the CPU."""
    import inspect

    from dffx_torch.eval import load_params_auto

    assert inspect.signature(load_params_auto).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        net = load_params_auto(0)
        assert next(net.parameters()).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            load_params_auto(0)
    assert next(load_params_auto(0, device="cpu").parameters()).device.type == "cpu"


def test_cpu_tensors_never_touch_the_library(monkeypatch):
    """Dispatch is by device: the CPU path must not try to build or load."""
    def refuse():
        raise AssertionError("library loaded for a CPU tensor")

    monkeypatch.setattr(_build, "library", refuse)
    tk.reset_launches()
    x = torch.zeros(1, 8, 2, 8, 8)
    aff = (torch.ones(8), torch.zeros(8))
    tk.rb2d_residual(x, torch.zeros(8, 8, 1, 3, 3), aff, torch.zeros(8, 8, 1, 3, 3), aff)
    tk.srd_attention_residual(x, torch.zeros(8, 8, 3, 1, 1), torch.zeros(8, 8, 1, 1, 1))
    blk = (torch.zeros(8, 8, 1, 3, 3), aff, torch.zeros(8, 8, 1, 3, 3), aff,
           torch.zeros(8, 8, 1, 1, 1))
    tk.rb_of_chain(x, [blk, blk])
    aff16 = (torch.ones(16), torch.zeros(16))
    tk.motion_head_conv_chain(torch.zeros(1, 18, 2, 8, 8), torch.zeros(16, 18, 1, 3, 3), aff16,
                              torch.zeros(16, 16, 1, 3, 3), aff16, torch.zeros(16, 16, 1, 3, 3),
                              aff16, torch.zeros(3, 16, 1, 3, 3), torch.zeros(3))
    tk.bn_act(torch.zeros(1, 8, 2, 8, 8, dtype=torch.bfloat16), *aff, x.bfloat16(), True)
    tk.bn_act_pool(x.bfloat16().contiguous(memory_format=torch.channels_last_3d), *aff, True)
    assert len(tk.launches) == 7
    assert tk.launches == dict.fromkeys(tk.launches, 0)


def test_a_group_on_the_card_raises_without_one(monkeypatch):
    """``initialize``'s device defaults to the card and, without one, raises
    before any rendezvous."""
    import inspect

    assert inspect.signature(distributed.initialize).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize("127.0.0.1:1", 2, 0)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("module,argv", [
    ("dffx_torch.eval.test", ["--dataset", "DDFF", "--spatial", "2", "--results-root"]),
    ("dffx_torch.eval.real_scenes", ["--spatial", "2", "--out"]),
    ("dffx_torch.train.cli", ["--recipe", "DDFF", "--lr", "1e-4", "--num_processes", "2",
                              "--process_id", "1", "--coordinator", "127.0.0.1:1",
                              "--saveroot"]),
], ids=["test", "real_scenes", "train"])
def test_multi_process_command_lines_default_to_the_card(module, argv, tmp_path):
    """A rank of each multi-process command line (``--num_processes``,
    ``--spatial``) defaults to the card and, without one, raises before it
    joins a group or writes anything."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        importlib.import_module(module).main(argv + [str(tmp_path / "out")])
    assert not (tmp_path / "out").exists() and not torch.distributed.is_initialized()
    assert os.environ.get("DFFX_PROCESS_ID") is None
