"""Guards on the port's boundaries: dffx_torch imports no JAX and no dffx, and
the kernel build raises, without a fallback, when there is no nvcc."""

import ast
import pathlib

import pytest
import torch

from dffx_torch.ops import _build
from dffx_torch.ops import kernels as tk

PKG = pathlib.Path(__file__).resolve().parent.parent / "dffx_torch"
FORBIDDEN = {"jax", "jaxlib", "optax", "dffx"}


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_no_dffx():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 16 and PKG / "models" / "packed.py" in files
    bad = {(f.relative_to(PKG).as_posix(), m) for f in files for m in _imported_roots(f)
           if m in FORBIDDEN}
    assert not bad, bad


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


def test_sources_are_the_three_kernels():
    names = {p.name for p in _build.sources()}
    assert {"fm_conv.cu", "rb2d.cu", "srd_attention.cu", "rb_of.cu", "motion_head.cu",
            "common.cuh", "mma.cuh", "res_block.cuh"} <= names
    for p in _build.sources():
        if p.suffix == ".cu":
            text = p.read_text()
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
    assert len(tk.launches) == 5
    assert tk.launches == dict.fromkeys(tk.launches, 0)
