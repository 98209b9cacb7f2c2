"""The port serves weights the JAX package trained: a ``.ckpt`` written by
``dffx.checkpoint.save`` (format v2) goes through ``dffx_torch``'s
``load_params_auto`` and the forward agrees with ``dffnet_apply`` on the same
parameters, fp32 on the CPU, heads at atol 1e-4 (the bound of the other
whole-network parity tests)."""

import io
import json
import zipfile

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from dffx import checkpoint as jckpt
from dffx.models import Ctx, dffnet_apply, network_specs
from dffx.models import init_params as jinit
from dffx_torch.checkpoint import load_dffx_checkpoint
from dffx_torch.eval import load_params_auto


@pytest.fixture(scope="module")
def params():
    return jinit(network_specs(), seed=5)


def _train_state(params):
    """What the train CLI saves: the step, the parameters, an optax Adam state."""
    trainable = {k: v for k, v in params.items() if k.endswith((".weight", ".bias"))}
    opt_state = optax.adam(1e-4, b1=0.9, b2=0.99, eps=1e-8).init(trainable)
    return {"step": jnp.asarray(3, jnp.int32), "params": params, "opt_state": opt_state}


def _rewrite(src, dst, *, version=None, drop=None):
    """Copy a format-v2 archive with another manifest version or without one key."""
    with zipfile.ZipFile(src) as zf:
        manifest = json.loads(zf.read("__dffx_manifest__").decode())
        leaves = [zf.read(f"leaf_{i}.npy") for i in range(len(manifest["keys"]))]
    keep = [i for i, k in enumerate(manifest["keys"]) if k != drop]
    manifest = {"version": version or manifest["version"],
                "keys": [manifest["keys"][i] for i in keep]}
    with zipfile.ZipFile(dst, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr("__dffx_manifest__", json.dumps(manifest))
        for j, i in enumerate(keep):
            zf.writestr(f"leaf_{j}.npy", leaves[i])


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_load_params_auto_serves_a_dffx_checkpoint(tmp_path, params, rng, packed):
    path = str(tmp_path / "models" / "10.ckpt")
    jckpt.save(path, _train_state(params))
    got = load_dffx_checkpoint(path)
    assert set(got) == set(params) and len(got) == 384
    for k, v in params.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    net = load_params_auto(path, device="cpu", packed=packed)
    assert not net.training and net.DFF_net.packed is packed
    fs = rng.uniform(-1, 1, (1, 4, 64, 96, 3)).astype(np.float32)
    fd = np.linspace(0.1, 1.5, 4, dtype=np.float32)[None]
    ref = dffnet_apply(params, jnp.asarray(fs), jnp.asarray(fd), Ctx(use_packed=packed))
    with torch.no_grad():
        outs = net(torch.from_numpy(fs), torch.from_numpy(fd))
    for g, r, name in zip(outs, ref, ["mid", "pred1", "pred2", "pred3"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, err_msg=name)


def test_a_bare_parameter_dict_is_read_whole(tmp_path, params):
    """``dffx.eval.load_params_auto`` takes ``blob["params"]`` where there is
    one and the blob itself otherwise; so does the port."""
    path = str(tmp_path / "params.ckpt")
    jckpt.save(path, params)
    got = load_dffx_checkpoint(path)
    assert set(got) == set(params)
    np.testing.assert_array_equal(got["DFF_net.deconv_3.0.weight"],
                                  np.asarray(params["DFF_net.deconv_3.0.weight"]))


def test_a_newer_format_raises(tmp_path, params):
    path, newer = str(tmp_path / "a.ckpt"), str(tmp_path / "b.ckpt")
    jckpt.save(path, _train_state(params))
    _rewrite(path, newer, version=3)
    with pytest.raises(ValueError, match="format v3 > supported v2"):
        load_params_auto(newer, device="cpu")


def test_a_file_that_is_neither_raises(tmp_path, params):
    """Not a zip (the legacy pickle, format v1, among them) and not a ``.pth``:
    the error says what is read; a zip of another kind is refused too."""
    import pickle

    legacy = tmp_path / "legacy.ckpt"
    legacy.write_bytes(pickle.dumps({"params": {"w": np.zeros(2, np.float32)}}))
    with pytest.raises(ValueError, match="legacy pickle"):
        load_params_auto(str(legacy), device="cpu")
    other = tmp_path / "other.ckpt"
    with zipfile.ZipFile(other, "w") as zf:
        buf = io.BytesIO()
        np.save(buf, np.zeros(2, np.float32))
        zf.writestr("leaf_0.npy", buf.getvalue())
    with pytest.raises(ValueError, match="__dffx_manifest__"):
        load_params_auto(str(other), device="cpu")
    with pytest.raises(FileNotFoundError):
        load_params_auto(str(tmp_path / "missing.ckpt"), device="cpu")


def test_a_missing_key_raises(tmp_path, params):
    path, short = str(tmp_path / "a.ckpt"), str(tmp_path / "b.ckpt")
    jckpt.save(path, _train_state(params))
    _rewrite(path, short, drop="['params']['DFF_net.dres4.conv6.0.weight']")
    with pytest.raises(ValueError, match="1 missing.*DFF_net.dres4.conv6.0.weight"):
        load_params_auto(short, device="cpu")
    with pytest.raises(ValueError, match="missing"):  # a DFFNet checkpoint is no E2E one
        load_params_auto(path, device="cpu", arch="e2e")
