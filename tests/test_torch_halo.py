"""The port's spatial serving (``dffx_torch/ops/halo.py``, ``layers.chain_site``,
``TimedForward(spatial=)``) on 2 and 4 ranks, each a process of its own in a
gloo group on the CPU (``tests/torch_dist_worker.py``), against the unsharded
port and against ``dffx``:

* ``halo_sharded_chain`` on a stock two-conv chain: exact to 1e-6;
* the three chain sites (``FMModule``: fm_conv -> rb2d -> attention, bleed
  2; ``OFLevel``'s ``rb_of_chain``, bleed 4; the fused ``MotionHead``, bleed
  3) through the kernels' twins: against ``dffx``'s ``halo_sharded_chain``
  on the same inputs (its Pallas kernels in interpret mode, as
  ``tests/test_spatial_pallas.py`` runs them) at 1e-5; through their stock
  layers (``--spatial-xla``): against the unsharded port at 1e-5;
* the halo rows and the all-gathers each rank moved, counted;
* whole DFFNet and E2E forwards on two ranks (``TimedForward(spatial=2)``)
  against ``dffx``'s unsharded forward at the port's fp32 parity, 1e-4; at
  E2E's 10 x 64 x 96 the half- and quarter-resolution levels do not split
  over two ranks and run whole;
* ``bleed`` has no default."""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from dffx.models import Ctx, dffnet_apply, e2e_apply, e2e_network_specs
from dffx.models import init_params as jinit, network_specs
from dffx.models.alignnet import _head_apply, _rb_of_stack_apply
from dffx.models.layers import fm_module_apply
from dffx.parallel import make_mesh as jmake_mesh
from dffx_torch.ops.halo import EDGE_MARGIN, HALO, halo_sharded_chain, spatial_active, spatial_ok
from dffx_torch.parallel.mesh import Mesh

import torch_dist_worker as w
from torch_fixtures import one_thread

SITES = ("fm", "of", "head")
FLOW = "optical_flow_aggregation"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from one_thread()


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every group of ranks at once: the chain sites on 2 and on 4 ranks, the
    whole forwards on 2."""
    tmp = tmp_path_factory.mktemp("halo")
    with ThreadPoolExecutor(3) as pool:
        yield {"halo2": pool.submit(w.launch, "halo", 2, tmp / "h2", spatial=2),
               "halo4": pool.submit(w.launch, "halo", 4, tmp / "h4", spatial=4),
               "forward": pool.submit(w.launch, "forward", 2, tmp / "f2", spatial=2)}


@pytest.fixture(scope="module")
def interpret_pallas():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        yield


@pytest.fixture(scope="module")
def jparams(launched):
    return {"dffnet": jinit(network_specs(), seed=0), "e2e": jinit(e2e_network_specs(), seed=0)}


def _ndhwc(a):
    return jnp.asarray(np.moveaxis(a, 1, -1))


@pytest.fixture(scope="module")
def dffx_sites(jparams, interpret_pallas):
    """``dffx``'s sharded chain sites on s virtual devices, channel-first."""
    out = {}
    for s in (2, 4):
        ctx = Ctx(use_pallas=True, spatial_mesh=jmake_mesh(jax.devices()[:s], data=1, spatial=s))
        x = {k: _ndhwc(v) for k, v in w.chain_inputs(s).items()}
        fm = jax.jit(lambda p, x: fm_module_apply(p, "DFF_net.FM_measure", x, ctx))
        of = jax.jit(lambda p, x: _rb_of_stack_apply(
            p, [f"{FLOW}.OF_feature.0", f"{FLOW}.OF_feature.1"], x, ctx))
        head = jax.jit(lambda p, x: _head_apply(p, f"{FLOW}.conv3", x, ctx))
        out[s] = {"fm": np.moveaxis(np.asarray(fm(jparams["dffnet"], x["fm"])), -1, 1),
                  "of": np.moveaxis(np.asarray(of(jparams["e2e"], x["of"])), -1, 1),
                  "head": np.asarray(head(jparams["e2e"], x["head"]))}
    return out


@pytest.fixture(scope="module")
def ranks(launched, dffx_sites):
    return {s: launched[f"halo{s}"].result() for s in (2, 4)}


@pytest.fixture(scope="module")
def unsharded():
    """The port's chain sites whole, in one process (kernels' twins)."""
    dff, e2e = w.new_model(False).eval(), w.new_model(True).eval()
    flow = e2e.optical_flow_aggregation
    sites = {"fm": dff.DFF_net.FM_measure, "of": flow.OF_feature, "head": flow.conv3}
    with torch.no_grad():
        return {s: {k: sites[k](torch.from_numpy(x)) for k, x in w.chain_inputs(s).items()}
                for s in (2, 4)}


@pytest.mark.parametrize("s", [2, 4])
def test_stock_chain_is_exact(ranks, s):
    x, k = (torch.from_numpy(a) for a in w.stock_chain_inputs(s))
    want = w.stock_chain(x, k)
    for r in ranks[s]:
        torch.testing.assert_close(r["stock"], want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("s", [2, 4])
def test_chain_site_matches_dffx_halo(ranks, dffx_sites, s, site):
    """The kernels' chain sharded over s ranks against ``dffx``'s, on every rank."""
    for r in ranks[s]:
        np.testing.assert_allclose(r[f"{site}_kernels"].numpy(), dffx_sites[s][site], rtol=0,
                                   atol=1e-5, err_msg=site)


@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("s", [2, 4])
def test_stock_chain_site_matches_unsharded(ranks, unsharded, s, site):
    """``--spatial-xla``: the stock layers sharded, against the kernels'
    twins whole."""
    for r in ranks[s]:
        torch.testing.assert_close(r[f"{site}_stock"], unsharded[s][site], rtol=0, atol=1e-5)


@pytest.mark.parametrize("s", [2, 4])
def test_halo_and_gather_bytes(ranks, s):
    """Each rank sends ``HALO`` rows to each neighbour and gathers its rows of
    each site's output, twice (kernels, stock)."""
    x = w.chain_inputs(s)
    width, rows = 32, x["fm"].shape[3] // s
    per_row = {k: v.shape[1] * v.shape[2] * width * 4 for k, v in x.items()}
    out_per_row = {"fm": 8 * 2 * width * 4, "of": 8 * 2 * width * 4, "head": 3 * 10 * width * 4}
    for i, r in enumerate(ranks[s]):
        neighbours = (i > 0) + (i < s - 1)
        assert r["traffic"]["halo"] == 2 * neighbours * HALO * sum(per_row.values())
        assert r["traffic"]["all_gather"] == 2 * rows * sum(out_per_row.values())
        assert r["traffic"]["host_staged"] == 0  # CPU tensors: nothing to stage


@pytest.fixture(scope="module")
def forwards(launched, jparams):
    """(ranks' outputs, dffx's unsharded outputs) per case."""
    ranks = launched["forward"].result()
    want = {}
    for key in ranks[0]:
        if isinstance(key[0], str) or key[:3] in want:
            continue
        e2e, h, wd, _ = key
        args = [jnp.asarray(a) for a in w.forward_inputs(e2e, h, wd)]
        if e2e:
            outs = jax.jit(lambda p, *a: e2e_apply(p, *a, Ctx()))(jparams["e2e"], *args)
        else:
            outs = jax.jit(lambda p, *a: dffnet_apply(p, *a, Ctx()))(jparams["dffnet"], *args)
        want[(e2e, h, wd)] = [np.asarray(o) for o in outs]
    return ranks, want


@pytest.mark.parametrize("pallas", [True, False], ids=["spatial_pallas", "spatial_xla"])
@pytest.mark.parametrize("e2e", [False, True], ids=["dffnet", "e2e"])
def test_spatial_forward_matches_dffx(forwards, e2e, pallas):
    ranks, want = forwards
    (key,) = [k for k in ranks[0] if k[0] is e2e and k[3] is pallas]
    assert ranks[0]["launches", *key] == dict.fromkeys(ranks[0]["launches", *key], 0)
    for r in ranks:
        got = r[key]
        assert len(got) == len(want[key[:3]])
        for g, ref in zip(got, want[key[:3]]):
            np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-4)


def test_e2e_lower_levels_run_whole(forwards):
    """At 10 x 64 x 96 on two ranks the full-resolution chains split (FM,
    pyramid level 1, motion head) and the half- and quarter-resolution
    levels (32 and 16 rows) run whole: the all-gathers carry the three split
    sites' outputs and nothing else."""
    ranks, _ = forwards
    for r in ranks:
        traffic = r["traffic", True, 64, 96]
        assert traffic["all_gather"] == 4 * 32 * 96 * 10 * (8 + 8 + 3)
        assert traffic["halo"] == 4 * HALO * 96 * 10 * (3 + 3 + 18)


def test_bleed_has_no_default():
    with pytest.raises(TypeError, match="bleed"):
        halo_sharded_chain(lambda t: t, torch.zeros(1, 1, 1, 64, 8), None, edge_fn=lambda t: t)


def test_spatial_gates():
    def mesh(data, spatial):
        return Mesh(data, spatial, 0, {"data": tuple(range(data)),
                                       "spatial": tuple(range(spatial))}, {})

    assert spatial_active(mesh(1, 2)) and not spatial_active(mesh(2, 1))
    assert not spatial_active(None)
    assert spatial_ok(mesh(1, 2), 128) and spatial_ok(mesh(1, 2), 64)
    assert not spatial_ok(mesh(1, 2), 96)  # 96 / 2 = 48, not a multiple of 32
    assert not spatial_ok(mesh(2, 1), 128) and not spatial_ok(None, 128)
    assert (HALO, EDGE_MARGIN) == (16, 1)
