"""The port's data-parallel train step on two ranks (two processes, a gloo group
on the CPU, ``tests/torch_dist_worker.py``) against the port in one process on
the global batch and against ``dffx``: DFFNet at b2 5x32x32 (one row a rank),
E2E at b2 10x32x32, fp32.

* ``bn_mode="sync"``: three steps.  Each is taken again in one process from
  the state the ranks had before it, on the global batch: the loss and the
  new running statistics within 1e-5, each gradient within ``DP_GRAD_RTOL``
  of its tensor's largest element and all of them within ``DP_GRAD_L2``
  (relative L2).  The first step also against ``dffx``'s one-device step at
  the bounds of ``tests/test_torch_train.py`` (loss rtol 1e-4; gradients 0.25
  of a tensor's largest element and 5 % L2; statistics rtol 1e-5, atol 1e-6).
* ``bn_mode="per_shard"``: against ``dffx``'s ``make_train_step(bn_mode=
  "per_shard", mesh=make_mesh(jax.devices()[:2]))`` on the conftest's
  virtual CPU devices, at the same bounds; the running statistics are rank
  0's rows' alone.
* ``bn_mode="sync"`` in float64 (model, batch and ``compute_dtype``): the
  same three steps against one process within ``F64_RTOL = 1e-10`` (loss,
  statistics, every gradient against its tensor's largest element, L2).
* remat on two ranks against remat in one process; E2E sync against one
  process; after three steps every rank holds the same bits.

The gradient bound against one process.  The two runs sum the same terms
in another order: the BN statistics as two partial sums, the gradient as two
halves.  Those rounding differences pass through BatchNorm's backward, which
at this size amplifies them (``tests/test_torch_train.py``: a perturbation
of one part in 10^7 of ``fs`` moves a gradient by up to 9.4 % of its
tensor's largest element); measured, the worst tensor moves by 5e-5 to
7.4e-5 of its largest element and all of them by 2.6e-5 to 3.1e-5 in L2.
The same steps in float64 move them by 6.7e-14 and 3.3e-14: the gap
shrinks with the precision of the sums, as a difference of order does,
and the float64 test holds the step to one process at 1e-10.  So in fp32 each
tensor is held to ``DP_GRAD_RTOL = 3e-4`` of its largest element and all of
them to 1e-4 in L2; a gradient scaled by the world size, or a missing
all-reduce, misses by its own size.  E2E's warp has ties where ``dffx``'s and the port's gradients
split (``tests/test_torch_train_e2e.py``), and there the bound is
``tests/test_torch_train.py``'s."""

import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dffx.models import init_params as jinit, network_specs
from dffx.parallel import make_mesh as jmake_mesh
from dffx.train import LossConfig as JLossConfig
from dffx.train import create_train_state as jcreate, make_train_step as jmake
from dffx_torch.checkpoint import jax_layout
from dffx_torch.train import LossConfig, create_train_state, make_train_step

import torch_dist_worker as w
from torch_fixtures import one_thread

STEPS = 3
DP_GRAD_RTOL, DP_GRAD_L2 = 3e-4, 1e-4
#: the step against one process in float64, where the order of the sums costs ~1e-13
F64_RTOL = 1e-10
#: against dffx (tests/test_torch_train.py's bounds)
GRAD_RTOL, GRAD_ATOL, GRAD_L2 = 0.25, 1e-7, 0.05


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from one_thread()


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The two ranks, started at once and running while ``dffx`` compiles."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(w.launch, "train", 2, tmp_path_factory.mktemp("dp_train"),
                          timeout=300)


@pytest.fixture(scope="module")
def ranks(launched, jax_steps):
    """Each rank's records: per mode a list of steps (``step_record``)."""
    return launched.result()


def one_process(record_before, batch, *, e2e=False, remat=False, dtype=torch.float32):
    """One step in one process from a rank's state before it (``None``: the
    fresh state), on ``batch`` (numpy)."""
    state = create_train_state(w.new_model(e2e).to(dtype), w.LR)
    if record_before is not None:
        state.model.load_state_dict(record_before["model"])
        state.optimizer.load_state_dict(record_before["optimizer"])
    step = make_train_step(w.LR, LossConfig(), e2e=e2e, remat=remat, compute_dtype=dtype)
    state, logs = step(state, w.torch_batch(batch))
    return w.step_record(state, logs)


def grad_gaps(got: dict, want: dict):
    """(worst max|dg| / max|g| over the tensors, relative L2 gap over all)."""
    worst = num = den = 0.0
    for k, g in want.items():
        g = np.asarray(g)
        d = np.abs(np.asarray(got[k]) - g).max()
        worst = max(worst, d / max(np.abs(g).max(), 1e-30))
        num += float(((np.asarray(got[k]) - g) ** 2).sum())
        den += float((g ** 2).sum())
    return worst, math.sqrt(num / den)


def assert_grads_within(got, want, rtol, atol, l2):
    assert set(got) == set(want)
    for k, g in want.items():
        g = np.asarray(g)
        gap = np.abs(np.asarray(got[k]) - g).max()
        assert gap <= rtol * np.abs(g).max() + atol, (k, gap, np.abs(g).max())
    assert grad_gaps(got, want)[1] <= l2


def assert_stats_close(got, want, rtol=1e-5, atol=1e-6):
    assert set(got) == set(want)
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == int(v), k
        else:
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(v), rtol=rtol, atol=atol,
                                       err_msg=k)


def assert_logs_close(got, want, rtol):
    for k in ("loss", "mid_loss", "loss1", "loss2", "loss3"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol, err_msg=k)


def assert_same_bits(a: dict, b: dict) -> None:
    """Two ranks' states: model and Adam moments, bit for bit."""
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for slot in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(torch.as_tensor(sa[i][slot]), torch.as_tensor(sb[i][slot]))


def jax_step(params, batch, **kw):
    """dffx's first step: (new params, logs with ``grads``)."""
    step = jmake(w.LR, JLossConfig(), donate=False, debug_grads=True, **kw)
    state, logs = step(jcreate(params, w.LR), {k: jnp.asarray(v) for k, v in batch.items()})
    return {k: np.asarray(v) for k, v in state.params.items()}, logs


@pytest.fixture(scope="module")
def jax_steps(launched):
    """dffx's first sync step on one device and per_shard step on a
    two-device mesh, from seed 0 on the global batch."""
    params = {k: jnp.asarray(v) for k, v in jinit(network_specs(), seed=0).items()}
    batch = w.train_batch(0)
    return {"sync": jax_step(params, batch),
            "per_shard": jax_step(params, batch, bn_mode="per_shard",
                                  mesh=jmake_mesh(jax.devices()[:2]))}


def port_grads(record):
    return jax_layout(w.new_model(False), record["grads"])


@pytest.mark.parametrize("step", range(STEPS))
def test_sync_step_matches_one_process(ranks, step):
    """Each of three sync steps on two ranks against the same step in one
    process on the global batch, from the state the ranks had before it."""
    got = ranks[0]["sync"][step]
    want = one_process(ranks[0]["sync"][step - 1] if step else None, w.train_batch(step))
    assert_logs_close(got["logs"], want["logs"], rtol=1e-5)
    assert_stats_close(got["stats"], want["stats"], rtol=1e-5, atol=1e-6)
    assert_grads_within(got["grads"], want["grads"], DP_GRAD_RTOL, 1e-7, DP_GRAD_L2)


@pytest.mark.parametrize("step", range(STEPS))
def test_sync_step_in_float64_matches_one_process(ranks, step):
    """The same three steps in float64: the loss, the statistics and every
    gradient within ``F64_RTOL`` of the one-process step, which shows that
    the fp32 gap above is the order of the sums and not an error of the
    data-parallel step (a wrong scale or a missing term misses by its own
    size in any precision)."""
    got = ranks[0]["sync64"][step]
    want = one_process(ranks[0]["sync64"][step - 1] if step else None,
                       w.in_float64(w.train_batch(step)), dtype=torch.float64)
    assert got["grads"]["DFF_net.FM_measure.Focus_extraction.0.0.weight"].dtype == torch.float64
    assert_logs_close(got["logs"], want["logs"], rtol=F64_RTOL)
    assert_stats_close(got["stats"], want["stats"], rtol=F64_RTOL, atol=F64_RTOL)
    assert_grads_within(got["grads"], want["grads"], F64_RTOL, 0.0, F64_RTOL)


def test_sync_step_matches_dffx(ranks, jax_steps):
    new, jlogs = jax_steps["sync"]
    got = ranks[0]["sync"][0]
    assert_logs_close(got["logs"], jlogs, rtol=1e-4)
    assert_grads_within(port_grads(got), jlogs["grads"], GRAD_RTOL, GRAD_ATOL, GRAD_L2)
    assert_stats_close(jax_layout(w.new_model(False), got["stats"]),
                       {k: new[k] for k in got["stats"]})


def test_per_shard_step_matches_dffx_per_shard(ranks, jax_steps):
    """``bn_mode="per_shard"`` against ``dffx``'s on a two-device mesh: each
    rank's statistics over its own row, the loss and the gradient of the
    gathered batch, replica 0's running statistics."""
    new, jlogs = jax_steps["per_shard"]
    got = ranks[0]["per_shard"][0]
    assert_logs_close(got["logs"], jlogs, rtol=1e-4)
    assert_grads_within(port_grads(got), jlogs["grads"], GRAD_RTOL, GRAD_ATOL, GRAD_L2)
    assert_stats_close(jax_layout(w.new_model(False), got["stats"]),
                       {k: new[k] for k in got["stats"]})


def test_per_shard_running_stats_are_rank_zeros(ranks):
    """The running statistics after a per_shard step are those of rank 0's
    rows alone: one process stepping on the first half of the batch writes
    the same."""
    alone = one_process(None, {k: v[:1] for k, v in w.train_batch(0).items()})
    for r in ranks:
        assert_stats_close(r["per_shard"][0]["stats"], alone["stats"], rtol=1e-6, atol=1e-7)
    sync = ranks[0]["sync"][0]["stats"]
    assert any(not torch.allclose(sync[k], alone["stats"][k], atol=1e-6)
               for k in sync if k.endswith("running_var"))


@pytest.mark.parametrize("mode", ["sync", "per_shard"])
def test_ranks_hold_the_same_bits(ranks, mode):
    """After three steps every rank's parameters, buffers and Adam moments
    are the same bits, and every step logged the same losses on both."""
    assert_same_bits(ranks[0][mode][-1], ranks[1][mode][-1])
    for a, b in zip(ranks[0][mode], ranks[1][mode]):
        assert a["logs"] == b["logs"]
    assert len(ranks[0][mode]) == STEPS


def test_remat_on_two_ranks_matches_remat_in_one_process(ranks):
    got = ranks[0]["remat"][0]
    want = one_process(None, w.train_batch(0), remat=True)
    assert_logs_close(got["logs"], want["logs"], rtol=1e-5)
    assert_stats_close(got["stats"], want["stats"], rtol=1e-5, atol=1e-6)
    assert_grads_within(got["grads"], want["grads"], DP_GRAD_RTOL, 1e-7, DP_GRAD_L2)
    # the recomputation writes no statistic a second time
    assert {int(v) for k, v in got["stats"].items() if k.endswith("num_batches_tracked")
            and ".pre_conv." not in k and ".redir3." not in k} == {1}


def test_e2e_sync_step_matches_one_process(ranks):
    got = ranks[0]["e2e"][0]
    want = one_process(None, w.train_batch(0, **w.E2E_BATCH), e2e=True)
    assert_logs_close(got["logs"], want["logs"], rtol=1e-5)
    assert_stats_close(got["stats"], want["stats"], rtol=1e-5, atol=1e-6)
    assert_grads_within(got["grads"], want["grads"], GRAD_RTOL, GRAD_ATOL, GRAD_L2)
    assert_same_bits(ranks[0]["e2e"][0], ranks[1]["e2e"][0])


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-6), ("float64", 1e-10)])
def test_sync_bn_of_unequal_rows_matches_one_process(ranks, dtype, rtol):
    """Sync BN on two ranks holding 1 and 3 rows against one process holding
    all 4: y and x's gradient on each rank's rows and the new running
    statistics within ``rtol`` of each tensor's largest value.  The count
    travels in the all-reduce of the sums: one of ``2 C + 1`` values in the
    forward and one in the backward, as many as with equal rows."""
    want = w.bn_rows_step(w.bn_rows_inputs(np.dtype(dtype).type), slice(None))
    got = [r["bn_rows"][dtype] for r in ranks]
    c = want["running_mean"].numel()
    for rec in got:
        assert rec["all_reduces"] == [2 * c + 1, 2 * c + 1]
        assert rec["bytes"] == 2 * (2 * c + 1) * np.dtype(dtype).itemsize
        for k in ("running_mean", "running_var"):
            bound = rtol * want[k].abs().max().item()
            assert (rec[k] - want[k]).abs().max().item() <= bound, (k, rec[k], want[k])
    for k in ("y", "dx"):
        joined = torch.cat([rec[k] for rec in got])
        assert joined.dtype == getattr(torch, dtype) and joined.shape == want[k].shape
        bound = rtol * want[k].abs().max().item()
        assert (joined - want[k]).abs().max().item() <= bound, k


def test_make_train_step_checks_its_mode():
    with pytest.raises(ValueError, match="requires a mesh"):
        make_train_step(w.LR, LossConfig(), bn_mode="per_shard")
    with pytest.raises(ValueError, match="bn_mode"):
        make_train_step(w.LR, LossConfig(), bn_mode="global")
