"""``srd_attention_residual``'s CUDA kernel (``dffx_torch/csrc/srd_attention.cu``),
its packed weights and its grid plan, checked on the CPU.

The kernel runs only on the card (tests/test_torch_gpu.py holds it to its twin
there).  Here the weights it reads are read back from
``srd_attention_params``' buffer in the kernel's order, the plan
(``srd_attention_plan``) is checked to cover every output once and to read
the right halo slices at the shapes ``chip_smoke.py`` runs, and the kernel's
arithmetic is emulated fragment by fragment, as ``mma.sync`` lays out its
operands, from that buffer and that plan: the permuted K order, 3xTF32 in
fp32, the bf16 hi/lo products.  The emulation is held to the gates the card
holds the kernel to (fp32 1e-4; bf16 2^-8 of the largest value + 1e-4)
against the fp32 twin and against ``dffx``'s Pallas kernel in interpret mode.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from dffx.ops import pallas_kernels as jpk
from dffx_torch.ops import kernels as tk

LANE = torch.arange(32)
G, T = LANE // 4, LANE % 4
#: (b, n, h, w) of chip_smoke.py's srd rows, with the widths it runs them at
SMOKE_SHAPES = {"path": ((1, 10, 384, 384), 8), "b4": ((4, 10, 384, 384), 8),
                "e2e": ((1, 10, 608, 1088), 8), "slices": ((1, 65537, 2, 3), 8),
                "batches": ((65537, 1, 2, 3), 8), "tiny": ((1, 2, 7, 5), 8),
                "ragged_c8": ((2, 3, 40, 72), 8), "ragged_c16": ((2, 3, 40, 72), 16),
                "ragged_c32": ((2, 3, 40, 72), 32), "n1": ((1, 1, 384, 384), 8)}
GRID_X_MAX = 2 ** 31 - 1


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _inputs(seed, b, c, n, h, w):
    g = np.random.default_rng(seed)
    f = torch.from_numpy(g.uniform(-1, 1, (b, c, n, h, w)).astype(np.float32))
    wn = torch.from_numpy((g.standard_normal((c, c, 3, 1, 1)) * 0.1).astype(np.float32))
    w1 = torch.from_numpy((g.standard_normal((c, c, 1, 1, 1)) * 0.1).astype(np.float32))
    return f, wn, w1


def _tf32(v):
    """What the tensor cores read of an fp32 operand: its 13 low mantissa bits dropped."""
    return (v.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _bf16(v):
    return v.to(torch.bfloat16).float()


def _halves(words):
    """32-bit words held as float32 bits -> (..., 2) bf16 values as float (low half first)."""
    w = words.contiguous().view(torch.int32)
    lo = (w << 16).view(torch.float32)
    hi = (w & ~0xFFFF).view(torch.float32)
    return torch.stack([lo, hi], dim=-1)


def _sections(buf, c):
    """The buffer as the kernel reads it: per product (Wn, W1), TF32 fragments
    ``(chunks, n-tiles, 32, 4)`` {hi0, hi1, lo0, lo1} and bf16 fragments
    ``(chunks, n-tiles, 32, {hi, lo}, 2)`` (two bf16 a word)."""
    kc = c // 8
    assert buf.dtype == torch.float32 and buf.numel() == tk.srd_params_size(c)
    tf32, b16 = buf[:8 * c * c], buf[8 * c * c:]
    out = {}
    for name, nch, t_off, b_off in (("wn", 3 * kc, 0, 0), ("w1", kc, 6 * c * c, 3 * c * c)):
        out[name, "tf32"] = tf32[t_off:t_off + nch * kc * 128].reshape(nch, kc, 32, 4)
        sec = b16[b_off:]
        pairs = sec[:nch // 2 * kc * 128].reshape(nch // 2, kc, 32, 4)
        chunks = [None] * nch
        for q in range(nch // 2):   # {hi(2q), hi(2q + 1), lo(2q), lo(2q + 1)}
            chunks[2 * q] = torch.stack([pairs[q, ..., 0], pairs[q, ..., 2]], dim=-1)
            chunks[2 * q + 1] = torch.stack([pairs[q, ..., 1], pairs[q, ..., 3]], dim=-1)
        if nch % 2:                  # the odd last chunk: {hi, lo}
            chunks[-1] = sec[nch // 2 * kc * 128:][:kc * 64].reshape(kc, 32, 2)
        out[name, "bf16"] = _halves(torch.stack(chunks))
    return out


def _matrix(frag):
    """Fragments ``(chunks, n-tiles, 32, 2)`` back to ``(Cout, K)`` through the
    fragment layout: lane (g, t), entry j holds k = 8 kk + 2t + j, cout = 8 nb + g."""
    nch, nt = frag.shape[:2]
    w = torch.full((nt * 8, nch * 8), float("nan"))
    for kk in range(nch):
        for nb in range(nt):
            for j in range(2):
                w[8 * nb + G, 8 * kk + 2 * T + j] = frag[kk, nb, :, j]
    return w


def _torch_matrices(wn, w1):
    c = wn.shape[0]
    return {"wn": wn.reshape(c, c, 3).permute(0, 2, 1).reshape(c, 3 * c), "w1": w1.reshape(c, c)}


@pytest.mark.parametrize("c", [8, 16, 32])
def test_srd_params_read_back_as_torch_weights(c):
    """TF32 hi + lo is the fp32 weight exactly, hi has TF32's bits only; bf16
    hi is the weight rounded, hi + lo within 2^-17 of it."""
    f, wn, w1 = _inputs(c, 1, c, 2, 3, 5)
    buf = tk.srd_attention_params(f, wn, w1)
    sec = _sections(buf, c)
    for name, want in _torch_matrices(wn, w1).items():
        t = sec[name, "tf32"]
        hi, lo = _matrix(t[..., :2]), _matrix(t[..., 2:])
        assert torch.equal(hi + lo, want), name
        assert torch.equal(_tf32(hi), hi), name
        b = sec[name, "bf16"]
        bh, bl = _matrix(b[..., 0, :]), _matrix(b[..., 1, :])
        assert torch.equal(bh, _bf16(want)) and torch.equal(bl, _bf16(want - bh)), name
        assert ((bh + bl - want).abs() <= 2.0 ** -17 * want.abs()).all(), name


def _items(plan, b, n):
    """Every warp's item as the kernel decodes it: (stack, first slice, count, tile)."""
    item = np.arange(plan.blocks * tk.SRD_WARPS, dtype=np.int64)
    item = item[item < plan.items]
    tile, rest = item % plan.tiles, item // plan.tiles
    n0 = rest % plan.chunks * plan.slices
    return rest // plan.chunks, n0, np.minimum(plan.slices, n - n0), tile


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("tag", sorted(SMOKE_SHAPES))
def test_srd_plan_covers_every_output_once(tag, bf16):
    """Each (b, n, pixel) is one warp's, no grid dimension is over its limit,
    and each run reads exactly the slices its outputs need: one halo slice on
    each side inside the stack."""
    (b, n, h, w), c = SMOKE_SHAPES[tag]
    hw = h * w
    plan = tk.srd_attention_plan(b, c, n, hw, bf16)
    assert plan.tile == 16 * 32 // c * (2 if bf16 and c == 8 else 1)
    assert plan.tiles == -(-hw // plan.tile)
    assert (plan.blocks - 1) * tk.SRD_WARPS < plan.items <= plan.blocks * tk.SRD_WARPS
    assert plan.blocks <= GRID_X_MAX and plan.items == b * plan.chunks * plan.tiles
    sb, n0, count, tile = _items(plan, b, n)
    key = (sb * plan.chunks + n0 // plan.slices) * plan.tiles + tile
    assert np.array_equal(np.sort(key), np.arange(plan.items))   # each item once
    assert (count >= 1).all() and (sb < b).all()
    # the runs of one stack and tile partition 0..N-1
    starts = np.arange(plan.chunks) * plan.slices
    ends = np.minimum(starts + plan.slices, n)
    assert starts[0] == 0 and ends[-1] == n and (starts[1:] == ends[:-1]).all()
    # the slices a run loads (csrc's `on`: inside the stack, n0 - 1 .. n0 + count)
    for s0, e0 in zip(starts, ends):
        m = np.arange(s0 - 1, e0 + plan.slices + 3)
        loaded = m[(m >= 0) & (m < n) & (m <= e0) & (m >= s0 - 1)]
        need = np.unique(np.clip(np.arange(s0, e0)[:, None] + [-1, 0, 1], 0, n - 1))
        assert np.array_equal(loaded, need), (s0, e0)
    if tag == "e2e":     # all N in one run, at least two waves of warps
        assert plan.slices == n and plan.items >= 2 * 132 * tk.SRD_WARPS_PER_SM
    if tag == "slices":  # thousands of blocks where the first design launched one
        assert plan.blocks >= 1000 and plan.slices >= tk.SRD_MIN_SLICES


def _mma_tf32(a, b):
    """m16n8k8 TF32: a ``(..., 32, 4)``, b ``(..., 32, 2)`` fragments of one warp
    as PTX lays them out -> d ``(..., 32, 4)``; operands cut to TF32."""
    am = torch.zeros(*a.shape[:-2], 16, 8)
    am[..., G, T], am[..., G + 8, T] = a[..., 0], a[..., 1]
    am[..., G, T + 4], am[..., G + 8, T + 4] = a[..., 2], a[..., 3]
    bm = torch.zeros(*b.shape[:-2], 8, 8)
    bm[..., T, G], bm[..., T + 4, G] = b[..., 0], b[..., 1]
    d = (_tf32(am).double() @ _tf32(bm).double()).float()
    return torch.stack([d[..., G, 2 * T], d[..., G, 2 * T + 1],
                        d[..., G + 8, 2 * T], d[..., G + 8, 2 * T + 1]], dim=-1)


def _mma_bf16(a, b):
    """m16n8k16 (4 A registers) or m16n8k8 (2) bf16: a ``(..., 32, regs, 2)``,
    b ``(..., 32, regs / 2, 2)`` -> d ``(..., 32, 4)``; a register's halves
    are consecutive k, the low half first."""
    k = 8 * a.shape[-2] // 2
    am = torch.zeros(*a.shape[:-3], 16, k)
    bm = torch.zeros(*b.shape[:-3], k, 8)
    for i in range(2):
        for r in range(a.shape[-2]):   # reg r: rows g + 8 (r % 2), k 2t + 8 (r // 2)
            am[..., G + 8 * (r % 2), 2 * T + 8 * (r // 2) + i] = a[..., r, i]
        for r in range(b.shape[-2]):
            bm[..., 2 * T + 8 * r + i, G] = b[..., r, i]
    d = (am.double() @ bm.double()).float()
    return torch.stack([d[..., G, 2 * T], d[..., G, 2 * T + 1],
                        d[..., G + 8, 2 * T], d[..., G + 8, 2 * T + 1]], dim=-1)


def _product_bf16(a, al, wsec, acc):
    """One bf16 product as the kernel chains it: chunk pairs as m16n8k16,
    an odd last chunk as m16n8k8; al B_h + a B_l + a B_h (no al: the first
    product, whose f is exact in bf16).  a, al ``(chunks, MT, 32, 2 regs, 2)``."""
    nch, nt = a.shape[0], acc.shape[1]
    for q in range(0, nch - 1, 2):
        aq = torch.cat([a[q], a[q + 1]], dim=-2)
        lq = None if al is None else torch.cat([al[q], al[q + 1]], dim=-2)
        for nb in range(nt):
            bh = torch.stack([wsec[q, nb, :, 0], wsec[q + 1, nb, :, 0]], dim=-2)
            bl = torch.stack([wsec[q, nb, :, 1], wsec[q + 1, nb, :, 1]], dim=-2)
            if lq is not None:
                acc[:, nb] += _mma_bf16(lq, bh)
            acc[:, nb] += _mma_bf16(aq, bl)
            acc[:, nb] += _mma_bf16(aq, bh)
    if nch % 2:
        for nb in range(nt):
            bh, bl = wsec[-1, nb, :, 0:1], wsec[-1, nb, :, 1:2]
            if al is not None:
                acc[:, nb] += _mma_bf16(al[-1], bh)
            acc[:, nb] += _mma_bf16(a[-1], bl)
            acc[:, nb] += _mma_bf16(a[-1], bh)


def _attend(prev, cur, nxt, sec, bf16, lo_terms):
    """One output slice of one sub-tile from its three input slices, each
    ``(KC, 2, 32, 2 MT)`` (channel 8 kc + 2t + h at the sub-tile's slot s):
    the kernel's ``attend`` / ``attend_bf16``.  Returns the same layout."""
    kc_n, mt = prev.shape[0], prev.shape[-1] // 2
    acc = torch.zeros(mt, kc_n, 32, 4)
    if not bf16:
        for dn, s in enumerate((prev, cur, nxt)):
            for kc in range(kc_n):
                # m-tile j: (slot 2j, ch 2t), (2j + 1, 2t), (2j, 2t + 1), (2j + 1, 2t + 1)
                a = torch.stack([s[kc, r // 2][:, 2 * torch.arange(mt) + r % 2].T
                                 for r in range(4)], dim=-1)          # (MT, 32, 4)
                ah = _tf32(a)
                for nb in range(kc_n):
                    bf = sec["wn", "tf32"][dn * kc_n + kc, nb]
                    acc[:, nb] += lo_terms * _mma_tf32(a - ah, bf[:, :2])
                    acc[:, nb] += lo_terms * _mma_tf32(ah, bf[:, 2:])
                    acc[:, nb] += _mma_tf32(ah, bf[:, :2])
        acc2 = torch.zeros_like(acc)
        for kc in range(kc_n):
            a = acc[:, kc].clamp(min=0)[..., [0, 2, 1, 3]]
            ah = _tf32(a)
            for nb in range(kc_n):
                bf = sec["w1", "tf32"][kc, nb]
                acc2[:, nb] += lo_terms * _mma_tf32(a - ah, bf[:, :2])
                acc2[:, nb] += lo_terms * _mma_tf32(ah, bf[:, 2:])
                acc2[:, nb] += _mma_tf32(ah, bf[:, :2])
    else:
        # chunk (dn, kc), m-tile j, register r: (channel 2t, 2t + 1) at slot 2j + r
        chunks = [torch.stack([torch.stack([s[kc, 0, :, 2 * j + r], s[kc, 1, :, 2 * j + r]],
                                           dim=-1) for r in range(2)], dim=-2)
                  for s in (prev, cur, nxt) for kc in range(kc_n) for j in range(mt)]
        a = torch.stack(chunks).reshape(3 * kc_n, mt, 32, 2, 2)
        _product_bf16(a, None, sec["wn", "bf16"], acc)
        r = acc.clamp(min=0).reshape(mt, kc_n, 32, 2, 2).permute(1, 0, 2, 3, 4)
        ah = _bf16(r)
        acc2 = torch.zeros_like(acc)
        _product_bf16(ah, _bf16(r - ah), sec["w1", "bf16"], acc2)
    # out[nb][h][s] = cur + relu(acc2[s // 2][nb][h + 2 (s % 2)])
    slot = torch.arange(2 * mt)
    return torch.stack([torch.stack([cur[nb, hh] + acc2[slot // 2, nb, :, hh + 2 * (slot % 2)]
                                     .T.clamp(min=0) for hh in range(2)])
                        for nb in range(kc_n)])


def _emulate(f, buf, bf16, split=True):
    """``csrc/srd_attention.cu`` on f, warp by warp as ``srd_attention_plan``
    hands out the items, from the packed buffer; in bf16 at C = 8 a warp's
    tile is two sub-tiles computed in turn.  ``split=False``: plain TF32 in fp32 (no lo
    terms), to show that the split is what holds the bound.  Returns the
    output and how often each element was written."""
    b, c, n, h, w = f.shape
    hw = h * w
    kc_n, mt, sub = c // 8, 32 // c, 2 if bf16 and c == 8 else 1
    ssl = 2 * mt
    sl = ssl * sub
    v = sl if sl * (2 if bf16 else 4) < 16 else 16 // (2 if bf16 else 4)
    plan = tk.srd_attention_plan(b, c, n, hw, bf16)
    assert plan.tile == 16 * sl // 2
    sec = _sections(buf, c)
    x = f.reshape(b, c, n, hw)
    y = torch.zeros_like(x)
    writes = torch.zeros(x.shape, dtype=torch.int64)
    slot = torch.arange(sl)
    pix0 = slot // v * 8 * v + slot % v                      # a lane's slots from its first pixel
    chan = (8 * torch.arange(kc_n)[:, None, None] + 2 * T[None, None]
            + torch.arange(2)[None, :, None])                  # (KC, 2, 32): 8 kc + 2t + h

    def load(sb, m, px, on):
        """(KC, 2, 32, SL): channel 8 kc + 2t + h at slot s, 0 where not read"""
        if not on:
            return torch.zeros(kc_n, 2, 32, sl)
        p = px[:, None] + pix0[None]                          # (32, SL)
        vals = x[sb, chan[..., None], m, p.clamp(max=hw - 1)[None, None]]
        return torch.where((p < hw)[None, None], vals, torch.zeros(()))

    lo_terms = 1.0 if split else 0.0
    for sb, n0, count, tile in zip(*_items(plan, b, n)):
        px = tile * plan.tile + G * v
        ring = {m: load(sb, m, px, 0 <= m < n and m <= n0 + count)
                for m in range(n0 - 1, n0 + count + 1)}
        # a sub-tile with no pixel inside is not computed: its slots hold no value
        computed = [k == 0 or tile * plan.tile + pix0[k * ssl] < hw for k in range(sub)]
        for nn in range(n0, n0 + count):
            part = lambda s, k: s[..., k * ssl:(k + 1) * ssl]
            out = torch.cat([_attend(*(part(ring[m], k) for m in (nn - 1, nn, nn + 1)), sec, bf16,
                                     lo_terms) if computed[k]
                             else torch.full((kc_n, 2, 32, ssl), float("nan"))
                             for k in range(sub)], dim=-1)  # (KC, 2, 32, SL)
            if bf16:
                out = _bf16(out)
            p = px[:, None] + pix0[None]
            inside = (p < hw)[None, None].expand_as(out)
            ci = chan[..., None].expand_as(out)
            y[sb, ci[inside], nn, p[None, None].expand_as(out)[inside]] = out[inside]
            writes[sb, ci[inside], nn, p[None, None].expand_as(out)[inside]] += 1
    return y.reshape(f.shape), writes.reshape(f.shape)


def _pallas(f, wn, w1):
    """dffx's Pallas kernel (interpret mode) on (B, C, N, H, W) torch inputs."""
    to = lambda t, perm: jnp.asarray(t.permute(*perm).contiguous().numpy())
    out = jpk.srd_attention_residual(to(f, (0, 2, 3, 4, 1)), to(wn, (2, 3, 4, 1, 0)),
                                     to(w1, (2, 3, 4, 1, 0)))
    return torch.from_numpy(np.array(out)).permute(0, 4, 1, 2, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,b,n,h,w", [(8, 1, 10, 16, 9), (8, 2, 9, 16, 5), (16, 1, 3, 16, 5),
                                       (32, 1, 2, 16, 3)],
                         ids=["c8_split", "c8_ragged", "c16", "c32"])
def test_srd_kernel_arithmetic_holds_the_gates(interpret_pallas, dtype, c, b, n, h, w):
    """The kernel's arithmetic, emulated from the packed buffer along the plan,
    within the card's gates of the fp32 twin and of dffx's Pallas kernel, with
    every output written once.  In fp32 plain TF32 (no lo terms) misses the
    1e-4 gate: the split is what holds it."""
    f, wn, w1 = _inputs(c * 100 + n, b, c, n, h, w)
    bf16 = dtype == "bfloat16"
    if bf16:
        f = _bf16(f)    # the card's input: rounded; the twin computes from it in fp32
    buf = tk.srd_attention_params(f, wn, w1)
    got, writes = _emulate(f, buf, bf16)
    assert (writes == 1).all()
    twin = tk.srd_attention_residual_ref(f, wn, w1)
    bound = (2.0 ** -8 * twin.abs().max().item() if bf16 else 0.0) + 1e-4
    assert (got - twin).abs().max().item() <= bound
    assert (got - _pallas(f, wn, w1)).abs().max().item() <= bound
    if not bf16 and c == 8 and n > 3:
        plain, _ = _emulate(f, buf, bf16, split=False)
        assert (plain - twin).abs().max().item() > 1e-4


def test_fmmodule_packs_the_attention_once():
    """FMModule keeps srd_attention_residual's buffer in a
    ParamCache(srd_attention_params): one packing for any number of forwards,
    a new one when a weight changes; a CPU tensor gets none (its twin takes
    the weights as they are)."""
    import types

    from dffx_torch.models.layers import FMModule

    m = FMModule().eval()
    assert m._srd_params._pack is tk.srd_attention_params
    att = m.Focus_extraction[2].N_ch_attention
    args = (att[0].weight, att[2].weight)
    f = torch.zeros(1, 8, 2, 3, 5)
    assert m._srd_params(f, *args) is None
    packs = []
    real = m._srd_params._pack

    def pack(x, *a):
        packs.append(x.device)
        return real(f, *a)

    m._srd_params._pack = pack
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0), dtype=torch.float32)
    with torch.no_grad():
        first = m._srd_params(on_card, *args)
        assert m._srd_params(on_card, *args) is first and len(packs) == 1
        assert first.numel() == tk.srd_params_size(8)
        torch.testing.assert_close(first, tk.srd_attention_params(f, *args), rtol=0, atol=0)
        att[2].weight.mul_(2)
        assert m._srd_params(on_card, *args) is not first and len(packs) == 2


def test_srd_wrapper_checks_the_packed_buffer_it_is_given():
    f, wn, w1 = _inputs(0, 1, 8, 2, 3, 5)
    good = tk.srd_attention_params(f, wn, w1)
    assert tk._check_params(good, f, tk.srd_params_size(8)) is good
    for bad in (good[:-1], good.double(), good.to("meta"), torch.cat([good, good])[::2]):
        with pytest.raises(ValueError, match="params"):
            tk._check_params(bad, f, tk.srd_params_size(8))
    with pytest.raises(ValueError, match="no srd_attention plan"):
        tk.srd_attention_plan(1, 12, 2, 6)
