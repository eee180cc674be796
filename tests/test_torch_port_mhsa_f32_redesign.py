"""Rows 4f / 5f redesigned (``csrc/mhsa_f32.cu``) and the f32
weight-gradient launch (``csrc/f32_ops.cuh``, shared by rows 5f, 7f, 9f,
11f): the numerics and the host side, on the CPU.

- the products' numerics before any CUDA: the 3xTF32 model of
  ``test_torch_port_block_f32_redesign`` (each operand split as hi =
  tf32_rna(v), lo = tf32_rna(v - hi), or as the kernels split it; a
  product sums a_lo b_hi + a_hi b_lo + a_hi b_hi in f32) patched over
  ``fa.mm`` (the qkv and output projections) and the two products of
  ``fa._attention_heads`` (q k^T and P v), every backward product on the
  same engine, the weight gradients too (the weight launch is 3xTF32
  now), against JAX's ``mhsa_reference`` and its ``jax.vjp``: [4, 17, 64]
  and [4, 19, 64] in 8 heads, [4, 17, 128] in heads of 32; the output
  within the card's 1e-5 and every gradient within its 1e-4 of their
  largest magnitude (``chip_smoke.py``'s ``F32_KERNEL_REL_TOL`` /
  ``F32_GRAD_REL_TOL``); the errors are printed; one TF32 pass misses;
- the weight launch's model alone: dW = A^T dY at row 7f's Stage-1 rows
  (17,408) for its [256, 768] job, the plan's row ranges summed in order,
  each on the engine, against an f64 product: within 1e-5 relative;
- the plans at 132 and 114 SMs and without a card: ``mhsa_f32_plan``
  (every (clip, 16-row block) item once, contiguous shares, no more CTAs
  than SMs) and ``f32_wgrad_plan`` at the jobs of rows 5f, 7f, 9f and 11f
  (every (tile, range) once, the ranges contiguous in order);
- the wrappers pass those plans' CTA and range counts (the card stood in
  for: ``_on_card`` true, the launches recorded);
- ``mhsa_f32_kernel_fits`` admits what it did (N <= 64, C a multiple of
  64 up to 256, heads of 8, 16 or 32), and every admitted shape reaches
  both entry points on the card, the plain version never.

``tests/test_torch_port_f32_cpu_build.py`` (``slow``) runs the sources
themselves, built for the CPU, with the grid cut to a few CTAs.
"""

from __future__ import annotations

import ctypes
import itertools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmce_tpu.ops.fused_attention import mhsa_reference
from pmce_tpu_torch.ops import _cuda
from pmce_tpu_torch.ops import fused_attention as fa
from test_torch_port_block_f32_redesign import (mm_1xtf32, mm_3xtf32,
                                                mm_3xtf32_kernel)

OUT_TOL, GRAD_TOL = 1e-5, 1e-4

# ---------------------------------------------------------------------------
# The CPU model of the products
# ---------------------------------------------------------------------------


class _ModelProduct(torch.autograd.Function):
    """``a @ b`` on ``engine``, both gradients on it too: da = g b^T, db =
    a^T g (a weight's over the rows of every clip)."""

    @staticmethod
    def forward(ctx, a, b, engine):
        ctx.save_for_backward(a, b)
        ctx.engine = engine
        return engine(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = ctx.engine(g, b.transpose(-1, -2))
        if b.dim() == 2:
            db = ctx.engine(a.reshape(-1, a.shape[-1]).t(),
                            g.reshape(-1, g.shape[-1]))
        else:
            db = ctx.engine(a.transpose(-1, -2), g)
        return da, db, None


def _model_mm(engine):
    return lambda a, w: _ModelProduct.apply(a.float(), w.float(), engine)


def _model_attention(engine):
    """``fa._attention_heads`` with q k^T and P v on ``engine`` (f32)."""

    def attention(q, k, v, num_heads, dt):
        B, Nq, Cq = q.shape
        Nk = k.shape[1]
        dh = Cq // num_heads

        def heads(a, n):
            return a.reshape(B, n, num_heads, dh).transpose(1, 2).float()

        s = _ModelProduct.apply(heads(q, Nq), heads(k, Nk).transpose(-1, -2),
                                engine)
        o = _ModelProduct.apply(torch.softmax(s, dim=-1), heads(v, Nk),
                                engine)
        return o.transpose(1, 2).reshape(B, Nq, Cq).to(dt)

    return attention


def _case(clips, N, C, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(clips, N, C)),
              rng.normal(size=(C, 3 * C)) * C ** -0.5,
              rng.normal(size=3 * C) * 0.05,
              rng.normal(size=(C, C)) * C ** -0.5,
              rng.normal(size=C) * 0.05]
    g = rng.normal(size=(clips, N, C)).astype(np.float32)
    return [a.astype(np.float32) for a in arrays], g


def _jax_reference(arrays, g, heads):
    """JAX's ``mhsa_reference`` and its VJP: (y, dx, dwqkv, dbqkv, dwproj,
    dbproj) as numpy."""
    args = [jnp.asarray(a) for a in arrays]
    y, vjp = jax.vjp(lambda *a: mhsa_reference(*a, heads), *args)
    return [np.asarray(t) for t in (y, *vjp(jnp.asarray(g)))]


def _model_errors(clips, N, C, heads, engine):
    """(output error, [each gradient's error]) of the plain MHSA with every
    product on ``engine`` against JAX's reference and VJP, each relative
    to its largest magnitude."""
    arrays, g = _case(clips, N, C, seed=N + C + heads)
    want = _jax_reference(arrays, g, heads)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    with mock.patch.object(fa, "mm", _model_mm(engine)), \
            mock.patch.object(fa, "_attention_heads",
                              _model_attention(engine)):
        y = fa.mhsa_plain(*leaves, heads)
        got = [y.detach(), *torch.autograd.grad(y, leaves,
                                                torch.from_numpy(g))]
    errs = [float(np.abs(a.numpy() - b).max() / np.abs(b).max())
            for a, b in zip(got, want)]
    return errs[0], errs[1:]


SHAPES = {"[4, 17, 64] 8 heads": (4, 17, 64, 8),
          "[4, 19, 64] 8 heads": (4, 19, 64, 8),
          "[4, 17, 128] heads of 32": (4, 17, 128, 4)}
ENGINES = {"lo-rounded": mm_3xtf32, "kernel-split": mm_3xtf32_kernel}


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_3xtf32_model_holds_the_cards_gates_against_jax(shape, engine):
    out, grads = _model_errors(*SHAPES[shape], ENGINES[engine])
    print(f"3xTF32 model ({engine}) vs JAX, {shape}: output {out:.3g}, "
          f"gradients {', '.join(f'{e:.3g}' for e in grads)}")
    assert len(grads) == 5
    assert out <= OUT_TOL, out
    assert max(grads) <= GRAD_TOL, grads


def test_one_tf32_pass_misses_the_output_gate():
    """Why the split: one TF32 product keeps 10 mantissa bits, and the
    output then errs beyond the card's 1e-5 of JAX's."""
    out, grads = _model_errors(*SHAPES["[4, 17, 64] 8 heads"], mm_1xtf32)
    print(f"one TF32 pass vs JAX: output {out:.3g}, worst gradient "
          f"{max(grads):.3g}")
    assert out > OUT_TOL, out


def test_weight_gradient_model_at_row_7f_rows():
    """Row 7f's [256, 768] job at Stage 1 (17,408 rows): the plan's row
    ranges (8 on 132 SMs), each range's partial on the 3xTF32 engine (as
    the kernel's tiles), added in range order, against f64: within 1e-5
    of the largest magnitude."""
    M, K, N = 17408, 256, 768
    rng = np.random.default_rng(7)
    a = rng.normal(size=(M, K)).astype(np.float32)
    y = rng.normal(size=(M, N)).astype(np.float32)
    plan = fa.f32_wgrad_plan(M, ((256, 768), (256, 256), (256, 512),
                                 (512, 256)), 132)
    assert plan.splits == 8 and plan.tiles == 32
    at, yt = torch.from_numpy(a), torch.from_numpy(y)
    got = torch.zeros(K, N)
    for m0, m1 in plan.ranges:
        got += mm_3xtf32_kernel(at[m0:m1].t().contiguous(), yt[m0:m1])
    want = a.astype(np.float64).T @ y.astype(np.float64)
    err = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
    print(f"weight gradient model, [{K}, {N}] over {M} rows: {err:.3g}")
    assert err <= 1e-5, err


# ---------------------------------------------------------------------------
# The plans
# ---------------------------------------------------------------------------

# (clips, N, SMs) -> CTAs: the f32 joint stream's, a long batch, a clip
# of 64 tokens; on an H100 SXM (132 SMs) and an H100 PCIe (114).
MHSA_PLANS = {(32, 17, 132): 64, (32, 19, 114): 64, (32, 64, 132): 128,
              (32, 64, 114): 114, (512, 17, 132): 132, (3, 1, 132): 3}


@pytest.mark.parametrize("clips,N,sms", list(MHSA_PLANS),
                         ids=[f"{c}x{n}-{s}sm" for c, n, s in MHSA_PLANS])
def test_mhsa_plan_owns_every_item_once(clips, N, sms):
    plan = fa.mhsa_f32_plan(clips, N, sms)
    blocks = -(-N // 16)
    assert plan.items == tuple((c, r) for c in range(clips)
                               for r in range(0, 16 * blocks, 16))
    assert plan.ctas == MHSA_PLANS[clips, N, sms] <= sms
    assert plan.ctas == len(plan.owned) == min(len(plan.items), sms)
    # Contiguous shares, CTA by CTA in order, within one item of each other.
    assert [i for cta in plan.owned for i in cta] == list(plan.items)
    sizes = {len(cta) for cta in plan.owned}
    assert max(sizes) - min(sizes) <= 1 and plan.waves == max(sizes)


def test_mhsa_plan_without_a_card_is_a_cta_an_item():
    plan = fa.mhsa_f32_plan(5, 33, None)
    assert plan.ctas == 15 and plan.waves == 1
    with pytest.raises(ValueError):
        fa.mhsa_f32_plan(2, 65, None)


# The weight launch's jobs a call: rows 7f (Stage 1), 9f ([32, 431]), 11f
# (its query side and key side, joints over vertices), 5f ([32, 17, 64]).
C, HID = 64, 256
WGRAD_JOBS = {
    "7f": (17408, ((256, 768), (256, 256), (256, 512), (512, 256))),
    "9f": (13792, ((C, 3 * C), (C, C), (C, HID), (HID, C))),
    "11f query side": (544, ((C, C), (C, C), (C, HID), (HID, C))),
    "11f key side": (13792, ((C, C), (C, C))),
    "5f": (544, ((C, 3 * C), (C, C))),
}
# (job, SMs) -> (tiles, ranges).
WGRAD_PLANS = {("7f", 132): (32, 8), ("7f", 114): (32, 7),
               ("9f", 132): (8, 32), ("9f", 114): (8, 28),
               ("11f query side", 132): (6, 8), ("11f key side", 114): (2, 32),
               ("5f", 132): (4, 8), ("5f", 114): (4, 8)}


def _tiles(jobs):
    """The kernel's tiles (tile_shape: 128 x 128 where K and N allow,
    else 128 x 64, 64 x 128, 64 x 64), enumerated as it does."""
    out = []
    for j, (k, n) in enumerate(jobs):
        tk = 128 if k % 128 == 0 else 64
        tn = 128 if n % 128 == 0 else 64
        out += [(j, k0, n0) for k0 in range(0, k, tk)
                for n0 in range(0, n, tn)]
    return out


@pytest.mark.parametrize("job,sms", list(WGRAD_PLANS),
                         ids=[f"{j}-{s}sm" for j, s in WGRAD_PLANS])
def test_wgrad_plan_owns_every_tile_and_range_once(job, sms):
    M, jobs = WGRAD_JOBS[job]
    plan = fa.f32_wgrad_plan(M, jobs, sms)
    tiles = _tiles(jobs)
    assert (plan.tiles, plan.splits) == WGRAD_PLANS[job, sms]
    assert plan.tiles == len(tiles) == len(set(tiles))
    # Every dW element in exactly one tile.
    cover = {}
    for j, k0, n0 in tiles:
        k, n = jobs[j]
        tk, tn = (128 if k % 128 == 0 else 64), (128 if n % 128 == 0 else 64)
        for r in range(k0, k0 + tk, 64):
            for c in range(n0, n0 + tn, 64):
                cover[j, r, c] = cover.get((j, r, c), 0) + 1
    assert sorted(cover) == sorted((j, r, c) for j, (k, n) in enumerate(jobs)
                                   for r in range(0, k, 64)
                                   for c in range(0, n, 64))
    assert set(cover.values()) == {1}
    # The ranges: contiguous, in order, every row once, at least 64 rows.
    assert plan.ranges[0][0] == 0 and plan.ranges[-1][1] == M
    assert all(a[1] == b[0] for a, b in zip(plan.ranges, plan.ranges[1:]))
    assert all(m1 - m0 >= 64 for m0, m1 in plan.ranges)
    assert 1 <= plan.splits <= 32 and len(plan.ranges) == plan.splits
    assert plan.ctas == plan.tiles * plan.splits
    assert plan.waves == -(-plan.ctas // sms) <= 2


def test_wgrad_plan_without_a_card_takes_two_ranges():
    M, jobs = WGRAD_JOBS["5f"]
    plan = fa.f32_wgrad_plan(M, jobs, None)
    assert plan.splits == 2 and plan.ranges == ((0, 272), (272, 544))
    assert plan.waves is None
    assert fa.f32_wgrad_plan(40, jobs, 132).splits == 1  # under 64 rows
    with pytest.raises(ValueError):
        fa.f32_wgrad_plan(M, ((64, 96),), 132)


# ---------------------------------------------------------------------------
# The wrappers' CTA and range counts
# ---------------------------------------------------------------------------


def _table(ptr, n):
    arr = ctypes.cast(ptr, ctypes.POINTER(ctypes.c_void_p))
    return [arr[i] for i in range(n)]


def _card(*extra):
    return [mock.patch.object(fa, "_on_card", return_value=True),
            mock.patch.object(_cuda, "check_cuda"),
            mock.patch.object(_cuda, "stream_ptr",
                              return_value=_cuda.P(None)),
            mock.patch.object(fa, "_block_f32_resident", return_value=132),
            *(mock.patch.object(fa, name, side_effect=AssertionError(
                f"{name} ran")) for name in ("mhsa_plain",
                                             "transformer_block_plain")),
            *extra]


def _run(patches, fn):
    for p in patches:
        p.start()
    try:
        return fn()
    finally:
        for p in reversed(patches):
            p.stop()


def _leaves(clips, N, c, seed=0):
    arrays, g = _case(clips, N, c, seed)
    return ([torch.from_numpy(a).requires_grad_(True) for a in arrays],
            torch.from_numpy(g))


def test_mhsa_wrappers_pass_the_plans():
    """On a card of 132 SMs, [32, 17, 64] in 8 heads: the forward's entry
    point gets the plan's 64 CTAs; the backward's the weight launch's 8
    row ranges, then the same 64 CTAs, and a table of 13 pointers."""
    leaves, g = _leaves(32, 17, 64)
    seen = []

    def call(name, table, *rest):
        seen.append((name, _table(table, 13 if "bwd" in name else 8), rest))

    _run(_card(mock.patch.object(_cuda.MHSA_F32, "call", call)),
         lambda: torch.autograd.grad(fa.fused_mhsa(*leaves, 8), leaves, g))
    (fname, ftab, fints), (bname, btab, bints) = seen
    assert (fname, bname) == ("pmce_mhsa_fwd_f32", "pmce_mhsa_bwd_f32")
    assert fints[:4] == bints[:4] == (32, 17, 64, 8)
    assert fints[5] == 64 and isinstance(fints[6], ctypes.c_void_p)
    assert bints[5:7] == (8, 64) and isinstance(bints[7], ctypes.c_void_p)
    assert fints[5] == fa.mhsa_f32_plan(32, 17, 132).ctas
    assert bints[5] == fa.f32_wgrad_plan(544, ((64, 192), (64, 64)),
                                         132).splits
    assert all(p is not None for p in btab)
    assert btab[4:6] == ftab[6:8]  # the forward's saved qkv and o


def test_block_f32_backward_passes_the_wgrad_plans_ranges():
    """Row 7f at [64, 17, 256] on a card of 132 SMs: the backward's entry
    point gets the weight launch's ranges for its four jobs (1,088 rows:
    8 ranges over 32 tiles) and the block plan's CTAs."""
    rng = np.random.default_rng(3)
    c, hid, clips, N = 256, 512, 64, 17

    def t(*shape, scale=0.2):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).requires_grad_(True)

    params = (t(c), t(c), t(c, 3 * c), t(3 * c), t(c, c), t(c), t(c), t(c),
              t(c, hid), t(hid), t(hid, c), t(c), t(c), t(c))
    x = t(clips, N, c)
    seen = []

    def call(name, table, *rest):
        seen.append((name, rest))

    _run(_card(mock.patch.object(_cuda.BLOCK_F32, "call", call)),
         lambda: torch.autograd.grad(fa.transformer_block(x, params, 8),
                                     [x, *params], torch.ones(clips, N, c)))
    bwd = dict(seen)["pmce_block_bwd_f32"]
    jobs = ((c, 3 * c), (c, c), (c, hid), (hid, c))
    assert bwd[6] == fa.f32_wgrad_plan(clips * N, jobs, 132).splits == 8
    assert bwd[7] == fa.f32_block_plan(clips, N, 132).ctas


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------

GATE = [(n, c, c // dh) for n, c, dh in itertools.product(
    (1, 17, 64), (64, 128, 192, 256), (8, 16, 32))]


@pytest.mark.parametrize("N,c,heads", GATE,
                         ids=[f"N{n}-C{c}-h{h}" for n, c, h in GATE])
def test_every_admitted_shape_reaches_both_kernels(N, c, heads):
    """Inside ``mhsa_f32_kernel_fits`` (unchanged) f32 ``fused_mhsa`` with
    a gradient is one ``pmce_mhsa_fwd_f32`` and one ``pmce_mhsa_bwd_f32``
    call on the card: nothing raises, no plain version runs."""
    assert fa.mhsa_f32_kernel_fits(N, c, heads)
    leaves, g = _leaves(2, N, c, seed=N)
    names = []
    _run(_card(mock.patch.object(
        _cuda.MHSA_F32, "call",
        lambda name, *rest: names.append((name, rest[1:6])))),
         lambda: torch.autograd.grad(fa.fused_mhsa(*leaves, heads), leaves,
                                     g))
    assert [n for n, _ in names] == ["pmce_mhsa_fwd_f32", "pmce_mhsa_bwd_f32"]
    assert names[0][1][:4] == (2, N, c, heads)


@pytest.mark.parametrize("N,c,heads", [(65, 64, 8), (17, 320, 10),
                                       (17, 96, 12), (17, 128, 2)])
def test_the_gate_refuses_what_it_did(N, c, heads):
    """Over 64 tokens, C over 256 or not a multiple of 64, head widths
    other than 8, 16 or 32: outside the gate, as before."""
    assert not fa.mhsa_f32_kernel_fits(N, c, heads)
