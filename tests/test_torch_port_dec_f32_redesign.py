"""Rows 9f / 11f redesigned (``csrc/ada_f32.cu``, ``csrc/ca_f32.cu`` over
``csrc/dec_tc32.cuh``): the host side and the numerics, on the CPU.

- the products' numerics before any CUDA: the 3xTF32 model of
  ``test_torch_port_block_f32_redesign`` (each operand split as hi =
  tf32_rna(v), lo = tf32_rna(v - hi), or as the kernels split it; a
  product sums a_lo b_hi + a_hi b_lo + a_hi b_hi in f32) patched over
  ``fa.mm`` (every row product of the plain blocks) and over the two
  products of ``fa._attention_heads`` (q k^T and P v), their backwards
  (dP = dO v^T, dS k, dS^T q, P^T dO and the activation gradients of the
  row products) on the same engine, the weight gradients in f32 (the f32
  weight-gradient launch, FFMA), at phase 13a's shapes cut to 4 clips:
  the AdaLN block [4, 431, 64] in 2 heads of 32, the CA block with joints
  [4, 17, 64] over vertices [4, 431, 64] in 8 heads of 8 and vertices over
  joints in 2 heads of 32, hid 256, branch masks at rate 0.2 without and
  with their gradient: outputs within the card's 1e-5 and every gradient
  (dm1, dm2 included) within its 1e-4 of their largest magnitude
  (``chip_smoke.py``'s ``F32_KERNEL_REL_TOL`` / ``F32_GRAD_REL_TOL``; the
  CA block's key bias and key AdaLN beta, zero analytically, of the
  largest gradient). The errors are printed; one TF32 pass misses them;
- the plan of the backwards' programs (``f32_dec_plan``) at [32, 431] /
  [32, 17] on 132 and 114 SMs: every (clip, row tile) and every range of
  a split long side owned exactly once, no more CTAs than the card holds at
  once, the ranges' merge order fixed, the waves stated;
- the wrappers pass the plan's CTA count to the backwards' entry points
  and the CA block's workspace query (the card stood in for).

``tests/test_torch_port_f32_cpu_build.py`` (``slow``) runs the sources
themselves, built for the CPU, under the split plan.
"""

from __future__ import annotations

import ctypes
from unittest import mock

import numpy as np
import pytest
import torch

from pmce_tpu_torch.ops import _cuda
from pmce_tpu_torch.ops import fused_attention as fa
from test_torch_port_block_f32_redesign import (mm_1xtf32, mm_3xtf32,
                                                mm_3xtf32_kernel)

C, HID = 64, 256
OUT_TOL, GRAD_TOL = 1e-5, 1e-4


# ---------------------------------------------------------------------------
# The CPU model of the products
# ---------------------------------------------------------------------------


class _ModelProduct(torch.autograd.Function):
    """``a @ b`` on ``engine``, its backward too: da = g b^T on the engine;
    db = a^T g on the engine where b is an activation (the attention's
    operands), in f32 where b is a weight (the weight-gradient launch)."""

    @staticmethod
    def forward(ctx, a, b, engine, weight):
        ctx.save_for_backward(a, b)
        ctx.engine, ctx.weight = engine, weight
        return engine(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = ctx.engine(g, b.transpose(-1, -2))
        if ctx.weight:
            db = a.reshape(-1, a.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        else:
            db = ctx.engine(a.transpose(-1, -2), g)
        return da, db, None, None


def _model_mm(engine):
    return lambda a, w: _ModelProduct.apply(a.float(), w.float(), engine,
                                            True)


def _model_attention(engine):
    """``fa._attention_heads`` with q k^T and P v on ``engine`` (f32)."""

    def attention(q, k, v, num_heads, dt):
        B, Nq, Cq = q.shape
        Nk = k.shape[1]
        dh = Cq // num_heads

        def heads(a, n):
            return a.reshape(B, n, num_heads, dh).transpose(1, 2).float()

        s = _ModelProduct.apply(heads(q, Nq), heads(k, Nk).transpose(-1, -2),
                                engine, False)
        o = _ModelProduct.apply(torch.softmax(s, dim=-1), heads(v, Nk),
                                engine, False)
        return o.transpose(1, 2).reshape(B, Nq, Cq).to(dt)

    return attention


def _t(rng, *shape, scale=1.0, offset=0.0, grad=True):
    a = (rng.normal(size=shape) * scale + offset).astype(np.float32)
    return torch.from_numpy(a).requires_grad_(grad)


def _decoder_case(kind, Nq, Nk, heads, mask_grad, clips=4, seed=0):
    """(run, zero): ``run(block_fn)`` gives the output and every leaf's
    gradient; ``zero``: the leaves (indices into the gradients) that are
    zero analytically."""
    rng = np.random.default_rng(seed + Nq + 3 * Nk + heads)
    masks = tuple(torch.from_numpy(
        ((rng.random((clips, 1, 1)) < 0.8) / 0.8).astype(np.float32))
        .requires_grad_(mask_grad) for _ in range(2))
    if kind == "ada":
        x = _t(rng, clips, Nq, C)
        gb = [_t(rng, clips, C, scale=0.1, offset=1.0 - i % 2)
              for i in range(4)]
        params = [_t(rng, C, 3 * C, scale=C ** -0.5),
                  _t(rng, 3 * C, scale=0.05),
                  _t(rng, C, C, scale=C ** -0.5), _t(rng, C, scale=0.05),
                  _t(rng, C, HID, scale=C ** -0.5), _t(rng, HID, scale=0.05),
                  _t(rng, HID, C, scale=HID ** -0.5), _t(rng, C, scale=0.05)]
        leaves = [x, *gb, *params]

        def block(fn):
            return fn(x, *gb, params, heads, 1e-6, masks)

        zero = ()
    else:
        xs = [_t(rng, clips, n, C) for n in (Nq, Nk, Nk)]
        conds = [_t(rng, clips, C, scale=0.1, offset=1.0 - i % 2)
                 for i in range(8)]
        params = [t for _ in range(4) for t in (
            _t(rng, C, C, scale=C ** -0.5), _t(rng, C, scale=0.05))]
        params += [_t(rng, C, HID, scale=C ** -0.5), _t(rng, HID, scale=0.05),
                   _t(rng, HID, C, scale=HID ** -0.5),
                   _t(rng, C, scale=0.05)]
        leaves = [*xs, *conds, *params]

        def block(fn):
            return fn(*xs, conds[0::2], conds[1::2], params, heads, 1e-6,
                      masks)

        zero = (6, 14)  # the keys' AdaLN beta and bias
    if mask_grad:
        leaves = leaves + list(masks)
    g = _t(rng, clips, Nq, C, grad=False)

    def run(fn):
        y = block(fn)
        return (y.detach(), *torch.autograd.grad(y, leaves, g))

    return run, zero


def _model_errors(kind, Nq, Nk, heads, mask_grad, engine):
    """(output error, [each gradient's error]) of the plain block with its
    products on ``engine`` against the plain block in f32."""
    run, zero = _decoder_case(kind, Nq, Nk, heads, mask_grad)
    plain = fa.ada_block_plain if kind == "ada" else fa.ca_block_plain
    want = run(plain)
    with mock.patch.object(fa, "mm", _model_mm(engine)), \
            mock.patch.object(fa, "_attention_heads",
                              _model_attention(engine)):
        got = run(plain)
    largest = max(float(b.abs().max()) for b in want[1:])
    errs = []
    for i, (a, b) in enumerate(zip(got, want)):
        scale = largest if i - 1 in zero else float(b.abs().max())
        errs.append(float((a - b).abs().max()) / scale)
    return errs[0], errs[1:]


# Phase 13a's three shapes: (kind, Nq, Nk, heads).
SHAPES = {"ada 431, 2 heads": ("ada", 431, 431, 2),
          "ca 17 over 431, 8 heads": ("ca", 17, 431, 8),
          "ca 431 over 17, 2 heads": ("ca", 431, 17, 2)}
ENGINES = {"lo-rounded": mm_3xtf32, "kernel-split": mm_3xtf32_kernel}


@pytest.mark.parametrize("mask_grad", [False, True],
                         ids=["masks", "mask-grads"])
@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_3xtf32_model_holds_the_cards_gates(shape, engine, mask_grad):
    kind, Nq, Nk, heads = SHAPES[shape]
    out, grads = _model_errors(kind, Nq, Nk, heads, mask_grad,
                               ENGINES[engine])
    n_leaves = (13 if kind == "ada" else 23) + 2 * mask_grad
    assert len(grads) == n_leaves
    print(f"3xTF32 model ({engine}), {shape}, mask grads {mask_grad}: "
          f"output {out:.3g}, worst gradient {max(grads):.3g}")
    assert out <= OUT_TOL, out
    assert max(grads) <= GRAD_TOL, grads


def test_one_tf32_pass_misses_the_gates():
    """Why the split: one TF32 product (10 mantissa bits) errs beyond the
    card's gates on the AdaLN block."""
    out, grads = _model_errors("ada", 431, 431, 2, False, mm_1xtf32)
    print(f"one TF32 pass, AdaLN block: output {out:.3g}, worst gradient "
          f"{max(grads):.3g}")
    assert out > OUT_TOL or max(grads) > GRAD_TOL, (out, grads)


# ---------------------------------------------------------------------------
# The backwards' plan
# ---------------------------------------------------------------------------

# (kind, clips, Nq, Nk, SMs) -> {program: waves}: phase 13a's shapes on an
# H100 SXM (132 SMs) and an H100 PCIe (114).
WAVES = {
    ("ada", 32, 431, 431, 132): {"queries": 1, "keys": 1,
                                 "finish queries": 1},
    ("ca", 32, 17, 431, 132): {"query attention": 1, "query tail": 1,
                               "keys": 1, "finish queries": 1,
                               "finish keys": 1},
    ("ca", 32, 431, 17, 132): {"queries": 1, "keys": 1, "finish queries": 1,
                               "finish keys": 1},
    ("ada", 32, 431, 431, 114): {"queries": 2, "keys": 2,
                                 "finish queries": 2},
    ("ca", 32, 17, 431, 114): {"query attention": 1, "query tail": 1,
                               "keys": 2, "finish queries": 1,
                               "finish keys": 2},
    ("ca", 32, 431, 17, 114): {"queries": 2, "keys": 1, "finish queries": 2,
                               "finish keys": 1},
}


@pytest.mark.parametrize("case", list(WAVES),
                         ids=[f"{k}-{q}x{n}-{s}sm" for k, _, q, n, s in WAVES])
def test_dec_plan_owns_every_tile_and_split_once(case):
    kind, clips, Nq, Nk, sms = case
    plan = fa.f32_dec_plan(kind, clips, Nq, Nk, sms)
    assert plan.ctas == sms
    assert {p.name: p.waves for p in plan.programs} == WAVES[case]
    chunks = {"queries": -(-Nk // 64), "keys": -(-Nq // 64)}
    for p in plan.programs:
        n = Nq if p.side == "queries" else Nk
        # Every item once, CTA by CTA in order; no more CTAs than resident.
        assert [i for cta in p.owned for i in cta] == list(p.items)
        assert p.ctas == len(p.owned) == min(len(p.items), sms) <= sms
        assert p.waves == max(len(cta) for cta in p.owned)
        per_clip = len(p.items) // clips
        assert list(p.items) == [(c, i) for c in range(clips)
                                 for i in range(per_clip)]
        if p.ranges:
            # A split short side: its rows whole a split, the long side's
            # chunks split in fixed contiguous ranges, merged in this order.
            assert p.rows == ((0, n),) and n <= 64
            assert per_clip == len(p.ranges) > 1
            assert p.ranges[0][0] == 0
            assert p.ranges[-1][1] == chunks[p.side]
            assert all(a[1] == b[0] for a, b in zip(p.ranges, p.ranges[1:]))
            assert all(c0 < c1 for c0, c1 in p.ranges)
            assert clips * per_clip <= sms
        else:
            # Row tiles: every row of the side once.
            rows = [r for r0, r1 in p.rows for r in range(r0, r1)]
            assert rows == list(range(n)) and per_clip == len(p.rows)
        if n <= 64 and kind == "ca":
            # No program over the short side is one CTA a clip.
            assert per_clip >= 2, p.name
    short = min(Nq, Nk)
    splits = (plan.splits_q, plan.splits_k)
    if kind == "ca":
        want = min(sms // clips, -(-max(Nq, Nk) // 64))
        assert splits == ((want, 1) if Nq == short else (1, want))
    else:
        assert splits == (1, 1)


def test_dec_plan_without_a_card_splits_every_chunk():
    """A CPU build of the sources runs a CTA an item: the short side split
    over every chunk of the long."""
    plan = fa.f32_dec_plan("ca", 2, 17, 130, None)
    assert (plan.splits_q, plan.splits_k) == (3, 1)
    attn = plan.programs[0]
    assert attn.name == "query attention" and attn.ranges == ((0, 1), (1, 2),
                                                              (2, 3))
    assert plan.ctas == max(len(p.items) for p in plan.programs)
    assert all(p.waves == 1 for p in plan.programs)


# ---------------------------------------------------------------------------
# The wrappers' CTA count
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["ada", "ca"])
def test_wrappers_pass_the_plans_ctas(kind):
    """With a gradient owed and masks: the backward's entry point gets the
    plan's CTA count for the card's SMs (here 9) after its other integers
    and before the stream; the CA block's workspace query gets it last."""
    Nq, Nk, heads = (40, 40, 2) if kind == "ada" else (17, 40, 8)
    run, _ = _decoder_case(kind, Nq, Nk, heads, True, clips=3)
    seen = []

    def call(name, table, *rest):
        seen.append((name, rest))

    def query(name, *rest):
        seen.append((name, rest))
        return 4096

    lib = _cuda.ADA_F32 if kind == "ada" else _cuda.CA_F32
    stubs = [mock.patch.object(fa, "_on_card", return_value=True),
             mock.patch.object(_cuda, "check_cuda"),
             mock.patch.object(_cuda, "stream_ptr",
                               return_value=_cuda.P(None)),
             mock.patch.object(fa, "_dec_f32_resident", return_value=9),
             mock.patch.object(lib, "call", call),
             mock.patch.object(lib, "query", query)]
    for s in stubs:
        s.start()
    try:
        run(fa.ada_block if kind == "ada" else fa.ca_block)
    finally:
        for s in reversed(stubs):
            s.stop()
    names = [name for name, _ in seen]
    plan = fa.f32_dec_plan(kind, 3, Nq, Nk, 9)
    assert plan.ctas == 9
    bwd = dict(seen)[f"pmce_{kind}_bwd_f32"]
    assert bwd[-2] == plan.ctas and isinstance(bwd[-1], ctypes.c_void_p)
    assert names == [f"pmce_{kind}_fwd_f32", f"pmce_{kind}_f32_workspace",
                     f"pmce_{kind}_bwd_f32"]
    ws = dict(seen)[f"pmce_{kind}_f32_workspace"]
    if kind == "ca":
        assert ws[-1] == plan.ctas and ws[:3] == (3, Nq, Nk)
    else:
        assert ws[:2] == (3, Nq)
