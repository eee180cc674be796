"""Rows 6f / 7f redesigned (``csrc/block_f32.cu``): the host side, on the
CPU.

- the persistent grid's plan (``f32_block_plan``) at the Stage-1 and f32
  serving shapes on 132 and 114 SMs: every clip owned once, every tile
  whole clips of at most 64 rows, no more CTAs than the card holds at
  once, the CTAs' shares within one clip, the rounds stated;
- the products' numerics before any CUDA: a CPU model of 3xTF32 (each
  operand split as hi = tf32_rna(v), lo = tf32_rna(v - hi); a product sums
  a_lo b_hi + a_hi b_lo + a_hi b_hi in f32; also with the kernels' split,
  lo = v - hi read to its top 19 bits) patched over ``fa.mm``, which
  the plain block calls for every product, against the plain f32 block at
  C 256, hid 512, 8 heads: outputs within the card's 1e-5 and every
  gradient within its 1e-4 of their largest magnitude (``chip_smoke.py``'s
  ``F32_KERNEL_REL_TOL`` / ``F32_GRAD_REL_TOL``). The weight gradients stay
  true f32 (the f32 weight-gradient launch, FFMA), the activation
  gradients' products 3xTF32, as on the card; one TF32 pass misses the
  gate;
- ``tf32_rna`` (cvt.rna.tf32.f32: to nearest, ties away from zero) on
  hand-worked bit patterns;
- the wrappers pass the plan's CTA count to both entry points (the card
  stood in for);
- ``prefetch_to_device`` defaults to the card, as the port's other entry
  points.

``slow``: the CPU build of the source (``tests/cuda_cpu/``) with the grid
cut to 1 and 2 CTAs, so that a CTA runs several tiles.
"""

from __future__ import annotations

import ctypes
import inspect
from unittest import mock

import numpy as np
import pytest
import torch

from pmce_tpu_torch.ops import _cuda
from pmce_tpu_torch.ops import fused_attention as fa
from pmce_tpu_torch.parallel.prefetch import prefetch_to_device

C, HID, HEADS = 256, 512, 8
OUT_TOL, GRAD_TOL = 1e-5, 1e-4

# (clips, N, SMs) -> the most tiles a CTA takes: Stage 1's spatial and
# temporal blocks, the f32 serving forward's, on an H100 SXM (132 SMs) and
# an H100 PCIe (114).
ROUNDS = {(1024, 17, 132): 3, (1088, 16, 132): 3, (4096, 19, 132): 11,
          (4864, 16, 132): 10, (1024, 17, 114): 3, (1088, 16, 114): 3,
          (4096, 19, 114): 12, (4864, 16, 114): 11}


@pytest.mark.parametrize("clips,N,sms", list(ROUNDS),
                         ids=[f"{c}x{n}-{s}sm" for c, n, s in ROUNDS])
def test_wave_plan_owns_every_clip_once_in_whole_tiles(clips, N, sms):
    plan = fa.f32_block_plan(clips, N, sms)
    tiles = -(-clips // (64 // N))
    assert plan.ctas == min(tiles, sms) and len(plan.tiles) == plan.ctas
    owned = [c for cta in plan.tiles for c0, n in cta
             for c in range(c0, c0 + n)]
    assert owned == list(range(clips))  # once each, CTA by CTA in order
    assert all(1 <= n and n * N <= 64 for cta in plan.tiles for _, n in cta)
    shares = [sum(n for _, n in cta) for cta in plan.tiles]
    assert set(shares) <= {clips // plan.ctas, -(-clips // plan.ctas)}
    assert plan.rounds == ROUNDS[clips, N, sms]
    assert plan.rounds == max(len(cta) for cta in plan.tiles)


def test_wave_plan_without_a_card_is_a_cta_a_tile():
    plan = fa.f32_block_plan(7, 17, None)
    assert plan.ctas == 3 and plan.rounds == 1
    assert plan.tiles == (((0, 2),), ((2, 2),), ((4, 3),))


# ---------------------------------------------------------------------------
# The CPU model of the products
# ---------------------------------------------------------------------------


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """f32 to TF32 (10 mantissa bits) to nearest, ties away from zero, as
    cvt.rna.tf32.f32: half a TF32 ulp added to the magnitude bits, the low
    13 bits cut (finite values)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(v: torch.Tensor) -> torch.Tensor:
    """The TF32 value the tensor cores read of an f32 operand: its top 19
    bits."""
    return (v.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(v: torch.Tensor):
    """hi = tf32_rna(v), lo = tf32_rna(v - hi)."""
    hi = tf32_rna(v)
    return hi, tf32_rna(v - hi)


def split_as_the_kernel(v: torch.Tensor):
    """``csrc/common.cuh``'s ``split_tf32``: hi = tf32_rna(v) by an integer
    add and mask, lo = v - hi as it is, of which the tensor cores read the
    top 19 bits."""
    hi = tf32_rna(v)
    return hi, tf32_trunc(v - hi)


def mm_3xtf32(a: torch.Tensor, w: torch.Tensor, splitter=split):
    (ah, al), (wh, wl) = splitter(a), splitter(w)
    return (al @ wh + ah @ wl) + ah @ wh


def mm_3xtf32_kernel(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return mm_3xtf32(a, w, split_as_the_kernel)


def mm_1xtf32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return tf32_rna(a) @ tf32_rna(w)


class _ModelProduct(torch.autograd.Function):
    """``a @ w`` with the kernels' product engine: forward and the
    activation gradient through ``engine``, the weight gradient in f32."""

    @staticmethod
    def forward(ctx, a, w, engine):
        ctx.save_for_backward(a, w)
        ctx.engine = engine
        return engine(a, w)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        da = ctx.engine(g, w.t())
        dw = a.reshape(-1, a.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        return da, dw, None


def _model_mm(engine):
    return lambda a, w: _ModelProduct.apply(a.float(), w.float(), engine)


def _block_errors(N: int, engine, clips: int = 6):
    """The plain block with its products on ``engine`` against the plain
    block: (output error, [each gradient's error]) relative to each one's
    largest magnitude; the post-norm and masks that require grad."""
    rng = np.random.default_rng(N)

    def t(*shape, scale=1.0, offset=0.0):
        a = rng.normal(size=shape) * scale + offset
        return torch.from_numpy(a.astype(np.float32)).requires_grad_(True)

    params = (t(C, scale=0.1, offset=1.0), t(C, scale=0.1),
              t(C, 3 * C, scale=C ** -0.5), t(3 * C, scale=0.05),
              t(C, C, scale=C ** -0.5), t(C, scale=0.05),
              t(C, scale=0.1, offset=1.0), t(C, scale=0.1),
              t(C, HID, scale=C ** -0.5), t(HID, scale=0.05),
              t(HID, C, scale=HID ** -0.5), t(C, scale=0.05),
              t(C, scale=0.1, offset=1.0), t(C, scale=0.1))
    x = t(clips, N, C)
    masks = tuple(torch.from_numpy(
        ((rng.random((clips, 1, 1)) < 0.8) / 0.8).astype(np.float32))
        .requires_grad_(True) for _ in range(2))
    g = torch.from_numpy(rng.normal(size=(clips, N, C)).astype(np.float32))
    leaves = [x, *params, *masks]

    def run():
        y = fa.transformer_block_plain(x, params, HEADS, branch_masks=masks)
        return (y.detach(), *torch.autograd.grad(y, leaves, g))

    want = run()
    with mock.patch.object(fa, "mm", _model_mm(engine)):
        got = run()
    errs = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(got, want)]
    return errs[0], errs[1:]


ENGINES = {"lo-rounded": mm_3xtf32, "kernel-split": mm_3xtf32_kernel}


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("N", [16, 17, 19])
def test_3xtf32_model_holds_the_cards_gates(N, engine):
    out, grads = _block_errors(N, ENGINES[engine])
    assert len(grads) == 17
    assert out <= OUT_TOL, out
    assert max(grads) <= GRAD_TOL, grads


def test_one_tf32_pass_misses_the_output_gate():
    """Why the split: one TF32 product keeps 10 mantissa bits, and the
    block's output then errs beyond the card's 1e-5."""
    out, _ = _block_errors(17, mm_1xtf32)
    assert out > OUT_TOL, out


# bits in -> cvt.rna.tf32.f32's bits out
TF32_CASES = {
    "one": (0x3F800000, 0x3F800000),
    "below half an ulp": (0x3F800FFF, 0x3F800000),
    "tie, kept bit even: away": (0x3F801000, 0x3F802000),
    "tie, kept bit odd: away": (0x3F803000, 0x3F804000),
    "above half an ulp": (0x3F801001, 0x3F802000),
    "negative tie: away": (0xBF801000, 0xBF802000),
    "negative below half": (0xBF800FFF, 0xBF800000),
    "carry into the exponent": (0x3FFFF000, 0x40000000),
    "zero": (0x00000000, 0x00000000),
    "negative zero": (0x80000000, 0x80000000),
}


@pytest.mark.parametrize("case", list(TF32_CASES))
def test_tf32_rna_bit_patterns(case):
    src, want = TF32_CASES[case]
    v = torch.tensor([src], dtype=torch.int64).to(torch.int32)
    got = tf32_rna(v.view(torch.float32)).view(torch.int32)
    assert int(got.item()) & 0xFFFFFFFF == want


# ---------------------------------------------------------------------------
# The wrappers' CTA count, the prefetch's device
# ---------------------------------------------------------------------------


def test_wrappers_pass_the_plans_ctas():
    """With a gradient owed and masks: the forward's and the backward's
    entry points get the plan's CTA count for the card's SMs (here 2: 5
    clips of 17 make 2 tiles), after their other integers and before the
    stream; the backward's row ranges stay where they were."""
    rng = np.random.default_rng(0)
    clips, N = 5, 17

    def t(*shape, scale=0.2):
        a = rng.normal(size=shape) * scale
        return torch.from_numpy(a.astype(np.float32)).requires_grad_(True)

    params = (t(C), t(C), t(C, 3 * C), t(3 * C), t(C, C), t(C), t(C), t(C),
              t(C, HID), t(HID), t(HID, C), t(C), t(C), t(C))
    x = t(clips, N, C)
    masks = tuple(torch.ones(clips, 1, 1) for _ in range(2))
    seen = []

    def call(name, table, *rest):
        seen.append((name, rest))

    stubs = [mock.patch.object(fa, "_on_card", return_value=True),
             mock.patch.object(_cuda, "check_cuda"),
             mock.patch.object(_cuda, "stream_ptr",
                               return_value=_cuda.P(None)),
             mock.patch.object(fa, "_block_f32_resident", return_value=2),
             mock.patch.object(_cuda.BLOCK_F32, "call", call)]
    for s in stubs:
        s.start()
    try:
        y = fa.transformer_block(x, params, HEADS, branch_masks=masks)
        torch.autograd.grad(y, [x, *params], torch.ones_like(y))
    finally:
        for s in reversed(stubs):
            s.stop()
    assert [name for name, _ in seen] == ["pmce_block_fwd_f32",
                                          "pmce_block_bwd_f32"]
    fwd, bwd = seen[0][1], seen[1][1]
    assert fwd[:3] == bwd[:3] == (clips, N, HID)
    assert fwd[6] == 2 and isinstance(fwd[7], ctypes.c_void_p)
    assert bwd[6] == fa.f32_wgrad_splits(
        clips * N, ((C, 3 * C), (C, C), (C, HID), (HID, C)), x.device)
    assert bwd[7] == 2


def test_prefetch_defaults_to_the_card():
    """As every other entry point of the port (and JAX's, which puts the
    batches on the accelerator): read from the signature, no CUDA touched."""
    default = inspect.signature(prefetch_to_device).parameters["device"]
    assert default.default == "cuda"


# ---------------------------------------------------------------------------
# The source built for the CPU, several tiles a CTA
# ---------------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("clips,N,resident", [(7, 17, 1), (9, 16, 2)])
def test_cpu_build_persistent_ctas_match_plain(tmp_path_factory, clips, N,
                                               resident):
    """The g++ build of ``csrc/block_f32.cu`` (over the shim's stand-ins
    for cp.async, cvt.rna and mma.sync) with 1 or 2 CTAs, so that each
    runs 2-3 tiles and sums its tiles' vector partials: forward and every
    gradient within 1e-5 of the plain version, a rerun bit for bit."""
    import test_torch_port_f32_cpu_build as cb

    libs = cb.cpu_libs.__wrapped__(tmp_path_factory)
    rng = np.random.default_rng(clips)
    hid = 128
    params = (cb._t(rng, C, scale=0.1, offset=1.0), cb._t(rng, C, scale=0.1),
              cb._t(rng, C, 3 * C, scale=C ** -0.5),
              cb._t(rng, 3 * C, scale=0.05),
              cb._t(rng, C, C, scale=C ** -0.5), cb._t(rng, C, scale=0.05),
              cb._t(rng, C, scale=0.1, offset=1.0), cb._t(rng, C, scale=0.1),
              cb._t(rng, C, hid, scale=C ** -0.5),
              cb._t(rng, hid, scale=0.05),
              cb._t(rng, hid, C, scale=hid ** -0.5),
              cb._t(rng, C, scale=0.05),
              cb._t(rng, C, scale=0.1, offset=1.0), cb._t(rng, C, scale=0.1))
    x = cb._t(rng, clips, N, C)
    masks = tuple(torch.from_numpy(
        ((rng.random((clips, 1, 1)) < 0.7) / 0.7).astype(np.float32))
        .requires_grad_(True) for _ in range(2))
    g = cb._t(rng, clips, N, C, grad=False)
    leaves = [x, *params, *masks]

    def step(block):
        y = block(x, params, HEADS, branch_masks=masks)
        return (y, *torch.autograd.grad(y, leaves, g))

    with mock.patch.object(fa, "_block_f32_resident",
                           return_value=resident):
        got, counts = cb._as_card(libs, lambda: step(fa.transformer_block))
        again, _ = cb._as_card(libs, lambda: step(fa.transformer_block))
    want = step(fa.transformer_block_plain)
    assert counts == {"block_fwd_f32": 1, "block_bwd_f32": 1}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and cb._rel(a, b) <= cb.TOL, (i,
                                                                cb._rel(a, b))
