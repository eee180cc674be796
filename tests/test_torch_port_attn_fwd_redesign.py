"""The redesigned self-attention forward (row 4) and AdaLN block forward
(row 8), on the CPU.

The device test answers "card" and the libraries' ``call`` is stubbed
(``_stubs``), so each wrapper's route shows in the entry points it calls
and the pointer tables it hands them:

- row 8 inside ``ada_fwd_kernel_fits`` is one ``pmce_ada_fwd_tile`` call
  (launch A, then launch B, 4 CTAs a clip) on the parameters' own bf16
  weights, writing qkv always (launch B's keys), the rest of the saved
  state only when a gradient is owed and the branches a, mo only when a
  mask's is; other shapes take the launch sequence ``pmce_ada_block_fwd``
  (counter ``ada_block_fwd_seq``);
- row 4 inside ``mhsa_fwd_kernel_fits`` is one ``pmce_mhsa_fwd_tile``
  launch at C = 64 / heads of 8 and C = 256 / heads of 32, whole clips a
  CTA by ``mhsa_fwd_plan``; other shapes take ``pmce_mhsa_fwd`` (counter
  ``mhsa_fwd_seq``);
- the saved tensors rows 5 and 9 read keep their shapes and dtypes and
  reach the backwards' pointer tables.
"""

from __future__ import annotations

from unittest import mock

import numpy as np
import pytest
import torch

from pmce_tpu_torch.ops import _cuda
from pmce_tpu_torch.ops import fused_attention as fa
from tests.test_torch_port_bwd_redesign import _enter, _stubs
from tests.test_torch_port_decoder_redesign import _bf16_ada
from tests.test_torch_port_fwd_redesign import _Launches

# pmce_ada_fwd_tile's table: x, g1, b1, g2, b2, m1, m2, wqkv, wproj, w1, w2,
# bqkv, bproj, bb1, bb2, out, qkv, h1, o, stat_m, stat_l, x1, h2, hh, ge, a,
# mo, stamps. pmce_ada_block_fwd's: x, 4 conds, m1, m2, wqkv, bqkv, wproj,
# bproj, w1, bb1, w2, bb2, h1, qkv, o, stat_m, stat_l, x1, h2, hh, ge, out,
# a, mo.
_ADA_PTRS = {"pmce_ada_fwd_tile": 28, "pmce_ada_block_fwd": 27,
             "pmce_ada_bwd_tile": 30, "pmce_ada_wgrad": 12}
_ADA_SAVED = range(17, 25)
# pmce_mhsa_fwd_tile's: x, wqkv, bqkv, wproj, bproj, out, qkv, o, stat_m,
# stat_l, stamps. pmce_mhsa_fwd's: x, wqkv, bqkv, wproj, bproj, qkv, o,
# stat_m, stat_l, out. pmce_mhsa_bwd_tile's: g, wqkv, wproj, qkv, o, stat_m,
# stat_l, dx, dqkv, counters, stamps. pmce_mhsa_wgrad's: x, o, dqkv, g,
# partial, vpartial, counters, grads. pmce_mhsa_bwd's (the sequence): x, g,
# wqkvᵀ, wprojᵀ, qkv, o, stat_m, stat_l, dx, grads, ws.
_MHSA_PTRS = {"pmce_mhsa_fwd_tile": 11, "pmce_mhsa_fwd": 10,
              "pmce_mhsa_bwd_tile": 11, "pmce_mhsa_wgrad": 8,
              "pmce_mhsa_bwd": 11}
_NO_WORKSPACE = mock.patch.object(
    fa, "_workspace", lambda *a: torch.empty(0, dtype=torch.uint8))


def _r(rng, *shape, dtype=torch.float32, grad=False):
    a = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return a.to(dtype).requires_grad_(grad)


def _mhsa(clips, N, C, H, grad=False):
    rng = np.random.default_rng([clips, N, C, H])
    bf = torch.bfloat16
    return (_r(rng, clips, N, C, dtype=bf, grad=grad),
            _r(rng, C, 3 * C, dtype=bf, grad=grad), _r(rng, 3 * C, grad=grad),
            _r(rng, C, C, dtype=bf, grad=grad), _r(rng, C, grad=grad))


# --------------------------------------------------------------- the gates
def test_forward_gates():
    """Row 4's: up to 64 tokens, (C, head width) in (64, 8 | 16 | 32) or
    (256, 32). Row 8's: the backward's (C = 64, hid up to 256, up to 512
    tokens)."""
    assert fa.mhsa_fwd_kernel_fits(17, 64, 8)
    assert fa.mhsa_fwd_kernel_fits(17, 256, 8)
    assert fa.mhsa_fwd_kernel_fits(16, 256, 8)
    assert fa.mhsa_fwd_kernel_fits(64, 64, 2)
    assert not fa.mhsa_fwd_kernel_fits(65, 64, 8)
    assert not fa.mhsa_fwd_kernel_fits(80, 64, 4)
    assert not fa.mhsa_fwd_kernel_fits(17, 128, 8)     # heads of 16 at 128
    assert not fa.mhsa_fwd_kernel_fits(17, 256, 16)    # heads of 16 at 256
    assert fa.ada_fwd_kernel_fits(431, 64, 256)
    assert fa.ada_fwd_kernel_fits(512, 64, 128)
    assert not fa.ada_fwd_kernel_fits(513, 64, 256)
    assert not fa.ada_fwd_kernel_fits(431, 64, 512)
    assert not fa.ada_fwd_kernel_fits(431, 128, 256)


@pytest.mark.parametrize("clips,N,C,sms", [
    (32, 17, 64, 132), (512, 17, 256, 132), (544, 16, 256, 132),
    (4096, 19, 256, 132), (512, 17, 256, 114), (7, 64, 64, 132),
    (300, 17, 64, 132), (1, 1, 64, 132)], ids=str)
def test_mhsa_plan_covers_every_clip_once(clips, N, C, sms):
    """``mhsa_fwd_plan``: whole clips of at most 128 rows a CTA, every
    clip's rows in exactly one CTA's tile; one wave (at most one CTA an SM
    at C = 256, two at C = 64) whenever the clips fit one; one clip a CTA
    at the decoder's 32 clips, 128 CTAs of 4 at the trunk's 512."""
    cpc = fa.mhsa_fwd_plan(clips, N, C, sms)
    assert cpc >= 1 and cpc * N <= 128
    ctas = -(-clips // cpc)
    owner = np.full(clips * N, -1)
    for cta in range(ctas):
        rows0 = cta * cpc * N
        nrows = min(cpc, clips - cta * cpc) * N
        assert nrows > 0 and rows0 % N == 0 and nrows % N == 0
        assert (owner[rows0:rows0 + nrows] == -1).all()
        owner[rows0:rows0 + nrows] = cta
    assert (owner >= 0).all()
    per_sm = 1 if C == 256 else 2
    if clips <= sms * per_sm * (128 // N):
        assert ctas <= sms * per_sm
    if (clips, N) == (32, 17):
        assert cpc == 1 and ctas == 32
    if (clips, N, C, sms) == (512, 17, 256, 132):
        assert cpc == 4 and ctas == 128


# ------------------------------------------------------- row 8 on the card
@pytest.mark.parametrize("N,H", [(431, 2), (17, 8), (512, 4)],
                         ids=["431", "17", "512"])
def test_ada_forward_inside_the_gate_is_one_tile_call(N, H):
    """Inside the gate the forward is one ``pmce_ada_fwd_tile`` call (its
    launch A, then its launch B), counted once by ``ada_block_fwd``: the
    four bf16 weights on the parameters' own pointers (no transposed copy:
    ``_bf16_mat_t`` is never called), out and qkv always, not stamped."""
    B = 3
    x, gb, params, masks = _bf16_ada(B, N, H)
    launches = _Launches(_ADA_PTRS)
    _cuda.reset_launch_counts()
    with _enter(_stubs(launches, _cuda.ADA)), torch.no_grad(), \
            mock.patch.object(fa, "_bf16_mat_t",
                              side_effect=AssertionError("a transpose")):
        fa.ada_block(x, *gb, params, H, 1e-6, masks)
    assert launches.names == ["pmce_ada_fwd_tile"]
    (_, ptrs, ints), = launches.calls
    assert tuple(ints[:4]) == (B, N, 256, H)
    assert ptrs[0] == x.data_ptr()
    assert ptrs[7:11] == [params[i].data_ptr() for i in (0, 2, 4, 6)]
    assert ptrs[15] and ptrs[16] and ptrs[27] == 0
    counts = _cuda.launch_counts()
    assert counts["ada_block_fwd"] == 1 and counts["ada_block_fwd_seq"] == 0


@pytest.mark.parametrize("grad,mask_grad", [
    (False, False), (True, False), (True, True), (False, True)],
    ids=["no-grad", "grad", "grad-mask-grads", "no-grad-mask-grads"])
def test_ada_forward_saves_only_what_is_owed(grad, mask_grad):
    """The tile call writes h1, o, the softmax statistics, x1, h2, hh and
    ge only when a gradient is owed, and a, mo only when a mask's is under
    grad; what it does not write comes back as None in ``saved``."""
    B, N, H = 2, 431, 2
    x, gb, params, masks = _bf16_ada(B, N, H, mask_grad=mask_grad)
    launches = _Launches(_ADA_PTRS)
    captured = {}
    real = fa._ada_fwd_cuda

    def spy(*args, **kw):
        out, saved = real(*args, **kw)
        captured["saved"] = saved
        return out, saved

    with _enter(_stubs(launches, _cuda.ADA)), \
            mock.patch.object(fa, "_ada_fwd_cuda", spy), \
            torch.set_grad_enabled(grad):
        fa.ada_block(x, *gb, params, H, 1e-6, masks)
    (_, ptrs, _), = launches.calls
    assert [bool(ptrs[i]) for i in _ADA_SAVED] == [grad] * 8
    assert bool(ptrs[25]) == bool(ptrs[26]) == (grad and mask_grad)
    saved = captured["saved"]
    h1, qkv, o, stats, x1, h2, hh, ge, a, mo = saved[4:]
    assert all((t is not None) == grad
               for t in (h1, qkv, o, stats, x1, h2, hh, ge))
    assert (a is not None) == (mo is not None) == (grad and mask_grad)


@pytest.mark.parametrize("B,N,C,H,hid", [(2, 431, 64, 2, 512),
                                         (2, 600, 64, 2, 256),
                                         (2, 40, 128, 4, 256)],
                         ids=["hid-512", "N-600", "C-128"])
def test_ada_forward_outside_the_gate_takes_the_launch_sequence(B, N, C, H,
                                                                hid):
    """Shapes the tile programs are not built for (hid 512, 600 tokens, C
    = 128) run the launch sequence ``pmce_ada_block_fwd``, counted by
    ``ada_block_fwd_seq`` alone; it writes every intermediate it chains
    through whatever the grad mode."""
    assert not fa.ada_fwd_kernel_fits(N, C, hid)
    x, gb, params, masks = _bf16_ada(B, N, H, C=C, hid=hid)
    launches = _Launches(_ADA_PTRS)
    _cuda.reset_launch_counts()
    with _enter(_stubs(launches, _cuda.ADA)), torch.no_grad():
        fa.ada_block(x, *gb, params, H, 1e-6, masks)
    assert launches.names == ["pmce_ada_block_fwd"]
    (_, ptrs, ints), = launches.calls
    assert tuple(ints[:5]) == (B, N, C, hid, H)
    assert all(ptrs[15:25]) and ptrs[25] == ptrs[26] == 0
    counts = _cuda.launch_counts()
    assert counts["ada_block_fwd_seq"] == 1 and counts["ada_block_fwd"] == 0


def test_ada_saved_state_reaches_row_9_in_its_layout():
    """Under grad with mask gradients, the saved state keeps the layout row
    9 reads (h1, qkv, o bf16; the softmax max and sum [2, B * H * N] f32;
    x1, hh, a, mo f32; h2, ge bf16) and reaches the backward's tile
    program and weight launch on the forward's own pointers."""
    B, N, H, C, hid = 2, 431, 2, 64, 256
    M = B * N
    x, gb, params, masks = _bf16_ada(B, N, H, mask_grad=True)
    launches = _Launches(_ADA_PTRS)
    captured = {}
    real = fa._ada_fwd_cuda

    def spy(*args, **kw):
        out, saved = real(*args, **kw)
        captured["saved"] = saved
        return out, saved

    with _enter(_stubs(launches, _cuda.ADA)), \
            mock.patch.object(fa, "_ada_fwd_cuda", spy):
        y = fa.ada_block(x, *gb, params, H, 1e-6, masks)
        y.backward(torch.zeros_like(y))
    h1, qkv, o, stats, x1, h2, hh, ge, a, mo = captured["saved"][4:]
    bf, f32 = torch.bfloat16, torch.float32
    for t, shape, dt in ((h1, (M, C), bf), (qkv, (M, 3 * C), bf),
                         (o, (M, C), bf), (stats, (2, B * H * N), f32),
                         (x1, (M, C), f32), (h2, (M, C), bf),
                         (hh, (M, hid), f32), (ge, (M, hid), bf),
                         (a, (M, C), f32), (mo, (M, C), f32)):
        assert tuple(t.shape) == shape and t.dtype == dt
    assert launches.names == ["pmce_ada_fwd_tile", "pmce_ada_bwd_tile",
                              "pmce_ada_wgrad"]
    (_, fwd, _), (_, tile, _), (_, wg, _) = launches.calls
    assert fwd[16] == tile[10] == qkv.data_ptr()
    assert fwd[18] == tile[11] == o.data_ptr()
    assert fwd[19:21] == tile[12:14]                          # stat_m, l
    assert fwd[21] == tile[14] and fwd[23] == tile[15]       # x1, hh
    assert fwd[25:27] == tile[16:18]                          # a, mo
    assert [fwd[17], fwd[18], fwd[22], fwd[24]] == wg[0:4]    # h1 o h2 ge


def test_ada_forward_stage_split_books_both_launches():
    """``ada_fwd_stage_split`` at [32, 431, 64] runs the stamped programs
    once (saving, stamps for 128 CTAs of each launch: 4 a clip, one wave
    on 132 SMs), not counted, and books every stage of
    ``ADA_FWD_STAGES``."""
    B, N, H = 32, 431, 2
    x, gb, params, _ = _bf16_ada(B, N, H)
    launches = _Launches(_ADA_PTRS)
    _cuda.reset_launch_counts()
    with _enter(_stubs(launches, _cuda.ADA)):
        split = fa.ada_fwd_stage_split(x, gb, params, H)
    assert launches.names == ["pmce_ada_fwd_tile"]
    (_, ptrs, _), = launches.calls
    assert ptrs[27] != 0 and all(ptrs[i] for i in _ADA_SAVED)
    assert split["ctas"] == B * fa.ADA_FWD_CTAS == 128
    assert set(split) == {*fa.ADA_FWD_STAGES, "ctas"}
    assert _cuda.launch_counts()["ada_block_fwd"] == 0


# ------------------------------------------------------- row 4 on the card
@pytest.mark.parametrize("clips,N,C,H,cpc", [
    (32, 17, 64, 8, 1), (512, 17, 256, 8, 4), (544, 16, 256, 8, 5)],
    ids=["decoder", "trunk-spatial", "trunk-temporal"])
@pytest.mark.parametrize("grad", [False, True], ids=["no-grad", "grad"])
def test_mhsa_forward_inside_the_gate_is_one_launch(clips, N, C, H, cpc,
                                                    grad):
    """Inside the gate the forward is one ``pmce_mhsa_fwd_tile`` launch at
    both widths, counted once by ``mhsa_fwd``, on the parameters' own bf16
    weights, with ``mhsa_fwd_plan``'s clips a CTA (the card stood in for by
    132 SMs); qkv, o and the softmax statistics only when a gradient is
    owed; not stamped."""
    x, *w = _mhsa(clips, N, C, H, grad=True)
    launches = _Launches(_MHSA_PTRS)
    _cuda.reset_launch_counts()
    with _enter(_stubs(launches, _cuda.MHSA)), torch.set_grad_enabled(grad):
        fa.fused_mhsa(x, *w, H)
    assert launches.names == ["pmce_mhsa_fwd_tile"]
    (_, ptrs, ints), = launches.calls
    assert tuple(ints[:5]) == (clips, N, C, H, cpc)
    assert ptrs[0] == x.data_ptr()
    assert [ptrs[1], ptrs[3]] == [w[0].data_ptr(), w[2].data_ptr()]
    assert ptrs[5] != 0 and ptrs[10] == 0
    assert [bool(p) for p in ptrs[6:10]] == [grad] * 4
    counts = _cuda.launch_counts()
    assert counts["mhsa_fwd"] == 1 and counts["mhsa_fwd_seq"] == 0


@pytest.mark.parametrize("clips,N,C,H", [(3, 80, 64, 4), (3, 17, 128, 8)],
                         ids=["N-80-head-16", "C-128-head-16"])
def test_mhsa_forward_outside_the_gate_takes_the_launch_sequence(clips, N, C,
                                                                 H):
    """Over 64 tokens, or at a width the tile program is not built for, the
    forward is the launch sequence ``pmce_mhsa_fwd``, counted by
    ``mhsa_fwd_seq`` alone; it writes the saved state always."""
    assert not fa.mhsa_fwd_kernel_fits(N, C, H)
    x, *w = _mhsa(clips, N, C, H)
    launches = _Launches(_MHSA_PTRS)
    _cuda.reset_launch_counts()
    with _enter(_stubs(launches, _cuda.MHSA)), torch.no_grad():
        fa.fused_mhsa(x, *w, H)
    assert launches.names == ["pmce_mhsa_fwd"]
    (_, ptrs, ints), = launches.calls
    assert tuple(ints[:4]) == (clips, N, C, H)
    assert all(ptrs)
    counts = _cuda.launch_counts()
    assert counts["mhsa_fwd_seq"] == 1 and counts["mhsa_fwd"] == 0


@pytest.mark.parametrize("clips,N,C,H", [(32, 17, 64, 8), (40, 17, 256, 8)],
                         ids=["decoder", "trunk"])
def test_mhsa_saved_state_reaches_row_5_in_its_layout(clips, N, C, H):
    """Under grad the tile program's saved qkv [M, 3C] and o [M, C] (bf16)
    and the softmax max and sum ([2, clips * H * N] f32) are what the
    backward's tile program reads, on the forward's own pointers, and o is
    the weight launch's X beside the tile program's dqkv; the gradients
    come back in the parameters' shapes."""
    x, *w = _mhsa(clips, N, C, H, grad=True)
    launches = _Launches(_MHSA_PTRS)
    captured = {}
    real = fa._mhsa_fwd_cuda

    def spy(*args, **kw):
        out, saved = real(*args, **kw)
        captured["saved"] = saved
        return out, saved

    with _enter(_stubs(launches, _cuda.MHSA)), _NO_WORKSPACE, \
            mock.patch.object(fa, "_mhsa_fwd_cuda", spy):
        y = fa.fused_mhsa(x, *w, H)
        y.backward(torch.zeros_like(y))
    qkv, o, stats = captured["saved"]
    M = clips * N
    assert tuple(qkv.shape) == (M, 3 * C) and qkv.dtype == torch.bfloat16
    assert tuple(o.shape) == (M, C) and o.dtype == torch.bfloat16
    assert tuple(stats.shape) == (2, clips * H * N)
    assert stats.dtype == torch.float32
    assert launches.names == ["pmce_mhsa_fwd_tile", "pmce_mhsa_bwd_tile",
                              "pmce_mhsa_wgrad"]
    (_, fwd, _), (_, bwd, _), (_, wg, _) = launches.calls
    assert fwd[6:10] == bwd[3:7] == [qkv.data_ptr(), o.data_ptr(),
                                     stats[0].data_ptr(),
                                     stats[1].data_ptr()]
    assert wg[1] == o.data_ptr() and wg[2] == bwd[8]       # o, dqkv
    assert all(t.grad is not None and t.grad.shape == t.shape
               for t in (x, *w))


def test_mhsa_forward_stage_split_is_one_stamped_launch():
    """``mhsa_fwd_stage_split`` runs the saving tile program once with the
    stamps' pointer set ([ctas, 4] int64), not counted, and books every
    stage of ``MHSA_FWD_STAGES``; a given clips a CTA reaches the launch."""
    x, *w = _mhsa(512, 17, 256, 8)
    launches = _Launches(_MHSA_PTRS)
    _cuda.reset_launch_counts()
    with _enter(_stubs(launches, _cuda.MHSA)):
        split = fa.mhsa_fwd_stage_split(x, *w, 8, clips_per_cta=7)
    assert launches.names == ["pmce_mhsa_fwd_tile"]
    (_, ptrs, ints), = launches.calls
    assert ints[4] == 7 and ptrs[10] != 0 and all(ptrs[6:10])
    assert set(split) == {*fa.MHSA_FWD_STAGES, "ctas", "clips_per_cta"}
    assert split["ctas"] == 74 and split["clips_per_cta"] == 7
    assert _cuda.launch_counts()["mhsa_fwd"] == 0
