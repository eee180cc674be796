"""The redesigned CA block forward (row 10), AdaLN block backward (row 9)
and the AdaLN block forward's saved branches (row 8), on the CPU.

The device test answers "card" and the libraries' ``call`` is stubbed
(``_stubs``), so each wrapper's route shows in the entry points it calls
and the pointer tables it hands them:

- row 10 is one launch of ``pmce_ca_fwd_tile`` in both Stage-2
  orientations, on the parameters' own bf16 weights, writing the saved
  state only when a gradient is owed and the branches a, mo only when a
  mask's is; shapes outside ``ca_bwd_kernel_fits`` take the launch
  sequence ``pmce_ca_block_fwd``;
- row 9 is ``pmce_ada_bwd_tile`` then ``pmce_ada_wgrad``, reading the
  forward's bf16 weights (no transposed copy), with dm1, dm2 only when
  owed; shapes outside ``ada_bwd_kernel_fits`` (hid over 256, C other
  than 64) take the launch sequence ``pmce_ada_block_bwd``, which gives
  the mask gradients too;
- row 8 (its two tile programs, ``pmce_ada_fwd_tile``, inside the gate;
  the launch sequence ``pmce_ada_block_fwd`` outside it) saves a, mo
  only when a mask's gradient is owed under grad mode.
"""

from __future__ import annotations

from unittest import mock

import numpy as np
import pytest
import torch

from pmce_tpu_torch.ops import _cuda
from pmce_tpu_torch.ops import fused_attention as fa
from tests.test_torch_port_bwd_redesign import _enter, _stubs
from tests.test_torch_port_fwd_redesign import _CA_PTRS, _Launches, _bf16_ca

# pmce_ca_fwd_tile's table: xq, xk, xv, 8 conds, m1, m2, wq, wk, wv, wproj,
# w1, w2, bq, bk, bv, bproj, bb1, bb2, out, nq, nk, nv, q, k, v, o, stat_m,
# stat_l, x1, h2, hh, ge, a, mo, stamps.
_CA_SAVED = range(26, 39)
# pmce_ada_fwd_tile's (row 8 inside its gate): x, 4 conds, m1, m2, wqkv,
# wproj, w1, w2, bqkv, bproj, bb1, bb2, out, qkv, h1, o, stat_m, stat_l,
# x1, h2, hh, ge, a, mo, stamps. pmce_ada_block_fwd's (the sequence outside
# the gate): x, 4 conds, m1, m2, wqkv, bqkv, wproj, bproj, w1, bb1, w2,
# bb2, h1, qkv, o, stat_m, stat_l, x1, h2, hh, ge, out, a, mo.
# pmce_ada_bwd_tile's: x, g, g1, g2, m1, m2, wqkv, wproj, w1, w2, qkv, o,
# stat_m, stat_l, x1, hh, a, mo, dx, m2g, dhh, da, dqkv, dout, dsum, dgb,
# dm1, dm2, counters, stamps, dx1 (the workspace past one pass a CTA).
_ADA_PTRS = {"pmce_ada_fwd_tile": 28, "pmce_ada_block_fwd": 27,
             "pmce_ada_bwd_tile": 31,
             "pmce_ada_wgrad": 12, "pmce_ada_block_bwd": 27}
_ORIENT = pytest.mark.parametrize("Nq,Nk,H", [(17, 431, 8), (431, 17, 2)],
                                  ids=["joints-query", "vertices-query"])


def _ca_call(xs, conds, params, H, masks):
    return fa.ca_block(*xs, tuple(conds[0::2]), tuple(conds[1::2]),
                       tuple(params), H, 1e-6, masks)


def _bf16_ada(B, N, H, C=64, hid=256, mask_grad=False):
    rng = np.random.default_rng([N, H])

    def r(*s, dtype=torch.float32):
        a = torch.from_numpy(rng.normal(size=s).astype(np.float32))
        return a.to(dtype).requires_grad_(True)

    bf = torch.bfloat16
    x = r(B, N, C, dtype=bf)
    gb = [r(B, C) for _ in range(4)]
    params = (r(C, 3 * C, dtype=bf), r(3 * C), r(C, C, dtype=bf), r(C),
              r(C, hid, dtype=bf), r(hid), r(hid, C, dtype=bf), r(C))
    masks = tuple(torch.ones(B, 1, 1).requires_grad_(mask_grad)
                  for _ in range(2))
    return x, gb, params, masks


# ------------------------------------------------------- row 10 on the card
@_ORIENT
@pytest.mark.parametrize("grad,mask_grad", [
    (False, False), (True, False), (True, True), (False, True)],
    ids=["no-grad", "grad", "grad-mask-grads", "no-grad-mask-grads"])
def test_ca_forward_is_one_tile_launch(Nq, Nk, H, grad, mask_grad):
    """The CA block's forward on the card is exactly one
    ``pmce_ca_fwd_tile`` launch in both orientations, counted once by
    ``ca_block_fwd`` (the sequence's counter stays 0): the six bf16 weights
    on the parameters' own pointers, the saved state only under grad, the
    branches a, mo only when a mask's gradient is owed under grad, not
    stamped."""
    B = 3
    xs, conds, params, masks = _bf16_ca(B, Nq, Nk, H, mask_grad=mask_grad)
    launches = _Launches(_CA_PTRS)
    _cuda.reset_launch_counts()
    with _enter(_stubs(launches, _cuda.CA)), torch.set_grad_enabled(grad):
        _ca_call(xs, conds, params, H, masks)
    assert launches.names == ["pmce_ca_fwd_tile"]
    (_, ptrs, ints), = launches.calls
    assert tuple(ints[:5]) == (B, Nq, Nk, 256, H)
    assert ptrs[13:19] == [params[i].data_ptr() for i in (0, 2, 4, 6, 8, 10)]
    assert ptrs[25] != 0                                      # out
    assert [bool(ptrs[i]) for i in _CA_SAVED] == [grad] * 13
    assert bool(ptrs[39]) == bool(ptrs[40]) == (grad and mask_grad)
    assert ptrs[41] == 0
    counts = _cuda.launch_counts()
    assert counts["ca_block_fwd"] == 1 and counts["ca_block_fwd_seq"] == 0


@pytest.mark.parametrize("Nq,Nk,H,hid", [(72, 80, 2, 256), (17, 600, 8, 512)],
                         ids=["short-side-over-64", "hid-over-256"])
def test_ca_forward_outside_the_gate_takes_the_launch_sequence(Nq, Nk, H,
                                                               hid):
    """Shapes the tile program is not built for (a short side over 64 rows,
    hid over 256; a long side of any length it takes) run the launch
    sequence without a gradient, counted by ``ca_block_fwd_seq`` alone; it
    writes the intermediates it chains through whatever the grad mode."""
    xs, conds, params, masks = _bf16_ca(2, Nq, Nk, H, hid=hid)
    assert not fa.ca_bwd_kernel_fits(Nq, Nk, 64, hid)
    launches = _Launches(_CA_PTRS)
    _cuda.reset_launch_counts()
    with _enter(_stubs(launches, _cuda.CA)), torch.no_grad():
        _ca_call(xs, conds, params, H, masks)
    assert launches.names == ["pmce_ca_block_fwd"]
    (_, ptrs, ints), = launches.calls
    assert tuple(ints[:6]) == (2, Nq, Nk, 64, hid, H)
    assert all(ptrs[25:38]) and ptrs[38] != 0                 # saved, out
    assert ptrs[39] == ptrs[40] == 0
    counts = _cuda.launch_counts()
    assert counts["ca_block_fwd_seq"] == 1 and counts["ca_block_fwd"] == 0


@_ORIENT
def test_ca_forward_stage_split_is_one_stamped_launch(Nq, Nk, H):
    """``ca_fwd_stage_split`` runs the saving tile program once with the
    stamps' pointer set ([B * 4, 6] int64), not counted, and books every
    stage of ``CA_FWD_STAGES``."""
    B = 3
    xs, conds, params, _ = _bf16_ca(B, Nq, Nk, H)
    launches = _Launches(_CA_PTRS)
    _cuda.reset_launch_counts()
    with _enter(_stubs(launches, _cuda.CA)):
        split = fa.ca_fwd_stage_split([x.detach() for x in xs],
                                      conds[0::2], conds[1::2], params, H)
    assert launches.names == ["pmce_ca_fwd_tile"]
    (_, ptrs, _), = launches.calls
    assert ptrs[41] != 0 and all(ptrs[i] for i in _CA_SAVED)
    assert set(split) == {*fa.CA_FWD_STAGES, "ctas"}
    assert split["ctas"] == B * fa.CA_BWD_CLUSTER
    assert _cuda.launch_counts()["ca_block_fwd"] == 0


# -------------------------------------------------------- row 9 on the card
@pytest.mark.parametrize("N,H", [(431, 2), (17, 8)], ids=["431", "17"])
@pytest.mark.parametrize("mask_grad", [False, True],
                         ids=["masks", "mask-grads"])
def test_ada_backward_is_the_tile_program_and_one_weight_launch(N, H,
                                                                mask_grad):
    """The AdaLN block's backward on the card: exactly the tile program,
    then the weight-gradient launch, after the forward's one call (its two
    tile programs, ``pmce_ada_fwd_tile``); all read the forward's bf16
    weights on the parameters' own pointers
    (``_bf16_mat_t`` is never called); the forward saves a, mo and the tile
    program gets them and the dm1, dm2 outputs only when a mask needs its
    gradient; the weight launch's counters are the ones the tile program
    zeroes; counted once by ``ada_block_bwd``; the masks get gradients of
    their shapes exactly when they require them."""
    B = 3
    x, gb, params, masks = _bf16_ada(B, N, H, mask_grad=mask_grad)
    launches = _Launches(_ADA_PTRS)
    _cuda.reset_launch_counts()
    with _enter(_stubs(launches, _cuda.ADA)), \
            mock.patch.object(fa, "_bf16_mat_t",
                              side_effect=AssertionError("a transpose")):
        y = fa.ada_block(x, *gb, params, H, 1e-6, masks)
        y.backward(torch.zeros_like(y))
    assert launches.names == ["pmce_ada_fwd_tile", "pmce_ada_bwd_tile",
                              "pmce_ada_wgrad"]
    (_, fwd, _), (_, tile, ints), (_, wg, wints) = launches.calls
    weights = [params[i].data_ptr() for i in (0, 2, 4, 6)]
    assert fwd[7:11] == weights
    assert tile[6:10] == weights
    assert tile[10:12] == [fwd[16], fwd[18]]                  # qkv, o
    assert bool(fwd[25]) == bool(fwd[26]) == mask_grad       # a, mo saved
    assert tile[16:18] == fwd[25:27]                          # read as saved
    assert bool(tile[26]) == bool(tile[27]) == mask_grad     # dm1, dm2
    assert tile[28] == wg[10] != 0                            # counters
    assert tile[29] == 0                                      # not stamped
    assert tile[30] == 0                          # one pass: no workspace
    assert wg[0] == fwd[17] and wg[4] == tile[22]             # h1, dqkv
    assert tuple(ints[:4]) == (B, N, 256, H)
    assert tuple(wints[:3]) == (B * N, 256, fa._ADA_WGRAD_SPLITS)
    counts = _cuda.launch_counts()
    assert counts["ada_block_bwd"] == 1 and counts["ada_block_bwd_seq"] == 0
    assert x.grad is not None and params[0].grad is not None
    for m in masks:
        assert (m.grad is not None) == mask_grad
        if mask_grad:
            assert m.grad.shape == m.shape and m.grad.dtype == m.dtype


@pytest.mark.parametrize("grad,mask_grad", [
    (False, False), (True, False), (True, True), (False, True)],
    ids=["no-grad", "grad", "grad-mask-grads", "no-grad-mask-grads"])
def test_ada_forward_saves_branches_only_when_owed(grad, mask_grad):
    """Row 8 is one call of its two tile programs (``pmce_ada_fwd_tile``,
    counted once by ``ada_block_fwd``; the sequence's counter stays 0): out
    and qkv always, the rest of the saved state only under grad, and the
    branches a, mo only when a mask's gradient is owed under grad mode:
    never under ``no_grad``."""
    x, gb, params, masks = _bf16_ada(2, 17, 8, mask_grad=mask_grad)
    launches = _Launches(_ADA_PTRS)
    _cuda.reset_launch_counts()
    with _enter(_stubs(launches, _cuda.ADA)), torch.set_grad_enabled(grad):
        fa.ada_block(x, *gb, params, 8, 1e-6, masks)
    assert launches.names == ["pmce_ada_fwd_tile"]
    (_, fwd, ints), = launches.calls
    assert tuple(ints[:4]) == (2, 17, 256, 8)
    assert bool(fwd[25]) == bool(fwd[26]) == (grad and mask_grad)
    assert fwd[15] and fwd[16]                                # out, qkv
    assert [bool(fwd[i]) for i in range(17, 25)] == [grad] * 8  # saved
    assert fwd[27] == 0                                       # not stamped
    counts = _cuda.launch_counts()
    assert counts["ada_block_fwd"] == 1 and counts["ada_block_fwd_seq"] == 0


@pytest.mark.parametrize("mask_grad", [False, True],
                         ids=["masks", "mask-grads"])
def test_ada_backward_outside_the_gate_takes_the_launch_sequence(mask_grad):
    """Outside the tile program's gate (here hid 320, over its 256) the
    backward runs the launch sequence (its transposed weight copies and
    workspace), counted by ``ada_block_bwd_seq`` alone; it gives the mask
    gradients too: a, mo and the dm1, dm2 outputs at the table's end only
    when owed."""
    B, N, H, hid = 2, 520, 2, 320
    assert not fa.ada_bwd_kernel_fits(N, 64, hid)
    x, gb, params, masks = _bf16_ada(B, N, H, hid=hid, mask_grad=mask_grad)
    launches = _Launches(_ADA_PTRS)
    _cuda.reset_launch_counts()
    with _enter(_stubs(launches, _cuda.ADA)), \
            mock.patch.object(fa, "_workspace",
                              lambda *a: torch.empty(0, dtype=torch.uint8)):
        y = fa.ada_block(x, *gb, params, H, 1e-6, masks)
        y.backward(torch.zeros_like(y))
    assert launches.names == ["pmce_ada_block_fwd", "pmce_ada_block_bwd"]
    (_, fwd, _), (_, seq, ints) = launches.calls
    assert tuple(ints[:5]) == (B, N, 64, hid, H)
    assert seq[23:25] == fwd[25:27]
    assert [bool(p) for p in seq[23:27]] == [mask_grad] * 4
    counts = _cuda.launch_counts()
    assert counts["ada_block_bwd_seq"] == 1 and counts["ada_block_bwd"] == 0
    assert all((m.grad is not None) == mask_grad for m in masks)


def test_ada_backward_stage_split_is_one_stamped_launch():
    """``ada_bwd_stage_split`` runs the tile program once with the stamps'
    pointer set ([B * 4, 9] int64) and no weight launch, not counted, and
    books every stage of ``ADA_BWD_STAGES``."""
    B, N, H = 3, 431, 2
    x, gb, params, masks = _bf16_ada(B, N, H)
    launches = _Launches(_ADA_PTRS)
    _cuda.reset_launch_counts()
    with _enter(_stubs(launches, _cuda.ADA)), torch.no_grad():
        _, saved = fa._ada_fwd_cuda(x, gb, masks, params, H, 1e-6)
        split = fa.ada_bwd_stage_split(torch.ones_like(x), x, params, saved,
                                       H)
    assert launches.names == ["pmce_ada_fwd_tile", "pmce_ada_bwd_tile"]
    assert launches.calls[1][1][29] != 0
    assert set(split) == {*fa.ADA_BWD_STAGES, "ctas"}
    assert split["ctas"] == B * fa.ADA_BWD_CLUSTER
    assert _cuda.launch_counts()["ada_block_bwd"] == 0


def test_ada_backward_gate():
    """The tile program's gate: C = 64, hid up to 256, any token count."""
    assert fa.ada_bwd_kernel_fits(431, 64, 256)
    assert fa.ada_bwd_kernel_fits(512, 64, 128)
    assert fa.ada_bwd_kernel_fits(513, 64, 256)
    assert not fa.ada_bwd_kernel_fits(431, 64, 320)
    assert not fa.ada_bwd_kernel_fits(431, 128, 256)
