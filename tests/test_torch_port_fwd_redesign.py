"""The redesigned lifter block forward (row 6) and cross-attention block
backward (row 11), and the branch masks' gradients, on the CPU.

- Row 6's route on the card, with the device test answering "card" and the
  block library's ``call`` stubbed: the forward is one launch of the tile
  program (``pmce_block_fwd_tile``) on the parameters' bf16 weights, its
  saving pointers set only when a gradient is owed and the branches a, mo
  only when the masks need theirs; its tiles are the backward's (128-row
  tiles of whole clips).
- Row 11's route on the card, with the CA library's ``call`` stubbed: the
  backward is the tile program then the weight-gradient launch, the six
  weights on the parameters' own pointers (no transposed copies), the mask
  gradients' pointers only where they are owed.
- Both decoder blocks' mask gradients (``ca_block_plain``'s and
  ``ada_block_plain``'s autograd) against JAX's interpreted
  ``fused_ca_block`` and ``fused_ada_block`` VJPs, f32 at 1e-4 of their
  largest magnitude.
"""

from __future__ import annotations

import ctypes
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmce_tpu.ops.fused_attention import fused_ada_block, fused_ca_block
from pmce_tpu_torch.ops import _cuda
from pmce_tpu_torch.ops import fused_attention as fa
from tests.test_torch_port_bwd_redesign import _bf16_block, _enter, _stubs


class _Launches:
    """Stands in for a library's ``call``: records every call's name, its
    pointer table (the first ``n`` pointers, 0 for null) and its other
    arguments."""

    def __init__(self, n_ptrs: dict):
        self.n_ptrs = n_ptrs
        self.calls = []

    def __call__(self, name, *args):
        n = self.n_ptrs.get(name, 0)
        ptrs = []
        if n:
            table = ctypes.cast(args[0], ctypes.POINTER(ctypes.c_void_p))
            ptrs = [table[i] or 0 for i in range(n)]
        self.calls.append((name, ptrs, args[1:]))

    @property
    def names(self):
        return [c[0] for c in self.calls]

    def of(self, name):
        return [c for c in self.calls if c[0] == name]


_BLOCK_PTRS = {"pmce_block_fwd_tile": 29, "pmce_block_bwd_tile": 27,
               "pmce_block_wgrad": 13}
# pmce_block_fwd_tile's table: x, out, wqkv, wproj, w1, w2, g1, b1, bqkv,
# bproj, g2, b2, bb1, bb2, gp, bp, m1, m2, h1, qkv, o, x1, h2, hh, ge, y, a,
# mo, stamps.
_SAVED = {"h1": 18, "qkv": 19, "o": 20, "h2": 22, "hh": 23, "ge": 24}


# ----------------------------------------------------- row 6 on the card
@pytest.mark.parametrize("grad,masks,mask_grad,post", [
    (False, False, False, True), (False, True, False, False),
    (True, False, False, True), (True, True, False, True),
    (True, True, True, False), (False, True, True, True)],
    ids=["no-grad", "no-grad-masks", "grad", "grad-masks",
         "grad-mask-grads", "no-grad-mask-grads"])
def test_block_forward_is_one_tile_launch(grad, masks, mask_grad, post):
    """The block's forward on the card is exactly one ``pmce_block_fwd_tile``
    launch, counted once by ``block_fwd``: the bf16 weights on the
    parameters' own pointers, the post-norm only with one; x1 whenever the
    saving program runs (a gradient or masks), the saved state only with a
    gradient, y only with a gradient and a post-norm, and the branches a,
    mo only when a mask needs its gradient under grad mode."""
    B, N = 9, 17
    x, params, bm = _bf16_block(B, N, post=post, masks=masks)
    if bm is not None and not mask_grad:
        bm = tuple(m.detach() for m in bm)
    launches = _Launches(_BLOCK_PTRS)
    _cuda.reset_launch_counts()
    with _enter(_stubs(launches, _cuda.BLOCK)), torch.set_grad_enabled(grad):
        fa.transformer_block(x, tuple(params), 8, branch_masks=bm)
    assert launches.names == ["pmce_block_fwd_tile"]
    (_, ptrs, ints), = launches.calls
    assert tuple(ints[:3]) == (B, N, 512)
    assert ptrs[2:6] == [params[i].data_ptr() for i in (2, 4, 8, 10)]
    assert bool(ptrs[14]) == bool(ptrs[15]) == post
    assert bool(ptrs[16]) == bool(ptrs[17]) == masks
    assert bool(ptrs[21]) == (grad or masks)                  # x1
    for name, i in _SAVED.items():
        assert bool(ptrs[i]) == grad, name
    assert bool(ptrs[25]) == (grad and post)                  # y
    assert bool(ptrs[26]) == bool(ptrs[27]) == (grad and mask_grad)  # a, mo
    assert ptrs[28] == 0                                      # not stamped
    assert _cuda.launch_counts()["block_fwd"] == 1


@pytest.mark.parametrize("N", [16, 17, 48, 64])
def test_block_forward_tiles_are_the_backward_tiles(N):
    """The forward's tile program runs on the backward's tiles: the stamped
    forward's tile count (128 // N whole clips a tile) is the tile count
    the backward hands its weight launch, and both entry points get the
    same clips and N."""
    B = 23
    x, params, _ = _bf16_block(B, N, post=True, masks=False)
    launches = _Launches(_BLOCK_PTRS)
    _cuda.reset_launch_counts()
    with _enter(_stubs(launches, _cuda.BLOCK)):
        split = fa.block_fwd_stage_split(x.detach(), tuple(params), 8)
        y = fa.transformer_block(x, tuple(params), 8)
        y.backward(torch.zeros_like(y))
    tiles = -(-B // (128 // N))
    assert split["tiles"] == tiles
    assert set(split) == {*fa.TRUNK_STAGES, "tiles"}
    (_, _, wgrad), = launches.of("pmce_block_wgrad")
    assert wgrad[3] == tiles
    fwd = launches.of("pmce_block_fwd_tile")
    assert fwd[0][1][28] != 0 and fwd[1][1][28] == 0   # stamped, then not
    (_, _, bwd), = launches.of("pmce_block_bwd_tile")
    assert tuple(fwd[1][2][:2]) == tuple(bwd[:2]) == (B, N)
    assert _cuda.launch_counts()["block_fwd"] == 1    # the stamped one not


# ---------------------------------------------------- row 11 on the card
_CA_PTRS = {"pmce_ca_fwd_tile": 42, "pmce_ca_block_fwd": 41,
            "pmce_ca_bwd_tile": 40, "pmce_ca_wgrad": 16}


def _bf16_ca(B, Nq, Nk, H, C=64, hid=256, mask_grad=False):
    rng = np.random.default_rng([Nq, Nk])

    def r(*s, dtype=torch.float32):
        a = torch.from_numpy(rng.normal(size=s).astype(np.float32))
        return a.to(dtype).requires_grad_(True)

    bf = torch.bfloat16
    xs = [r(B, Nq, C, dtype=bf), r(B, Nk, C, dtype=bf), r(B, Nk, C, dtype=bf)]
    conds = [r(B, C) for _ in range(8)]
    params = []
    for i, o in ((C, C),) * 4 + ((C, hid), (hid, C)):
        params += [r(i, o, dtype=bf), r(o)]
    masks = tuple(torch.ones(B, 1, 1).requires_grad_(mask_grad)
                  for _ in range(2))
    return xs, conds, params, masks


@pytest.mark.parametrize("Nq,Nk,H", [(17, 431, 8), (431, 17, 2)],
                         ids=["joints-query", "vertices-query"])
@pytest.mark.parametrize("mask_grad", [False, True],
                         ids=["masks", "mask-grads"])
def test_ca_backward_is_the_tile_program_and_one_weight_launch(Nq, Nk, H,
                                                               mask_grad):
    """The CA block's backward on the card: exactly the tile program, then
    the weight-gradient launch, after the forward's one tile launch; both
    read the six bf16 weights on the parameters' own pointers (no
    transposed copy is made: ``_bf16_mat_t`` is never called); the forward
    saves the branches
    a, mo and the tile program gets them and the dm1, dm2 outputs only when
    a mask needs its gradient; the weight launch's counters are the ones
    the tile program zeroes; counted once by ``ca_block_bwd``."""
    B = 3
    xs, conds, params, masks = _bf16_ca(B, Nq, Nk, H, mask_grad=mask_grad)
    launches = _Launches(_CA_PTRS)
    _cuda.reset_launch_counts()
    with _enter(_stubs(launches, _cuda.CA)), \
            mock.patch.object(fa, "_bf16_mat_t",
                              side_effect=AssertionError("a transpose")):
        y = fa.ca_block(*xs, tuple(conds[0::2]), tuple(conds[1::2]),
                        tuple(params), H, 1e-6, masks)
        y.backward(torch.zeros_like(y))
    assert launches.names == ["pmce_ca_fwd_tile", "pmce_ca_bwd_tile",
                              "pmce_ca_wgrad"]
    (_, fwd, _), (_, tile, ints), (_, wg, wints) = launches.calls
    weights = [params[i].data_ptr() for i in (0, 2, 4, 6, 8, 10)]
    assert tile[10:16] == weights
    assert fwd[13:19] == weights
    assert bool(fwd[39]) == bool(fwd[40]) == mask_grad       # a, mo saved
    assert tile[24:26] == fwd[39:41]                          # read as saved
    assert tile[16:20] == fwd[29:33]                          # q, k, v, o
    assert fwd[41] == 0                                       # not stamped
    assert bool(tile[36]) == bool(tile[37]) == mask_grad     # dm1, dm2
    assert tile[39] == 0                                      # not stamped
    assert tile[38] == wg[14] != 0                            # counters
    assert tuple(ints[:5]) == (B, Nq, Nk, 256, H)
    assert tuple(wints[:4]) == (B, Nq, Nk, 256)
    assert _cuda.launch_counts()["ca_block_bwd"] == 1
    assert xs[0].grad is not None and params[0].grad is not None
    assert (masks[0].grad is not None) == mask_grad


def test_ca_forward_keeps_no_branches_without_grad():
    """Under no_grad the CA block's forward saves no branches for the
    masks' gradients, even where the masks require grad: no backward will
    read them (the block's forward decides the same way)."""
    xs, conds, params, masks = _bf16_ca(3, 17, 431, 8, mask_grad=True)
    launches = _Launches(_CA_PTRS)
    with _enter(_stubs(launches, _cuda.CA)), torch.no_grad():
        fa.ca_block(*xs, tuple(conds[0::2]), tuple(conds[1::2]),
                    tuple(params), 8, 1e-6, masks)
    (_, fwd, _), = launches.calls
    assert fwd[39] == fwd[40] == 0


def test_ca_backward_refuses_what_its_tile_program_is_not_built_for():
    """Both sides over the short side's 64 rows: the backward's gate raises
    before the forward runs (the forward alone, without a gradient, still
    runs)."""
    xs, conds, params, masks = _bf16_ca(2, 72, 80, 2)
    launches = _Launches(_CA_PTRS)
    with _enter(_stubs(launches, _cuda.CA)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fa.ca_block(*xs, tuple(conds[0::2]), tuple(conds[1::2]),
                        tuple(params), 2, 1e-6, masks)
        with torch.no_grad():
            fa.ca_block(*xs, tuple(conds[0::2]), tuple(conds[1::2]),
                        tuple(params), 2, 1e-6, masks)
    assert launches.names == ["pmce_ca_block_fwd"]
    assert fa.ca_bwd_kernel_fits(17, 431, 64, 256)
    assert fa.ca_bwd_kernel_fits(431, 17, 64, 256)
    assert fa.ca_bwd_kernel_fits(17, 1723, 64, 256)
    assert fa.ca_bwd_kernel_fits(1723, 17, 64, 256)
    assert not fa.ca_bwd_kernel_fits(72, 1723, 64, 256)
    assert not fa.ca_bwd_kernel_fits(17, 431, 64, 320)


# ------------------------------------------ the mask gradients vs JAX
@pytest.mark.parametrize("Nq,Nk,H", [(5, 72, 4), (72, 5, 2)],
                         ids=["joints-query", "vertices-query"])
def test_ca_block_mask_gradients_match_jax(Nq, Nk, H):
    """dm1 = sum(dx1 * a) and dm2 = sum(g * mo) per clip: the plain
    version's autograd (what the tile program is held to on the card)
    against the gradients JAX's ``_ca_block_bwd_kernel`` returns for the
    branch masks (interpreted), f32, within 1e-4 of their largest
    magnitude."""
    B, C, hid = 3, 32, 64
    rng = np.random.default_rng([Nq, Nk, 7])

    def w(*shape, scale=0.2, offset=0.0):
        return (rng.normal(size=shape) * scale + offset).astype(np.float32)

    xs = [w(B, Nq, C, scale=1.0), w(B, Nk, C, scale=1.0),
          w(B, Nk, C, scale=1.0)]
    conds = [w(B, C, offset=1.0 - (i % 2)) for i in range(8)]
    params = []
    for _ in range(4):
        params += [w(C, C, scale=C ** -0.5), w(C, scale=0.05)]
    params += [w(C, hid, scale=C ** -0.5), w(hid, scale=0.05),
               w(hid, C, scale=hid ** -0.5), w(C, scale=0.05)]
    # Both mask values in play: clip 0 drops the attention branch.
    masks = [np.array([0.0, 1.25, 1.25], np.float32).reshape(B, 1, 1),
             np.array([1.25, 0.0, 1.25], np.float32).reshape(B, 1, 1)]
    g = w(B, Nq, C, scale=1.0)

    def jax_fn(m1, m2):
        j = [jnp.asarray(a) for a in (*xs, *conds, *params)]
        return fused_ca_block(j[0], j[1], j[2], tuple(j[3:11:2]),
                              tuple(j[4:11:2]), tuple(j[11:]), H, 1e-6,
                              (m1, m2))

    _, vjp = jax.vjp(jax_fn, *(jnp.asarray(m) for m in masks))
    want = [np.asarray(d) for d in vjp(jnp.asarray(g))]
    tm = [torch.from_numpy(m).requires_grad_(True) for m in masks]
    t = [torch.from_numpy(a) for a in (*xs, *conds, *params)]
    y = fa.ca_block_plain(t[0], t[1], t[2], tuple(t[3:11:2]),
                          tuple(t[4:11:2]), tuple(t[11:]), H, 1e-6, tuple(tm))
    y.backward(torch.from_numpy(g))
    for want_m, m in zip(want, tm):
        got = m.grad.numpy()
        assert got.shape == want_m.shape
        scale = np.abs(want_m).max()
        assert scale > 0
        assert np.abs(got - want_m).max() <= 1e-4 * scale


def test_ada_block_mask_gradients_match_jax():
    """dm1 = sum(dx1 * a) and dm2 = sum(g * mo) per clip for the AdaLN
    block: the plain version's autograd (what both backward routes are held
    to on the card) against the gradients JAX's ``_ada_block_bwd_kernel``
    returns for the branch masks (interpreted), f32, within 1e-4 of their
    largest magnitude."""
    B, N, C, H, hid = 3, 20, 32, 2, 64
    rng = np.random.default_rng(11)

    def w(*shape, scale=0.2, offset=0.0):
        return (rng.normal(size=shape) * scale + offset).astype(np.float32)

    x = w(B, N, C, scale=1.0)
    conds = [w(B, C, offset=1.0 - (i % 2)) for i in range(4)]
    params = [w(C, 3 * C, scale=C ** -0.5), w(3 * C, scale=0.05),
              w(C, C, scale=C ** -0.5), w(C, scale=0.05),
              w(C, hid, scale=C ** -0.5), w(hid, scale=0.05),
              w(hid, C, scale=hid ** -0.5), w(C, scale=0.05)]
    # Both mask values in play: clip 0 drops the attention branch.
    masks = [np.array([0.0, 1.25, 1.25], np.float32).reshape(B, 1, 1),
             np.array([1.25, 0.0, 1.25], np.float32).reshape(B, 1, 1)]
    g = w(B, N, C, scale=1.0)

    def jax_fn(m1, m2):
        j = [jnp.asarray(a) for a in (x, *conds, *params)]
        return fused_ada_block(j[0], *j[1:5], tuple(j[5:]), H, 1e-6,
                               (m1, m2))

    _, vjp = jax.vjp(jax_fn, *(jnp.asarray(m) for m in masks))
    want = [np.asarray(d) for d in vjp(jnp.asarray(g))]
    tm = [torch.from_numpy(m).requires_grad_(True) for m in masks]
    t = [torch.from_numpy(a) for a in (x, *conds, *params)]
    y = fa.ada_block_plain(t[0], *t[1:5], tuple(t[5:]), H, 1e-6, tuple(tm))
    y.backward(torch.from_numpy(g))
    for want_m, m in zip(want, tm):
        got = m.grad.numpy()
        assert got.shape == want_m.shape
        scale = np.abs(want_m).max()
        assert scale > 0
        assert np.abs(got - want_m).max() <= 1e-4 * scale
