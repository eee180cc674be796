"""The redesigned backwards of the GRU scan (row 13) and of the lifter
block (row 7), on the CPU.

- ``gru_bwd_plan``: how the one launch of the persistent backward scan
  spreads over a card, at the SM counts of the H100's SXM and PCIe parts:
  at most one CTA an SM, shared memory within the opt-in limit, every
  hidden unit owned exactly once, K = 3H split in whole 32-wide chunks; a
  plan that cannot be co-resident raises.
- Row 13's route on the card, with the device test answering "card" and
  the library call stubbed: the backward of each direction is one launch
  of the backward scan, reading the saving forward's bf16 [3H, H] rounding
  of Whh on its own pointer; no per-step calls.
- Row 7's route on the card, with the launches stubbed: the backward is
  the tile program and the weight-gradient launch, reading the bf16
  weights in their [in, out] layout on the parameters' own pointers (no
  transposed copies), with mask gradients only where they are owed.
"""

from __future__ import annotations

import contextlib
import ctypes
from unittest import mock

import numpy as np
import pytest
import torch

from pmce_tpu_torch.ops import _cuda
from pmce_tpu_torch.ops import fused_attention as fa

SMEM_OPTIN = 232_448


# ------------------------------------------------------- backward plan
@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("B", [5, 32, 256])
@pytest.mark.parametrize("H", [64, 1024])
def test_bwd_plan_fits_and_owns_every_unit_once(sms, B, H):
    plan = fa.gru_bwd_plan(B, H, sms, SMEM_OPTIN)
    assert plan.units in fa.GRU_SCAN_UNITS
    assert plan.grid == plan.groups <= sms            # one CTA an SM
    assert plan.smem == fa.gru_bwd_smem_bytes(B, H, plan.units, plan.wm,
                                              plan.wk) <= SMEM_OPTIN
    assert plan.wm * plan.wk <= fa.GRU_SCAN_WARPS
    assert (3 * H // 32) % plan.wk == 0               # whole K chunks
    assert plan.wm <= -(-B // 32)
    owned = np.zeros(H, np.int64)
    for cta in range(plan.grid):
        u0 = cta * plan.units
        owned[u0:min(u0 + plan.units, H)] += 1
    assert (owned == 1).all()


def test_bwd_plan_at_the_training_shape():
    """Stage 2's backward (B = 32, H = 1024): 128 CTAs of 8 units on 132
    SMs, the 8 warps splitting K (48 KB of Whh columns a CTA); on 114 SMs
    16 units; at H = 64 the K split stops at 2 (6 chunks of 32)."""
    assert fa.gru_bwd_plan(32, 1024, 132, SMEM_OPTIN)[:5] == (8, 128, 128,
                                                              1, 8)
    assert fa.gru_bwd_plan(32, 1024, 114, SMEM_OPTIN)[:3] == (16, 64, 64)
    assert fa.gru_bwd_plan(5, 64, 132, SMEM_OPTIN)[3:5] == (1, 2)
    assert fa.gru_bwd_plan(256, 1024, 132, SMEM_OPTIN)[3:5] == (8, 1)


@pytest.mark.parametrize("args", [
    (32, 1024, 40, SMEM_OPTIN),           # too few SMs for any CTA size
    (32, 4096, 132, SMEM_OPTIN),          # Whh columns over shared memory
    (32, 1024, 132, 32 * 1024),           # a smaller opt-in limit
], ids=["sms", "width", "smem"])
def test_bwd_plan_that_cannot_be_resident_raises(args):
    with pytest.raises(NotImplementedError, match="co-resident"):
        fa.gru_bwd_plan(*args)


# ------------------------------------------------- row 13 on the card
class _GruLaunches:
    """Stands in for the GRU library's ``call``: records every call by
    name; for the backward scan its pointer table and integers."""

    def __init__(self):
        self.names, self.bwd, self.save_w = [], [], []

    def __call__(self, name, *args):
        self.names.append(name)
        ptrs = ctypes.cast(args[0], ctypes.POINTER(ctypes.c_void_p))
        if name == "pmce_gru_scan":
            self.save_w.append(ptrs[10] or 0)
        elif name == "pmce_gru_bwd_scan":
            self.bwd.append({"ptrs": [ptrs[i] or 0 for i in range(10)],
                             "T": args[1], "reverse": args[2],
                             "dgi_bf16": args[3], "B": args[4],
                             "H": args[5], "units": args[6]})


def _stubs(lib_call, patch_lib):
    return (mock.patch.object(fa, "_on_card", return_value=True),
            mock.patch.object(_cuda, "check_cuda", lambda *a, **k: None),
            mock.patch.object(_cuda, "stream_ptr",
                              lambda dev: ctypes.c_void_p(0)),
            mock.patch.object(fa, "_card_limits",
                              lambda dev: (132, SMEM_OPTIN)),
            mock.patch.object(patch_lib, "call", lib_call))


def _enter(stubs):
    stack = contextlib.ExitStack()
    for s in stubs:
        stack.enter_context(s)
    return stack


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_gru_backward_is_one_launch_a_direction(reverse):
    """A training GRU direction's backward on the card: after the one saving
    launch, one launch of the backward scan over all T steps (T, the
    direction, bf16 dgi for bf16 projections) reading Whh on the pointer
    the saving scan wrote its bf16 rounding to, and the saved state on the
    saving scan's own pointers; nothing else is called (no per-step
    launches); counted once by ``gru_layer_bwd`` and once by
    ``gru_bwd_scan``."""
    torch.manual_seed(0)
    H, T, B = 64, 7, 3
    gi = torch.randn(T, B, 3 * H).to(torch.bfloat16).requires_grad_(True)
    whh = torch.randn(3 * H, H).t().requires_grad_(True)
    bhh = torch.randn(3 * H).requires_grad_(True)
    launches = _GruLaunches()
    _cuda.reset_launch_counts()
    with _enter(_stubs(launches, _cuda.GRU)):
        ys = fa._GRULayer.apply(gi, whh, bhh, reverse)
        ys.backward(torch.zeros_like(ys))
    assert launches.names == ["pmce_gru_scan", "pmce_gru_bwd_scan"]
    (bwd,) = launches.bwd
    assert (bwd["T"], bwd["reverse"], bwd["dgi_bf16"]) == (T, int(reverse),
                                                          1)
    assert (bwd["B"], bwd["H"]) == (B, H)
    assert bwd["units"] == fa.gru_bwd_plan(B, H, 132, SMEM_OPTIN).units
    assert bwd["ptrs"][6] == launches.save_w[0] != 0   # Whh, no copy
    assert all(bwd["ptrs"])
    counts = _cuda.launch_counts()
    assert counts["gru_layer_bwd"] == counts["gru_bwd_scan"] == 1
    assert counts["gru_layer_save"] == 1
    assert gi.grad.dtype == torch.bfloat16


def test_gru_layer_bwd_returns_f32_gradients_from_one_launch():
    """The public backward on the card: one launch, f32 dgi and dgh."""
    H, T, B = 64, 4, 2
    g = torch.zeros(T, B, H, dtype=torch.bfloat16)
    saved = torch.zeros(5, T, B, H)
    wb = torch.zeros(3 * H, H, dtype=torch.bfloat16).t()
    launches = _GruLaunches()
    with _enter(_stubs(launches, _cuda.GRU)):
        dgi, dgh = fa.gru_layer_bwd(g, saved, wb, True)
    assert launches.names == ["pmce_gru_bwd_scan"]
    assert launches.bwd[0]["dgi_bf16"] == 0
    assert launches.bwd[0]["ptrs"][1:6] == [saved[i].data_ptr()
                                            for i in range(5)]
    assert launches.bwd[0]["ptrs"][6] == wb.data_ptr()
    assert dgi.dtype == dgh.dtype == torch.float32
    assert dgi.shape == dgh.shape == (T, B, 3 * H)


# -------------------------------------------------- row 7 on the card
class _BlockLaunches:
    """Stands in for the block library's ``call``: records the names and,
    for the backward's tile program, its pointer table and integers."""

    def __init__(self):
        self.names, self.tile, self.wgrad = [], None, None

    def __call__(self, name, *args):
        self.names.append(name)
        if name == "pmce_block_bwd_tile":
            ptrs = ctypes.cast(args[0], ctypes.POINTER(ctypes.c_void_p))
            self.tile = {"ptrs": [ptrs[i] or 0 for i in range(27)],
                         "ints": args[1:4]}
        elif name == "pmce_block_wgrad":
            self.wgrad = args[1:5]


def _bf16_block(B, N, C=256, hid=512, post=True, masks=True):
    rng = np.random.default_rng(N)

    def r(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32))

    vec = [r(C), r(C), None, r(3 * C), None, r(C), r(C), r(C), None, r(hid),
           None, r(C)]
    mats = {2: (C, 3 * C), 4: (C, C), 8: (C, hid), 10: (hid, C)}
    params = [r(*mats[i]).to(torch.bfloat16) if i in mats else vec[i]
              for i in range(12)]
    params += [r(C), r(C)] if post else [None, None]
    params = [p if p is None else p.requires_grad_(True) for p in params]
    x = r(B, N, C).to(torch.bfloat16).requires_grad_(True)
    bm = None
    if masks:
        bm = tuple(torch.ones(B, 1, 1).requires_grad_(True) for _ in range(2))
    return x, params, bm


@pytest.mark.parametrize("N,post,masks", [(17, True, False), (16, True, True),
                                          (48, False, True), (64, True, False)])
def test_block_backward_is_the_tile_program_and_one_weight_launch(N, post,
                                                                  masks):
    """The block's backward on the card: exactly two launches, the tile
    program then the weight gradients, after the forward's one; the tile
    program reads the four bf16 weight matrices on the parameters' own
    pointers ([in, out], as the forward does: no transposed copies), the
    post-norm and the mask-gradient inputs only where they are in play,
    and its tile count is that of 128-row tiles of whole clips."""
    B = 9
    x, params, bm = _bf16_block(B, N, post=post, masks=masks)
    launches = _BlockLaunches()
    _cuda.reset_launch_counts()
    with _enter(_stubs(launches, _cuda.BLOCK)):
        y = fa.transformer_block(x, tuple(params), 8, branch_masks=bm)
        n_fwd = len(launches.names)
        y.backward(torch.zeros_like(y))
    assert launches.names[:n_fwd] == ["pmce_block_fwd_tile"]
    assert launches.names[n_fwd:] == ["pmce_block_bwd_tile",
                                      "pmce_block_wgrad"]
    ptrs = launches.tile["ptrs"]
    assert ptrs[8:12] == [params[i].data_ptr() for i in (2, 4, 8, 10)]
    assert bool(ptrs[2]) == bool(ptrs[14]) == post      # y, post-norm scale
    for i in (6, 7, 24, 25):                            # a, mo, dm1, dm2
        assert bool(ptrs[i]) == masks
    assert bool(ptrs[15]) == bool(ptrs[16]) == masks    # m1, m2
    assert ptrs[26] == 0                                # not stamped
    assert tuple(launches.tile["ints"]) == (B, N, 512)
    tiles = -(-B // (128 // N))
    assert launches.wgrad == (B * N, 512, 4, tiles)
    counts = _cuda.launch_counts()
    assert counts["block_fwd"] == counts["block_bwd"] == 1
    assert x.grad is not None and x.grad.shape == x.shape
    if masks:
        assert bm[0].grad.shape == bm[0].shape


def test_block_vector_layout_matches_the_kernel():
    """The host's offsets of the vector gradients are the tile program's
    (bb::V_* in csrc/block.cu): g1, b1, bqkv, bproj, g2, b2, bb1 (hid), bb2,
    gp, bp; 11·C + hid in all."""
    off, n = fa._block_vec_layout(256, 512)
    assert n == 11 * 256 + 512
    assert (off["g1"], off["b1"], off["bqkv"], off["bproj"], off["g2"],
            off["b2"], off["bb1"]) == (0, 256, 512, 1280, 1536, 1792, 2048)
    assert (off["bb2"], off["gp"], off["bp"]) == (2560, 2816, 3072)
