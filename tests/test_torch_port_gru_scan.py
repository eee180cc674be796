"""The redesigned GRU scan (K2 and its saving variant) on the CPU.

- ``gru_plan``: how one launch of the persistent scan kernel spreads over
  a card (units per CTA, warps, shared memory), at the SM counts of the
  H100's SXM and PCIe parts: every CTA resident, shared memory within the
  opt-in limit, every hidden unit of every direction owned exactly once;
  a plan that cannot be co-resident raises.
- ``gru_bidir``'s plain version (both directions of a BiGRU layer, each
  with its own T) against JAX's ``fused_gru_layer`` /
  ``fused_gru_layer_rev`` (interpreted off-TPU, as
  tests/test_torch_port_kernels.py runs them) in bf16, and against
  ``gru_layer_scan_reference`` in f32.
- The wrappers' route on the card with the device test answering "card"
  and the library call stubbed: a serving BiGRU makes one launch per
  layer, hands the kernel each ``weight_hh`` parameter's own storage (no
  transposed or cast copy) and counts each direction once.
"""

from __future__ import annotations

import contextlib
import ctypes
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmce_tpu.ops import fused_attention as jfa
from pmce_tpu_torch.models.layers import BiGRU
from pmce_tpu_torch.ops import _cuda
from pmce_tpu_torch.ops import fused_attention as fa

from torch_port_common import rel_max_err

# The shared memory a block may opt in to on sm_90 (the H100 SXM has 132
# SMs, the PCIe part 114).
SMEM_OPTIN = 232_448


# ----------------------------------------------------------------- plan
@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("B", [5, 32, 256])
@pytest.mark.parametrize("H", [64, 1024])
@pytest.mark.parametrize("dirs", [1, 2])
def test_plan_fits_and_owns_every_unit_once(sms, B, H, dirs):
    plan = fa.gru_plan(B, H, dirs, sms, SMEM_OPTIN)
    assert plan.units in fa.GRU_SCAN_UNITS
    assert plan.grid == dirs * plan.groups <= sms     # one CTA an SM
    assert plan.smem == fa.gru_smem_bytes(B, H, plan.units, plan.wm,
                                          plan.wk) <= SMEM_OPTIN
    assert plan.wm * plan.wk <= fa.GRU_SCAN_WARPS
    # Each warp's K span is whole pairs of 32-wide chunks.
    assert (H // 64) % plan.wk == 0
    # The warps over rows cover every 32-row pair in whole rounds.
    assert plan.wm <= -(-B // 32)
    owned = np.zeros((dirs, H), np.int64)
    for cta in range(plan.grid):
        d, u0 = divmod(cta, plan.groups)
        u0 *= plan.units
        owned[d, u0:min(u0 + plan.units, H)] += 1
    assert (owned == 1).all()


def test_plan_spreads_one_direction_and_packs_two():
    """At the serving shapes two directions take 16 units a CTA (128 of
    132 SMs); one direction (training) takes 8 (128 CTAs), and the warps
    split K at batch 32; 114 SMs need 24 units a CTA for two."""
    assert fa.gru_plan(256, 1024, 2, 132, SMEM_OPTIN)[:5] == (16, 64, 128, 8,
                                                              1)
    assert fa.gru_plan(32, 1024, 1, 132, SMEM_OPTIN)[:5] == (8, 128, 128, 1,
                                                             8)
    assert fa.gru_plan(256, 1024, 2, 114, SMEM_OPTIN)[:3] == (24, 43, 86)


@pytest.mark.parametrize("args", [
    (256, 1024, 2, 40, SMEM_OPTIN),        # too few SMs for any CTA size
    (8192, 1024, 2, 132, SMEM_OPTIN),      # the carry over shared memory
    (256, 1024, 2, 132, 64 * 1024),        # a smaller opt-in limit
], ids=["sms", "batch", "smem"])
def test_plan_that_cannot_be_resident_raises(args):
    with pytest.raises(NotImplementedError, match="co-resident"):
        fa.gru_plan(*args)


# -------------------------------------------------------- gru_bidir vs JAX
def _bidir_case(seed, tf, tb, B=8, H=64):
    rng = np.random.default_rng(seed)

    def w(*s, scale=1.0):
        return (rng.normal(size=s) * scale).astype(np.float32)

    return (w(tf, B, 3 * H), w(tb, B, 3 * H), w(H, 3 * H, scale=0.2),
            w(3 * H, scale=0.2), w(H, 3 * H, scale=0.2), w(3 * H, scale=0.2))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("tf,tb", [(9, 9), (9, 8)], ids=["equal", "9-8"])
def test_bidir_plain_matches_pallas_kernels_bf16(tf, tb):
    gi_f, gi_b, wf, bf, wb, bb = _bidir_case(tf + tb, tf, tb)
    bf16 = jnp.bfloat16
    want_f = jfa.fused_gru_layer(jnp.asarray(gi_f, bf16), jnp.asarray(wf),
                                 jnp.asarray(bf))
    want_b = jfa.fused_gru_layer_rev(jnp.asarray(gi_b, bf16),
                                     jnp.asarray(wb), jnp.asarray(bb))
    got_f, got_b = fa.gru_bidir(_t(gi_f, torch.bfloat16),
                                _t(gi_b, torch.bfloat16), _t(wf), _t(bf),
                                _t(wb), _t(bb))
    assert got_f.shape == (tf, 8, 64) and got_b.shape == (tb, 8, 64)
    assert got_f.dtype == got_b.dtype == torch.bfloat16
    # The band of test_gru_plain_matches_pallas_kernel_bf16: one bf16 ulp
    # of |h| < 1.
    assert rel_max_err(want_f, got_f.float().numpy()) < 0.005
    assert rel_max_err(want_b, got_b.float().numpy()) < 0.005


@pytest.mark.parametrize("tf,tb", [(7, 7), (9, 8)], ids=["equal", "9-8"])
def test_bidir_plain_matches_jax_reference_f32(tf, tb):
    gi_f, gi_b, wf, bf, wb, bb = _bidir_case(100 + tf + tb, tf, tb)
    want_f = jfa.gru_layer_scan_reference(jnp.asarray(gi_f), jnp.asarray(wf),
                                          jnp.asarray(bf))
    want_b = jfa.gru_layer_scan_reference(jnp.asarray(gi_b)[::-1],
                                          jnp.asarray(wb),
                                          jnp.asarray(bb))[::-1]
    got_f, got_b = fa.gru_bidir(*(_t(a) for a in (gi_f, gi_b, wf, bf, wb,
                                                  bb)))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-4,
                               atol=1e-4)


# ------------------------------------------------- the route on the card
class _Launches:
    """Stands in for the GRU library's ``call``: records each scan launch's
    per-direction pointers and integers, reads nothing, writes nothing."""

    def __init__(self):
        self.scans = []

    def __call__(self, name, *args):
        if name != "pmce_gru_scan":
            return
        table, ints, dirs = args[0], args[1], args[2]
        ptrs = ctypes.cast(table, ctypes.POINTER(ctypes.c_void_p))
        self.scans.append({
            "dirs": dirs, "B": args[3], "H": args[4], "save": args[8],
            "ptrs": [[ptrs[11 * d + i] or 0 for i in range(11)]
                     for d in range(dirs)],
            "ints": [[ints[5 * d + i] for i in range(5)]
                     for d in range(dirs)]})


def _on_card_stubs(launches):
    """The device test answers "card"; the checks that need a CUDA tensor,
    the stream, the card's limits and the library call are stubbed."""
    return (mock.patch.object(fa, "_on_card", return_value=True),
            mock.patch.object(_cuda, "check_cuda", lambda *a, **k: None),
            mock.patch.object(_cuda, "stream_ptr",
                              lambda dev: ctypes.c_void_p(0)),
            mock.patch.object(fa, "_card_plan",
                              lambda B, H, d, dev: fa.gru_plan(
                                  B, H, d, 132, SMEM_OPTIN)),
            mock.patch.object(_cuda.GRU, "call", launches))


def _enter(stubs):
    stack = contextlib.ExitStack()
    for s in stubs:
        stack.enter_context(s)
    return stack


def test_serving_bigru_launches_once_per_layer_on_the_parameters():
    """A bf16 BiGRU forward without gradients, cut at the mid frame as the
    decoder runs it: two launches, each of both directions (layer 1 with
    its own T: 9 forward and 8 reverse steps), each reading its
    ``weight_hh`` parameter in place (the pointer of the parameter's own
    storage, strides H and 1: no transposed or cast copy), each direction
    counted once."""
    torch.manual_seed(0)
    H, T, mid = 64, 16, 8
    gru = BiGRU(32, H, num_layers=2)
    x = torch.randn(T, 4, 32)
    launches = _Launches()
    _cuda.reset_launch_counts()
    with _enter(_on_card_stubs(launches)), torch.no_grad():
        gru(x, mid_index=mid, dt=torch.bfloat16)
    counts = _cuda.launch_counts()
    assert counts["gru_scan"] == 2
    assert counts["gru_layer"] == counts["gru_layer_rev"] == 2
    assert counts["gru_layer_save"] == 0
    assert [s["dirs"] for s in launches.scans] == [2, 2]
    steps = [(T, T), (mid + 1, T - mid)]
    for layer, scan in enumerate(launches.scans):
        assert (scan["B"], scan["H"], scan["save"]) == (4, H, 0)
        for d, sfx in enumerate(("", "_reverse")):
            w = getattr(gru, f"weight_hh_l{layer}{sfx}")
            T_d, reverse, w_f32, srow, scol = scan["ints"][d]
            assert scan["ptrs"][d][1] == w.data_ptr()
            assert (srow, scol, w_f32) == (H, 1, 1)
            assert (T_d, reverse) == (steps[layer][d], d)
            assert scan["ptrs"][d][5:] == [0] * 6    # nothing saved


def test_training_scan_saves_and_reads_the_parameter_in_place():
    """The saving variant on the card: one launch of one direction with the
    parameter's own pointer, five saved states and the bf16 [3H, H]
    rounding of Whh for the backward; the backward takes that rounding
    without a copy and refuses an f32 weight."""
    H, T, B = 64, 5, 3
    w = torch.randn(3 * H, H)
    gi = torch.randn(T, B, 3 * H).to(torch.bfloat16)
    launches = _Launches()
    _cuda.reset_launch_counts()
    with _enter(_on_card_stubs(launches)):
        ys, saved, wb = fa._gru_save(gi, w.t(), torch.zeros(3 * H), True)
        (scan,) = launches.scans
        assert (scan["dirs"], scan["save"]) == (1, 1)
        assert scan["ptrs"][0][1] == w.data_ptr()
        assert scan["ptrs"][0][5:10] == [saved[i].data_ptr()
                                         for i in range(5)]
        assert scan["ptrs"][0][10] == wb.data_ptr()
        assert wb.dtype == torch.bfloat16 and wb.shape == (H, 3 * H)
        assert wb.t().is_contiguous()
        assert scan["ints"][0][:2] == [T, 1]
        g = torch.zeros(T, B, H, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="bf16"):
            fa.gru_layer_bwd(g, saved, w.t(), True)
    assert _cuda.launch_counts()["gru_layer_save"] == 1
    assert _cuda.launch_counts()["gru_scan"] == 0


def test_bigru_with_gradients_runs_each_direction_on_the_training_kernels():
    """Under autograd a BiGRU layer runs its directions one by one through
    ``_GRULayer`` (the saving variant, one launch a direction)."""
    torch.manual_seed(1)
    gru = BiGRU(32, 64, num_layers=1)
    launches = _Launches()
    _cuda.reset_launch_counts()
    with _enter(_on_card_stubs(launches)):
        gru(torch.randn(6, 4, 32), dt=torch.bfloat16)
    assert [(s["dirs"], s["save"]) for s in launches.scans] == [(1, 1)] * 2
    assert [s["ints"][0][1] for s in launches.scans] == [0, 1]
    counts = _cuda.launch_counts()
    assert counts["gru_layer_save"] == 2 and counts["gru_scan"] == 0
