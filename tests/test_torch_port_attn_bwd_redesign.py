"""The redesigned self-attention backward (row 5) and skinning (row 15), on
the CPU.

The device test answers "card" and the libraries' ``call`` is stubbed
(``_stubs``), so each wrapper's route shows in the entry points it calls
and the pointer tables it hands them:

- row 5 inside ``mhsa_fwd_kernel_fits`` is exactly ``pmce_mhsa_bwd_tile``
  (the forward's clips a CTA, its saved qkv, o and softmax statistics on
  their own pointers, the weights on the parameters' own pointers) then
  ``pmce_mhsa_wgrad`` (x, o, the tile program's dqkv, g); no transposed
  weight copy is made; other shapes take the launch sequence
  ``pmce_mhsa_bwd`` (counter ``mhsa_bwd_seq``);
- ``mhsa_bwd_stage_split`` is one stamped launch, not counted;
- the plain ``fused_mhsa`` and its autograd against JAX's interpreted
  ``fused_mhsa`` and custom VJP at the tile programs' widths (C = 64 with
  8 heads, C = 256 with 8 heads; ``test_torch_port_attention.py`` holds
  C = 32), f32 within 1e-4, bf16 within that file's ``BF16_BOUND``;
- skinning's launch plan (every vertex and body once, one wave of blocks
  at B = 256) and its wrapper's routes.
"""

from __future__ import annotations

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmce_tpu.ops.fused_attention import fused_mhsa
from pmce_tpu_torch.ops import _cuda
from pmce_tpu_torch.ops import fused_attention as fa
from pmce_tpu_torch.smpl import kernels as sk
from pmce_tpu_torch.smpl.layer import apply_skinning
from tests.test_torch_port_attention import BF16_BOUND, DT, F32_BOUND
from tests.test_torch_port_attn_fwd_redesign import (_MHSA_PTRS,
                                                     _NO_WORKSPACE, _mhsa)
from tests.test_torch_port_bwd_redesign import _enter, _stubs
from tests.test_torch_port_fwd_redesign import _Launches

_NO_TRANSPOSE = mock.patch.object(
    fa, "_bf16_mat_t",
    mock.Mock(side_effect=AssertionError("a transposed weight copy")))


def _backward(clips, N, C, H):
    """The forward and backward of ``fused_mhsa`` on the stubbed card;
    returns the launches, the inputs and the forward's saved state."""
    x, *w = _mhsa(clips, N, C, H, grad=True)
    launches = _Launches(_MHSA_PTRS)
    captured = {}
    real = fa._mhsa_fwd_cuda

    def spy(*args, **kw):
        out, saved = real(*args, **kw)
        captured["saved"] = saved
        return out, saved

    _cuda.reset_launch_counts()
    with _enter(_stubs(launches, _cuda.MHSA)), _NO_WORKSPACE, \
            mock.patch.object(fa, "_mhsa_fwd_cuda", spy):
        y = fa.fused_mhsa(x, *w, H)
        y.backward(torch.zeros_like(y))
    return launches, x, w, captured["saved"]


# ------------------------------------------------------- row 5 on the card
@pytest.mark.parametrize("clips,N,C,H,cpc", [
    (32, 17, 64, 8, 1), (512, 17, 256, 8, 4), (544, 16, 256, 8, 5),
    (3, 16, 64, 4, 1), (3, 16, 64, 2, 1)],
    ids=["decoder", "trunk-spatial", "trunk-temporal", "heads-16",
         "heads-32"])
def test_mhsa_backward_inside_the_gate_is_two_launches(clips, N, C, H, cpc):
    """Inside the gate the backward is exactly ``pmce_mhsa_bwd_tile`` then
    ``pmce_mhsa_wgrad``, counted once by ``mhsa_bwd`` (``mhsa_bwd_seq`` 0):
    the tile program owns the forward's clips a CTA and reads g, the
    weights on the parameters' own (bf16) pointers and the forward's saved
    qkv, o, max and sum on theirs; it writes dx and dqkv and zeroes the
    weight launch's counters, which then reads x, o, that dqkv and g. No
    transposed weight copy is made."""
    with _NO_TRANSPOSE:
        launches, x, w, saved = _backward(clips, N, C, H)
    assert launches.names == ["pmce_mhsa_fwd_tile", "pmce_mhsa_bwd_tile",
                              "pmce_mhsa_wgrad"]
    (_, fwd, fints), (_, tile, tints), (_, wg, wints) = launches.calls
    wt, tiles = fa.mhsa_wgrad_tiles(C)
    assert tuple(tints[:6]) == (clips, N, C, H, cpc, tiles)
    assert tints[4] == fints[4]                     # the forward's clips
    assert [tile[1], tile[2]] == [w[0].data_ptr(), w[2].data_ptr()]
    qkv, o, stats = saved
    assert tile[3:7] == fwd[6:10] == [qkv.data_ptr(), o.data_ptr(),
                                      stats[0].data_ptr(),
                                      stats[1].data_ptr()]
    assert all(tile[:10]) and tile[10] == 0        # not stamped
    assert wg[0] == x.data_ptr() and wg[1] == o.data_ptr()
    assert wg[2] == tile[8] and wg[3] == tile[0]    # dqkv, g
    assert wg[6] == tile[9]                         # the counters
    assert all(wg)
    assert tuple(wints[:3]) == (clips * N, C, fa._MHSA_WGRAD_SPLITS)
    counts = _cuda.launch_counts()
    assert counts["mhsa_bwd"] == 1 and counts["mhsa_bwd_seq"] == 0
    assert all(t.grad is not None and t.grad.shape == t.shape
               for t in (x, *w))


@pytest.mark.parametrize("clips,N,C,H", [(3, 72, 64, 4), (3, 17, 128, 8)],
                         ids=["N-72", "C-128"])
def test_mhsa_backward_outside_the_gate_takes_the_sequence(clips, N, C, H):
    """Over 64 tokens, or at a width the tile programs are not built for,
    forward and backward are the launch sequences (``pmce_mhsa_fwd``,
    ``pmce_mhsa_bwd``), counted by ``mhsa_fwd_seq`` and ``mhsa_bwd_seq``
    alone; the sequence reads the forward's saved state."""
    assert not fa.mhsa_fwd_kernel_fits(N, C, H)
    launches, *_, saved = _backward(clips, N, C, H)
    assert launches.names == ["pmce_mhsa_fwd", "pmce_mhsa_bwd"]
    (_, fwd, _), (_, bwd, ints) = launches.calls
    assert tuple(ints[:4]) == (clips, N, C, H)
    assert bwd[4:8] == fwd[5:9] == [t.data_ptr() for t in
                                    (saved[0], saved[1], saved[2][0],
                                     saved[2][1])]
    counts = _cuda.launch_counts()
    assert counts["mhsa_bwd_seq"] == 1 and counts["mhsa_bwd"] == 0
    assert counts["mhsa_fwd_seq"] == 1 and counts["mhsa_fwd"] == 0


@pytest.mark.parametrize("C,expect", [(64, (64, 4)), (256, (128, 16))])
def test_mhsa_weight_launch_tiles(C, expect):
    """dWqkv [C, 3C] and dWproj [C, C] in 64 x 64 tiles at C = 64 (3 + 1),
    128 x 128 at C = 256 (12 + 4)."""
    assert fa.mhsa_wgrad_tiles(C) == expect


@pytest.mark.parametrize("clips,N,C,cpc", [(32, 17, 64, None),
                                           (512, 17, 256, None),
                                           (512, 17, 256, 7)],
                         ids=["joint", "trunk", "trunk-7"])
def test_mhsa_backward_stage_split_is_one_stamped_launch(clips, N, C, cpc):
    """``mhsa_bwd_stage_split`` runs the stamped tile program once on a
    forward's saved state ([ctas, 5] int64 stamps), not counted, no weight
    launch, and books every stage of ``MHSA_BWD_STAGES``; a given clips a
    CTA reaches the launch."""
    H = 8
    x, wqkv, bqkv, wproj, bproj = _mhsa(clips, N, C, H)
    launches = _Launches(_MHSA_PTRS)
    with _enter(_stubs(launches, _cuda.MHSA)):
        _, saved = fa._mhsa_fwd_cuda(x, wqkv, bqkv, wproj, bproj, H)
        _cuda.reset_launch_counts()
        split = fa.mhsa_bwd_stage_split(torch.ones_like(x), x, wqkv, wproj,
                                        saved, H, clips_per_cta=cpc)
    assert launches.names == ["pmce_mhsa_fwd_tile", "pmce_mhsa_bwd_tile"]
    (_, ptrs, ints) = launches.calls[1]
    want = cpc or fa.mhsa_fwd_plan(clips, N, C, 132)
    assert ints[4] == want and ptrs[10] != 0
    assert split["clips_per_cta"] == want
    assert split["ctas"] == -(-clips // want)
    assert set(split) == {*fa.MHSA_BWD_STAGES, "ctas", "clips_per_cta"}
    assert _cuda.launch_counts()["mhsa_bwd"] == 0


# ------------------------------------ the plain version against JAX's VJP
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("C,N", [(64, 17), (64, 16), (256, 17), (256, 16)])
def test_mhsa_plain_matches_jax_at_the_tile_widths(C, N, dtype):
    """The plain ``fused_mhsa`` (the CPU route) and its autograd against
    JAX's interpreted ``fused_mhsa`` and custom VJP (the Pallas kernels of
    rows 4 and 5) at the widths of the tile programs, 8 heads (of 8 and of
    32), 3 clips: value and every gradient."""
    H, B = 8, 3
    rng = np.random.default_rng([C, N])

    def w(*shape, scale=0.2):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    arrays = [w(B, N, C, scale=1.0), w(C, 3 * C, scale=C ** -0.5),
              w(3 * C, scale=0.05), w(C, C, scale=C ** -0.5),
              w(C, scale=0.05)]
    g = w(B, N, C, scale=1.0)
    jdt, tdt = DT[dtype]
    ja = [jnp.asarray(a) for a in arrays]
    y, vjp = jax.vjp(lambda x, *p: fused_mhsa(x.astype(jdt), *p, H), *ja)
    grads = vjp(jnp.asarray(g).astype(jdt))
    want = {"y": np.asarray(y.astype(jnp.float32)),
            **{f"d{i}": np.asarray(d, np.float32)
               for i, d in enumerate(grads)}}
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fa.fused_mhsa(leaves[0].to(tdt), *leaves[1:], H)
    out.backward(torch.from_numpy(g).to(tdt))
    got = {"y": out.detach().float().numpy(),
           **{f"d{i}": t.grad.float().numpy() for i, t in enumerate(leaves)}}
    for k, a in want.items():
        lim = F32_BOUND if dtype == "f32" else (
            BF16_BOUND["y"] if k == "y" else BF16_BOUND["grad"])
        assert np.abs(got[k] - a).max() / np.abs(a).max() <= lim, k


# ------------------------------------------------------------ skinning
@pytest.mark.parametrize("V", [6890, 6889, 513])
@pytest.mark.parametrize("B", [1, 9, 256])
def test_skinning_plan_covers_every_vertex_and_body_once(B, V):
    """The launch: tiles of 512 vertices (the last ragged, V = 6890 = 4 ·
    1722 + 2 and 6889 not multiples of 4) by chunks of at most 16 bodies;
    every vertex and body in exactly one block; at most three blocks an SM
    (one wave on 132 SMs); the shared memory the block stages (the tile's
    weights and its bodies' transforms) within the card's opt-in."""
    J, sms = 24, 132
    plan = sk.skinning_plan(B, V, J, sms)
    tiles, chunks = plan.grid
    assert (tiles - 1) * 512 < V <= tiles * 512
    assert 1 <= plan.bodies <= 16
    assert (chunks - 1) * plan.bodies < B <= chunks * plan.bodies
    assert tiles * chunks <= 3 * sms or plan.bodies == 16
    assert plan.smem == (J * 512 + plan.bodies * J * 12) * 4 <= 232448


def test_skinning_plan_at_the_synthesis_shape():
    """B = 256 bodies of the 6890-vertex mesh on 132 SMs: 14 tiles by 26
    chunks of 10 bodies, 364 blocks, one wave of three an SM."""
    plan = sk.skinning_plan(256, 6890, 24, 132)
    assert plan == sk.SkinPlan((14, 26), 10, (24 * 512 + 10 * 24 * 12) * 4)


def test_skinning_plan_refuses_joints_over_the_kernel():
    with pytest.raises(ValueError):
        sk.skinning_plan(4, 100, 33, 132)


def _skin_args(B, V, J=24, dtype=torch.float32):
    rng = np.random.default_rng([B, V])
    v = torch.from_numpy(rng.normal(size=(B, V, 3)).astype(np.float32))
    A = torch.from_numpy(rng.normal(size=(B, J, 4, 4)).astype(np.float32))
    w = torch.softmax(torch.from_numpy(
        rng.normal(size=(V, J)).astype(np.float32)), -1)
    return v.to(dtype), A.to(dtype), w


def test_skinning_routes_on_the_cpu_and_other_devices():
    """A CPU tensor runs the plain skinning and launches nothing; another
    device raises."""
    args = _skin_args(3, 50)
    _cuda.reset_launch_counts()
    assert torch.equal(sk.fused_skinning(*args), apply_skinning(*args))
    assert _cuda.launch_counts()["skinning"] == 0
    with pytest.raises(ValueError):
        sk.fused_skinning(torch.empty(3, 50, 3, device="meta"), *args[1:])


@pytest.mark.parametrize("B,V", [(1, 6890), (9, 6889), (256, 6890)])
def test_skinning_on_the_card_is_one_planned_launch(B, V):
    """On the card (stood in for: the launch stubbed) one ``pmce_skinning``
    call on the tensors' own pointers with (B, V, J) and the plan's bodies
    a block, counted once; f64 inputs raise."""
    v, A, w = _skin_args(B, V)
    calls = []
    with mock.patch.object(_cuda, "check_cuda", lambda *a, **k: None), \
            mock.patch.object(_cuda, "stream_ptr", lambda dev: None), \
            mock.patch.object(sk, "_sm_count", lambda dev: 132), \
            mock.patch.object(_cuda.SKIN, "call",
                              lambda name, *a: calls.append((name, a))):
        _cuda.reset_launch_counts()
        sk._skinning_cuda(v, A, w)
        assert _cuda.launch_counts()["skinning"] == 1
        with pytest.raises(NotImplementedError):
            sk._skinning_cuda(*_skin_args(2, 40, dtype=torch.float64))
    (name, a), = calls
    assert name == "pmce_skinning"
    assert [p.value for p in a[:2]] == [v.data_ptr(), A.data_ptr()]
    assert a[2].value == w.data_ptr()
    assert tuple(a[4:8]) == (B, V, 24, sk.skinning_plan(B, V, 24,
                                                        132).bodies)
