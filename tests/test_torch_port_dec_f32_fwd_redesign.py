"""Rows 8f / 10f redesigned (``csrc/ada_f32.cu``, ``csrc/ca_f32.cu`` over
``csrc/dec_tc32.cuh``: the forwards on the backwards' 3xTF32 routines),
their host side and numerics, on the CPU.

- the forwards' numerics before any CUDA: the 3xTF32 model of
  ``test_torch_port_dec_f32_redesign`` (both engines: operands split as
  hi = tf32_rna(v) and lo = tf32_rna(v - hi), or as the kernels split them)
  patched over every row product of the plain blocks (``fa.mm``) and the
  attention's two products (``fa._attention_heads``), at phase 13a's shapes
  cut to 4 clips (the AdaLN block [4, 431, 64] in 2 heads of 32; the CA
  block with joints [4, 17, 64] over vertices [4, 431, 64] in 8 heads of 8
  and vertices over joints in 2 heads of 32; hid 256; branch masks at rate
  0.2): the output within the card's 1e-5 of its largest magnitude
  (``chip_smoke.py``'s ``F32_KERNEL_REL_TOL``); the errors are printed;
- the forwards' plan (``f32_dec_fwd_plan``) at [32, 431] / [32, 17] on
  132 and 114 SMs and without a card: the rows program owns every (clip,
  key tile) once, the attention every (clip, query tile) or every range
  of a split long side once (the backward's splits), the tail every
  (clip, query tile) once; no more CTAs than the card holds at once; the
  ranges' merge order fixed; the waves stated; the workspace's floats;
- the wrappers pass the plan's CTA count and a workspace of the plan's
  size to ``pmce_ada_fwd_f32`` / ``pmce_ca_fwd_f32`` (the card stood in
  for);
- the port's f32 AdaLN and CA blocks (their plain versions, the CPU route)
  against JAX's ``ada_block_reference`` / ``ca_block_reference`` (pure XLA
  on the CPU) at C = 64, the f32 kernels' width, with branch masks: within
  1e-5 of the largest magnitude (f32 both sides; the sums' order and the
  erf's polynomial differ).

``tests/test_torch_port_f32_cpu_build.py`` (``slow``) runs the sources
themselves, built for the CPU, with the grid cut to a few CTAs and under
the split plan.
"""

from __future__ import annotations

import ctypes
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmce_tpu.ops.fused_attention import (ada_block_reference,
                                          ca_block_reference)
from pmce_tpu_torch.ops import _cuda
from pmce_tpu_torch.ops import fused_attention as fa
from test_torch_port_dec_f32_redesign import (ENGINES, SHAPES, _model_attention,
                                              _model_mm)

C, HID = 64, 256
OUT_TOL = 1e-5
JAX_TOL = 1e-5


def _arr(rng, *shape, scale=1.0, offset=0.0):
    return (rng.normal(size=shape) * scale + offset).astype(np.float32)


def _case(kind, Nq, Nk, clips, hid, seed):
    """numpy inputs of one block: (tokens, AdaLN vectors, params, masks)."""
    rng = np.random.default_rng(seed + Nq + 3 * Nk)
    masks = tuple(((rng.random((clips, 1, 1)) < 0.8) / 0.8).astype(
        np.float32) for _ in range(2))
    if kind == "ada":
        xs = [_arr(rng, clips, Nq, C)]
        conds = [_arr(rng, clips, C, scale=0.1, offset=1.0 - i % 2)
                 for i in range(4)]
        params = [_arr(rng, C, 3 * C, scale=C ** -0.5),
                  _arr(rng, 3 * C, scale=0.05)]
    else:
        xs = [_arr(rng, clips, n, C) for n in (Nq, Nk, Nk)]
        conds = [_arr(rng, clips, C, scale=0.1, offset=1.0 - i % 2)
                 for i in range(8)]
        params = [a for _ in range(3) for a in (
            _arr(rng, C, C, scale=C ** -0.5), _arr(rng, C, scale=0.05))]
    params += [_arr(rng, C, C, scale=C ** -0.5), _arr(rng, C, scale=0.05),
               _arr(rng, C, hid, scale=C ** -0.5),
               _arr(rng, hid, scale=0.05),
               _arr(rng, hid, C, scale=hid ** -0.5),
               _arr(rng, C, scale=0.05)]
    return xs, conds, params, masks


def _torch_block(kind, fn, xs, conds, params, masks, heads):
    t = [torch.from_numpy(a) for a in (*xs, *conds, *params, *masks)]
    nx, nc, npar = len(xs), len(conds), len(params)
    xs_t, conds_t = t[:nx], t[nx:nx + nc]
    params_t, masks_t = t[nx + nc:nx + nc + npar], tuple(t[nx + nc + npar:])
    with torch.no_grad():
        if kind == "ada":
            return fn(*xs_t, *conds_t, params_t, heads, 1e-6, masks_t)
        return fn(*xs_t, conds_t[0::2], conds_t[1::2], params_t, heads,
                  1e-6, masks_t)


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


# ---------------------------------------------------------------------------
# The 3xTF32 model of the forwards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_3xtf32_model_of_the_forwards_holds_the_cards_gate(shape, engine):
    kind, Nq, Nk, heads = SHAPES[shape]
    inputs = _case(kind, Nq, Nk, 4, HID, seed=13)
    plain = fa.ada_block_plain if kind == "ada" else fa.ca_block_plain
    want = _torch_block(kind, plain, *inputs, heads)
    with mock.patch.object(fa, "mm", _model_mm(ENGINES[engine])), \
            mock.patch.object(fa, "_attention_heads",
                              _model_attention(ENGINES[engine])):
        got = _torch_block(kind, plain, *inputs, heads)
    err = _rel(got, want)
    print(f"3xTF32 model ({engine}) of the forward, {shape}, masks: output "
          f"{err:.3g}")
    assert got.shape == want.shape and err <= OUT_TOL, err


# ---------------------------------------------------------------------------
# The forwards' plan
# ---------------------------------------------------------------------------

# (kind, clips, Nq, Nk, SMs) -> {program: waves}: phase 13a's shapes on an
# H100 SXM (132 SMs) and an H100 PCIe (114).
WAVES = {
    ("ada", 32, 431, 431, 132): {"rows": 1, "query attention": 1,
                                 "query tail": 1},
    ("ca", 32, 17, 431, 132): {"key rows": 1, "query attention": 1,
                               "query tail": 1},
    ("ca", 32, 431, 17, 132): {"key rows": 1, "query attention": 1,
                               "query tail": 1},
    ("ada", 32, 431, 431, 114): {"rows": 2, "query attention": 2,
                                 "query tail": 2},
    ("ca", 32, 17, 431, 114): {"key rows": 2, "query attention": 1,
                               "query tail": 1},
    ("ca", 32, 431, 17, 114): {"key rows": 1, "query attention": 2,
                               "query tail": 2},
}


def _owns_every_item_once(p, clips, sms):
    assert [i for cta in p.owned for i in cta] == list(p.items)
    assert p.ctas == len(p.owned) == min(len(p.items), sms) <= sms
    assert p.waves == max(len(cta) for cta in p.owned)
    per_clip = len(p.items) // clips
    assert list(p.items) == [(c, i) for c in range(clips)
                             for i in range(per_clip)]
    return per_clip


@pytest.mark.parametrize("case", list(WAVES),
                         ids=[f"{k}-{q}x{n}-{s}sm" for k, _, q, n, s in WAVES])
def test_fwd_plan_owns_every_tile_and_split_once(case):
    kind, clips, Nq, Nk, sms = case
    plan = fa.f32_dec_fwd_plan(kind, clips, Nq, Nk, sms)
    assert plan.ctas == sms
    assert [p.name for p in plan.programs] == list(WAVES[case])
    assert {p.name: p.waves for p in plan.programs} == WAVES[case]
    # The forward's attention splits as the backward's, so that both run
    # the same programs over the same ranges.
    bwd = fa.f32_dec_plan(kind, clips, Nq, Nk, sms)
    assert plan.splits_q == bwd.splits_q
    rows_p, attn, tail = plan.programs
    for p in plan.programs:
        per_clip = _owns_every_item_once(p, clips, sms)
        n = Nq if p.side == "queries" else Nk
        if p.ranges:
            continue
        rows = [r for r0, r1 in p.rows for r in range(r0, r1)]
        assert rows == list(range(n)) and per_clip == len(p.rows)
        assert all(r1 - r0 <= 128 for r0, r1 in p.rows)
    assert rows_p.side == ("queries" if kind == "ada" else "keys")
    assert tail.side == attn.side == "queries" and not tail.ranges
    if plan.splits_q > 1:
        # A split short side: its rows whole a split, the long side's
        # chunks in fixed contiguous ranges, merged in this order by the
        # tail, one CTA a clip.
        chunks = -(-Nk // 64)
        assert Nq <= 64 and attn.rows == ((0, Nq),)
        assert len(attn.ranges) == plan.splits_q == len(attn.items) // clips
        assert attn.ranges == bwd.programs[0].ranges
        assert attn.ranges[0][0] == 0 and attn.ranges[-1][1] == chunks
        assert all(a[1] == b[0] for a, b in zip(attn.ranges,
                                                attn.ranges[1:]))
        assert all(c0 < c1 for c0, c1 in attn.ranges)
        assert plan.splits_q == min(sms // clips, chunks)
        assert len(tail.items) == clips
    else:
        assert attn.items == tail.items and attn.rows == tail.rows


def test_fwd_plan_without_a_card_splits_every_chunk():
    """A CPU build of the sources runs a CTA an item: the short side split
    over every chunk of the long, every program one wave."""
    plan = fa.f32_dec_fwd_plan("ca", 2, 17, 130, None)
    assert plan.splits_q == 3
    attn = plan.programs[1]
    assert attn.name == "query attention" and attn.ranges == ((0, 1), (1, 2),
                                                              (2, 3))
    assert plan.ctas == max(len(p.items) for p in plan.programs) == 6
    assert all(p.waves == 1 for p in plan.programs)
    ada = fa.f32_dec_fwd_plan("ada", 3, 200, 200, None)
    assert ada.splits_q == 1 and ada.ctas == 6
    with pytest.raises(ValueError):
        fa.f32_dec_fwd_plan("ada", 2, 17, 40, None)


@pytest.mark.parametrize("kind,Nq,Nk,heads,S,want", [
    ("ada", 431, 431, 2, 1, 32 * 431 * 256),
    ("ca", 17, 431, 8, 4, 2 * 32 * 431 * 64 + 4 * 32 * 17 * (64 + 16)),
    ("ca", 431, 17, 2, 1, 2 * 32 * 17 * 64 + 32 * 431 * (64 + 4))])
def test_fwd_workspace_holds_each_programs_outputs(kind, Nq, Nk, heads, S,
                                                   want):
    """q, k, v and o (AdaLN); k and v, then o and the split attention's
    max and sum (CA), as the entry points carve them."""
    assert fa.f32_dec_fwd_workspace(kind, 32, Nq, Nk, heads, S) == want


# ---------------------------------------------------------------------------
# The wrappers' CTA count and workspace
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,Nq,Nk,heads", [("ada", 200, 200, 2),
                                              ("ca", 17, 200, 8),
                                              ("ca", 200, 17, 2)],
                         ids=["ada", "ca-joints", "ca-vertices"])
def test_wrappers_pass_the_fwd_plans_ctas(kind, Nq, Nk, heads):
    """Without a gradient, masks given: one forward call whose last two
    arguments are the plan's CTA count for the card's SMs (here 9) and the
    stream, its workspace (the table's last pointer) a fresh f32 buffer of
    the plan's floats."""
    clips = 3
    xs, conds, params, masks = _case(kind, Nq, Nk, clips, 128, seed=5)
    seen, sizes = [], []
    n_ptr = 17 if kind == "ada" else 27

    def call(name, table, *rest):
        arr = ctypes.cast(table, ctypes.POINTER(ctypes.c_void_p))
        seen.append((name, [arr[i] for i in range(n_ptr)], rest))

    real_ws = fa.f32_dec_fwd_workspace

    def workspace(*args):
        sizes.append((args, real_ws(*args)))
        return sizes[-1][1]

    lib = _cuda.ADA_F32 if kind == "ada" else _cuda.CA_F32
    stubs = [mock.patch.object(fa, "_on_card", return_value=True),
             mock.patch.object(_cuda, "check_cuda"),
             mock.patch.object(_cuda, "stream_ptr",
                               return_value=_cuda.P(None)),
             mock.patch.object(fa, "_dec_f32_resident", return_value=9),
             mock.patch.object(fa, "f32_dec_fwd_workspace", workspace),
             mock.patch.object(lib, "call", call)]
    for s in stubs:
        s.start()
    try:
        y = _torch_block(kind, fa.ada_block if kind == "ada"
                         else fa.ca_block, xs, conds, params, masks, heads)
    finally:
        for s in reversed(stubs):
            s.stop()
    plan = fa.f32_dec_fwd_plan(kind, clips, Nq, Nk, 9)
    assert plan.ctas == 9
    assert [name for name, _, _ in seen] == [f"pmce_{kind}_fwd_f32"]
    _, table, ints = seen[0]
    assert ints[-2] == plan.ctas and isinstance(ints[-1], ctypes.c_void_p)
    assert table[-2] == y.data_ptr() and table[-1] is not None
    assert sizes == [((kind, clips, Nq, Nk, heads, plan.splits_q),
                      real_ws(kind, clips, Nq, Nk, heads, plan.splits_q))]
    if kind == "ca" and Nq < Nk:
        assert plan.splits_q == 3  # min(9 // 3 clips, 4 chunks)


# ---------------------------------------------------------------------------
# The port's f32 blocks against JAX's references
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,Nq,Nk,heads", [("ada", 72, 72, 2),
                                              ("ca", 17, 72, 8),
                                              ("ca", 72, 17, 2)],
                         ids=["ada", "ca-joints", "ca-vertices"])
def test_f32_blocks_match_jax_references(kind, Nq, Nk, heads):
    """2 clips at C = 64, hid 128, branch masks: the port's ``ada_block`` /
    ``ca_block`` on CPU tensors (the route of the CPU tests) against
    ``ada_block_reference`` / ``ca_block_reference``."""
    xs, conds, params, masks = _case(kind, Nq, Nk, 2, 128, seed=9)
    port = _torch_block(kind, fa.ada_block if kind == "ada"
                        else fa.ca_block, xs, conds, params, masks,
                        heads).numpy()
    j = [jnp.asarray(a) for a in (*xs, *conds)]
    jp = tuple(jnp.asarray(a) for a in params)
    jm = tuple(jnp.asarray(m) for m in masks)
    if kind == "ada":
        ref = ada_block_reference(*j, jp, heads, 1e-6, branch_masks=jm)
    else:
        ref = ca_block_reference(*j[:3], tuple(j[3::2]), tuple(j[4::2]), jp,
                                 heads, 1e-6, branch_masks=jm)
    ref = np.asarray(ref)
    err = float(np.abs(port - ref).max() / np.abs(ref).max())
    print(f"port vs JAX reference, {kind} {Nq} over {Nk}, {heads} heads: "
          f"{err:.3g}")
    assert port.shape == ref.shape and err <= JAX_TOL, err
