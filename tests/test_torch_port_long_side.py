"""Stage-2 training past 512 vertex tokens (the 1723-vertex coarse mesh),
on the CPU: the widened gates of the CA tile programs (rows 10 / 11, bf16)
and of the f32 decoder blocks (rows 8f-11f), their plans and workspaces,
the counts the wrappers pass, and the numerics of the long side against
JAX.

- the gates: the CA tile programs take a long side of any length (a
  CTA's quarter of it in passes of 128 rows) and a short side of up to 64
  rows; the f32 blocks any token count, a CA block's short side up to 64;
  past them the wrappers raise ``NotImplementedError`` naming the limits
  and ROADMAP.md (the card stood in for, nothing launched);
- the bf16 CA wrappers at [32, 17] over [32, 1723] and back: one forward
  tile launch (never the launch sequence ``pmce_ca_block_fwd``), the tile
  backward with its workspace (queries split over more than one pass a
  CTA: each CTA's dk | dv sums between passes) and the weight launch;
- ``f32_dec_plan`` / ``f32_dec_fwd_plan`` at [32, 1723] and 17 joints over
  1723 vertices both ways, on 132 and 114 SMs and without a card: every
  tile and split once, the waves stated, the forward's workspace linear in
  the rows; the CTA counts and workspaces the f32 wrappers pass at 1723;
- the 3xTF32 CPU model of rows 8f-11f's products (the kernels' split, of
  ``test_torch_port_dec_f32_redesign``) over the plain blocks at a long
  side of 600 against JAX's ``ada_block_reference`` /
  ``ca_block_reference`` and their VJPs (outputs 1e-5, gradients 1e-4);
- ``ca_block_plain`` and its autograd against JAX's interpreted
  ``fused_ca_block`` and custom VJP at a long side of 600, f32 (1e-4) and
  bf16 (``test_torch_port_attention``'s pinned band);
- the mesh pieces at the two-level coarsening: the port's
  ``synthetic_coarsening(sizes=...)``, ``build_vj_relation`` and
  ``default_assets`` equal JAX's; ``convert.py`` carries a 1723-vertex
  PMCE's JAX parameters across unchanged;
- a narrow PMCE (embed 64, depth 1, GRU 32, batch 2) on the coarsening
  (6890, 600) in training mode, f32, fused route (JAX's interpreted
  ``fused_ada_block`` / ``fused_ca_block`` on its side): the loss (1e-5)
  and every gradient (1e-4 of its largest magnitude) through
  ``convert.py``'s weights.

The kernels themselves: ``tests/test_torch_port_f32_cpu_build.py``
(``slow``: the f32 sources built for the CPU at 600 tokens) and the
``gpu`` cases of ``tests/test_torch_port_gpu.py`` at [32, 1723].
"""

from __future__ import annotations

import ctypes
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmce_tpu.core import losses as jlosses
from pmce_tpu.models import coevo as jcoevo
from pmce_tpu.models import pmce as jpmce
from pmce_tpu.models import pose_lifter as jlifter
from pmce_tpu.ops.fused_attention import (ada_block_reference,
                                          ca_block_reference, fused_ca_block)
from pmce_tpu.smpl import mesh as jmesh
from pmce_tpu_torch import convert
from pmce_tpu_torch.core import losses
from pmce_tpu_torch.core.trainer import pmce_loss
from pmce_tpu_torch.models import pmce as tpmce
from pmce_tpu_torch.models.layers import DropPath
from pmce_tpu_torch.models.pmce import PMCE
from pmce_tpu_torch.ops import _cuda
from pmce_tpu_torch.ops import fused_attention as fa
from pmce_tpu_torch.smpl import mesh as tmesh
from pmce_tpu_torch.smpl.artifacts import synthetic_artifacts
from test_torch_port_attention import (BF16_BOUND, DT, F32_BOUND, _compare,
                                       _masks, _rng_w, _run)
from test_torch_port_bwd_redesign import _enter, _stubs
from test_torch_port_dec_f32_fwd_redesign import _owns_every_item_once
from test_torch_port_dec_f32_redesign import (ENGINES, _model_attention,
                                              _model_mm)
from test_torch_port_fwd_redesign import _CA_PTRS, _Launches, _bf16_ca
from torch_port_common import init_shapes, numpy_params

V_COARSE = 1723


# ---------------------------------------------------------------------------
# The gates and the limits they state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Nq,Nk,C,hid,fits", [
    (17, 431, 64, 256, True), (431, 17, 64, 256, True),
    (17, 1723, 64, 256, True), (1723, 17, 64, 256, True),
    (64, 8192, 64, 256, True), (8192, 64, 64, 128, True),
    (65, 1723, 64, 256, False), (1723, 80, 64, 256, False),
    (17, 1723, 64, 512, False), (17, 1723, 128, 256, False)], ids=str)
def test_ca_tile_gate_takes_any_long_side(Nq, Nk, C, hid, fits):
    assert fa.ca_bwd_kernel_fits(Nq, Nk, C, hid) is fits


@pytest.mark.parametrize("Nq,Nk,passes,floats", [
    (431, 17, 1, 0), (17, 431, 1, 0), (512, 17, 1, 0), (513, 17, 2, 1),
    (1723, 17, 4, 1), (17, 1723, 4, 0), (2048, 64, 4, 1), (64, 64, 1, 0)],
    ids=str)
def test_ca_tile_passes_and_backward_workspace(Nq, Nk, passes, floats):
    """A CTA walks its quarter of the long side (whole 16-row blocks) in
    passes of 128 rows; queries split over more than one pass need each
    CTA's dk | dv sums between passes: [32 clips x 4 CTAs, 64, 128] f32;
    keys split need none (dq sums in shared memory)."""
    assert fa.ca_bwd_passes(Nq, Nk) == passes
    assert fa.ca_bwd_workspace(32, Nq, Nk) == floats * 32 * 4 * 64 * 128


@pytest.mark.parametrize("N,C,heads,hid,fits", [
    (431, 64, 2, 256, True), (1723, 64, 2, 256, True),
    (4096, 64, 8, 256, True), (1723, 64, 4, 128, True),
    (1723, 64, 2, 512, False), (1723, 128, 4, 256, False),
    (1723, 64, 1, 256, False)], ids=str)
def test_ada_f32_gate_takes_any_token_count(N, C, heads, hid, fits):
    assert fa.ada_f32_kernel_fits(N, C, heads, hid) is fits


@pytest.mark.parametrize("Nq,Nk,fits", [
    (17, 1723, True), (1723, 17, True), (64, 4096, True), (4096, 64, True),
    (65, 1723, False), (1723, 72, False)], ids=str)
def test_ca_f32_gate_takes_any_long_side(Nq, Nk, fits):
    assert fa.ca_f32_kernel_fits(Nq, Nk, 64, 8, 256) is fits


def _on_card_stubs(launch):
    return [mock.patch.object(fa, "_on_card", return_value=True),
            mock.patch.object(_cuda, "check_cuda", lambda *a, **k: None),
            *(mock.patch.object(lib, "call", launch)
              for lib in (_cuda.CA, _cuda.ADA, _cuda.CA_F32,
                          _cuda.ADA_F32))]


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_ca_refusals_name_the_short_side_limit(dtype):
    """A short side over 64 rows (72 joints over 1723 vertices), a gradient
    owed: the wrapper raises naming the 64-row limit and ROADMAP.md before
    anything launches."""
    xs, conds, params, masks = _bf16_ca(2, 72, V_COARSE, 8)
    if dtype == "f32":
        xs = [t.detach().float().requires_grad_(True) for t in xs]
        params = [t.detach().float().requires_grad_(True) for t in params]
    launch = mock.Mock()
    want = ("short side of up to 64 rows" if dtype == "bf16"
            else "up to 64 rows on the short side")
    with _enter(_on_card_stubs(launch)), \
            pytest.raises(NotImplementedError, match=want) as err:
        fa.ca_block(*xs, tuple(conds[0::2]), tuple(conds[1::2]),
                    tuple(params), 8, 1e-6, masks)
    assert "ROADMAP.md" in str(err.value)
    assert launch.call_count == 0


def test_ada_f32_refusal_names_its_widths():
    rng = np.random.default_rng(3)

    def r(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32)
                                ).requires_grad_(True)

    x, gb = r(2, V_COARSE, 64), [r(2, 64) for _ in range(4)]
    params = [r(64, 192), r(192), r(64, 64), r(64), r(64, 512), r(512),
              r(512, 64), r(64)]
    launch = mock.Mock()
    with _enter(_on_card_stubs(launch)), pytest.raises(
            NotImplementedError, match="hid a multiple of 64 up to 256 "
            r"\(any number of tokens\)"):
        fa.ada_block(x, *gb, params, 2)
    assert launch.call_count == 0


# ---------------------------------------------------------------------------
# The bf16 CA wrappers at 1723
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Nq,Nk,H", [(17, V_COARSE, 8), (V_COARSE, 17, 2)],
                         ids=["joints-query", "vertices-query"])
def test_ca_wrappers_pass_the_long_side_to_the_tile_programs(Nq, Nk, H):
    """With a gradient owed at 1723 vertices: exactly the forward's tile
    program, the backward's tile program and the weight launch (never the
    forward's launch sequence), each given (clips, Nq, Nk, hid, H); the
    tile backward's 41st pointer is a workspace of ``ca_bwd_workspace``
    floats where the queries are split over more than one pass, else
    null; counted once each."""
    B = 2
    xs, conds, params, masks = _bf16_ca(B, Nq, Nk, H, mask_grad=True)
    launches = _Launches({**_CA_PTRS, "pmce_ca_bwd_tile": 41})
    sizes = []
    real = fa.ca_bwd_workspace

    def workspace(*args):
        sizes.append(real(*args))
        return sizes[-1]

    _cuda.reset_launch_counts()
    with _enter(_stubs(launches, _cuda.CA)), \
            mock.patch.object(fa, "ca_bwd_workspace", workspace):
        y = fa.ca_block(*xs, tuple(conds[0::2]), tuple(conds[1::2]),
                        tuple(params), H, 1e-6, masks)
        y.backward(torch.zeros_like(y))
    assert launches.names == ["pmce_ca_fwd_tile", "pmce_ca_bwd_tile",
                              "pmce_ca_wgrad"]
    (_, _, fints), (_, tile, ints), (_, _, wints) = launches.calls
    assert tuple(fints[:5]) == tuple(ints[:5]) == (B, Nq, Nk, 256, H)
    assert tuple(wints[:4]) == (B, Nq, Nk, 256)
    split_q = Nq >= Nk
    assert sizes == [B * 4 * 64 * 128 if split_q else 0]
    assert bool(tile[40]) == split_q
    counts = _cuda.launch_counts()
    assert (counts["ca_block_fwd"], counts["ca_block_bwd"],
            counts["ca_block_fwd_seq"]) == (1, 1, 0)
    assert masks[0].grad is not None and xs[1].grad is not None


@pytest.mark.parametrize("Nq,Nk,H", [(17, V_COARSE, 8), (V_COARSE, 17, 2)],
                         ids=["joints-query", "vertices-query"])
def test_ca_forward_without_grad_takes_the_tile_program_at_1723(Nq, Nk, H):
    """No gradient owed (serving's shapes, were the chain to take them):
    one tile launch saving nothing."""
    xs, conds, params, masks = _bf16_ca(2, Nq, Nk, H)
    launches = _Launches(_CA_PTRS)
    with _enter(_stubs(launches, _cuda.CA)), torch.no_grad():
        fa.ca_block(*xs, tuple(conds[0::2]), tuple(conds[1::2]),
                    tuple(params), H, 1e-6, masks)
    assert launches.names == ["pmce_ca_fwd_tile"]
    (_, ptrs, _), = launches.calls
    assert not any(ptrs[26:39]) and ptrs[25] != 0


# ---------------------------------------------------------------------------
# The f32 plans, workspaces and wrappers at 1723
# ---------------------------------------------------------------------------

# (kind, clips, Nq, Nk, SMs) -> {program: waves}, the backward's programs.
BWD_WAVES = {
    ("ada", 32, V_COARSE, V_COARSE, 132): {
        "queries": 4, "keys": 4, "finish queries": 4},
    ("ca", 32, 17, V_COARSE, 132): {
        "query attention": 1, "query tail": 1, "keys": 4,
        "finish queries": 1, "finish keys": 4},
    ("ca", 32, V_COARSE, 17, 132): {
        "queries": 4, "keys": 1, "finish queries": 4, "finish keys": 1},
    ("ada", 32, V_COARSE, V_COARSE, 114): {
        "queries": 4, "keys": 4, "finish queries": 4},
    ("ca", 32, 17, V_COARSE, 114): {
        "query attention": 1, "query tail": 1, "keys": 4,
        "finish queries": 1, "finish keys": 4},
    ("ca", 32, V_COARSE, 17, 114): {
        "queries": 4, "keys": 1, "finish queries": 4, "finish keys": 1},
}
FWD_WAVES = {
    ("ada", 32, V_COARSE, V_COARSE, 132): {
        "rows": 4, "query attention": 4, "query tail": 4},
    ("ca", 32, 17, V_COARSE, 132): {
        "key rows": 4, "query attention": 1, "query tail": 1},
    ("ca", 32, V_COARSE, 17, 132): {
        "key rows": 1, "query attention": 4, "query tail": 4},
    ("ada", 32, V_COARSE, V_COARSE, 114): {
        "rows": 4, "query attention": 4, "query tail": 4},
    ("ca", 32, 17, V_COARSE, 114): {
        "key rows": 4, "query attention": 1, "query tail": 1},
    ("ca", 32, V_COARSE, 17, 114): {
        "key rows": 1, "query attention": 4, "query tail": 4},
}


def _ids(cases):
    return [f"{k}-{q}x{n}-{s}sm" for k, _, q, n, s in cases]


def _check_program(p, kind, clips, Nq, Nk, sms):
    per_clip = _owns_every_item_once(p, clips, sms)
    n = Nq if p.side == "queries" else Nk
    if p.ranges:
        # A split short side over the long side's 27 chunks of 64 rows:
        # contiguous ranges, merged in this order.
        chunks = -(-max(Nq, Nk) // 64)
        assert p.rows == ((0, n),) and n <= 64 and per_clip == len(p.ranges)
        assert p.ranges[0][0] == 0 and p.ranges[-1][1] == chunks == 27
        assert all(a[1] == b[0] for a, b in zip(p.ranges, p.ranges[1:]))
        assert all(c0 < c1 for c0, c1 in p.ranges)
    else:
        rows = [r for r0, r1 in p.rows for r in range(r0, r1)]
        assert rows == list(range(n)) and per_clip == len(p.rows)


@pytest.mark.parametrize("case", list(BWD_WAVES), ids=_ids(BWD_WAVES))
def test_bwd_plan_at_1723_owns_every_tile_and_split_once(case):
    kind, clips, Nq, Nk, sms = case
    plan = fa.f32_dec_plan(kind, clips, Nq, Nk, sms)
    assert plan.ctas == sms
    assert {p.name: p.waves for p in plan.programs} == BWD_WAVES[case]
    for p in plan.programs:
        _check_program(p, kind, clips, Nq, Nk, sms)
    split = min(sms // clips, 27) if kind == "ca" else 1
    assert (plan.splits_q, plan.splits_k) == (
        (split, 1) if Nq < Nk else (1, split) if Nk < Nq else (1, 1))


@pytest.mark.parametrize("case", list(FWD_WAVES), ids=_ids(FWD_WAVES))
def test_fwd_plan_at_1723_owns_every_tile_and_split_once(case):
    kind, clips, Nq, Nk, sms = case
    plan = fa.f32_dec_fwd_plan(kind, clips, Nq, Nk, sms)
    assert plan.ctas == sms
    assert {p.name: p.waves for p in plan.programs} == FWD_WAVES[case]
    for p in plan.programs:
        _check_program(p, kind, clips, Nq, Nk, sms)
    assert plan.splits_q == fa.f32_dec_plan(kind, clips, Nq, Nk,
                                            sms).splits_q


@pytest.mark.parametrize("kind,Nq,Nk", [("ada", V_COARSE, V_COARSE),
                                        ("ca", 17, V_COARSE),
                                        ("ca", V_COARSE, 17)], ids=str)
def test_plans_without_a_card_at_1723(kind, Nq, Nk):
    """A CPU build of the sources: a CTA an item, every program one wave;
    the short side split over each of the long side's 27 chunks."""
    for plan in (fa.f32_dec_plan(kind, 2, Nq, Nk, None),
                 fa.f32_dec_fwd_plan(kind, 2, Nq, Nk, None)):
        assert all(p.waves == 1 for p in plan.programs)
        assert plan.ctas == max(len(p.items) for p in plan.programs)
        for p in plan.programs:
            _check_program(p, kind, 2, Nq, Nk, plan.ctas)
        assert plan.splits_q == (27 if Nq < Nk else 1)


@pytest.mark.parametrize("kind,Nq,Nk,heads,S", [
    ("ada", V_COARSE, V_COARSE, 2, 1), ("ca", 17, V_COARSE, 8, 4),
    ("ca", V_COARSE, 17, 2, 1)], ids=str)
def test_fwd_workspace_is_linear_in_the_rows(kind, Nq, Nk, heads, S):
    """The forward's workspace at [32, 1723]: each program's outputs, no
    term over the token count squared (1723 x 17 clips' worth, not 1723^2)."""
    got = fa.f32_dec_fwd_workspace(kind, 32, Nq, Nk, heads, S)
    if kind == "ada":
        assert got == 32 * V_COARSE * 4 * 64
    else:
        assert got == 2 * 32 * Nk * 64 + S * 32 * Nq * (64 + 2 * heads)
    assert fa.f32_dec_fwd_workspace(kind, 64, Nq, Nk, heads, S) == 2 * got


@pytest.mark.parametrize("kind,Nq,Nk,heads", [("ada", V_COARSE, V_COARSE, 2),
                                              ("ca", 17, V_COARSE, 8),
                                              ("ca", V_COARSE, 17, 2)],
                         ids=["ada", "ca-joints", "ca-vertices"])
def test_f32_wrappers_pass_the_plans_at_1723(kind, Nq, Nk, heads):
    """With a gradient owed at 1723 tokens on a card of 132 SMs: the
    forward call gets the forward plan's CTAs and a workspace of its
    floats; the backward call the backward plan's CTAs, after the
    workspace query (the CA block's: with the CTAs)."""
    clips = 2
    rng = np.random.default_rng(Nq + Nk)

    def r(*s, scale=1.0):
        return torch.from_numpy((rng.normal(size=s) * scale).astype(
            np.float32)).requires_grad_(True)

    if kind == "ada":
        xs = [r(clips, Nq, 64)]
        conds = [r(clips, 64) for _ in range(4)]
        params = [r(64, 192), r(192), r(64, 64), r(64)]
    else:
        xs = [r(clips, Nq, 64), r(clips, Nk, 64), r(clips, Nk, 64)]
        conds = [r(clips, 64) for _ in range(8)]
        params = [t for _ in range(4) for t in (r(64, 64), r(64))]
    params += [r(64, 256), r(256), r(256, 64), r(64)]
    seen, sizes = [], []

    def call(name, table, *rest):
        seen.append((name, rest))

    def query(name, *rest):
        seen.append((name, rest))
        return 4096

    real_ws = fa.f32_dec_fwd_workspace

    def workspace(*args):
        sizes.append(real_ws(*args))
        return sizes[-1]

    lib = _cuda.ADA_F32 if kind == "ada" else _cuda.CA_F32
    stubs = [mock.patch.object(fa, "_on_card", return_value=True),
             mock.patch.object(_cuda, "check_cuda"),
             mock.patch.object(_cuda, "stream_ptr",
                               return_value=_cuda.P(None)),
             mock.patch.object(fa, "_dec_f32_resident", return_value=132),
             mock.patch.object(fa, "f32_dec_fwd_workspace", workspace),
             mock.patch.object(lib, "call", call),
             mock.patch.object(lib, "query", query)]
    with _enter(stubs):
        if kind == "ada":
            y = fa.ada_block(*xs, *conds, params, heads)
        else:
            y = fa.ca_block(*xs, conds[0::2], conds[1::2], params, heads)
        y.backward(torch.zeros_like(y))
    fwd_plan = fa.f32_dec_fwd_plan(kind, clips, Nq, Nk, 132)
    bwd_plan = fa.f32_dec_plan(kind, clips, Nq, Nk, 132)
    names = [name for name, _ in seen]
    assert names == [f"pmce_{kind}_fwd_f32", f"pmce_{kind}_f32_workspace",
                     f"pmce_{kind}_bwd_f32"]
    got = dict(seen)
    assert got[f"pmce_{kind}_fwd_f32"][-2] == fwd_plan.ctas == 132
    assert got[f"pmce_{kind}_bwd_f32"][-2] == bwd_plan.ctas == 132
    assert sizes == [real_ws(kind, clips, Nq, Nk, heads, fwd_plan.splits_q)]
    ws = got[f"pmce_{kind}_f32_workspace"]
    if kind == "ca":
        assert ws[:3] == (clips, Nq, Nk) and ws[-1] == 132
        assert fwd_plan.splits_q == (27 if Nq < Nk else 1)  # 132 // 2 > 27
    else:
        assert ws[:2] == (clips, Nq)


# ---------------------------------------------------------------------------
# The 3xTF32 model of rows 8f-11f at 600 tokens against JAX's references
# ---------------------------------------------------------------------------

LONG = {"ada 600, 2 heads": ("ada", 600, 600, 2),
        "ca 17 over 600, 8 heads": ("ca", 17, 600, 8),
        "ca 600 over 17, 2 heads": ("ca", 600, 17, 2)}


def _f32_case(kind, Nq, Nk, clips, seed):
    """numpy arrays of one block at C = 64, hid 256: the leaves (tokens,
    AdaLN vectors, parameters, masks) and the output's cotangent."""
    rng = np.random.default_rng(seed + Nq + 3 * Nk)

    def a(*shape, scale=1.0, offset=0.0):
        return (rng.normal(size=shape) * scale + offset).astype(np.float32)

    if kind == "ada":
        xs = [a(clips, Nq, 64)]
        conds = [a(clips, 64, scale=0.1, offset=1.0 - i % 2)
                 for i in range(4)]
        params = [a(64, 192, scale=0.125), a(192, scale=0.05)]
    else:
        xs = [a(clips, n, 64) for n in (Nq, Nk, Nk)]
        conds = [a(clips, 64, scale=0.1, offset=1.0 - i % 2)
                 for i in range(8)]
        params = [t for _ in range(3) for t in (a(64, 64, scale=0.125),
                                                a(64, scale=0.05))]
    params += [a(64, 64, scale=0.125), a(64, scale=0.05),
               a(64, 256, scale=0.125), a(256, scale=0.05),
               a(256, 64, scale=0.0625), a(64, scale=0.05)]
    # Clip 0 drops the MLP branch, clip 1 the attention branch: each
    # mask's two values occur, and every parameter gets a gradient.
    masks = [np.array([1.25, 0.0], np.float32).reshape(2, 1, 1),
             np.array([0.0, 1.25], np.float32).reshape(2, 1, 1)]
    return [*xs, *conds, *params, *masks], a(clips, Nq, 64)


def _jax_block(kind, heads):
    def fn(*leaves):
        masks = leaves[-2:]
        if kind == "ada":
            x, g1, b1, g2, b2, *p = leaves[:-2]
            return ada_block_reference(x, g1, b1, g2, b2, tuple(p), heads,
                                       1e-6, branch_masks=masks)
        xq, xk, xv, *rest = leaves[:-2]
        return ca_block_reference(xq, xk, xv, tuple(rest[0:8:2]),
                                  tuple(rest[1:8:2]), tuple(rest[8:]), heads,
                                  1e-6, branch_masks=masks)
    return fn


def _port_block(kind, heads):
    def fn(*leaves):
        masks = tuple(leaves[-2:])
        if kind == "ada":
            x, g1, b1, g2, b2, *p = leaves[:-2]
            return fa.ada_block_plain(x, g1, b1, g2, b2, p, heads, 1e-6,
                                      masks)
        xq, xk, xv, *rest = leaves[:-2]
        return fa.ca_block_plain(xq, xk, xv, rest[0:8:2], rest[1:8:2],
                                 rest[8:], heads, 1e-6, masks)
    return fn


@pytest.mark.parametrize("shape", list(LONG))
def test_3xtf32_model_at_600_tokens_matches_jax(shape, engine="kernel-split"):
    """The plain blocks with every row product and the attention's on the
    3xTF32 model (rows 8f-11f's numerics, the operands split as the
    kernels split them) against JAX's references and
    ``jax.vjp`` at a long side of 600 (10 chunks of 64 keys or queries, 5
    tiles of 128 rows): output within 1e-5, each gradient (the masks'
    included) within 1e-4 of its largest magnitude (the CA block's key bias
    and key AdaLN beta, zero analytically, of the largest gradient)."""
    kind, Nq, Nk, heads = LONG[shape]
    leaves, g = _f32_case(kind, Nq, Nk, 2, seed=17)
    y, vjp = jax.vjp(_jax_block(kind, heads), *map(jnp.asarray, leaves))
    want = [np.asarray(y), *map(np.asarray, vjp(jnp.asarray(g)))]
    ts = [torch.from_numpy(a).requires_grad_(True) for a in leaves]
    with mock.patch.object(fa, "mm", _model_mm(ENGINES[engine])), \
            mock.patch.object(fa, "_attention_heads",
                              _model_attention(ENGINES[engine])):
        out = _port_block(kind, heads)(*ts)
        grads = torch.autograd.grad(out, ts, torch.from_numpy(g))
    got = [out.detach().numpy(), *(t.numpy() for t in grads)]
    zero = (6, 14) if kind == "ca" else ()
    largest = max(np.abs(w).max() for w in want[1:])
    errs = []
    for i, (a, b) in enumerate(zip(got, want)):
        scale = largest if i - 1 in zero else np.abs(b).max()
        assert scale > 0, i
        errs.append(float(np.abs(a - b).max() / scale))
    print(f"3xTF32 model ({engine}) vs JAX, {shape}: output {errs[0]:.3g}, "
          f"worst gradient {max(errs[1:]):.3g}")
    assert len(got) == len(want) == len(leaves) + 1
    assert errs[0] <= 1e-5, errs[0]
    assert max(errs[1:]) <= 1e-4, errs


# ---------------------------------------------------------------------------
# ca_block_plain against JAX's interpreted kernel at a long side of 600
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(5, 600, 4), (600, 5, 2)],
                         ids=["joints-query", "vertices-query"])
def test_ca_block_matches_jax_kernel_at_600(shape, dtype):
    """As ``test_torch_port_attention.test_ca_block_matches_jax`` (width 32,
    hid 64, 3 clips, per-clip masks), with the long side at 600 rows:
    JAX's Pallas kernel (interpreted) and its VJP."""
    Nq, Nk, H = shape
    C, HID = 32, 64
    rng = np.random.default_rng(Nq + 7 * Nk)
    w = _rng_w(rng)
    B = 3
    xs = [w(B, Nq, C, scale=1.0), w(B, Nk, C, scale=1.0),
          w(B, Nk, C, scale=1.0)]
    conds = [w(B, C, scale=0.2, offset=1.0 - (i % 2)) for i in range(8)]
    params = []
    for _ in range(4):
        params += [w(C, C, scale=C ** -0.5), w(C, scale=0.05)]
    params += [w(C, HID, scale=C ** -0.5), w(HID, scale=0.05),
               w(HID, C, scale=HID ** -0.5), w(C, scale=0.05)]
    bm = _masks(rng)
    g = w(B, Nq, C, scale=1.0)
    jdt, tdt = DT[dtype]
    jm = tuple(jnp.asarray(m) for m in bm)
    tm = tuple(torch.from_numpy(m) for m in bm)

    def split(a):
        return tuple(a[0::2]), tuple(a[1::2])

    want, got = _run(
        lambda xq, xk, xv, *r: fused_ca_block(
            xq.astype(jdt), xk.astype(jdt), xv.astype(jdt), *split(r[:8]),
            r[8:], H, 1e-6, jm),
        lambda xq, xk, xv, *r: fa.ca_block(
            xq.to(tdt), xk.to(tdt), xv.to(tdt), *split(r[:8]), r[8:], H,
            1e-6, tm),
        [*xs, *conds, *params], g, dtype)
    _compare(want, got, F32_BOUND if dtype == "f32" else BF16_BOUND,
             zero=("d6", "d14"))


# ---------------------------------------------------------------------------
# The mesh pieces at the two-level coarsening, and convert.py at 1723
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sizes", [(6890, 1723), (6890, 600)], ids=str)
def test_two_level_coarsening_and_assets_match_jax(sizes):
    """``synthetic_coarsening(sizes=...)`` gives JAX's operators bit for
    bit; ``default_assets`` (``build_vj_relation`` over the last level) the
    same vertex-to-joint relation, one joint for each of the last level's
    vertices."""
    port, ref = (tmesh.synthetic_coarsening(sizes=sizes),
                 jmesh.synthetic_coarsening(sizes=sizes))
    assert port.sizes == ref.sizes == sizes
    for a, b in zip(port.D + port.U, ref.D + ref.U):
        np.testing.assert_array_equal(a, b)
    art = synthetic_artifacts(seed=0)
    jart = jmesh_artifacts()
    np.testing.assert_array_equal(art.v_template, jart.v_template)
    t = tpmce.default_assets(art, port)
    j = jpmce.default_assets(jart, ref)
    assert len(t.vj_relation) == sizes[-1]
    assert tuple(t.vj_relation) == tuple(j.vj_relation)
    np.testing.assert_array_equal(t.joint_regressor_h36m,
                                  j.joint_regressor_h36m)


def jmesh_artifacts():
    from pmce_tpu.smpl.artifacts import synthetic_artifacts as jart

    return jart(seed=0)


def test_convert_carries_a_1723_vertex_pmce_across():
    """A narrow PMCE on the two-level coarsening (1723 vertex tokens):
    every JAX parameter lands in the port's model unchanged (a strict load,
    bit for bit), the vertex stream's token embedding at [1723, 64]."""
    coarse = jmesh.synthetic_coarsening(sizes=(6890, V_COARSE))
    jart = jmesh_artifacts()
    cfg = dict(embed_dim=64, depth=1, num_vertx=V_COARSE,
               num_verts_full=6890, joint_dim=64, vertx_dim=64,
               gru_hidden=32, seqlen=16)
    vj = tuple(int(i) for i in jpmce.default_assets(jart, coarse).vj_relation)
    jm = jpmce.PMCE(num_joint=17, vj_relation=vj, fused_attn=True, **cfg)
    params = numpy_params(init_shapes(jm, np.zeros((1, 16, 17, 2),
                                                   np.float32),
                                      np.zeros((1, 16, 2048), np.float32)),
                          11)
    sd = convert.state_dict_from_jax(params, vj)
    model = PMCE(num_joint=17, vj_relation=vj, dtype=None, fused=True, **cfg)
    model.load_state_dict(sd, strict=True)
    flat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_leaves_with_path(params)}
    own = model.state_dict()
    for name, t in sd.items():
        assert torch.equal(own[name], t), name
    n_jax = sum(a.size for a in flat.values())
    n_port = sum(p.numel() for p in model.parameters())
    assert n_jax == n_port
    shapes = {tuple(t.shape) for n, t in sd.items() if "vertx" in n}
    assert any(V_COARSE in s for s in shapes), shapes


# ---------------------------------------------------------------------------
# A narrow PMCE at 600 coarse vertices, training mode, against JAX
# ---------------------------------------------------------------------------

T, J, B2, V_FULL, V_LONG = 16, 17, 2, 6890, 600
CFG = dict(embed_dim=64, depth=1, num_vertx=V_LONG, num_verts_full=V_FULL,
           joint_dim=64, vertx_dim=64, gru_hidden=32, seqlen=T)
WEIGHTS = (0.1, 20.0, 1e-3)
KEY_BIASES = ("wk.bias", "normk.mlp_beta.weight", "normk.mlp_beta.bias")
ORDER = ("mesh", "lift_pose3d", "reg_pose3d", "mesh_valid",
         "lift_pose3d_valid", "reg_pose3d_valid")


class _NoDropLifter(jlifter.PoseLifter):
    drop_path_rate: float = 0.0


class _NoDropCoevoBlock(jcoevo.CoevoBlock):
    drop_path: float = 0.0


def test_pmce_at_600_coarse_vertices_trains_as_jax():
    """The port's fused f32 route (``ada_block`` / ``ca_block`` at 600
    vertex tokens; on the CPU their plain versions) against
    ``jax.value_and_grad`` through JAX's interpreted ``fused_ada_block`` /
    ``fused_ca_block`` (3 and 6 calls), drop path 0 both sides, weights
    through ``convert.py``: loss within 1e-5, each gradient within 1e-4 of
    its largest magnitude (the key biases, zero analytically, of the
    model's largest gradient)."""
    from pmce_tpu.ops import fused_attention as jfa

    art = synthetic_artifacts(seed=0)
    coarse = tmesh.synthetic_coarsening(sizes=(V_FULL, V_LONG))
    assets = tpmce.default_assets(art, coarse)
    jr = assets.joint_regressor_h36m
    vj = tuple(int(i) for i in assets.vj_relation)
    rng = np.random.default_rng(26)

    def mask(*shape):
        return (rng.random(shape) > 0.2).astype(np.float32)

    batch = {
        "pose2d": rng.standard_normal((B2, T, J, 2), dtype=np.float32),
        "img_feature": rng.standard_normal((B2, T, 2048), dtype=np.float32),
        "mesh": (rng.normal(size=(B2, V_FULL, 3)) * 0.1).astype(np.float32),
        "lift_pose3d": (rng.normal(size=(B2, J, 3)) * 300).astype(
            np.float32),
        "reg_pose3d": (rng.normal(size=(B2, J, 3)) * 300).astype(np.float32),
        "mesh_valid": mask(B2, 1, 1), "lift_pose3d_valid": mask(B2, J, 1),
        "reg_pose3d_valid": mask(B2, J, 1)}
    jm = jpmce.PMCE(num_joint=J, vj_relation=vj, fused_attn=True, **CFG)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jface = jlosses.build_face_losses(art.faces, V_FULL)
    with mock.patch.object(jpmce, "PoseLifter", _NoDropLifter), \
            mock.patch.object(jcoevo, "CoevoBlock", _NoDropCoevoBlock):
        params = numpy_params(init_shapes(jm, batch["pose2d"][:1],
                                          batch["img_feature"][:1]), 26)

        def jloss(p):
            mesh, evo, pose3d = jm.apply(
                {"params": p}, jb["pose2d"], jb["img_feature"],
                deterministic=False,
                rngs={"droppath": jax.random.PRNGKey(0),
                      "dropout": jax.random.PRNGKey(1)})
            return jlosses.pmce_total_loss(
                mesh, evo, pose3d, *(jb[k] for k in ORDER),
                jnp.asarray(art.faces), jnp.asarray(jr), *WEIGHTS, 1.0,
                face_loss_fn=jface)[0]

        with mock.patch.object(jfa, "fused_ada_block",
                               wraps=jfa.fused_ada_block) as ada, \
                mock.patch.object(jfa, "fused_ca_block",
                                  wraps=jfa.fused_ca_block) as ca:
            want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(
                jax.tree_util.tree_map(jnp.asarray, params))
        assert ada.call_count == 3 and ca.call_count == 6
    model = PMCE(num_joint=J, vj_relation=vj, dtype=None, fused=True, **CFG)
    model.load_state_dict(convert.state_dict_from_jax(params, vj),
                          strict=True)
    for mod in model.modules():
        if isinstance(mod, DropPath):
            mod.rate = 0.0
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with mock.patch.object(fa, "ada_block", wraps=fa.ada_block) as t_ada, \
            mock.patch.object(fa, "ca_block", wraps=fa.ca_block) as t_ca:
        loss, _ = pmce_loss(model.train(), tb, torch.as_tensor(art.faces),
                            torch.from_numpy(jr), WEIGHTS, 1.0,
                            losses.build_face_losses(art.faces, V_FULL,
                                                     "cpu"),
                            torch.Generator().manual_seed(0))
        loss.backward()
    assert t_ada.call_count == 3 and t_ca.call_count == 6
    assert all(c.args[0].shape[1] == V_LONG for c in t_ada.call_args_list)
    assert {max(c.args[0].shape[1], c.args[1].shape[1])
            for c in t_ca.call_args_list} == {V_LONG}
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    g_want = convert.state_dict_from_jax(jax.device_get(want_grads))
    largest = max(float(g.abs().max()) for g in g_want.values())
    for name, p in model.named_parameters():
        want = g_want[name].numpy()
        if p.grad is None:
            # Only the last block's joint stream reaches the output.
            assert name.startswith("pose_mesh_coevo.coevoblock"), name
            assert not want.any(), name
            continue
        err = np.abs(p.grad.numpy() - want).max()
        if name.endswith(KEY_BIASES) or name.endswith("v2j_K_embed"):
            # The key biases: zero analytically. The vertex keys'
            # embedding of the joints' cross-attention: only the x1e-3
            # joint loss reaches it, through a 600-key softmax (under
            # 1e-6 of the largest gradient). Both held to the largest.
            assert err <= 1e-4 * largest, (name, err / largest)
        else:
            assert err <= 1e-4 * np.abs(want).max(), (
                name, err / np.abs(want).max())


def test_ctypes_table_of_the_tile_backward_holds_41_pointers():
    """The tile backward's pointer table: the 40 of the 431-vertex layout,
    then the workspace (``csrc/ca_block.cu``'s pmce_ca_bwd_tile reads
    ptrs[40])."""
    xs, conds, params, masks = _bf16_ca(1, V_COARSE, 17, 2)
    tables = []

    def call(name, table, *rest):
        if name == "pmce_ca_bwd_tile":
            arr = ctypes.cast(table, ctypes.POINTER(ctypes.c_void_p))
            tables.append([arr[i] for i in range(41)])

    with _enter(_stubs(call, _cuda.CA)):
        y = fa.ca_block(*xs, tuple(conds[0::2]), tuple(conds[1::2]),
                        tuple(params), 2, 1e-6, masks)
        y.backward(torch.zeros_like(y))
    (table,) = tables
    assert table[39] is None and table[40] is not None
