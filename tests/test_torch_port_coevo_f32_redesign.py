"""Rows 3f / 14f redesigned (``csrc/coevo_f32.cu``: a cluster of CTAs a
clip, 3xTF32 products and attention on the tensor cores), their host side
and numerics, on the CPU.

- the numerics before any CUDA: a CPU model of the kernel's arithmetic
  patched over the plain chain and whole block (``fc.mm``: every row
  product; ``fc.attend``: the attention). Operands split as the kernel
  splits them (hi = tf32_rna(v), lo = v - hi read to 19 bits), each 8-wide
  k-step of a product summed from zero (a_lo b_hi + a_hi b_lo + a_hi b_hi)
  and added to the f32 sums rounded; the attention over the keys in 64-row
  chunks of each rank's range at the plan's S (4 at V = 431), an online
  softmax (weights as 2^(x log2 e), the kernel's exp2): the vertex
  self-attention through every rank's chunks in rank order, the joints
  over the vertices a partial (o, max, sum) a rank merged in rank order;
  the 3 -> C embeds and the C -> 3 heads in f32 (FFMA in the kernel).
  Held against JAX's ``fused_coevo_chain`` (its Pallas kernel
  interpreted, as ``test_torch_port_f32_kernels.py`` runs it) and
  ``coevo_chain_reference`` at V = 431, B = 2, J = 17 and 19, 3 blocks,
  and against ``fused_coevo_block`` and ``coevo_block_reference`` at the
  same shapes: within 2e-6 of each output's largest magnitude (measured
  ≤ 5.1e-7; the plain f32 versions alone ≤ 4.4e-7);
- ``coevo_f32_plan`` at 132 and 114 SMs and without a card: S (up to 16
  at V <= 2048), each rank's rows, the CTAs, the clusters and the waves;
- the S the wrappers pass to ``pmce_coevo_chain_f32`` /
  ``pmce_coevo_block_f32`` (the card stood in for) and their gate's V and J
  limits (past them ``NotImplementedError`` naming ROADMAP.md B3).

``tests/test_torch_port_f32_cpu_build.py`` (``slow``) runs the source
itself, built for the CPU, on clusters of 1-3 CTAs.
"""

from __future__ import annotations

import ctypes
from unittest import mock

import numpy as np
import pytest
import torch

from pmce_tpu.ops import fused_attention as jfa
from pmce_tpu.ops import fused_coevo_chain as jfc
from pmce_tpu_torch.ops import _cuda
from pmce_tpu_torch.ops import fused_attention as fa
from pmce_tpu_torch.ops import fused_coevo_chain as fc
from test_torch_port_block_f32_redesign import split_as_the_kernel
from test_torch_port_f32_kernels import (_chain_case, _coevo_block_case,
                                         _coevo_stubs, _j, _run, _t)

V = 431
JAX_TOL = 2e-6
KSTEP, CHUNK = 8, 64
LOG2E = 1.4426950408889634


# ---------------------------------------------------------------------------
# The CPU model of the kernel's arithmetic
# ---------------------------------------------------------------------------


def ksteps(a, b, acc=None):
    """``acc + a @ b`` as the kernel sums it: each 8-wide k-step's three
    TF32 products (a_lo b_hi + a_hi b_lo + a_hi b_hi) summed from zero,
    then added to the f32 sums rounded."""
    (ah, al), (bh, bl) = split_as_the_kernel(a), split_as_the_kernel(b)
    out = acc
    for k in range(0, a.shape[-1], KSTEP):
        ks = slice(k, k + KSTEP)
        step = (al[..., ks] @ bh[..., ks, :] + ah[..., ks] @ bl[..., ks, :]) \
            + ah[..., ks] @ bh[..., ks, :]
        out = step if out is None else out + step
    return out


def model_mm(a, w):
    """A row product: 3xTF32 k-steps; the 3 -> C embeds (K = 3) in f32, as
    the kernel's FFMA."""
    a, w = a.float(), w.float()
    return a @ w if a.shape[-1] < KSTEP else ksteps(a, w)


def _exp(x):
    """The kernel's softmax weight, 2^(x log2 e)."""
    return torch.exp2(x * LOG2E)


def _online(q, k, v, chunks):
    """The kernel's online softmax over the key chunks in order: o
    (unnormalised), max, sum."""
    m = l = o = None
    for c0, c1 in chunks:
        s = ksteps(q, k[..., c0:c1, :].transpose(-1, -2))
        mx = s.amax(-1, keepdim=True)
        mn = mx if m is None else torch.maximum(m, mx)
        p = _exp(s - mn)
        if m is None:
            l, o = p.sum(-1, keepdim=True), ksteps(p, v[..., c0:c1, :])
        else:
            alpha = _exp(m - mn)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = ksteps(p, v[..., c0:c1, :], o * alpha)
        m = mn
    return o, m, l


def model_attend(q, k, v):
    """``fc.attend`` as the kernel runs it. Over the V vertex keys: each
    rank's 64-row chunks; the vertex SA (queries = keys) one online softmax
    through every rank's chunks in rank order, the joint queries a partial
    a rank merged in rank order. Over the J joint keys: one chunk."""
    q, k, v = q.float(), k.float(), v.float()
    Nq, Nk = q.shape[-2], k.shape[-2]
    if Nk != V:
        o, _, l = _online(q, k, v, [(0, Nk)])
        return o / l
    ranks = [[(c, min(c + CHUNK, r1)) for c in range(r0, r1, CHUNK)]
             for r0, r1 in fa.coevo_f32_plan(1, 17, V, None).rows]
    if Nq == Nk:
        o, _, l = _online(q, k, v, [c for r in ranks for c in r])
        return o / l
    parts = [_online(q, k, v, r) for r in ranks]
    M = parts[0][1]
    for _, m, _ in parts[1:]:
        M = torch.maximum(M, m)
    O = L = 0.0
    for o, m, l in parts:
        f = torch.exp(m - M)  # the merge's expf
        O, L = O + o * f, L + l * f
    return O / L


def _model(fn, *args):
    with mock.patch.object(fc, "mm", model_mm), \
            mock.patch.object(fc, "attend", model_attend), torch.no_grad():
        return fn(*args, 8, 2)


def _err(got, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(got.numpy() - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("J", [17, 19], ids=["h36m17", "coco19"])
def test_3xtf32_model_of_the_chain_holds_against_jax(J):
    inputs, blocks = _chain_case(J, batch=2, J=J, V=V)
    got = _model(fc.coevo_chain_plain, *_t(inputs), _t(blocks))
    kernel = jfc.fused_coevo_chain(*_j(inputs), _j(blocks), 8, 2)
    ref = jfc.coevo_chain_reference(*_j(inputs), _j(blocks), 8, 2)
    errs = [_err(a, r) for want in (kernel, ref) for a, r in zip(got, want)]
    print(f"3xTF32 model of the chain, J={J}: vs the JAX kernel "
          f"{errs[0]:.3g} / {errs[1]:.3g}, vs its reference {errs[2]:.3g} / "
          f"{errs[3]:.3g}")
    assert all(a.shape == tuple(r.shape) for a, r in zip(got, kernel))
    assert max(errs) <= JAX_TOL, errs


@pytest.mark.parametrize("J", [17, 19], ids=["h36m17", "coco19"])
def test_3xtf32_model_of_the_whole_block_holds_against_jax(J):
    args = _coevo_block_case(J + 1, batch=2, J=J, V=V)
    got = _model(fc.coevo_block_plain, *_t(args))
    kernel = jfa.fused_coevo_block(*_j(args), 8, 2)
    ref = jfa.coevo_block_reference(*_j(args), 8, 2)
    errs = [_err(a, r) for want in (kernel, ref) for a, r in zip(got, want)]
    print(f"3xTF32 model of the whole block, J={J}: vs the JAX kernel "
          f"{errs[0]:.3g} / {errs[1]:.3g}, vs its reference {errs[2]:.3g} / "
          f"{errs[3]:.3g}")
    assert all(a.shape == tuple(r.shape) for a, r in zip(got, kernel))
    assert max(errs) <= JAX_TOL, errs


def test_the_model_differs_from_plain_f32():
    """The model is not the plain version: its products are 3xTF32's, its
    softmax chunked (a check that the patches reach the chain's
    products)."""
    inputs, blocks = _chain_case(3, batch=1, J=17, V=V)
    got = _model(fc.coevo_chain_plain, *_t(inputs), _t(blocks))
    with torch.no_grad():
        want = fc.coevo_chain_plain(*_t(inputs), _t(blocks), 8, 2)
    assert all(0 < float((a - b).abs().max()) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

# (V, S): the fewest of 1, 2, 4, 8, 16 CTAs a clip that leave a rank at
# most 8 tiles of 16 vertex rows.
SPLITS = [(48, 1), (128, 1), (129, 2), (256, 2), (257, 4), (431, 4),
          (512, 4), (513, 8), (1024, 8), (1025, 16), (1723, 16), (2048, 16)]


@pytest.mark.parametrize("V_,S", SPLITS, ids=[f"V{v}" for v, _ in SPLITS])
def test_plan_splits_a_clip_into_ranks_of_at_most_8_tiles(V_, S):
    plan = fa.coevo_f32_plan(2, 19, V_, None)
    assert plan.splits == fa.coevo_f32_splits(V_) == S
    rows = [r for r0, r1 in plan.rows for r in range(r0, r1)]
    assert rows == list(range(V_))
    assert all(r0 % 16 == 0 and 0 < r1 - r0 <= 128 for r0, r1 in plan.rows)
    sizes = [r1 - r0 for r0, r1 in plan.rows]
    assert max(sizes) - min(sizes) <= 16  # balanced to a tile


# (B, SMs) -> (CTAs, clusters, waves) at V = 431 (S = 4): the serving and
# Stage-2 evaluation batches on an H100 SXM (132 SMs: 30 clusters of 4 at
# once, read on the card) and PCIe (114: not read, its SMs // 4).
WAVES = {(64, 132): (256, 30, 3), (256, 132): (1024, 30, 9),
         (64, 114): (256, 28, 3), (256, 114): (1024, 28, 10),
         (64, None): (256, None, None)}


@pytest.mark.parametrize("case", list(WAVES),
                         ids=[f"B{b}-{s}sm" for b, s in WAVES])
def test_plan_at_the_shipped_shape(case):
    B, sms = case
    plan = fa.coevo_f32_plan(B, 17, V, sms)
    assert plan.splits == 4
    assert plan.rows == ((0, 96), (96, 208), (208, 320), (320, 431))
    assert (plan.ctas, plan.clusters, plan.waves) == WAVES[case]


# ---------------------------------------------------------------------------
# The wrappers' S and gate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,V_", [("chain", 431), ("chain", 200),
                                     ("block", 431), ("block", 61)])
def test_wrappers_pass_the_plans_splits(kind, V_):
    """One launch whose integers are B, J, V, (NB,) then the plan's S; no
    workspace pointer (the kernel has none)."""
    calls = []

    def call(name, *args):
        calls.append((name, args))

    if kind == "chain":
        inputs, blocks = _chain_case(7, batch=3, V=V_)
        fn, args, n_ptr = fc.coevo_chain, (*_t(inputs), _t(blocks)), 6
    else:
        fn, args, n_ptr = fc.coevo_block, _t(_coevo_block_case(
            8, batch=3, V=V_)), 7
    J = args[0].shape[1]
    with torch.no_grad():
        _run(_coevo_stubs([]) + [mock.patch.object(_cuda.COEVO_F32, "call",
                                                   call)],
             lambda: fn(*args, 8, 2))
    (name, cargs), = calls
    assert name == f"pmce_coevo_{kind}_f32"
    assert all(isinstance(a, ctypes.c_void_p) for a in cargs[:n_ptr])
    ints = cargs[n_ptr:-4]
    S = fa.coevo_f32_plan(3, J, V_, None).splits
    assert ints == ((3, J, V_, 3, S) if kind == "chain" else (3, J, V_, S))
    assert S == (4 if V_ == 431 else 2 if V_ == 200 else 1)


@pytest.mark.parametrize("J,V_,ok", [(19, 1024, True), (19, 1040, True),
                                     (19, 2048, True), (19, 2064, False),
                                     (32, 431, True), (33, 431, False)],
                         ids=["V1024", "V1040", "V2048", "V2064", "J32",
                              "J33"])
def test_gate_takes_what_the_plan_admits(J, V_, ok):
    """V ≤ 2048 (16 CTAs of 128 rows) and J ≤ 32 (two warp tiles) launch;
    past them ``NotImplementedError`` names the limit and ROADMAP.md B3,
    and nothing launches."""
    seen = []
    case = _coevo_block_case(9, batch=1, J=J, V=V_)
    with torch.no_grad():
        if ok:
            _run(_coevo_stubs(seen), lambda: fc.coevo_block(*_t(case), 8, 2))
            assert seen == ["pmce_coevo_block_f32"]
            return
        limit = "V <= 2048" if V_ > 2048 else "J <= 32"
        with pytest.raises(NotImplementedError,
                           match=f"{limit}.*ROADMAP.md B3"):
            _run(_coevo_stubs(seen), lambda: fc.coevo_block(*_t(case), 8, 2))
    assert seen == []
