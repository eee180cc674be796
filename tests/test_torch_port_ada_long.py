"""The bf16 AdaLN block's tile programs (rows 8 / 9) past 512 tokens, on
the CPU.

- the gates: C = 64 and hid up to 256 at any token count (513, 600, the
  1723-vertex mesh, 2048); hid 320 and C 128 still take the launch
  sequences;
- ``ada_bwd_passes`` / ``ada_bwd_workspace``: the passes of 128 rows a CTA
  walks and the backward's dx1 workspace (none in one pass);
- the wrappers at 1723 tokens with ``_cuda.ADA.call`` stubbed: the forward
  one ``pmce_ada_fwd_tile`` call, the backward ``pmce_ada_bwd_tile`` with
  its 31st pointer (the workspace, set exactly when a CTA takes more than
  one pass) and then ``pmce_ada_wgrad``, never a sequence;
- a torch model of the programs' schedule in f32 (``_model``): each of a
  clip's four CTAs walks its quarter (``rank_rows``) in passes of 128
  rows; the backward's phase 1 runs a pass's row-local chain and dq over
  every key, writing dO, D and (more than one pass) dx1 to buffers that
  start as NaN; after the barrier, phase 2 runs dk / dv over every query
  and qkvᵀ + norm1 a pass at a time, reading only those buffers, the
  saved state and the pass's own dq; the per-clip vectors add up over a
  CTA's passes, then over the CTAs in rank order. At 600 tokens and at
  1723 (1-2 clips, C 64, hid 128, masks dropping a branch) it is held
  against JAX's interpreted ``fused_ada_block`` and its VJP (mask
  gradients included) within 1e-4 and against ``ada_block_plain``'s
  autograd.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmce_tpu.ops.fused_attention import fused_ada_block
from pmce_tpu_torch.ops import _cuda
from pmce_tpu_torch.ops import fused_attention as fa
from tests.test_torch_port_bwd_redesign import _enter, _stubs
from tests.test_torch_port_decoder_redesign import _bf16_ada
from tests.test_torch_port_fwd_redesign import _Launches

# pmce_ada_bwd_tile's table ends in counters, stamps, dx1 (the workspace).
_ADA_PTRS = {"pmce_ada_fwd_tile": 28, "pmce_ada_block_fwd": 27,
             "pmce_ada_bwd_tile": 31, "pmce_ada_wgrad": 12,
             "pmce_ada_block_bwd": 27}
TOL = 1e-4


# ---------------------------------------------------------------- the gates
@pytest.mark.parametrize("N", [431, 512, 513, 600, 1723, 2048])
def test_gates_take_any_token_count(N):
    """At C = 64 and hid up to 256 both tile programs take any N; hid 320
    and C 128 take the launch sequences at any N."""
    for hid in (64, 128, 256):
        assert fa.ada_fwd_kernel_fits(N, 64, hid)
        assert fa.ada_bwd_kernel_fits(N, 64, hid)
    for C, hid in ((64, 320), (64, 512), (128, 256)):
        assert not fa.ada_fwd_kernel_fits(N, C, hid)
        assert not fa.ada_bwd_kernel_fits(N, C, hid)


@pytest.mark.parametrize("N,passes", [(17, 1), (431, 1), (512, 1),
                                      (513, 2), (600, 2), (1723, 4),
                                      (2048, 4)])
def test_passes_and_workspace(N, passes):
    """A CTA's rows (``rank_rows``: a quarter in whole 16-row blocks) in
    passes of 128; the workspace, dx1 f32 [B * N, 64], only past one."""
    assert fa.ada_bwd_passes(N) == passes
    assert max(-(-nr // 128) for _, nr in _ranks(N)) == passes
    B = 3
    assert fa.ada_bwd_workspace(B, N) == (B * N * 64 if passes > 1 else 0)


# ---------------------------------------------- the wrappers at 1723 tokens
@pytest.mark.parametrize("grad", [False, True], ids=["no-grad", "grad"])
def test_forward_at_1723_is_one_tile_call(grad):
    """The forward at 1723 tokens: one ``pmce_ada_fwd_tile`` call with N =
    1723 (launch A, then B), the saved state only under grad; counted by
    ``ada_block_fwd`` alone."""
    B, N, H = 2, 1723, 2
    x, gb, params, masks = _bf16_ada(B, N, H)
    launches = _Launches(_ADA_PTRS)
    _cuda.reset_launch_counts()
    with _enter(_stubs(launches, _cuda.ADA)), torch.set_grad_enabled(grad):
        fa.ada_block(x, *gb, params, H, 1e-6, masks)
    assert launches.names == ["pmce_ada_fwd_tile"]
    (_, fwd, ints), = launches.calls
    assert tuple(ints[:4]) == (B, N, 256, H)
    assert [bool(fwd[i]) for i in range(17, 25)] == [grad] * 8
    counts = _cuda.launch_counts()
    assert counts["ada_block_fwd"] == 1 and counts["ada_block_fwd_seq"] == 0


@pytest.mark.parametrize("N", [431, 600, 1723])
@pytest.mark.parametrize("mask_grad", [False, True],
                         ids=["masks", "mask-grads"])
def test_backward_is_the_tile_program_with_its_workspace(N, mask_grad):
    """The backward: exactly ``pmce_ada_bwd_tile`` then ``pmce_ada_wgrad``
    (never ``pmce_ada_block_bwd``); the tile program's 31st pointer, dx1's
    workspace, is set exactly when a CTA walks more than one pass; dm1,
    dm2 only when owed; the counters the weight launch reads; counted by
    ``ada_block_bwd`` alone."""
    B, H = 2, 2
    x, gb, params, masks = _bf16_ada(B, N, H, mask_grad=mask_grad)
    launches = _Launches(_ADA_PTRS)
    _cuda.reset_launch_counts()
    with _enter(_stubs(launches, _cuda.ADA)):
        y = fa.ada_block(x, *gb, params, H, 1e-6, masks)
        y.backward(torch.zeros_like(y))
    assert launches.names == ["pmce_ada_fwd_tile", "pmce_ada_bwd_tile",
                              "pmce_ada_wgrad"]
    (_, fwd, _), (_, tile, ints), (_, wg, wints) = launches.calls
    assert tuple(ints[:4]) == (B, N, 256, H)
    assert bool(tile[30]) == (fa.ada_bwd_passes(N) > 1)
    assert bool(tile[26]) == bool(tile[27]) == mask_grad
    assert tile[28] == wg[10] != 0 and tile[29] == 0
    assert tuple(wints[:2]) == (B * N, 256)
    counts = _cuda.launch_counts()
    assert counts["ada_block_fwd"] == counts["ada_block_bwd"] == 1
    assert counts["ada_block_fwd_seq"] == counts["ada_block_bwd_seq"] == 0


# --------------------------------------------- the programs' schedule in f32
def _ranks(N):
    """(first row, rows) of each of a clip's 4 CTAs (``rank_rows``)."""
    per = -(-(-(-N // 4)) // 16) * 16
    out = []
    for rank in range(4):
        r0 = min(N, rank * per)
        out.append((r0, min(N, r0 + per) - r0))
    return out


def _passes(N):
    """Each CTA's passes in order: (rank, first row, rows)."""
    for rank, (r0, nr) in enumerate(_ranks(N)):
        for p in range(max(1, -(-nr // 128))):
            yield rank, r0 + p * 128, min(128, nr - p * 128)


def _adaln(x, gamma, beta, eps):
    u = x - x.mean(-1, keepdim=True)
    inv = 1.0 / (u.pow(2).sum(-1, keepdim=True).div(x.shape[-1] - 1).sqrt()
                 + eps)
    return gamma * (u * inv) + beta


def _adaln_bwd(dy, x, gamma, eps):
    """dx of the AdaLN (adaln_tile.cuh's adaln_bwd_frag) and the rows'
    dgamma, dbeta terms summed."""
    C = x.shape[-1]
    u = x - x.mean(-1, keepdim=True)
    sigma = u.pow(2).sum(-1, keepdim=True).div(C - 1).sqrt()
    inv = 1.0 / (sigma + eps)
    coef = (inv * inv * (dy * gamma * u).sum(-1, keepdim=True) / (C - 1)
            / sigma.clamp_min(1e-20))
    du = dy * gamma * inv - u * coef
    return (du - du.mean(-1, keepdim=True), (dy * u * inv).sum(0),
            dy.sum(0))


def _gelu_grad(h):
    cdf = 0.5 * (1.0 + torch.erf(h / math.sqrt(2.0)))
    return cdf + h * torch.exp(-0.5 * h * h) / math.sqrt(2.0 * math.pi)


def _model(x, gb, params, H, eps, masks, g):
    """The forward and backward of rows 8 / 9 by the programs' schedule,
    f32, one clip at a time. Returns y and the gradients of x, the four
    AdaLN vectors, the eight parameters and the two masks."""
    g1, b1, g2, b2 = gb
    wqkv, bqkv, wproj, bproj, w1, bb1, w2, bb2 = params
    B, N, C = x.shape
    D = C // H
    qscale = 1.0 / math.sqrt(D)
    nan = float("nan")
    y, dx = torch.empty_like(x), torch.empty_like(x)
    dgb = torch.zeros(4, B, C)
    dms = torch.zeros(2, B)
    saved = {k: [] for k in ("h1", "qkv", "o", "h2", "ge", "da", "dqkv",
                             "dhh", "m2g")}
    for b in range(B):
        s1, s2 = float(masks[0][b]), float(masks[1][b])
        xb, gy = x[b], g[b]
        # -- the forward: launch A a pass at a time, then launch B ---------
        h1 = torch.full((N, C), nan)
        qkv = torch.full((N, 3 * C), nan)
        for _, r0, n in _passes(N):
            rows = slice(r0, r0 + n)
            h1[rows] = _adaln(xb[rows], g1[b], b1[b], eps)
            t = h1[rows] @ wqkv + bqkv
            t[:, :C] *= qscale
            qkv[rows] = t
        q, k, v = qkv[:, :C], qkv[:, C:2 * C], qkv[:, 2 * C:]
        o = torch.full((N, C), nan)
        sm, sl = torch.full((H, N), nan), torch.full((H, N), nan)
        x1, hh, h2 = (torch.full((N, C), nan), torch.full((N, w1.shape[1]),
                                                          nan),
                      torch.full((N, C), nan))
        ge, a, mo = torch.full_like(hh, nan), torch.full((N, C), nan), \
            torch.full((N, C), nan)
        for _, r0, n in _passes(N):
            rows = slice(r0, r0 + n)
            for h in range(H):
                cols = slice(h * D, (h + 1) * D)
                s = q[rows, cols] @ k[:, cols].T          # every key
                m = s.max(-1).values
                lsum = torch.exp(s - m[:, None]).sum(-1)
                sm[h, rows], sl[h, rows] = m, lsum
                o[rows, cols] = (torch.exp(s - m[:, None]) / lsum[:, None]
                                 ) @ v[:, cols]
            a[rows] = o[rows] @ wproj + bproj
            x1[rows] = xb[rows] + s1 * a[rows]
            h2[rows] = _adaln(x1[rows], g2[b], b2[b], eps)
            hh[rows] = h2[rows] @ w1 + bb1
            ge[rows] = torch.nn.functional.gelu(hh[rows])
            mo[rows] = ge[rows] @ w2 + bb2
            y[b, rows] = x1[rows] + s2 * mo[rows]
        # -- the backward's phase 1, a pass at a time ------------------------
        vp = torch.zeros(4, 4 * C + 2)          # each CTA's per-clip sums
        dout = torch.full((N, C), nan)          # device memory: dO, D
        dsum = torch.full((H, N), nan)
        dx1_ws = torch.full((N, C), nan)        # the workspace (or region M)
        dqkv = torch.full((N, 3 * C), nan)
        da_all, m2g_all = torch.full((N, C), nan), torch.full((N, C), nan)
        dhh_all = torch.full_like(hh, nan)
        for rank, r0, n in _passes(N):
            rows = slice(r0, r0 + n)
            m2g = gy[rows] * s2
            dhh = (m2g @ w2.T) * _gelu_grad(hh[rows])
            dh2 = dhh @ w1.T
            dxn, cg2, cb2 = _adaln_bwd(dh2, x1[rows], g2[b], eps)
            dx1 = dxn + gy[rows]
            dx1_ws[rows] = dx1
            vp[rank, 2 * C:3 * C] += cg2
            vp[rank, 3 * C:4 * C] += cb2
            vp[rank, 4 * C] += (dx1 * a[rows]).sum()
            vp[rank, 4 * C + 1] += (gy[rows] * mo[rows]).sum()
            da = dx1 * s1
            dO = da @ wproj.T
            dout[rows] = dO
            for h in range(H):
                cols = slice(h * D, (h + 1) * D)
                dsum[h, rows] = (dO[:, cols] * o[rows, cols]).sum(-1)
                p = torch.exp(q[rows, cols] @ k[:, cols].T
                              - sm[h, rows, None]) / sl[h, rows, None]
                ds = p * (dO[:, cols] @ v[:, cols].T - dsum[h, rows, None])
                dqkv[rows, cols] = ds @ k[:, cols] * qscale
            da_all[rows], m2g_all[rows], dhh_all[rows] = da, m2g, dhh
        # -- the cluster barrier; phase 2, a pass at a time -----------------
        for rank, r0, n in _passes(N):
            rows = slice(r0, r0 + n)
            for h in range(H):
                cols = slice(h * D, (h + 1) * D)
                kc, vc = C + h * D, 2 * C + h * D
                p = torch.exp(k[rows, cols] @ q[:, cols].T
                              - sm[h, None, :]) / sl[h, None, :]
                ds = p * (v[rows, cols] @ dout[:, cols].T - dsum[h, None, :])
                dqkv[rows, kc:kc + D] = ds @ q[:, cols]
                dqkv[rows, vc:vc + D] = p @ dout[:, cols]
            dh = dqkv[rows] @ wqkv.T
            dxl, cg1, cb1 = _adaln_bwd(dh, xb[rows], g1[b], eps)
            dx[b, rows] = dxl + dx1_ws[rows]
            vp[rank, :C] += cg1
            vp[rank, C:2 * C] += cb1
        # -- the per-clip sums over the cluster, in rank order --------------
        tot = vp[0] + vp[1] + vp[2] + vp[3]
        dgb[:, b] = tot[:4 * C].view(4, C)
        dms[:, b] = tot[4 * C:]
        for key, val in (("h1", h1), ("qkv", qkv), ("o", o), ("h2", h2),
                         ("ge", ge), ("da", da_all), ("dqkv", dqkv),
                         ("dhh", dhh_all), ("m2g", m2g_all)):
            saved[key].append(val)
    cat = {k: torch.cat(v) for k, v in saved.items()}
    wgrads = (cat["h1"].T @ cat["dqkv"], cat["dqkv"].sum(0),
              cat["o"].T @ cat["da"], cat["da"].sum(0),
              cat["h2"].T @ cat["dhh"], cat["dhh"].sum(0),
              cat["ge"].T @ cat["m2g"], cat["m2g"].sum(0))
    return y, (dx, *dgb, *wgrads, dms[0].view(B, 1, 1), dms[1].view(B, 1, 1))


def _case(clips, N, hid=128, seed=0):
    rng = np.random.default_rng([clips, N, seed])
    C = 64

    def w(*shape, scale=0.2, offset=0.0):
        return (rng.normal(size=shape) * scale + offset).astype(np.float32)

    x = w(clips, N, C, scale=1.0)
    gb = [w(clips, C, scale=0.2, offset=1.0 - i % 2) for i in range(4)]
    params = [w(C, 3 * C, scale=C ** -0.5), w(3 * C, scale=0.05),
              w(C, C, scale=C ** -0.5), w(C, scale=0.05),
              w(C, hid, scale=C ** -0.5), w(hid, scale=0.05),
              w(hid, C, scale=hid ** -0.5), w(C, scale=0.05)]
    keep = np.full((2, clips, 1, 1), 1.25, np.float32)
    if clips > 1:
        keep[0, 0] = keep[1, 1] = 0.0       # each branch dropped for a clip
    return x, gb, params, (keep[0], keep[1]), w(clips, N, C, scale=1.0)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("clips,N", [(2, 600), (1, 1723), (2, 1723)],
                         ids=["2x600", "1x1723", "2x1723"])
def test_schedule_model_matches_jax_and_plain(clips, N):
    """The model of the programs' passes (see ``_model``) against JAX's
    interpreted ``fused_ada_block`` and its VJP (mask gradients included)
    within 1e-4 of each output's largest magnitude, and against
    ``ada_block_plain``'s autograd; the buffers phase 2 reads are all
    written by phase 1 (they start as NaN)."""
    H, eps = 2, 1e-6
    x, gb, params, masks, g = _case(clips, N)
    t = [torch.from_numpy(a) for a in (x, *gb, *params, *masks, g)]
    tx, tgb, tp, tm, tg = t[0], t[1:5], t[5:13], t[13:15], t[15]
    with torch.no_grad():
        y, grads = _model(tx, tgb, tp, H, eps, tm, tg)
    assert all(bool(torch.isfinite(a).all()) for a in (y, *grads))

    def jfn(x, g1, b1, g2, b2, m1, m2, *p):
        return fused_ada_block(x, g1, b1, g2, b2, p, H, eps, (m1, m2))

    jy, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (x, *gb, *masks,
                                                      *params)))
    jg = vjp(jnp.asarray(g))
    jgrads = [jg[0], *jg[1:5], *jg[7:15], jg[5], jg[6]]
    errs = [_rel(y, jy)] + [_rel(a, b) for a, b in zip(grads, jgrads)]
    assert max(errs) <= TOL, errs

    leaves = [a.clone().requires_grad_(True) for a in t[:15]]
    yp = fa.ada_block_plain(leaves[0], *leaves[1:5], tuple(leaves[5:13]), H,
                            eps, tuple(leaves[13:15]))
    pg = torch.autograd.grad(yp, leaves, tg)
    pgrads = [pg[0], *pg[1:5], *pg[5:13], pg[13], pg[14]]
    errs = [_rel(y, yp.detach())] + [_rel(a, b)
                                     for a, b in zip(grads, pgrads)]
    assert max(errs) <= TOL, errs
