"""The attention kernels and the GRU scan, in PyTorch and CUDA.

Port of every ``pmce_tpu/ops/fused_attention.py`` Pallas kernel that the
bf16 serving forward, the Stage-1 lifter's training step and the Stage-2
mesh training step run: ``fused_lifter_trunk`` (the whole Stage-1 trunk,
with JAX's recompute for its gradient), ``fused_gru_layer`` /
``fused_gru_layer_rev`` (one GRU direction over T) with their training pair
(the saving forward and the reverse-time backward of their custom VJP),
``fused_transformer_block`` with its backward (one lifter block in
training, with stochastic-depth branch masks and the shared post-norm), and
the decoder's attention blocks with their backwards: ``fused_mhsa``,
``fused_ada_block`` and ``fused_ca_block``; in f32 (JAX's compute dtype
f32) the block forward and backward (rows 6f / 7f, ``csrc/block_f32.cu``),
``fused_mhsa`` forward and backward (rows 4f / 5f, ``csrc/mhsa_f32.cu``)
and the AdaLN and CA blocks forward and backward (rows 8f / 9f,
``csrc/ada_f32.cu``; rows 10f / 11f, ``csrc/ca_f32.cu``). Each comes as

- a plain PyTorch version (``*_plain``) with the math of the JAX kernel;
- a wrapper that picks by the device of its input: a CPU tensor goes to
  the plain version, a CUDA tensor to the hand-written kernel in
  ``pmce_tpu_torch/csrc``. On the card the one route to a plain version
  is the JAX package's own static test, the block over 64 tokens
  (``pmce_tpu/ops/fused_attention.py:984-989`` sends it to its oracle); a
  shape that JAX's kernel takes but this kernel is not built for
  (``*_kernel_fits`` is false) raises ``NotImplementedError`` naming the
  widening queued in ROADMAP.md (section B; B3 for the f32 kernels'
  gates). Nothing is caught, nothing falls back.

The numerics follow the JAX oracles rather than the TPU kernels' bf16
workarounds, and are shared with ``ops/fused_coevo_chain.py``: f32 LayerNorm
and AdaLayerNorm statistics, exact erf GELU, a max-stabilised f32 softmax,
every product an f32 sum of its operands as given (bf16 operands are
upcast, :func:`mm`), and q scaled by 1/sqrt(dh) in f32 before its one bf16
rounding (``fused_attention.py:195-206`` of the JAX package).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from pmce_tpu_torch.ops import _cuda

TRUNK_LAUNCHES = _cuda.launch_counter("lifter_trunk")
TRUNK_LONG_LAUNCHES = _cuda.launch_counter("lifter_trunk_long")
GRU_LAUNCHES = _cuda.launch_counter("gru_layer")
GRU_REV_LAUNCHES = _cuda.launch_counter("gru_layer_rev")
GRU_SAVE_LAUNCHES = _cuda.launch_counter("gru_layer_save")
GRU_BWD_LAUNCHES = _cuda.launch_counter("gru_layer_bwd")
# Launches of the scan kernel (K2) itself: one runs both directions of a
# BiGRU layer, which gru_layer and gru_layer_rev count once each.
GRU_SCAN_LAUNCHES = _cuda.launch_counter("gru_scan")
# Launches of the persistent backward scan (row 13): one a direction, one
# per gru_layer_bwd call.
GRU_BWD_SCAN_LAUNCHES = _cuda.launch_counter("gru_bwd_scan")
BLOCK_FWD_LAUNCHES = _cuda.launch_counter("block_fwd")
BLOCK_BWD_LAUNCHES = _cuda.launch_counter("block_bwd")
# Row 6's f32 forward (with or without branch masks) and row 7's f32
# backward (csrc/block_f32.cu).
BLOCK_FWD_F32_LAUNCHES = _cuda.launch_counter("block_fwd_f32")
BLOCK_BWD_F32_LAUNCHES = _cuda.launch_counter("block_bwd_f32")


# ---------------------------------------------------------------------------
# Shared numerics of the plain versions
# ---------------------------------------------------------------------------


def mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` as an f32 sum of the operands as given.

    bf16 operands are upcast first, so the result is the kernels' f32
    accumulation of bf16 products (JAX's ``preferred_element_type=f32``),
    not a product rounded to bf16."""
    return a.float() @ w.float()


def ln_f32(x, scale, bias, eps: float) -> torch.Tensor:
    """LayerNorm with f32 statistics on explicit params."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * scale + bias


def adaln_f32(x, gamma, beta, eps: float) -> torch.Tensor:
    """Reference AdaLayerNorm: unbiased std, eps OUTSIDE the sqrt."""
    xf = x.float()
    n = xf.shape[-1]
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().sum(-1, keepdim=True) / (n - 1)
    return gamma * ((xf - mean) / (var.sqrt() + eps)) + beta


def attend(q, k, v) -> torch.Tensor:
    """softmax(q kᵀ) v per head in f32; q arrives pre-scaled."""
    s = q.float() @ k.float().transpose(-1, -2)
    return torch.softmax(s, dim=-1) @ v.float()


def split_scaled_qkv(qkv: torch.Tensor, dim: int, num_heads: int, dt):
    """f32 [.., 3C] → (q·1/sqrt(dh), k, v) each rounded once to ``dt``."""
    scale = 1.0 / math.sqrt(dim // num_heads)
    return ((qkv[..., :dim] * scale).to(dt), qkv[..., dim:2 * dim].to(dt),
            qkv[..., 2 * dim:].to(dt))


def _tensors(tree):
    """The tensors of nested tuples / lists, depth first (None skipped)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for item in tree for t in _tensors(item)]
    return []


def _on_card(x, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type in ("cpu", "cuda"):
        return x.device.type == "cuda"
    raise ValueError(f"{name}: unsupported device {x.device}")


def require_kernel(fits: bool, name: str, shape: str) -> None:
    """On the card, a shape the JAX package runs through its kernel but
    this port's kernel is not built for raises: the widening is queued in
    ROADMAP.md, section B."""
    if not fits:
        raise NotImplementedError(
            f"{name}: the CUDA kernel is not built for {shape} (the JAX "
            "kernel takes it); widening it is queued in ROADMAP.md, "
            "section B")


# ---------------------------------------------------------------------------
# Lifter trunk (replaces _lifter_trunk_kernel / fused_lifter_trunk)
# ---------------------------------------------------------------------------


def _grouped_attention(q, k, v, T: int, J: int, num_heads: int,
                       temporal: bool) -> torch.Tensor:
    """Attention within each frame (spatial) or each joint (temporal) of
    [B, T·J, C] tokens in (t, j) row order; returns f32 [B, T·J, C]."""
    B, R, C = q.shape
    dh = C // num_heads
    # [B, T, J, H, dh] -> [B, groups, H, members, dh]
    perm = (0, 2, 3, 1, 4) if temporal else (0, 1, 3, 2, 4)

    def split(a):
        return a.reshape(B, T, J, num_heads, dh).permute(*perm)

    o = attend(split(q), split(k), split(v))
    inv = (0, 3, 1, 2, 4) if temporal else (0, 1, 3, 2, 4)
    return o.permute(*inv).reshape(B, R, C)


def _block_f32(x, w, T, J, num_heads, eps, temporal, m1=None, m2=None):
    """One pre-norm block on [B, T·J, C] tokens; f32 result before any
    post-norm. ``m1`` / ``m2``: per-clip [B, 1, 1] branch scales or None."""
    (g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, w1, bb1, w2, bb2) = w
    dt = x.dtype
    C = x.shape[-1]
    xf = x.float()
    h1 = ln_f32(xf, g1, b1, eps).to(dt)
    q, k, v = split_scaled_qkv(mm(h1, wqkv.to(dt)) + bqkv, C, num_heads, dt)
    o = _grouped_attention(q, k, v, T, J, num_heads, temporal).to(dt)
    a = mm(o, wproj.to(dt)) + bproj
    x1 = xf + (a if m1 is None else a * m1)
    h2 = ln_f32(x1, g2, b2, eps).to(dt)
    hh = F.gelu(mm(h2, w1.to(dt)) + bb1).to(dt)
    mo = mm(hh, w2.to(dt)) + bb2
    return x1 + (mo if m2 is None else mo * m2)


def _trunk_block_plain(x, w, T, J, num_heads, eps, temporal):
    return _block_f32(x, w, T, J, num_heads, eps, temporal).to(x.dtype)


def lifter_trunk_plain(x, params, norm_s, norm_t, tpe, T: int, J: int,
                       depth: int, num_heads: int, eps: float = 1e-6):
    """Plain version of the trunk (math of ``lifter_trunk_reference``).

    x: [B, T·J, C] embedded tokens in (t, j) row order, compute dtype;
    params: 2·depth 12-tuples (spatial_0, temporal_0, spatial_1, ...), each
    (ln1_s, ln1_b, wqkv [C,3C], bqkv, wproj [C,C], bproj, ln2_s, ln2_b,
    w_fc1 [C,hid], b_fc1, w_fc2 [hid,C], b_fc2); norm_s / norm_t: the shared
    post-norm (scale, bias); tpe: [T, C] temporal pos-embed, added after the
    first spatial block. Returns [B, T·J, C] in x's dtype."""
    dt = x.dtype
    tpe_rows = tpe.float().repeat_interleave(J, dim=0)          # [R, C]
    for i in range(depth):
        x = _trunk_block_plain(x, params[2 * i], T, J, num_heads, eps, False)
        x = ln_f32(x, *norm_s, eps).to(dt)
        if i == 0:
            x = (x.float() + tpe_rows).to(dt)
        x = _trunk_block_plain(x, params[2 * i + 1], T, J, num_heads, eps,
                               True)
        x = ln_f32(x, *norm_t, eps).to(dt)
    return x


# Epilogue codes of the kernels' GEMM (csrc/transformer_ops.cuh).
_EPI_QKV, _EPI_RES, _EPI_GELU, _EPI_DGELU, _EPI_STORE = range(5)


def _gemm(lib, fn, A, W, M, N, K, epi, out, bias=None, res=None,
          rowscale=None, rps=1, qcols=0, qscale=1.0, save=None, aux=None,
          stream=None):
    """One launch of the GEMM with its fused epilogue (``gemm_entry``);
    the output's and the residual's dtypes pick their f32 or bf16 forms."""
    p, null = _cuda.ptr, _cuda.P(None)

    def opt(t):
        return p(t) if t is not None else null

    lib.call(fn, p(A), p(W), M, N, K, epi, int(out.dtype == torch.float32),
             opt(bias), opt(res),
             int(res is not None and res.dtype == torch.float32),
             opt(rowscale), rps, qcols, qscale, opt(save), opt(aux), p(out),
             stream)


def trunk_kernel_fits(C: int, num_heads: int, hid: int) -> bool:
    """The static shape test of the trunk kernel: C = 256 in heads of 32
    and hid a multiple of 128; any T and J."""
    return C == 256 and C == 32 * num_heads and hid % 128 == 0


# The block kernel's tile holds whole attention groups of up to this many
# tokens (csrc/lifter_trunk.cu, tb::TM); longer groups take the long route.
TRUNK_TILE_ROWS = 128


def trunk_route(T: int, J: int) -> str:
    """Which hand-written route the trunk takes on the card: "block" (one
    launch per transformer block, tiles of whole groups) when every
    spatial group (J tokens) and temporal group (T tokens) fits in a tile,
    else "long" (8 launches per block, any group size)."""
    return "block" if max(T, J) <= TRUNK_TILE_ROWS else "long"


def _trunk_weights(params, norm_s, norm_t, tpe, C, hid, T, dev):
    """The kernels' copies of the trunk's weights: per block (g1, b1, wqkv,
    bqkv, wproj, bproj, g2, b2, w1, bb1, w2, bb2) with products in bf16 and
    vectors in f32, the two post-norms and tpe."""
    bf16, f32 = torch.bfloat16, torch.float32

    def vec(a, n, name):
        return _cuda.to_kernel(a, dev, f32, (n,), name)

    def mat(a, rows, cols, name):
        return _cuda.to_kernel(a, dev, bf16, (rows, cols), name)

    blocks = []
    for w in params:
        (g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, w1, bb1, w2, bb2) = w
        blocks.append((vec(g1, C, "ln1 scale"), vec(b1, C, "ln1 bias"),
                       mat(wqkv, C, 3 * C, "wqkv"), vec(bqkv, 3 * C, "bqkv"),
                       mat(wproj, C, C, "wproj"), vec(bproj, C, "bproj"),
                       vec(g2, C, "ln2 scale"), vec(b2, C, "ln2 bias"),
                       mat(w1, C, hid, "w_fc1"), vec(bb1, hid, "b_fc1"),
                       mat(w2, hid, C, "w_fc2"), vec(bb2, C, "b_fc2")))
    post = tuple((vec(g, C, "post-norm scale"), vec(b, C, "post-norm bias"))
                 for g, b in (norm_s, norm_t))
    return blocks, post, _cuda.to_kernel(tpe, dev, f32, (T, C), "tpe")


def _trunk_checks(x, params, T, J, depth):
    B, R, C = x.shape
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(
            "the trunk kernel takes bf16 tokens; the f32 model runs the "
            "modular path")
    if R != T * J or len(params) != 2 * depth:
        raise ValueError(f"trunk: R={R} tokens for T={T} x J={J}, "
                         f"{len(params)} blocks for depth {depth}")
    _cuda.check_cuda(x, "x", torch.bfloat16, (B, R, C))


def _lifter_trunk_cuda(x, params, norm_s, norm_t, tpe, T, J, depth,
                       num_heads, eps=1e-6, stamps=None):
    """The block route: one ``pmce_trunk_block`` launch per transformer
    block. ``stamps`` (the profile's stage split): a list that receives,
    per block, the stamped instantiation's [tiles, 8] cycle counts; such a
    call is not counted as a launch of the path."""
    _trunk_checks(x, params, T, J, depth)
    B, R, C = x.shape
    hid = params[0][8].shape[1]
    dev = x.device
    blocks, post, tpe_c = _trunk_weights(params, norm_s, norm_t, tpe, C, hid,
                                         T, dev)
    stream = _cuda.stream_ptr(dev)
    p, null = _cuda.ptr, _cuda.P(None)
    qscale = 1.0 / math.sqrt(C // num_heads)
    tile = int(_cuda.TRUNK.query("pmce_trunk_tile_rows"))
    nstamp = int(_cuda.TRUNK.query("pmce_trunk_stamps"))
    outs = (torch.empty_like(x), torch.empty_like(x))
    cur = x
    for i, w in enumerate(blocks):
        temporal = i % 2 == 1
        n, groups = (T, B * J) if temporal else (J, B * T)
        st = None
        if stamps is not None:
            tiles = -(-groups // (tile // n))
            st = torch.zeros(tiles, nstamp, dtype=torch.int64, device=dev)
            stamps.append(st)
        nxt = outs[i % 2]
        (g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, w1, bb1, w2, bb2) = w
        _cuda.TRUNK.call(
            "pmce_trunk_block", p(cur), p(nxt), p(wqkv), p(wproj), p(w1),
            p(w2), p(g1), p(b1), p(bqkv), p(bproj), p(g2), p(b2), p(bb1),
            p(bb2), *map(p, post[int(temporal)]),
            p(tpe_c) if i == 0 else null, B, T, J, int(temporal), hid, eps,
            qscale, p(st) if st is not None else null, stream)
        cur = nxt
    if stamps is None:
        TRUNK_LAUNCHES.count += 1
    return cur


def _lifter_trunk_long(x, params, norm_s, norm_t, tpe, T, J, depth,
                       num_heads, eps=1e-6):
    """The long-group route (a group over :data:`TRUNK_TILE_ROWS` tokens):
    8 launches per block over all B·T·J rows (row LayerNorm, the WMMA GEMM
    with fused epilogues, grouped attention of any group size)."""
    _trunk_checks(x, params, T, J, depth)
    B, R, C = x.shape
    bf16, f32 = torch.bfloat16, torch.float32
    hid = params[0][8].shape[1]
    dev = x.device
    M = B * R
    stream = _cuda.stream_ptr(dev)
    lib = _cuda.TRUNK
    blocks, post, tpe_c = _trunk_weights(params, norm_s, norm_t, tpe, C, hid,
                                         T, dev)
    h = torch.empty(M, C, device=dev, dtype=bf16)
    qkv = torch.empty(M, 3 * C, device=dev, dtype=bf16)
    o = torch.empty(M, C, device=dev, dtype=bf16)
    x1 = torch.empty(M, C, device=dev, dtype=f32)
    hh = torch.empty(M, hid, device=dev, dtype=bf16)
    y = torch.empty(M, C, device=dev, dtype=bf16)
    outs = (torch.empty_like(x), torch.empty_like(x))
    p = _cuda.ptr
    null = _cuda.P(None)
    qscale = 1.0 / math.sqrt(C // num_heads)

    def ln(src, is_f32, dst, g, b, with_tpe):
        lib.call("pmce_trunk_ln", p(src), int(is_f32), p(dst), p(g), p(b),
                 p(tpe_c) if with_tpe else null, M, R, J, eps, stream)

    def gemm(a, w, bias, res, out, n, k, epi):
        _gemm(lib, "pmce_trunk_gemm", a, w, M, n, k, epi, out, bias=bias,
              res=res, qcols=C, qscale=qscale, stream=stream)

    cur = x
    for i, w in enumerate(blocks):
        (g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, w1, bb1, w2, bb2) = w
        temporal = i % 2 == 1
        ln(cur, False, h, g1, b1, False)
        gemm(h, wqkv, bqkv, None, qkv, 3 * C, C, _EPI_QKV)
        lib.call("pmce_trunk_attn", p(qkv), p(o), B, T, J, C, num_heads,
                 int(temporal), stream)
        gemm(o, wproj, bproj, cur, x1, C, C, _EPI_RES)
        ln(x1, True, h, g2, b2, False)
        gemm(h, w1, bb1, None, hh, hid, C, _EPI_GELU)
        gemm(hh, w2, bb2, x1, y, C, hid, _EPI_RES)
        nxt = outs[i % 2]
        ln(y, False, nxt, *post[int(temporal)], i == 0)
        cur = nxt
    TRUNK_LONG_LAUNCHES.count += 1
    return cur


def _trunk_cuda(x, params, norm_s, norm_t, tpe, T, J, depth, num_heads,
                eps):
    route = (_lifter_trunk_cuda if trunk_route(T, J) == "block"
             else _lifter_trunk_long)
    return route(x, params, norm_s, norm_t, tpe, T, J, depth, num_heads, eps)


TRUNK_STAGES = ("LN1", "QKV", "attention", "proj", "LN2", "fc1", "fc2",
                "post-norm + store")


def trunk_stage_split(x, params, norm_s, norm_t, tpe, T: int, J: int,
                      depth: int, num_heads: int, eps: float = 1e-6) -> dict:
    """One forward of the block route's stamped instantiation on the card:
    {stage: cycles summed over every tile of every block} (the stage names
    of :data:`TRUNK_STAGES`). Not counted as a launch of the path."""
    stamps: list = []
    with torch.no_grad():
        _lifter_trunk_cuda(x, params, norm_s, norm_t, tpe, T, J, depth,
                           num_heads, eps, stamps=stamps)
    torch.cuda.synchronize()
    total = sum(st.sum(0) for st in stamps).cpu().tolist()
    return dict(zip(TRUNK_STAGES, total))


def trunk_recompute(x, params, norm_s, norm_t, tpe, T: int, J: int,
                    depth: int, num_heads: int, eps: float = 1e-6):
    """The trunk as the JAX package recomputes it for its gradient
    (``_fused_trunk_bwd``: ``lifter_trunk_reference`` with the attention
    of every block through ``fused_mhsa``), differentiable. Args as
    :func:`lifter_trunk_plain`."""
    B, R, C = x.shape
    dt = x.dtype

    def block(x3, w):
        (g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, w1, bb1, w2, bb2) = w
        h = ln_f32(x3, g1, b1, eps).to(dt)
        x1 = x3.float() + fused_mhsa(h, wqkv, bqkv, wproj, bproj,
                                     num_heads).float()
        h2 = ln_f32(x1, g2, b2, eps).to(dt)
        hh = F.gelu(mm(h2, w1.to(dt)) + bb1).to(dt)
        return (x1 + mm(hh, w2.to(dt)) + bb2).to(dt)

    x = x.reshape(B, T, J, C)
    for i in range(depth):
        xs = block(x.reshape(B * T, J, C), params[2 * i])
        x = ln_f32(xs, *norm_s, eps).to(dt).reshape(B, T, J, C)
        if i == 0:
            x = (x.float() + tpe.float()[None, :, None, :]).to(dt)
        xt = block(x.transpose(1, 2).reshape(B * J, T, C), params[2 * i + 1])
        xt = ln_f32(xt, *norm_t, eps).to(dt)
        x = xt.reshape(B, J, T, C).transpose(1, 2)
    return x.reshape(B, R, C)


class _TrunkKernel(torch.autograd.Function):
    """The trunk kernel with JAX's gradient: the forward is
    ``csrc/lifter_trunk.cu``; the backward is autograd of
    :func:`trunk_recompute`, whose attention runs ``csrc/mhsa.cu`` forward
    and backward (``fused_attention.py:3165-3175`` of the JAX package)."""

    @staticmethod
    def forward(ctx, x, cfg, *flat):
        T, J, depth, num_heads, eps = cfg
        n = 24 * depth
        params = tuple(tuple(flat[12 * i:12 * i + 12]) for i in range(2 * depth))
        ctx.cfg = cfg
        ctx.save_for_backward(x, *flat)
        return _trunk_cuda(x, params, flat[n:n + 2], flat[n + 2:n + 4],
                           flat[n + 4], T, J, depth, num_heads, eps)

    @staticmethod
    def backward(ctx, g):
        T, J, depth, num_heads, eps = ctx.cfg
        n = 24 * depth
        leaves = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, (ctx.needs_input_grad[0],
                                          *ctx.needs_input_grad[2:]))]
        x, *flat = leaves
        params = tuple(tuple(flat[12 * i:12 * i + 12]) for i in range(2 * depth))
        with torch.enable_grad():
            out = trunk_recompute(x, params, flat[n:n + 2], flat[n + 2:n + 4],
                                  flat[n + 4], T, J, depth, num_heads, eps)
            wanted = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, g))
        grads = [next(got) if t.requires_grad else None for t in leaves]
        return (grads[0], None, *grads[1:])


def lifter_trunk(x, params, norm_s, norm_t, tpe, T: int, J: int,
                 depth: int, num_heads: int, eps: float = 1e-6):
    """The whole lifter trunk (see :func:`lifter_trunk_plain` for args).

    CPU tensors run the plain version; CUDA tensors ``csrc/lifter_trunk.cu``
    (bf16 only; widths :func:`trunk_kernel_fits` refuses raise, see
    :func:`require_kernel`): one launch per transformer block, or for groups
    over a tile the long route (:func:`trunk_route`). A call on the card that
    owes a gradient gets JAX's: :class:`_TrunkKernel` recomputes the trunk
    with its attention through :func:`fused_mhsa` (kernels forward and
    backward) and differentiates that."""
    if not _on_card(x, "lifter_trunk"):
        return lifter_trunk_plain(x, params, norm_s, norm_t, tpe, T, J,
                                  depth, num_heads, eps)
    C, hid = x.shape[-1], params[0][8].shape[1]
    require_kernel(trunk_kernel_fits(C, num_heads, hid),
                   "lifter_trunk", f"C={C}, {num_heads} heads, hid={hid}")
    flat = (*(t for w in params for t in w), *norm_s, *norm_t, tpe)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, *flat)):
        return _TrunkKernel.apply(x, (T, J, depth, num_heads, eps), *flat)
    return _trunk_cuda(x, params, norm_s, norm_t, tpe, T, J, depth,
                       num_heads, eps)


# ---------------------------------------------------------------------------
# Transformer block with its backward (replaces _block_kernel /
# fused_transformer_block and _block_bwd_kernel / _fused_block_bwd)
# ---------------------------------------------------------------------------


def transformer_block_plain(x, params, num_heads: int, eps: float = 1e-6,
                            post_eps: float = 1e-6, branch_masks=None):
    """Plain version of the block (math of ``block_reference``); its
    gradient is PyTorch's autograd of this function.

    x: [B, N, C] tokens of B clips, compute dtype; params: the 14-tuple
    (ln1_s, ln1_b, wqkv [C,3C], bqkv, wproj [C,C], bproj, ln2_s, ln2_b,
    w_fc1 [C,hid], b_fc1, w_fc2 [hid,C], b_fc2, post_s | None, post_b);
    branch_masks: None or (m1, m2), per-clip [B, 1, 1] scales of the
    attention and MLP branches (stochastic depth). Returns [B, N, C] in x's
    dtype."""
    B, N, _ = x.shape
    m1 = m2 = None
    if branch_masks is not None:
        m1, m2 = (m.float().reshape(B, 1, 1) for m in branch_masks)
    y = _block_f32(x, params[:12], 1, N, num_heads, eps, False, m1, m2)
    gp, bp = params[12:]
    if gp is not None:
        y = ln_f32(y, gp, bp, post_eps)
    return y.to(x.dtype)


# The JAX package's own gate (``_fused_block_impl``): longer clips run its
# oracle, so here the plain version; the kernels take up to this many.
BLOCK_MAX_TOKENS = 64
# The backward's tile program: tiles of whole clips up to this many rows
# (csrc/block.cu, bb::TM), and the fixed splits of the weight products'
# K = B·N rows (bb::block_wgrad_kernel adds them in order).
_BLOCK_TILE_ROWS = 128
_WGRAD_SPLITS = 4
# Stages of the tile program's stamped instantiation.
BLOCK_BWD_STAGES = ("post-norm", "fc2ᵀ", "fc1ᵀ", "LN2", "projᵀ",
                    "attention", "qkvᵀ", "LN1")


def _block_tiles(clips: int, N: int) -> int:
    """The tiles of both tile programs: whole clips, up to 128 rows."""
    return -(-clips // (_BLOCK_TILE_ROWS // N))


def block_kernel_fits(C: int, num_heads: int, hid: int) -> bool:
    """The static shape test of the block kernels: C = 256 in heads of 32
    and hid a multiple of 128, for N up to :data:`BLOCK_MAX_TOKENS`."""
    return C == 256 and C == 32 * num_heads and hid % 128 == 0


def _block_checks(x, params, num_heads):
    B, N, C = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(
            f"the block kernels take bf16 or f32 tokens, not {x.dtype}")
    hid = params[8].shape[1]
    _cuda.check_cuda(x, "x", x.dtype, (B, N, C))
    return B, N, C, hid


def _mask_rows(m, B, dev):
    return None if m is None else _cuda.to_kernel(
        m.reshape(B), dev, torch.float32, (B,), "branch mask")


class _BlockWeights:
    """A block's parameters as the kernels take them (f32 vectors, bf16
    [in, out] matrices; with ``f32``, the f32 kernel's, every parameter
    f32 as given: another dtype raises)."""

    def __init__(self, params, C, hid, dev, f32_route: bool = False):
        f32, bf16 = torch.float32, torch.bfloat16

        def vec(a, n, name):
            return _cuda.to_kernel(a, dev, f32, (n,), name)

        def mat(a, rows, cols, name):
            return _cuda.to_kernel(a, dev, f32 if f32_route else bf16,
                                   (rows, cols), name)

        if f32_route:
            _f32_params("transformer_block",
                        *(t for t in params if t is not None))

        (g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, w1, bb1, w2, bb2,
         gp, bp) = params
        self.g1, self.b1 = vec(g1, C, "ln1 scale"), vec(b1, C, "ln1 bias")
        self.wqkv, self.bqkv = mat(wqkv, C, 3 * C, "wqkv"), vec(
            bqkv, 3 * C, "bqkv")
        self.wproj, self.bproj = mat(wproj, C, C, "wproj"), vec(
            bproj, C, "bproj")
        self.g2, self.b2 = vec(g2, C, "ln2 scale"), vec(b2, C, "ln2 bias")
        self.w1, self.bb1 = mat(w1, C, hid, "w_fc1"), vec(bb1, hid, "b_fc1")
        self.w2, self.bb2 = mat(w2, hid, C, "w_fc2"), vec(bb2, C, "b_fc2")
        self.post = gp is not None
        if self.post:
            self.gp = vec(gp, C, "post-norm scale")
            self.bp = vec(bp, C, "post-norm bias")


def _block_fwd_cuda(x, params, m1, m2, num_heads, eps, post_eps,
                    for_grad: bool, keep_branches: bool, w=None,
                    stamps=None):
    """The forward in one launch of ``csrc/block.cu``'s tile program;
    returns (out, saved) where ``saved`` holds what the backward reads (None
    entries where not needed). With ``for_grad`` or masks the saving
    program runs (x1 goes to device memory), its epilogues writing the
    saved state with ``for_grad`` and the branches a, mo with
    ``keep_branches``; otherwise only the output is written. ``w``: the
    parameters as :class:`_BlockWeights` already made, or None. ``stamps``
    (int64 [tiles, 8] on the card): the stamped instantiation, not
    counted."""
    B, N, C, hid = _block_checks(x, params, num_heads)
    bf16, f32 = torch.bfloat16, torch.float32
    dev = x.device
    if x.dtype == f32:
        raise ValueError("_block_fwd_cuda: the bf16 tile program; f32 "
                         "tokens take _block_fwd_f32_cuda")
    M = B * N
    w = w or _BlockWeights(params, C, hid, dev)
    rows1, rows2 = _mask_rows(m1, B, dev), _mask_rows(m2, B, dev)

    def buf(cols, dt, wanted=True):
        return torch.empty(M, cols, device=dev, dtype=dt) if wanted else None

    saving = for_grad or rows1 is not None or rows2 is not None
    h1, qkv, o, h2 = (buf(C, bf16, for_grad), buf(3 * C, bf16, for_grad),
                      buf(C, bf16, for_grad), buf(C, bf16, for_grad))
    hh, ge = buf(hid, f32, for_grad), buf(hid, bf16, for_grad)
    x1 = buf(C, f32, saving)
    y = buf(C, f32, for_grad and w.post)
    a = buf(C, f32, keep_branches)
    mo = buf(C, f32, keep_branches)
    out = torch.empty_like(x)
    _cuda.BLOCK.call("pmce_block_fwd_tile", _cuda.ptr_table(
        x, out, w.wqkv, w.wproj, w.w1, w.w2, w.g1, w.b1, w.bqkv, w.bproj,
        w.g2, w.b2, w.bb1, w.bb2, w.gp if w.post else None,
        w.bp if w.post else None, rows1, rows2, h1, qkv, o, x1, h2, hh, ge,
        y, a, mo, stamps), B, N, hid, eps, post_eps,
        1.0 / math.sqrt(C // num_heads), _cuda.stream_ptr(dev))
    if stamps is None:
        BLOCK_FWD_LAUNCHES.count += 1
    saved = (h1, qkv, o, x1, h2, hh, ge, y, a, mo)
    return out, saved


def _block_fwd_f32_cuda(x, params, m1, m2, num_heads, eps, post_eps,
                        w=None):
    """The f32 forward in one launch of ``csrc/block_f32.cu``'s program
    (row 6f) on :func:`f32_block_plan`'s persistent CTAs, with the
    per-clip branch masks m1 / m2 or without (None): writes only the
    output, nothing for the gradient (row 7f recomputes it from x). ``w``:
    the parameters as :class:`_BlockWeights` already made, or None."""
    B, N, C, hid = _block_checks(x, params, num_heads)
    dev = x.device
    w = w or _BlockWeights(params, C, hid, dev, True)
    out = torch.empty_like(x)
    plan = f32_block_plan(B, N, _block_f32_resident(dev))
    _cuda.BLOCK_F32.call("pmce_block_fwd_f32", _cuda.ptr_table(
        x, out, w.wqkv, w.wproj, w.w1, w.w2, w.g1, w.b1, w.bqkv, w.bproj,
        w.g2, w.b2, w.bb1, w.bb2, w.gp if w.post else None,
        w.bp if w.post else None, _mask_rows(m1, B, dev),
        _mask_rows(m2, B, dev)), B, N, hid, eps, post_eps,
        1.0 / math.sqrt(C // num_heads), plan.ctas, _cuda.stream_ptr(dev))
    BLOCK_FWD_F32_LAUNCHES.count += 1
    return out


def block_fwd_stage_split(x, params, num_heads: int, branch_masks=None,
                          eps: float = 1e-6, post_eps: float = 1e-6) -> dict:
    """One stamped launch of the forward's tile program on the card (not
    counted), saving as for a gradient: {stage: cycles summed over the
    tiles} for the stages of :data:`TRUNK_STAGES` (the program is the
    trunk's), and ``"tiles"``."""
    m1, m2 = branch_masks if branch_masks is not None else (None, None)
    B, N, _ = x.shape
    tiles = _block_tiles(B, N)
    stamps = torch.zeros(tiles, len(TRUNK_STAGES), dtype=torch.int64,
                         device=x.device)
    with torch.no_grad():
        _block_fwd_cuda(x, params, m1, m2, num_heads, eps, post_eps, True,
                        False, stamps=stamps)
    total = stamps.sum(0).cpu().tolist()
    return {**dict(zip(TRUNK_STAGES, total)), "tiles": tiles}


def _block_vec_layout(C: int, hid: int) -> tuple[dict, int]:
    """Offsets of the vector gradients in the tile program's per-tile
    partials (``bb::vec_len``): g1, b1, bqkv, bproj, g2, b2, bb1, bb2, gp,
    bp; and their total length."""
    off, n = {}, 0
    for name, size in (("g1", C), ("b1", C), ("bqkv", 3 * C), ("bproj", C),
                       ("g2", C), ("b2", C), ("bb1", hid), ("bb2", C),
                       ("gp", C), ("bp", C)):
        off[name], n = n, n + size
    return off, n


def _block_bwd_cuda(gout, x, params, m1, m2, saved, num_heads, eps,
                    post_eps, need_masks: bool, stamps=None, w=None):
    """The backward in two launches of ``csrc/block.cu``: the tile program
    (the activation-gradient chain over tiles of whole clips: dx, the
    weight products' bf16 operands, per-tile partials of the vector
    gradients, the per-clip mask gradients when ``need_masks``), then the
    four weight gradients and the vector gradients' fixed-order sums in one
    launch. The weights are read in their [in, out] layout: no transposed
    copies. Returns dx, the 14 parameter gradients (f32) and the mask
    gradients. ``stamps`` (int64 [tiles, 8] on the card): run only the
    stamped tile program (not counted) and return None. ``w``: the
    forward's :class:`_BlockWeights` (their casts are not made again), or
    None."""
    B, N, C, hid = _block_checks(x, params, num_heads)
    bf16, f32 = torch.bfloat16, torch.float32
    dev = x.device
    M = B * N
    stream = _cuda.stream_ptr(dev)
    lib = _cuda.BLOCK
    w = w or _BlockWeights(params, C, hid, dev)
    rows1, rows2 = _mask_rows(m1, B, dev), _mask_rows(m2, B, dev)
    h1, qkv, o, x1, h2, hh, ge, y, a, mo = saved
    gout = gout.to(bf16).contiguous()
    _cuda.check_cuda(gout, "grad of the block output", bf16, (B, N, C))
    voff, L = _block_vec_layout(C, hid)
    tiles = _block_tiles(B, N)

    def buf(cols, dt):
        return torch.empty(M, cols, device=dev, dtype=dt)

    part = torch.empty(tiles, L, device=dev, dtype=f32)
    gbuf, m2g, dhh, da, dqkv = (buf(C, f32), buf(C, bf16), buf(hid, bf16),
                                buf(C, bf16), buf(3 * C, bf16))
    dx = torch.empty_like(x)
    dm1, dm2 = ((torch.empty(B, device=dev, dtype=f32) for _ in range(2))
                if need_masks else (None, None))
    lib.call("pmce_block_bwd_tile", _cuda.ptr_table(
        gout, x, y if w.post else None, x1, hh, qkv,
        a if need_masks else None, mo if need_masks else None, w.wqkv,
        w.wproj, w.w1, w.w2, w.g1, w.g2, w.gp if w.post else None, rows1,
        rows2, gbuf, m2g, dhh, da, dqkv, dx, part, dm1, dm2, stamps),
        B, N, hid, eps, post_eps, 1.0 / math.sqrt(C // num_heads), stream)
    if stamps is not None:
        return None
    mat_shapes = (("wqkv", C, 3 * C), ("wproj", C, C), ("w1", C, hid),
                  ("w2", hid, C))
    moff, Lm = {}, 0
    for name, r, c in mat_shapes:
        moff[name], Lm = Lm, Lm + r * c
    mtiles = sum(r // 128 * (c // 128) for _, r, c in mat_shapes)
    partial = torch.empty(mtiles * _WGRAD_SPLITS, 128 * 128, device=dev,
                          dtype=f32)
    counters = torch.zeros(mtiles, device=dev, dtype=torch.int32)
    mat = torch.empty(Lm, device=dev, dtype=f32)
    vec = torch.empty(L, device=dev, dtype=f32)
    lib.call("pmce_block_wgrad", _cuda.ptr_table(
        h1, o, h2, ge, dqkv, da, dhh, m2g, partial, counters, mat, part,
        vec), M, hid, _WGRAD_SPLITS, tiles, stream)
    BLOCK_BWD_LAUNCHES.count += 1

    def v(name, n):
        return vec[voff[name]:voff[name] + n]

    def m(name, r, c):
        return mat[moff[name]:moff[name] + r * c].view(r, c)

    grads = (v("g1", C), v("b1", C), m("wqkv", C, 3 * C), v("bqkv", 3 * C),
             m("wproj", C, C), v("bproj", C), v("g2", C), v("b2", C),
             m("w1", C, hid), v("bb1", hid), m("w2", hid, C), v("bb2", C),
             v("gp", C) if w.post else None, v("bp", C) if w.post else None)
    return dx, grads, (dm1, dm2)


def block_bwd_stage_split(x, params, num_heads: int, branch_masks=None,
                          eps: float = 1e-6, post_eps: float = 1e-6) -> dict:
    """One stamped launch of the backward's tile program on the card (not
    counted), after the forward, with a gradient of ones: {stage: cycles
    summed over the tiles} for the stages of :data:`BLOCK_BWD_STAGES`, and
    ``"tiles"``."""
    m1, m2 = branch_masks if branch_masks is not None else (None, None)
    with torch.no_grad():
        _, saved = _block_fwd_cuda(x, params, m1, m2, num_heads, eps,
                                   post_eps, True, False)
        B, N, _ = x.shape
        tiles = _block_tiles(B, N)
        stamps = torch.zeros(tiles, len(BLOCK_BWD_STAGES), dtype=torch.int64,
                             device=x.device)
        _block_bwd_cuda(torch.ones_like(x), x, params, m1, m2, saved,
                        num_heads, eps, post_eps, False, stamps)
    total = stamps.sum(0).cpu().tolist()
    return {**dict(zip(BLOCK_BWD_STAGES, total)), "tiles": tiles}


# Rows 6f / 7f's tiles (csrc/block_f32.cu, bf32::TR: whole clips up to 64
# rows).
_F32_TILE_ROWS = 64
# The f32 weight-gradient launch (csrc/f32_ops.cuh, rows 5f, 7f, 9f, 11f):
# a CTA a (dW tile, row range), one an SM, _F32_WGRAD_WAVES waves of them
# where the rows allow; a range at least _F32_WGRAD_ROWS rows, at most
# _F32_WGRAD_SPLITS ranges (the sum of a dW element's partials is a chain
# of that many loads).
_F32_WGRAD_ROWS = 64
_F32_WGRAD_SPLITS = 32
_F32_WGRAD_WAVES = 2


def _wgrad_tile(K: int, N: int) -> tuple[int, int]:
    """(rows, columns) of a CTA's tile of a [K, N] dW (``f32_ops.cuh``'s
    ``tile_shape``: 8 warps of 32 x 64 outputs)."""
    return (128 if K % 128 == 0 else 64, 128 if N % 128 == 0 else 64)


class F32WgradPlan(NamedTuple):
    """One f32 weight-gradient launch: ``tiles`` dW tiles over its jobs,
    each tile's M rows cut into ``splits`` ranges (``ranges``, summed in
    this order), ``ctas`` = tiles x splits CTAs, ``waves`` of them on the
    card at one an SM (None without one)."""
    tiles: int
    splits: int
    ranges: tuple
    ctas: int
    waves: int | None


@functools.lru_cache(maxsize=64)
def f32_wgrad_plan(M: int, jobs: tuple, sms: int | None) -> F32WgradPlan:
    """The row ranges of the f32 weight-gradient launch over M rows and the
    [K, N] dW ``jobs`` on a card of ``sms`` SMs: as many ranges as fill
    the card twice at one CTA an SM (at least one; at most 32, and one a
    64 rows); without a card (a build for the host) two. The wrappers
    size the range partials' workspace [splits, K N / 4096, 4096] by it."""
    if M < 1 or not jobs or any(k % 64 or n % 64 for k, n in jobs):
        raise ValueError(f"f32_wgrad_plan: {M} rows, jobs {jobs}")
    tiles = sum(k // tk * (n // tn) for k, n in jobs
                for tk, tn in (_wgrad_tile(k, n),))
    cap = max(1, min(_F32_WGRAD_SPLITS, M // _F32_WGRAD_ROWS))
    if sms is None:
        splits, waves = min(cap, 2), None
    else:
        splits = max(1, min(cap, sms * _F32_WGRAD_WAVES // tiles))
        waves = -(-tiles * splits // sms)
    ranges = tuple((M * s // splits, M * (s + 1) // splits)
                   for s in range(splits))
    return F32WgradPlan(tiles, splits, ranges, tiles * splits, waves)


def f32_wgrad_splits(M: int, jobs, device) -> int:
    """The row ranges of one f32 weight-gradient launch on ``device``'s
    card (:func:`f32_wgrad_plan`)."""
    return f32_wgrad_plan(M, tuple(jobs), _block_f32_resident(device)).splits


class BlockF32Plan(NamedTuple):
    """Rows 6f / 7f's persistent grid: ``ctas`` CTAs, CTA i owning the
    tiles ``tiles[i]`` ((first clip, clips) each: whole clips, at most 64
    rows), ``rounds`` the most tiles a CTA takes."""
    ctas: int
    tiles: tuple
    rounds: int


@functools.lru_cache(maxsize=64)
def f32_block_plan(clips: int, N: int, resident: int | None) -> BlockF32Plan:
    """Spread ``clips`` clips of N tokens over whole waves, as
    ``csrc/block_f32.cu``'s ``Tiles`` does: min(tiles of whole clips,
    ``resident`` co-resident CTAs) CTAs (``resident`` None: a CTA a tile),
    CTA i taking the clips [floor(clips i / G), floor(clips (i + 1) / G))
    in tiles of 64 // N clips, the last of them shorter. The CTAs' shares
    differ by one clip at most."""
    if clips < 1 or not 1 <= N <= _F32_TILE_ROWS:
        raise ValueError(f"f32_block_plan: {clips} clips of {N} tokens")
    per = _F32_TILE_ROWS // N
    tiles = -(-clips // per)
    ctas = tiles if resident is None else max(1, min(tiles, resident))
    owned = []
    for i in range(ctas):
        begin, end = clips * i // ctas, clips * (i + 1) // ctas
        owned.append(tuple((c, min(per, end - c))
                           for c in range(begin, end, per)))
    return BlockF32Plan(ctas, tuple(owned), max(len(t) for t in owned))


def _block_f32_resident(device) -> int | None:
    """The CTAs of rows 6f / 7f the card holds at once: one an SM (each
    takes 226-227 KB of shared memory). A CPU tensor reaches the launch
    only through a build of the source for the host, whose CTAs run one
    after another: None, a CTA a tile."""
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).multi_processor_count


# Rows 8f-11f's programs (csrc/dec_tc32.cuh): a long side in tiles of 128
# rows (8 warps of 16), the streamed side in chunks of 64 rows, the
# backward's finishing program 16 rows a warp, one warp a CTA on a side of
# up to 64 rows, else 8.
_DEC_TILE_ROWS, _DEC_CHUNK_ROWS, _DEC_WARP_ROWS = 128, 64, 16


class DecF32Program(NamedTuple):
    """One program of a decoder block's f32 forward or backward. ``items``:
    its work in the order the CTAs share it, (clip, tile) or, on a split
    short side, (clip, split); ``rows``: a tile's rows [r0, r1) of
    ``side``; ``ranges``: a split's 64-row chunks [c0, c1) of the other
    side (empty unsplit), merged in this order; ``ctas`` CTAs, CTA i taking
    ``owned[i]`` (a contiguous share); ``waves``: the most items a CTA
    takes."""
    name: str
    side: str
    items: tuple
    rows: tuple
    ranges: tuple
    ctas: int
    owned: tuple
    waves: int


class DecF32Plan(NamedTuple):
    """Rows 9f / 11f's grids: ``ctas`` (the entry points' argument: the
    most CTAs a program launches), the query and key programs' splits (1:
    tiles of 128 rows) and the programs in launch order."""
    ctas: int
    splits_q: int
    splits_k: int
    programs: tuple


class DecF32FwdPlan(NamedTuple):
    """Rows 8f / 10f's grids: ``ctas`` (the entry points' argument), the
    query side's splits in the attention (1: tiles of 128 rows) and the
    programs in launch order: rows (AdaLN and the qkv, or k and v,
    products; the backward's recompute launches the same program), the
    attention, the tail (a CTA a tile of the query side: a split short
    side's partials merged in order of s)."""
    ctas: int
    splits_q: int
    programs: tuple


def _dec_check(kind, clips, Nq, Nk, what):
    if kind not in ("ada", "ca") or clips < 1 or Nq < 1 or Nk < 1 or (
            kind == "ada" and Nq != Nk):
        raise ValueError(f"{what}: {kind} {clips} x {Nq} / {Nk}")


def _dec_chunks(n):
    return -(-n // _DEC_CHUNK_ROWS)


def _dec_tiles(n, rows=_DEC_TILE_ROWS):
    return tuple((r, min(n, r + rows)) for r in range(0, n, rows))


def _dec_splits(kind, clips, short, long, resident):
    """A side shorter than the other (a CA block's, one tile) split over
    the other's chunks: min(resident // clips, chunks) CTAs a clip (all of
    them without a card)."""
    if kind == "ada" or short >= long or short > _DEC_TILE_ROWS:
        return 1
    if resident is None:
        return _dec_chunks(long)
    return max(1, min(resident // clips, _dec_chunks(long)))


def _dec_side(name, side, clips, n, s, other):
    """(name, side, items, rows, ranges) of a program over ``side``'s n
    rows: s > 1 splits over ``other``'s chunks, else 128-row tiles."""
    if s > 1:
        ranges = tuple((_dec_chunks(other) * i // s,
                        _dec_chunks(other) * (i + 1) // s) for i in range(s))
        return (name, side, tuple((c, i) for c in range(clips)
                                  for i in range(s)), ((0, n),), ranges)
    rows = _dec_tiles(n)
    return (name, side, tuple((c, i) for c in range(clips)
                              for i in range(len(rows))), rows, ())


def _dec_grids(progs, resident):
    """(ctas, the programs): every program a persistent grid of min(items,
    ctas) CTAs, ctas the card's ``resident`` CTAs (None: the most items)."""
    ctas = resident if resident is not None else max(len(p[2])
                                                      for p in progs)
    programs = []
    for name, side, items, rows, ranges in progs:
        grid = min(len(items), ctas)
        owned = tuple(items[len(items) * i // grid:
                            len(items) * (i + 1) // grid]
                      for i in range(grid))
        programs.append(DecF32Program(name, side, items, rows, ranges, grid,
                                      owned, max(len(o) for o in owned)))
    return ctas, tuple(programs)


@functools.lru_cache(maxsize=64)
def f32_dec_plan(kind: str, clips: int, Nq: int, Nk: int,
                 resident: int | None) -> DecF32Plan:
    """The f32 decoder blocks' backward programs over the card's
    ``resident`` co-resident CTAs (one an SM; None: a CPU build, a CTA an
    item), as ``csrc/ada_f32.cu`` (``kind`` "ada", Nq = Nk = N) and
    ``csrc/ca_f32.cu``'s ``plan`` (``kind`` "ca") launch them after the
    rows program (:func:`f32_dec_fwd_plan`'s first). A side shorter than
    the other (a CA block's, one tile) is split over the other's chunks:
    min(resident // clips, chunks) CTAs a clip (all of them without a
    card); every program is a persistent grid of min(items, ctas) CTAs."""
    _dec_check(kind, clips, Nq, Nk, "f32_dec_plan")
    sq = _dec_splits(kind, clips, Nq, Nk, resident)
    sk = _dec_splits(kind, clips, Nk, Nq, resident)
    progs = []
    if sq > 1:
        progs.append(_dec_side("query attention", "queries", clips, Nq, sq,
                               Nk))
        progs.append(_dec_side("query tail", "queries", clips, Nq, sq, Nk))
    else:
        progs.append(_dec_side("queries", "queries", clips, Nq, 1, Nk))
    progs.append(_dec_side("keys", "keys", clips, Nk, sk, Nq))
    for side, n in (("queries", Nq),) + ((("keys", Nk),) if kind == "ca"
                                         else ()):
        rows = _dec_tiles(n, _DEC_WARP_ROWS * (1 if n <= 64 else 8))
        progs.append((f"finish {side}", side, tuple(
            (c, i) for c in range(clips) for i in range(len(rows))), rows,
            ()))
    ctas, programs = _dec_grids(progs, resident)
    return DecF32Plan(ctas, sq, sk, programs)


@functools.lru_cache(maxsize=64)
def f32_dec_fwd_plan(kind: str, clips: int, Nq: int, Nk: int,
                     resident: int | None) -> DecF32FwdPlan:
    """The f32 decoder blocks' forward programs (rows 8f / 10f) over the
    card's ``resident`` co-resident CTAs, as ``pmce_ada_fwd_f32`` /
    ``pmce_ca_fwd_f32`` launch them: the rows program over the keys' (an
    AdaLN block's tokens') 128-row tiles; the attention over the query
    side's tiles or, on a short side, split over the long side's chunks as
    the backward's (:func:`f32_dec_plan`); the tail over the query side's
    tiles."""
    _dec_check(kind, clips, Nq, Nk, "f32_dec_fwd_plan")
    sq = _dec_splits(kind, clips, Nq, Nk, resident)
    progs = [_dec_side("rows" if kind == "ada" else "key rows",
                       "queries" if kind == "ada" else "keys", clips, Nk, 1,
                       Nq),
             _dec_side("query attention", "queries", clips, Nq, sq, Nk),
             _dec_side("query tail", "queries", clips, Nq, 1, Nk)]
    ctas, programs = _dec_grids(progs, resident)
    return DecF32FwdPlan(ctas, sq, programs)


def f32_dec_fwd_workspace(kind: str, clips: int, Nq: int, Nk: int,
                          heads: int, splits_q: int) -> int:
    """Floats of the forward's workspace (the entry points' last pointer):
    an AdaLN block's q, k, v and o [clips * N, 256]; a CA block's k and v
    [2, clips * Nk, 64], o [S, clips * Nq, 64] and the split attention's
    max and sum [2, S, clips * Nq, heads] (S = ``splits_q``)."""
    if kind == "ada":
        return clips * Nq * 4 * 64
    return 2 * clips * Nk * 64 + splits_q * clips * Nq * (64 + 2 * heads)


# Rows 3f / 14f (csrc/coevo_f32.cu): a cluster of S CTAs a clip, the
# vertex rows in tiles of 16 split into S contiguous ranges of at most 8
# tiles (a tile a warp of the CTA's 8), S the fewest of 1, 2, 4, 8 that
# does (the portable cluster sizes); the joints in at most two tiles.
_COEVO_TILE, _COEVO_RANK_TILES, _COEVO_SPLITS = 16, 8, (1, 2, 4, 8)
_COEVO_MAX_V = _COEVO_TILE * _COEVO_RANK_TILES * _COEVO_SPLITS[-1]
_COEVO_MAX_J = 2 * _COEVO_TILE
# The clusters of S CTAs a card holds at once, where read on one
# (``pmce_coevo_f32_clusters``, cudaOccupancyMaxActiveClusters, through
# ``tools/profile_f32.py --chain``): {(SMs, S): clusters}. NVIDIA H100 80GB
# HBM3 (132 SMs): its GPCs leave 30 clusters of 4, not 33.
_COEVO_F32_CLUSTERS = {(132, 1): 132, (132, 2): 66, (132, 4): 30,
                       (132, 8): 15}


class CoevoF32Plan(NamedTuple):
    """Rows 3f / 14f's launch: ``splits`` CTAs a clip (a cluster; the
    entry points' S), each rank's vertex rows [r0, r1) in rank order,
    ``ctas`` = B S, the ``clusters`` the card holds at once (read on the
    card where known, else its SMs // S, one CTA an SM; None without a
    card) and the ``waves`` of clusters."""
    splits: int
    rows: tuple
    ctas: int
    clusters: int | None
    waves: int | None


def coevo_f32_splits(V: int) -> int:
    """S of :func:`coevo_f32_plan` at V vertices; a V over the plan's
    limit raises ``NotImplementedError`` naming it."""
    tiles = -(-V // _COEVO_TILE)
    for s in _COEVO_SPLITS:
        if -(-tiles // s) <= _COEVO_RANK_TILES:
            return s
    raise NotImplementedError(
        f"the f32 CoevoBlock kernel's plan takes V <= {_COEVO_MAX_V} "
        f"vertices (clusters of up to {_COEVO_SPLITS[-1]} CTAs of "
        f"{_COEVO_TILE * _COEVO_RANK_TILES} rows), not V={V} (the JAX "
        "kernel takes it); widening it is queued in ROADMAP.md B3")


@functools.lru_cache(maxsize=64)
def coevo_f32_plan(B: int, J: int, V: int, sms: int | None) -> CoevoF32Plan:
    """The cluster launch of ``csrc/coevo_f32.cu`` (the f32 chain and
    whole block) for B clips of J joints and V vertices on a card of
    ``sms`` SMs (None: no card). J over two tiles (32) or V over
    :func:`coevo_f32_splits`' limit raise ``NotImplementedError``."""
    if B < 1 or J < 1 or V < 1:
        raise ValueError(f"coevo_f32_plan: {B} x {J} / {V}")
    if J > _COEVO_MAX_J:
        raise NotImplementedError(
            f"the f32 CoevoBlock kernel's plan takes J <= {_COEVO_MAX_J} "
            f"joints (two warp tiles), not J={J} (the JAX kernel takes "
            "it); widening it is queued in ROADMAP.md B3")
    s = coevo_f32_splits(V)
    tiles = -(-V // _COEVO_TILE)
    rows = tuple((_COEVO_TILE * (tiles * r // s),
                  min(V, _COEVO_TILE * (tiles * (r + 1) // s)))
                 for r in range(s))
    if sms is None:
        clusters = waves = None
    else:
        clusters = _COEVO_F32_CLUSTERS.get((sms, s), sms // s)
        waves = -(-B // clusters)
    return CoevoF32Plan(s, rows, B * s, clusters, waves)


def _dec_f32_resident(device) -> int | None:
    """The CTAs of rows 9f / 11f's programs the card holds at once: one an
    SM (up to 255 registers a thread at 256 threads), as
    :func:`_block_f32_resident`."""
    return _block_f32_resident(device)


def _block_bwd_f32_cuda(gout, x, params, m1, m2, num_heads, eps, post_eps,
                        need_masks: bool, w=None):
    """Row 7f: the f32 backward of ``csrc/block_f32.cu`` in one call
    (``pmce_block_bwd_f32``: the weights' transposes, the tile program on
    :func:`f32_block_plan`'s persistent CTAs, which recomputes the forward
    from x and runs the gradient chain, the weight gradients with the
    vector gradients' fixed-order sums over the CTAs). The workspace
    (the recomputed activations and the weight products' operands, ~17 KB
    a row at C 256, hid 512) lives for the call. Returns dx, the 14
    parameter gradients (f32) and the per-clip mask gradients (None, None
    unless ``need_masks``)."""
    B, N, C, hid = _block_checks(x, params, num_heads)
    f32 = torch.float32
    dev = x.device
    M = B * N
    w = w or _BlockWeights(params, C, hid, dev, True)
    gout = gout.to(f32).contiguous()
    _cuda.check_cuda(gout, "grad of the block output", f32, (B, N, C))
    voff, L = _block_vec_layout(C, hid)
    ctas = f32_block_plan(B, N, _block_f32_resident(dev)).ctas
    mats = ((C, 3 * C), (C, C), (C, hid), (hid, C))
    splits = f32_wgrad_splits(M, mats, dev)

    def buf(*shape):
        return torch.empty(*shape, device=dev, dtype=f32)

    wt = tuple(buf(c, r) for r, c in mats)
    acts = (buf(M, C), buf(M, 3 * C), buf(M, C), buf(M, C), buf(M, hid),
            buf(M, hid))
    branches = (buf(M, C), buf(M, C)) if need_masks else (None, None)
    dys = (buf(M, 3 * C), buf(M, C), buf(M, hid), buf(M, C))
    dx = torch.empty_like(x)
    part = buf(ctas, L)
    dm1, dm2 = (buf(B), buf(B)) if need_masks else (None, None)
    wpart = buf(splits, sum(r * c for r, c in mats) // 4096, 4096)
    dw = tuple(buf(r, c) for r, c in mats)
    vec = buf(L)
    _cuda.BLOCK_F32.call("pmce_block_bwd_f32", _cuda.ptr_table(
        x, gout, w.wqkv, w.wproj, w.w1, w.w2, w.g1, w.b1, w.bqkv, w.bproj,
        w.g2, w.b2, w.bb1, w.bb2, w.gp if w.post else None,
        w.bp if w.post else None, _mask_rows(m1, B, dev),
        _mask_rows(m2, B, dev), *wt, *acts, *branches, *dys, dx, part, dm1,
        dm2, wpart, *dw, vec), B, N, hid, eps, post_eps,
        1.0 / math.sqrt(C // num_heads), splits, ctas, _cuda.stream_ptr(dev))
    BLOCK_BWD_F32_LAUNCHES.count += 1

    def v(name, n):
        return vec[voff[name]:voff[name] + n]

    grads = (v("g1", C), v("b1", C), dw[0], v("bqkv", 3 * C), dw[1],
             v("bproj", C), v("g2", C), v("b2", C), dw[2], v("bb1", hid),
             dw[3], v("bb2", C), v("gp", C) if w.post else None,
             v("bp", C) if w.post else None)
    return dx, grads, (dm1, dm2)


def _needs_grad(*tensors) -> bool:
    """Whether autograd will ask for a gradient of any of ``tensors`` (None
    entries skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _owed(ctx, grad_enabled: bool, *inputs: int) -> bool:
    """Whether autograd will ask a kernel Function for the gradient of its
    inputs ``inputs`` (of any input where none is named). Autograd runs
    forward with grad off: the caller's grad mode comes in as
    ``grad_enabled``."""
    need = ctx.needs_input_grad
    return grad_enabled and any(need[i] for i in inputs or range(len(need)))


class _BlockKernel(torch.autograd.Function):
    """The block on the card: forward and backward are the launches of
    ``csrc/block.cu`` (the backward: its tile program and its weight-
    gradient launch, :func:`_block_bwd_cuda`)."""

    @staticmethod
    def forward(ctx, x, m1, m2, num_heads, eps, post_eps, grad_enabled,
                *params):
        for_grad = _owed(ctx, grad_enabled)
        keep = _owed(ctx, grad_enabled, 1, 2)
        # The kernels' casts of the parameters, kept for the backward.
        w = _BlockWeights(params, x.shape[-1], params[8].shape[1], x.device)
        out, saved = _block_fwd_cuda(x, params, m1, m2, num_heads, eps,
                                     post_eps, for_grad, keep, w)
        ctx.weights = w if for_grad else None
        ctx.cfg = (num_heads, eps, post_eps, len(params))
        ctx.save_for_backward(x, m1, m2, *params, *saved)
        return out

    @staticmethod
    def backward(ctx, gout):
        num_heads, eps, post_eps, n_params = ctx.cfg
        x, m1, m2, *rest = ctx.saved_tensors
        params, saved = rest[:n_params], rest[n_params:]
        need_masks = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dx, grads, dms = _block_bwd_cuda(gout, x, params, m1, m2, saved,
                                         num_heads, eps, post_eps,
                                         need_masks, w=ctx.weights)
        dm1 = dms[0].reshape(m1.shape) if need_masks else None
        dm2 = dms[1].reshape(m2.shape) if need_masks else None
        grads = tuple(None if g is None else g.reshape(t.shape)
                      for g, t in zip(grads, params))
        return (dx, dm1, dm2, None, None, None, None, *grads)


class _BlockF32Kernel(torch.autograd.Function):
    """The f32 block on the card: forward row 6f's program (with the branch
    masks), backward row 7f (:func:`_block_bwd_f32_cuda`), both in
    ``csrc/block_f32.cu``. The forward keeps nothing but its inputs: the
    backward recomputes the rest from x, as JAX's ``_block_bwd_kernel``
    does."""

    @staticmethod
    def forward(ctx, x, m1, m2, num_heads, eps, post_eps, grad_enabled,
                *params):
        # The kernels' view of the parameters, kept for the backward.
        w = _BlockWeights(params, x.shape[-1], params[8].shape[1], x.device,
                          True)
        out = _block_fwd_f32_cuda(x, params, m1, m2, num_heads, eps,
                                  post_eps, w)
        ctx.weights = w if _owed(ctx, grad_enabled) else None
        ctx.cfg = (num_heads, eps, post_eps)
        ctx.save_for_backward(x, m1, m2, *params)
        return out

    @staticmethod
    def backward(ctx, gout):
        num_heads, eps, post_eps = ctx.cfg
        x, m1, m2, *params = ctx.saved_tensors
        need_masks = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dx, grads, (dm1, dm2) = _block_bwd_f32_cuda(
            gout, x, params, m1, m2, num_heads, eps, post_eps, need_masks,
            w=ctx.weights)
        if need_masks:
            dm1, dm2 = dm1.reshape(m1.shape), dm2.reshape(m2.shape)
        grads = tuple(None if g is None else g.reshape(t.shape)
                      for g, t in zip(grads, params))
        return (dx, dm1, dm2, None, None, None, None, *grads)


def transformer_block(x, params, num_heads: int, eps: float = 1e-6,
                      post_eps: float = 1e-6, branch_masks=None):
    """The block with its gradient (see :func:`transformer_block_plain`).

    CPU tensors, and clips of more than :data:`BLOCK_MAX_TOKENS` tokens
    (where the JAX package runs its oracle), run the plain version. CUDA
    tensors run the kernels of ``csrc/block.cu`` forward and backward in
    bf16, and those of ``csrc/block_f32.cu`` in f32: with no gradient owed
    and no masks one launch of the forward, otherwise
    :class:`_BlockF32Kernel` (the masked forward, the recompute-and-
    backward). Widths :func:`block_kernel_fits` refuses raise."""
    if not _on_card(x, "transformer_block") or x.shape[1] > BLOCK_MAX_TOKENS:
        return transformer_block_plain(x, params, num_heads, eps, post_eps,
                                       branch_masks)
    C, hid = x.shape[-1], params[8].shape[1]
    require_kernel(block_kernel_fits(C, num_heads, hid),
                   "transformer_block", f"C={C}, {num_heads} heads, hid={hid}")
    m1, m2 = branch_masks if branch_masks is not None else (None, None)
    if x.dtype == torch.float32:
        if branch_masks is None and not _needs_grad(x, *params):
            return _block_fwd_f32_cuda(x, params, None, None, num_heads, eps,
                                       post_eps)
        return _BlockF32Kernel.apply(x, m1, m2, num_heads, eps, post_eps,
                                     torch.is_grad_enabled(), *params)
    return _BlockKernel.apply(x, m1, m2, num_heads, eps, post_eps,
                              torch.is_grad_enabled(), *params)


# ---------------------------------------------------------------------------
# GRU scan (replaces _gru_scan_kernel / fused_gru_layer[_rev]) and its
# training pair (_gru_scan_save_kernel and _gru_bwd_kernel, the custom VJP
# of fused_gru_layer[_rev])
# ---------------------------------------------------------------------------


def _gru_step(h, gi_t, w, b, dt):
    """One step of torch's gate math from the f32 carry ``h``: returns
    (h_next, r, z, n, h_n), all f32, h_n = bf16(h) @ Whh_n + b_n before the
    reset product."""
    gh = mm(h.to(dt), w) + b
    i_r, i_z, i_n = gi_t.float().chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h, r, z, n, h_n


def _gru_rows(T: int, reverse: bool):
    """The rows a direction visits, in its scan order."""
    return range(T - 1, -1, -1) if reverse else range(T)


def gru_layer_plain(gi, whh, bhh, reverse: bool = False) -> torch.Tensor:
    """Plain version of one GRU direction (math of
    ``gru_layer_scan_reference``, with the kernel's f32 sums).

    gi: [T, B, 3H] input-gate projections in the compute dtype; whh [H, 3H];
    bhh [3H]. h0 = 0 and the carry is f32; each step adds
    ``bf16(h) @ Whh + bhh`` (``h @ Whh`` under f32) with torch's gate math.
    ``reverse`` scans rows T−1 … 0 and writes each output at its own row,
    so ``gru_layer_plain(gi, .., True)[t] == gru_layer_plain(gi.flip(0))
    [T−1−t]``. Returns [T, B, H] in gi's dtype."""
    T, B, H3 = gi.shape
    dt = gi.dtype
    w, b = whh.to(dt), bhh.float()
    h = torch.zeros(B, H3 // 3, dtype=torch.float32, device=gi.device)
    ys = torch.empty(T, B, H3 // 3, dtype=dt, device=gi.device)
    for t in _gru_rows(T, reverse):
        h = _gru_step(h, gi[t], w, b, dt)[0]
        ys[t] = h.to(dt)
    return ys


def gru_layer_save_plain(gi, whh, bhh, reverse: bool = False):
    """Plain version of the saving forward (``_gru_scan_save_kernel``): the
    scan of :func:`gru_layer_plain`, plus what the backward reads.

    Returns (ys [T, B, H] in gi's dtype, saved [5, T, B, H] f32) with saved =
    (h_prev, r, z, n, h_n) of every step at its own row: the f32 state the
    step started from, the gates, and h_n before the reset product."""
    T, B, H3 = gi.shape
    H = H3 // 3
    dt = gi.dtype
    w, b = whh.to(dt), bhh.float()
    h = torch.zeros(B, H, dtype=torch.float32, device=gi.device)
    ys = torch.empty(T, B, H, dtype=dt, device=gi.device)
    saved = torch.empty(5, T, B, H, dtype=torch.float32, device=gi.device)
    for t in _gru_rows(T, reverse):
        saved[0, t] = h
        h, *gates = _gru_step(h, gi[t], w, b, dt)
        for i, v in enumerate(gates, 1):
            saved[i, t] = v
        ys[t] = h.to(dt)
    return ys, saved


def gru_layer_bwd_plain(g, saved, whh, reverse: bool = False):
    """Plain version of the backward scan (``_gru_bwd_kernel``).

    g: [T, B, H] gradient of ys, in the compute dtype; saved: the forward's
    [5, T, B, H] state; whh [H, 3H]. Visits the rows in the reverse of the
    forward's order with an f32 carry: dh = g[t] + carry, the gate gradients
    dgi = [dr, dz, dn] and dgh = [dr, dz, dn·r], then carry = dh·z +
    bf16(dgh) @ Whhᵀ (f32 sums), not formed after the last row. Returns
    (dgi, dgh), f32 [T, B, 3H]."""
    T, B, H = g.shape
    dt = g.dtype
    wt = whh.t().to(dt)
    hprev, r, z, n, hn = saved
    dgi = torch.empty(T, B, 3 * H, dtype=torch.float32, device=g.device)
    dgh = torch.empty_like(dgi)
    carry = torch.zeros(B, H, dtype=torch.float32, device=g.device)
    rows = list(_gru_rows(T, not reverse))
    for i, t in enumerate(rows):
        dh = g[t].float() + carry
        dz = dh * (hprev[t] - n[t])
        dn = (dh * (1.0 - z[t])) * (1.0 - n[t] * n[t])
        dr = (dn * hn[t]) * (r[t] * (1.0 - r[t]))
        dzp = dz * (z[t] * (1.0 - z[t]))
        dgi[t] = torch.cat([dr, dzp, dn], dim=-1)
        dgh[t] = torch.cat([dr, dzp, dn * r[t]], dim=-1)
        if i < T - 1:
            carry = dh * z[t] + mm(dgh[t].to(dt), wt)
    return dgi, dgh


def gru_bidir_plain(gi_f, gi_b, whh_f, bhh_f, whh_b, bhh_b):
    """Plain version of one BiGRU layer's two scans: the forward direction
    over ``gi_f`` and the reverse one over ``gi_b`` (each with its own T),
    as :func:`gru_layer_plain`. Returns (ys_f, ys_b)."""
    return (gru_layer_plain(gi_f, whh_f, bhh_f),
            gru_layer_plain(gi_b, whh_b, bhh_b, reverse=True))


def gru_kernel_fits(H: int) -> bool:
    """The static shape test of the GRU kernels: H a multiple of 64."""
    return H % 64 == 0


# The scan kernel's CTA: 8 warps, each over 32-row pairs of the batch.
GRU_SCAN_WARPS = 8
# Units of one direction a CTA may own (csrc/gru_scan.cu instantiates
# 8, 16 and 24: one, two or three n8 tiles per gate).
GRU_SCAN_UNITS = (8, 16, 24)
# Stages of the stamped launch (``gru_scan_kernel``'s clock64() stamps).
GRU_STAGES = ("weights", "barrier", "h load", "product", "epilogue")
# Stages of the stamped backward launch (``gru_bwd_kernel``'s).
GRU_BWD_STAGES = ("weights", "state", "barrier", "dgh load", "product",
                  "epilogue")


class GruPlan(NamedTuple):
    """One launch of the scan kernel on the card: ``units`` hidden units of
    one direction per CTA (``groups`` CTAs a direction, ``grid`` in all, at
    most one an SM), its warps as ``wm`` over 32-row pairs times ``wk``
    over K, and the CTA's dynamic shared memory in bytes."""

    units: int
    groups: int
    grid: int
    wm: int
    wk: int
    smem: int


def gru_smem_bytes(B: int, H: int, units: int, wm: int, wk: int) -> int:
    """Shared memory of one scan CTA, as ``scan_smem_bytes`` in
    csrc/gru_scan.cu (the launch refuses any other): the bf16 weight slice
    [3U, H], the f32 carry of its units for every 32-row pair, and the
    partial sums of the warps past the first when they split K."""
    pairs = -(-B // 32)
    return (H * 3 * units * 2 + pairs * 32 * units * 4
            + (wk - 1) * wm * (3 * units // 8) * 2 * 4 * 32 * 4)


def gru_plan(B: int, H: int, directions: int, sm_count: int,
             smem_limit: int) -> GruPlan:
    """Spread a scan of ``directions`` directions over the card: the
    fewest units per CTA whose grid has at most one CTA an SM (every CTA
    resident, as the grid barrier needs) and whose shared memory fits.
    The warps cover the 32-row pairs first and split K with the rest.
    Raises ``NotImplementedError`` where no plan is co-resident: the scan
    is never cut into more launches."""
    if not gru_kernel_fits(H) or B < 1 or directions not in (1, 2):
        raise ValueError(f"gru_plan: B={B}, H={H}, {directions} directions")
    pairs = -(-B // 32)
    wm = 1 << (min(pairs, GRU_SCAN_WARPS).bit_length() - 1)
    wk = GRU_SCAN_WARPS // wm
    while (H // 64) % wk:
        wk //= 2
    for units in GRU_SCAN_UNITS:
        groups = -(-H // units)
        smem = gru_smem_bytes(B, H, units, wm, wk)
        if directions * groups <= sm_count and smem <= smem_limit:
            return GruPlan(units, groups, directions * groups, wm, wk, smem)
    raise NotImplementedError(
        f"gru_layer: no co-resident plan for B={B}, H={H}, {directions} "
        f"directions on {sm_count} SMs with {smem_limit} B of shared memory "
        "a block; widening the scan kernel is queued in ROADMAP.md, "
        "section B")


def gru_bwd_smem_bytes(B: int, H: int, units: int, wm: int, wk: int) -> int:
    """Shared memory of one backward-scan CTA, as ``bwd_smem_bytes`` in
    csrc/gru_scan.cu (the launch refuses any other): the bf16 columns
    Whh[:, units] [3H, U], dh·z of its units for every 32-row pair (f32),
    and the partial sums of the warps past the first when they split K."""
    pairs = -(-B // 32)
    return (3 * H * units * 2 + pairs * 32 * units * 4
            + (wk - 1) * wm * (units // 8) * 2 * 4 * 32 * 4)


def gru_bwd_plan(B: int, H: int, sm_count: int, smem_limit: int) -> GruPlan:
    """Spread the backward scan of one direction over the card, as
    :func:`gru_plan` does the forward: the fewest units per CTA whose grid
    has at most one CTA an SM and whose shared memory fits; the warps cover
    the 32-row pairs first and split K = 3H with the rest, in whole 32-wide
    chunks. Raises ``NotImplementedError`` where no plan is co-resident:
    the backward is never cut into more launches."""
    if not gru_kernel_fits(H) or B < 1:
        raise ValueError(f"gru_bwd_plan: B={B}, H={H}")
    pairs = -(-B // 32)
    wm = 1 << (min(pairs, GRU_SCAN_WARPS).bit_length() - 1)
    wk = GRU_SCAN_WARPS // wm
    while (3 * H // 32) % wk:
        wk //= 2
    for units in GRU_SCAN_UNITS:
        groups = -(-H // units)
        smem = gru_bwd_smem_bytes(B, H, units, wm, wk)
        if groups <= sm_count and smem <= smem_limit:
            return GruPlan(units, groups, groups, wm, wk, smem)
    raise NotImplementedError(
        f"gru_layer_bwd: no co-resident plan for B={B}, H={H} on "
        f"{sm_count} SMs with {smem_limit} B of shared memory a block; "
        "widening the backward scan is queued in ROADMAP.md, section B")


_GRU_LIMITS: dict = {}


def _card_limits(device) -> tuple[int, int]:
    """The card's SM count and opt-in shared memory a block (asked once
    per device)."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _GRU_LIMITS:
        sm, smem = ctypes.c_int(), ctypes.c_int()
        _cuda.GRU.call("pmce_gru_device_limits", index, ctypes.byref(sm),
                       ctypes.byref(smem))
        _GRU_LIMITS[index] = (sm.value, smem.value)
    return _GRU_LIMITS[index]


def _card_plan(B: int, H: int, directions: int, device) -> GruPlan:
    """:func:`gru_plan` with the card's own limits."""
    return gru_plan(B, H, directions, *_card_limits(device))


def _card_bwd_plan(B: int, H: int, device) -> GruPlan:
    """:func:`gru_bwd_plan` with the card's own limits."""
    return gru_bwd_plan(B, H, *_card_limits(device))


def _scan_weight(whh, H: int, device):
    """Check ``whh`` ([H, 3H], f32 or bf16, on the card; any strides) and
    return its strides as the kernel indexes the [3H, H] parameter
    (row j, column k at ``j * srow + k * scol``): no copy is made. The
    parameter's own ``.t()`` view gives srow = H, scol = 1."""
    if whh.device != device:
        raise ValueError(f"whh: expected a tensor on {device}, got "
                         f"{whh.device}")
    if whh.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"whh: expected float32 or bfloat16, got "
                         f"{whh.dtype}")
    if tuple(whh.shape) != (H, 3 * H):
        raise ValueError(f"whh: expected shape {(H, 3 * H)}, got "
                         f"{tuple(whh.shape)}")
    return whh.stride(1), whh.stride(0)


def _gru_scan_cuda(dirs, save: bool, stamps=None):
    """One launch of the persistent scan kernel over ``dirs``, a list of
    one or two (gi, whh, bhh, reverse) of the same B and H. Returns a list
    with, per direction, ys or, with ``save``, (ys, saved, wb): the saving
    forward's state (as :func:`gru_layer_save_plain`) and the bf16
    rounding of whh as the [H, 3H] view of a [3H, H] tensor, which the
    backward kernel reads. ``stamps`` (int64 [grid, 5] on the card) takes
    the stamped launch's cycles instead of counting one."""
    bf16, f32 = torch.bfloat16, torch.float32
    B, H = dirs[0][0].shape[1], dirs[0][0].shape[2] // 3
    dev = dirs[0][0].device
    ptrs, ints, outs = [], [], []
    for gi, whh, bhh, reverse in dirs:
        if gi.dtype != bf16:
            raise NotImplementedError("the GRU kernels take bf16 projections")
        T = gi.shape[0]
        _cuda.check_cuda(gi, "gi", bf16, (T, B, 3 * H))
        srow, scol = _scan_weight(whh, H, dev)
        b = _cuda.to_kernel(bhh, dev, f32, (3 * H,), "bhh")
        ys = torch.empty(T, B, H, device=dev, dtype=bf16)
        # bf16(h) ping-pong: the next step's matrix operand.
        hb = torch.empty(2, B, H, device=dev, dtype=bf16)
        saved = torch.empty(5, T, B, H, device=dev, dtype=f32) if save \
            else None
        wb = torch.empty(3 * H, H, device=dev, dtype=bf16) if save else None
        ptrs += [gi, whh, b, ys, hb,
                 *(saved.unbind(0) if save else (None,) * 5), wb]
        ints += [T, int(reverse), int(whh.dtype == f32), srow, scol]
        outs.append((ys, saved, wb.t()) if save else ys)
    plan = _card_plan(B, H, len(dirs), dev)
    bar = torch.empty(1, device=dev, dtype=torch.int32)
    _cuda.GRU.call("pmce_gru_scan", _cuda.ptr_table(*ptrs),
                   (ctypes.c_longlong * len(ints))(*ints), len(dirs), B, H,
                   plan.units, plan.wm, plan.wk, int(save), plan.smem,
                   _cuda.ptr(bar), None if stamps is None else
                   _cuda.ptr(stamps), _cuda.stream_ptr(dev))
    if stamps is None and not save:
        GRU_SCAN_LAUNCHES.count += 1
    return outs


def _gru_layer_cuda(gi, whh, bhh, reverse: bool, save: bool = False):
    """One direction through the scan kernel: ys, or with ``save`` the
    saving variant's (ys, saved, wb) (see :func:`_gru_scan_cuda`)."""
    return _gru_scan_cuda([(gi, whh, bhh, reverse)], save)[0]


def _gru_bwd_cuda(g, saved, wb, reverse: bool, dgi_dtype=torch.float32,
                  stamps=None):
    """One launch of the persistent backward scan (row 13) over all T steps
    of one direction. ``wb``: Whh as the bf16 [H, 3H] view of a [3H, H]
    tensor (the saving forward's rounding), read in place. Returns (dgi in
    ``dgi_dtype`` (f32 or bf16, the bits of the f32 values' cast), dgh f32,
    bf16(dgh)), each [T, B, 3H]. ``stamps`` (int64 [grid, 6] on the card)
    takes the stamped launch's cycles instead of counting one."""
    T, B, H = g.shape
    bf16, f32 = torch.bfloat16, torch.float32
    if g.dtype != bf16:
        raise NotImplementedError("the GRU kernels take bf16 gradients")
    _cuda.check_cuda(g, "g", bf16, (T, B, H))
    _cuda.check_cuda(saved, "saved", f32, (5, T, B, H))
    if wb.dtype != bf16 or tuple(wb.shape) != (H, 3 * H):
        raise ValueError("whh: the backward kernel reads Whh as bf16 "
                         "[H, 3H] (the saving forward's rounding)")
    # Whh^T as a row-major [3H, H] matrix: the view of the parameter's own
    # layout, which the saving forward writes; no copy.
    _cuda.check_cuda(wb.t(), "whh.t()", bf16, (3 * H, H))
    if dgi_dtype not in (f32, bf16):
        raise ValueError(f"dgi: float32 or bfloat16, not {dgi_dtype}")
    dev = g.device
    dgi = torch.empty(T, B, 3 * H, device=dev, dtype=dgi_dtype)
    dgh = torch.empty(T, B, 3 * H, device=dev, dtype=f32)
    dghb = torch.empty(T, B, 3 * H, device=dev, dtype=bf16)
    plan = _card_bwd_plan(B, H, dev)
    bar = torch.empty(1, device=dev, dtype=torch.int32)
    _cuda.GRU.call("pmce_gru_bwd_scan",
                   _cuda.ptr_table(g, *saved.unbind(0), wb.t(), dgi, dgh,
                                   dghb),
                   T, int(reverse), int(dgi_dtype == bf16), B, H, plan.units,
                   plan.wm, plan.wk, plan.smem, _cuda.ptr(bar),
                   None if stamps is None else _cuda.ptr(stamps),
                   _cuda.stream_ptr(dev))
    if stamps is None:
        GRU_BWD_SCAN_LAUNCHES.count += 1
    return dgi, dgh, dghb


def _gru_require(H: int) -> None:
    require_kernel(gru_kernel_fits(H), "gru_layer", f"H={H}")


def _gru_save(gi, whh, bhh, reverse: bool):
    """:func:`gru_layer_save` with the weight the backward reads: on the
    card the kernel's bf16 rounding of whh, on the CPU whh itself."""
    if not _on_card(gi, "gru_layer_save"):
        return (*gru_layer_save_plain(gi, whh, bhh, reverse), whh)
    _gru_require(whh.shape[0])
    out = _gru_layer_cuda(gi, whh, bhh, reverse, save=True)
    GRU_SAVE_LAUNCHES.count += 1
    return out


def gru_layer_save(gi, whh, bhh, reverse: bool = False):
    """The saving forward (see :func:`gru_layer_save_plain`): CPU tensors
    run the plain version; CUDA tensors the saving variant of the scan
    kernel of ``csrc/gru_scan.cu`` (bf16 gi; f32 or bf16 whh, read in
    place; H that :func:`gru_kernel_fits` refuses raises)."""
    return _gru_save(gi, whh, bhh, reverse)[:2]


def _gru_bwd_plain(g, saved, whh, reverse: bool, dgi_dtype):
    """:func:`gru_layer_bwd_plain` with the casts :func:`_gru_bwd` returns."""
    dgi, dgh = gru_layer_bwd_plain(g, saved, whh, reverse)
    return dgi.to(dgi_dtype), dgh, dgh.to(g.dtype)


def _gru_bwd(g, saved, whh, reverse: bool, dgi_dtype):
    """:func:`gru_layer_bwd` with dgi in ``dgi_dtype`` and bf16(dgh) too:
    (dgi, dgh f32, dgh in g's dtype), as the weight gradient reads them."""
    if not _on_card(g, "gru_layer_bwd"):
        return _gru_bwd_plain(g, saved, whh, reverse, dgi_dtype)
    _gru_require(g.shape[-1])
    out = _gru_bwd_cuda(g, saved, whh, reverse, dgi_dtype)
    GRU_BWD_LAUNCHES.count += 1
    return out


def gru_layer_bwd(g, saved, whh, reverse: bool = False):
    """The backward scan (see :func:`gru_layer_bwd_plain`): CPU tensors
    run the plain version; CUDA tensors one launch of the persistent
    backward scan of ``csrc/gru_scan.cu`` (bf16 g; whh the bf16 [H, 3H]
    view of a [3H, H] tensor, as the saving forward writes it on the card;
    H that :func:`gru_kernel_fits` refuses raises)."""
    return _gru_bwd(g, saved, whh, reverse, torch.float32)[:2]


class _GRULayer(torch.autograd.Function):
    """One GRU direction with its gradient, as ``fused_gru_layer``'s custom
    VJP: the saving forward (one launch), then the backward scan (one
    launch of the persistent backward kernel on the card, which also
    writes dgi in gi's dtype and bf16(dgh), so nothing is cast after it)
    and the weight gradients as one time-batched product and sum over all
    T·B rows (``fused_attention.py:2538-2546`` of the JAX package)."""

    @staticmethod
    def forward(ctx, gi, whh, bhh, reverse):
        ys, saved, wb = _gru_save(gi, whh, bhh, reverse)
        ctx.reverse = reverse
        ctx.gi_dtype = gi.dtype
        ctx.w_dtype = whh.dtype
        ctx.save_for_backward(wb, saved)
        return ys

    @staticmethod
    def backward(ctx, g):
        wb, saved = ctx.saved_tensors
        dgi, dgh, dghb = _gru_bwd(g.contiguous(), saved, wb, ctx.reverse,
                                  ctx.gi_dtype)
        T, B, H = g.shape
        dt = g.dtype
        # Operands in the compute dtype, as the forward cast them; f32 sums.
        dwhh = mm(saved[0].reshape(T * B, H).to(dt).t(),
                  dghb.reshape(T * B, 3 * H))
        return (dgi, dwhh.to(ctx.w_dtype), dgh.reshape(T * B, 3 * H).sum(0),
                None)


def _gru_dispatch(gi, whh, bhh, reverse: bool, counter) -> torch.Tensor:
    if _needs_grad(gi, whh, bhh):
        return _GRULayer.apply(gi, whh, bhh, reverse)
    if not _on_card(gi, "gru_layer"):
        return gru_layer_plain(gi, whh, bhh, reverse)
    _gru_require(whh.shape[0])
    ys = _gru_layer_cuda(gi, whh, bhh, reverse)
    counter.count += 1
    return ys


def gru_layer(gi, whh, bhh) -> torch.Tensor:
    """One forward GRU direction over T (see :func:`gru_layer_plain`).

    Without a gradient to keep: the scan kernel (K2) on CUDA tensors, the
    plain version on CPU ones. With one: :class:`_GRULayer` (the saving
    forward and the backward scan, kernels on the card)."""
    return _gru_dispatch(gi, whh, bhh, False, GRU_LAUNCHES)


def gru_layer_rev(gi, whh, bhh) -> torch.Tensor:
    """The backward direction, output in forward time order, no copies."""
    return _gru_dispatch(gi, whh, bhh, True, GRU_REV_LAUNCHES)


def gru_bidir(gi_f, gi_b, whh_f, bhh_f, whh_b, bhh_b):
    """Both directions of a BiGRU layer (see :func:`gru_bidir_plain`).

    Without a gradient to keep: on CUDA tensors one launch of the scan
    kernel runs both directions (counted once by ``gru_scan`` and once by
    each direction's counter, ``gru_layer`` and ``gru_layer_rev``), on CPU
    tensors the plain version. With one: :func:`gru_layer` and
    :func:`gru_layer_rev`, a :class:`_GRULayer` each."""
    if _needs_grad(gi_f, gi_b, whh_f, bhh_f, whh_b, bhh_b):
        return gru_layer(gi_f, whh_f, bhh_f), gru_layer_rev(gi_b, whh_b,
                                                            bhh_b)
    if not _on_card(gi_f, "gru_bidir"):
        return gru_bidir_plain(gi_f, gi_b, whh_f, bhh_f, whh_b, bhh_b)
    _gru_require(whh_f.shape[0])
    ys_f, ys_b = _gru_scan_cuda([(gi_f, whh_f, bhh_f, False),
                                 (gi_b, whh_b, bhh_b, True)], False)
    GRU_LAUNCHES.count += 1
    GRU_REV_LAUNCHES.count += 1
    return ys_f, ys_b


def gru_stage_split(gi_f, gi_b, whh_f, bhh_f, whh_b, bhh_b) -> dict:
    """One stamped launch of the two-direction scan on the card (not
    counted): {stage: cycles summed over the CTAs} for the stages of
    :data:`GRU_STAGES`, and ``"steps"``: the launch's sequential steps."""
    H = whh_f.shape[0]
    plan = _card_plan(gi_f.shape[1], H, 2, gi_f.device)
    stamps = torch.zeros(plan.grid, len(GRU_STAGES), dtype=torch.int64,
                         device=gi_f.device)
    with torch.no_grad():
        _gru_scan_cuda([(gi_f, whh_f, bhh_f, False),
                        (gi_b, whh_b, bhh_b, True)], False, stamps=stamps)
    total = stamps.sum(0).cpu().tolist()
    return {**dict(zip(GRU_STAGES, total)), "ctas": plan.grid,
            "steps": max(gi_f.shape[0], gi_b.shape[0])}


def gru_bwd_stage_split(g, saved, wb, reverse: bool = False) -> dict:
    """One stamped launch of the backward scan on the card (not counted):
    {stage: cycles summed over the CTAs} for the stages of
    :data:`GRU_BWD_STAGES`, ``"ctas"`` and ``"steps"``."""
    T, B, H = g.shape
    plan = _card_bwd_plan(B, H, g.device)
    stamps = torch.zeros(plan.grid, len(GRU_BWD_STAGES), dtype=torch.int64,
                         device=g.device)
    with torch.no_grad():
        _gru_bwd_cuda(g, saved, wb, reverse, stamps=stamps)
    total = stamps.sum(0).cpu().tolist()
    return {**dict(zip(GRU_BWD_STAGES, total)), "ctas": plan.grid,
            "steps": T}


# ---------------------------------------------------------------------------
# The decoder's attention blocks, forward and backward: multi-head
# self-attention (replaces _mhsa_kernel / fused_mhsa and _mhsa_bwd_kernel),
# the AdaLayerNorm self-attention block (_ada_block_kernel /
# fused_ada_block, _ada_block_bwd_kernel) and the cross-attention block
# (_ca_block_kernel / fused_ca_block, _ca_block_bwd_kernel)
# ---------------------------------------------------------------------------


def _attention_heads(q, k, v, num_heads: int, dt) -> torch.Tensor:
    """Per-head softmax(q kᵀ) v of [B, Nq, C] queries (pre-scaled) over
    [B, Nk, C] keys and values, all in ``dt``: f32 scores and softmax, the
    probabilities rounded to ``dt`` before P·V (f32 sums). [B, Nq, C] in
    ``dt``."""
    B, Nq, C = q.shape
    Nk = k.shape[1]
    dh = C // num_heads

    def heads(a, n):
        return a.reshape(B, n, num_heads, dh).transpose(1, 2).float()

    p = torch.softmax(heads(q, Nq) @ heads(k, Nk).transpose(-1, -2), dim=-1)
    o = p.to(dt).float() @ heads(v, Nk)
    return o.transpose(1, 2).reshape(B, Nq, C).to(dt)


def _mhsa_f32(x, wqkv, bqkv, wproj, bproj, num_heads: int):
    dt = x.dtype
    q, k, v = split_scaled_qkv(mm(x, wqkv.to(dt)) + bqkv, x.shape[-1],
                               num_heads, dt)
    return mm(_attention_heads(q, k, v, num_heads, dt), wproj.to(dt)) + bproj


def mhsa_plain(x, wqkv, bqkv, wproj, bproj, num_heads: int):
    """Plain version of the fused MHSA (math of ``mhsa_reference``, with
    the kernel's cast points); its gradient is PyTorch's autograd of it.

    x: [B, N, C] tokens, any N, compute dtype; wqkv [C, 3C], bqkv [3C],
    wproj [C, C], bproj [C]. q is scaled by 1/sqrt(dh) in f32 before its
    one rounding. Returns [B, N, C] in x's dtype."""
    return _mhsa_f32(x, wqkv, bqkv, wproj, bproj, num_heads).to(x.dtype)


def _branch_scales(branch_masks, B: int):
    if branch_masks is None:
        return None, None
    return tuple(m.float().reshape(B, 1, 1) for m in branch_masks)


def _ada_mlp_f32(x1, gamma2, beta2, w1, bb1, w2, bb2, m2, eps: float, dt):
    """x1 + m2·MLP(AdaLN(x1)) in f32: the MLP half of both decoder
    blocks."""
    h2 = adaln_f32(x1, gamma2.float()[:, None], beta2.float()[:, None],
                   eps).to(dt)
    hh = F.gelu(mm(h2, w1.to(dt)) + bb1).to(dt)
    mo = mm(hh, w2.to(dt)) + bb2
    return x1 + (mo if m2 is None else mo * m2)


def ada_block_plain(x, gamma1, beta1, gamma2, beta2, params, num_heads: int,
                    eps: float = 1e-6, branch_masks=None):
    """Plain version of the fused AdaLN block (math of
    ``ada_block_reference``); its gradient is PyTorch's autograd of it.

    x: [B, N, C] tokens, compute dtype; gamma*/beta*: [B, C] per-clip AdaLN
    vectors; params: (wqkv, bqkv, wproj, bproj, w_fc1, b_fc1, w_fc2, b_fc2),
    weights [in, out]; branch_masks: None or per-clip [B, 1, 1] scales of
    the attention and MLP branches. Returns [B, N, C] in x's dtype."""
    wqkv, bqkv, wproj, bproj, w1, bb1, w2, bb2 = params
    dt = x.dtype
    m1, m2 = _branch_scales(branch_masks, x.shape[0])
    xf = x.float()
    h1 = adaln_f32(xf, gamma1.float()[:, None], beta1.float()[:, None],
                   eps).to(dt)
    a = _mhsa_f32(h1, wqkv, bqkv, wproj, bproj, num_heads)
    x1 = xf + (a if m1 is None else a * m1)
    return _ada_mlp_f32(x1, gamma2, beta2, w1, bb1, w2, bb2, m2, eps,
                        dt).to(dt)


def ca_block_plain(xq, xk, xv, gammas, betas, params, num_heads: int,
                   eps: float = 1e-6, branch_masks=None):
    """Plain version of the fused cross-attention block (math of
    ``ca_block_reference``); its gradient is PyTorch's autograd of it.

    xq: [B, Nq, C] queries; xk, xv: [B, Nk, C] keys and values, compute
    dtype; gammas / betas: 4-tuples of [B, C] (normq, normk, normv, norm2);
    params: (wq, bq, wk, bk, wv, bv, wproj, bproj, w_fc1, b_fc1, w_fc2,
    b_fc2). Returns [B, Nq, C] in xq's dtype."""
    (wq, bq, wk, bk, wv, bv, wproj, bproj, w1, bb1, w2, bb2) = params
    dt = xq.dtype
    C = xq.shape[-1]
    m1, m2 = _branch_scales(branch_masks, xq.shape[0])

    def norm(x, i):
        return adaln_f32(x.float(), gammas[i].float()[:, None],
                         betas[i].float()[:, None], eps).to(dt)

    scale = 1.0 / math.sqrt(C // num_heads)
    q = ((mm(norm(xq, 0), wq.to(dt)) + bq) * scale).to(dt)
    k = (mm(norm(xk, 1), wk.to(dt)) + bk).to(dt)
    v = (mm(norm(xv, 2), wv.to(dt)) + bv).to(dt)
    a = mm(_attention_heads(q, k, v, num_heads, dt), wproj.to(dt)) + bproj
    x1 = xq.float() + (a if m1 is None else a * m1)
    return _ada_mlp_f32(x1, gammas[3], betas[3], w1, bb1, w2, bb2, m2, eps,
                        dt).to(dt)


MHSA_FWD_LAUNCHES = _cuda.launch_counter("mhsa_fwd")
MHSA_BWD_LAUNCHES = _cuda.launch_counter("mhsa_bwd")
# Rows 4f and 5f: the self-attention's f32 forward and backward
# (csrc/mhsa_f32.cu).
MHSA_FWD_F32_LAUNCHES = _cuda.launch_counter("mhsa_fwd_f32")
MHSA_BWD_F32_LAUNCHES = _cuda.launch_counter("mhsa_bwd_f32")
ADA_FWD_LAUNCHES = _cuda.launch_counter("ada_block_fwd")
ADA_BWD_LAUNCHES = _cuda.launch_counter("ada_block_bwd")
CA_FWD_LAUNCHES = _cuda.launch_counter("ca_block_fwd")
CA_BWD_LAUNCHES = _cuda.launch_counter("ca_block_bwd")
# The launch sequences of the shapes outside rows 4, 5, 8, 9 and 10's tile
# programs' gates (:func:`mhsa_fwd_kernel_fits` for rows 4 and 5,
# :func:`ada_fwd_kernel_fits`, :func:`ada_bwd_kernel_fits`,
# :func:`ca_bwd_kernel_fits`), counted apart from the programs.
MHSA_FWD_SEQ_LAUNCHES = _cuda.launch_counter("mhsa_fwd_seq")
MHSA_BWD_SEQ_LAUNCHES = _cuda.launch_counter("mhsa_bwd_seq")
ADA_FWD_SEQ_LAUNCHES = _cuda.launch_counter("ada_block_fwd_seq")
ADA_BWD_SEQ_LAUNCHES = _cuda.launch_counter("ada_block_bwd_seq")
CA_FWD_SEQ_LAUNCHES = _cuda.launch_counter("ca_block_fwd_seq")
# Rows 8f-11f: the AdaLN and CA blocks' f32 forwards and backwards
# (csrc/ada_f32.cu, csrc/ca_f32.cu).
ADA_FWD_F32_LAUNCHES = _cuda.launch_counter("ada_fwd_f32")
ADA_BWD_F32_LAUNCHES = _cuda.launch_counter("ada_bwd_f32")
CA_FWD_F32_LAUNCHES = _cuda.launch_counter("ca_fwd_f32")
CA_BWD_F32_LAUNCHES = _cuda.launch_counter("ca_bwd_f32")

# Head widths the attention kernel is built for (attention_ops.cuh).
_HEAD_DIMS = (8, 16, 32)
_WORKSPACE: dict = {}


def attention_kernel_fits(C: int, num_heads: int, hid: int = 64) -> bool:
    """The static shape test of the decoder attention kernels (mhsa,
    AdaLN block, CA block): C and hid multiples of 64, head width in
    :data:`_HEAD_DIMS`; any token count."""
    return (C % 64 == 0 and C % num_heads == 0
            and C // num_heads in _HEAD_DIMS and hid % 64 == 0)


def _attention_require(name: str, C: int, num_heads: int, hid: int = 64):
    require_kernel(attention_kernel_fits(C, num_heads, hid), name,
                   f"C={C}, {num_heads} heads, hid={hid}")


def _attn_checks(name, x) -> bool:
    """The decoder kernels' dtype gate: True for f32 tokens (their f32
    kernels: rows 4f / 5f, 8f-11f), False for bf16 (``csrc/mhsa.cu``,
    ``ada_block.cu``, ``ca_block.cu``); any other dtype raises."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"the {name} kernels take bf16 or f32 tokens, not {x.dtype}")
    return x.dtype == torch.float32



def _workspace(lib, fn, dev, *shape):
    key = (fn, *shape)
    if key not in _WORKSPACE:
        _WORKSPACE[key] = int(lib.query(fn, *shape))
    return torch.empty(_WORKSPACE[key], device=dev, dtype=torch.uint8)


def _bf16_mat(a, dev, rows, cols, name):
    return _cuda.to_kernel(a, dev, torch.bfloat16, (rows, cols), name)


def _bf16_mat_t(a, dev, rows, cols, name):
    """W [in, out] → bf16 Wᵀ [out, in] (the backward's NN products)."""
    return _cuda.to_kernel(a.t(), dev, torch.bfloat16, (rows, cols), name)


def _f32_vec(a, dev, n, name):
    return _cuda.to_kernel(a, dev, torch.float32, (n,), name)


def _f32_rows(a, dev, B, C, name):
    return _cuda.to_kernel(a, dev, torch.float32, (B, C), name)


def _split_grads(flat, like):
    """Views of one flat f32 gradient buffer shaped and typed as ``like``."""
    out, off = [], 0
    for t in like:
        n = t.numel()
        out.append(flat[off:off + n].view(t.shape).to(t.dtype))
        off += n
    return tuple(out)


# The self-attention forward's tile program (csrc/mhsa.cu): whole clips of
# up to 64 tokens a CTA, at most 128 rows, at the widths it is built for
# ((C, head width)); its stamped stages.
_MHSA_TILE_ROWS, _MHSA_MAX_TOKENS = 128, 64
_MHSA_WIDTHS = ((64, 8), (64, 16), (64, 32), (256, 32))
MHSA_FWD_STAGES = ("loads", "qkv", "attention", "proj + store")


def mhsa_fwd_kernel_fits(N: int, C: int, num_heads: int) -> bool:
    """The static shape test of the self-attention forward's tile program,
    on top of :func:`attention_kernel_fits`: up to 64 tokens (JAX's grouped
    route, ``pmce_tpu/ops/fused_attention.py:557-563``) and C = 64 with
    heads of 8, 16 or 32, or C = 256 with heads of 32. Other shapes take
    the launch sequence (``pmce_mhsa_fwd``)."""
    return (N <= _MHSA_MAX_TOKENS and C % num_heads == 0
            and (C, C // num_heads) in _MHSA_WIDTHS)


def mhsa_fwd_plan(clips: int, N: int, C: int, sm_count: int) -> int:
    """Clips a CTA of the tile program takes: the fewest that put every
    CTA on the card at once (one wave: the C = 256 program holds one CTA
    an SM, the C = 64 program two), within the tile's 128 rows. So one
    clip a CTA while the clips fit (the decoder's 32: 32 CTAs, the
    shortest critical path); the trunk's 512 clips of 17 at C = 256: 4 a
    CTA, 128 CTAs on 132 SMs."""
    resident = sm_count * (1 if C == 256 else 2)
    return max(1, min(_MHSA_TILE_ROWS // N, -(-clips // resident)))


def _mhsa_fwd_cuda(x, wqkv, bqkv, wproj, bproj, num_heads,
                   for_grad: bool = True, stamps=None, clips_per_cta=None):
    """The forward; returns (out, saved). Inside
    :func:`mhsa_fwd_kernel_fits` one launch of the tile program
    (``pmce_mhsa_fwd_tile``, ``clips_per_cta`` clips a CTA, by default
    :func:`mhsa_fwd_plan`'s), which writes the state the backward reads
    (qkv, o, the softmax statistics) only with ``for_grad`` (else ``saved``
    is None three times); outside it the launch sequence
    (``pmce_mhsa_fwd``), which writes it always. ``stamps`` (int64 [grid,
    4] on the card): the stamped tile program, not counted."""
    clips, N, C = x.shape
    _attn_checks("fused_mhsa", x)
    _cuda.check_cuda(x, "x", torch.bfloat16, (clips, N, C))
    dev, M = x.device, clips * N
    bf16, f32 = torch.bfloat16, torch.float32
    tile = mhsa_fwd_kernel_fits(N, C, num_heads)
    save = for_grad or not tile
    qkv, o, stats = ((torch.empty(M, 3 * C, device=dev, dtype=bf16),
                      torch.empty(M, C, device=dev, dtype=bf16),
                      torch.empty(2, clips * num_heads * N, device=dev,
                                  dtype=f32))
                     if save else (None, None, None))
    sm, sl = (stats[0], stats[1]) if save else (None, None)
    out = torch.empty_like(x)
    w = (_bf16_mat(wqkv, dev, C, 3 * C, "wqkv"),
         _f32_vec(bqkv, dev, 3 * C, "bqkv"),
         _bf16_mat(wproj, dev, C, C, "wproj"),
         _f32_vec(bproj, dev, C, "bproj"))
    stream = _cuda.stream_ptr(dev)
    if tile:
        cpc = clips_per_cta or mhsa_fwd_plan(clips, N, C,
                                             _card_limits(dev)[0])
        _cuda.MHSA.call("pmce_mhsa_fwd_tile", _cuda.ptr_table(
            x, *w, out, qkv, o, sm, sl, stamps), clips, N, C, num_heads,
            cpc, stream)
        if stamps is None:
            MHSA_FWD_LAUNCHES.count += 1
    else:
        _cuda.MHSA.call("pmce_mhsa_fwd", _cuda.ptr_table(
            x, *w, qkv, o, sm, sl, out), clips, N, C, num_heads, stream)
        MHSA_FWD_SEQ_LAUNCHES.count += 1
    return out, (qkv, o, stats)


def mhsa_fwd_stage_split(x, wqkv, bqkv, wproj, bproj, num_heads: int,
                         clips_per_cta=None) -> dict:
    """One stamped launch of the forward's tile program on the card (not
    counted), saving as for a gradient: {stage: cycles summed over the
    CTAs} for the stages of :data:`MHSA_FWD_STAGES`, ``"ctas"`` and
    ``"clips_per_cta"``."""
    clips, N, C = x.shape
    cpc = clips_per_cta or mhsa_fwd_plan(clips, N, C,
                                         _card_limits(x.device)[0])
    ctas = -(-clips // cpc)
    stamps = torch.zeros(ctas, len(MHSA_FWD_STAGES), dtype=torch.int64,
                         device=x.device)
    with torch.no_grad():
        _mhsa_fwd_cuda(x, wqkv, bqkv, wproj, bproj, num_heads, stamps=stamps,
                       clips_per_cta=cpc)
    total = stamps.sum(0).cpu().tolist()
    return {**dict(zip(MHSA_FWD_STAGES, total)), "ctas": ctas,
            "clips_per_cta": cpc}


# The backward's tile program (csrc/mhsa.cu): the forward's whole clips a
# CTA, inside the forward's gate; its weight launch's K splits; its stamped
# stages.
_MHSA_WGRAD_SPLITS = 8
MHSA_BWD_STAGES = ("loads", "dO + D", "attention dq", "attention dk dv",
                   "dx + store")


def mhsa_wgrad_tiles(C: int) -> tuple[int, int]:
    """The weight launch's output tile (64 at C = 64, 128 at C = 256) and
    its number of tiles over dWqkv [C, 3C] and dWproj [C, C]."""
    wt = 64 if C == 64 else 128
    n = C // wt
    return wt, 3 * n * n + n * n


def _mhsa_bwd_seq(g, x, wqkv, wproj, saved, num_heads):
    """The backward's launch sequence (the shapes outside
    :func:`mhsa_fwd_kernel_fits`): transposed bf16 weight copies, dO's
    product, the CUDA-core attention backward's two passes, split-K weight
    partials."""
    clips, N, C = x.shape
    dev = x.device
    qkv, o, stats = saved
    dx = torch.empty_like(x)
    grads = torch.empty(4 * C * C + 4 * C, device=dev, dtype=torch.float32)
    ws = _workspace(_cuda.MHSA, "pmce_mhsa_workspace", dev, clips, N, C,
                    num_heads)
    _cuda.MHSA.call("pmce_mhsa_bwd", _cuda.ptr_table(
        x, g, _bf16_mat_t(wqkv, dev, 3 * C, C, "wqkvᵀ"),
        _bf16_mat_t(wproj, dev, C, C, "wprojᵀ"), qkv, o, stats[0], stats[1],
        dx, grads, ws), clips, N, C, num_heads, _cuda.stream_ptr(dev))
    MHSA_BWD_SEQ_LAUNCHES.count += 1
    return dx, grads


def _mhsa_bwd_cuda(g, x, wqkv, wproj, saved, num_heads, stamps=None,
                   clips_per_cta=None):
    """The backward of ``csrc/mhsa.cu``; returns (dx, the flat parameter
    gradients). Inside :func:`mhsa_fwd_kernel_fits`, two launches: the
    tile program (``pmce_mhsa_bwd_tile``, the forward's clips a CTA: dO, the
    attention backward on the tensor cores, dx, and dqkv, the weight
    products' operand) and the weight launch (``pmce_mhsa_wgrad``: dWqkv =
    xᵀ dqkv, dWproj = oᵀ g and both bias gradients); the weights are read
    in their [in, out] layout (no transposed copies). Outside it, the launch
    sequence (:func:`_mhsa_bwd_seq`). ``stamps`` (int64 [ctas, 5] on the
    card): run only the stamped tile program (not counted) and return
    None."""
    clips, N, C = x.shape
    dev = x.device
    bf16, f32 = torch.bfloat16, torch.float32
    g = g.to(bf16).contiguous()
    _cuda.check_cuda(g, "grad of the attention output", bf16, (clips, N, C))
    if not mhsa_fwd_kernel_fits(N, C, num_heads):
        return _mhsa_bwd_seq(g, x, wqkv, wproj, saved, num_heads)
    qkv, o, stats = saved
    M = clips * N
    cpc = clips_per_cta or mhsa_fwd_plan(clips, N, C, _card_limits(dev)[0])
    wt, tiles = mhsa_wgrad_tiles(C)
    dx = torch.empty_like(x)
    dqkv = torch.empty(M, 3 * C, device=dev, dtype=bf16)
    counters = torch.empty(tiles, device=dev, dtype=torch.int32)
    stream = _cuda.stream_ptr(dev)
    _cuda.MHSA.call("pmce_mhsa_bwd_tile", _cuda.ptr_table(
        g, _bf16_mat(wqkv, dev, C, 3 * C, "wqkv"),
        _bf16_mat(wproj, dev, C, C, "wproj"), qkv, o, stats[0], stats[1], dx,
        dqkv, counters, stamps), clips, N, C, num_heads, cpc, tiles, stream)
    if stamps is not None:
        return None
    grads = torch.empty(4 * C * C + 4 * C, device=dev, dtype=f32)
    splits = _MHSA_WGRAD_SPLITS
    partial = torch.empty(tiles * splits, wt * wt, device=dev, dtype=f32)
    vpartial = torch.empty(tiles * splits, wt, device=dev, dtype=f32)
    _cuda.MHSA.call("pmce_mhsa_wgrad", _cuda.ptr_table(
        x, o, dqkv, g, partial, vpartial, counters, grads), M, C, splits,
        stream)
    MHSA_BWD_LAUNCHES.count += 1
    return dx, grads


def mhsa_bwd_stage_split(g, x, wqkv, wproj, saved, num_heads: int,
                         clips_per_cta=None) -> dict:
    """One stamped launch of the backward's tile program on the card (not
    counted), from a saving forward's ``saved``: {stage: cycles summed over
    the CTAs} for the stages of :data:`MHSA_BWD_STAGES`, ``"ctas"`` and
    ``"clips_per_cta"``."""
    clips, N, C = x.shape
    cpc = clips_per_cta or mhsa_fwd_plan(clips, N, C,
                                         _card_limits(x.device)[0])
    ctas = -(-clips // cpc)
    stamps = torch.zeros(ctas, len(MHSA_BWD_STAGES), dtype=torch.int64,
                         device=x.device)
    with torch.no_grad():
        _mhsa_bwd_cuda(g, x, wqkv, wproj, saved, num_heads, stamps=stamps,
                       clips_per_cta=cpc)
    total = stamps.sum(0).cpu().tolist()
    return {**dict(zip(MHSA_BWD_STAGES, total)), "ctas": ctas,
            "clips_per_cta": cpc}


class _MhsaKernel(torch.autograd.Function):
    """fused_mhsa on the card: forward and backward are ``csrc/mhsa.cu``
    (the forward saves what the backward reads only when it is owed)."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, num_heads, grad_enabled):
        out, saved = _mhsa_fwd_cuda(x, wqkv, bqkv, wproj, bproj, num_heads,
                                    _owed(ctx, grad_enabled))
        ctx.num_heads = num_heads
        ctx.save_for_backward(x, wqkv, bqkv, wproj, bproj, *saved)
        return out

    @staticmethod
    def backward(ctx, g):
        x, wqkv, bqkv, wproj, bproj, *saved = ctx.saved_tensors
        dx, flat = _mhsa_bwd_cuda(g, x, wqkv, wproj, saved, ctx.num_heads)
        return (dx, *_split_grads(flat, (wqkv, bqkv, wproj, bproj)), None,
                None)


def mhsa_f32_kernel_fits(N: int, C: int, num_heads: int) -> bool:
    """The static shape test of rows 4f / 5f (csrc/mhsa_f32.cu, items of a
    clip's 16 rows on :func:`mhsa_f32_plan`'s CTAs): up to 64 tokens, C a
    multiple of 64 up to 256, head width in :data:`_HEAD_DIMS`."""
    return (N <= _MHSA_MAX_TOKENS and C % 64 == 0 and C <= 256
            and C % num_heads == 0 and C // num_heads in _HEAD_DIMS)


def _f32_params(name, *params):
    for t in params:
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: f32 tokens take f32 parameters, got "
                             f"{t.dtype} {tuple(t.shape)}")


# Rows 4f / 5f (csrc/mhsa_f32.cu): an item is a clip's 16-row block (a
# warp's tile), on a persistent grid of min(items, the card's SMs) CTAs.
_MHSA_F32_ROWS = 16


class MhsaF32Plan(NamedTuple):
    """Rows 4f / 5f's grid (both launches): ``items`` (clip, first row) in
    the order the CTAs share them, ``ctas`` CTAs (the entry points'
    argument), CTA i taking ``owned[i]`` (a contiguous share), ``waves``
    the most items a CTA takes."""
    ctas: int
    items: tuple
    owned: tuple
    waves: int


@functools.lru_cache(maxsize=64)
def mhsa_f32_plan(clips: int, N: int, sms: int | None) -> MhsaF32Plan:
    """The items of ``clips`` clips of N tokens (each clip's ceil(N / 16)
    row blocks, clip-major) over min(items, ``sms``) CTAs (``sms`` None, a
    build for the host: a CTA an item), CTA i taking the items [n i / G,
    n (i + 1) / G), as ``csrc/mhsa_f32.cu``'s kernels do."""
    if clips < 1 or not 1 <= N <= _MHSA_MAX_TOKENS:
        raise ValueError(f"mhsa_f32_plan: {clips} clips of {N} tokens")
    items = tuple((c, r) for c in range(clips)
                  for r in range(0, N, _MHSA_F32_ROWS))
    n = len(items)
    ctas = n if sms is None else max(1, min(n, sms))
    owned = tuple(items[n * i // ctas:n * (i + 1) // ctas]
                  for i in range(ctas))
    return MhsaF32Plan(ctas, items, owned, max(len(o) for o in owned))


def _mhsa_f32_resident(device) -> int | None:
    """The CTAs of rows 4f / 5f the card holds at once: one an SM (172 and
    199 KB of shared memory), as :func:`_block_f32_resident`."""
    return _block_f32_resident(device)


def _mhsa_fwd_f32_cuda(x, wqkv, bqkv, wproj, bproj, num_heads,
                       for_grad: bool):
    """Row 4f: one launch of ``pmce_mhsa_fwd_f32`` on
    :func:`mhsa_f32_plan`'s CTAs. Returns (out, saved): with ``for_grad``
    the scaled q, k, v [M, 3C] and o [M, C] (the backward's state), else
    (None, None): nothing is saved."""
    clips, N, C = x.shape
    dev, f32 = x.device, torch.float32
    _cuda.check_cuda(x, "x", f32, (clips, N, C))
    _f32_params("fused_mhsa", wqkv, bqkv, wproj, bproj)
    w = (_cuda.to_kernel(wqkv, dev, f32, (C, 3 * C), "wqkv"),
         _f32_vec(bqkv, dev, 3 * C, "bqkv"),
         _cuda.to_kernel(wproj, dev, f32, (C, C), "wproj"),
         _f32_vec(bproj, dev, C, "bproj"))
    M = clips * N
    qkv, o = ((torch.empty(M, 3 * C, device=dev, dtype=f32),
               torch.empty(M, C, device=dev, dtype=f32)) if for_grad
              else (None, None))
    out = torch.empty_like(x)
    ctas = mhsa_f32_plan(clips, N, _mhsa_f32_resident(dev)).ctas
    _cuda.MHSA_F32.call("pmce_mhsa_fwd_f32", _cuda.ptr_table(
        x, *w, out, qkv, o), clips, N, C, num_heads,
        1.0 / math.sqrt(C // num_heads), ctas, _cuda.stream_ptr(dev))
    MHSA_FWD_F32_LAUNCHES.count += 1
    return out, (qkv, o)


def _mhsa_bwd_f32_cuda(g, x, wqkv, wproj, saved, num_heads):
    """Row 5f: one call of ``pmce_mhsa_bwd_f32`` (the tile program on
    :func:`mhsa_f32_plan`'s CTAs, then the weight gradients with the bias
    gradients' fixed-order sums over the items) from the forward's saved
    qkv and o. Returns dx and (dwqkv, dbqkv, dwproj, dbproj)."""
    clips, N, C = x.shape
    dev, f32 = x.device, torch.float32
    g = g.to(f32).contiguous()
    _cuda.check_cuda(g, "grad of the attention output", f32, (clips, N, C))
    qkv, o = saved
    M = clips * N
    splits = f32_wgrad_splits(M, ((C, 3 * C), (C, C)), dev)
    plan = mhsa_f32_plan(clips, N, _mhsa_f32_resident(dev))

    def buf(*shape):
        return torch.empty(*shape, device=dev, dtype=f32)

    wqkv_k = _cuda.to_kernel(wqkv, dev, f32, (C, 3 * C), "wqkv")
    wproj_k = _cuda.to_kernel(wproj, dev, f32, (C, C), "wproj")
    # The workspace: dqkv, the items' bias partials and the weight
    # gradients' range partials.
    ws = (buf(M, 3 * C), buf(len(plan.items), 4 * C),
          buf(splits, 4 * C * C // 4096, 4096))
    dx = torch.empty_like(x)
    dwqkv, dwproj, dbias = buf(C, 3 * C), buf(C, C), buf(4 * C)
    _cuda.MHSA_F32.call("pmce_mhsa_bwd_f32", _cuda.ptr_table(
        g, x, wqkv_k, wproj_k, qkv, o, *ws, dx, dwqkv, dwproj, dbias),
        clips, N, C, num_heads, 1.0 / math.sqrt(C // num_heads), splits,
        plan.ctas, _cuda.stream_ptr(dev))
    MHSA_BWD_F32_LAUNCHES.count += 1
    return dx, (dwqkv, dbias[:3 * C], dwproj, dbias[3 * C:])


class _MhsaF32Kernel(torch.autograd.Function):
    """fused_mhsa in f32 on the card: rows 4f / 5f of ``csrc/mhsa_f32.cu``
    (the forward saves qkv and o only when a gradient is owed)."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, num_heads, grad_enabled):
        out, saved = _mhsa_fwd_f32_cuda(x, wqkv, bqkv, wproj, bproj,
                                        num_heads, _owed(ctx, grad_enabled))
        ctx.num_heads = num_heads
        ctx.save_for_backward(x, wqkv, wproj, *saved)
        return out

    @staticmethod
    def backward(ctx, g):
        x, wqkv, wproj, *saved = ctx.saved_tensors
        dx, grads = _mhsa_bwd_f32_cuda(g, x, wqkv, wproj, saved,
                                       ctx.num_heads)
        return (dx, *grads, None, None)


def fused_mhsa(x, wqkv, bqkv, wproj, bproj, num_heads: int):
    """Multi-head self-attention with its projections (see
    :func:`mhsa_plain`), with its gradient. CPU tensors run the plain
    version; CUDA tensors the kernels of ``csrc/mhsa.cu`` forward and
    backward in bf16 (any token count: the forward's and the backward's
    tile programs inside :func:`mhsa_fwd_kernel_fits`, their launch
    sequences outside; widths :func:`attention_kernel_fits` refuses raise)
    and those of ``csrc/mhsa_f32.cu`` in f32 (rows 4f / 5f; shapes outside
    :func:`mhsa_f32_kernel_fits` raise naming ROADMAP.md B3)."""
    if not _on_card(x, "fused_mhsa"):
        return mhsa_plain(x, wqkv, bqkv, wproj, bproj, num_heads)
    N, C = x.shape[1:]
    _attention_require("fused_mhsa", C, num_heads)
    if x.dtype == torch.float32:
        if not mhsa_f32_kernel_fits(N, C, num_heads):
            raise NotImplementedError(
                f"fused_mhsa: the f32 kernel (csrc/mhsa_f32.cu) is built for "
                f"up to {_MHSA_MAX_TOKENS} tokens and C <= 256, not N={N}, "
                f"C={C}, {num_heads} heads (the JAX kernel takes it); "
                "widening it is queued in ROADMAP.md B3")
        return _MhsaF32Kernel.apply(x.contiguous(), wqkv, bqkv, wproj,
                                    bproj, num_heads, torch.is_grad_enabled())
    return _MhsaKernel.apply(x.contiguous(), wqkv, bqkv, wproj, bproj,
                             num_heads, torch.is_grad_enabled())


class _AdaWeights(NamedTuple):
    """The AdaLN block's matrices as its kernels take them: bf16 [in, out]
    on the parameters' own storage where they are bf16 already."""
    wqkv: torch.Tensor
    wproj: torch.Tensor
    w1: torch.Tensor
    w2: torch.Tensor


def _ada_weights(params, dev) -> _AdaWeights:
    wqkv, _, wproj, _, w1, _, w2, _ = params
    C, hid = wqkv.shape[0], w1.shape[1]
    return _AdaWeights(_bf16_mat(wqkv, dev, C, 3 * C, "wqkv"),
                       _bf16_mat(wproj, dev, C, C, "wproj"),
                       _bf16_mat(w1, dev, C, hid, "w_fc1"),
                       _bf16_mat(w2, dev, hid, C, "w_fc2"))


# The forward's tile programs (csrc/ada_block.cu): launch A (AdaLN1, qkv)
# and launch B (attention and the block's tail), 4 ordinary CTAs a clip;
# their stamped stages.
ADA_FWD_CTAS = 4
ADA_FWD_STAGES = ("A loads + norm1", "A qkv", "B loads",
                  "B attention max, sum", "B attention P·V",
                  "B proj, norm2, MLP")
_ADA_FWD_A_STAGES = 2


def ada_fwd_kernel_fits(N: int, C: int, hid: int) -> bool:
    """The static shape test of the AdaLN block's forward tile programs, on
    top of :func:`attention_kernel_fits`: the backward's
    (:func:`ada_bwd_kernel_fits`: C = 64, hid up to 256, up to 512 tokens,
    four CTAs of at most 128 rows a clip). Other shapes take the launch
    sequence (``pmce_ada_block_fwd``)."""
    return ada_bwd_kernel_fits(N, C, hid)


def _ada_fwd_cuda(x, gb, masks, params, num_heads, eps,
                  keep_branches: bool = False, w=None, for_grad: bool = True,
                  stamps=None):
    """The forward; returns (out, saved). Inside :func:`ada_fwd_kernel_fits`
    two launches (``pmce_ada_fwd_tile``: A, then B), which write the state
    the backward reads only with ``for_grad`` (else ``saved`` holds None
    there); outside it the launch sequence (``pmce_ada_block_fwd``), which
    writes it always. ``saved`` ends with the branches a and mo (f32) when
    ``keep_branches`` (the mask gradients read them), else None twice.
    ``w``: the :class:`_AdaWeights` already made, or None. ``stamps``
    (int64, ``B * 4 * 6`` values on the card): the stamped programs, not
    counted."""
    B, N, C = x.shape
    wqkv, bqkv, wproj, bproj, w1, bb1, w2, bb2 = params
    hid = w1.shape[1]
    _attn_checks("ada_block", x)
    _cuda.check_cuda(x, "x", torch.bfloat16, (B, N, C))
    dev, M = x.device, B * N
    bf16, f32 = torch.bfloat16, torch.float32
    w = w or _ada_weights(params, dev)
    tile = ada_fwd_kernel_fits(N, C, hid)
    save = for_grad or not tile

    def buf(cols, dt, wanted=True):
        return torch.empty(M, cols, device=dev, dtype=dt) if wanted else None

    # qkv: launch B's keys and values whether saved or not.
    qkv = buf(3 * C, bf16)
    h1, o, x1, h2 = (buf(C, bf16, save), buf(C, bf16, save),
                     buf(C, f32, save), buf(C, bf16, save))
    hh, ge = buf(hid, f32, save), buf(hid, bf16, save)
    a, mo = buf(C, f32, keep_branches), buf(C, f32, keep_branches)
    stats = (torch.empty(2, B * num_heads * N, device=dev, dtype=f32)
             if save else None)
    sm, sl = (stats[0], stats[1]) if save else (None, None)
    out = torch.empty_like(x)
    rows = [_f32_rows(t, dev, B, C, n)
            for t, n in zip(gb, ("gamma1", "beta1", "gamma2", "beta2"))]
    m1, m2 = (_mask_rows(m, B, dev) for m in masks)
    vecs = (_f32_vec(bqkv, dev, 3 * C, "bqkv"),
            _f32_vec(bproj, dev, C, "bproj"),
            _f32_vec(bb1, dev, hid, "b_fc1"), _f32_vec(bb2, dev, C, "b_fc2"))
    stream = _cuda.stream_ptr(dev)
    if tile:
        _cuda.ADA.call("pmce_ada_fwd_tile", _cuda.ptr_table(
            x, *rows, m1, m2, *w, *vecs, out, qkv, h1, o, sm, sl, x1, h2, hh,
            ge, a, mo, stamps), B, N, hid, num_heads, eps, stream)
        if stamps is None:
            ADA_FWD_LAUNCHES.count += 1
    else:
        _cuda.ADA.call("pmce_ada_block_fwd", _cuda.ptr_table(
            x, *rows, m1, m2, w.wqkv, vecs[0], w.wproj, vecs[1], w.w1,
            vecs[2], w.w2, vecs[3], h1, qkv, o, sm, sl, x1, h2, hh, ge, out,
            a, mo), B, N, C, hid, num_heads, eps, stream)
        ADA_FWD_SEQ_LAUNCHES.count += 1
    return out, (rows[0], rows[2], m1, m2, h1, qkv if save else None, o,
                 stats, x1, h2, hh, ge, a, mo)


def ada_fwd_stage_split(x, gb, params, num_heads: int, eps: float = 1e-6,
                        branch_masks=None) -> dict:
    """One stamped run of the forward's two tile programs on the card (not
    counted), saving as for a gradient: {stage: cycles summed over the
    CTAs} for the stages of :data:`ADA_FWD_STAGES` (launch A's, then
    B's), and ``"ctas"`` (of each launch)."""
    masks = branch_masks if branch_masks is not None else (None, None)
    ctas = x.shape[0] * ADA_FWD_CTAS
    stamps = torch.zeros(ctas * len(ADA_FWD_STAGES), dtype=torch.int64,
                         device=x.device)
    with torch.no_grad():
        _ada_fwd_cuda(x, gb, masks, params, num_heads, eps, stamps=stamps)
    na = ctas * _ADA_FWD_A_STAGES
    total = (stamps[:na].view(ctas, -1).sum(0).cpu().tolist()
             + stamps[na:].view(ctas, -1).sum(0).cpu().tolist())
    return {**dict(zip(ADA_FWD_STAGES, total)), "ctas": ctas}


def ada_fwd_waves(B: int) -> tuple[int, int]:
    """The CTAs of the forward's launch B the card holds at once and the
    waves a batch of ``B`` clips (4 CTAs each) takes."""
    resident = int(_cuda.ADA.query("pmce_ada_fwd_resident"))
    if resident <= 0:
        raise _cuda.KernelError(f"pmce_ada_fwd_resident: CUDA error "
                                f"{-resident}")
    return resident, -(-B * ADA_FWD_CTAS // resident)


# The backward's tile program (csrc/ada_block.cu): a cluster of 4 CTAs a
# clip, each owning a quarter of its rows (at most 128), hid up to 256; the
# weight launch's K splits, and the tile program's stamped stages.
ADA_BWD_CLUSTER = 4
_ADA_BWD_ROWS, _ADA_BWD_HID = 4 * 128, 256
_ADA_WGRAD_SPLITS = 8
ADA_BWD_STAGES = ("loads", "MLPᵀ", "norm2", "projᵀ + D", "attention dq",
                  "cluster barrier", "attention dk dv", "qkvᵀ + norm1",
                  "cluster sums")


def ada_bwd_kernel_fits(N: int, C: int, hid: int) -> bool:
    """The static shape test of the AdaLN block's backward tile program, on
    top of :func:`attention_kernel_fits`: C = 64, hid up to 256, up to 512
    tokens (four CTAs of 128 rows). Other shapes take the launch sequence
    (``pmce_ada_block_bwd``)."""
    return C == 64 and hid <= _ADA_BWD_HID and N <= _ADA_BWD_ROWS


def _ada_bwd_seq(g, x, params, saved, num_heads, eps, need_masks):
    """The backward's launch sequence (the shapes outside the tile
    program's gate): transposed weight copies, the MLP half, the mask
    gradients (a block per clip), the attention and AdaLN backwards, split-K
    weight partials."""
    B, N, C = x.shape
    wqkv, _, wproj, _, w1, _, w2, _ = params
    hid = w1.shape[1]
    dev = x.device
    g1, g2, m1, m2, h1, qkv, o, stats, x1, h2, hh, ge, a, mo = saved
    dx = torch.empty_like(x)
    dgb = torch.empty(4, B, C, device=dev, dtype=torch.float32)
    dm1, dm2 = ((torch.empty(B, device=dev, dtype=torch.float32)
                 for _ in range(2)) if need_masks else (None, None))
    grads = torch.empty(sum(t.numel() for t in params), device=dev,
                        dtype=torch.float32)
    ws = _workspace(_cuda.ADA, "pmce_ada_block_workspace", dev, B, N, C, hid,
                    num_heads)
    _cuda.ADA.call("pmce_ada_block_bwd", _cuda.ptr_table(
        x, g, g1, g2, m1, m2, _bf16_mat_t(wqkv, dev, 3 * C, C, "wqkvᵀ"),
        _bf16_mat_t(wproj, dev, C, C, "wprojᵀ"),
        _bf16_mat_t(w1, dev, hid, C, "w_fc1ᵀ"),
        _bf16_mat_t(w2, dev, C, hid, "w_fc2ᵀ"), h1, qkv, o, stats[0],
        stats[1], x1, h2, hh, ge, dx, dgb, grads, ws,
        a if need_masks else None, mo if need_masks else None, dm1, dm2),
        B, N, C, hid, num_heads, eps, _cuda.stream_ptr(dev))
    ADA_BWD_SEQ_LAUNCHES.count += 1
    return dx, dgb, grads, (dm1, dm2)


def _ada_bwd_cuda(gout, x, params, saved, num_heads, eps,
                  need_masks: bool = False, stamps=None, w=None):
    """The backward of ``csrc/ada_block.cu``. Inside
    :func:`ada_bwd_kernel_fits`, two launches: the tile program (a cluster
    of 4 CTAs a clip: the activation-gradient chain, dx, the per-clip AdaLN
    vectors' gradients, the mask gradients when ``need_masks``, and the
    weight products' bf16 operands), then the four weight gradients and
    the four bias gradients in one launch; the weights are read in their
    [in, out] layout (no transposed copies). Outside it, the launch
    sequence (:func:`_ada_bwd_seq`). Returns dx, dgb [4, B, C], the flat
    parameter gradients and (dm1, dm2) (None without ``need_masks``).
    ``stamps`` (int64 [B * 4, 9] on the card): run only the stamped tile
    program (not counted) and return None. ``w``: the forward's
    :class:`_AdaWeights` (not cast again), or None."""
    B, N, C = x.shape
    hid = params[4].shape[1]
    dev = x.device
    bf16, f32 = torch.bfloat16, torch.float32
    g = gout.to(bf16).contiguous()
    _cuda.check_cuda(g, "grad of the block output", bf16, (B, N, C))
    g1, g2, m1, m2, h1, qkv, o, stats, x1, h2, hh, ge, a, mo = saved
    if need_masks and (a is None or mo is None):
        raise ValueError("ada_block backward: the mask gradients need the "
                         "forward's branches (keep_branches)")
    if not ada_bwd_kernel_fits(N, C, hid):
        return _ada_bwd_seq(g, x, params, saved, num_heads, eps, need_masks)
    w = w or _ada_weights(params, dev)
    M = B * N

    def buf(cols, dt=bf16):
        return torch.empty(M, cols, device=dev, dtype=dt)

    dx = torch.empty_like(x)
    m2g, dhh, da, dqkv, dout = (buf(C), buf(hid), buf(C), buf(3 * C),
                                buf(C))
    dsum = torch.empty(B * num_heads * N, device=dev, dtype=f32)
    dgb = torch.empty(4, B, C, device=dev, dtype=f32)
    dm1, dm2 = ((torch.empty(B, device=dev, dtype=f32) for _ in range(2))
                if need_masks else (None, None))
    tiles = 4 + 2 * (hid // 64)   # the weight launch's 64 x 64 tiles
    counters = torch.empty(tiles, device=dev, dtype=torch.int32)
    stream = _cuda.stream_ptr(dev)
    _cuda.ADA.call("pmce_ada_bwd_tile", _cuda.ptr_table(
        x, g, g1, g2, m1, m2, w.wqkv, w.wproj, w.w1, w.w2, qkv, o, stats[0],
        stats[1], x1, hh, a if need_masks else None,
        mo if need_masks else None, dx, m2g, dhh, da, dqkv, dout, dsum, dgb,
        dm1, dm2, counters, stamps), B, N, hid, num_heads, eps, stream)
    if stamps is not None:
        return None
    grads = torch.empty(sum(t.numel() for t in params), device=dev,
                        dtype=f32)
    partial = torch.empty(tiles * _ADA_WGRAD_SPLITS, 64 * 64, device=dev,
                          dtype=f32)
    vpartial = torch.empty(tiles * _ADA_WGRAD_SPLITS, 64, device=dev,
                           dtype=f32)
    _cuda.ADA.call("pmce_ada_wgrad", _cuda.ptr_table(
        h1, o, h2, ge, dqkv, da, dhh, m2g, partial, vpartial, counters,
        grads), M, hid, _ADA_WGRAD_SPLITS, stream)
    ADA_BWD_LAUNCHES.count += 1
    return dx, dgb, grads, (dm1, dm2)


def ada_bwd_stage_split(gout, x, params, saved, num_heads: int,
                        eps: float = 1e-6) -> dict:
    """One stamped launch of the backward's tile program on the card (not
    counted), from a forward's ``saved``: {stage: cycles summed over the
    CTAs} for the stages of :data:`ADA_BWD_STAGES`, and ``"ctas"``."""
    ctas = x.shape[0] * ADA_BWD_CLUSTER
    stamps = torch.zeros(ctas, len(ADA_BWD_STAGES), dtype=torch.int64,
                         device=x.device)
    with torch.no_grad():
        _ada_bwd_cuda(gout, x, params, saved, num_heads, eps, stamps=stamps)
    total = stamps.sum(0).cpu().tolist()
    return {**dict(zip(ADA_BWD_STAGES, total)), "ctas": ctas}


class _AdaBlockKernel(torch.autograd.Function):
    """ada_block on the card: forward and backward are
    ``csrc/ada_block.cu`` (the forward: its two tile programs, saving only
    when a gradient is owed; the backward: its tile program and its weight-
    gradient launch; each the launch sequence outside its program's gate).
    The branch masks get JAX's gradients (per-clip sums) where autograd
    asks for them; the forward then keeps the branches they need."""

    @staticmethod
    def forward(ctx, x, gamma1, beta1, gamma2, beta2, m1, m2, num_heads,
                eps, grad_enabled, *params):
        keep = _owed(ctx, grad_enabled, 5, 6)
        w = _ada_weights(params, x.device)
        out, saved = _ada_fwd_cuda(x, (gamma1, beta1, gamma2, beta2),
                                   (m1, m2), params, num_heads, eps, keep, w,
                                   _owed(ctx, grad_enabled))
        ctx.cfg = (num_heads, eps, len(params))
        ctx.weights = w
        ctx.gb = tuple((t.shape, t.dtype)
                       for t in (gamma1, beta1, gamma2, beta2))
        ctx.masks = tuple(None if m is None else (m.shape, m.dtype)
                          for m in (m1, m2))
        ctx.save_for_backward(x, *params, *saved)
        return out

    @staticmethod
    def backward(ctx, gout):
        num_heads, eps, n = ctx.cfg
        x, *rest = ctx.saved_tensors
        params, saved = rest[:n], rest[n:]
        need_masks = ctx.needs_input_grad[5] or ctx.needs_input_grad[6]
        dx, dgb, flat, dms = _ada_bwd_cuda(gout, x, params, saved, num_heads,
                                           eps, need_masks, w=ctx.weights)
        dgb = tuple(d.reshape(s).to(t) for d, (s, t) in zip(dgb, ctx.gb))
        dm = [None if m is None or not need_masks else
              dms[i].reshape(m[0]).to(m[1]) for i, m in enumerate(ctx.masks)]
        return (dx, *dgb, *dm, None, None, None,
                *_split_grads(flat, params))


def ada_block(x, gamma1, beta1, gamma2, beta2, params, num_heads: int,
              eps: float = 1e-6, branch_masks=None):
    """The AdaLN self-attention block with its gradient (see
    :func:`ada_block_plain`). CPU tensors run the plain version; CUDA
    tensors the kernels of ``csrc/ada_block.cu`` forward and backward in
    bf16 (any token count: the forward's two tile programs and the
    backward's tile program inside :func:`ada_fwd_kernel_fits` /
    :func:`ada_bwd_kernel_fits`, their launch sequences outside; widths
    :func:`attention_kernel_fits` refuses raise) and those of
    ``csrc/ada_f32.cu`` in f32 (rows 8f / 9f: with no gradient owed one
    forward call, otherwise :class:`_AdaF32Kernel`; shapes outside
    :func:`ada_f32_kernel_fits` raise naming ROADMAP.md B3). Branch masks
    that require grad get their gradients."""
    if not _on_card(x, "ada_block"):
        return ada_block_plain(x, gamma1, beta1, gamma2, beta2, params,
                               num_heads, eps, branch_masks)
    f32 = _attn_checks("ada_block", x)
    B, N, C = x.shape
    hid = params[4].shape[1]
    _attention_require("ada_block", C, num_heads, hid)
    m1, m2 = branch_masks if branch_masks is not None else (None, None)
    if f32:
        if not ada_f32_kernel_fits(N, C, num_heads, hid):
            raise NotImplementedError(
                f"ada_block: the f32 kernel (csrc/ada_f32.cu) is built for C "
                f"= 64, heads of 8, 16 or 32 and hid a multiple of 64 up to "
                f"{_F32_DEC_HID} (any number of tokens), not N={N}, C={C}, "
                f"{num_heads} heads, hid={hid} (the JAX kernel takes it); "
                "widening it is queued in ROADMAP.md B3")
        gb = (gamma1, beta1, gamma2, beta2)
        if not _needs_grad(x, *gb, m1, m2, *params):
            return _ada_fwd_f32_cuda(x.contiguous(), gb, (m1, m2), params,
                                     num_heads, eps)
        return _AdaF32Kernel.apply(x.contiguous(), *gb, m1, m2, num_heads,
                                   eps, *params)
    return _AdaBlockKernel.apply(x.contiguous(), gamma1, beta1, gamma2,
                                 beta2, m1, m2, num_heads, eps,
                                 torch.is_grad_enabled(), *params)


class _CaWeights(NamedTuple):
    """The CA block's matrices as its kernels take them: bf16 [in, out] on
    the parameters' own storage where they are bf16 already."""
    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wproj: torch.Tensor
    w1: torch.Tensor
    w2: torch.Tensor


def _ca_weights(params, dev) -> _CaWeights:
    (wq, _, wk, _, wv, _, wproj, _, w1, _, w2, _) = params
    C, hid = wq.shape[0], w1.shape[1]
    return _CaWeights(
        *(_bf16_mat(w, dev, C, C, n) for w, n in ((wq, "wq"), (wk, "wk"),
                                                    (wv, "wv"),
                                                    (wproj, "wproj"))),
        _bf16_mat(w1, dev, C, hid, "w_fc1"), _bf16_mat(w2, dev, hid, C,
                                                       "w_fc2"))


# The CA block's tile programs (csrc/ca_block.cu), forward and backward: a
# cluster of 4 CTAs a clip, the long side split in quarters, each walked in
# passes of up to 128 rows (a long side of any length), the short side
# whole in each (at most 64 rows), hid up to 256; the backward's weight
# launch's K splits, and the programs' stamped stages.
CA_BWD_CLUSTER = 4
_CA_BWD_SHORT, _CA_BWD_HID, _CA_PASS_ROWS = 64, 256, 128
_CA_WGRAD_SPLITS = 8
CA_BWD_STAGES = ("loads", "MLPᵀ", "norm2", "projᵀ", "attention dq",
                 "attention dk dv", "q/k/v projᵀ + norms", "cluster sums")
CA_FWD_STAGES = ("loads", "k/v norms + proj", "q norm + proj", "attention",
                 "cluster merge", "proj, norm2, MLP")


def _ca_fwd_cuda(xs, gammas, betas, masks, params, num_heads, eps,
                 keep_branches: bool = False, w=None, for_grad: bool = True,
                 stamps=None):
    """The forward; returns (out, saved). Inside :func:`ca_bwd_kernel_fits`
    one launch of the tile program (``pmce_ca_fwd_tile``), which writes the
    state the backward reads only with ``for_grad`` (else ``saved`` holds
    None there); outside it the launch sequence (``pmce_ca_block_fwd``),
    which writes it always. ``saved`` ends with the branches a and mo (f32)
    when ``keep_branches`` (the mask gradients read them), else None twice.
    ``w``: the :class:`_CaWeights` already made, or None. ``stamps`` (int64
    [B * 4, 6] on the card): the stamped tile program, not counted."""
    xq, xk, xv = xs
    B, Nq, C = xq.shape
    Nk = xk.shape[1]
    (wq, bq, wk, bk, wv, bv, wproj, bproj, w1, bb1, w2, bb2) = params
    hid = w1.shape[1]
    _attn_checks("ca_block", xq)
    _cuda.check_cuda(xq, "xq", torch.bfloat16, (B, Nq, C))
    _cuda.check_cuda(xk, "xk", torch.bfloat16, (B, Nk, C))
    _cuda.check_cuda(xv, "xv", torch.bfloat16, (B, Nk, C))
    dev = xq.device
    bf16, f32 = torch.bfloat16, torch.float32
    w = w or _ca_weights(params, dev)
    tile = ca_bwd_kernel_fits(Nq, Nk, C, hid)
    save = for_grad or not tile

    def buf(rows, cols, dt, wanted=True):
        return torch.empty(rows, cols, device=dev, dtype=dt) if wanted \
            else None

    Mq, Mk = B * Nq, B * Nk
    nq, nk, nv = (buf(Mq, C, bf16, save), buf(Mk, C, bf16, save),
                  buf(Mk, C, bf16, save))
    q, k, v = (buf(Mq, C, bf16, save), buf(Mk, C, bf16, save),
               buf(Mk, C, bf16, save))
    o, x1, h2 = (buf(Mq, C, bf16, save), buf(Mq, C, f32, save),
                 buf(Mq, C, bf16, save))
    hh, ge = buf(Mq, hid, f32, save), buf(Mq, hid, bf16, save)
    a, mo = buf(Mq, C, f32, keep_branches), buf(Mq, C, f32, keep_branches)
    stats = buf(2, B * num_heads * Nq, f32, save)
    sm, sl = (stats[0], stats[1]) if save else (None, None)
    out = torch.empty_like(xq)
    conds = []
    for i, name in enumerate(("q", "k", "v", "2")):
        conds += [_f32_rows(gammas[i], dev, B, C, f"gamma {name}"),
                  _f32_rows(betas[i], dev, B, C, f"beta {name}")]
    m1, m2 = (_mask_rows(m, B, dev) for m in masks)
    vecs = [_f32_vec(b, dev, n, name)
            for b, n, name in ((bq, C, "bq"), (bk, C, "bk"), (bv, C, "bv"),
                               (bproj, C, "bproj"), (bb1, hid, "b_fc1"),
                               (bb2, C, "b_fc2"))]
    stream = _cuda.stream_ptr(dev)
    if tile:
        _cuda.CA.call("pmce_ca_fwd_tile", _cuda.ptr_table(
            xq, xk, xv, *conds, m1, m2, *w, *vecs, out, nq, nk, nv, q, k, v,
            o, sm, sl, x1, h2, hh, ge, a, mo, stamps),
            B, Nq, Nk, hid, num_heads, eps, stream)
        if stamps is None:
            CA_FWD_LAUNCHES.count += 1
    else:
        mats = (w.wq, w.wk, w.wv, w.wproj)
        _cuda.CA.call("pmce_ca_block_fwd", _cuda.ptr_table(
            xq, xk, xv, *conds, m1, m2,
            *(t for pair in zip(mats, vecs) for t in pair), w.w1, vecs[4],
            w.w2, vecs[5], nq, nk, nv, q, k, v, o, sm, sl, x1, h2, hh, ge,
            out, a, mo), B, Nq, Nk, C, hid, num_heads, eps, stream)
        CA_FWD_SEQ_LAUNCHES.count += 1
    return out, (*conds[0::2], m1, m2, nq, nk, nv, q, k, v, o, stats, x1,
                 h2, hh, ge, a, mo)


def ca_fwd_stage_split(xs, gammas, betas, params, num_heads: int,
                       eps: float = 1e-6, branch_masks=None) -> dict:
    """One stamped launch of the forward's tile program on the card (not
    counted), saving as for a gradient: {stage: cycles summed over the
    CTAs} for the stages of :data:`CA_FWD_STAGES`, and ``"ctas"``."""
    masks = branch_masks if branch_masks is not None else (None, None)
    ctas = xs[0].shape[0] * CA_BWD_CLUSTER
    stamps = torch.zeros(ctas, len(CA_FWD_STAGES), dtype=torch.int64,
                         device=xs[0].device)
    with torch.no_grad():
        _ca_fwd_cuda(xs, gammas, betas, masks, params, num_heads, eps,
                     stamps=stamps)
    total = stamps.sum(0).cpu().tolist()
    return {**dict(zip(CA_FWD_STAGES, total)), "ctas": ctas}


def ca_bwd_kernel_fits(Nq: int, Nk: int, C: int, hid: int) -> bool:
    """The static shape test of the CA block's tile programs, forward and
    backward, on top of :func:`attention_kernel_fits`: C = 64, hid up to
    256 and the short side (the smaller of Nq, Nk) up to 64 rows; the long
    side of any length (a CTA's quarter of it in passes of 128 rows: one up
    to 512, four at the 1723-vertex mesh). The forward takes other shapes
    through its launch sequence; the backward refuses them."""
    return (C == 64 and hid <= _CA_BWD_HID
            and min(Nq, Nk) <= _CA_BWD_SHORT)


def ca_bwd_passes(Nq: int, Nk: int) -> int:
    """The passes of up to 128 long-side rows a CTA of the CA tile programs
    walks (``csrc/adaln_tile.cuh``'s ``rank_rows``: a cluster rank's quarter
    of the long side in whole 16-row blocks)."""
    quarter = -(-max(Nq, Nk) // CA_BWD_CLUSTER)
    per = -(-quarter // 16) * 16
    return max(1, -(-per // _CA_PASS_ROWS))


def ca_bwd_workspace(B: int, Nq: int, Nk: int) -> int:
    """Floats of the backward tile program's workspace (``csrc/ca_block.cu``'s
    ``ca_bwd_acc_floats``): with the queries split over more than one pass
    a CTA (Nq over 512, Nq >= Nk), each CTA's dk | dv sums between its
    passes, [B * 4, 64, 128]; else 0 (no workspace)."""
    if Nq >= Nk and ca_bwd_passes(Nq, Nk) > 1:
        return B * CA_BWD_CLUSTER * _CA_BWD_SHORT * 2 * 64
    return 0


def _ca_bwd_cuda(gout, xs, params, saved, num_heads, eps,
                 need_masks: bool = False, stamps=None, w=None):
    """The backward in two launches of ``csrc/ca_block.cu``: the tile
    program (a cluster of 4 CTAs a clip, :func:`ca_bwd_passes` passes a CTA
    with :func:`ca_bwd_workspace`'s floats: the activation-gradient chain,
    dxq, dxk, dxv, the per-clip AdaLN vectors' gradients, the mask
    gradients when ``need_masks``, and the weight products' bf16 operands),
    then the six weight gradients and the six bias gradients in one
    launch. The weights are read in their [in, out] layout: no transposed
    copies. Returns (dxq, dxk, dxv), dgb [8, B, C], the flat parameter
    gradients and (dm1, dm2) (None without ``need_masks``). ``stamps``
    (int64 [B * 4, 8] on the card): run only the stamped tile program (not
    counted) and return None. ``w``: the forward's :class:`_CaWeights` (not
    cast again), or None."""
    xq, xk, xv = xs
    B, Nq, C = xq.shape
    Nk = xk.shape[1]
    hid = params[8].shape[1]
    dev = xq.device
    bf16, f32 = torch.bfloat16, torch.float32
    w = w or _ca_weights(params, dev)
    g = gout.to(bf16).contiguous()
    _cuda.check_cuda(g, "grad of the block output", bf16, (B, Nq, C))
    (gq, gk, gv, g2, m1, m2, nq, nk, nv, q, k, v, o, stats, x1, h2, hh, ge,
     a, mo) = saved
    if need_masks and (a is None or mo is None):
        raise ValueError("ca_block backward: the mask gradients need the "
                         "forward's branches (keep_branches)")
    Mq, Mk = B * Nq, B * Nk

    def buf(rows, cols):
        return torch.empty(rows, cols, device=dev, dtype=bf16)

    dxq, dxk, dxv = (torch.empty_like(t) for t in xs)
    m2g, dhh, da, dq = buf(Mq, C), buf(Mq, hid), buf(Mq, C), buf(Mq, C)
    dk, dv = buf(Mk, C), buf(Mk, C)
    dgb = torch.empty(8, B, C, device=dev, dtype=f32)
    dm1, dm2 = ((torch.empty(B, device=dev, dtype=f32) for _ in range(2))
                if need_masks else (None, None))
    tiles = 4 + 2 * (hid // 64)   # cab::wgrad_tiles: 64 x 64 output tiles
    counters = torch.empty(tiles, device=dev, dtype=torch.int32)
    stream = _cuda.stream_ptr(dev)
    n_acc = ca_bwd_workspace(B, Nq, Nk)
    acc = torch.empty(n_acc, device=dev, dtype=f32) if n_acc else None
    _cuda.CA.call("pmce_ca_bwd_tile", _cuda.ptr_table(
        xq, xk, xv, g, gq, gk, gv, g2, m1, m2, w.wq, w.wk, w.wv, w.wproj,
        w.w1, w.w2, q, k, v, o, stats[0], stats[1], x1, hh,
        a if need_masks else None, mo if need_masks else None, dxq, dxk, dxv,
        m2g, dhh, da, dq, dk, dv, dgb, dm1, dm2, counters, stamps, acc),
        B, Nq, Nk, hid, num_heads, eps, stream)
    if stamps is not None:
        return None
    grads = torch.empty(sum(t.numel() for t in params), device=dev,
                        dtype=f32)
    partial = torch.empty(tiles * _CA_WGRAD_SPLITS, 64 * 64, device=dev,
                          dtype=f32)
    vpartial = torch.empty(tiles * _CA_WGRAD_SPLITS, 64, device=dev,
                           dtype=f32)
    _cuda.CA.call("pmce_ca_wgrad", _cuda.ptr_table(
        nq, nk, nv, o, h2, ge, dq, dk, dv, da, dhh, m2g, partial, vpartial,
        counters, grads), B, Nq, Nk, hid, _CA_WGRAD_SPLITS, stream)
    CA_BWD_LAUNCHES.count += 1
    return (dxq, dxk, dxv), dgb, grads, (dm1, dm2)


def ca_bwd_stage_split(gout, xs, params, saved, num_heads: int,
                       eps: float = 1e-6) -> dict:
    """One stamped launch of the backward's tile program on the card (not
    counted), from a forward's ``saved``: {stage: cycles summed over the
    CTAs} for the stages of :data:`CA_BWD_STAGES`, and ``"ctas"``."""
    ctas = xs[0].shape[0] * CA_BWD_CLUSTER
    stamps = torch.zeros(ctas, len(CA_BWD_STAGES), dtype=torch.int64,
                         device=xs[0].device)
    with torch.no_grad():
        _ca_bwd_cuda(gout, xs, params, saved, num_heads, eps,
                     stamps=stamps)
    total = stamps.sum(0).cpu().tolist()
    return {**dict(zip(CA_BWD_STAGES, total)), "ctas": ctas}


class _CaBlockKernel(torch.autograd.Function):
    """ca_block on the card: forward and backward are ``csrc/ca_block.cu``
    (the backward: its tile program and its weight-gradient launch). The
    branch masks get JAX's gradients (per-clip sums) where autograd asks
    for them; the forward then keeps the branches they need."""

    @staticmethod
    def forward(ctx, xq, xk, xv, m1, m2, num_heads, eps, grad_enabled,
                *rest):
        gammas, betas, params = rest[:4], rest[4:8], rest[8:]
        keep = _owed(ctx, grad_enabled, 3, 4)
        w = _ca_weights(params, xq.device)
        out, saved = _ca_fwd_cuda((xq, xk, xv), gammas, betas, (m1, m2),
                                  params, num_heads, eps, keep, w,
                                  _owed(ctx, grad_enabled))
        ctx.cfg = (num_heads, eps)
        ctx.weights = w
        # Per-clip vectors' gradients come back in the order gq, bq, gk,
        # bk, gv, bv, g2, b2.
        ctx.gb = tuple((t.shape, t.dtype) for pair in zip(gammas, betas)
                       for t in pair)
        ctx.masks = tuple(None if m is None else (m.shape, m.dtype)
                          for m in (m1, m2))
        ctx.save_for_backward(xq, xk, xv, *params, *saved)
        return out

    @staticmethod
    def backward(ctx, gout):
        num_heads, eps = ctx.cfg
        xq, xk, xv, *rest = ctx.saved_tensors
        params, saved = rest[:12], rest[12:]
        need_masks = ctx.needs_input_grad[3] or ctx.needs_input_grad[4]
        dxs, dgb, flat, dms = _ca_bwd_cuda(gout, (xq, xk, xv), params, saved,
                                           num_heads, eps, need_masks,
                                           w=ctx.weights)
        d = [dgb[i].reshape(s).to(t) for i, (s, t) in enumerate(ctx.gb)]
        dm = [None if m is None or not need_masks else
              dms[i].reshape(m[0]).to(m[1]) for i, m in enumerate(ctx.masks)]
        # Back to the inputs' order: gammas (q, k, v, 2), then betas.
        dconds = tuple(d[0::2]) + tuple(d[1::2])
        return (*dxs, *dm, None, None, None, *dconds,
                *_split_grads(flat, params))


def ca_block(xq, xk, xv, gammas, betas, params, num_heads: int,
             eps: float = 1e-6, branch_masks=None):
    """The AdaLN cross-attention block with its gradient (see
    :func:`ca_block_plain`). CPU tensors run the plain version; CUDA
    tensors the kernels of ``csrc/ca_block.cu`` in bf16 (widths
    :func:`attention_kernel_fits` refuses raise): the forward's tile
    program inside :func:`ca_bwd_kernel_fits`, its launch sequence for any
    other Nq and Nk; the backward's tile program, whose gate a gradient
    must meet. In f32 those of ``csrc/ca_f32.cu`` (rows 10f / 11f: with no
    gradient owed one forward call, otherwise :class:`_CaF32Kernel`;
    shapes outside :func:`ca_f32_kernel_fits` raise naming ROADMAP.md
    B3)."""
    if not _on_card(xq, "ca_block"):
        return ca_block_plain(xq, xk, xv, gammas, betas, params, num_heads,
                              eps, branch_masks)
    C, hid = xq.shape[-1], params[8].shape[1]
    f32 = _attn_checks("ca_block", xq)
    _attention_require("ca_block", C, num_heads, hid)
    m1, m2 = branch_masks if branch_masks is not None else (None, None)
    grad = _needs_grad(xq, xk, xv, m1, m2, *gammas, *betas, *params)
    if f32:
        Nq, Nk = xq.shape[1], xk.shape[1]
        if not ca_f32_kernel_fits(Nq, Nk, C, num_heads, hid):
            raise NotImplementedError(
                f"ca_block: the f32 kernel (csrc/ca_f32.cu) is built for C = "
                f"64, heads of 8, 16 or 32, hid a multiple of 64 up to "
                f"{_F32_DEC_HID} and up to {_F32_DEC_SHORT} rows on the "
                f"short side (the long side of any length), not Nq={Nq}, "
                f"Nk={Nk}, C={C}, {num_heads} heads, hid={hid} (the JAX "
                "kernel takes it); widening it is queued in ROADMAP.md B3")
        xs = (xq.contiguous(), xk.contiguous(), xv.contiguous())
        if not grad:
            return _ca_fwd_f32_cuda(xs, gammas, betas, (m1, m2), params,
                                    num_heads, eps)
        return _CaF32Kernel.apply(*xs, m1, m2, num_heads, eps, *gammas,
                                  *betas, *params)
    if grad:
        require_kernel(ca_bwd_kernel_fits(xq.shape[1], xk.shape[1], C, hid),
                       "ca_block backward",
                       f"Nq={xq.shape[1]}, Nk={xk.shape[1]}, C={C}, "
                       f"hid={hid} (it takes C = 64, hid up to "
                       f"{_CA_BWD_HID} and a short side of up to "
                       f"{_CA_BWD_SHORT} rows)")
    return _CaBlockKernel.apply(xq.contiguous(), xk.contiguous(),
                                xv.contiguous(), m1, m2, num_heads, eps,
                                torch.is_grad_enabled(), *gammas, *betas,
                                *params)


# ---------------------------------------------------------------------------
# The AdaLN and CA blocks in f32 (rows 8f-11f: csrc/ada_f32.cu,
# csrc/ca_f32.cu)
# ---------------------------------------------------------------------------

# The f32 kernels' gates: C = 64 in heads of 8, 16 or 32, hid a multiple of
# 64 up to 256, any number of tokens (a CA block: on the long side; the
# programs stream it in 64-row chunks, a ring's window of items at a time)
# and up to _F32_DEC_SHORT on a CA block's short side (Stage 2: 431 or 1723
# and 17 / 19).
_F32_DEC_SHORT, _F32_DEC_HID = 64, 256


def _f32_dec_width(C: int, num_heads: int, hid: int) -> bool:
    return (C == 64 and C % num_heads == 0 and C // num_heads in _HEAD_DIMS
            and hid % 64 == 0 and 0 < hid <= _F32_DEC_HID)


def ada_f32_kernel_fits(N: int, C: int, num_heads: int, hid: int) -> bool:
    """The static shape test of rows 8f / 9f (``csrc/ada_f32.cu``): C = 64
    in heads of 8, 16 or 32, hid a multiple of 64 up to 256, any number of
    tokens."""
    return _f32_dec_width(C, num_heads, hid) and N > 0


def ca_f32_kernel_fits(Nq: int, Nk: int, C: int, num_heads: int,
                       hid: int) -> bool:
    """The static shape test of rows 10f / 11f (``csrc/ca_f32.cu``): the
    widths of :func:`ada_f32_kernel_fits`, up to 64 rows on the short side
    (the smaller of Nq, Nk), the long side of any length."""
    return (_f32_dec_width(C, num_heads, hid)
            and 0 < min(Nq, Nk) <= _F32_DEC_SHORT)


def _f32_rows_of(name, dev, B, C, vecs, names):
    _f32_params(name, *vecs)
    return [_f32_rows(t, dev, B, C, n) for t, n in zip(vecs, names)]


def _ada_f32_inputs(x, gb, masks, params):
    """The forward's 15 inputs as ``csrc/ada_f32.cu`` takes them: x, the
    four [B, C] AdaLN vectors, the mask rows and the eight parameters, f32
    on their own storage (another dtype raises ``ValueError``)."""
    B, N, C = x.shape
    dev, f32 = x.device, torch.float32
    _cuda.check_cuda(x, "x", f32, (B, N, C))
    wqkv, bqkv, wproj, bproj, w1, bb1, w2, bb2 = params
    hid = w1.shape[1]
    rows = _f32_rows_of("ada_block", dev, B, C, gb,
                        ("gamma1", "beta1", "gamma2", "beta2"))
    _f32_params("ada_block", *params)
    return (x, *rows, *(_mask_rows(m, B, dev) for m in masks),
            _cuda.to_kernel(wqkv, dev, f32, (C, 3 * C), "wqkv"),
            _f32_vec(bqkv, dev, 3 * C, "bqkv"),
            _cuda.to_kernel(wproj, dev, f32, (C, C), "wproj"),
            _f32_vec(bproj, dev, C, "bproj"),
            _cuda.to_kernel(w1, dev, f32, (C, hid), "w_fc1"),
            _f32_vec(bb1, dev, hid, "b_fc1"),
            _cuda.to_kernel(w2, dev, f32, (hid, C), "w_fc2"),
            _f32_vec(bb2, dev, C, "b_fc2"))


def _ada_fwd_f32_cuda(x, gb, masks, params, num_heads, eps):
    """Row 8f: one call of ``pmce_ada_fwd_f32`` (three launches on
    :func:`f32_dec_fwd_plan`'s persistent grids: AdaLN1 and qkv, the
    attention, the tail, over 128-row tiles of each clip); it keeps nothing
    for the gradient (row 9f recomputes from x)."""
    B, N, C = x.shape
    hid = params[4].shape[1]
    ins = _ada_f32_inputs(x, gb, masks, params)
    plan = f32_dec_fwd_plan("ada", B, N, N, _dec_f32_resident(x.device))
    out = torch.empty_like(x)
    ws = torch.empty(f32_dec_fwd_workspace("ada", B, N, N, num_heads,
                                           plan.splits_q),
                     device=x.device, dtype=torch.float32)
    _cuda.ADA_F32.call("pmce_ada_fwd_f32", _cuda.ptr_table(*ins, out, ws),
                       B, N, hid, num_heads, eps,
                       1.0 / math.sqrt(C // num_heads), plan.ctas,
                       _cuda.stream_ptr(x.device))
    ADA_FWD_F32_LAUNCHES.count += 1
    return out


def _ada_bwd_f32_cuda(gout, x, gb, masks, params, num_heads, eps,
                      need_masks: bool):
    """Row 9f: one call of ``pmce_ada_bwd_f32`` (the weights' transposes,
    qkv recomputed from x by the forward's rows program, then on
    :func:`f32_dec_plan`'s persistent grids
    the attention recomputed with the tail and the gradient chain down to
    dq, dk / dv over the queries, AdaLN1's backward; the weight gradients
    and the sums of the programs' partials, every sum in a fixed order).
    Returns dx, the four [B, C] AdaLN vectors'
    gradients, the eight parameter gradients and (dm1, dm2) (None, None
    unless ``need_masks``)."""
    B, N, C = x.shape
    hid = params[4].shape[1]
    dev, f32 = x.device, torch.float32
    ins = _ada_f32_inputs(x, gb, masks, params)
    g = gout.to(f32).contiguous()
    _cuda.check_cuda(g, "grad of the block output", f32, (B, N, C))
    splits = f32_wgrad_splits(
        B * N, ((C, 3 * C), (C, C), (C, hid), (hid, C)), dev)
    ctas = f32_dec_plan("ada", B, N, N, _dec_f32_resident(dev)).ctas
    ws = torch.empty(int(_cuda.ADA_F32.query(
        "pmce_ada_f32_workspace", B, N, hid, num_heads, splits)),
        device=dev, dtype=f32)
    dx = torch.empty_like(x)
    sums = torch.empty(B, 4 * C + 2, device=dev, dtype=f32)
    dw = [torch.empty(r, c, device=dev, dtype=f32)
          for r, c in ((C, 3 * C), (C, C), (C, hid), (hid, C))]
    db = torch.empty(5 * C + hid, device=dev, dtype=f32)
    _cuda.ADA_F32.call("pmce_ada_bwd_f32", _cuda.ptr_table(
        *ins, g, ws, dx, sums, *dw, db), B, N, hid, num_heads, eps,
        1.0 / math.sqrt(C // num_heads), splits, int(need_masks), ctas,
        _cuda.stream_ptr(dev))
    ADA_BWD_F32_LAUNCHES.count += 1
    dgb = tuple(sums[:, i * C:(i + 1) * C] for i in range(4))
    dms = ((sums[:, 4 * C], sums[:, 4 * C + 1]) if need_masks
           else (None, None))
    grads = (dw[0], db[:3 * C], dw[1], db[3 * C:4 * C], dw[2],
             db[4 * C:4 * C + hid], dw[3], db[4 * C + hid:])
    return dx, dgb, grads, dms


def _mask_grads(masks, dms):
    return [None if m is None or d is None else d.reshape(m.shape).to(m.dtype)
            for m, d in zip(masks, dms)]


class _AdaF32Kernel(torch.autograd.Function):
    """The f32 AdaLN block on the card: forward row 8f, backward row 9f
    (``csrc/ada_f32.cu``). The forward keeps only its inputs; the backward
    recomputes the rest from x, as JAX's ``_ada_block_bwd_kernel`` does,
    and sums the mask gradients (per clip) only where autograd asks for
    them."""

    @staticmethod
    def forward(ctx, x, gamma1, beta1, gamma2, beta2, m1, m2, num_heads, eps,
                *params):
        gb = (gamma1, beta1, gamma2, beta2)
        out = _ada_fwd_f32_cuda(x, gb, (m1, m2), params, num_heads, eps)
        ctx.cfg = (num_heads, eps)
        ctx.save_for_backward(x, *gb, m1, m2, *params)
        return out

    @staticmethod
    def backward(ctx, gout):
        num_heads, eps = ctx.cfg
        x, g1, b1, g2, b2, m1, m2, *params = ctx.saved_tensors
        need_masks = ctx.needs_input_grad[5] or ctx.needs_input_grad[6]
        dx, dgb, grads, dms = _ada_bwd_f32_cuda(
            gout, x, (g1, b1, g2, b2), (m1, m2), params, num_heads, eps,
            need_masks)
        return (dx, *(d.reshape(t.shape) for d, t in zip(dgb, (g1, b1, g2,
                                                                b2))),
                *_mask_grads((m1, m2), dms), None, None,
                *(d.reshape(t.shape) for d, t in zip(grads, params)))


def _ca_f32_inputs(xs, gammas, betas, masks, params):
    """The forward's 25 inputs as ``csrc/ca_f32.cu`` takes them: xq, xk,
    xv, the eight [B, C] AdaLN vectors (q, k, v, 2; each gamma then beta),
    the mask rows and the twelve parameters, f32 on their own storage
    (another dtype raises ``ValueError``)."""
    xq, xk, xv = xs
    B, Nq, C = xq.shape
    Nk = xk.shape[1]
    dev, f32 = xq.device, torch.float32
    _f32_params("ca_block", xk, xv, *params)
    _cuda.check_cuda(xq, "xq", f32, (B, Nq, C))
    _cuda.check_cuda(xk, "xk", f32, (B, Nk, C))
    _cuda.check_cuda(xv, "xv", f32, (B, Nk, C))
    (wq, bq, wk, bk, wv, bv, wproj, bproj, w1, bb1, w2, bb2) = params
    hid = w1.shape[1]
    conds = _f32_rows_of(
        "ca_block", dev, B, C,
        [t for pair in zip(gammas, betas) for t in pair],
        [f"{k} {n}" for n in ("q", "k", "v", "2") for k in ("gamma",
                                                            "beta")])

    def mat(w, r, c, name):
        return _cuda.to_kernel(w, dev, f32, (r, c), name)

    return (*xs, *conds, *(_mask_rows(m, B, dev) for m in masks),
            mat(wq, C, C, "wq"), _f32_vec(bq, dev, C, "bq"),
            mat(wk, C, C, "wk"), _f32_vec(bk, dev, C, "bk"),
            mat(wv, C, C, "wv"), _f32_vec(bv, dev, C, "bv"),
            mat(wproj, C, C, "wproj"), _f32_vec(bproj, dev, C, "bproj"),
            mat(w1, C, hid, "w_fc1"), _f32_vec(bb1, dev, hid, "b_fc1"),
            mat(w2, hid, C, "w_fc2"), _f32_vec(bb2, dev, C, "b_fc2"))


def _ca_fwd_f32_cuda(xs, gammas, betas, masks, params, num_heads, eps):
    """Row 10f: one call of ``pmce_ca_fwd_f32`` (three launches on
    :func:`f32_dec_fwd_plan`'s persistent grids: k and v over the keys'
    tiles; q and the attention over the queries' tiles, a short query side
    split over the keys' chunks; the tail); it keeps nothing for the
    gradient (row 11f recomputes)."""
    xq, xk, _ = xs
    B, Nq, C = xq.shape
    Nk = xk.shape[1]
    hid = params[8].shape[1]
    ins = _ca_f32_inputs(xs, gammas, betas, masks, params)
    plan = f32_dec_fwd_plan("ca", B, Nq, Nk, _dec_f32_resident(xq.device))
    out = torch.empty_like(xq)
    ws = torch.empty(f32_dec_fwd_workspace("ca", B, Nq, Nk, num_heads,
                                           plan.splits_q),
                     device=xq.device, dtype=torch.float32)
    _cuda.CA_F32.call("pmce_ca_fwd_f32", _cuda.ptr_table(*ins, out, ws),
                      B, Nq, Nk, hid, num_heads, eps,
                      1.0 / math.sqrt(C // num_heads), plan.ctas,
                      _cuda.stream_ptr(xq.device))
    CA_FWD_F32_LAUNCHES.count += 1
    return out


def _ca_bwd_f32_cuda(gout, xs, gammas, betas, masks, params, num_heads, eps,
                     need_masks: bool):
    """Row 11f: one call of ``pmce_ca_bwd_f32`` (the weights' transposes,
    k and v recomputed by the forward's rows program, then on
    :func:`f32_dec_plan`'s persistent grids
    (the short side split over the long) the query side's recompute and
    gradient chain down to dq, dk / dv over the queries, each side's AdaLN
    backward; the weight gradients of each side and the sums of the
    programs' partials, every sum in a fixed order). Returns (dxq, dxk,
    dxv), the eight [B, C] AdaLN vectors' gradients in the order gq, bq',
    gk, bk', gv, bv', g2, b2, the twelve parameter gradients and (dm1,
    dm2) (None, None unless ``need_masks``)."""
    xq, xk, _ = xs
    B, Nq, C = xq.shape
    Nk = xk.shape[1]
    hid = params[8].shape[1]
    dev, f32 = xq.device, torch.float32
    ins = _ca_f32_inputs(xs, gammas, betas, masks, params)
    g = gout.to(f32).contiguous()
    _cuda.check_cuda(g, "grad of the block output", f32, (B, Nq, C))
    sq = f32_wgrad_splits(B * Nq, ((C, C), (C, C), (C, hid), (hid, C)), dev)
    sk = f32_wgrad_splits(B * Nk, ((C, C), (C, C)), dev)
    ctas = f32_dec_plan("ca", B, Nq, Nk, _dec_f32_resident(dev)).ctas
    ws = torch.empty(int(_cuda.CA_F32.query(
        "pmce_ca_f32_workspace", B, Nq, Nk, hid, num_heads, max(sq, sk),
        ctas)), device=dev, dtype=f32)
    dxs = [torch.empty_like(t) for t in xs]
    sums_q = torch.empty(B, 4 * C + 2, device=dev, dtype=f32)
    sums_k = torch.empty(B, 4 * C, device=dev, dtype=f32)
    dw = [torch.empty(r, c, device=dev, dtype=f32)
          for r, c in ((C, C),) * 4 + ((C, hid), (hid, C))]
    db_q = torch.empty(3 * C + hid, device=dev, dtype=f32)
    db_k = torch.empty(2 * C, device=dev, dtype=f32)
    _cuda.CA_F32.call("pmce_ca_bwd_f32", _cuda.ptr_table(
        *ins, g, ws, *dxs, sums_q, sums_k, *dw, db_q, db_k), B, Nq, Nk, hid,
        num_heads, eps, 1.0 / math.sqrt(C // num_heads), sq, sk,
        int(need_masks), ctas, _cuda.stream_ptr(dev))
    CA_BWD_F32_LAUNCHES.count += 1

    def q(i):
        return sums_q[:, i * C:(i + 1) * C]

    def k(i):
        return sums_k[:, i * C:(i + 1) * C]

    dgb = (q(0), q(1), k(0), k(1), k(2), k(3), q(2), q(3))
    dms = ((sums_q[:, 4 * C], sums_q[:, 4 * C + 1]) if need_masks
           else (None, None))
    grads = (dw[0], db_q[:C], dw[1], db_k[:C], dw[2], db_k[C:], dw[3],
             db_q[C:2 * C], dw[4], db_q[2 * C:2 * C + hid], dw[5],
             db_q[2 * C + hid:])
    return tuple(dxs), dgb, grads, dms


class _CaF32Kernel(torch.autograd.Function):
    """The f32 CA block on the card: forward row 10f, backward row 11f
    (``csrc/ca_f32.cu``). The forward keeps only its inputs; the backward
    recomputes the rest, as JAX's ``_ca_block_bwd_kernel`` does, and sums
    the mask gradients only where autograd asks for them."""

    @staticmethod
    def forward(ctx, xq, xk, xv, m1, m2, num_heads, eps, *rest):
        gammas, betas, params = rest[:4], rest[4:8], rest[8:]
        out = _ca_fwd_f32_cuda((xq, xk, xv), gammas, betas, (m1, m2), params,
                               num_heads, eps)
        ctx.cfg = (num_heads, eps)
        ctx.save_for_backward(xq, xk, xv, m1, m2, *rest)
        return out

    @staticmethod
    def backward(ctx, gout):
        num_heads, eps = ctx.cfg
        xq, xk, xv, m1, m2, *rest = ctx.saved_tensors
        gammas, betas, params = rest[:4], rest[4:8], rest[8:]
        need_masks = ctx.needs_input_grad[3] or ctx.needs_input_grad[4]
        dxs, dgb, grads, dms = _ca_bwd_f32_cuda(
            gout, (xq, xk, xv), gammas, betas, (m1, m2), params, num_heads,
            eps, need_masks)
        # Back to the inputs' order: gammas (q, k, v, 2), then betas.
        conds = [t for pair in zip(gammas, betas) for t in pair]
        d = [a.reshape(t.shape) for a, t in zip(dgb, conds)]
        return (*dxs, *_mask_grads((m1, m2), dms), None, None,
                *d[0::2], *d[1::2],
                *(a.reshape(t.shape) for a, t in zip(grads, params)))
