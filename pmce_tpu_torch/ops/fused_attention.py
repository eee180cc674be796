"""The lifter trunk and the GRU scan of the serving path, in PyTorch and CUDA.

Port of the two ``pmce_tpu/ops/fused_attention.py`` Pallas kernels that the
bf16 serving forward runs: ``fused_lifter_trunk`` (the whole Stage-1 trunk)
and ``fused_gru_layer`` / ``fused_gru_layer_rev`` (one GRU direction over
T). Each comes as

- a plain PyTorch version (``*_plain``) with the math of the JAX kernel;
- a wrapper that picks by the device of its input: a CPU tensor goes to the
  plain version, a CUDA tensor to the hand-written kernel in
  ``pmce_tpu_torch/csrc`` (or an exception; nothing falls back).

The numerics follow the JAX oracles rather than the TPU kernels' bf16
workarounds, and are shared with ``ops/fused_coevo_chain.py``: f32 LayerNorm
and AdaLayerNorm statistics, exact erf GELU, a max-stabilised f32 softmax,
every product an f32 sum of its operands as given (bf16 operands are
upcast, :func:`mm`), and q scaled by 1/sqrt(dh) in f32 before its one bf16
rounding (``fused_attention.py:195-206`` of the JAX package).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from pmce_tpu_torch.ops import _cuda

TRUNK_LAUNCHES = _cuda.launch_counter("lifter_trunk")
GRU_LAUNCHES = _cuda.launch_counter("gru_layer")
GRU_REV_LAUNCHES = _cuda.launch_counter("gru_layer_rev")


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


def _trunk_block_plain(x, w, T, J, num_heads, eps, temporal):
    (g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, w1, bb1, w2, bb2) = w
    dt = x.dtype
    C = x.shape[-1]
    xf = x.float()
    h1 = ln_f32(xf, g1, b1, eps).to(dt)
    q, k, v = split_scaled_qkv(mm(h1, wqkv.to(dt)) + bqkv, C, num_heads, dt)
    o = _grouped_attention(q, k, v, T, J, num_heads, temporal).to(dt)
    x1 = xf + (mm(o, wproj.to(dt)) + bproj)
    h2 = ln_f32(x1, g2, b2, eps).to(dt)
    hh = F.gelu(mm(h2, w1.to(dt)) + bb1).to(dt)
    return (x1 + (mm(hh, w2.to(dt)) + bb2)).to(dt)


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


# Epilogue codes of pmce_trunk_gemm (csrc/lifter_trunk.cu).
_EPI_QKV, _EPI_RES_BF16, _EPI_GELU, _EPI_RES_F32 = 0, 1, 2, 3


def _lifter_trunk_cuda(x, params, norm_s, norm_t, tpe, T, J, depth,
                       num_heads, eps):
    B, R, C = x.shape
    bf16, f32 = torch.bfloat16, torch.float32
    if x.dtype != bf16:
        raise NotImplementedError(
            "the trunk kernel takes bf16 tokens; the f32 model runs the "
            "modular path")
    hid = params[0][8].shape[1]
    if (C != 256 or C != 32 * num_heads or R != T * J or max(T, J) > 32
            or hid % 128 or len(params) != 2 * depth):
        raise ValueError(f"trunk kernel shapes: C={C} heads={num_heads} "
                         f"T={T} J={J} R={R} hid={hid}")
    _cuda.check_cuda(x, "x", bf16, (B, R, C))
    dev = x.device
    M = B * R
    stream = _cuda.stream_ptr(dev)
    lib = _cuda.TRUNK

    def vec(a, n, name):
        return _cuda.to_kernel(a, dev, f32, (n,), name)

    def mat(a, rows, cols, name):
        return _cuda.to_kernel(a, dev, bf16, (rows, cols), name)

    h = torch.empty(M, C, device=dev, dtype=bf16)
    qkv = torch.empty(M, 3 * C, device=dev, dtype=bf16)
    o = torch.empty(M, C, device=dev, dtype=bf16)
    x1 = torch.empty(M, C, device=dev, dtype=f32)
    hh = torch.empty(M, hid, device=dev, dtype=bf16)
    y = torch.empty(M, C, device=dev, dtype=bf16)
    outs = (torch.empty_like(x), torch.empty_like(x))
    tpe_c = _cuda.to_kernel(tpe, dev, f32, (T, C), "tpe")
    post = tuple((vec(g, C, "post-norm scale"), vec(b, C, "post-norm bias"))
                 for g, b in (norm_s, norm_t))
    p = _cuda.ptr
    null = _cuda.P(None)
    qscale = 1.0 / math.sqrt(C // num_heads)

    def ln(src, is_f32, dst, g, b, with_tpe):
        lib.call("pmce_trunk_ln", p(src), int(is_f32), p(dst), p(g), p(b),
                 p(tpe_c) if with_tpe else null, M, R, J, eps, stream)

    def gemm(a, w, bias, res, out, n, k, epi):
        lib.call("pmce_trunk_gemm", p(a), p(w), p(bias),
                 p(res) if res is not None else null, p(out), M, n, k, epi,
                 C, qscale, stream)

    cur = x
    for i, w in enumerate(params):
        (g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, w1, bb1, w2, bb2) = w
        g1, b1 = vec(g1, C, "ln1 scale"), vec(b1, C, "ln1 bias")
        g2, b2 = vec(g2, C, "ln2 scale"), vec(b2, C, "ln2 bias")
        wqkv, bqkv = mat(wqkv, C, 3 * C, "wqkv"), vec(bqkv, 3 * C, "bqkv")
        wproj, bproj = mat(wproj, C, C, "wproj"), vec(bproj, C, "bproj")
        w1, bb1 = mat(w1, C, hid, "w_fc1"), vec(bb1, hid, "b_fc1")
        w2, bb2 = mat(w2, hid, C, "w_fc2"), vec(bb2, C, "b_fc2")
        temporal = i % 2 == 1
        ln(cur, False, h, g1, b1, False)
        gemm(h, wqkv, bqkv, None, qkv, 3 * C, C, _EPI_QKV)
        lib.call("pmce_trunk_attn", p(qkv), p(o), B, T, J, C, num_heads,
                 int(temporal), stream)
        gemm(o, wproj, bproj, cur, x1, C, C, _EPI_RES_BF16)
        ln(x1, True, h, g2, b2, False)
        gemm(h, w1, bb1, None, hh, hid, C, _EPI_GELU)
        gemm(hh, w2, bb2, x1, y, C, hid, _EPI_RES_F32)
        nxt = outs[i % 2]
        ln(y, False, nxt, *post[int(temporal)], i == 0)
        cur = nxt
    TRUNK_LAUNCHES.count += 1
    return cur


def lifter_trunk(x, params, norm_s, norm_t, tpe, T: int, J: int,
                 depth: int, num_heads: int, eps: float = 1e-6):
    """The whole lifter trunk (see :func:`lifter_trunk_plain` for args).

    CPU tensors run the plain version; CUDA tensors the kernel sequence of
    ``csrc/lifter_trunk.cu`` (bf16 only)."""
    if x.device.type == "cpu":
        return lifter_trunk_plain(x, params, norm_s, norm_t, tpe, T, J,
                                  depth, num_heads, eps)
    if x.device.type != "cuda":
        raise ValueError(f"lifter_trunk: unsupported device {x.device}")
    return _lifter_trunk_cuda(x, params, norm_s, norm_t, tpe, T, J, depth,
                              num_heads, eps)


# ---------------------------------------------------------------------------
# GRU scan (replaces _gru_scan_kernel / fused_gru_layer[_rev])
# ---------------------------------------------------------------------------


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
    w = whh.to(dt)
    b = bhh.float()
    h = torch.zeros(B, H3 // 3, dtype=torch.float32, device=gi.device)
    ys = torch.empty(T, B, H3 // 3, dtype=dt, device=gi.device)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gh = mm(h.to(dt), w) + b
        i_r, i_z, i_n = gi[t].float().chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h = (1.0 - z) * n + z * h
        ys[t] = h.to(dt)
    return ys


def _gru_layer_cuda(gi, whh, bhh, reverse: bool) -> torch.Tensor:
    T, B, H3 = gi.shape
    H = H3 // 3
    bf16, f32 = torch.bfloat16, torch.float32
    if gi.dtype != bf16:
        raise NotImplementedError("the GRU kernel takes bf16 projections")
    if H % 64:
        raise ValueError(f"GRU kernel: H={H} must be a multiple of 64")
    _cuda.check_cuda(gi, "gi", bf16, (T, B, 3 * H))
    dev = gi.device
    w = _cuda.to_kernel(whh, dev, bf16, (H, 3 * H), "whh")
    b = _cuda.to_kernel(bhh, dev, f32, (3 * H,), "bhh")
    Bp = -(-B // 16) * 16
    # Ping-pong carries: f32 h and its bf16 rounding (the next step's
    # matrix operand, padded to whole 16-row tiles with zero rows).
    h32 = torch.zeros(2, B, H, device=dev, dtype=f32)
    hb = torch.zeros(2, Bp, H, device=dev, dtype=bf16)
    ys = torch.empty(T, B, H, device=dev, dtype=bf16)
    stream = _cuda.stream_ptr(dev)
    p = _cuda.ptr
    for step in range(T):
        t = T - 1 - step if reverse else step
        src, dst = step % 2, (step + 1) % 2
        _cuda.GRU.call("pmce_gru_step", p(gi[t]), p(w), p(b), p(h32[src]),
                       p(hb[src]), p(h32[dst]), p(hb[dst]), p(ys[t]), B, Bp,
                       H, stream)
    return ys


def _gru_dispatch(gi, whh, bhh, reverse: bool, counter) -> torch.Tensor:
    if gi.device.type == "cpu":
        return gru_layer_plain(gi, whh, bhh, reverse)
    if gi.device.type != "cuda":
        raise ValueError(f"gru_layer: unsupported device {gi.device}")
    ys = _gru_layer_cuda(gi, whh, bhh, reverse)
    counter.count += 1
    return ys


def gru_layer(gi, whh, bhh) -> torch.Tensor:
    """One forward GRU direction over T (see :func:`gru_layer_plain`)."""
    return _gru_dispatch(gi, whh, bhh, False, GRU_LAUNCHES)


def gru_layer_rev(gi, whh, bhh) -> torch.Tensor:
    """The backward direction, output in forward time order, no copies."""
    return _gru_dispatch(gi, whh, bhh, True, GRU_REV_LAUNCHES)
