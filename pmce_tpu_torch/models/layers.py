"""Transformer building blocks of the lifter and the decoder.

Port of ``pmce_tpu/models/layers.py``. Parameters carry the reference
state_dict names (timm ``Mlp`` / ``Attention``, ``AdaLayerNorm.mlp_gamma``,
``nn.GRU``'s ``weight_ih_l0_reverse`` ...), so a reference checkpoint loads
with ``load_state_dict(strict=True)``.

Every forward takes the compute dtype ``dt``: ``None`` runs in f32; a
16-bit dtype runs each dense layer as flax's ``nn.Dense(dtype=dt)`` does
(operands cast to ``dt``, product and bias add rounded to ``dt``), with
LayerNorm statistics in f32. GELU is the exact (erf) variant.

Training: stochastic depth (:class:`DropPath`) draws per-clip branch masks
from an explicit ``torch.Generator`` while the module is in training mode
and is the identity in eval mode. ``fused`` takes the JAX package's kernel
gates (kernels forward and backward on the card, the masks entering as
branch scales): a :class:`Block` is one
:func:`~pmce_tpu_torch.ops.fused_attention.transformer_block` call; an
:class:`AdaBlock` over more than 64 tokens one ``ada_block`` call, over
fewer its AdaLNs and MLP as modules around ``fused_mhsa``; a
:class:`CrossAttentionBlock` with more than 64 queries or keys one
``ca_block`` call. Element dropout is not ported: the lifter and decoder
are built with rate 0, as the JAX package's training CLI builds them, so
the JAX gates' "no active dropout" clause always holds.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from pmce_tpu_torch.ops import fused_attention as fa


def dense(x, lin: nn.Linear, dt):
    """flax ``nn.Dense(dtype=dt)`` semantics on a torch ``Linear``."""
    if dt is None:
        return F.linear(x, lin.weight, lin.bias)
    return x.to(dt) @ lin.weight.t().to(dt) + lin.bias.to(dt)


def layer_norm(x, ln: nn.LayerNorm, dt):
    """LayerNorm with f32 statistics, output in ``dt`` (f32 if None)."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                     ln.eps)
    return y if dt is None else y.to(dt)


def linear_t(lin: nn.Linear):
    """(kernel [in, out], bias) of a torch Linear, as the kernels take them."""
    return lin.weight.t(), lin.bias


# The std of a standard normal truncated to [-2, 2] (flax's
# ``variance_scaling`` divides by it, so that the truncated draw keeps the
# variance asked for).
_TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def init_like_jax(p: torch.Tensor, name: str, generator) -> None:
    """Fill ``p`` (parameter ``name``, not an embed) with what the JAX
    package's ``model.init`` draws for it (``pmce_tpu/models/layers.py:96-141``
    and flax's defaults), from ``generator`` (a CPU generator): a
    LayerNorm's scale 1, every bias (LayerNorm, dense, GRU) 0, and every
    product weight (dense, GRU, convolution; torch layout [out, in, ...])
    flax's lecun-normal: a normal truncated at ±2σ and rescaled so that its
    std is 1/√fan_in."""
    if p.ndim == 1:
        p.fill_(1.0 if name.rsplit(".", 1)[-1] == "weight" else 0.0)
        return
    fan_in = math.prod(p.shape[1:])
    std = fan_in ** -0.5 / _TRUNCATED_STD
    v = torch.empty(p.shape)
    nn.init.trunc_normal_(v, 0.0, std, -2 * std, 2 * std, generator=generator)
    p.copy_(v)


class DropPath(nn.Module):
    """Per-sample stochastic depth of one residual branch.

    In training mode with a nonzero rate, :meth:`mask` draws a [B, 1, 1]
    scale per sample of the leading dimension: 1/keep with probability
    keep, else 0, drawn on ``device`` from ``generator`` (a generator on
    that device, or None for the device's default one). In eval mode or at
    rate 0 there is no mask."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def mask(self, batch: int, device, generator=None):
        if not self.training or self.rate == 0.0:
            return None
        keep = 1.0 - self.rate
        u = torch.rand(batch, 1, 1, device=device, generator=generator)
        return (u < keep).float() / keep

    def forward(self, x, generator=None):
        m = self.mask(x.shape[0], x.device, generator)
        return x if m is None else x * m.to(x.dtype)


class Mlp(nn.Module):
    """Linear → exact GELU → Linear (timm layout)."""

    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, in_dim)

    def forward(self, x, dt=None):
        return dense(F.gelu(dense(x, self.fc1, dt)), self.fc2, dt)

    def params(self):
        return (*linear_t(self.fc1), *linear_t(self.fc2))


def _softmax_attention(q, k, v):
    """softmax(q kᵀ · dh^-½) v over [B, H, N, dh] heads."""
    attn = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    attn = torch.softmax(attn.float(), dim=-1)
    return attn.to(q.dtype) @ v


class Attention(nn.Module):
    """timm multi-head self-attention with a fused qkv projection."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, dt=None, fused: bool = False):
        """``fused``: one ``fused_mhsa`` call on x cast to the compute dtype
        (``layers.py:200-208`` of the JAX package), output in that dtype."""
        B, N, C = x.shape
        H = self.num_heads
        if fused:
            return fa.fused_mhsa(x.to(dt or x.dtype), *self.params(), H)
        qkv = dense(x, self.qkv, dt).reshape(B, N, 3, H, C // H)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        out = _softmax_attention(q, k, v)
        return dense(out.transpose(1, 2).reshape(B, N, C), self.proj, dt)

    def params(self):
        return (*linear_t(self.qkv), *linear_t(self.proj))


class Block(nn.Module):
    """Pre-norm transformer block (LN → MHA → +res → LN → MLP → +res),
    optionally followed by a caller's shared post-norm (the lifter's
    ``norm_s`` / ``norm_t``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, norm_eps: float = 1e-6):
        super().__init__()
        self.num_heads = num_heads
        self.norm_eps = norm_eps
        self.norm1 = nn.LayerNorm(dim, eps=norm_eps)
        self.attn = Attention(dim, num_heads)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=norm_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, dt=None, post_norm: nn.LayerNorm | None = None,
                fused: bool = False, generator=None):
        """x [B, N, C] → [B, N, C] in x's dtype.

        Two independent stochastic-depth draws (attention, then MLP branch)
        come from ``generator`` in training mode. ``fused``: the whole block
        and the post-norm are one ``transformer_block`` call on x cast to
        the compute dtype, its output cast back (``layers.py:286-288`` of
        the JAX package); otherwise the modules run one by one."""
        B = x.shape[0]
        m1 = self.drop_path.mask(B, x.device, generator)
        m2 = self.drop_path.mask(B, x.device, generator)
        if fused:
            post = ((post_norm.weight, post_norm.bias)
                    if post_norm is not None else (None, None))
            masks = None if m1 is None else (m1, m2)
            y = fa.transformer_block(x.to(dt or x.dtype),
                                     self.params() + post, self.num_heads,
                                     self.norm_eps, self.norm_eps, masks)
            return y.to(x.dtype)
        h = self.attn(layer_norm(x, self.norm1, dt), dt)
        x = x + (h if m1 is None else h * m1.to(h.dtype))
        h = self.mlp(layer_norm(x, self.norm2, dt), dt)
        x = x + (h if m2 is None else h * m2.to(h.dtype))
        return x if post_norm is None else layer_norm(x, post_norm, dt)

    def params(self) -> tuple:
        """The 12-tuple the kernels take (weights as [in, out])."""
        return (self.norm1.weight, self.norm1.bias, *self.attn.params(),
                self.norm2.weight, self.norm2.bias, *self.mlp.params())


class AdaLayerNorm(nn.Module):
    """LayerNorm whose γ/β are regressed from a conditioning feature.

    The reference's normalization: UNBIASED std over channels and
    ``(std + eps)`` in the denominator."""

    def __init__(self, num_features: int, cond_dim: int = 2048,
                 eps: float = 1e-6):
        super().__init__()
        self.mlp_gamma = nn.Linear(cond_dim, num_features)
        self.mlp_beta = nn.Linear(cond_dim, num_features)
        self.eps = eps

    def gamma_beta(self, cond, dt=None):
        """Per-clip [B, C] γ and β (``layers.py:387-407`` of the JAX
        package): dense layers in the compute dtype."""
        return dense(cond, self.mlp_gamma, dt), dense(cond, self.mlp_beta, dt)

    def forward(self, x, cond, dt=None):
        gamma, beta = self.gamma_beta(cond, dt)
        mean = x.mean(-1, keepdim=True)
        std = x.var(-1, keepdim=True, unbiased=True).sqrt()
        return gamma[:, None, :] * (x - mean) / (std + self.eps) \
            + beta[:, None, :]


class CrossAttention(nn.Module):
    """Cross-attention: queries from one stream, keys/values from another;
    the value width may differ from the query width."""

    def __init__(self, dim: int, v_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.wq = nn.Linear(dim, dim)
        self.wk = nn.Linear(dim, dim)
        self.wv = nn.Linear(v_dim, v_dim)
        self.proj = nn.Linear(v_dim, dim)

    def forward(self, xq, xk, xv, dt=None):
        B, N, C = xq.shape
        M = xk.shape[1]
        H = self.num_heads
        v_dim = self.wv.out_features
        q = dense(xq, self.wq, dt).reshape(B, N, H, C // H).transpose(1, 2)
        k = dense(xk, self.wk, dt).reshape(B, M, H, C // H).transpose(1, 2)
        v = dense(xv, self.wv, dt).reshape(B, M, H, v_dim // H).transpose(1, 2)
        out = _softmax_attention(q, k, v)
        return dense(out.transpose(1, 2).reshape(B, N, v_dim), self.proj, dt)

    def params(self) -> tuple:
        return (*linear_t(self.wq), *linear_t(self.wk), *linear_t(self.wv),
                *linear_t(self.proj))


class AdaBlock(nn.Module):
    """Self-attention block whose norms are AdaLayerNorms."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, cond_dim: int = 2048):
        super().__init__()
        self.norm1 = AdaLayerNorm(dim, cond_dim)
        self.attn = Attention(dim, num_heads)
        self.drop_path = DropPath(drop_path)
        self.norm2 = AdaLayerNorm(dim, cond_dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, cond, dt=None, generator=None, fused: bool = False):
        """Both stochastic-depth draws (attention, then MLP branch) come
        from ``generator`` in training mode. ``fused`` with more than 64
        tokens: the whole block is one ``ada_block`` call on x cast to the
        compute dtype, its output cast back; with fewer, the attention alone
        is ``fused_mhsa`` (``layers.py:557-597`` of the JAX package)."""
        B, N = x.shape[:2]
        if fused and N > 64:
            m1 = self.drop_path.mask(B, x.device, generator)
            m2 = self.drop_path.mask(B, x.device, generator)
            y = fa.ada_block(x.to(dt or x.dtype),
                             *self.norm1.gamma_beta(cond, dt),
                             *self.norm2.gamma_beta(cond, dt), self.params(),
                             self.attn.num_heads, self.norm1.eps,
                             None if m1 is None else (m1, m2))
            return y.to(x.dtype)
        x = x + self.drop_path(self.attn(self.norm1(x, cond, dt), dt, fused),
                               generator)
        return x + self.drop_path(self.mlp(self.norm2(x, cond, dt), dt),
                                  generator)

    def adaln(self):
        return (self.norm1, self.norm2)

    def params(self) -> tuple:
        return (*self.attn.params(), *self.mlp.params())


class CrossAttentionBlock(nn.Module):
    """AdaLN'd cross-attention + FFN with a residual on the query stream."""

    def __init__(self, q_dim: int, k_dim: int, v_dim: int, num_heads: int,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 cond_dim: int = 2048):
        super().__init__()
        self.normq = AdaLayerNorm(q_dim, cond_dim)
        self.normk = AdaLayerNorm(k_dim, cond_dim)
        self.normv = AdaLayerNorm(v_dim, cond_dim)
        self.attn = CrossAttention(q_dim, v_dim, num_heads)
        self.drop_path = DropPath(drop_path)
        self.norm2 = AdaLayerNorm(q_dim, cond_dim)
        self.mlp = Mlp(q_dim, int(q_dim * mlp_ratio))

    def forward(self, xq, xk, xv, cond, dt=None, generator=None,
                fused: bool = False):
        """Both stochastic-depth draws (attention, then MLP branch) come
        from ``generator`` in training mode. ``fused`` with more than 64
        queries or keys: the whole block is one ``ca_block`` call on the
        streams cast to the compute dtype, its output cast back
        (``layers.py:623-662`` of the JAX package)."""
        if fused and max(xq.shape[1], xk.shape[1]) > 64:
            B = xq.shape[0]
            m1 = self.drop_path.mask(B, xq.device, generator)
            m2 = self.drop_path.mask(B, xq.device, generator)
            gb = [n.gamma_beta(cond, dt) for n in self.adaln()]
            cd = dt or xq.dtype
            y = fa.ca_block(xq.to(cd), xk.to(cd), xv.to(cd),
                            tuple(g for g, _ in gb), tuple(b for _, b in gb),
                            self.params(), self.attn.num_heads,
                            self.normq.eps, None if m1 is None else (m1, m2))
            return y.to(xq.dtype)
        h = self.attn(self.normq(xq, cond, dt), self.normk(xk, cond, dt),
                      self.normv(xv, cond, dt), dt)
        xq = xq + self.drop_path(h, generator)
        return xq + self.drop_path(self.mlp(self.norm2(xq, cond, dt), dt),
                                   generator)

    def adaln(self):
        return (self.normq, self.normk, self.normv, self.norm2)

    def params(self) -> tuple:
        return (*self.attn.params(), *self.mlp.params())


class BiGRU(nn.Module):
    """Multi-layer bidirectional GRU over the leading time axis.

    torch's gate math and ``nn.GRU`` parameter names and layouts
    (``weight_ih_l{k}[_reverse]`` [3H, in] ...). The recurrence of each
    layer is :func:`~pmce_tpu_torch.ops.fused_attention.gru_bidir` under
    bf16 compute, whatever ``fused`` says, as the JAX package gates its GRU
    kernel on the dtype alone (``layers.py:734``; its ``B % 8`` part is a
    VMEM rule, and the kernels here take any B): on the card one launch of
    the scan kernel runs both directions, reading ``weight_hh`` in place;
    with a gradient to keep, each direction runs the training kernels.
    The same math as a plain loop in f32. The input projections are one
    dense product over all steps."""

    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int = 2):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        H = hidden_dim
        for layer in range(num_layers):
            in_dim = input_dim if layer == 0 else 2 * H
            for sfx in ("", "_reverse"):
                self.register_parameter(
                    f"weight_ih_l{layer}{sfx}",
                    nn.Parameter(torch.empty(3 * H, in_dim)))
                self.register_parameter(
                    f"weight_hh_l{layer}{sfx}",
                    nn.Parameter(torch.empty(3 * H, H)))
                self.register_parameter(
                    f"bias_ih_l{layer}{sfx}", nn.Parameter(torch.empty(3 * H)))
                self.register_parameter(
                    f"bias_hh_l{layer}{sfx}", nn.Parameter(torch.empty(3 * H)))
        bound = 1.0 / math.sqrt(H)
        for p in self.parameters():
            nn.init.uniform_(p, -bound, bound)

    def _direction(self, layer: int, reverse: bool):
        sfx = "_reverse" if reverse else ""
        g = lambda n: getattr(self, f"{n}_l{layer}{sfx}")  # noqa: E731
        return (g("weight_ih"), g("bias_ih"), g("weight_hh"), g("bias_hh"))

    def forward(self, x, mid_index: int | None = None, dt=None):
        """x: [T, B, C] → [T, B, 2H]; with ``mid_index``, only the final
        layer's step-``mid_index`` output [B, 2H]: that layer then scans
        steps 0..mid forward and T−1..mid backward (the only steps that
        output depends on)."""
        scan = fa.gru_bidir if dt == torch.bfloat16 else fa.gru_bidir_plain

        def proj(xs, w_ih, b_ih):
            if dt is None:
                return xs @ w_ih.t() + b_ih
            return xs.to(dt) @ w_ih.t().to(dt) + b_ih.to(dt)

        for layer in range(self.num_layers):
            wf, bf, hf_w, hf_b = self._direction(layer, False)
            wb, bb, hb_w, hb_b = self._direction(layer, True)
            if mid_index is not None and layer == self.num_layers - 1:
                ys_f, ys_b = scan(proj(x[:mid_index + 1], wf, bf),
                                  proj(x[mid_index:], wb, bb), hf_w.t(),
                                  hf_b, hb_w.t(), hb_b)
                return torch.cat([ys_f[-1], ys_b[0]], dim=-1)
            ys_f, ys_b = scan(proj(x, wf, bf), proj(x, wb, bb), hf_w.t(),
                              hf_b, hb_w.t(), hb_b)
            x = torch.cat([ys_f, ys_b], dim=-1)
        return x
