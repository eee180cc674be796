"""Transformer building blocks of the lifter and the decoder (inference).

Port of ``pmce_tpu/models/layers.py``. Parameters carry the reference
state_dict names (timm ``Mlp`` / ``Attention``, ``AdaLayerNorm.mlp_gamma``,
``nn.GRU``'s ``weight_ih_l0_reverse`` ...), so a reference checkpoint loads
with ``load_state_dict(strict=True)``.

Every forward takes the compute dtype ``dt``: ``None`` runs in f32; a
16-bit dtype runs each dense layer as flax's ``nn.Dense(dtype=dt)`` does
(operands cast to ``dt``, product and bias add rounded to ``dt``), with
LayerNorm statistics in f32. GELU is the exact (erf) variant. Dropout and
stochastic depth are identities: this module serves inference.
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


class DropPath(nn.Module):
    """Stochastic depth: the identity at inference (all this port runs)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        return x


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

    def forward(self, x, dt=None):
        B, N, C = x.shape
        H = self.num_heads
        qkv = dense(x, self.qkv, dt).reshape(B, N, 3, H, C // H)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        out = _softmax_attention(q, k, v)
        return dense(out.transpose(1, 2).reshape(B, N, C), self.proj, dt)

    def params(self):
        return (*linear_t(self.qkv), *linear_t(self.proj))


class Block(nn.Module):
    """Pre-norm transformer block (LN → MHA → +res → LN → MLP → +res).

    The shared post-norm of the lifter (``norm_s`` / ``norm_t``) is applied
    by the caller, as in the reference."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, norm_eps: float = 1e-6):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=norm_eps)
        self.attn = Attention(dim, num_heads)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=norm_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, dt=None):
        x = x + self.drop_path(self.attn(layer_norm(x, self.norm1, dt), dt))
        return x + self.drop_path(self.mlp(layer_norm(x, self.norm2, dt), dt))

    def params(self) -> tuple:
        """The 12-tuple the trunk kernel takes (weights as [in, out])."""
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

    def forward(self, x, cond, dt=None):
        x = x + self.drop_path(self.attn(self.norm1(x, cond, dt), dt))
        return x + self.drop_path(self.mlp(self.norm2(x, cond, dt), dt))

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

    def forward(self, xq, xk, xv, cond, dt=None):
        h = self.attn(self.normq(xq, cond, dt), self.normk(xk, cond, dt),
                      self.normv(xv, cond, dt), dt)
        xq = xq + self.drop_path(h)
        return xq + self.drop_path(self.mlp(self.norm2(xq, cond, dt), dt))

    def adaln(self):
        return (self.normq, self.normk, self.normv, self.norm2)

    def params(self) -> tuple:
        return (*self.attn.params(), *self.mlp.params())


class BiGRU(nn.Module):
    """Multi-layer bidirectional GRU over the leading time axis.

    torch's gate math and ``nn.GRU`` parameter names and layouts
    (``weight_ih_l{k}[_reverse]`` [3H, in] ...). The recurrence of each
    direction is :func:`~pmce_tpu_torch.ops.fused_attention.gru_layer` (the
    kernel path) under ``fused`` with bf16 compute, and the same math as a
    plain loop otherwise; the input projections are one dense product over
    all steps."""

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

    def forward(self, x, mid_index: int | None = None, dt=None,
                fused: bool = False):
        """x: [T, B, C] → [T, B, 2H]; with ``mid_index``, only the final
        layer's step-``mid_index`` output [B, 2H]: that layer then scans
        steps 0..mid forward and T−1..mid backward (the only steps that
        output depends on)."""
        kernel = fused and dt == torch.bfloat16
        fwd_scan = fa.gru_layer if kernel else fa.gru_layer_plain
        rev_scan = fa.gru_layer_rev if kernel else (
            lambda gi, w, b: fa.gru_layer_plain(gi, w, b, reverse=True))

        def proj(xs, w_ih, b_ih):
            if dt is None:
                return xs @ w_ih.t() + b_ih
            return xs.to(dt) @ w_ih.t().to(dt) + b_ih.to(dt)

        for layer in range(self.num_layers):
            wf, bf, hf_w, hf_b = self._direction(layer, False)
            wb, bb, hb_w, hb_b = self._direction(layer, True)
            if mid_index is not None and layer == self.num_layers - 1:
                hf = fwd_scan(proj(x[:mid_index + 1], wf, bf), hf_w.t(),
                              hf_b)[-1]
                hb = rev_scan(proj(x[mid_index:], wb, bb), hb_w.t(), hb_b)[0]
                return torch.cat([hf, hb], dim=-1)
            ys_f = fwd_scan(proj(x, wf, bf), hf_w.t(), hf_b)
            ys_b = rev_scan(proj(x, wb, bb), hb_w.t(), hb_b)
            x = torch.cat([ys_f, ys_b], dim=-1)
        return x
