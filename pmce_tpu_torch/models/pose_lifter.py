"""Stage-1 spatio-temporal 2D → 3D pose lifter.

Port of ``pmce_tpu/models/pose_lifter.py``; parameter names are those of
the reference ``GraphormerNet`` (``SpatialBlocks.0.attn.qkv.weight``,
``regression.1.bias``, ``fusion.weight`` [1, T, 1, 1] ...). Per frame the 2D
joints are embedded (Linear 2 → C) with an image-feature bias (Linear
2048 → C) and the spatial pos-embed; ``depth`` pairs of (spatial over J,
temporal over T) blocks follow, with the temporal pos-embed added after the
first spatial block and the SHARED ``norm_s`` / ``norm_t`` applied after
every block (reference quirks). The head is LayerNorm(1e-5) + Linear(C → 3)
in f32 and a learned weighted sum over the T frames; output is the
mid-frame pose in millimeters.

Three paths, as in ``pose_lifter.py:123-189`` of the JAX package:

- eval mode, ``fused`` and bf16 compute: the whole trunk is one call of
  :func:`~pmce_tpu_torch.ops.fused_attention.lifter_trunk` (a kernel
  sequence on the card);
- otherwise with ``fused`` (training, or f32): every block is one
  :func:`~pmce_tpu_torch.ops.fused_attention.transformer_block` call with
  the shared norm as its post-norm, kernels forward and backward on the
  card, stochastic depth as per-clip branch masks;
- without ``fused``: the blocks run as modules.

In training mode the stochastic-depth masks come from the ``generator``
given to :meth:`PoseLifter.forward`, a generator on the input's device
(rates ``linspace(0, 0.2, depth)``, so the first pair of blocks draws
none).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pmce_tpu_torch.models.layers import Block, dense, init_like_jax
from pmce_tpu_torch.ops import fused_attention as fa


class PoseLifter(nn.Module):
    def __init__(self, num_joints: int = 17, num_frames: int = 16,
                 embed_dim: int = 256, depth: int = 3, num_heads: int = 8,
                 mlp_ratio: float = 2.0, drop_path_rate: float = 0.2,
                 img_feat_dim: int = 2048, dtype=None, fused: bool = False):
        super().__init__()
        C = embed_dim
        self.num_heads = num_heads
        self.depth = depth
        self.dtype = dtype
        self.fused = fused
        self.joint_embed = nn.Linear(2, C)
        self.imgfeat_embed = nn.Linear(img_feat_dim, C)
        self.spatial_pos_embed = nn.Parameter(torch.zeros(1, num_joints, C))
        self.temporal_pos_embed = nn.Parameter(torch.zeros(1, num_frames, C))
        dpr = np.linspace(0.0, drop_path_rate, depth)
        self.SpatialBlocks = nn.ModuleList(
            Block(C, num_heads, mlp_ratio, drop_path=float(dpr[i]))
            for i in range(depth))
        self.TemporalBlocks = nn.ModuleList(
            Block(C, num_heads, mlp_ratio, drop_path=float(dpr[i]))
            for i in range(depth))
        self.norm_s = nn.LayerNorm(C, eps=1e-6)
        self.norm_t = nn.LayerNorm(C, eps=1e-6)
        # torch's default eps (1e-5) in the head, as the reference builds it.
        self.regression = nn.Sequential(nn.LayerNorm(C), nn.Linear(C, 3))
        # Conv2d(T → 1, 1×1): a learned weighted sum over the T frames.
        self.fusion = nn.Conv2d(num_frames, 1, kernel_size=1)

    def forward(self, pose2d, img_feat, generator=None):
        """pose2d [B, T, J, 2], img_feat [B, T, 2048] → [B, J, 3] (mm)."""
        B, T, J, _ = pose2d.shape
        C = self.joint_embed.out_features
        dt = self.dtype

        x = dense(pose2d, self.joint_embed, dt)                   # [B,T,J,C]
        x = x + dense(img_feat, self.imgfeat_embed, dt)[:, :, None, :]
        # The f32 pos-embed promotes x to f32.
        x = x + self.spatial_pos_embed[None]

        if self.fused and dt == torch.bfloat16 and not self.training:
            blocks = []
            for s, t in zip(self.SpatialBlocks, self.TemporalBlocks):
                blocks += [s.params(), t.params()]
            # Re-enter the compute dtype before the trunk (one cast point).
            x = fa.lifter_trunk(
                x.to(dt).reshape(B, T * J, C), tuple(blocks),
                (self.norm_s.weight, self.norm_s.bias),
                (self.norm_t.weight, self.norm_t.bias),
                self.temporal_pos_embed[0], T, J, self.depth, self.num_heads)
            x = x.reshape(B, T, J, C)
        else:
            x = x.reshape(B * T, J, C)
            for i in range(self.depth):
                if i:
                    x = x.reshape(B, J, T, C).transpose(1, 2).reshape(
                        B * T, J, C)
                x = self.SpatialBlocks[i](x, dt, self.norm_s, self.fused,
                                          generator)
                x = x.reshape(B, T, J, C).transpose(1, 2).reshape(B * J, T, C)
                if i == 0:
                    x = x + self.temporal_pos_embed
                x = self.TemporalBlocks[i](x, dt, self.norm_t, self.fused,
                                           generator)
            x = x.reshape(B, J, T, C).transpose(1, 2)             # [B,T,J,C]

        # f32 head: millimeter-scale outputs, where bf16 quantizes at ~4 mm.
        h = F.layer_norm(x.float(), (C,), self.regression[0].weight,
                         self.regression[0].bias, self.regression[0].eps)
        h = F.linear(h, self.regression[1].weight, self.regression[1].bias)
        out = torch.einsum("t,btjc->bjc", self.fusion.weight.reshape(T), h)
        return out + self.fusion.bias[0]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initial values, drawn from ``generator`` (a CPU
        generator): the pos-embeds 0, the frame fusion U(±1/√T), the rest
        as :func:`~pmce_tpu_torch.models.layers.init_like_jax`."""
        for name, p in self.named_parameters():
            if name == "fusion.weight":
                bound = p.shape[1] ** -0.5
                p.copy_((torch.rand(tuple(p.shape), generator=generator) * 2
                         - 1) * bound)
            elif name.endswith("_embed"):
                p.zero_()
            else:
                init_like_jax(p, name, generator)


def create_pose_lifter(num_joints: int = 17, num_frames: int = 16,
                       embed_dim: int = 256, depth: int = 3,
                       drop_path_rate: float = 0.2, dtype=None,
                       fused: bool = False, device="cuda",
                       seed: int = 0) -> PoseLifter:
    """A Stage-1 lifter on ``device`` (the card unless asked otherwise)
    with the JAX package's initial values drawn from ``seed``; in eval
    mode (call ``.train()`` to train)."""
    with torch.device("meta"):
        model = PoseLifter(num_joints=num_joints, num_frames=num_frames,
                           embed_dim=embed_dim, depth=depth,
                           drop_path_rate=drop_path_rate, dtype=dtype,
                           fused=fused)
    model = model.to_empty(device=device)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.eval()
