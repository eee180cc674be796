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

With ``fused`` and bf16 compute the whole trunk is one call of
:func:`~pmce_tpu_torch.ops.fused_attention.lifter_trunk` (a kernel on the
card); otherwise the blocks run as modules, as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pmce_tpu_torch.models.layers import Block, dense, layer_norm
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

    def forward(self, pose2d, img_feat):
        """pose2d [B, T, J, 2], img_feat [B, T, 2048] → [B, J, 3] (mm)."""
        B, T, J, _ = pose2d.shape
        C = self.joint_embed.out_features
        dt = self.dtype

        x = dense(pose2d, self.joint_embed, dt)                   # [B,T,J,C]
        x = x + dense(img_feat, self.imgfeat_embed, dt)[:, :, None, :]
        # The f32 pos-embed promotes x to f32.
        x = x + self.spatial_pos_embed[None]

        if self.fused and dt == torch.bfloat16:
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
                x = layer_norm(self.SpatialBlocks[i](x, dt), self.norm_s, dt)
                x = x.reshape(B, T, J, C).transpose(1, 2).reshape(B * J, T, C)
                if i == 0:
                    x = x + self.temporal_pos_embed
                x = layer_norm(self.TemporalBlocks[i](x, dt), self.norm_t, dt)
            x = x.reshape(B, J, T, C).transpose(1, 2)             # [B,T,J,C]

        # f32 head: millimeter-scale outputs, where bf16 quantizes at ~4 mm.
        h = F.layer_norm(x.float(), (C,), self.regression[0].weight,
                         self.regression[0].bias, self.regression[0].eps)
        h = F.linear(h, self.regression[1].weight, self.regression[1].bias)
        out = torch.einsum("t,btjc->bjc", self.fusion.weight.reshape(T), h)
        return out + self.fusion.bias[0]
