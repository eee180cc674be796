"""ViTPose: top-down 2D keypoint estimation with a plain ViT backbone.

Port of ``pmce_tpu/models/vitpose.py`` (the mmpose ViTPose-Huge top-down
heatmap configuration the reference demo uses, ViTPose_huge_coco_256x192:
a ViT-Huge patch-16 backbone, the classic 2-deconv heatmap head, 256×192
input, 17 COCO keypoints, argmax + quarter-pixel decoding). Inference is
one batched call over all (frame, person) crops.

Parameters carry mmpose's state_dict names (``backbone.patch_embed.proj``,
``backbone.pos_embed`` with its leading cls slot, ``backbone.blocks.{i}``,
``backbone.last_norm``, ``keypoint_head.deconv_layers.{0,1,3,4}``,
``keypoint_head.final_layer``), so an mmpose checkpoint's ``state_dict``
loads with ``load_state_dict``. The forward adds ``pos_embed[:, 1:]`` to
the patch tokens, as the JAX package's importer keeps it.

The trunk's blocks are the port's :class:`~pmce_tpu_torch.models.layers.Block`
on its plain path (qkv bias, LayerNorm eps 1e-6), as JAX's ViTPose calls
``Block`` without ``fused``: no kernel lies on this model's path. The
trunk runs in ``cfg.dtype``; the final norm, the deconvolution head and the
1×1 conv always run in full f32 (no TF32 on the card: the heatmaps feed an
argmax whose ties turn at ~1e-3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pmce_tpu_torch.models.layers import Block, init_like_jax
from pmce_tpu_torch.models.spin import batch_norm
from pmce_tpu_torch.smpl.layer import full_f32


@dataclasses.dataclass(frozen=True)
class ViTPoseConfig:
    img_size: tuple = (256, 192)      # (H, W)
    patch_size: int = 16
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_keypoints: int = 17
    deconv_channels: int = 256
    # Compute dtype of the ViT trunk (params stay f32); the head is f32.
    dtype: torch.dtype | None = None

    @classmethod
    def huge(cls, dtype=None) -> "ViTPoseConfig":
        return cls(dtype=dtype)

    @classmethod
    def tiny(cls, dtype=None) -> "ViTPoseConfig":
        return cls(embed_dim=64, depth=2, num_heads=2, dtype=dtype)

    @property
    def grid(self) -> tuple:
        return (self.img_size[0] // self.patch_size,
                self.img_size[1] // self.patch_size)


class _PatchEmbed(nn.Module):
    def __init__(self, c: ViTPoseConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, c.embed_dim, c.patch_size,
                              stride=c.patch_size)


class _Backbone(nn.Module):
    def __init__(self, c: ViTPoseConfig):
        super().__init__()
        gh, gw = c.grid
        self.patch_embed = _PatchEmbed(c)
        self.pos_embed = nn.Parameter(torch.zeros(1, gh * gw + 1,
                                                  c.embed_dim))
        self.blocks = nn.ModuleList(
            Block(c.embed_dim, c.num_heads, c.mlp_ratio, norm_eps=1e-6)
            for _ in range(c.depth))
        self.last_norm = nn.LayerNorm(c.embed_dim, eps=1e-6)


class _KeypointHead(nn.Module):
    def __init__(self, c: ViTPoseConfig):
        super().__init__()
        ch = c.deconv_channels
        self.deconv_layers = nn.Sequential(
            nn.ConvTranspose2d(c.embed_dim, ch, 4, stride=2, padding=1,
                               bias=False),
            nn.BatchNorm2d(ch), nn.ReLU(),
            nn.ConvTranspose2d(ch, ch, 4, stride=2, padding=1, bias=False),
            nn.BatchNorm2d(ch), nn.ReLU())
        self.final_layer = nn.Conv2d(ch, c.num_keypoints, 1)


class ViTPose(nn.Module):
    def __init__(self, cfg: ViTPoseConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = _Backbone(cfg)
        self.keypoint_head = _KeypointHead(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N, 3, H, W] normalized crops → heatmaps [N, K, H/4, W/4]
        (f32)."""
        c, bb, head = self.cfg, self.backbone, self.keypoint_head
        dt = c.dtype
        gh, gw = c.grid
        proj = bb.patch_embed.proj
        if dt is None:
            x = proj(x)
        else:
            x = F.conv2d(x.to(dt), proj.weight.to(dt), proj.bias.to(dt),
                         proj.stride)
        x = x.flatten(2).transpose(1, 2)                  # [N, gh·gw, C]
        x = x + bb.pos_embed[:, 1:].to(x.dtype)
        for blk in bb.blocks:
            x = blk(x, dt)
        with full_f32():
            x = F.layer_norm(x.float(), bb.last_norm.normalized_shape,
                             bb.last_norm.weight, bb.last_norm.bias,
                             bb.last_norm.eps)
            x = x.transpose(1, 2).reshape(x.shape[0], c.embed_dim, gh, gw)
            layers = head.deconv_layers
            for deconv, bn in ((layers[0], layers[1]), (layers[3], layers[4])):
                x = F.relu(batch_norm(deconv(x), bn, None))
            return head.final_layer(x)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initial values of the JAX model, drawn from ``generator``:
        products lecun-normal (a ConvTranspose2d weight [in, out, kh, kw]
        has flax's transposed-kernel fan-in out·kh·kw), biases 0, norm
        scales 1, BatchNorm statistics 0 and 1, the position embedding
        N(0, 0.02²) truncated at ±2σ."""
        for name, p in self.named_parameters():
            if name == "backbone.pos_embed":
                nn.init.trunc_normal_(p, 0.0, 0.02, -0.04, 0.04,
                                      generator=generator)
            else:
                init_like_jax(p, name, generator)
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()


def decode_heatmaps(heatmaps: torch.Tensor) -> tuple:
    """Heatmaps [N, K, h, w] → (keypoints [N, K, 2] in heatmap pixels,
    scores [N, K]).

    Argmax (the first maximum) with the classic quarter-pixel offset toward
    the higher neighbour, at interior peaks only (1 < x < w−1 and
    1 < y < h−1): border peaks keep their integer coordinate, as mmpose's
    'default' decoding.
    """
    N, K, h, w = heatmaps.shape
    flat = heatmaps.reshape(N, K, h * w)
    idx = flat.argmax(-1)
    scores = flat.gather(-1, idx[..., None])[..., 0]
    yi, xi = idx // w, idx % w

    def at(y, x):
        return flat.gather(-1, (y * w + x)[..., None])[..., 0]

    gx = at(yi, (xi + 1).clamp(max=w - 1)) - at(yi, (xi - 1).clamp(min=0))
    gy = at((yi + 1).clamp(max=h - 1), xi) - at((yi - 1).clamp(min=0), xi)
    xs, ys = xi.float(), yi.float()
    interior = (xs > 1.0) & (xs < w - 1.0) & (ys > 1.0) & (ys < h - 1.0)
    off = torch.where(interior, 0.25, 0.0)
    kps = torch.stack([xs + off * torch.sign(gx), ys + off * torch.sign(gy)],
                      -1)
    return kps, scores


def heatmap_to_image_coords(kps_hm: np.ndarray, bboxes: np.ndarray,
                            heatmap_size: tuple,
                            crop_size: tuple) -> np.ndarray:
    """Heatmap-pixel keypoints → full-frame pixel coordinates.

    Args:
      kps_hm: [N, K, 2]; bboxes: [N, 4] (x, y, w, h) of the crops;
      heatmap_size: (h, w); crop_size: (H, W).
    """
    hy, hx = heatmap_size
    cy, cx = crop_size
    scale = np.array([cx / hx, cy / hy], np.float32)
    kps_crop = kps_hm * scale                             # crop pixels
    wh = bboxes[:, None, 2:4]
    xy = bboxes[:, None, 0:2]
    return xy + kps_crop * wh / np.array([cx, cy], np.float32)
