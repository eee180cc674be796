"""Crop / resize / normalize of demo frames as batched products.

Port of ``pmce_tpu/demo/preprocess.py``. The crop and resize is separable
bilinear resampling,

    crop = R_y · frame · R_xᵀ,

where R_y [S, H] and R_x [S, W] are per-crop interpolation operators with
two nonzeros per row, built on the frames' device from the boxes (the same
one-hot construction as JAX's, so boxes that leave the frame clamp to the
edge pixels exactly as there). The two contractions are batched products;
the ImageNet normalization follows. ``F.interpolate`` and ``grid_sample``
place samples and treat edges differently, so they are not used.

Normalization constants match torchvision's ImageNet preprocessing used by
the reference's feature extractor.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _interp_matrix(start: torch.Tensor, extent: torch.Tensor,
                   src_size: int, out_size: int) -> torch.Tensor:
    """Bilinear resampling operators [..., out_size, src_size] along one
    axis, for crop starts and lengths ``start``, ``extent`` [...] in
    source pixels (pixel-center convention, as cv2.resize INTER_LINEAR)."""
    i = torch.arange(out_size, dtype=torch.float32, device=start.device)
    src = start[..., None] + (i + 0.5) * extent[..., None] / out_size - 0.5
    src = src.clamp(0.0, src_size - 1.0)
    lo = torch.floor(src)
    w_hi = src - lo
    lo_i = lo.long()
    hi_i = torch.clamp(lo_i + 1, max=src_size - 1)
    return (F.one_hot(lo_i, src_size).float() * (1.0 - w_hi)[..., None]
            + F.one_hot(hi_i, src_size).float() * w_hi[..., None])


def crop_resize_normalize(frames: torch.Tensor, bboxes: torch.Tensor,
                          out_size: int | tuple = 224) -> torch.Tensor:
    """Batched crop + bilinear resize + ImageNet normalization.

    Args:
      frames: [N, H, W, 3] uint8 (or float 0..255) source frames.
      bboxes: [N, 4] (x, y, w, h) crop boxes in pixels, on the frames'
        device.
      out_size: an int for square crops (224 for the feature extractor) or
        an (out_h, out_w) tuple (256×192 for ViTPose: the box height maps
        onto out_h rows and the box width onto out_w columns, so keypoint
        decode scales stay consistent).

    Returns:
      [N, 3, out_h, out_w] float32, normalized, channel-first.
    """
    out_h, out_w = ((out_size, out_size) if isinstance(out_size, int)
                    else out_size)
    N, H, W, _ = frames.shape
    b = bboxes.float()
    ry = _interp_matrix(b[:, 1], b[:, 3], H, out_h)      # [N, S, H]
    rx = _interp_matrix(b[:, 0], b[:, 2], W, out_w)      # [N, S, W]
    frames = frames.float()
    tmp = torch.einsum("nsh,nhwc->nswc", ry, frames)
    crops = torch.einsum("ntw,nswc->nstc", rx, tmp)
    mean = torch.tensor(IMAGENET_MEAN, device=frames.device)
    std = torch.tensor(IMAGENET_STD, device=frames.device)
    crops = (crops / 255.0 - mean) / std
    return crops.permute(0, 3, 1, 2).contiguous()


def resize_frames(frames: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    """Whole-frame bilinear resize with shared operators.

    Args:
      frames: [N, H, W, 3] uint8/float 0..255.
      out_hw: (out_h, out_w).

    Returns:
      [N, out_h, out_w, 3] float32 in 0..1 (detector input convention).
    """
    N, H, W, _ = frames.shape
    oh, ow = out_hw
    zero = torch.zeros((), device=frames.device)
    ry = _interp_matrix(zero, zero + H, H, oh)
    rx = _interp_matrix(zero, zero + W, W, ow)
    tmp = torch.einsum("sh,nhwc->nswc", ry, frames.float())
    out = torch.einsum("tw,nswc->nstc", rx, tmp)
    return out / 255.0


def square_crop_bbox(bbox_xywh, scale: float = 1.1):
    """Tight bbox → scaled square crop box (demo convention): a square
    patch around the person with a 1.1–1.3 scale factor, as the reference
    crops (lib/utils/_img_utils.py)."""
    bbox = np.asarray(bbox_xywh, np.float32)
    x, y, w, h = bbox[..., 0], bbox[..., 1], bbox[..., 2], bbox[..., 3]
    cx, cy = x + w / 2.0, y + h / 2.0
    size = np.maximum(w, h) * scale
    return np.stack([cx - size / 2.0, cy - size / 2.0, size, size], axis=-1)
