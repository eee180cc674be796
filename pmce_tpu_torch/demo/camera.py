"""Weak-perspective camera fitting for the demo overlay.

Port of ``pmce_tpu/demo/camera.py``. The reference fits 3 camera
parameters (scale, tx, ty) per clip window with 300 Adam steps on an L1
reprojection loss (main/run_demo.py:134-173, lib/models/project_net.py).

The projection model is affine in disguise:
    u = (x + tx) · s · r + r,   v = (y + ty) · s · r + r,   r = crop/2
so with a = s·r, bx = s·r·tx, by = s·r·ty the least-squares fit is a
2-variable linear solve, in closed form for a whole batch of windows
(:func:`fit_cam_closed_form`). :func:`fit_cam_iterative` polishes it with
Adam under the reference's L1 objective, as the JAX package does with
optax (torch's Adam takes the same steps: eps outside the square root,
both moments bias-corrected).
"""

from __future__ import annotations

import numpy as np
import torch

from pmce_tpu_torch.ops.coords import weak_perspective_project


def fit_cam_closed_form(pose3d: torch.Tensor, target2d: torch.Tensor,
                        img_res: float) -> torch.Tensor:
    """Closed-form weak-perspective fit, batched.

    Args:
      pose3d: [..., J, 3] predicted joints (camera frame).
      target2d: [..., J, 2] detected 2D joints in the virtual crop.
      img_res: half crop size (reference: crop_size / 2 = 250).

    Returns:
      [..., 3] camera (scale, tx, ty).
    """
    x = pose3d[..., :2]
    t = (target2d - img_res) / img_res
    # Minimize Σ ||a·x + b − t||² with a shared scalar a and a per-axis
    # offset b = a·(tx, ty).
    xm = x.mean(-2, keepdim=True)
    tm = t.mean(-2, keepdim=True)
    xc = x - xm
    tc = t - tm
    a = ((xc * tc).sum((-2, -1))
         / (xc * xc).sum((-2, -1)).clamp_min(1e-12))
    # Degenerate fits (collapsed keypoints, anti-correlated joints) give
    # a ≤ 0, and near-collapsed 3D joints (an untrained lifter) make it
    # explode; a body fitted to a detector crop never needs a scale over
    # ~4. Clamping keeps tx/ty bounded and the rasterizer's work O(H·W).
    a = a.clamp(1e-3, 4.0)
    b = tm[..., 0, :] - a[..., None] * xm[..., 0, :]
    return torch.cat([a[..., None], b / a[..., None]], -1)


def fit_cam_iterative(pose3d: torch.Tensor, target2d: torch.Tensor,
                      img_res: float, steps: int = 50,
                      lr: float = 0.05) -> torch.Tensor:
    """Adam polish of the closed-form fit under the reference's L1 loss."""
    with torch.no_grad():
        cam0 = fit_cam_closed_form(pose3d, target2d, img_res)
    cam = cam0.clone().requires_grad_(True)
    opt = torch.optim.Adam([cam], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(steps):
        opt.zero_grad()
        proj = weak_perspective_project(pose3d, cam, img_res)
        (proj - target2d).abs().mean().backward()
        opt.step()
    return cam.detach()


def convert_crop_cam_to_orig_img(cam, bbox, img_width: float,
                                 img_height: float) -> np.ndarray:
    """Crop-space weak-perspective camera → full-frame camera.

    Parity: the reference's main/run_demo.py:49-67.

    Args:
      cam: [N, 3] (s, tx, ty); bbox: [N, 4] (x, y, w, h).

    Returns:
      [N, 4] (sx, sy, tx, ty) in full-frame normalized coordinates.
    """
    cam = np.asarray(cam)
    bbox = np.asarray(bbox)
    x, y, w, h = bbox[:, 0], bbox[:, 1], bbox[:, 2], bbox[:, 3]
    cx, cy = x + w / 2.0, y + h / 2.0
    hw, hh = img_width / 2.0, img_height / 2.0
    sx = cam[:, 0] * (1.0 / (img_width / h))
    sy = cam[:, 0] * (1.0 / (img_height / h))
    tx = ((cx - hw) / hw / sx) + cam[:, 1]
    ty = ((cy - hh) / hh / sy) + cam[:, 2]
    return np.stack([sx, sy, tx, ty], axis=-1)
