"""Camera / pixel / world coordinate transforms and bbox helpers.

Port of ``pmce_tpu/ops/coords.py`` (the reference's
``lib/coord_utils.py:45-148`` and ``normalize_screen_coordinates``,
``data/Human36M/dataset.py:532-534``). The transforms take tensors with
any leading batch dims on any device; the bbox helpers are host-side
numpy, for the data pipeline.
"""

from __future__ import annotations

import numpy as np
import torch


def cam2pixel(cam_coord: torch.Tensor, f: torch.Tensor,
              c: torch.Tensor) -> torch.Tensor:
    """Perspective-project camera-space points to pixel coordinates.

    Args:
      cam_coord: [..., N, 3] camera-frame points.
      f: [..., 2] focal lengths (fx, fy).
      c: [..., 2] principal point (cx, cy).

    Returns:
      [..., N, 3] (u, v, z).
    """
    z = cam_coord[..., 2]
    x = cam_coord[..., 0] / z * f[..., 0:1] + c[..., 0:1]
    y = cam_coord[..., 1] / z * f[..., 1:2] + c[..., 1:2]
    return torch.stack([x, y, z], -1)


def world2cam(world_coord: torch.Tensor, R: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    """World → camera frame: ``R @ x + t`` ([..., N, 3], [..., 3, 3],
    [..., 3] → [..., N, 3])."""
    return torch.einsum("...ij,...nj->...ni", R, world_coord) + t[..., None, :]


def pixel2cam(pix_coord: torch.Tensor, c: torch.Tensor,
              f: torch.Tensor) -> torch.Tensor:
    """Back-project pixel coordinates (u, v, z) to the camera frame."""
    z = pix_coord[..., 2:3]
    xy = (pix_coord[..., :2] - c[..., None, :]) * z / f[..., None, :]
    return torch.cat([xy, z], -1)


def normalize_screen_coordinates(x: torch.Tensor, w, h) -> torch.Tensor:
    """Map pixel (u, v) into the width-normalized [-1, 1] convention:
    ``X / w * 2 - [1, h / w]``.

    Args:
      x: [..., 2] pixel coordinates.
      w, h: image width / height (python scalars or tensors broadcastable
        against the leading dims of ``x``).
    """
    dtype = x.dtype if x.is_floating_point() else torch.float32
    w = torch.as_tensor(w, dtype=dtype, device=x.device)
    h = torch.as_tensor(h, dtype=dtype, device=x.device)
    offset = torch.stack([torch.ones_like(w), h / w], -1)
    return x / w[..., None, None] * 2.0 - offset[..., None, :]


def weak_perspective_project(pose3d: torch.Tensor, cam: torch.Tensor,
                             img_res: float) -> torch.Tensor:
    """Weak-perspective projection of the demo camera layer:
    ``((xy + cam[1:3]) * cam[0]) * img_res + img_res`` (the reference's
    OptimzeCamLayer, ``lib/models/project_net.py:13-16``, with ``img_res``
    half the crop size).

    Args:
      pose3d: [..., J, 3].
      cam: [..., 3] (scale, tx, ty).
      img_res: half crop size.

    Returns:
      [..., J, 2] pixel coordinates in the virtual crop.
    """
    xy = pose3d[..., :2] + cam[..., None, 1:3]
    return xy * cam[..., None, 0:1] * img_res + img_res


def get_bbox(joint_img: np.ndarray) -> np.ndarray:
    """Tight bbox (x, y, w, h) around 2D joints."""
    x, y = joint_img[:, 0], joint_img[:, 1]
    xmin, xmax = float(np.min(x)), float(np.max(x))
    ymin, ymax = float(np.min(y)), float(np.max(y))
    return np.array([xmin, ymin, xmax - xmin, ymax - ymin], dtype=np.float32)


def process_bbox(bbox: np.ndarray, aspect_ratio: float,
                 scale: float = 1.0) -> np.ndarray | None:
    """Sanitize a bbox and pad it to a fixed aspect ratio about its center.

    Args:
      bbox: (x, y, w, h).
      aspect_ratio: target width / height.
      scale: multiplicative padding.

    Returns:
      adjusted (x, y, w, h), or None if the bbox is degenerate.
    """
    x, y, w, h = [float(v) for v in bbox]
    x1, y1, x2, y2 = x, y, x + (w - 1), y + (h - 1)
    if not (w * h > 0 and x2 >= x1 and y2 >= y1):
        return None
    bbox = np.array([x1, y1, x2 - x1, y2 - y1], dtype=np.float32)

    w, h = bbox[2], bbox[3]
    c_x, c_y = bbox[0] + w / 2.0, bbox[1] + h / 2.0
    if w > aspect_ratio * h:
        h = w / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    bbox[2] = w * scale
    bbox[3] = h * scale
    bbox[0] = c_x - bbox[2] / 2.0
    bbox[1] = c_y - bbox[3] / 2.0
    return bbox


def get_center_scale(bbox: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Bbox → (center, scale) pair used by affine crop transforms."""
    x, y, w, h = bbox
    center = np.array([x + w * 0.5, y + h * 0.5], dtype=np.float32)
    scale = np.array([w, h], dtype=np.float32)
    return center, scale
