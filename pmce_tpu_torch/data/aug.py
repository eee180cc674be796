"""2D/3D joint augmentation: flips, in-plane rotation, affine crops.

Port of ``pmce_tpu/data/aug.py`` (numpy, unchanged).

Functional parity targets: reference lib/aug_utils.py —
``flip_2d_joint``/``flip_3d_joint`` (:33-48), ``j2d_processing``/
``j3d_processing`` (:51-83), ``augm_params`` (:98-117), and
``get_affine_transform`` (:140-179) re-derived without OpenCV: the 2×3
affine map is solved directly from the three (src, dst) point pairs.

All functions are host-side numpy with explicit RNGs (the reference uses
the global ``random`` state).
"""

from __future__ import annotations

import numpy as np


def flip_2d_joint(kp: np.ndarray, width: float,
                  flip_pairs) -> np.ndarray:
    """Mirror 2D keypoints horizontally and swap left/right joints."""
    kp = kp.copy()
    kp[:, 0] = width - kp[:, 0] - 1
    for a, b in flip_pairs:
        kp[[a, b]] = kp[[b, a]]
    return kp


def flip_3d_joint(kp: np.ndarray, flip_pairs) -> np.ndarray:
    """Swap left/right joints and negate x."""
    kp = kp.copy()
    for a, b in flip_pairs:
        kp[[a, b]] = kp[[b, a]]
    kp[:, 0] = -kp[:, 0]
    return kp


def _rotate_2d(pt: np.ndarray, rad: float) -> np.ndarray:
    sn, cs = np.sin(rad), np.cos(rad)
    return np.array([pt[0] * cs - pt[1] * sn, pt[0] * sn + pt[1] * cs],
                    dtype=np.float32)


def get_affine_transform(center: np.ndarray, scale: np.ndarray, rot: float,
                         output_size, inv: bool = False) -> np.ndarray:
    """2×3 affine mapping a (center, scale, rot) box onto the output crop.

    Same three-point construction as the reference (center, a rotated
    'up' direction point, and their 90°-rotated third point), but the
    linear system is solved in numpy instead of cv2.getAffineTransform.
    """
    center = np.asarray(center, np.float32)
    scale = np.asarray(scale, np.float32)
    src_w = scale[0]
    dst_w, dst_h = float(output_size[0]), float(output_size[1])

    rot_rad = np.pi * rot / 180.0
    src_dir = _rotate_2d(np.array([0.0, src_w * -0.5]), rot_rad)
    dst_dir = np.array([0.0, dst_w * -0.5], np.float32)

    def third(a, b):
        d = a - b
        return b + np.array([-d[1], d[0]], np.float32)

    src = np.zeros((3, 2), np.float32)
    dst = np.zeros((3, 2), np.float32)
    src[0] = center
    src[1] = center + src_dir
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = dst[0] + dst_dir
    src[2] = third(src[0], src[1])
    dst[2] = third(dst[0], dst[1])

    if inv:
        src, dst = dst, src

    # Solve A·[x, y, 1]ᵀ = dst for the 2×3 matrix A.
    ones = np.ones((3, 1), np.float32)
    P = np.concatenate([src, ones], axis=1)          # [3, 3]
    A = np.linalg.solve(P, dst).T                    # [2, 3]
    return A.astype(np.float32)


def affine_transform(pt: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Apply a 2×3 affine to one 2D point."""
    return (t @ np.array([pt[0], pt[1], 1.0]))[:2]


def affine_transform_batch(pts: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Apply a 2×3 affine to [N, 2] points (vectorized)."""
    homo = np.concatenate(
        [pts, np.ones((*pts.shape[:-1], 1), pts.dtype)], axis=-1)
    return homo @ t.T


def j2d_processing(kp: np.ndarray, res, bbox: np.ndarray, rot: float,
                   flip: bool, flip_pairs) -> tuple:
    """Affine-warp GT 2D keypoints into the crop, with optional flip.

    Args:
      kp: [J, 2+] keypoints (pixels).
      res: (out_w, out_h) crop resolution.
      bbox: (x, y, w, h).

    Returns:
      (warped keypoints float32, the 2×3 transform used).
    """
    x, y, w, h = bbox
    center = np.array([x + w * 0.5, y + h * 0.5], np.float32)
    scale = np.array([w, h], np.float32)
    trans = get_affine_transform(center, scale, rot, res)
    kp = kp.copy().astype(np.float32)
    kp[:, :2] = affine_transform_batch(kp[:, :2], trans)
    if flip:
        kp = flip_2d_joint(kp, res[0], flip_pairs)
    return kp.astype(np.float32), trans


def j3d_processing(S: np.ndarray, rot: float, flip: bool,
                   flip_pairs) -> np.ndarray:
    """In-plane-rotate (and optionally flip) 3D joints."""
    rot_mat = np.eye(3, dtype=np.float32)
    if rot != 0:
        rad = -rot * np.pi / 180.0
        sn, cs = np.sin(rad), np.cos(rad)
        rot_mat[0, :2] = [cs, -sn]
        rot_mat[1, :2] = [sn, cs]
    S = S @ rot_mat.T
    if flip:
        S = flip_3d_joint(S, flip_pairs)
    return S.astype(np.float32)


def augm_params(rng: np.random.Generator, is_train: bool,
                do_flip: bool, rotate_factor: float) -> tuple:
    """Sample (flip, rot) augmentation parameters.

    Same law as the reference: flip w.p. 1/2 when enabled; rotation
    N(0, rf) clipped to ±2·rf, then zeroed w.p. 1/2.
    """
    if not is_train:
        return 0, 0.0
    flip = 1 if (do_flip and rng.uniform() <= 0.5) else 0
    rot = float(np.clip(rng.normal() * rotate_factor,
                        -2 * rotate_factor, 2 * rotate_factor))
    if rng.uniform() <= 0.5:
        rot = 0.0
    return flip, rot
