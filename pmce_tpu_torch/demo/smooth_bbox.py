"""Temporal bbox smoothing from 2D keypoint tracks.

Port of ``pmce_tpu/demo/smooth_bbox.py`` (numpy, unchanged).

Functional parity target: reference lib/utils/smooth_bbox.py —
keypoints → (cx, cy, scale) params with the 150-px person-height
normalization, linear interpolation across detection gaps, then median +
gaussian filtering. Re-derived scipy-free (vectorized median filter and an
explicit truncated-gaussian convolution matching scipy's defaults).
"""

from __future__ import annotations

import numpy as np


def kp_to_bbox_param(kp: np.ndarray | None,
                     vis_thresh: float) -> np.ndarray | None:
    """2D keypoints → (cx, cy, scale); scale normalizes height to 150 px."""
    if kp is None:
        return None
    vis = kp[:, 2] > vis_thresh
    if not np.any(vis):
        return None
    min_pt = np.min(kp[vis, :2], axis=0)
    max_pt = np.max(kp[vis, :2], axis=0)
    height = float(np.linalg.norm(max_pt - min_pt))
    if height < 0.5:
        return None
    center = (min_pt + max_pt) / 2.0
    return np.array([center[0], center[1], 150.0 / height], np.float32)


def get_all_bbox_params(kps: list, vis_thresh: float = 2.0):
    """Per-frame params with linear interpolation across gaps.

    Returns:
      (params [M, 3], start_index inclusive, end_index exclusive).
    """
    params: list = []
    gap = 0
    start = -1
    i = -1
    for i, kp in enumerate(kps):
        p = kp_to_bbox_param(kp, vis_thresh)
        if p is None:
            gap += 1
            continue
        if start == -1:
            start = i
            gap = 0
        if gap > 0 and params:
            prev = params[-1]
            interp = np.linspace(prev, p, gap + 2)[1:-1]
            params.extend(interp)
            gap = 0
        params.append(p)
    arr = (np.stack(params).astype(np.float32)
           if params else np.empty((0, 3), np.float32))
    return arr, start, i - gap + 1


def median_filter_1d(x: np.ndarray, kernel_size: int) -> np.ndarray:
    """scipy.signal.medfilt semantics: zero-padded, odd kernel."""
    assert kernel_size % 2 == 1
    half = kernel_size // 2
    padded = np.pad(x, (half, half))
    windows = np.lib.stride_tricks.sliding_window_view(padded, kernel_size)
    return np.median(windows, axis=-1)


def gaussian_filter_1d(x: np.ndarray, sigma: float,
                       truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage.gaussian_filter1d semantics: reflect padding."""
    radius = int(truncate * sigma + 0.5)
    t = np.arange(-radius, radius + 1)
    kernel = np.exp(-0.5 * (t / sigma) ** 2)
    kernel /= kernel.sum()
    padded = np.pad(x, (radius, radius), mode="reflect")
    return np.convolve(padded, kernel, mode="valid")


def smooth_bbox_params(params: np.ndarray, kernel_size: int = 11,
                       sigma: float = 8.0) -> np.ndarray:
    out = np.stack([median_filter_1d(c, kernel_size) for c in params.T]).T
    return np.stack([gaussian_filter_1d(c, sigma) for c in out.T]).T


def get_smooth_bbox_params(kps: list, vis_thresh: float = 2.0,
                           kernel_size: int = 11, sigma: float = 3.0):
    """Full pipeline: params + gap interpolation + median + gaussian."""
    params, start, end = get_all_bbox_params(kps, vis_thresh)
    smoothed = smooth_bbox_params(params, kernel_size, sigma)
    smoothed = np.vstack([np.zeros((max(start, 0), 3), np.float32),
                          smoothed])
    return smoothed, start, end
