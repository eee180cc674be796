"""Synthetic occlusion augmentation for person crops.

Port of ``pmce_tpu/data/occlusion.py`` (numpy, unchanged).

Functional parity target: the reference's ``lib/utils/_occ_utils.py`` — the
reference pastes random Pascal-VOC object cutouts over training crops
(not wired into its default recipes). Here occluders are procedurally
generated patches (solid / noise / gradient) with the same placement and
area statistics, so the augmentation needs no external dataset. Explicit
RNG, vectorizable over a batch.
"""

from __future__ import annotations

import numpy as np


def sample_occluder(rng: np.random.Generator, max_hw: tuple,
                    area_frac: tuple = (0.02, 0.25)) -> np.ndarray:
    """Generate one occluder patch [h, w, 3] uint8."""
    H, W = max_hw
    area = rng.uniform(*area_frac) * H * W
    aspect = rng.uniform(0.5, 2.0)
    h = int(np.clip(np.sqrt(area * aspect), 4, H - 1))
    w = int(np.clip(np.sqrt(area / aspect), 4, W - 1))
    kind = rng.integers(3)
    if kind == 0:            # solid color
        patch = np.full((h, w, 3), rng.integers(0, 255, 3), np.uint8)
    elif kind == 1:          # noise texture
        patch = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
    else:                    # linear gradient
        g = np.linspace(0, 255, w, dtype=np.float32)[None, :, None]
        base = rng.integers(0, 128, 3).astype(np.float32)
        patch = np.clip(base + g, 0, 255).astype(np.uint8)
        patch = np.broadcast_to(patch, (h, w, 3)).copy()
    return patch


def occlude(image: np.ndarray, rng: np.random.Generator,
            prob: float = 0.5, area_frac: tuple = (0.02, 0.25)
            ) -> np.ndarray:
    """Paste one random occluder into an image crop (with prob ``prob``)."""
    if rng.uniform() > prob:
        return image
    H, W = image.shape[:2]
    patch = sample_occluder(rng, (H, W), area_frac)
    h, w = patch.shape[:2]
    y = int(rng.integers(0, H - h))
    x = int(rng.integers(0, W - w))
    out = image.copy()
    out[y : y + h, x : x + w] = patch
    return out


def occlude_batch(images: np.ndarray, rng: np.random.Generator,
                  prob: float = 0.5) -> np.ndarray:
    """Apply independent occluders to a batch of crops [N, H, W, 3]."""
    return np.stack([occlude(img, rng, prob) for img in images])
