"""Synthetic 2D keypoint detector-error model (COCO-17 convention).

Port of ``pmce_tpu/data/noise.py`` (numpy, unchanged: the same draws
from the same ``Generator`` give the same keypoints, bit for bit).

Behavioral parity target: ``synthesize_pose`` (the reference's
``lib/noise_utils.py:17-284``), the COCO keypoint error model
of Pose2Mesh: per joint, with probabilities conditioned on the joint group
(face / upper body / lower body) and the number of valid joints, inject one
of

- GOOD:     a detection within the OKS-0.85 radius of the GT;
- JITTER:   a detection in the OKS-0.85..0.50 annulus;
- MISS:     a detection in the OKS-0.50..0.10 annulus;
- INVERSION: a detection near the left/right-symmetric partner joint;
- SWAP:     (a detection near another person — disabled in the reference's
            effective configuration, ``swap_exist = False`` / final
            ``swap_prob = 0``; preserved here as disabled).

OKS radii derive from the published COCO per-keypoint sigmas and the person
area: d(ks) = sqrt(-2 · area · (2σ)² · ln ks).

Differences from the reference, by design: fully vectorized over joints,
an explicit ``numpy.random.Generator`` (the reference uses the global
``random``/``np.random`` state), and direct annulus sampling instead of
the reference's 500-candidate rejection loops (the rejection step only
prunes candidates that land near other candidate centers; with swap
disabled its effect is negligible and the marginal radius/angle law is
identical).
"""

from __future__ import annotations

import numpy as np

# Published COCO keypoint sigmas (scaled ×0.1 like the reference).
KPS_SIGMAS = np.array([
    .26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07,
    .87, .87, .89, .89]) / 10.0
NUM_KPS = 17
KPS_SYMMETRY = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12),
                (13, 14), (15, 16))

_FACE = np.arange(0, 5)
_UPPER = np.arange(5, 11)


def oks_distance(ks: float, area: float) -> np.ndarray:
    """Distance at which the keypoint similarity drops to ``ks``: [17]."""
    variances = (KPS_SIGMAS * 2) ** 2
    return np.sqrt(-2 * area * variances * np.log(ks))


def _jitter_probs(num_valid: int) -> np.ndarray:
    p = np.zeros(NUM_KPS)
    lo = num_valid <= 10
    p[[0, 13, 14, 15, 16]] = 0.15 if lo else 0.10   # nose, knees, ankles
    p[1:11] = 0.20 if lo else 0.15                  # face/upper body
    p[[11, 12]] = 0.25 if lo else 0.20              # hips
    return p


def _miss_probs(num_valid: int) -> np.ndarray:
    p = np.zeros(NUM_KPS)
    if num_valid <= 5:
        face, sa, other = 0.15, 0.20, 0.25
    elif num_valid <= 10:
        face, sa, other = 0.10, 0.13, 0.15
    else:
        face, sa, other = 0.02, 0.05, 0.10
    p[:] = other
    p[_FACE] = face
    p[[5, 6, 15, 16]] = sa                          # shoulders, ankles
    return p


def _inv_probs() -> np.ndarray:
    p = np.full(NUM_KPS, 0.06)                      # lower body
    p[_FACE] = 0.01
    p[_UPPER] = 0.03
    return p


def _annulus(rng: np.random.Generator, centers: np.ndarray,
             r_lo: np.ndarray, r_hi: np.ndarray) -> np.ndarray:
    """Sample one point per row uniformly in [r_lo, r_hi] × [0, 2π)."""
    n = len(centers)
    angle = rng.uniform(0, 2 * np.pi, n)
    r = rng.uniform(r_lo, r_hi)
    return centers + np.stack([r * np.cos(angle), r * np.sin(angle)], -1)


def synthesize_pose(joints: np.ndarray, area: float,
                    rng: np.random.Generator,
                    num_overlap: int = 0) -> np.ndarray:
    """Inject detector-style error into GT 2D keypoints.

    Args:
      joints: [17, 3] (x, y, valid) GT keypoints.
      area: person area in pixels² (bbox area).
      rng: explicit random generator.
      num_overlap: overlapping-person count (kept for API parity; the swap
        channel it gates is disabled, as in the reference).

    Returns:
      [17, 3] noisy keypoints; a joint whose every error channel is
      unavailable is zeroed (validity 0), like the reference.
    """
    d10 = oks_distance(0.10, area)
    d50 = oks_distance(0.50, area)
    d85 = oks_distance(0.85, area)

    out = joints.copy().astype(np.float32)
    valid = joints[:, 2] > 0
    num_valid = int(valid.sum())

    p_jit = _jitter_probs(num_valid)
    p_miss = _miss_probs(num_valid)
    p_inv = _inv_probs()

    # Symmetric partner per joint (-1 = none).
    pair = np.full(NUM_KPS, -1)
    for q, w in KPS_SYMMETRY:
        pair[q], pair[w] = w, q
    has_pair = (pair >= 0) & np.where(pair >= 0, valid[pair], False)

    # Good keeps its PRIOR mass (1 − all channel priors); an unavailable
    # inversion channel is zeroed and the deficit renormalizes across ALL
    # remaining channels proportionally — the reference divides every
    # channel by the sum of the available ones (noise_utils.py:258-276),
    # it does not fold the missing mass into good alone.
    p_good = 1.0 - (p_jit + p_miss + p_inv)
    p_inv = np.where(has_pair, p_inv, 0.0)
    probs = np.stack([p_good, p_jit, p_miss, p_inv], axis=1)
    probs /= probs.sum(1, keepdims=True)

    gt = joints[:, :2]
    pair_xy = gt[np.maximum(pair, 0)]

    candidates = np.stack([
        _annulus(rng, gt, np.zeros(NUM_KPS), d85),          # good
        _annulus(rng, gt, d85, d50),                        # jitter
        _annulus(rng, gt, d50, d10),                        # miss
        _annulus(rng, pair_xy, np.zeros(NUM_KPS), d50),     # inversion
    ], axis=1)                                              # [17, 4, 2]

    choice = np.array([rng.choice(4, p=probs[j]) for j in range(NUM_KPS)])
    out[:, :2] = candidates[np.arange(NUM_KPS), choice]
    out[:, 2] = 1.0
    out[~valid] = joints[~valid]
    return out
