"""Per-joint 2D detector error statistics for Human3.6M.

Port of ``pmce_tpu/data/noise_stats.py`` (numpy, unchanged).

Parity target: the reference's ``data/Human36M/noise_stats.py:5-123`` — the
MEASURED per-joint (mean, std, weight) of the CPN detector's 2D error,
originally published with AbsPoseLifter (Chang, Moon, Lee — arXiv
1910.12029). The table below carries those measured constants verbatim
(they are data, not code). Note the source lists Head before Nose, the
opposite of the H36M joint-name order; entries are therefore keyed by
joint NAME and mapped into H36M index order explicitly.
"""

from __future__ import annotations

import numpy as np

H36M_JOINT_NUM = 17

H36M_JOINTS_NAME = (
    "Pelvis", "R_Hip", "R_Knee", "R_Ankle", "L_Hip", "L_Knee", "L_Ankle",
    "Torso", "Neck", "Nose", "Head", "L_Shoulder", "L_Elbow", "L_Wrist",
    "R_Shoulder", "R_Elbow", "R_Wrist",
)

# Measured CPN error model, copied from the reference table (source order
# preserved): joint name → ((mean_x, mean_y), (std_x, std_y), weight).
MEASURED_ERROR_DISTRIBUTION = {
    "Pelvis":     ((-0.06, -2.37), (1.33, 2.13), 1.00),
    "R_Hip":      ((-0.83, -2.07), (3.41, 2.69), 1.00),
    "R_Knee":     ((-0.04, -1.01), (1.74, 2.20), 0.95),
    "R_Ankle":    ((0.52, -3.40),  (1.39, 2.14), 0.93),
    "L_Hip":      ((0.78, -2.79),  (3.26, 2.28), 1.00),
    "L_Knee":     ((0.42, -0.15),  (1.53, 1.99), 0.94),
    "L_Ankle":    ((-0.15, -3.78), (1.39, 2.39), 0.93),
    "Torso":      ((-0.05, 0.10),  (1.36, 1.74), 0.99),
    "Neck":       ((0.14, -2.56),  (1.18, 1.15), 0.99),
    "Head":       ((0.09, 0.49),   (1.35, 0.87), 0.99),
    "Nose":       ((0.13, -0.26),  (0.78, 0.59), 0.98),
    "L_Shoulder": ((-0.19, 0.31),  (2.51, 1.48), 0.99),
    "L_Elbow":    ((0.11, -0.60),  (1.79, 1.76), 0.95),
    "L_Wrist":    ((-0.02, 0.88),  (2.02, 2.10), 0.91),
    "R_Shoulder": ((0.52, -0.12),  (2.23, 1.73), 0.99),
    "R_Elbow":    ((0.06, -0.44),  (1.93, 1.63), 0.95),
    "R_Wrist":    ((0.05, 0.16),   (2.02, 2.24), 0.90),
}


def _measured_arrays():
    mean = np.zeros((H36M_JOINT_NUM, 2), np.float32)
    std = np.zeros((H36M_JOINT_NUM, 2), np.float32)
    weight = np.zeros(H36M_JOINT_NUM, np.float32)
    for i, name in enumerate(H36M_JOINTS_NAME):
        m, s, w = MEASURED_ERROR_DISTRIBUTION[name]
        mean[i] = m
        std[i] = s
        weight[i] = w
    return mean, std, weight


class ErrorDistribution:
    """Per-joint gaussian-mixture detector-error model (measured CPN
    defaults, H36M joint order)."""

    def __init__(self, mean: np.ndarray | None = None,
                 std: np.ndarray | None = None,
                 weight: np.ndarray | None = None):
        m_mean, m_std, m_weight = _measured_arrays()
        self.mean = m_mean if mean is None else mean
        self.std = m_std if std is None else std
        # Mixture weight of the "clean" mode; the rest is a 3× wider tail.
        self.weight = m_weight if weight is None else weight

    @classmethod
    def load(cls, path: str) -> "ErrorDistribution":
        with np.load(path) as z:
            return cls(mean=z["mean"], std=z["std"], weight=z["weight"])

    def save(self, path: str) -> None:
        np.savez(path, mean=self.mean, std=self.std, weight=self.weight)

    def perturb(self, joints_2d: np.ndarray,
                rng: np.random.Generator) -> np.ndarray:
        """GT 2D joints [..., 17, 2] → detector-like noisy joints."""
        clean = rng.uniform(size=joints_2d.shape[:-1]) < self.weight
        scale = np.where(clean[..., None], 1.0, 3.0)
        noise = rng.normal(size=joints_2d.shape) * self.std * scale
        return (joints_2d + self.mean + noise).astype(np.float32)
