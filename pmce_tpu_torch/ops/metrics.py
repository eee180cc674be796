"""Evaluation metrics on tensors: MPJPE, PA-MPJPE, MPVPE, acceleration.

Port of ``pmce_tpu/ops/metrics.py`` (the reference's batch metrics,
``data/Human36M/dataset.py:600-623``, and acceleration error,
``lib/eval_utils.py:24-52``). Sequence bookkeeping (grouping windows into
videos) stays on the host, in :mod:`pmce_tpu_torch.data.evaluation`.
"""

from __future__ import annotations

import torch

from pmce_tpu_torch.ops.procrustes import rigid_align


def per_joint_error(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Euclidean error per joint: [..., J, 3] → [..., J]."""
    return (pred - gt).square().sum(-1).sqrt()


def mpjpe(pred: torch.Tensor, gt: torch.Tensor,
          root_idx: int | None = 0) -> torch.Tensor:
    """Mean per-joint position error after optional root alignment.

    Args:
      pred, gt: [..., J, 3].
      root_idx: joint used for root alignment; None skips alignment.

    Returns:
      scalar (mean over every batch element and joint).
    """
    if root_idx is not None:
        pred = pred - pred[..., root_idx:root_idx + 1, :]
        gt = gt - gt[..., root_idx:root_idx + 1, :]
    return per_joint_error(pred, gt).mean()


def pa_mpjpe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Procrustes-aligned MPJPE (per-sample similarity alignment)."""
    return per_joint_error(rigid_align(pred, gt), gt).mean()


def mpvpe(pred_verts: torch.Tensor, gt_verts: torch.Tensor) -> torch.Tensor:
    """Mean per-vertex position error (inputs already root-aligned)."""
    return per_joint_error(pred_verts, gt_verts).mean()


def accel(joints: torch.Tensor) -> torch.Tensor:
    """Second finite difference magnitude of a joint sequence.

    Args:
      joints: [N, J, 3] sequence.

    Returns:
      [N-2] per-frame mean acceleration norms.
    """
    vel = joints[1:] - joints[:-1]
    acc = vel[1:] - vel[:-1]
    return torch.linalg.vector_norm(acc, dim=-1).mean(-1)


def accel_error(joints_gt: torch.Tensor,
                joints_pred: torch.Tensor) -> torch.Tensor:
    """Acceleration error between two sequences.

    Args:
      joints_gt, joints_pred: [N, J, 3].

    Returns:
      [N-2] per-frame mean acceleration error norms.
    """
    a_gt = joints_gt[:-2] - 2 * joints_gt[1:-1] + joints_gt[2:]
    a_pr = joints_pred[:-2] - 2 * joints_pred[1:-1] + joints_pred[2:]
    return torch.linalg.vector_norm(a_pr - a_gt, dim=-1).mean(-1)
