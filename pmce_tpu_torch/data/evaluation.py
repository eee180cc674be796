"""Dataset evaluation protocols (MPJPE / PA-MPJPE / MPVPE / ACCEL).

Port of ``pmce_tpu/data/evaluation.py``, the reference's protocols:

- Human3.6M mesh eval (camera-4 filter, per-action breakdown, SMPL-joint
  root alignment, H36M-regressed joints, per-sequence ACCEL):
  ``data/Human36M/dataset.py:715-849``;
- 3DPW mesh eval: ``data/PW3D/dataset.py:351-462``;
- MPI-INF-3DHP joint eval: ``data/MPII3D/dataset.py:560-625``;
- H36M joint eval: ``data/Human36M/dataset.py:625-713``.

The reference aligns one sample at a time in numpy; here the whole result
set is aligned in one batched f32 Procrustes pass on ``device`` (the card
unless asked), as the JAX package runs it on its device in f32. Everything
else is host numpy in the JAX package's order, so that the same arrays give
the same numbers.

ACCEL accumulation keeps the reference's semantics: windows are walked in
order; when the video name changes, the finished buffer's acceleration
error is padded with a zero at each end, averaged including those zeros,
weighted by the buffer length and added to the accumulator; the last
buffer is flushed the same way and the sum divided by the number of
evaluated windows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pmce_tpu_torch.ops.metrics import per_joint_error
from pmce_tpu_torch.ops.procrustes import rigid_align

H36M_EVAL_JOINTS = (1, 2, 3, 4, 5, 6, 8, 10, 11, 12, 13, 14, 15, 16)

H36M_ACTION_NAMES = (
    "Directions", "Discussion", "Eating", "Greeting", "Phoning", "Posing",
    "Purchases", "Sitting", "SittingDown", "Smoking", "Photo", "Waiting",
    "Walking", "WalkDog", "WalkTogether",
)


def _pa_per_joint_errors(pred: np.ndarray, gt: np.ndarray,
                         device) -> np.ndarray:
    """Per-sample Procrustes-aligned per-joint errors [N, J], one batched
    f32 pass on ``device``."""
    p = torch.as_tensor(pred, dtype=torch.float32, device=device)
    g = torch.as_tensor(gt, dtype=torch.float32, device=device)
    return per_joint_error(rigid_align(p, g), g).cpu().numpy()


def _per_joint_errors(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    return np.sqrt(np.sum((pred - gt) ** 2, axis=-1))


def sequence_accel_error(pred: np.ndarray, gt: np.ndarray,
                         seq_names: np.ndarray) -> float:
    """Per-contiguous-sequence acceleration error, reference semantics."""
    n = len(pred)
    if n == 0:
        return 0.0
    acc = 0.0
    buf_p: list = []
    buf_g: list = []
    last = None

    def flush():
        p = np.asarray(buf_p)
        g = np.asarray(buf_g)
        accel_err = np.zeros(len(p))
        if len(p) > 2:
            a_g = g[:-2] - 2 * g[1:-1] + g[2:]
            a_p = p[:-2] - 2 * p[1:-1] + p[2:]
            accel_err[1:-1] = np.mean(
                np.linalg.norm(a_p - a_g, axis=2), axis=1)
        return float(np.mean(accel_err)) * len(p)

    for i in range(n):
        name = seq_names[i]
        if last is not None and name != last:
            acc += flush()
            buf_p, buf_g = [pred[i]], [gt[i]]
        else:
            buf_p.append(pred[i])
            buf_g.append(gt[i])
        last = name
    acc += flush()
    return acc / n


@dataclasses.dataclass
class MeshEvalResult:
    mpjpe: float
    pa_mpjpe: float
    mpvpe: float
    accel: float
    smpl_joint_error: float
    per_action: dict | None = None

    def summary(self, tag: str = "") -> str:
        lines = [
            f"{tag}MPJPE (mm)     >> tot: {self.mpjpe:.2f}",
            f"{tag}PA-MPJPE (mm)  >> tot: {self.pa_mpjpe:.2f}",
            f"{tag}MPVPE (mm)     >> tot: {self.mpvpe:.2f}",
            f"{tag}ACCEL (mm/s^2) >> tot: {self.accel:.2f}",
        ]
        if self.per_action:
            for k, v in self.per_action.items():
                lines.append(f"  {k}: MPJPE {v[0]:.2f} PA {v[1]:.2f}")
        return "\n".join(lines)


def evaluate_mesh(pred_mesh: np.ndarray, gt_mesh: np.ndarray,
                  J_reg_smpl: np.ndarray, J_reg_h36m: np.ndarray,
                  seq_names: np.ndarray,
                  gt_h36m_joints: np.ndarray | None = None,
                  keep_mask: np.ndarray | None = None,
                  action_ids: np.ndarray | None = None,
                  smpl_root_idx: int = 0, device="cuda") -> MeshEvalResult:
    """Full mesh evaluation suite.

    Args:
      pred_mesh, gt_mesh: [N, V, 3] millimeters (camera frame).
      J_reg_smpl: [24, V]; J_reg_h36m: [17, V].
      seq_names: [N] video identity per window (for ACCEL grouping).
      gt_h36m_joints: optional [N, 17, 3] dataset GT joints; if None the
        H36M joints are regressed from the GT mesh (PW3D behavior).
      keep_mask: optional [N] bool filter applied FIRST (H36M camera-4).
      action_ids: optional [N] int for the per-action breakdown.
      device: where the Procrustes pass runs.

    Returns:
      MeshEvalResult.
    """
    if keep_mask is not None:
        sel = np.nonzero(keep_mask)[0]
        pred_mesh, gt_mesh = pred_mesh[sel], gt_mesh[sel]
        seq_names = seq_names[sel]
        if gt_h36m_joints is not None:
            gt_h36m_joints = gt_h36m_joints[sel]
        if action_ids is not None:
            action_ids = action_ids[sel]
    n = len(pred_mesh)
    if n == 0:
        return MeshEvalResult(0, 0, 0, 0, 0)

    # SMPL-joint root alignment (mesh + smpl joints).
    j_out = np.einsum("jv,nvk->njk", J_reg_smpl, pred_mesh)
    j_gt = np.einsum("jv,nvk->njk", J_reg_smpl, gt_mesh)
    root_out = j_out[:, smpl_root_idx:smpl_root_idx + 1]
    root_gt = j_gt[:, smpl_root_idx:smpl_root_idx + 1]
    mesh_out_al = pred_mesh - root_out
    mesh_gt_al = gt_mesh - root_gt
    mpvpe = float(np.mean(_per_joint_errors(mesh_out_al, mesh_gt_al)))
    smpl_joint_err = float(np.mean(
        _per_joint_errors(j_out - root_out, j_gt - root_gt)))

    # H36M-regressed joints, root-aligned, then the eval-joint subset.
    eval_idx = np.asarray(H36M_EVAL_JOINTS)
    h_out = np.einsum("jv,nvk->njk", J_reg_h36m, mesh_out_al)
    h_out = h_out - h_out[:, :1]
    h_out = h_out[:, eval_idx]
    if gt_h36m_joints is not None:
        h_gt = gt_h36m_joints - gt_h36m_joints[:, :1]
    else:
        h_gt = np.einsum("jv,nvk->njk", J_reg_h36m, mesh_gt_al)
        h_gt = h_gt - h_gt[:, :1]
    h_gt = h_gt[:, eval_idx]

    mpjpe_per = _per_joint_errors(h_out, h_gt)
    mpjpe = float(np.mean(mpjpe_per))
    pa_per = _pa_per_joint_errors(h_out, h_gt, device)
    pa_mpjpe = float(np.mean(pa_per))

    accel = sequence_accel_error(h_out, h_gt, seq_names)

    per_action = None
    if action_ids is not None:
        per_action = {}
        for a in np.unique(action_ids):
            m = action_ids == a
            name = (H36M_ACTION_NAMES[a]
                    if 0 <= a < len(H36M_ACTION_NAMES) else str(a))
            per_action[name] = (
                float(np.mean(mpjpe_per[m])), float(np.mean(pa_per[m])))

    return MeshEvalResult(mpjpe=mpjpe, pa_mpjpe=pa_mpjpe, mpvpe=mpvpe,
                          accel=accel, smpl_joint_error=smpl_joint_err,
                          per_action=per_action)


@dataclasses.dataclass
class JointEvalResult:
    mpjpe: float
    pa_mpjpe: float
    accel: float

    def summary(self, tag: str = "") -> str:
        return (f"{tag}MPJPE (mm)     >> tot: {self.mpjpe:.2f}\n"
                f"{tag}PA-MPJPE (mm)  >> tot: {self.pa_mpjpe:.2f}\n"
                f"{tag}ACCEL (mm/s^2) >> tot: {self.accel:.2f}")


def evaluate_joints(pred: np.ndarray, gt: np.ndarray,
                    seq_names: np.ndarray,
                    root_idx: int = 0,
                    eval_joints: tuple | None = None,
                    keep_mask: np.ndarray | None = None,
                    device="cuda") -> JointEvalResult:
    """Joint-only evaluation (Stage-1 / MPII3D protocols).

    Args:
      pred, gt: [N, J, 3] millimeters.
      root_idx: alignment joint (0 for h36m/mpii3d, -2 = pelvis for the
        19-joint coco set, reference PW3D dataset.py:306-309).
      eval_joints: optional subset applied AFTER root alignment.
      device: where the Procrustes pass runs.
    """
    if keep_mask is not None:
        sel = np.nonzero(keep_mask)[0]
        pred, gt, seq_names = pred[sel], gt[sel], seq_names[sel]
    pred = pred - pred[:, root_idx][:, None, :]
    gt = gt - gt[:, root_idx][:, None, :]
    if eval_joints is not None:
        idx = np.asarray(eval_joints)
        pred, gt = pred[:, idx], gt[:, idx]
    mpjpe = float(np.mean(_per_joint_errors(pred, gt)))
    pa_per = _pa_per_joint_errors(pred, gt, device)
    accel = sequence_accel_error(pred, gt, seq_names)
    return JointEvalResult(mpjpe=mpjpe, pa_mpjpe=float(np.mean(pa_per)),
                           accel=accel)
