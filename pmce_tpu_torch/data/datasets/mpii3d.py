"""MPI-INF-3DHP dataset family.

Port of ``pmce_tpu/data/datasets/mpii3d.py``. Protocol of the reference
(``data/MPII3D/dataset.py``):

- train: NeuralAnnot SMPL fits, COCO-19 noisy 2D inputs, a 2D-reprojection
  fitting gate (threshold in 64×64-crop pixels, :31,368-380) zeroing all
  validities on bad fits;
- val: 3D joints in the H36M-17 order (:266-272), ViTPose 2D inputs, the
  mesh targets zeroed (:495-502): only joints count;
- evaluation: joint-only MPJPE / PA-MPJPE / ACCEL about joint 0
  (:560-625).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pmce_tpu_torch.data.datasets.base import (
    VideoMeshDataset,
    synthetic_regressors,
)
from pmce_tpu_torch.data.evaluation import evaluate_joints
from pmce_tpu_torch.data.packed import load_packed
from pmce_tpu_torch.data.synthetic import generate_sequences
from pmce_tpu_torch.ops.coords import get_bbox, process_bbox
from pmce_tpu_torch.smpl.artifacts import SMPLArtifacts

FITTING_THR_CROP_PX = 3.0


def reprojection_fit_mask(pred_pose2d: np.ndarray, gt_pose2d: np.ndarray,
                          tight_bboxes: np.ndarray,
                          valid: np.ndarray | None = None,
                          thr_px: float = FITTING_THR_CROP_PX) -> np.ndarray:
    """Train-split quality gate in 64×64-crop pixel units.

    The reference's MPII3D ``get_fitting_error`` (dataset.py:368-380):
    both joint sets map into the 64×64 crop of the ``process_bbox``-
    sanitized square tight box (w−1 edge semantics), invalid joints are
    masked out, and a mean distance over ``thr_px`` is a bad fit.

    Args:
      pred_pose2d, gt_pose2d: [N, J, 2] pixels.
      tight_bboxes: [N, 4] (x, y, w, h) tight keypoint boxes.
      valid: optional [N, J] 0/1 joint validity.
    """
    n = len(pred_pose2d)
    good = np.zeros(n, bool)
    for i in range(n):
        bbox = process_bbox(
            np.asarray(tight_bboxes[i], np.float32).copy(),
            aspect_ratio=1.0)
        if bbox is None:
            continue
        v = (np.ones(pred_pose2d.shape[1], bool) if valid is None
             else np.asarray(valid[i]).reshape(-1) > 0)
        if not v.any():
            continue
        scale = 64.0 / bbox[2]
        err = np.linalg.norm(
            (pred_pose2d[i][v] - gt_pose2d[i][v]) * scale, axis=-1).mean()
        good[i] = err <= thr_px
    return good


def apply_reprojection_gate(data) -> None:
    """Train gate: zero all loss validities on bad fits, keep the windows
    (reference ``data/MPII3D/dataset.py:440-443``)."""
    tight = np.stack([get_bbox(j[:17]) for j in data.joint_img])
    good = reprojection_fit_mask(
        data.pose2d_det[:, :17], data.joint_img[:, :17], tight)
    v = (data.has_smpl & good).astype(np.float32)
    data.mesh_valid = v
    data.lift_valid = v.copy()
    data.reg_valid = v.copy()


@dataclasses.dataclass
class MPII3D(VideoMeshDataset):
    name: str = "MPII3D"
    is_val: bool = False

    def get_batch(self, idxs):
        batch = super().get_batch(idxs)
        if self.is_val:
            # No mesh or lift targets at val: zero the targets and their
            # validities (reference :495-502).
            batch["mesh"] = np.zeros_like(batch["mesh"])
            batch["mesh_valid"] = np.zeros_like(batch["mesh_valid"])
            batch["lift_pose3d"] = np.zeros_like(batch["lift_pose3d"])
            batch["lift_pose3d_valid"] = np.zeros_like(
                batch["lift_pose3d_valid"])
        return batch

    def evaluate(self, results: list, verbose: bool = True):
        """MPII3D reports joints only (no mesh GT at val)."""
        out = evaluate_joints(
            pred=np.stack([np.asarray(r["joint_coord"]) for r in results]),
            gt=np.stack(
                [np.asarray(r["joint_coord_target"]) for r in results]),
            seq_names=self.seq_names(),
            root_idx=0,
            device=self.device,
        )
        if verbose:
            print(out.summary(tag="MPII3D "))
        return out

    @classmethod
    def from_synthetic(cls, art: SMPLArtifacts, split: str = "train",
                       seed: int = 5, num_videos: int = 2,
                       frames_per_video: int = 48, device="cuda",
                       **kw) -> "MPII3D":
        jr_h36m, jr_coco = synthetic_regressors(art)
        is_val = split != "train"
        data = generate_sequences(
            art, jr_coco, jr_h36m, num_videos=num_videos,
            frames_per_video=frames_per_video,
            seed=seed + (0 if split == "train" else 60), device=device)
        if not is_val:
            apply_reprojection_gate(data)
        return cls(data=data, name="MPII3D", is_val=is_val,
                   joint_regressor_smpl=art.J_regressor,
                   joint_regressor_h36m=jr_h36m,
                   joint_regressor_coco=jr_coco, device=device, **kw)

    @classmethod
    def from_packed(cls, path, split: str = "train", **kw) -> "MPII3D":
        """Load a packed npz written by the JAX package's
        ``tools/convert_mpii3d.py``."""
        data, aux = load_packed(path)
        is_val = split != "train"
        if not is_val:
            apply_reprojection_gate(data)
        return cls(data=data, name="MPII3D", is_val=is_val,
                   joint_regressor_smpl=aux.get("jr_smpl"),
                   joint_regressor_h36m=aux.get("jr_h36m"),
                   joint_regressor_coco=aux.get("jr_coco"), **kw)
