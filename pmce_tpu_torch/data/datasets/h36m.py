"""Human3.6M dataset family.

Port of ``pmce_tpu/data/datasets/h36m.py``. Protocol of the reference
(``data/Human36M/dataset.py``):

- protocol 2 (train S1/5/6/7/8, test S9/11), frame subsampling 2
  (:167-192), encoded in the offline ETL;
- input joint set H36M-17 (CPN detections) or COCO-19 (NeuralAnnot),
  supervision only at the clip's mid frame (:450-530);
- SMPL-fitting gate: windows whose NeuralAnnot mesh disagrees with the
  dataset's GT joints by more than 25 mm get their mesh validity zeroed
  (:509-514), here in one vectorized pass over the packed arrays;
- evaluation: camera 4 only (:759-761), per-action breakdown (:778-785),
  the H36M GT joints as the joint target, per-sequence ACCEL.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pmce_tpu_torch.data.datasets.base import (
    VideoMeshDataset,
    synthetic_regressors,
)
from pmce_tpu_torch.data.packed import load_packed
from pmce_tpu_torch.data.synthetic import generate_sequences
from pmce_tpu_torch.smpl.artifacts import SMPLArtifacts

FITTING_THR_MM = 25.0


def fitting_error_mask(joint_cam_h36m: np.ndarray, mesh_cam: np.ndarray,
                       J_reg_h36m: np.ndarray,
                       thr_mm: float = FITTING_THR_MM) -> np.ndarray:
    """Vectorized NeuralAnnot quality gate.

    The reference's ``get_fitting_error`` (``data/Human36M/dataset.py:
    400-407``): root-relative GT joints against mean-translation-aligned
    mesh-regressed joints; a mean joint distance over ``thr_mm`` is a bad
    fit.

    Args:
      joint_cam_h36m: [N, 17, 3] GT joints (mm, any frame).
      mesh_cam: [N, V, 3] fitted mesh (mm, same frame).

    Returns:
      [N] bool, True where the fit is good (≤ thr).
    """
    gt = joint_cam_h36m - joint_cam_h36m[:, :1]
    reg = np.einsum("jv,nvk->njk", J_reg_h36m, mesh_cam)
    reg = reg - reg.mean(1, keepdims=True) + gt.mean(1, keepdims=True)
    err = np.sqrt(((gt - reg) ** 2).sum(-1)).mean(-1)
    return err <= thr_mm


def apply_fitting_gate(data, jr_h36m: np.ndarray,
                       input_joint_set: str) -> None:
    """Zero loss validities on bad NeuralAnnot fits, keeping the windows:
    ``mesh_valid`` (and ``lift_valid`` for the COCO input set), while the
    sample still trains with its other terms
    (``data/Human36M/dataset.py:509-514``)."""
    good = fitting_error_mask(data.joint_cam_h36m, data.mesh_cam, jr_h36m)
    data.mesh_valid = (data.has_smpl & good).astype(np.float32)
    if input_joint_set == "coco":
        data.lift_valid = data.mesh_valid.copy()


@dataclasses.dataclass
class Human36M(VideoMeshDataset):
    name: str = "Human36M"
    eval_cam_idx: int = 4
    # The Stage-1 joint protocol keeps the 14 H36M eval joints after root
    # alignment (reference Human36M/dataset.py:62,670): the full set would
    # score the zeroed root (error exactly 0) and deflate MPJPE.
    eval_joint_subset: tuple | None = (
        1, 2, 3, 4, 5, 6, 8, 10, 11, 12, 13, 14, 15, 16)

    def keep_mask(self) -> np.ndarray:
        mids = self.mid_indices()
        return self.data.cam_idx[mids] == self.eval_cam_idx

    def action_ids(self) -> np.ndarray:
        """Parse ``act_XX`` from reference-style image names; windows whose
        names carry no action tag land in action 0."""
        mids = self.mid_indices()
        ids = np.zeros(len(mids), dtype=np.int64)
        for i, n in enumerate(self.data.img_names[mids]):
            s = str(n)
            pos = s.find("act")
            if pos >= 0:
                try:
                    ids[i] = int(s[pos + 4:pos + 6]) - 2
                except ValueError:
                    ids[i] = 0
        return ids

    def gt_h36m_joints_mid(self) -> np.ndarray:
        return self.data.joint_cam_h36m[self.mid_indices()]

    @classmethod
    def from_synthetic(cls, art: SMPLArtifacts, split: str = "train",
                       seed: int = 0, num_videos: int = 2,
                       frames_per_video: int = 48,
                       input_joint_set: str = "human36", device="cuda",
                       **kw) -> "Human36M":
        jr_h36m, jr_coco = synthetic_regressors(art)
        jr_in = jr_h36m if input_joint_set in ("human36", "h36m") else jr_coco
        data = generate_sequences(
            art, jr_in, jr_h36m, num_videos=num_videos,
            frames_per_video=frames_per_video,
            seed=seed + (0 if split == "train" else 100), device=device)
        apply_fitting_gate(data, jr_h36m, input_joint_set)
        return cls(data=data, name="Human36M",
                   joint_regressor_smpl=art.J_regressor,
                   joint_regressor_h36m=jr_h36m,
                   joint_regressor_coco=jr_coco, device=device, **kw)

    @classmethod
    def from_packed(cls, path, split: str = "train",
                    input_joint_set: str = "human36", **kw) -> "Human36M":
        """Load a packed npz written by the JAX package's
        ``tools/convert_h36m.py``."""
        data, aux = load_packed(path)
        apply_fitting_gate(data, aux["jr_h36m"], input_joint_set)
        return cls(data=data, name="Human36M",
                   joint_regressor_smpl=aux.get("jr_smpl"),
                   joint_regressor_h36m=aux["jr_h36m"],
                   joint_regressor_coco=aux.get("jr_coco"), **kw)
