"""3DPW dataset family.

Port of ``pmce_tpu/data/datasets/pw3d.py``. Protocol of the reference
(``data/PW3D/dataset.py``):

- always COCO-19 input (ViTPose detections at test, precomputed noisy
  joints at train, :95-104);
- gendered SMPL ground truth with translation (:70-88), produced by the
  ETL into the packed mesh arrays;
- evaluation (:351-462): H36M-regressed joints from both the predicted and
  the GT meshes (no dataset joint GT), MPVPE over all vertices, per-video
  ACCEL, no camera filter: the base class's ``evaluate``.
"""

from __future__ import annotations

import dataclasses

from pmce_tpu_torch.data.datasets.base import (
    VideoMeshDataset,
    synthetic_regressors,
)
from pmce_tpu_torch.data.packed import load_packed
from pmce_tpu_torch.data.synthetic import generate_sequences
from pmce_tpu_torch.smpl.artifacts import SMPLArtifacts


@dataclasses.dataclass
class PW3D(VideoMeshDataset):
    name: str = "PW3D"
    # COCO-19 pelvis for the joint-only (Stage-1) eval, reference
    # PW3D dataset.py:306-309 (root = joints[-2]).
    eval_root_idx: int = -2

    @classmethod
    def from_synthetic(cls, art: SMPLArtifacts, split: str = "test",
                       seed: int = 3, num_videos: int = 2,
                       frames_per_video: int = 48, device="cuda",
                       **kw) -> "PW3D":
        jr_h36m, jr_coco = synthetic_regressors(art)
        data = generate_sequences(
            art, jr_coco, jr_h36m, num_videos=num_videos,
            frames_per_video=frames_per_video,
            seed=seed + (0 if split == "test" else 50), device=device)
        return cls(data=data, name="PW3D",
                   joint_regressor_smpl=art.J_regressor,
                   joint_regressor_h36m=jr_h36m,
                   joint_regressor_coco=jr_coco, device=device, **kw)

    @classmethod
    def from_packed(cls, path, split: str = "test", **kw) -> "PW3D":
        """Load a packed npz written by the JAX package's
        ``tools/convert_pw3d.py``."""
        data, aux = load_packed(path)
        return cls(data=data, name="PW3D",
                   joint_regressor_smpl=aux.get("jr_smpl"),
                   joint_regressor_h36m=aux.get("jr_h36m"),
                   joint_regressor_coco=aux.get("jr_coco"), **kw)
