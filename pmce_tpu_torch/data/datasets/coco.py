"""MSCOCO dataset family (train-only, static images).

Port of ``pmce_tpu/data/datasets/coco.py``. Protocol of the reference
(``data/COCO/dataset.py``): train-only (no 3D video test protocol); each
sample is one image repeated T = 16 times (:283-284), so static images go
through the same clip-shaped model; SMPLify-fit pseudo-GT meshes; 2D
keypoint noise on the GT projections (``synthesize_pose``, :311-322),
precomputed into ``pose2d_det`` by the ETL or the fixture generator.
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
class StaticImageDataset(VideoMeshDataset):
    """Single-image dataset: every window repeats one frame T times (one
    degenerate window per frame with an SMPL pseudo-GT)."""

    def __post_init__(self):
        # One-frame windows whatever the configured chunk mode, and no
        # video chunker.
        self.chunk_mode = "static"
        super().__post_init__()

    def evaluate(self, results, verbose: bool = True):
        raise NotImplementedError(
            f"{self.name} is a train-only dataset (no test protocol)")


@dataclasses.dataclass
class MSCOCO(StaticImageDataset):
    name: str = "COCO"

    @classmethod
    def from_synthetic(cls, art: SMPLArtifacts, seed: int = 9,
                       num_images: int = 64, device="cuda",
                       **kw) -> "MSCOCO":
        jr_h36m, jr_coco = synthetic_regressors(art)
        # Static images: one 1-frame "video" per image keeps names unique.
        data = generate_sequences(art, jr_coco, jr_h36m, num_videos=1,
                                  frames_per_video=num_images, seed=seed,
                                  device=device)
        return cls(data=data, name="COCO",
                   joint_regressor_smpl=art.J_regressor,
                   joint_regressor_h36m=jr_h36m,
                   joint_regressor_coco=jr_coco, device=device, **kw)

    @classmethod
    def from_packed(cls, path, split: str = "train", **kw) -> "MSCOCO":
        """Load a packed npz written by the JAX package's
        ``tools/convert_coco.py`` (the SMPLify fitting gate is already in
        the validity arrays)."""
        data, aux = load_packed(path)
        return cls(data=data, name="COCO",
                   joint_regressor_smpl=aux.get("jr_smpl"),
                   joint_regressor_h36m=aux.get("jr_h36m"),
                   joint_regressor_coco=aux.get("jr_coco"), **kw)
