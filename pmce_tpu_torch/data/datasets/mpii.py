"""MPII dataset family (train-only, static images).

Port of ``pmce_tpu/data/datasets/mpii.py`` (the reference's
``data/MPII/dataset.py``): the COCO pattern, a single image repeated
T = 16 times with a NeuralAnnot SMPL pseudo-GT and no test protocol.
"""

from __future__ import annotations

import dataclasses

from pmce_tpu_torch.data.datasets.base import synthetic_regressors
from pmce_tpu_torch.data.datasets.coco import StaticImageDataset
from pmce_tpu_torch.data.packed import load_packed
from pmce_tpu_torch.data.synthetic import generate_sequences
from pmce_tpu_torch.smpl.artifacts import SMPLArtifacts


@dataclasses.dataclass
class MPII(StaticImageDataset):
    name: str = "MPII"

    @classmethod
    def from_synthetic(cls, art: SMPLArtifacts, seed: int = 11,
                       num_images: int = 64, device="cuda", **kw) -> "MPII":
        jr_h36m, jr_coco = synthetic_regressors(art)
        data = generate_sequences(art, jr_coco, jr_h36m, num_videos=1,
                                  frames_per_video=num_images, seed=seed,
                                  device=device)
        return cls(data=data, name="MPII",
                   joint_regressor_smpl=art.J_regressor,
                   joint_regressor_h36m=jr_h36m,
                   joint_regressor_coco=jr_coco, device=device, **kw)

    @classmethod
    def from_packed(cls, path, split: str = "train", **kw) -> "MPII":
        """Load a packed npz written by the JAX package's
        ``tools/convert_mpii.py``."""
        data, aux = load_packed(path)
        return cls(data=data, name="MPII",
                   joint_regressor_smpl=aux.get("jr_smpl"),
                   joint_regressor_h36m=aux.get("jr_h36m"),
                   joint_regressor_coco=aux.get("jr_coco"), **kw)
