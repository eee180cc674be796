"""Shared dataset machinery: windowed access plus evaluation wiring.

Port of ``pmce_tpu/data/datasets/base.py``. The reference gives every
dataset class three roles: sample provider, joint-set registry and metric
owner. The sample mechanics live in ``ClipDataset`` (vectorized gathers);
this base adds the joint-set metadata and the evaluation entry points, so
that each concrete dataset wires only its own protocol quirks.

The results format is the reference Tester's
(``lib/core/base.py:236-243``): a list of per-window dicts with
``mesh_coord`` / ``mesh_coord_target`` / ``joint_coord`` /
``joint_coord_target`` in millimeters.

``device`` is where a dataset's synthesis runs its SMPL forward (the
skinning kernel on the card) and where its evaluation runs the batched
Procrustes pass: the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from pmce_tpu_torch.data.clip_dataset import ClipDataset
from pmce_tpu_torch.data.evaluation import (
    JointEvalResult,
    MeshEvalResult,
    evaluate_joints,
    evaluate_mesh,
)
from pmce_tpu_torch.data.synthetic import (
    SyntheticSequenceData,
    generate_sequences,
)
from pmce_tpu_torch.smpl.artifacts import SMPLArtifacts

H36M_JOINT_NUM = 17
COCO_JOINT_NUM = 19


def _stack_results(results: list, key: str) -> np.ndarray:
    return np.stack([np.asarray(r[key]) for r in results])


@dataclasses.dataclass
class VideoMeshDataset(ClipDataset):
    """ClipDataset + SMPL regressors + evaluation protocol hooks."""

    joint_regressor_smpl: np.ndarray | None = None   # [24, V]
    joint_regressor_h36m: np.ndarray | None = None   # [17, V]
    joint_regressor_coco: np.ndarray | None = None   # [19, V]
    eval_root_idx: int = 0
    eval_joint_subset: tuple | None = None
    device: Any = "cuda"

    # ------------------------------------------------------------ windows
    def mid_indices(self) -> np.ndarray:
        mids = []
        for start, end in self.vid_indices:
            mids.append(start if start == end
                        else start + self.seqlen // 2)
        return np.asarray(mids, dtype=np.int64)

    def seq_names(self) -> np.ndarray:
        mids = self.mid_indices()
        return np.array([str(n)[:-11] for n in self.data.img_names[mids]])

    # --------------------------------------------------------- evaluation
    def keep_mask(self) -> np.ndarray | None:
        """Window filter applied before metrics (None = keep all)."""
        return None

    def action_ids(self) -> np.ndarray | None:
        return None

    def gt_h36m_joints_mid(self) -> np.ndarray | None:
        """Dataset GT H36M joints at mid frames (None → regress from GT
        mesh, the PW3D behavior)."""
        return None

    def evaluate(self, results: list, verbose: bool = True
                 ) -> MeshEvalResult:
        assert len(results) == len(self.vid_indices)
        out = evaluate_mesh(
            pred_mesh=_stack_results(results, "mesh_coord"),
            gt_mesh=_stack_results(results, "mesh_coord_target"),
            J_reg_smpl=self.joint_regressor_smpl,
            J_reg_h36m=self.joint_regressor_h36m,
            seq_names=self.seq_names(),
            gt_h36m_joints=self.gt_h36m_joints_mid(),
            keep_mask=self.keep_mask(),
            action_ids=self.action_ids(),
            device=self.device,
        )
        if verbose:
            print(out.summary(tag=f"{self.name} "))
        return out

    def evaluate_joint(self, results: list, verbose: bool = True
                       ) -> JointEvalResult:
        assert len(results) == len(self.vid_indices)
        out = evaluate_joints(
            pred=_stack_results(results, "joint_coord"),
            gt=_stack_results(results, "joint_coord_target"),
            seq_names=self.seq_names(),
            root_idx=self.eval_root_idx,
            eval_joints=self.eval_joint_subset,
            keep_mask=self.keep_mask(),
            device=self.device,
        )
        if verbose:
            print(out.summary(tag=f"{self.name} "))
        return out


def synthetic_regressors(art: SMPLArtifacts, seed: int = 7):
    """Deterministic stand-in H36M-17 and COCO-19 regressors for one body:
    sparse row-stochastic rows, the JAX package's draws. Real regressors
    come in a packed npz from the ETL."""
    rng = np.random.default_rng(seed)
    V = art.num_verts

    def make(k):
        jr = np.zeros((k, V), dtype=np.float32)
        for j in range(k):
            idx = rng.choice(V, size=max(4, V // (4 * k)), replace=False)
            w = rng.random(len(idx))
            jr[j, idx] = (w / w.sum()).astype(np.float32)
        return jr

    return make(H36M_JOINT_NUM), make(COCO_JOINT_NUM)


def make_synthetic_split(art: SMPLArtifacts, joint_regressor: np.ndarray,
                         num_videos: int, frames_per_video: int,
                         seed: int, device="cuda") -> SyntheticSequenceData:
    return generate_sequences(art, joint_regressor, num_videos=num_videos,
                              frames_per_video=frames_per_video, seed=seed,
                              device=device)
