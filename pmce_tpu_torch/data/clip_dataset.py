"""Clip dataset: windowed samples with the reference's (inputs, targets,
meta) structure, plus host-side batching iterators.

The port's own copy of ``pmce_tpu/data/clip_dataset.py`` (numpy only):
the same windows, batches and seeded draws as the JAX package.

Sample-structure parity: reference data/Human36M/dataset.py:450-530 —
inputs ``{pose2d [T,J,2], img_feature [T,2048]}``, targets ``{mesh [V,3] m,
lift_pose3d [J,3] mm, reg_pose3d [17,3] mm}``, meta = validity masks, all
supervision at the clip's mid frame. 2D inputs are width-normalized with
``normalize_screen_coordinates``.

Unlike the reference (per-sample python + DataLoader workers), samples are
assembled by numpy fancy-indexing over packed arrays — a whole batch is one
vectorized gather on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pmce_tpu_torch.data.chunker import (
    split_into_chunks_mesh,
    split_into_chunks_pose,
)
from pmce_tpu_torch.data.synthetic import SyntheticSequenceData


@dataclasses.dataclass
class ClipDataset:
    """Windowed view over packed per-frame arrays."""

    data: SyntheticSequenceData
    seqlen: int = 16
    stride: int = 1
    use_gt_input: bool = False
    fitting_thr_mm: float = 25.0
    name: str = "synthetic"
    # "mesh" drops windows whose mid frame lacks an SMPL fit; "pose"
    # keeps every window — the reference picks by MODEL stage
    # (Human36M/dataset.py:99-103): Stage-1 PoseEst trains and is
    # EVALUATED over all windows. "static" = one degenerate window per
    # SMPL-fitted frame (COCO/MPII single images; no video chunking).
    chunk_mode: str = "mesh"

    def __post_init__(self):
        if self.chunk_mode == "static":
            frames = np.nonzero(np.asarray(self.data.has_smpl))[0]
            self.vid_indices = np.stack([frames, frames], axis=1)
        elif self.chunk_mode == "pose":
            self.vid_indices = split_into_chunks_pose(
                self.data.img_names, self.seqlen, self.stride)
        else:
            self.vid_indices = split_into_chunks_mesh(
                self.data.img_names, self.seqlen, self.stride,
                self.data.has_smpl)
        d = self.data
        # Width-normalized 2D inputs, precomputed once.
        w = d.img_hw[:, 1:2].astype(np.float32)
        h = d.img_hw[:, 0:1].astype(np.float32)
        src = d.joint_img if self.use_gt_input else d.pose2d_det
        self.pose2d_norm = (
            src / w[:, None] * 2.0
            - np.stack([np.ones_like(w), h / w], axis=-1)
        ).astype(np.float32)

    def __len__(self) -> int:
        return len(self.vid_indices)

    @property
    def num_joints(self) -> int:
        return self.data.joint_cam.shape[1]

    @property
    def num_verts(self) -> int:
        return self.data.mesh_cam.shape[1]

    def frame_window(self, idx: int) -> np.ndarray:
        start, end = self.vid_indices[idx]
        if start == end:
            return np.full(self.seqlen, start, dtype=np.int64)
        return np.arange(start, start + self.seqlen, dtype=np.int64)

    def get_batch(self, idxs: np.ndarray) -> dict:
        """Assemble a batch of clips by vectorized gathering.

        Returns a dict of numpy arrays:
          pose2d [B,T,J,2], img_feature [B,T,2048],
          mesh [B,V,3] (meters), lift_pose3d [B,J,3] (mm),
          reg_pose3d [B,J,3] (mm), and [B,.,1] validity masks.
        """
        idxs = np.asarray(idxs)
        windows = np.stack([self.frame_window(i) for i in idxs])  # [B,T]
        mid = windows[:, self.seqlen // 2]

        d = self.data
        reg = getattr(d, "joint_cam_h36m", None)
        if reg is None:
            reg = d.joint_cam
        batch = {
            "pose2d": self.pose2d_norm[windows],
            "img_feature": d.features[windows],
            "mesh": d.mesh_cam[mid] / 1000.0,
            "lift_pose3d": d.joint_cam[mid],
            "reg_pose3d": reg[mid],
        }
        B = len(idxs)
        mesh_v = (d.mesh_valid if d.mesh_valid is not None
                  else d.has_smpl.astype(np.float32))
        lift_v = (d.lift_valid if d.lift_valid is not None
                  else np.ones(len(d), np.float32))
        reg_v = (d.reg_valid if d.reg_valid is not None
                 else np.ones(len(d), np.float32))
        batch["mesh_valid"] = np.broadcast_to(
            mesh_v[mid].astype(np.float32)[:, None, None],
            (B, self.num_verts, 1)).copy()
        batch["lift_pose3d_valid"] = np.broadcast_to(
            lift_v[mid].astype(np.float32)[:, None, None],
            (B, self.num_joints, 1)).copy()
        batch["reg_pose3d_valid"] = np.broadcast_to(
            reg_v[mid].astype(np.float32)[:, None, None],
            (B, reg.shape[1], 1)).copy()
        return batch


@dataclasses.dataclass
class MultiDataset:
    """Equal-probability mixing of several datasets.

    Parity target: reference data/multiple_datasets.py:6-40 with
    ``make_same_len=True`` — virtual length = max length × n datasets,
    uniform random dataset choice per index — but with an explicit seeded
    RNG instead of the global ``random`` module.
    """

    datasets: list
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self.max_len = max(len(d) for d in self.datasets)

    def __len__(self):
        return self.max_len * len(self.datasets)

    def sample_batch(self, batch_size: int) -> dict:
        # Group by dataset for vectorized gathers.
        # (All datasets share the sample structure, so concat works.)
        db_choice = self._rng.integers(len(self.datasets), size=batch_size)
        chunks = []
        for di, db in enumerate(self.datasets):
            n = int((db_choice == di).sum())
            if n == 0:
                continue
            idxs = self._rng.integers(len(db), size=n)
            chunks.append(db.get_batch(idxs))
        out = {
            k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]
        }
        return out


def epoch_iterator(dataset: ClipDataset, batch_size: int, shuffle: bool,
                   seed: int, drop_last: bool = True):
    """Yield batches covering the dataset once (static batch shapes).

    Every batch carries a ``_weight`` [B] float mask: 1 for real samples,
    0 for the wrap-padded tail of a ragged final batch — consumers MUST
    weight per-sample statistics by it (an unweighted mean would count the
    duplicated pad samples, biasing streamed metrics)."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    n_batches = len(order) // batch_size if drop_last else -(
        -len(order) // batch_size)
    for b in range(n_batches):
        idxs = order[b * batch_size : (b + 1) * batch_size]
        weight = np.ones(batch_size, np.float32)
        if len(idxs) < batch_size:
            # Pad the final batch by wrapping (every batch has one shape);
            # padded rows get zero weight. np.resize repeats the order
            # cyclically, so datasets SMALLER than the deficit still fill
            # the full batch.
            weight[len(idxs):] = 0.0
            idxs = np.concatenate(
                [idxs, np.resize(order, batch_size - len(idxs))])
        batch = dataset.get_batch(idxs)
        batch["_weight"] = weight
        yield batch
