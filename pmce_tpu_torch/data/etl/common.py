"""Shared ETL machinery: COCO-json indexing, rotation helpers, batched
SMPL ground-truth synthesis.

Port of ``pmce_tpu/data/etl/common.py``. Everything but the SMPL forward is
its numpy, unchanged. The synthesis (:func:`smpl_verts_joints`) runs the
port's SMPL layer on ``device``, the card unless the caller asks for the
CPU: one upload of the body model a call, then ``batch`` bodies a chunk,
whose skinning launches the skinning kernel (``smpl/kernels.py``) once a
chunk on the card. The GT-synthesis math mirrors the reference's
per-sample ``get_smpl_coord`` (its ``data/Human36M/dataset.py:354-398``
and ``data/PW3D/dataset.py:70-88``), once over the whole split.
"""

from __future__ import annotations

import json
import os.path as osp

import numpy as np
import torch

from pmce_tpu_torch.ops.coords import process_bbox
from pmce_tpu_torch.smpl.artifacts import SMPLArtifacts
from pmce_tpu_torch.smpl.layer import SMPLModel, smpl_forward

COCO_JOINTS_NAME = (
    "Nose", "L_Eye", "R_Eye", "L_Ear", "R_Ear", "L_Shoulder", "R_Shoulder",
    "L_Elbow", "R_Elbow", "L_Wrist", "R_Wrist", "L_Hip", "R_Hip", "L_Knee",
    "R_Knee", "L_Ankle", "R_Ankle", "Pelvis", "Neck",
)


def resolve_device(device) -> torch.device:
    """The ETL's device: the card unless the caller asks for the CPU;
    asking for the card where there is none raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"ETL device {device}: no CUDA card here; pass device='cpu' "
            f"(--device cpu) to run the SMPL synthesis on the CPU")
    return device


# --------------------------------------------------------------------------
# COCO-format annotation JSONs (no pycocotools: only imgs/anns are used).
# --------------------------------------------------------------------------
class CocoIndex:
    """Minimal COCO-annotation index: anns in insertion order, imgs by id."""

    def __init__(self, dataset: dict):
        self.imgs = {img["id"]: img for img in dataset.get("images", [])}
        self.anns = {ann["id"]: ann
                     for ann in dataset.get("annotations", [])}

    @classmethod
    def from_file(cls, path: str) -> "CocoIndex":
        with open(path) as f:
            return cls(json.load(f))

    @classmethod
    def from_merged(cls, paths: list[str]) -> "CocoIndex":
        """Concatenate several COCO jsons (the reference's per-subject merge,
        its data/Human36M/dataset.py:221-228)."""
        merged: dict = {}
        for p in paths:
            with open(p) as f:
                d = json.load(f)
            for k, v in d.items():
                merged.setdefault(k, [])
                merged[k] += v
        return cls(merged)


def load_json(*path_parts) -> dict:
    with open(osp.join(*path_parts)) as f:
        return json.load(f)


# --------------------------------------------------------------------------
# Rotations (numpy, batched).
# --------------------------------------------------------------------------
def axangle_to_mat(v: np.ndarray) -> np.ndarray:
    """Batched axis-angle [N, 3] → rotation matrices [N, 3, 3]."""
    v = np.asarray(v, dtype=np.float64)
    angle = np.linalg.norm(v, axis=-1, keepdims=True)
    axis = v / np.maximum(angle, 1e-12)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    c = np.cos(angle[..., 0])
    s = np.sin(angle[..., 0])
    C = 1.0 - c
    m = np.empty(v.shape[:-1] + (3, 3), dtype=np.float64)
    m[..., 0, 0] = x * x * C + c
    m[..., 0, 1] = x * y * C - z * s
    m[..., 0, 2] = x * z * C + y * s
    m[..., 1, 0] = y * x * C + z * s
    m[..., 1, 1] = y * y * C + c
    m[..., 1, 2] = y * z * C - x * s
    m[..., 2, 0] = z * x * C - y * s
    m[..., 2, 1] = z * y * C + x * s
    m[..., 2, 2] = z * z * C + c
    return m


def mat_to_axangle(m: np.ndarray) -> np.ndarray:
    """Batched rotation matrices [N, 3, 3] → axis-angle [N, 3]."""
    m = np.asarray(m, dtype=np.float64)
    trace = np.trace(m, axis1=-2, axis2=-1)
    angle = np.arccos(np.clip((trace - 1.0) / 2.0, -1.0, 1.0))
    axis = np.stack([
        m[..., 2, 1] - m[..., 1, 2],
        m[..., 0, 2] - m[..., 2, 0],
        m[..., 1, 0] - m[..., 0, 1],
    ], axis=-1)
    norm = np.linalg.norm(axis, axis=-1, keepdims=True)
    small = norm[..., 0] < 1e-8
    axis = axis / np.maximum(norm, 1e-12)
    out = axis * angle[..., None]
    if np.any(small):
        # angle ≈ 0 (identity) or π; handle π via the diagonal.
        for i in np.nonzero(small)[0]:
            if angle[i] < 1e-6:
                out[i] = 0.0
            else:  # angle ~ π: axis from the largest diagonal element
                d = np.diagonal(m[i])
                k = int(np.argmax(d))
                ax = np.sqrt(np.maximum((d[k] + 1.0) / 2.0, 0.0))
                vec = np.zeros(3)
                vec[k] = ax
                for j in range(3):
                    if j != k and ax > 0:
                        vec[j] = m[i][j, k] / (2.0 * ax)
                out[i] = vec / np.linalg.norm(vec) * angle[i]
    return out


def clamp_betas(shape: np.ndarray, limit: float = 3.0) -> np.ndarray:
    """Reference quirk: replace a whole beta vector by the mean shape when
    ANY coefficient exceeds the limit (dataset.py:365)."""
    shape = np.asarray(shape, dtype=np.float32).copy()
    bad = np.any(np.abs(shape) > limit, axis=-1)
    shape[bad] = 0.0
    return shape


def rotate_root_pose(pose: np.ndarray, R: np.ndarray) -> np.ndarray:
    """World→cam fix-up of the global (root) axis-angle by the camera R
    (dataset.py:368-374)."""
    pose = np.asarray(pose, dtype=np.float32).copy()
    root_mat = axangle_to_mat(pose[:, :3])
    fixed = np.einsum("nij,njk->nik", np.asarray(R, np.float64), root_mat)
    pose[:, :3] = mat_to_axangle(fixed).astype(np.float32)
    return pose


# --------------------------------------------------------------------------
# Batched SMPL synthesis on the device.
# --------------------------------------------------------------------------
def smpl_verts_joints(art: SMPLArtifacts, pose: np.ndarray,
                      shape: np.ndarray, trans: np.ndarray | None = None,
                      batch: int = 512, device="cuda", fused: bool = True
                      ) -> tuple[np.ndarray, np.ndarray]:
    """(pose [N,72], shape [N,10][, trans [N,3]]) → (verts, joints) meters,
    as f32 numpy.

    The body model is uploaded to ``device`` once; each chunk of ``batch``
    bodies runs :func:`~pmce_tpu_torch.smpl.layer.smpl_forward` with
    ``fused`` (on the card: the skinning kernel, one launch a chunk; with
    ``fused=False`` the plain skinning)."""
    device = resolve_device(device)
    model = SMPLModel.from_artifacts(art, device)

    def upload(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    pose_d, shape_d = upload(pose), upload(shape)
    trans_d = None if trans is None else upload(trans)
    verts_all, joints_all = [], []
    with torch.no_grad():
        for i in range(0, len(pose), batch):
            t = None if trans_d is None else trans_d[i:i + batch]
            v, j = smpl_forward(model, pose_d[i:i + batch],
                                shape_d[i:i + batch], t, fused=fused)
            verts_all.append(v.cpu().numpy())
            joints_all.append(j.cpu().numpy())
    return np.concatenate(verts_all), np.concatenate(joints_all)


def smpl_world_to_cam_mm(art: SMPLArtifacts, pose: np.ndarray,
                         shape: np.ndarray, trans: np.ndarray,
                         R: np.ndarray, t: np.ndarray,
                         root_joint_idx: int = 0, device="cuda"
                         ) -> tuple[np.ndarray, np.ndarray]:
    """The reference's full camera-frame GT synthesis, batched.

    Parity: the reference's data/Human36M/dataset.py:354-398 — clamp betas,
    rotate the root pose into the camera frame, SMPL forward on ``device``,
    then the translation compensation ``R·trans + t/1000 − j_root +
    R·j_root`` in f32 numpy.

    Args:
      pose [N, 72] axis-angle; shape [N, 10]; trans [N, 3] world (meters);
      R [N, 3, 3]; t [N, 3] camera translation (mm).

    Returns:
      (mesh_cam [N, V, 3], joints_cam [N, 24, 3]) in millimeters.
    """
    shape = clamp_betas(shape)
    pose = rotate_root_pose(pose, R)
    verts, joints = smpl_verts_joints(art, pose, shape, device=device)
    root = joints[:, root_joint_idx:root_joint_idx + 1]      # [N, 1, 3]
    Rr = np.einsum("nij,nkj->nki", np.asarray(R, np.float32), root)
    smpl_trans = (
        np.einsum("nij,nj->ni", np.asarray(R, np.float32),
                  np.asarray(trans, np.float32))[:, None]
        + np.asarray(t, np.float32)[:, None] / 1000.0
        - root + Rr
    )
    return ((verts + smpl_trans) * 1000.0,
            (joints + smpl_trans) * 1000.0)


def add_pelvis_and_neck(joint_coord: np.ndarray) -> np.ndarray:
    """COCO-17 → COCO-19 by appending (pelvis, neck) midpoints (batched on
    the leading dims). Parity: dataset.py:420-432."""
    names = COCO_JOINTS_NAME
    lhip, rhip = names.index("L_Hip"), names.index("R_Hip")
    lsho, rsho = names.index("L_Shoulder"), names.index("R_Shoulder")
    pelvis = (joint_coord[..., lhip, :] + joint_coord[..., rhip, :]) * 0.5
    neck = (joint_coord[..., lsho, :] + joint_coord[..., rsho, :]) * 0.5
    return np.concatenate(
        [joint_coord, pelvis[..., None, :], neck[..., None, :]], axis=-2)


def crop64_fit_error(tight_bbox: np.ndarray, kp_a: np.ndarray,
                     kp_b: np.ndarray, valid: np.ndarray) -> float:
    """Mean 2D distance between two keypoint sets, in 64×64-crop pixels.

    Parity: the COCO/MPII/MPII3D ``get_fitting_error`` (the reference's
    data/COCO/dataset.py:226-239) — both sets are mapped into the 64×64
    crop of the square-processed tight bbox; since that crop is a uniform
    scale + translation, the distance simply scales by 64 / bbox_side.

    Args:
      tight_bbox: (x, y, w, h); kp_a, kp_b: [K, 2]; valid: [K] (0/1).
    """
    bbox = process_bbox(np.asarray(tight_bbox, np.float32).copy(),
                        aspect_ratio=1.0)
    if bbox is None:
        return np.inf
    scale = 64.0 / bbox[2]
    v = np.asarray(valid).reshape(-1) > 0
    if not v.any():
        return np.inf
    d = np.linalg.norm((kp_a[v, :2] - kp_b[v, :2]) * scale, axis=-1)
    return float(d.mean())


def project_np(cam_coord: np.ndarray, f, c) -> np.ndarray:
    """Perspective projection (numpy): [..., 3] mm → [..., 2] px."""
    f = np.asarray(f, np.float32)
    c = np.asarray(c, np.float32)
    z = cam_coord[..., 2]
    return np.stack([
        cam_coord[..., 0] / z * f[..., 0, None] + c[..., 0, None],
        cam_coord[..., 1] / z * f[..., 1, None] + c[..., 1, None],
    ], axis=-1).astype(np.float32)
