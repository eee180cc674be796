"""Keypoint-set vocabularies and cross-convention conversion.

Port of ``pmce_tpu/data/kp_utils.py`` (numpy, unchanged).

Functional parity target: reference lib/_kp_utils.py (the
``get_*_joint_names`` vocabularies and ``convert_kps``) and
``transform_joint_to_other_db`` (reference lib/aug_utils.py:10-21).

Joints are converted between skeleton conventions by NAME matching: a
destination joint takes the value of the same-named source joint, else
zeros. The vocabularies below cover every convention the pipelines use
(SPIN-49, H36M-17, COCO-17/19, MPI-INF-3DHP test-17, MPII-16, SMPL-24,
LSP-style common-14).
"""

from __future__ import annotations

import numpy as np

JOINT_NAMES = {
    "spin": (
        # 25 OpenPose joints followed by 24 "ground-truth" joints — the
        # SPIN regressor convention used by pre-extracted feature DBs.
        "OP Nose", "OP Neck", "OP RShoulder", "OP RElbow", "OP RWrist",
        "OP LShoulder", "OP LElbow", "OP LWrist", "OP MidHip", "OP RHip",
        "OP RKnee", "OP RAnkle", "OP LHip", "OP LKnee", "OP LAnkle",
        "OP REye", "OP LEye", "OP REar", "OP LEar", "OP LBigToe",
        "OP LSmallToe", "OP LHeel", "OP RBigToe", "OP RSmallToe",
        "OP RHeel",
        "rankle", "rknee", "rhip", "lhip", "lknee", "lankle", "rwrist",
        "relbow", "rshoulder", "lshoulder", "lelbow", "lwrist", "neck",
        "headtop", "hip", "thorax", "Spine (H36M)", "Jaw (H36M)",
        "Head (H36M)", "nose", "leye", "reye", "lear", "rear",
    ),
    "h36m": (
        "hip", "rhip", "rknee", "rankle", "lhip", "lknee", "lankle",
        "Spine (H36M)", "neck", "nose", "headtop",
        "lshoulder", "lelbow", "lwrist", "rshoulder", "relbow", "rwrist",
    ),
    "coco": (
        "nose", "leye", "reye", "lear", "rear", "lshoulder", "rshoulder",
        "lelbow", "relbow", "lwrist", "rwrist", "lhip", "rhip", "lknee",
        "rknee", "lankle", "rankle",
    ),
    "coco19": (
        "nose", "leye", "reye", "lear", "rear", "lshoulder", "rshoulder",
        "lelbow", "relbow", "lwrist", "rwrist", "lhip", "rhip", "lknee",
        "rknee", "lankle", "rankle", "hip", "neck",
    ),
    "mpii3d_test": (
        # The 17-joint MPI-INF-3DHP test set ordering ( _kp_utils.py:
        # get_mpii3d_test_joint_names). Position 16 fills from spin's
        # "Head (H36M)" row; the reference's SECOND walk (dataset names,
        # MPII3D/dataset.py:35-37: position 16 is 'Nose') then lands it
        # in the h36m nose slot — see MPII3D_TEST_TO_H36M.
        "headtop", "neck", "rshoulder", "relbow", "rwrist", "lshoulder",
        "lelbow", "lwrist", "rhip", "rknee", "rankle", "lhip", "lknee",
        "lankle", "hip", "Spine (H36M)", "Head (H36M)",
    ),
    "mpii": (
        "rankle", "rknee", "rhip", "lhip", "lknee", "lankle", "hip",
        "thorax", "neck", "headtop", "rwrist", "relbow", "rshoulder",
        "lshoulder", "lelbow", "lwrist",
    ),
    "smpl": (
        "hip", "lhip", "rhip", "Spine (H36M)", "lknee", "rknee",
        "spine2", "lankle", "rankle", "spine3", "ltoe", "rtoe", "neck",
        "lcollar", "rcollar", "headtop", "lshoulder", "rshoulder",
        "lelbow", "relbow", "lwrist", "rwrist", "lhand", "rhand",
    ),
    "common": (
        "rankle", "rknee", "rhip", "lhip", "lknee", "lankle", "rwrist",
        "relbow", "rshoulder", "lshoulder", "lelbow", "lwrist", "neck",
        "headtop",
    ),
}


# h36m[i] ← mpii3d_test[MPII3D_TEST_TO_H36M[i]]: the reference's second
# walk maps by its DATASET name tuples (MPII3D/dataset.py:35-37 'Head,
# Neck, …, Pelvis, Torso, Nose' → :55-57 'Pelvis, R_Hip, …, Nose, Head,
# …'), which is this fixed permutation — note position 16 (filled from
# spin "Head (H36M)") lands in the h36m NOSE slot.
MPII3D_TEST_TO_H36M = (14, 8, 9, 10, 11, 12, 13, 15, 1, 16, 0,
                       5, 6, 7, 2, 3, 4)


def get_joint_names(convention: str) -> tuple:
    try:
        return JOINT_NAMES[convention]
    except KeyError:
        raise ValueError(
            f"unknown keypoint convention {convention!r}; "
            f"known: {sorted(JOINT_NAMES)}") from None


def convert_kps(joints: np.ndarray, src: str, dst: str) -> np.ndarray:
    """Convert a [.., J_src, C] joint array between conventions by name.

    Destination joints absent from the source are zero-filled (matching the
    reference's behavior of leaving unmapped joints at zero).
    """
    src_names = get_joint_names(src)
    dst_names = get_joint_names(dst)
    out_shape = joints.shape[:-2] + (len(dst_names), joints.shape[-1])
    out = np.zeros(out_shape, dtype=joints.dtype)
    for di, name in enumerate(dst_names):
        if name in src_names:
            out[..., di, :] = joints[..., src_names.index(name), :]
    return out


def transform_joint_to_other_db(src_joint: np.ndarray, src_names: tuple,
                                dst_names: tuple) -> np.ndarray:
    """Name-matched reindexing between explicit name tuples."""
    out = np.zeros((len(dst_names),) + src_joint.shape[1:],
                   dtype=np.float32)
    for si, name in enumerate(src_names):
        if name in dst_names:
            out[dst_names.index(name)] = src_joint[si]
    return out


def add_pelvis_and_neck(joint_coord: np.ndarray,
                        lhip: int, rhip: int,
                        lshoulder: int, rshoulder: int,
                        only_pelvis: bool = False) -> np.ndarray:
    """Append midpoint pelvis (and neck) to a COCO-17 joint array.

    Parity: reference data/PW3D/dataset.py:185-200.
    """
    pelvis = (joint_coord[..., lhip, :] + joint_coord[..., rhip, :]) * 0.5
    parts = [joint_coord, pelvis[..., None, :]]
    if not only_pelvis:
        neck = (joint_coord[..., lshoulder, :]
                + joint_coord[..., rshoulder, :]) * 0.5
        parts.append(neck[..., None, :])
    return np.concatenate(parts, axis=-2)
