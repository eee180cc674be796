"""Extended SMPL joint sets: face keypoints, the 49-joint SPIN set, maps.

Port of ``pmce_tpu/smpl/joints.py`` (numpy, unchanged).

Parity targets:
- reference lib/smpl.py:20-48 — the 29-joint set (24 SMPL joints +
  nose/eyes/ears picked as one-hot vertex rows appended to the regressor),
  flip pairs and skeleton;
- reference lib/models/smpl_mps.py:14-89 — the 49-joint SPIN/OpenPose
  convention (25 OpenPose + 24 GT joints) and the H36M→J17/J14 index maps.
"""

from __future__ import annotations

import numpy as np

# Mesh vertex indices of the face keypoints on the real SMPL topology
# (nose, L eye, R eye, L ear, R ear) — reference lib/smpl.py:21.
FACE_KPS_VERTEX = (331, 2802, 6262, 3489, 3990)

SMPL29_JOINT_NAMES = (
    "Pelvis", "L_Hip", "R_Hip", "Torso", "L_Knee", "R_Knee", "Spine",
    "L_Ankle", "R_Ankle", "Chest", "L_Toe", "R_Toe", "Neck", "L_Thorax",
    "R_Thorax", "Head", "L_Shoulder", "R_Shoulder", "L_Elbow", "R_Elbow",
    "L_Wrist", "R_Wrist", "L_Hand", "R_Hand", "Nose", "L_Eye", "R_Eye",
    "L_Ear", "R_Ear",
)

SMPL29_FLIP_PAIRS = (
    (1, 2), (4, 5), (7, 8), (10, 11), (13, 14), (16, 17), (18, 19),
    (20, 21), (22, 23), (25, 26), (27, 28),
)

SMPL29_SKELETON = (
    (0, 1), (1, 4), (4, 7), (7, 10), (0, 2), (2, 5), (5, 8), (8, 11),
    (0, 3), (3, 6), (6, 9), (9, 14), (14, 17), (17, 19), (21, 23),
    (9, 13), (13, 16), (16, 18), (18, 20), (20, 22), (9, 12), (12, 24),
    (24, 14), (24, 25), (24, 26), (25, 27), (26, 28),
)

# H36M-17 → 14 LSP-style eval joints (reference smpl_mps.py H36M_TO_J14).
H36M_TO_J17 = (6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10, 0, 7, 9)
H36M_TO_J14 = H36M_TO_J17[:14]


def extended_joint_regressor(J_regressor: np.ndarray,
                             face_vertices: tuple = FACE_KPS_VERTEX
                             ) -> np.ndarray:
    """Append one-hot face-keypoint rows to a [24, V] SMPL regressor.

    Parity: reference lib/smpl.py:22-33 — produces the 29-joint
    regressor used for demo/aux joint sets. Vertex indices are clipped for
    reduced synthetic meshes so tests work at any vertex count.
    """
    V = J_regressor.shape[1]
    rows = []
    for v in face_vertices:
        row = np.zeros((1, V), dtype=np.float32)
        row[0, min(v, V - 1)] = 1.0
        rows.append(row)
    return np.concatenate([J_regressor.astype(np.float32), *rows], axis=0)


def coco17_regressor(J_regressor24: np.ndarray,
                     face_vertices: tuple = FACE_KPS_VERTEX) -> np.ndarray:
    """[17, V] regressor in COCO-17 keypoint order.

    The demo's camera fit pairs mesh-regressed joints with ViTPose/COCO
    2D keypoints, so BOTH sides must share the COCO ordering (the
    reference fits against ``joint_regressor_coco``). Face keypoints
    (nose/eyes/ears) are one-hot vertex rows (lib/smpl.py:22-33 style);
    body joints map onto SMPL-24 rows.
    """
    V = J_regressor24.shape[1]

    def face_row(i):
        row = np.zeros(V, np.float32)
        row[min(face_vertices[i], V - 1)] = 1.0
        return row

    # COCO-17: nose, eyes, ears (face rows), then L/R shoulder, elbow,
    # wrist, hip, knee, ankle (SMPL-24 joint rows).
    smpl_idx = {"ls": 16, "rs": 17, "le": 18, "re": 19, "lw": 20,
                "rw": 21, "lh": 1, "rh": 2, "lk": 4, "rk": 5,
                "la": 7, "ra": 8}
    rows = [face_row(0), face_row(1), face_row(2), face_row(3),
            face_row(4)]
    rows += [J_regressor24[smpl_idx[k]] for k in
             ("ls", "rs", "le", "re", "lw", "rw",
              "lh", "rh", "lk", "rk", "la", "ra")]
    return np.stack(rows).astype(np.float32)


def spin49_regressor(J_regressor24: np.ndarray,
                     openpose_regressor: np.ndarray | None = None
                     ) -> np.ndarray:
    """Build the 49-joint SPIN regressor: 25 OpenPose + 24 SMPL joints.

    The real OpenPose-25 rows come from the converted
    ``J_regressor_extra`` artifact; absent that, the 25 rows are derived
    from the SMPL-24 regressor by name matching (structurally faithful
    stand-in for tests).
    """
    if openpose_regressor is None:
        from pmce_tpu_torch.data.kp_utils import JOINT_NAMES

        spin_names = JOINT_NAMES["spin"][:25]
        # Map "OP X" onto the nearest SMPL-24 joint by simple name rules.
        smpl_for_op = {
            "OP Nose": 15, "OP Neck": 12, "OP RShoulder": 17,
            "OP RElbow": 19, "OP RWrist": 21, "OP LShoulder": 16,
            "OP LElbow": 18, "OP LWrist": 20, "OP MidHip": 0,
            "OP RHip": 2, "OP RKnee": 5, "OP RAnkle": 8, "OP LHip": 1,
            "OP LKnee": 4, "OP LAnkle": 7, "OP REye": 15, "OP LEye": 15,
            "OP REar": 15, "OP LEar": 15, "OP LBigToe": 10,
            "OP LSmallToe": 10, "OP LHeel": 7, "OP RBigToe": 11,
            "OP RSmallToe": 11, "OP RHeel": 8,
        }
        openpose_regressor = np.stack(
            [J_regressor24[smpl_for_op[n]] for n in spin_names])
    return np.concatenate(
        [openpose_regressor.astype(np.float32),
         J_regressor24.astype(np.float32)], axis=0)
