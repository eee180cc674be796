"""MPI-INF-3DHP ETL: reference on-disk sources → packed SequenceData.

Port of ``pmce_tpu/data/etl/mpii3d.py``; the feature DBs are read by the
port's own joblib reader (``joblib_io``), the SMPL synthesis runs on
``device``.

Train sources (the reference's data/MPII3D/dataset.py:126-250):
  MPI-INF-3DHP.json                       COCO-format (subject/seq/cam/frame)
  MPI-INF-3DHP_SMPL_NeuralAnnot.json      [sub][seq][frame] → fit
  MPI-INF-3DHP_camera.json                [sub][seq][cam] → params
  MPII3D_train_joint_coco_cam.json        [sub][seq][cam][frame] → [19, 3]
  MPII3D_train_gt_joint_coco_img.json     same nesting → [19, 2/3]
  MPII3D_train_joint_h36m_cam.json        same nesting → [17, 3]
  MPII3D_train_joint_coco_img_noise.json  same nesting (noisy 2D input)
  mpii3d_train_scale12_db.pt              joblib {img_name, features}

Val sources (:250-290):
  mpii3d_val_scale12_db.pt                joblib {img_name, features,
                                           joints3D (SPIN 49-joint order)}
  vitpose_mpii3d_val_output.json          [{image_name, keypoints}]
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from pmce_tpu_torch.data.etl.common import (
    CocoIndex,
    add_pelvis_and_neck,
    load_json,
    resolve_device,
    smpl_world_to_cam_mm,
)
from pmce_tpu_torch.data.etl.joblib_io import load as joblib_load
from pmce_tpu_torch.data.kp_utils import MPII3D_TEST_TO_H36M, convert_kps
from pmce_tpu_torch.data.packed import SequenceData
from pmce_tpu_torch.smpl.artifacts import SMPLArtifacts


def _train_img_name(sub, seq, vid, frame) -> str:
    # Feature-DB key layout (dataset.py:173).
    return osp.join("data/mpii_3d", f"S{sub}", f"Seq{seq}",
                    f"video_{vid}", str(frame).zfill(6) + ".jpg")


def convert_mpii3d_train(data_path: str, art: SMPLArtifacts,
                         device="cuda") -> SequenceData:
    device = resolve_device(device)
    db = CocoIndex.from_file(osp.join(data_path, "MPI-INF-3DHP.json"))
    smpl_params = load_json(data_path, "MPI-INF-3DHP_SMPL_NeuralAnnot.json")
    cam_params = load_json(data_path, "MPI-INF-3DHP_camera.json")
    coco_cam = load_json(data_path, "MPII3D_train_joint_coco_cam.json")
    gt_coco_img = load_json(data_path,
                            "MPII3D_train_gt_joint_coco_img.json")
    h36m_cam = load_json(data_path, "MPII3D_train_joint_h36m_cam.json")
    noise_2d = load_json(data_path,
                         "MPII3D_train_joint_coco_img_noise.json")
    feat_db = joblib_load(osp.join(data_path, "mpii3d_train_scale12_db.pt"))
    features = {str(n): np.asarray(f, np.float32) for n, f in
                zip(feat_db["img_name"], feat_db["features"])}

    rows: dict[str, list] = {k: [] for k in (
        "path", "hw", "pose", "shape", "trans", "jcam", "jimg",
        "jcam_h36m", "det", "feat", "R", "t")}
    for aid in db.anns:
        ann = db.anns[aid]
        img = db.imgs[ann["image_id"]]
        sub, seq = str(int(img["subject_idx"])), str(int(img["seq_idx"]))
        vid, frame = str(int(img["cam_idx"])), str(int(img["frame_idx"]))
        if _train_img_name(sub, seq, vid, frame) not in features:
            continue
        try:
            sp = smpl_params[sub][seq][frame]
        except KeyError:
            continue
        pose = np.asarray(sp["pose"], np.float32).reshape(72)
        shape = np.asarray(sp["shape"], np.float32).reshape(10)
        trans = np.asarray(sp["trans"], np.float32).reshape(3)
        if np.isnan(pose.sum() + shape.sum() + trans.sum()):
            continue
        cam = cam_params[sub][seq][vid]
        rows["path"].append(
            f"{data_path}/MPI_INF_3DHP/S{sub}/Seq{seq}/imageFrames/"
            f"video_{vid}/{frame.zfill(6)}.jpg")
        rows["hw"].append(np.asarray(cam["img_shape"], np.int32))
        rows["pose"].append(pose)
        rows["shape"].append(shape)
        rows["trans"].append(trans)
        rows["jcam"].append(
            np.asarray(coco_cam[sub][seq][vid][frame], np.float32))
        rows["jimg"].append(np.asarray(
            gt_coco_img[sub][seq][vid][frame], np.float32)[:, :2])
        rows["jcam_h36m"].append(
            np.asarray(h36m_cam[sub][seq][vid][frame], np.float32))
        rows["det"].append(np.asarray(
            noise_2d[sub][seq][vid][frame], np.float32)[:, :2])
        rows["feat"].append(
            features[_train_img_name(sub, seq, vid, frame)])
        rows["R"].append(np.asarray(cam["R"], np.float32).reshape(3, 3))
        rows["t"].append(np.asarray(cam["t"], np.float32).reshape(3))

    order = np.argsort(np.asarray(rows["path"]))
    for k in rows:
        rows[k] = [rows[k][i] for i in order]

    n = len(rows["path"])
    jcam_h36m = np.stack(rows["jcam_h36m"])
    root = jcam_h36m[:, :1].copy()
    mesh_mm, _ = smpl_world_to_cam_mm(
        art, np.stack(rows["pose"]), np.stack(rows["shape"]),
        np.stack(rows["trans"]), np.stack(rows["R"]), np.stack(rows["t"]),
        device=device)

    return SequenceData(
        img_names=np.asarray(rows["path"]),
        joint_cam=(np.stack(rows["jcam"]) - root).astype(np.float32),
        joint_cam_h36m=(jcam_h36m - root).astype(np.float32),
        joint_img=np.stack(rows["jimg"]).astype(np.float32),
        pose2d_det=np.stack(rows["det"]).astype(np.float32),
        features=np.stack(rows["feat"]),
        smpl_pose=np.stack(rows["pose"]),
        smpl_shape=np.stack(rows["shape"]),
        has_smpl=np.ones(n, bool),
        mesh_cam=(mesh_mm - root).astype(np.float32),
        img_hw=np.stack(rows["hw"]),
        cam_idx=np.zeros(n, np.int32),
    )


def convert_mpii3d_val(data_path: str, num_verts: int) -> SequenceData:
    """Val split: SPIN-format 3D joints → H36M-17 order ×1000 (mm), ViTPose
    2D inputs, NO mesh targets (zeroed, dataset.py:266-272,495-502)."""
    db = joblib_load(osp.join(data_path, "mpii3d_val_scale12_db.pt"))
    vit = {str(item["image_name"]):
           np.asarray(item["keypoints"], np.float32)[:, :3]
           for item in load_json(data_path, "vitpose_mpii3d_val_output.json")}

    names, jcams, feats, dets = [], [], [], []
    for i in range(len(db["img_name"])):
        name = str(db["img_name"][i])
        j3d = np.asarray(db["joints3D"][i], np.float32)
        # SPIN 49-joint → mpii3d_test → H36M-17 double walk ×1000
        # (dataset.py:266-272). The second step is the reference's
        # DATASET-name permutation (kp_utils.MPII3D_TEST_TO_H36M) — a
        # kp_utils-name match would leave the h36m nose slot zeroed
        # instead of filling it from the "Head (H36M)" row.
        jcam = convert_kps(j3d, "spin", "mpii3d_test")
        jcam = jcam[list(MPII3D_TEST_TO_H36M)] * 1000.0
        det = add_pelvis_and_neck(vit[name])[:, :2]
        names.append(name)
        jcams.append(jcam.astype(np.float32))
        feats.append(np.asarray(db["features"][i], np.float32))
        dets.append(det.astype(np.float32))

    order = np.argsort(np.asarray(names))
    names = [names[i] for i in order]
    n = len(names)
    jcam = np.stack(jcams)[order]
    # SPIN-converted joints are already root-centered in the reference's
    # eval (root subtracted at metric time); keep absolute here.
    return SequenceData(
        img_names=np.asarray(names),
        joint_cam=jcam,
        joint_cam_h36m=jcam,
        joint_img=np.stack(dets)[order],   # GT 2D unavailable at val
        pose2d_det=np.stack(dets)[order],
        features=np.stack(feats)[order],
        smpl_pose=np.zeros((n, 72), np.float32),
        smpl_shape=np.zeros((n, 10), np.float32),
        has_smpl=np.ones(n, bool),          # windows exist; targets zeroed
        mesh_cam=np.zeros((n, num_verts, 3), np.float32),
        img_hw=np.full((n, 2), 2048, np.int32),
        cam_idx=np.zeros(n, np.int32),
    )


def convert_mpii3d(data_path: str, split: str, art: SMPLArtifacts,
                   device="cuda") -> SequenceData:
    """Train through the SMPL synthesis on ``device``; val without SMPL
    (``device`` is still checked: the card unless the caller asks for the
    CPU)."""
    device = resolve_device(device)
    if split == "train":
        return convert_mpii3d_train(data_path, art, device)
    return convert_mpii3d_val(data_path, art.num_verts)
