"""3DPW ETL: reference on-disk sources → packed SequenceData.

Port of ``pmce_tpu/data/etl/pw3d.py``; the SMPL synthesis runs on
``device``.

Source layout (the reference's data/PW3D/dataset.py:90-183):

  {data_path}/
    3DPW_latest_{split}.json                   COCO-format, smpl_param per ann
    3DPW_{split}_joint_coco_img_noise.json     [seq][img][person] (train 2D)
    vitpose_3dpw_{split}_output.json           [{annotation_id, keypoints}]
    3DPW_{split}_joint_coco_cam.json           [seq][img][person] → [19, 3]
    3DPW_{split}_gt_joint_coco_img.json        [seq][img][person] → [19, 2/3]
    3DPW_{split}_joint_h36m_cam.json           [seq][img][person] → [17, 3]
    3DPW_{split}_img_feat.json                 {"seq_person_img": [2048]}

Protocol notes: gendered SMPL GT with translation passed through the layer
(:70-88); frames are sorted by img_path; samples whose feature key is
missing are skipped (:148-151); ViTPose test 2D gets pelvis/neck appended
(:156-157).
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from pmce_tpu_torch.data.etl.common import (
    CocoIndex,
    add_pelvis_and_neck,
    load_json,
    resolve_device,
    smpl_verts_joints,
)
from pmce_tpu_torch.data.packed import SequenceData
from pmce_tpu_torch.smpl.artifacts import SMPLArtifacts


def convert_pw3d(data_path: str, split: str,
                 arts: dict[str, SMPLArtifacts],
                 device="cuda") -> SequenceData:
    """Convert one 3DPW split.

    Args:
      arts: gender → SMPLArtifacts. Keys among {male, female, neutral};
        missing genders fall back to 'neutral'.
      device: runs the SMPL synthesis (the card unless the caller asks
        for the CPU); one body-model upload a gender.
    """
    device = resolve_device(device)
    db = CocoIndex.from_file(
        osp.join(data_path, f"3DPW_latest_{split}.json"))
    if split == "train":
        det_noise = load_json(
            data_path, f"3DPW_{split}_joint_coco_img_noise.json")
        vit = None
    else:
        det_noise = None
        vit = {str(item["annotation_id"]):
               np.asarray(item["keypoints"], np.float32)[:, :3]
               for item in load_json(
                   data_path, f"vitpose_3dpw_{split}_output.json")}
    coco_cam = load_json(data_path, f"3DPW_{split}_joint_coco_cam.json")
    gt_coco_img = load_json(data_path,
                            f"3DPW_{split}_gt_joint_coco_img.json")
    h36m_cam = load_json(data_path, f"3DPW_{split}_joint_h36m_cam.json")
    feats = load_json(data_path, f"3DPW_{split}_img_feat.json")

    rows: dict[str, list] = {k: [] for k in (
        "path", "hw", "pose", "shape", "trans", "gender", "det", "jcam",
        "jimg", "jcam_h36m", "feat")}
    for aid in db.anns:
        ann = db.anns[aid]
        img = db.imgs[ann["image_id"]]
        seq = str(img["sequence"])
        img_name = img["file_name"]
        pid = ann["person_id"]
        img_idx = str(int(img_name[6:-4]))
        feat_key = f"{seq}_{int(pid)}_{img_idx}"
        if feat_key not in feats:
            continue
        sp = ann["smpl_param"]

        if split == "train":
            det = np.asarray(det_noise[seq][img_idx][str(int(pid))],
                             np.float32)
        else:
            det = add_pelvis_and_neck(
                np.asarray(vit[str(int(aid))], np.float32))

        rows["path"].append(osp.join(str(pid), seq, img_name))
        rows["hw"].append(np.asarray(
            (img["height"], img["width"]), np.int32))
        rows["pose"].append(np.asarray(sp["pose"], np.float32).reshape(72))
        rows["shape"].append(
            np.asarray(sp["shape"], np.float32).reshape(10))
        rows["trans"].append(
            np.asarray(sp["trans"], np.float32).reshape(3))
        rows["gender"].append(str(sp["gender"]))
        rows["det"].append(det[:, :2])
        rows["jcam"].append(np.asarray(
            coco_cam[seq][img_idx][str(int(pid))], np.float32))
        rows["jimg"].append(np.asarray(
            gt_coco_img[seq][img_idx][str(int(pid))],
            np.float32)[:, :2])
        rows["jcam_h36m"].append(np.asarray(
            h36m_cam[seq][img_idx][str(int(pid))], np.float32))
        rows["feat"].append(np.asarray(feats[feat_key], np.float32))

    order = np.argsort(np.asarray(rows["path"]))
    for k in rows:
        rows[k] = [rows[k][i] for i in order]

    # Gendered SMPL GT in mm, root-relativized by the H36M pelvis
    # (PW3D dataset.py:70-88 and the getitem root subtraction :240-242).
    # NOTE: unlike H36M/MPII3D, PW3D does NOT clamp outlier betas.
    n = len(rows["path"])
    genders = np.asarray(rows["gender"])
    pose = np.stack(rows["pose"])
    shape = np.stack(rows["shape"])
    trans = np.stack(rows["trans"])
    jcam_h36m = np.stack(rows["jcam_h36m"])
    root = jcam_h36m[:, :1].copy()
    V = next(iter(arts.values())).num_verts
    mesh_rel = np.zeros((n, V, 3), np.float32)
    for g in np.unique(genders):
        sel = genders == g
        art_g = arts.get(g, arts.get("neutral"))
        verts, _ = smpl_verts_joints(art_g, pose[sel], shape[sel],
                                     trans[sel], device=device)
        mesh_rel[sel] = verts * 1000.0 - root[sel]

    return SequenceData(
        img_names=np.asarray(rows["path"]),
        joint_cam=(np.stack(rows["jcam"]) - root).astype(np.float32),
        joint_cam_h36m=(jcam_h36m - root).astype(np.float32),
        joint_img=np.stack(rows["jimg"]).astype(np.float32),
        pose2d_det=np.stack(rows["det"]).astype(np.float32),
        features=np.stack(rows["feat"]),
        smpl_pose=pose,
        smpl_shape=shape,
        has_smpl=np.ones(n, bool),
        mesh_cam=mesh_rel,
        img_hw=np.stack(rows["hw"]),
        cam_idx=np.zeros(n, np.int32),
    )
