"""MPII ETL (train-only static images): sources → packed SequenceData.

Port of ``pmce_tpu/data/etl/mpii.py``; the feature DB is read by the
port's own joblib reader (``joblib_io``), the SMPL synthesis runs on
``device``.

Source layout (the reference's data/MPII/dataset.py:102-160):
  {annot_path}/train.json                      COCO-format annotations
  {annot_path}/MPII_train_SMPL_NeuralAnnot.json {aid: {smpl_param, cam_param}}
  {annot_path}/mpii_train_db.pt                joblib {img_name, features,
                                                aid}

Differences from COCO (dataset.py:161-283): SMPL takes the fitted TRANS and
betas are NOT clamped; the camera is perspective (focal/princpt, cam2pixel);
there is NO fitting gate (all validities stay 1).
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from pmce_tpu_torch.data.etl.common import (
    CocoIndex,
    add_pelvis_and_neck,
    load_json,
    project_np,
    resolve_device,
    smpl_verts_joints,
)
from pmce_tpu_torch.data.etl.joblib_io import load as joblib_load
from pmce_tpu_torch.data.noise import synthesize_pose
from pmce_tpu_torch.data.packed import SequenceData
from pmce_tpu_torch.ops.coords import get_bbox, process_bbox
from pmce_tpu_torch.smpl.artifacts import SMPLArtifacts


def convert_mpii(annot_path: str, art: SMPLArtifacts,
                 jr_h36m: np.ndarray, jr_coco: np.ndarray,
                 seed: int = 0, device="cuda") -> SequenceData:
    device = resolve_device(device)
    db = CocoIndex.from_file(osp.join(annot_path, "train.json"))
    smpl_params = load_json(annot_path, "MPII_train_SMPL_NeuralAnnot.json")
    img_db = joblib_load(osp.join(annot_path, "mpii_train_db.pt"))
    feat_aids = np.asarray(img_db["aid"])
    feats_db = np.asarray(img_db["features"])

    rows: dict[str, list] = {k: [] for k in (
        "path", "hw", "pose", "shape", "trans", "f", "c", "feat")}
    for idx, aid in enumerate(db.anns):
        ann = db.anns[aid]
        img = db.imgs[ann["image_id"]]
        if ann.get("iscrowd") or ann.get("num_keypoints", 0) == 0:
            continue
        if process_bbox(np.asarray(ann["bbox"], np.float32),
                        aspect_ratio=1.0) is None:
            continue
        fit = smpl_params[str(aid)]
        assert int(feat_aids[idx]) == int(aid), (
            f"feature misalignment: {feat_aids[idx]} vs {aid}")

        rows["path"].append(osp.basename(img["file_name"]))
        rows["hw"].append(np.asarray(
            (img["height"], img["width"]), np.int32))
        rows["pose"].append(np.asarray(
            fit["smpl_param"]["pose"], np.float32).reshape(72))
        rows["shape"].append(np.asarray(
            fit["smpl_param"]["shape"], np.float32).reshape(10))
        rows["trans"].append(np.asarray(
            fit["smpl_param"]["trans"], np.float32).reshape(3))
        rows["f"].append(np.asarray(
            fit["cam_param"]["focal"], np.float32).reshape(2))
        rows["c"].append(np.asarray(
            fit["cam_param"]["princpt"], np.float32).reshape(2))
        rows["feat"].append(np.asarray(feats_db[idx], np.float32))

    n = len(rows["path"])
    pose = np.stack(rows["pose"])
    shape = np.stack(rows["shape"])
    trans = np.stack(rows["trans"])
    verts, _ = smpl_verts_joints(art, pose, shape, trans, device=device)
    mesh_mm = verts * 1000.0

    jcam_h36m = np.einsum("jv,nvk->njk", jr_h36m, mesh_mm)
    jcam_coco = add_pelvis_and_neck(
        np.einsum("jv,nvk->njk", jr_coco, mesh_mm))
    jimg_coco = project_np(jcam_coco, np.stack(rows["f"]),
                           np.stack(rows["c"]))
    root = jcam_h36m[:, :1].copy()

    rng = np.random.default_rng(seed)
    dets = jimg_coco.copy().astype(np.float32)
    for i in range(n):
        tight = get_bbox(jimg_coco[i])
        area = float(tight[2] * tight[3])
        # Validity 1 (reference passes xy1, data/MPII/dataset.py:295);
        # validity-0 joints pass through synthesize_pose untouched.
        kp3 = np.concatenate(
            [jimg_coco[i, :17], np.ones((17, 1), np.float32)], axis=1)
        dets[i, :17] = synthesize_pose(kp3, area, rng)[:, :2]

    return SequenceData(
        img_names=np.asarray(rows["path"]),
        joint_cam=(jcam_coco - root).astype(np.float32),
        joint_cam_h36m=(jcam_h36m - root).astype(np.float32),
        joint_img=jimg_coco.astype(np.float32),
        pose2d_det=dets,
        features=np.stack(rows["feat"]),
        smpl_pose=pose,
        smpl_shape=shape,
        has_smpl=np.ones(n, bool),
        mesh_cam=(mesh_mm - root).astype(np.float32),
        img_hw=np.stack(rows["hw"]),
        cam_idx=np.zeros(n, np.int32),
    )
