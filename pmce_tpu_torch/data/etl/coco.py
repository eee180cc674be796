"""MSCOCO ETL (train-only static images): sources → packed SequenceData.

Port of ``pmce_tpu/data/etl/coco.py``; the feature DB is read by the
port's own joblib reader (``joblib_io``), the SMPL synthesis runs on
``device``, everything after it is JAX's numpy.

Source layout (the reference's data/COCO/dataset.py:102-176):
  {annot_path}/person_keypoints_train2014.json   COCO keypoints
  {annot_path}/coco_smplify_train.json           {aid: {smpl_param, cam_param}}
  {annot_path}/coco_train_db.pt                  joblib {img_name, features,
                                                  aid}

Per-sample GT (dataset.py:246-293): neutral SMPL with beta clamping, no
trans; scaled-orthographic projection ``xy/1000 * s + t``; root-relative by
the H36M pelvis regressed from the mesh; the SMPLify fitting gate (3.0 px in
the 64×64 crop against the annotated keypoints) zeroes ALL validities. The
noisy 2D input (``synthesize_pose`` over the projected GT) is precomputed
here with an explicit seed.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from pmce_tpu_torch.data.etl.common import (
    CocoIndex,
    add_pelvis_and_neck,
    clamp_betas,
    crop64_fit_error,
    load_json,
    resolve_device,
    smpl_verts_joints,
)
from pmce_tpu_torch.data.etl.joblib_io import load as joblib_load
from pmce_tpu_torch.data.noise import synthesize_pose
from pmce_tpu_torch.data.packed import SequenceData
from pmce_tpu_torch.ops.coords import get_bbox, process_bbox
from pmce_tpu_torch.smpl.artifacts import SMPLArtifacts

FITTING_THR_PX = 3.0   # following I2L-MeshNet (dataset.py:24)


def convert_coco(annot_path: str, art: SMPLArtifacts,
                 jr_h36m: np.ndarray, jr_coco: np.ndarray,
                 split: str = "train", seed: int = 0,
                 device="cuda") -> SequenceData:
    device = resolve_device(device)
    db = CocoIndex.from_file(
        osp.join(annot_path, f"person_keypoints_{split}2014.json"))
    smplify = load_json(annot_path, "coco_smplify_train.json")
    img_db = joblib_load(osp.join(annot_path, "coco_train_db.pt"))
    feat_aids = np.asarray(img_db["aid"])
    feats_db = np.asarray(img_db["features"])
    perm = np.argsort(feat_aids)
    feat_aids, feats_db = feat_aids[perm], feats_db[perm]

    rows: dict[str, list] = {k: [] for k in (
        "path", "hw", "kp", "kpvalid", "pose", "shape", "s", "t", "feat")}
    idx = -1
    for aid in db.anns:
        idx += 1
        ann = db.anns[aid]
        img = db.imgs[ann["image_id"]]
        if ann.get("iscrowd") or ann.get("num_keypoints", 0) == 0:
            idx -= 1
            continue
        if process_bbox(np.asarray(ann["bbox"], np.float32),
                        aspect_ratio=1.0) is None:
            continue
        kp = np.asarray(ann["keypoints"], np.float32).reshape(-1, 3)
        if str(aid) not in smplify:
            continue
        fit = smplify[str(aid)]
        assert int(feat_aids[idx]) == int(aid), (
            f"feature misalignment: {feat_aids[idx]} vs {aid}")

        rows["path"].append(osp.join("train2014", img["file_name"]))
        rows["hw"].append(np.asarray(
            (img["height"], img["width"]), np.int32))
        rows["kp"].append(kp[:, :2])
        rows["kpvalid"].append((kp[:, 2] > 0).astype(np.float32))
        rows["pose"].append(np.asarray(
            fit["smpl_param"]["pose"], np.float32).reshape(72))
        rows["shape"].append(np.asarray(
            fit["smpl_param"]["shape"], np.float32).reshape(10))
        rows["s"].append(np.asarray(
            fit["cam_param"]["s"], np.float32).reshape(-1))
        rows["t"].append(np.asarray(
            fit["cam_param"]["t"], np.float32).reshape(2))
        rows["feat"].append(np.asarray(feats_db[idx], np.float32))

    n = len(rows["path"])
    pose = np.stack(rows["pose"])
    shape = clamp_betas(np.stack(rows["shape"]))
    verts, _ = smpl_verts_joints(art, pose, shape, device=device)
    mesh_mm = verts * 1000.0

    jcam_h36m = np.einsum("jv,nvk->njk", jr_h36m, mesh_mm)
    jcam_coco = add_pelvis_and_neck(
        np.einsum("jv,nvk->njk", jr_coco, mesh_mm))
    s = np.stack(rows["s"])[:, :1]
    t = np.stack(rows["t"])
    jimg_coco = (jcam_coco[..., :2] / 1000.0) * s[:, None] + t[:, None]
    root = jcam_h36m[:, :1].copy()

    # Precomputed noisy detections + the SMPLify fitting gate.
    rng = np.random.default_rng(seed)
    dets = jimg_coco.copy().astype(np.float32)
    good = np.zeros(n, bool)
    kps = np.stack(rows["kp"])
    for i in range(n):
        tight = get_bbox(jimg_coco[i])
        area = float(tight[2] * tight[3])
        # Validity 1 on every joint (the reference passes xy1,
        # data/COCO/dataset.py:321): validity-0 joints are returned
        # UNTOUCHED by synthesize_pose, which made this a silent no-op.
        kp3 = np.concatenate(
            [jimg_coco[i, :17], np.ones((17, 1), np.float32)], axis=1)
        dets[i, :17] = synthesize_pose(kp3, area, rng)[:, :2]
        err = crop64_fit_error(tight, kps[i],
                               jimg_coco[i, :17], rows["kpvalid"][i])
        good[i] = err <= FITTING_THR_PX

    v = good.astype(np.float32)
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
        mesh_valid=v,
        lift_valid=v.copy(),
        reg_valid=v.copy(),
    )
