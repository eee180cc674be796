"""Human3.6M ETL: reference on-disk sources → packed SequenceData.

Port of ``pmce_tpu/data/etl/h36m.py``; the feature DB is read by the
port's own joblib reader (``joblib_io``), the SMPL synthesis runs on
``device``.

Source layout (exactly what the reference loads, its
data/Human36M/dataset.py:194-350):

  {data_path}/
    h36m_{split}_imgfeat_db_concat.pt          joblib {features, img_name}
    Human36M_{split}_start_idx_tight.json      [subj][act][subact][cam] → idx
    Human36M_{split}_cpn_joint_2d.json         {img_path: [17, 2/3]} (human36)
    annotations/
      Human36M_subject{S}_data.json            COCO-format images+annotations
      Human36M_subject{S}_camera.json          [cam] → {R, t, f, c}
      Human36M_subject{S}_joint_3d.json        [act][subact][frame] → [17, 3]
      Human36M_subject{S}_SMPL_NeuralAnnot.json [act][subact][frame] → fit
      Human36M_subject{S}_joint_coco_cam_3d_neuralannot.json   (coco input)
      Human36M_subject{S}_joint_coco_img_noise_neuralannot.json (coco input)

Protocol 2: train S1/5/6/7/8, test S9/11; frame subsampling 2; the
's_11_act_02_subact_02_ca_0' sequence skip; the feat_cnt / start_idx
feature-alignment walk with its name assert (dataset.py:316-319).
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from pmce_tpu_torch.data.etl.common import (
    CocoIndex,
    load_json,
    project_np,
    resolve_device,
    smpl_world_to_cam_mm,
)
from pmce_tpu_torch.data.etl.joblib_io import load as joblib_load
from pmce_tpu_torch.data.packed import SequenceData
from pmce_tpu_torch.ops.coords import process_bbox
from pmce_tpu_torch.smpl.artifacts import SMPLArtifacts

SUBJECTS = {("train", 2): (1, 5, 6, 7, 8), ("test", 2): (9, 11)}
SAMPLING_RATIO = 2
SKIP_SEQ_PREFIX = "s_11_act_02_subact_02_ca_0"


def _world2cam(x, R, t):
    return np.einsum("ij,nj->ni", R, x) + t


def convert_h36m(data_path: str, split: str, art: SMPLArtifacts,
                 input_joint_set: str = "human36",
                 protocol: int = 2, debug: bool = False,
                 subjects: tuple | None = None,
                 device="cuda") -> SequenceData:
    """Convert one Human3.6M split. See module docstring for the layout.

    ``subjects`` overrides the protocol subject list (partial conversions
    and fixture tests); default = protocol 2. ``device`` runs the SMPL
    synthesis (the card unless the caller asks for the CPU).
    """
    device = resolve_device(device)
    annot_path = osp.join(data_path, "annotations")
    if subjects is None:
        subjects = SUBJECTS[(split, protocol)]
    if debug:
        subjects = subjects[:1]

    # Feature DB + alignment index (dataset.py:206-217).
    img_db = joblib_load(
        osp.join(data_path, f"h36m_{split}_imgfeat_db_concat.pt"))
    feats_db = np.asarray(img_db["features"])
    feat_names = np.asarray(img_db["img_name"])
    perm = np.argsort(feat_names)
    feats_db, feat_names = feats_db[perm], feat_names[perm]
    start_idx = load_json(data_path,
                          f"Human36M_{split}_start_idx_tight.json")

    # Per-subject sources.
    paths = [osp.join(annot_path, f"Human36M_subject{s}_data.json")
             for s in subjects]
    db = CocoIndex.from_merged(paths)
    cameras, joints, joints_h36m, smpl_params = {}, {}, {}, {}
    coco_det = {}
    for s in subjects:
        cameras[str(s)] = load_json(
            annot_path, f"Human36M_subject{s}_camera.json")
        joints_h36m[str(s)] = load_json(
            annot_path, f"Human36M_subject{s}_joint_3d.json")
        smpl_params[str(s)] = load_json(
            annot_path, f"Human36M_subject{s}_SMPL_NeuralAnnot.json")
        if input_joint_set == "coco":
            joints[str(s)] = load_json(
                annot_path,
                f"Human36M_subject{s}_joint_coco_cam_3d_neuralannot.json")
            coco_det[str(s)] = load_json(
                annot_path,
                f"Human36M_subject{s}_joint_coco_img_noise_neuralannot.json")
        else:
            joints[str(s)] = joints_h36m[str(s)]

    # CPN 2D detections by image name (dataset.py:105-133; dict lookup
    # replaces the sorted-order positional alignment, same assert).
    cpn_det = None
    if input_joint_set == "human36":
        cpn_raw = load_json(data_path,
                            f"Human36M_{split}_cpn_joint_2d.json")
        cpn_det = {osp.basename(k): np.asarray(v, np.float32)
                   for k, v in cpn_raw.items()}

    rows: dict[str, list] = {k: [] for k in (
        "name", "jcam", "jcam_h36m", "jimg", "det", "feat", "pose", "shape",
        "trans", "has", "hw", "cam", "R", "t")}
    feat_cnt = -SAMPLING_RATIO
    for aid in db.anns:
        ann = db.anns[aid]
        img = db.imgs[ann["image_id"]]
        img_name = osp.basename(img["file_name"])
        frame_idx = img["frame_idx"]
        if frame_idx % SAMPLING_RATIO != 0:
            continue
        feat_cnt += SAMPLING_RATIO
        if img_name[:-12] == SKIP_SEQ_PREFIX:
            continue

        subject = img["subject"]
        action_idx = img["action_idx"]
        subaction_idx = img["subaction_idx"]
        cam_idx = img["cam_idx"]
        cam = cameras[str(subject)][str(cam_idx)]
        R = np.asarray(cam["R"], np.float32)
        t = np.asarray(cam["t"], np.float32)
        f = np.asarray(cam["f"], np.float32)
        c = np.asarray(cam["c"], np.float32)

        sp = smpl_params[str(subject)].get(str(action_idx), {}).get(
            str(subaction_idx), {}).get(str(frame_idx))
        has = sp is not None

        if process_bbox(np.asarray(ann["bbox"], np.float32),
                        aspect_ratio=1.0) is None:
            continue

        key = (str(subject), str(action_idx), str(subaction_idx),
               str(frame_idx))
        jw_h36m = np.asarray(
            joints_h36m[key[0]][key[1]][key[2]][key[3]], np.float32)
        jcam_h36m = _world2cam(jw_h36m, R, t)
        if input_joint_set == "human36":
            jcam = jcam_h36m
            jimg = project_np(jcam, f, c)
            det = cpn_det[img_name][:, :2]
        else:
            jcam = np.asarray(
                joints[key[0]][key[1]][key[2]][str(cam_idx)][key[3]],
                np.float32)
            jimg = project_np(jcam, f, c)
            det = np.asarray(
                coco_det[key[0]][key[1]][key[2]][str(cam_idx)][key[3]],
                np.float32)[:, :2]

        # Feature alignment walk (dataset.py:316-320).
        if frame_idx == 0:
            feat_cnt = start_idx[key[0]][key[1]][key[2]][str(cam_idx)]
        feat_img_name = osp.basename(str(feat_names[feat_cnt]))
        assert img_name == feat_img_name, (
            f"feature misalignment: {img_name} vs {feat_img_name}")

        rows["name"].append(img_name)
        rows["jcam"].append(jcam)
        rows["jcam_h36m"].append(jcam_h36m)
        rows["jimg"].append(jimg)
        rows["det"].append(det)
        rows["feat"].append(np.asarray(feats_db[feat_cnt], np.float32))
        rows["pose"].append(
            np.asarray(sp["pose"], np.float32).reshape(72) if has
            else np.zeros(72, np.float32))
        rows["shape"].append(
            np.asarray(sp["shape"], np.float32).reshape(10) if has
            else np.zeros(10, np.float32))
        rows["trans"].append(
            np.asarray(sp["trans"], np.float32).reshape(3) if has
            else np.zeros(3, np.float32))
        rows["has"].append(has)
        rows["hw"].append(np.asarray(
            (img["height"], img["width"]), np.int32))
        rows["cam"].append(int(cam_idx))
        rows["R"].append(R)
        rows["t"].append(t)

    has_smpl = np.asarray(rows["has"], bool)
    jcam_h36m = np.stack(rows["jcam_h36m"])
    root = jcam_h36m[:, :1].copy()                      # absolute pelvis
    n = len(has_smpl)
    V = art.num_verts
    mesh_rel = np.zeros((n, V, 3), np.float32)
    if has_smpl.any():
        mesh_mm, _ = smpl_world_to_cam_mm(
            art,
            np.stack(rows["pose"])[has_smpl],
            np.stack(rows["shape"])[has_smpl],
            np.stack(rows["trans"])[has_smpl],
            np.stack(rows["R"])[has_smpl],
            np.stack(rows["t"])[has_smpl], device=device)
        mesh_rel[has_smpl] = mesh_mm - root[has_smpl]

    return SequenceData(
        img_names=np.asarray(rows["name"]),
        joint_cam=(np.stack(rows["jcam"]) - root).astype(np.float32),
        joint_cam_h36m=(jcam_h36m - root).astype(np.float32),
        joint_img=np.stack(rows["jimg"]).astype(np.float32),
        pose2d_det=np.stack(rows["det"]).astype(np.float32),
        features=np.stack(rows["feat"]),
        smpl_pose=np.stack(rows["pose"]),
        smpl_shape=np.stack(rows["shape"]),
        has_smpl=has_smpl,
        mesh_cam=mesh_rel,
        img_hw=np.stack(rows["hw"]),
        cam_idx=np.asarray(rows["cam"], np.int32),
    )
