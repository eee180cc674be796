"""Mock dataset sources in the reference's on-disk formats, without JAX.

The port's counterpart of ``tests/etl_fixtures.py``, for the machine that
has neither JAX nor joblib: ``chip_smoke.py`` writes full-width trees with
these writers, and the CPU tests write small ones. Each writer writes the
files the reference loads (COCO-format annotation JSONs, joblib feature
DBs, NeuralAnnot / SMPLify fit JSONs, CPN / ViTPose detection JSONs) and
returns its ground truth, computed through the world-frame SMPL of the
port (``data/etl/common.smpl_verts_joints`` on ``device``) and the camera
transform of the result, the other path than the converters' root-pose
fix-up.

With their default sizes the writers draw the numbers of
``tests/etl_fixtures.py`` in the same order from the same seed, so the two
write the same trees up to the SMPL forward's rounding; the sizes scale a
tree up (the SMPL forward then runs once for all bodies of a writer, and
the translations repeat with the default size's period, so that the bodies
stay in front of the cameras).
:func:`joblib_dump` writes joblib's file format (what
``pmce_tpu_torch/data/etl/joblib_io.py`` reads) without joblib.
"""

from __future__ import annotations

import bz2
import gzip
import io
import json
import lzma
import os
import os.path as osp
import pickle
import zlib

import numpy as np

from pmce_tpu_torch.data.etl.common import smpl_verts_joints
from pmce_tpu_torch.data.kp_utils import get_joint_names
from pmce_tpu_torch.smpl.artifacts import synthetic_artifacts

# joblib's array alignment (joblib >= 1.2, NUMPY_ARRAY_ALIGNMENT_BYTES).
_ALIGN = 16


class _JoblibPickler(pickle._Pickler):
    """joblib's ``NumpyPickler`` without joblib: an array becomes a
    ``joblib.numpy_pickle.NumpyArrayWrapper`` whose BUILD ends a frame,
    followed by the padding byte, the padding and the raw bytes (an object
    array: its own protocol-5 pickle)."""

    def __init__(self, file):
        super().__init__(file, protocol=4)
        self.file_handle = file

    def save(self, obj, save_persistent_id=True):
        if type(obj) is np.ndarray:
            self._save_array(obj)
        else:
            super().save(obj, save_persistent_id)

    def _save_array(self, a: np.ndarray) -> None:
        order = ("F" if a.flags.f_contiguous and not a.flags.c_contiguous
                 else "C")
        state = {"subclass": np.ndarray, "shape": a.shape, "order": order,
                 "dtype": a.dtype, "allow_mmap": not a.dtype.hasobject,
                 "numpy_array_alignment_bytes": _ALIGN}
        # The wrapper's class by name, then NEWOBJ and BUILD of its state,
        # as pickling a NumpyArrayWrapper instance writes them.
        self.save("joblib.numpy_pickle")
        self.save("NumpyArrayWrapper")
        self.write(pickle.STACK_GLOBAL + pickle.EMPTY_TUPLE + pickle.NEWOBJ)
        self.save(state)
        self.write(pickle.BUILD)
        self.framer.commit_frame(force=True)
        f = self.file_handle
        if a.dtype.hasobject:
            pickle.dump(a, f, protocol=5)
            return
        pad = _ALIGN - (f.tell() + 1) % _ALIGN
        f.write(bytes([pad]) + b"\xff" * pad)
        f.write(a.tobytes(order=order))


def joblib_dump(value, path, compress: str | None = None) -> None:
    """Write ``value`` in joblib's format: uncompressed, or through
    ``compress`` in {zlib, gzip, bz2, lzma, xz} at joblib's default level
    3."""
    buf = io.BytesIO()
    _JoblibPickler(buf).dump(value)
    data = buf.getvalue()
    encode = {
        None: lambda d: d,
        "zlib": lambda d: zlib.compress(d, 3),
        "gzip": lambda d: gzip.compress(d, 3, mtime=0),
        "bz2": lambda d: bz2.compress(d, 3),
        "lzma": lambda d: lzma.compress(d, lzma.FORMAT_ALONE, preset=3),
        "xz": lambda d: lzma.compress(d, lzma.FORMAT_XZ, preset=3),
    }[compress]
    with open(path, "wb") as fh:
        fh.write(encode(data))


def small_art(seed=0):
    return synthetic_artifacts(seed=seed, num_verts=120, num_faces=200)


def small_regressors(V, rng):
    def make(k):
        jr = np.zeros((k, V), np.float32)
        for j in range(k):
            idx = rng.choice(V, size=4, replace=False)
            w = rng.random(4).astype(np.float32)
            jr[j, idx] = w / w.sum()
        return jr
    return make(17), make(17)  # h36m-17 and coco-17 (pre pelvis/neck)


def rot_xyz(rx, ry, rz):
    cx, sx, cy, sy, cz, sz = (np.cos(rx), np.sin(rx), np.cos(ry),
                              np.sin(ry), np.cos(rz), np.sin(rz))
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (Rz @ Ry @ Rx).astype(np.float32)


def _project(jcam_mm, f, c):
    z = jcam_mm[:, 2]
    return np.stack([jcam_mm[:, 0] / z * f[0] + c[0],
                     jcam_mm[:, 1] / z * f[1] + c[1]], axis=1)


def _coco19(jc17):
    pelvis = (jc17[11] + jc17[12]) / 2
    neck = (jc17[5] + jc17[6]) / 2
    return np.concatenate([jc17, pelvis[None], neck[None]])


def _dump_json(obj, *parts):
    with open(osp.join(*parts), "w") as fh:
        json.dump(obj, fh)


def build_h36m_mock(root: str, art, jr_h36m, seed=0, n_frames=12,
                    subjects=(1, 5), device="cpu"):
    """A mock h36m_data tree: train ``subjects``, one action and
    subaction, cameras 1 and 4, ``n_frames`` frames (every second one
    sampled). Returns the ground truth of the sampled frames."""
    rng = np.random.default_rng(seed)
    annot_path = osp.join(root, "annotations")
    os.makedirs(annot_path, exist_ok=True)

    cams = [1, 4]
    # Annotation / image ids start at subject × base, as in
    # tests/etl_fixtures.py; a base past the frame count keeps them unique.
    id_base = 1000 if n_frames * len(cams) <= 1000 else 10 ** 7
    f = np.array([1100.0, 1100.0], np.float32)
    c = np.array([500.0, 500.0], np.float32)
    cameras = {
        1: {"R": rot_xyz(0.05, 0.1, -0.03).tolist(),
            "t": [100.0, -50.0, 4500.0], "f": f.tolist(), "c": c.tolist()},
        4: {"R": rot_xyz(-0.04, 0.6, 0.02).tolist(),
            "t": [-80.0, 30.0, 5200.0], "f": f.tolist(), "c": c.tolist()},
    }

    truth = {"frames": [], "feat": {}}
    all_feat_entries = []
    for subject in subjects:
        images, annots = [], []
        joint_3d = {"2": {"1": {}}}
        smpl = {"2": {"1": {}}}
        aid = subject * id_base
        draws = [(rng.normal(scale=0.3, size=72).astype(np.float32),
                  rng.normal(scale=0.5, size=10).astype(np.float32))
                 for _ in range(n_frames)]
        verts_m, _ = smpl_verts_joints(
            art, np.stack([p for p, _ in draws]),
            np.stack([s for _, s in draws]), device=device)
        frames = []
        for frame, (pose, shape) in enumerate(draws):
            trans = np.array([0.1 * (frame % 12), 0.02 * subject, 0.5],
                             np.float32)
            has_smpl = not (subject == 5 and frame == 4)
            verts_w = (verts_m[frame] + trans) * 1000.0          # world mm
            jw_h36m = jr_h36m @ verts_w                          # [17, 3]
            joint_3d["2"]["1"][str(frame)] = jw_h36m.tolist()
            if has_smpl:
                smpl["2"]["1"][str(frame)] = {
                    "pose": pose.tolist(), "shape": shape.tolist(),
                    "trans": trans.tolist(),
                }
            frames.append((frame, has_smpl, verts_w, jw_h36m))

        for cam in cams:
            R = np.asarray(cameras[cam]["R"], np.float32)
            t = np.asarray(cameras[cam]["t"], np.float32)
            for frame, has_smpl, verts_w, jw_h36m in frames:
                img_name = (f"s_{subject:02d}_act_02_subact_01_"
                            f"ca_{cam:02d}_{frame + 1:06d}.jpg")
                images.append({
                    "id": aid, "file_name": img_name,
                    "width": 1000, "height": 1002,
                    "frame_idx": frame, "subject": subject,
                    "action_idx": 2, "subaction_idx": 1, "cam_idx": cam,
                })
                jcam = jw_h36m @ R.T + t
                jimg = _project(jcam, f, c)
                annots.append({
                    "id": aid, "image_id": aid,
                    "bbox": [float(jimg[:, 0].min()),
                             float(jimg[:, 1].min()),
                             float(np.ptp(jimg[:, 0]) + 1),
                             float(np.ptp(jimg[:, 1]) + 1)],
                })
                aid += 1
                feat = rng.normal(size=2048).astype(np.float32)
                all_feat_entries.append((img_name, feat))
                if frame % 2 == 0:
                    truth["feat"][img_name] = feat
                    truth["frames"].append(dict(
                        img_name=img_name, subject=subject, cam=cam,
                        frame=frame, has_smpl=has_smpl,
                        jcam_h36m=jcam, jimg=jimg,
                        mesh_cam=verts_w @ R.T + t))
        prefix = f"Human36M_subject{subject}"
        _dump_json({"images": images, "annotations": annots},
                   annot_path, f"{prefix}_data.json")
        _dump_json({str(k): v for k, v in cameras.items()},
                   annot_path, f"{prefix}_camera.json")
        _dump_json(joint_3d, annot_path, f"{prefix}_joint_3d.json")
        _dump_json(smpl, annot_path, f"{prefix}_SMPL_NeuralAnnot.json")

    # Feature DB sorted by name + the start-idx walk index.
    all_feat_entries.sort(key=lambda e: e[0])
    names = np.array([e[0] for e in all_feat_entries])
    feats = np.stack([e[1] for e in all_feat_entries])
    joblib_dump({"features": feats, "img_name": names},
                osp.join(root, "h36m_train_imgfeat_db_concat.pt"))
    start_idx: dict = {}
    for i, n in enumerate(names):
        # s_SS_act_AA_subact_BB_ca_CC_FFFFFF.jpg
        parts = str(n).split("_")
        subject, act = str(int(parts[1])), str(int(parts[3]))
        subact, cam = str(int(parts[5])), str(int(parts[7]))
        if int(str(n)[-10:-4]) == 1:
            start_idx.setdefault(subject, {}).setdefault(
                act, {}).setdefault(subact, {})[cam] = i
    _dump_json(start_idx, root, "Human36M_train_start_idx_tight.json")
    # CPN detections: GT 2D + a fixed offset.
    _dump_json({fr["img_name"]: (fr["jimg"] + 1.5).tolist()
                for fr in truth["frames"]},
               root, "Human36M_train_cpn_joint_2d.json")
    return truth


def build_pw3d_mock(root: str, art, jr_h36m, jr_coco, split="test",
                    seed=1, n_frames=8, device="cpu"):
    """Mock pw3d_data: 2 sequences (male, female) × ``n_frames`` frames ×
    1 person."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    f = np.array([1000.0, 1000.0], np.float32)
    c = np.array([400.0, 400.0], np.float32)
    genders = {"seq_a": "male", "seq_b": "female"}
    draws = []
    for seq in genders:
        for frame in range(n_frames):
            pose = rng.normal(scale=0.3, size=72).astype(np.float32)
            shape = rng.normal(scale=0.5, size=10).astype(np.float32)
            feat = rng.normal(size=2048).astype(np.float32)
            trans = np.array([0.05 * (frame % 8), 0.0, 4.0], np.float32)
            draws.append((seq, frame, pose, shape, trans, feat))
    verts_m, _ = smpl_verts_joints(
        art, np.stack([d[2] for d in draws]), np.stack([d[3] for d in draws]),
        np.stack([d[4] for d in draws]), device=device)

    images, annots, vit = [], [], []
    coco_cam: dict = {}
    gt_coco_img: dict = {}
    h36m_cam: dict = {}
    feats: dict = {}
    truth = {"frames": []}
    for aid, (seq, frame, pose, shape, trans, feat) in enumerate(draws):
        img_name = f"image_{frame:05d}.jpg"
        mesh_mm = verts_m[aid] * 1000.0
        jh = jr_h36m @ mesh_mm
        jc = _coco19(jr_coco @ mesh_mm)
        jimg = _project(jc, f, c)
        images.append({"id": aid, "file_name": img_name,
                       "width": 800, "height": 800, "sequence": seq})
        annots.append({
            "id": aid, "image_id": aid, "person_id": 0,
            "smpl_param": {
                "pose": pose.tolist(), "shape": shape.tolist(),
                "trans": trans.tolist(), "gender": genders[seq]},
        })
        fidx = str(frame)
        coco_cam.setdefault(seq, {}).setdefault(fidx, {})["0"] = jc.tolist()
        gt_coco_img.setdefault(seq, {}).setdefault(fidx, {})["0"] = (
            jimg.tolist())
        h36m_cam.setdefault(seq, {}).setdefault(fidx, {})["0"] = jh.tolist()
        feats[f"{seq}_0_{frame}"] = feat.tolist()
        vit.append({"annotation_id": aid,
                    "keypoints": np.concatenate(
                        [jimg[:17] + 2.0, np.ones((17, 1), np.float32)],
                        axis=1).tolist()})
        truth["frames"].append(dict(
            path=osp.join("0", seq, img_name), mesh_mm=mesh_mm,
            jcam_h36m=jh, feat=feat, gender=genders[seq]))

    _dump_json({"images": images, "annotations": annots},
               root, f"3DPW_latest_{split}.json")
    _dump_json(coco_cam, root, f"3DPW_{split}_joint_coco_cam.json")
    _dump_json(gt_coco_img, root, f"3DPW_{split}_gt_joint_coco_img.json")
    _dump_json(h36m_cam, root, f"3DPW_{split}_joint_h36m_cam.json")
    _dump_json(feats, root, f"3DPW_{split}_img_feat.json")
    if split == "train":
        noise = {s: {f_: {p: (np.asarray(v)[:, :2] + 1.0).tolist()
                          for p, v in d.items()}
                     for f_, d in per.items()}
                 for s, per in gt_coco_img.items()}
        _dump_json(noise, root, f"3DPW_{split}_joint_coco_img_noise.json")
    else:
        _dump_json(vit, root, f"vitpose_3dpw_{split}_output.json")
    return truth


def build_mpii3d_train_mock(root: str, art, jr_h36m, jr_coco, seed=2,
                            n_frames=8, device="cpu"):
    """Mock MPI-INF-3DHP train: 1 subject, 1 seq, 2 cams, ``n_frames``
    frames."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    f, c = [1200.0, 1200.0], [1024.0, 1024.0]
    R1 = rot_xyz(0.1, -0.2, 0.05)
    cams = {"1": {"1": {"0": {"R": R1.tolist(),
                              "t": [50.0, 20.0, 3800.0],
                              "focal": f, "princpt": c,
                              "img_shape": [2048, 2048]},
                        "1": {"R": rot_xyz(0, 0.9, 0).tolist(),
                              "t": [-60.0, 10.0, 4100.0],
                              "focal": f, "princpt": c,
                              "img_shape": [2048, 2048]}}}}
    smpl: dict = {"1": {"1": {}}}
    draws = []
    for frame in range(n_frames):
        pose = rng.normal(scale=0.3, size=72).astype(np.float32)
        shape = rng.normal(scale=0.5, size=10).astype(np.float32)
        trans = np.array([0.02 * (frame % 8), 0.01, 0.3], np.float32)
        smpl["1"]["1"][str(frame)] = {"pose": pose.tolist(),
                                      "shape": shape.tolist(),
                                      "trans": trans.tolist()}
        draws.append((pose, shape, trans))
    verts_m, _ = smpl_verts_joints(
        art, np.stack([d[0] for d in draws]),
        np.stack([d[1] for d in draws]), device=device)
    frames = [(frame, (verts_m[frame] + draws[frame][2]) * 1000.0)
              for frame in range(n_frames)]

    images, annots = [], []
    coco_cam: dict = {}
    gt_coco_img: dict = {}
    h36m_cam: dict = {}
    noise_2d: dict = {}
    feat_names, feat_vals = [], []
    truth = {"frames": []}
    aid = 0
    for vid in ("0", "1"):
        cam = cams["1"]["1"][vid]
        R = np.asarray(cam["R"], np.float32)
        t = np.asarray(cam["t"], np.float32)
        fx = np.asarray(cam["focal"], np.float32)
        cx = np.asarray(cam["princpt"], np.float32)
        for frame, verts_w in frames:
            mesh_cam_mm = verts_w @ R.T + t
            jh = jr_h36m @ mesh_cam_mm
            jc = _coco19(jr_coco @ mesh_cam_mm)
            jimg = _project(jc, fx, cx)
            images.append({"id": aid, "subject_idx": 1, "seq_idx": 1,
                           "cam_idx": int(vid), "frame_idx": frame,
                           "width": 2048, "height": 2048})
            annots.append({"id": aid, "image_id": aid})
            fidx = str(frame)
            for tree, value in ((coco_cam, jc), (gt_coco_img, jimg),
                                (h36m_cam, jh), (noise_2d, jimg + 1.0)):
                tree.setdefault("1", {}).setdefault("1", {}).setdefault(
                    vid, {})[fidx] = value.tolist()
            name = osp.join("data/mpii_3d", "S1", "Seq1",
                            f"video_{vid}", str(frame).zfill(6) + ".jpg")
            feat = rng.normal(size=2048).astype(np.float32)
            feat_names.append(name)
            feat_vals.append(feat)
            truth["frames"].append(dict(
                vid=vid, frame=frame, mesh_cam=mesh_cam_mm,
                jcam_h36m=jh, feat=feat))
            aid += 1

    _dump_json({"images": images, "annotations": annots},
               root, "MPI-INF-3DHP.json")
    _dump_json(smpl, root, "MPI-INF-3DHP_SMPL_NeuralAnnot.json")
    _dump_json(cams, root, "MPI-INF-3DHP_camera.json")
    _dump_json(coco_cam, root, "MPII3D_train_joint_coco_cam.json")
    _dump_json(gt_coco_img, root, "MPII3D_train_gt_joint_coco_img.json")
    _dump_json(h36m_cam, root, "MPII3D_train_joint_h36m_cam.json")
    _dump_json(noise_2d, root, "MPII3D_train_joint_coco_img_noise.json")
    joblib_dump({"img_name": np.array(feat_names),
                 "features": np.stack(feat_vals)},
                osp.join(root, "mpii3d_train_scale12_db.pt"))
    return truth


def build_mpii3d_val_mock(root: str, seed=3, n=20):
    """Mock MPII3D val: SPIN-order joints3D db + ViTPose json."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    n_spin = len(get_joint_names("spin"))
    names, j3ds, feats, vit = [], [], [], []
    for i in range(n):
        name = f"val_video_0/img_{i:06d}.jpg"
        j3d = rng.normal(scale=0.4, size=(n_spin, 3)).astype(np.float32)
        kp = np.abs(rng.normal(scale=100, size=(17, 3))).astype(np.float32)
        names.append(name)
        j3ds.append(j3d)
        feats.append(rng.normal(size=2048).astype(np.float32))
        vit.append({"image_name": name, "keypoints": kp.tolist()})
    joblib_dump({"img_name": np.array(names),
                 "features": np.stack(feats),
                 "joints3D": np.stack(j3ds)},
                osp.join(root, "mpii3d_val_scale12_db.pt"))
    _dump_json(vit, root, "vitpose_mpii3d_val_output.json")
    return {"names": names, "j3ds": j3ds}


def build_coco_mock(root: str, art, jr_h36m, jr_coco, seed=4, n=12,
                    device="cpu"):
    """Mock COCO train2014 annotations + SMPLify fits + feature db: image 3
    a crowd annotation, image 5 without a fit; good fits (even images) and
    bad ones (odd) for the fitting gate."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    s_cam, t_cam = 140.0, np.array([320.0, 240.0], np.float32)
    draws = []
    for i in range(n):
        pose = rng.normal(scale=0.3, size=72).astype(np.float32)
        shape = rng.normal(scale=0.5, size=10).astype(np.float32)
        feat = (np.zeros(2048, np.float32) if i == 5
                else rng.normal(size=2048).astype(np.float32))
        draws.append((pose, shape, feat))
    verts_m, _ = smpl_verts_joints(
        art, np.stack([d[0] for d in draws]),
        np.stack([d[1] for d in draws]), device=device)

    images, annots = [], []
    smplify: dict = {}
    feat_aids = []
    truth = {"frames": []}
    for i, (pose, shape, feat) in enumerate(draws):
        aid = 100 + i
        images.append({"id": i, "file_name": f"COCO_train2014_{i:012d}.jpg",
                       "width": 640, "height": 480})
        # Projected SMPL COCO joints (the converter's own projection) so
        # the mock plants good fits (even i) and bad ones (odd i).
        jc17 = jr_coco @ (verts_m[i] * 1000.0)
        jimg17 = (jc17[:, :2] / 1000.0) * s_cam + t_cam
        offset = 0.1 if i % 2 == 0 else 300.0
        kp = np.concatenate(
            [jimg17 + offset, np.ones((17, 1), np.float32)], axis=1)
        ann = {"id": aid, "image_id": i, "iscrowd": int(i == 3),
               "num_keypoints": 17,
               "keypoints": kp.reshape(-1).tolist(),
               "bbox": [50.0, 40.0, 200.0, 300.0]}
        annots.append(ann)
        feat_aids.append(aid)
        if i == 5:
            continue
        smplify[str(aid)] = {
            "smpl_param": {"pose": pose.tolist(), "shape": shape.tolist()},
            "cam_param": {"s": [s_cam], "t": t_cam.tolist()},
        }
        if ann["iscrowd"] == 0:
            truth["frames"].append(dict(aid=aid, pose=pose, shape=shape,
                                        feat=feat, good=(i % 2 == 0)))
    _dump_json({"images": images, "annotations": annots},
               root, "person_keypoints_train2014.json")
    _dump_json(smplify, root, "coco_smplify_train.json")
    # Feature db rows align with non-crowd annotation order (aid asserts).
    keep = [j for j, a in enumerate(annots) if not a["iscrowd"]]
    joblib_dump({"img_name": np.array([f"i{j}" for j in keep]),
                 "features": np.stack([draws[j][2] for j in keep]),
                 "aid": np.array([feat_aids[j] for j in keep])},
                osp.join(root, "coco_train_db.pt"))
    return truth


def build_mpii_mock(root: str, art, jr_h36m, jr_coco, seed=5, n=10):
    """Mock MPII train annotations + NeuralAnnot fits + feature db."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    images, annots = [], []
    fits: dict = {}
    feat_aids, feat_vals = [], []
    truth = {"frames": []}
    for i in range(n):
        aid = 200 + i
        images.append({"id": i, "file_name": f"images/{i:09d}.jpg",
                       "width": 1280, "height": 720})
        annots.append({"id": aid, "image_id": i, "iscrowd": 0,
                       "num_keypoints": 16,
                       "bbox": [100.0, 80.0, 300.0, 400.0]})
        pose = rng.normal(scale=0.3, size=72).astype(np.float32)
        shape = rng.normal(scale=0.5, size=10).astype(np.float32)
        trans = np.array([0.01 * (i % 10), 0.0, 4.0], np.float32)
        fits[str(aid)] = {
            "smpl_param": {"pose": pose.tolist(), "shape": shape.tolist(),
                           "trans": trans.tolist()},
            "cam_param": {"focal": [1500.0, 1500.0],
                          "princpt": [640.0, 360.0]},
        }
        feat = rng.normal(size=2048).astype(np.float32)
        feat_aids.append(aid)
        feat_vals.append(feat)
        truth["frames"].append(dict(aid=aid, pose=pose, shape=shape,
                                    trans=trans, feat=feat))
    _dump_json({"images": images, "annotations": annots},
               root, "train.json")
    _dump_json(fits, root, "MPII_train_SMPL_NeuralAnnot.json")
    joblib_dump({"img_name": np.array([str(i) for i in range(n)]),
                 "features": np.stack(feat_vals),
                 "aid": np.array(feat_aids)},
                osp.join(root, "mpii_train_db.pt"))
    return truth
