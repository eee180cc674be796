"""Synthetic sequence data with the reference's sample structure.

Port of ``pmce_tpu/data/synthetic.py``: the same numpy draws in the same
order, so a seed gives the JAX package's arrays (the SMPL-derived ones to
f32 rounding). Real Human3.6M / 3DPW data is license-gated; the generator
makes packed arrays with the structure the dataset pipelines consume:

- per-frame camera-space GT joints from the SMPL layer, so mesh targets,
  regressed joints and lifted-pose targets are mutually consistent;
- smooth random pose trajectories grouped into videos with reference-style
  image names (``..._000001.jpg``), so the clip chunker groups them;
- noisy "detected" 2D poses from a perspective projection of the joints;
- 2048-d image features that are a fixed random linear code of the true
  pose, so a model can learn from them.

The SMPL forward of the synthesis runs on the card by default, skinning
with the kernel of ``pmce_tpu_torch.smpl.kernels``; ``device="cpu"`` runs
it on the host with the plain skinning. The JAX package pins synthesis to
the host so that a producer does not contend with the training step (and,
on a remote TPU, saves a round trip per call). Here a split is made whole
before training starts, so nothing runs beside it, and the card is the
default of every entry point of the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pmce_tpu_torch.smpl.artifacts import SMPLArtifacts
from pmce_tpu_torch.smpl.layer import SMPLModel, smpl_forward


@dataclasses.dataclass
class SyntheticSequenceData:
    """Packed per-frame arrays for one synthetic dataset split."""

    img_names: np.ndarray        # [N] strings, reference naming convention
    joint_cam: np.ndarray        # [N, J, 3] camera-space GT joints (mm)
    joint_cam_h36m: np.ndarray   # [N, 17, 3] H36M-17 GT joints (mm)
    joint_img: np.ndarray        # [N, J, 2] projected GT 2D (pixels)
    pose2d_det: np.ndarray       # [N, J, 2] noisy detected 2D (pixels)
    features: np.ndarray         # [N, 2048] image features
    smpl_pose: np.ndarray        # [N, 72]
    smpl_shape: np.ndarray       # [N, 10]
    has_smpl: np.ndarray         # [N] bool
    mesh_cam: np.ndarray         # [N, V, 3] GT mesh (mm, root-relative)
    img_hw: np.ndarray           # [N, 2] (h, w)
    cam_idx: np.ndarray          # [N] int (h36m camera id)
    # Optional per-frame loss validities (float 0/1). The reference zeroes
    # these on bad fits while KEEPING the window in training
    # (reference data/Human36M/dataset.py:509-514) — distinct from
    # ``has_smpl``, which drops windows from the chunker entirely.
    # None ⇒ derived from has_smpl (mesh) / all-ones (lift/reg).
    mesh_valid: np.ndarray | None = None   # [N]
    lift_valid: np.ndarray | None = None   # [N]
    reg_valid: np.ndarray | None = None    # [N]

    def __len__(self):
        return len(self.img_names)


def _smpl_verts(model: SMPLModel, pose: np.ndarray,
                shape: np.ndarray) -> np.ndarray:
    """The SMPL forward on the model's device, in meters (numpy)."""
    dev = model.device
    with torch.no_grad():
        verts, _ = smpl_forward(
            model, torch.as_tensor(pose, dtype=torch.float32, device=dev),
            torch.as_tensor(shape, dtype=torch.float32, device=dev))
    return verts.cpu().numpy()


def _smooth_trajectory(rng, n, dim, scale, smoothing=7):
    x = rng.normal(scale=scale, size=(n + smoothing, dim))
    kernel = np.ones(smoothing) / smoothing
    out = np.stack([np.convolve(x[:, d], kernel, mode="valid")
                    for d in range(dim)], axis=1)
    return out[:n]


def generate_sequences(art: SMPLArtifacts,
                       joint_regressor: np.ndarray,
                       joint_regressor_h36m: np.ndarray | None = None,
                       num_videos: int = 3,
                       frames_per_video: int = 48,
                       seed: int = 0,
                       img_hw: tuple = (1000, 1000),
                       feature_dim: int = 2048,
                       det_noise_px: float = 3.0,
                       device="cuda") -> SyntheticSequenceData:
    """Generate consistent multi-video synthetic motion data.

    Args:
      art: SMPL artifacts (any vertex count).
      joint_regressor: [J, V] regressor defining the dataset's INPUT/lift
        joint set (h36m-17 or coco-19).
      joint_regressor_h36m: optional [17, V] regressor for the H36M-17
        regression targets; defaults to ``joint_regressor`` (the
        h36m-input case). Mirrors the reference carrying both joint sets
        when the input set is COCO (data/Human36M/dataset.py:306-314).
      num_videos: number of distinct video sequences.
      frames_per_video: frames per video.
      seed: RNG seed (deterministic).
      device: where the SMPL forward runs (the card unless asked).
    """
    rng = np.random.default_rng(seed)
    model = SMPLModel.from_artifacts(art, device=device)
    if joint_regressor_h36m is None:
        joint_regressor_h36m = joint_regressor
    J = joint_regressor.shape[0]
    h, w = img_hw
    focal = np.array([1100.0, 1100.0], dtype=np.float32)
    princpt = np.array([w / 2.0, h / 2.0], dtype=np.float32)

    # Fixed random projection pose→features so features carry information.
    feat_code = rng.normal(
        scale=1.0 / np.sqrt(3 * J), size=(3 * J, feature_dim)
    ).astype(np.float32)

    names, joint_cams, joint_imgs, dets, feats = [], [], [], [], []
    poses, shapes, meshes, joint_cams_h36m = [], [], [], []
    for vid in range(num_videos):
        n = frames_per_video
        pose_traj = _smooth_trajectory(rng, n, 72, scale=0.5)
        pose_traj[:, :3] *= 0.3
        shape = np.repeat(rng.normal(scale=0.8, size=(1, 10)), n, axis=0)

        verts = _smpl_verts(model, pose_traj, shape)  # meters
        # Dataset-joint-set GT from the mesh, like the reference's regressed
        # targets; place the body ~4.5 m in front of the camera.
        root_depth = 4.5 + 0.5 * rng.random()
        offset = np.array([0.0, 0.0, root_depth], dtype=np.float32)
        verts_cam = verts + offset
        jcam = np.einsum("jv,nvk->njk", joint_regressor, verts_cam)
        jcam_h36m = np.einsum("jv,nvk->njk", joint_regressor_h36m,
                              verts_cam)

        # Vectorized host-side projection (no device round trips).
        z = jcam[..., 2]
        jimg = np.stack(
            [jcam[..., 0] / z * focal[0] + princpt[0],
             jcam[..., 1] / z * focal[1] + princpt[1]], axis=-1
        ).astype(np.float32)
        det = jimg + rng.normal(scale=det_noise_px, size=jimg.shape)

        # Root convention mirrors the reference: everything is made
        # relative to the H36M root (pelvis) of the same frame.
        root = jcam_h36m[:, :1].copy()
        jcam_rel = (jcam - root) * 1000.0          # mm, root-relative
        jcam_h36m_rel = (jcam_h36m - root) * 1000.0
        mesh_rel = (verts_cam - root) * 1000.0     # mm, root-relative

        feat = (pose_traj @ rng.normal(scale=0.1, size=(72, 3 * J))
                ).astype(np.float32) @ feat_code
        feat += jcam_rel.reshape(n, -1) @ rng.normal(
            scale=1e-3, size=(3 * J, feature_dim)).astype(np.float32)

        for i in range(n):
            names.append(f"s_{seed:02d}_vid_{vid:02d}_ca_04_{i + 1:06d}.jpg")
        joint_cams.append(jcam_rel.astype(np.float32))
        joint_cams_h36m.append(jcam_h36m_rel.astype(np.float32))
        joint_imgs.append(jimg)
        dets.append(det.astype(np.float32))
        feats.append(feat.astype(np.float32))
        poses.append(pose_traj.astype(np.float32))
        shapes.append(shape.astype(np.float32))
        meshes.append(mesh_rel.astype(np.float32))

    n_total = num_videos * frames_per_video
    has_smpl = np.ones(n_total, dtype=bool)
    # A few frames without SMPL fits so the mesh chunker's drop logic runs.
    drop = rng.choice(n_total, size=max(1, n_total // 40), replace=False)
    has_smpl[drop] = False

    return SyntheticSequenceData(
        img_names=np.array(names),
        joint_cam=np.concatenate(joint_cams),
        joint_cam_h36m=np.concatenate(joint_cams_h36m),
        joint_img=np.concatenate(joint_imgs),
        pose2d_det=np.concatenate(dets),
        features=np.concatenate(feats),
        smpl_pose=np.concatenate(poses),
        smpl_shape=np.concatenate(shapes),
        has_smpl=has_smpl,
        mesh_cam=np.concatenate(meshes),
        img_hw=np.tile(np.array([img_hw], dtype=np.int32), (n_total, 1)),
        cam_idx=np.full(n_total, 4, dtype=np.int32),
    )
