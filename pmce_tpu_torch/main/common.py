"""What the train and test CLIs share: the device, the model a config
names, and the test dataset's evaluation protocol."""

from __future__ import annotations

import torch

from pmce_tpu_torch.core.config import Config
from pmce_tpu_torch.core.trainer import H36M_EVAL_JOINTS
from pmce_tpu_torch.models.pmce import create_pmce, resolve_compute_dtype
from pmce_tpu_torch.models.pose_lifter import create_pose_lifter

def resolve_device(name: str) -> torch.device:
    """``--device``: the card unless the caller asks for the CPU. Without a
    card, asking for it raises; nothing carries on on the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA card here (torch "
            f"{torch.__version__}); pass --device cpu to run on the CPU")
    return device


def describe(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


def build_model(cfg: Config, dataset, art, coarse, device, seed: int):
    """The model ``cfg.MODEL`` names, sized for ``dataset``'s joint set,
    with the JAX package's initial values drawn from ``seed``. An unknown
    name raises: a mistyped one would otherwise evaluate a random model of
    the other stage against a checkpoint."""
    m = cfg.MODEL
    dtype = resolve_compute_dtype(m.compute_dtype)
    if m.name == "PMCE":
        model, _ = create_pmce(
            num_joint=dataset.num_joints, art=art, coarsening=coarse,
            joint_regressor_h36m=dataset.joint_regressor_h36m,
            embed_dim=m.hpe_dim, depth=m.hpe_dep,
            seqlen=cfg.DATASET.seqlen, dtype=dtype, fused=m.fused_attn,
            device=device, seed=seed)
        return model
    if m.name == "PoseEst":
        return create_pose_lifter(
            num_joints=dataset.num_joints, num_frames=cfg.DATASET.seqlen,
            embed_dim=m.hpe_dim, depth=m.hpe_dep, dtype=dtype,
            fused=m.fused_attn, device=device, seed=seed)
    raise ValueError(f"unknown MODEL.name {m.name!r}")


def eval_protocol(cfg: Config, test_ds) -> tuple[int, tuple | None]:
    """(root joint, eval joints) of the streamed evaluation: PW3D's
    Stage-1 protocol scores all COCO joints about the pelvis; every other
    path the 14 H36M eval joints about joint 0."""
    root = getattr(test_ds, "eval_root_idx", 0)
    joints = (None if (cfg.MODEL.name == "PoseEst" and root != 0)
              else H36M_EVAL_JOINTS)
    return root, joints
