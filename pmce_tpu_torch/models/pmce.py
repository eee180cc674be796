"""Composed two-stage PMCE model: pose lifter + co-evolution decoder.

Port of ``pmce_tpu/models/pmce.py``. The lifter outputs millimeters and
the decoder consumes meters (÷1000); the outputs are (mesh [B, 6890, 3] m,
evo_pose [B, J, 3] m, pose3d [B, J, 3] mm), as the reference trainer takes
them. Two switches, as in the JAX package: ``dtype`` (None = f32, or
``torch.bfloat16``: params stay f32, products and activations run in bf16,
coordinate heads stay f32) and ``fused`` (the kernel path: the lifter trunk,
the GRU scan and the decoder chain; ``fused=False`` is the plain modular
path on any device).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn

from pmce_tpu_torch.models.coevo import CoevolutionDecoder
from pmce_tpu_torch.models.pose_lifter import PoseLifter
from pmce_tpu_torch.smpl.artifacts import SMPLArtifacts
from pmce_tpu_torch.smpl.mesh import (
    MeshCoarsening,
    downsample,
    nearest_joint_per_vertex,
)


def resolve_compute_dtype(name: str):
    """Map a config ``MODEL.compute_dtype`` string to the model policy."""
    table = {"float32": None, "f32": None,
             "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}
    try:
        return table[name]
    except KeyError:
        raise ValueError(
            f"MODEL.compute_dtype {name!r}: use float32 or bfloat16"
        ) from None


class PMCE(nn.Module):
    """Video 2D pose + image features → mid-frame 3D pose and SMPL mesh."""

    def __init__(self, num_joint: int = 17, embed_dim: int = 256,
                 depth: int = 3, vj_relation: tuple = (),
                 num_vertx: int = 431, num_verts_full: int = 6890,
                 seqlen: int = 16, joint_dim: int = 64, vertx_dim: int = 64,
                 gru_hidden: int = 1024, dtype=None, fused: bool = False):
        super().__init__()
        self.num_joint = num_joint
        self.pose_lifter = PoseLifter(
            num_joints=num_joint, num_frames=seqlen, embed_dim=embed_dim,
            depth=depth, dtype=dtype, fused=fused)
        self.pose_mesh_coevo = CoevolutionDecoder(
            num_joint, vj_relation, num_vertx=num_vertx,
            num_verts_full=num_verts_full, joint_dim=joint_dim,
            vertx_dim=vertx_dim, gru_hidden=gru_hidden, seqlen=seqlen,
            dtype=dtype, fused=fused)

    def forward(self, pose2d, img_feat):
        """pose2d [B, T, J, 2], img_feat [B, T, 2048] → (mesh, evo_pose,
        pose3d)."""
        pose3d = self.pose_lifter(pose2d, img_feat)
        evo_pose, mesh = self.pose_mesh_coevo(pose3d / 1000.0, img_feat)
        return mesh, evo_pose, pose3d

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Fill every parameter from ``generator`` (a CPU generator).

        Products get N(0, 1/fan_in) weights; the decoder's pos/Q/K embeds
        N(0, 1) as the JAX package initialises them; LayerNorm scales
        1 + N(0, 0.02²); biases and the lifter's pos-embeds N(0, 0.02²), so
        no bias path hides behind a zero; the frame fusion U(±1/√T)."""
        for name, p in self.named_parameters():
            shape = tuple(p.shape)
            leaf = name.rsplit(".", 1)[-1]
            if name == "pose_lifter.fusion.weight":
                bound = shape[1] ** -0.5
                v = (torch.rand(shape, generator=generator) * 2 - 1) * bound
            elif leaf.endswith("_embed"):
                std = 1.0 if name.startswith("pose_mesh_coevo") else 0.02
                v = torch.randn(shape, generator=generator) * std
            elif p.ndim == 1 and leaf == "weight":         # LayerNorm scale
                v = 1.0 + torch.randn(shape, generator=generator) * 0.02
            elif p.ndim == 1:                              # biases
                v = torch.randn(shape, generator=generator) * 0.02
            else:                              # [out, in(, k)] products
                fan_in = int(np.prod(shape[1:]))
                v = torch.randn(shape, generator=generator) * fan_in ** -0.5
            p.copy_(v)


def build_vj_relation(mean_vertices: np.ndarray,
                      joint_regressor: np.ndarray,
                      coarsening: MeshCoarsening) -> tuple:
    """Nearest-template-joint index for each coarse vertex.

    Template joints are regressed from the FULL-resolution mean mesh; the
    relation is computed against the mean mesh downsampled to the
    coarsening's last level (an f32 contraction in numpy)."""
    joints_template = joint_regressor @ mean_vertices
    levels = len(coarsening.sizes) - 1
    coarse = downsample(coarsening, np.asarray(mean_vertices, np.float32),
                        0, levels)
    return tuple(
        int(i) for i in nearest_joint_per_vertex(joints_template, coarse))


@dataclasses.dataclass(frozen=True)
class PMCEAssets:
    """Static data a PMCE model instance is built around."""

    mean_vertices: np.ndarray          # [6890, 3]
    joint_regressor_h36m: np.ndarray   # [17, 6890]
    vj_relation: tuple


def default_assets(art: SMPLArtifacts, coarsening: MeshCoarsening,
                   joint_regressor_h36m: np.ndarray | None = None
                   ) -> PMCEAssets:
    """Decoder assets from SMPL artifacts; without a converted H36M
    regressor, the JAX package's deterministic stand-in derived from the
    24-joint SMPL regressor."""
    if joint_regressor_h36m is None:
        jr24 = art.J_regressor
        picks = [
            (0,), (2,), (5,), (8,), (1,), (4,), (7,), (3, 6), (12,), (15,),
            (15,), (16,), (18,), (20,), (17,), (19,), (21,),
        ]
        rows = [np.mean([jr24[i] for i in p], axis=0) for p in picks]
        joint_regressor_h36m = np.stack(rows).astype(np.float32)

    vj = build_vj_relation(art.v_template, joint_regressor_h36m, coarsening)
    return PMCEAssets(
        mean_vertices=art.v_template.copy(),
        joint_regressor_h36m=joint_regressor_h36m,
        vj_relation=vj,
    )


def create_pmce(num_joint: int, art: SMPLArtifacts,
                coarsening: MeshCoarsening,
                joint_regressor_h36m: np.ndarray | None = None,
                embed_dim: int = 256, depth: int = 3, seqlen: int = 16,
                dtype=None, fused: bool = False, device="cpu",
                seed: int = 0) -> tuple[PMCE, PMCEAssets]:
    """Build an inference-mode PMCE on ``device`` with random weights drawn
    from ``seed`` (load a checkpoint over them with ``load_state_dict``)."""
    assets = default_assets(art, coarsening, joint_regressor_h36m)
    with torch.device("meta"):
        model = PMCE(num_joint=num_joint, embed_dim=embed_dim, depth=depth,
                     vj_relation=assets.vj_relation,
                     num_vertx=coarsening.sizes[-1],
                     num_verts_full=art.num_verts, seqlen=seqlen,
                     dtype=dtype, fused=fused)
    model = model.to_empty(device=device)
    model.pose_mesh_coevo.vj_relation.copy_(
        torch.as_tensor(assets.vj_relation, dtype=torch.long))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.eval(), assets
