"""Batched SMPL forward in PyTorch: blend shapes, kinematic chain, skinning.

Port of ``pmce_tpu/smpl/layer.py`` (the reference's
``smplpytorch/pytorch/smpl_layer.py:65-158``): axis-angle → rotation
matrices, shape and pose blend shapes, the 24-joint kinematic chain
composed level by level (the reference's parent-before-child order), the
inverse-bind correction and linear blend skinning.

Everything runs in full f32: the JAX package pins ``Precision.HIGHEST`` on
every contraction here, and the layer is held to 0.001 mm of an f64
oracle. :func:`full_f32` keeps TF32 off around the products on the card.
On a CUDA tensor :func:`smpl_forward` applies the skinning with the kernel
of :mod:`pmce_tpu_torch.smpl.kernels`.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from pmce_tpu_torch.ops.geometry import axis_angle_to_rotmat
from pmce_tpu_torch.smpl.artifacts import SMPLArtifacts, kintree_levels


@contextlib.contextmanager
def full_f32():
    """f32 products and convolutions in full f32 (no TF32) on the card for
    the duration of the block, the caller's settings restored after.
    Through the per-backend flags: since torch 2.9
    ``get_float32_matmul_precision`` raises once a caller has also set
    them."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


@dataclasses.dataclass(frozen=True)
class SMPLModel:
    """SMPL parameters on one device plus the static tree structure."""

    v_template: torch.Tensor   # [V, 3]
    shapedirs: torch.Tensor    # [V, 3, 10]
    posedirs: torch.Tensor     # [V, 3, 207]
    J_regressor: torch.Tensor  # [J, V]
    lbs_weights: torch.Tensor  # [V, J]
    faces: torch.Tensor        # [F, 3] int64
    parents: tuple = ()
    levels: tuple = ()

    @classmethod
    def from_artifacts(cls, art: SMPLArtifacts, device="cuda",
                       dtype=torch.float32) -> "SMPLModel":
        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        levels = tuple(tuple(int(i) for i in lvl)
                       for lvl in kintree_levels(art.kintree_parents))
        return cls(
            v_template=t(art.v_template), shapedirs=t(art.shapedirs),
            posedirs=t(art.posedirs), J_regressor=t(art.J_regressor),
            lbs_weights=t(art.lbs_weights),
            faces=torch.as_tensor(art.faces, dtype=torch.long, device=device),
            parents=tuple(int(p) for p in art.kintree_parents),
            levels=levels)

    @property
    def num_joints(self) -> int:
        return len(self.parents)

    @property
    def device(self) -> torch.device:
        return self.v_template.device


def _compose_chain(rotmats: torch.Tensor, joints: torch.Tensor,
                   parents: tuple, levels: tuple) -> torch.Tensor:
    """Global joint transforms [B, J, 4, 4] from local rotations
    [B, J, 3, 3] and rest joints [B, J, 3], one batched 4×4 product per
    tree level."""
    B, J = rotmats.shape[:2]
    par = torch.as_tensor(parents, device=joints.device)
    rel_t = joints - joints[:, par]
    rel_t = torch.cat([joints[:, :1], rel_t[:, 1:]], dim=1)
    top = torch.cat([rotmats, rel_t[..., None]], dim=-1)          # [B,J,3,4]
    bottom = torch.zeros(B, J, 1, 4, dtype=rotmats.dtype,
                         device=rotmats.device)
    bottom[..., 3] = 1.0
    rel = torch.cat([top, bottom], dim=-2)                        # [B,J,4,4]

    glob = [None] * J
    for j in levels[0]:
        glob[j] = rel[:, j]
    for lvl in levels[1:]:
        parent_t = torch.stack([glob[parents[j]] for j in lvl], dim=1)
        composed = parent_t @ rel[:, list(lvl)]
        for i, j in enumerate(lvl):
            glob[j] = composed[:, i]
    return torch.stack(glob, dim=1)


def skinning_transforms(model: SMPLModel, pose: torch.Tensor,
                        betas: torch.Tensor):
    """(v_posed [B, V, 3], A_skin [B, J, 4, 4], joints [B, J, 3]) for
    pose [B, 72] axis-angle and betas [B, 10]; ``A_skin`` has the
    inverse-bind translation folded in."""
    B = pose.shape[0]
    J = model.num_joints
    with full_f32():
        rotmats = axis_angle_to_rotmat(pose.reshape(B, J, 3))
        eye = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device)
        pose_map = (rotmats[:, 1:] - eye).reshape(B, 9 * (J - 1))
        v_shaped = model.v_template + torch.einsum(
            "vki,bi->bvk", model.shapedirs, betas)
        joints_rest = torch.einsum("jv,bvk->bjk", model.J_regressor,
                                   v_shaped)
        v_posed = v_shaped + torch.einsum("vkp,bp->bvk", model.posedirs,
                                          pose_map)
        A = _compose_chain(rotmats, joints_rest, model.parents, model.levels)
        joints_out = A[:, :, :3, 3]
        shifted = torch.einsum("bjmk,bjk->bjm", A[:, :, :3, :3], joints_rest)
        A_skin = torch.cat(
            [torch.cat([A[:, :, :3, :3], (A[:, :, :3, 3] - shifted)[..., None]],
                       dim=-1), A[:, :, 3:]], dim=-2)
    return v_posed, A_skin, joints_out


def apply_skinning(v_posed: torch.Tensor, A_skin: torch.Tensor,
                   lbs_weights: torch.Tensor) -> torch.Tensor:
    """Plain linear blend skinning: [B, V, 3] posed vertices from v_posed
    [B, V, 3], A_skin [B, J, 4, 4] and lbs_weights [V, J]."""
    B, J = A_skin.shape[:2]
    with full_f32():
        A_flat = A_skin[:, :, :3, :].reshape(B, J, 12)
        T = torch.einsum("vj,bjk->bvk", lbs_weights, A_flat).reshape(
            B, -1, 3, 4)
        return (torch.einsum("bvmk,bvk->bvm", T[..., :3], v_posed)
                + T[..., 3])


def smpl_forward(model: SMPLModel, pose: torch.Tensor, betas: torch.Tensor,
                 trans: torch.Tensor | None = None,
                 fused: bool = True):
    """(pose [B, 72], betas [B, 10][, trans [B, 3]]) → (verts [B, V, 3],
    joints [B, J, 3]) in meters.

    ``fused``: the skinning goes through
    :func:`~pmce_tpu_torch.smpl.kernels.fused_skinning`, which launches the
    kernel for CUDA tensors (and runs the plain version for CPU tensors);
    otherwise the plain :func:`apply_skinning` on any device."""
    v_posed, A_skin, joints = skinning_transforms(model, pose, betas)
    if fused:
        from pmce_tpu_torch.smpl.kernels import fused_skinning

        verts = fused_skinning(v_posed, A_skin, model.lbs_weights)
    else:
        verts = apply_skinning(v_posed, A_skin, model.lbs_weights)
    if trans is not None:
        verts = verts + trans[:, None, :]
        joints = joints + trans[:, None, :]
    return verts, joints


def regress_joints(J_regressor: torch.Tensor,
                   verts: torch.Tensor) -> torch.Tensor:
    """[K, V] regressor × [B, V, 3] vertices → [B, K, 3] joints."""
    with full_f32():
        return torch.einsum("kv,bvc->bkc", J_regressor, verts)
