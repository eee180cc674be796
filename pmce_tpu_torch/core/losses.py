"""Training losses: coordinate L1, surface normal, edge length, Laplacian,
and the Stage-2 six-term mesh loss.

Port of ``pmce_tpu/core/losses.py`` (the reference's ``lib/core/loss.py``
and the loss of ``lib/core/base.py:132-148``). :func:`build_face_losses` is
the training path's normal + edge loss: one gather of the triangles for
both losses, and a backward that sums the per-corner gradients into the
vertices in a fixed order (a padded vertex → face-corner table).
"""

from __future__ import annotations

import numpy as np
import torch

from pmce_tpu_torch.ops.segments import segment_sum, segment_table
from pmce_tpu_torch.smpl.layer import full_f32


def coord_l1(pred: torch.Tensor, target: torch.Tensor,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """Mean L1 with the reference's multiplicative validity masking: the
    mask multiplies both sides and the mean divides by every element, so
    masked joints dilute the loss rather than renormalise it."""
    if valid is not None:
        pred = pred * valid
        target = target * valid
    return (pred - target).abs().mean()


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """torch ``F.normalize`` semantics: v / max(|v|, eps)."""
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(
        eps)


def _face_losses(P: torch.Tensor, Pg: torch.Tensor):
    """(normal loss, edge loss) of gathered triangles P, Pg: [B, F, 3, 3]."""
    v1o = _normalize(P[:, :, 1] - P[:, :, 0])
    v2o = _normalize(P[:, :, 2] - P[:, :, 0])
    v3o = _normalize(P[:, :, 2] - P[:, :, 1])
    v1g = _normalize(Pg[:, :, 1] - Pg[:, :, 0])
    v2g = _normalize(Pg[:, :, 2] - Pg[:, :, 0])
    ng = _normalize(torch.linalg.cross(v1g, v2g, dim=-1))
    ln = torch.stack([(v * ng).sum(-1).abs() for v in (v1o, v2o, v3o)]).mean()

    def elen(Q, a, b):
        return (Q[:, :, a] - Q[:, :, b]).square().sum(-1).sqrt()

    le = torch.stack([(elen(P, a, b) - elen(Pg, a, b)).abs()
                      for a, b in ((0, 1), (0, 2), (1, 2))]).mean()
    return ln, le


def normal_loss(coord_out, coord_gt, faces) -> torch.Tensor:
    """Mean |cos| between the predicted triangle edges and the ground
    truth's face normals (coord_*: [B, V, 3]; faces: [F, 3] long)."""
    return _face_losses(coord_out[:, faces], coord_gt[:, faces])[0]


def edge_length_loss(coord_out, coord_gt, faces) -> torch.Tensor:
    """Mean |predicted − ground-truth edge length| over every face edge."""
    return _face_losses(coord_out[:, faces], coord_gt[:, faces])[1]


def build_laplacian(faces: np.ndarray, num_verts: int) -> np.ndarray:
    """Row-normalised uniform Laplacian (dense [V, V], host-side)."""
    L = np.zeros((num_verts, num_verts), dtype=np.float32)
    for a, b in ((0, 1), (1, 2), (2, 0)):
        L[faces[:, a], faces[:, b]] = -1
        L[faces[:, b], faces[:, a]] = -1
    np.fill_diagonal(L, -L.sum(1))
    diag = np.diag(L).copy()
    L /= (diag[:, None] + 1e-8)
    return L


class _Contract(torch.autograd.Function):
    """``einsum("jv,bvk->bjk", M, x)`` for a constant [J, V] matrix M, in
    full f32 forward and backward."""

    @staticmethod
    def forward(ctx, M, x):
        ctx.save_for_backward(M)
        with full_f32():
            return torch.einsum("jv,bvk->bjk", M, x)

    @staticmethod
    def backward(ctx, g):
        (M,) = ctx.saved_tensors
        with full_f32():
            return None, torch.einsum("jv,bjk->bvk", M, g)


def contract_vertices(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[J, V] × [B, V, K] → [B, J, K] over the vertices in full f32 (a
    joint regressor applied to meshes, or a Laplacian)."""
    return _Contract.apply(M.to(x.dtype), x)


def laplacian_loss(laplacian: torch.Tensor, verts: torch.Tensor):
    """Mean squared Laplacian coordinates: [V, V] × [B, V, 3]."""
    return contract_vertices(laplacian, verts).square().sum(-1).mean()


class _FaceLosses(torch.autograd.Function):
    """Both face losses from one gather. The backward takes the gradient
    of the gathered triangles and sums it into the vertices over a padded
    vertex → face-corner table in a fixed order
    (:func:`~pmce_tpu_torch.ops.segments.segment_sum`; the JAX package's
    sorted ``segment_sum``), the same bits on every run; the ground truth
    gets a zero gradient."""

    @staticmethod
    def forward(ctx, pred, gt, faces, corners):
        P, Pg = pred[:, faces], gt[:, faces]
        ctx.save_for_backward(P, Pg, corners)
        return _face_losses(P, Pg)

    @staticmethod
    def backward(ctx, g_ln, g_le):
        P, Pg, corners = ctx.saved_tensors
        with torch.enable_grad():
            Pv = P.detach().requires_grad_(True)
            (dP,) = torch.autograd.grad(_face_losses(Pv, Pg), Pv,
                                        (g_ln, g_le))
        dm = segment_sum(dP.reshape(dP.shape[0], -1, 3), corners)
        return dm, torch.zeros_like(dm), None, None


def build_face_losses(faces: np.ndarray, num_verts: int, device="cuda"):
    """The fused normal + edge loss of ``build_face_losses``:
    ``fn(pred [B, V, 3], gt [B, V, 3]) -> (normal_loss, edge_loss)``, its
    gradient through :class:`_FaceLosses`. ``num_verts`` is V, the mesh's
    vertex count (not max(faces) + 1: an unreferenced last vertex would
    shrink the gradient). The vertex → face-corner table is built here,
    once."""
    faces = np.asarray(faces)
    if int(faces.max()) >= num_verts:
        raise ValueError(f"faces index vertex {int(faces.max())} of "
                         f"{num_verts}")
    faces_t = torch.as_tensor(faces, dtype=torch.long, device=device)
    corners = segment_table(faces.reshape(-1), num_verts).to(device)

    def face_losses(pred, gt):
        return _FaceLosses.apply(pred, gt, faces_t, corners)

    return face_losses


def pmce_total_loss(pred_mesh, evo_pose, pose3d,
                    gt_mesh, gt_lift_pose, gt_reg_pose,
                    mesh_valid, lift_valid, reg_valid,
                    faces, J_regressor_target,
                    normal_weight: float, edge_weight: float,
                    joint_weight: float, use_edge_loss,
                    face_loss_fn=None) -> tuple:
    """The reference trainer's six-term mesh loss (``base.py:132-148``).

    Units follow the reference: mesh losses in meters, joint losses in mm
    (the mesh regressed to joints at ×1000, the lifter's output already in
    mm). pred_mesh [B, V, 3] m; evo_pose [B, J, 3] m; pose3d [B, J, 3] mm;
    gt_mesh [B, V, 3] m; gt_lift_pose [B, J, 3] mm; gt_reg_pose [B, 17, 3]
    mm; ``*_valid`` broadcastable masks or None; faces [F, 3] long;
    J_regressor_target [17, V]; ``use_edge_loss`` a bool or a 0/1 value
    gating the edge term; ``face_loss_fn`` the fused normal + edge loss of
    :func:`build_face_losses` (the training path) or None (the separate
    losses). Returns (total, dict of the six terms)."""
    pred_reg_pose = contract_vertices(J_regressor_target, pred_mesh * 1000.0)
    l_vertex = coord_l1(pred_mesh, gt_mesh, mesh_valid)
    if face_loss_fn is not None:
        ln, le = face_loss_fn(pred_mesh, gt_mesh)
    else:
        ln = normal_loss(pred_mesh, gt_mesh, faces)
        le = edge_length_loss(pred_mesh, gt_mesh, faces)
    l_normal = normal_weight * ln
    l_edge = edge_weight * le
    l_reg = joint_weight * coord_l1(pred_reg_pose, gt_reg_pose, reg_valid)
    l_evo = joint_weight * coord_l1(evo_pose * 1000.0, gt_lift_pose,
                                    lift_valid)
    l_lift = joint_weight * coord_l1(pose3d, gt_lift_pose, lift_valid)
    total = (l_vertex + l_normal + float(use_edge_loss) * l_edge + l_reg
             + l_evo + l_lift)
    terms = {"vertex": l_vertex, "normal": l_normal, "edge": l_edge,
             "reg_joint": l_reg, "evo_joint": l_evo, "lift_joint": l_lift}
    return total, terms
