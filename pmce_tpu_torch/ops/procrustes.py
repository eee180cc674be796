"""Batched Procrustes (similarity) alignment on tensors.

Port of ``pmce_tpu/ops/procrustes.py``. The whole evaluation set is
aligned with one batched ``torch.linalg.svd`` (cuSOLVER on the card, LAPACK
on the CPU) in the reference's formulation:

  H = (A - muA)^T (B - muB) / n
  U s V^h = svd(H);  R = V U^T  (with the det(R) < 0 sign fix on V and s)
  c = sum(s) / var(A);  t = -c R muA + muB

The JAX package runs every product here at ``Precision.HIGHEST``; the
products run under :func:`full_f32`, so TF32 stays off on the card whatever
the caller set.
"""

from __future__ import annotations

import torch

from pmce_tpu_torch.smpl.layer import full_f32


def similarity_transform(A: torch.Tensor, B: torch.Tensor):
    """Least-squares similarity transform (c, R, t) aligning A onto B.

    Args:
      A: [..., N, 3] source points.
      B: [..., N, 3] target points.

    Returns:
      (c, R, t): scale [...], rotation [..., 3, 3], translation [..., 3].
    """
    n = A.shape[-2]
    with full_f32():
        mu_a = A.mean(-2, keepdim=True)
        mu_b = B.mean(-2, keepdim=True)
        H = torch.einsum("...ni,...nj->...ij", A - mu_a, B - mu_b) / n
        U, s, Vh = torch.linalg.svd(H)
        V = Vh.transpose(-1, -2)
        Ut = U.transpose(-1, -2)

        # det(R) < 0: flip the last singular value and the last column of
        # V, the reference's sign fix.
        sign = torch.where(torch.linalg.det(V @ Ut) < 0, -1.0, 1.0).to(
            A.dtype)
        s = torch.cat([s[..., :-1], s[..., -1:] * sign[..., None]], -1)
        V = torch.cat([V[..., :-1], V[..., -1:] * sign[..., None, None]], -1)
        R = V @ Ut

        # Population variance, as jnp.var.
        var_a = A.var(-2, correction=0).sum(-1)
        c = s.sum(-1) / var_a
        t = (-torch.einsum("...,...ij,...j->...i", c, R, mu_a[..., 0, :])
             + mu_b[..., 0, :])
    return c, R, t


def rigid_align(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Align A onto B with the optimal similarity transform.

    Args:
      A, B: [..., N, 3].

    Returns:
      [..., N, 3] transformed A.
    """
    c, R, t = similarity_transform(A, B)
    with full_f32():
        return (torch.einsum("...,...ij,...nj->...ni", c, R, A)
                + t[..., None, :])
