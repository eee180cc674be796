"""Mesh coarsening (6890 → 1723 → 431) as dense matrices.

Port of ``pmce_tpu/smpl/mesh.py``. The operators are densified once at load
time; ``synthetic_coarsening`` makes the JAX package's numpy random calls in
the same order (bit-identical operators for a seed), and both packages read
and write the same ``data/base_data/mesh_coarsening.npz`` cache.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

LEVEL_SIZES = (6890, 1723, 431)


@dataclasses.dataclass(frozen=True)
class MeshCoarsening:
    """Dense down/up-sampling operators between mesh resolution levels."""

    D: tuple[np.ndarray, ...]  # D[i]: [sizes[i+1], sizes[i]]
    U: tuple[np.ndarray, ...]  # U[i]: [sizes[i], sizes[i+1]]

    @property
    def sizes(self) -> tuple[int, ...]:
        return (self.D[0].shape[1],) + tuple(d.shape[0] for d in self.D)

    def validate(self) -> None:
        for i, d in enumerate(self.D):
            if (d.shape != (self.sizes[i + 1], self.sizes[i])
                    or self.U[i].shape != (self.sizes[i], self.sizes[i + 1])):
                raise ValueError(f"coarsening level {i}: D {d.shape}, "
                                 f"U {self.U[i].shape}")

    def save(self, path: str) -> None:
        payload = {}
        for i, d in enumerate(self.D):
            payload[f"D{i}"] = d
            payload[f"U{i}"] = self.U[i]
        np.savez_compressed(path, **payload)

    @classmethod
    def load(cls, path: str) -> "MeshCoarsening":
        with np.load(path) as z:
            n = sum(1 for k in z.files if k.startswith("D"))
            D = tuple(z[f"D{i}"].astype(np.float32) for i in range(n))
            U = tuple(z[f"U{i}"].astype(np.float32) for i in range(n))
        mesh = cls(D=D, U=U)
        mesh.validate()
        return mesh


def synthetic_coarsening(seed: int = 0,
                         sizes: tuple[int, ...] = LEVEL_SIZES) -> MeshCoarsening:
    """Deterministic stand-in coarsening operators.

    D[i] partitions fine vertices into coarse groups and averages them
    (row-stochastic); U[i] interpolates each fine vertex from one or two
    coarse vertices (row-stochastic) — the structure of the real COMA-style
    sampling matrices.
    """
    rng = np.random.default_rng(seed + 1000)
    D, U = [], []
    for lvl in range(len(sizes) - 1):
        n_fine, n_coarse = sizes[lvl], sizes[lvl + 1]
        owner = np.arange(n_fine) % n_coarse
        owner = rng.permutation(owner)

        d = np.zeros((n_coarse, n_fine), dtype=np.float64)
        for c in range(n_coarse):
            idx = np.nonzero(owner == c)[0]
            d[c, idx] = 1.0 / len(idx)

        u = np.zeros((n_fine, n_coarse), dtype=np.float64)
        w = 0.6 + 0.4 * rng.random(n_fine)
        second = rng.integers(0, n_coarse, size=n_fine)
        u[np.arange(n_fine), owner] = w
        u[np.arange(n_fine), second] += 1.0 - w
        u /= u.sum(axis=1, keepdims=True)

        D.append(d.astype(np.float32))
        U.append(u.astype(np.float32))
    mesh = MeshCoarsening(D=tuple(D), U=tuple(U))
    mesh.validate()
    return mesh


def default_coarsening_path() -> str:
    base = os.environ.get(
        "PMCE_TPU_DATA_DIR",
        os.path.join(os.path.dirname(__file__), "..", "..", "data", "base_data"),
    )
    return os.path.join(base, "mesh_coarsening.npz")


def load_or_synthetic(seed: int = 0) -> MeshCoarsening:
    """Load the cached operators, or generate the stand-in without caching
    it."""
    path = default_coarsening_path()
    if os.path.isfile(path):
        return MeshCoarsening.load(path)
    return synthetic_coarsening(seed=seed)


def ensure_cached_coarsening(seed: int = 0) -> MeshCoarsening:
    """Load the cached operators, or generate the stand-in and cache it."""
    path = default_coarsening_path()
    if os.path.isfile(path):
        return MeshCoarsening.load(path)
    m = synthetic_coarsening(seed=seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    m.save(path)
    return m


def downsample(mesh: MeshCoarsening, x, n1: int = 0, n2: int = 1):
    """Downsample vertices [..., sizes[n1], 3] to [..., sizes[n2], 3].

    ``x`` is a numpy array or a torch tensor; the contraction is an f32 sum
    either way (the JAX package pins HIGHEST precision for the same
    reason: these are meter-scale coordinates)."""
    for i in range(n1, n2):
        if isinstance(x, np.ndarray):
            x = (mesh.D[i] @ x).astype(x.dtype)
        else:
            x = torch.as_tensor(mesh.D[i], device=x.device, dtype=x.dtype) @ x
    return x


def upsample(mesh: MeshCoarsening, x, n1: int = 1, n2: int = 0):
    """Upsample vertices [..., sizes[n1], 3] back to [..., sizes[n2], 3]
    (n2 < n1), an f32 sum as :func:`downsample`."""
    for i in reversed(range(n2, n1)):
        if isinstance(x, np.ndarray):
            x = (mesh.U[i] @ x).astype(x.dtype)
        else:
            x = torch.as_tensor(mesh.U[i], device=x.device, dtype=x.dtype) @ x
    return x


def nearest_joint_per_vertex(joints: np.ndarray,
                             vertices: np.ndarray) -> np.ndarray:
    """Index of the nearest joint for every vertex ([V] int32)."""
    d2 = ((vertices[:, None, :] - joints[None, :, :]) ** 2).sum(-1)
    return np.argmin(d2, axis=1).astype(np.int32)
