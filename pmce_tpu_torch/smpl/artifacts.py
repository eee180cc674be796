"""SMPL model artifacts: schema, npz loading and the synthetic stand-in.

Port of ``pmce_tpu/smpl/artifacts.py`` (numpy only). ``synthetic_artifacts``
makes the same numpy random calls in the same order, so it gives arrays
bit-identical to the JAX package's for the same seed, and both packages read
and write the same ``data/base_data/smpl_neutral.npz`` cache.

The real MPI artifacts are converted offline by ``tools/convert_smpl_pkl.py``;
when they are absent the deterministic stand-in has the exact tensor shapes
and invariants of the real model (normalized skinning weights, a joint
regressor consistent with the rest joints, the real SMPL kinematic tree).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

NUM_VERTS = 6890
NUM_JOINTS = 24
NUM_BETAS = 10
NUM_POSE_BASIS = 207  # 23 joints × 9 rotmat entries
NUM_FACES = 13776

# The SMPL kinematic tree (public model topology). Root's parent is itself.
KINTREE_PARENTS = np.array(
    [0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18,
     19, 20, 21],
    dtype=np.int32,
)

# Approximate rest-pose joint centers (meters, y-up) used only to synthesize
# a plausible stand-in body when real artifacts are absent.
_REST_JOINTS = np.array(
    [
        [0.00, -0.20, 0.00], [0.07, -0.30, 0.00], [-0.07, -0.30, 0.00],
        [0.00, -0.08, 0.00], [0.10, -0.70, 0.00], [-0.10, -0.70, 0.00],
        [0.00, 0.03, 0.00], [0.09, -1.10, -0.03], [-0.09, -1.10, -0.03],
        [0.00, 0.10, 0.00], [0.11, -1.15, 0.10], [-0.11, -1.15, 0.10],
        [0.00, 0.28, 0.00], [0.05, 0.20, 0.00], [-0.05, 0.20, 0.00],
        [0.00, 0.42, 0.03], [0.17, 0.23, 0.00], [-0.17, 0.23, 0.00],
        [0.43, 0.22, 0.00], [-0.43, 0.22, 0.00], [0.68, 0.21, 0.00],
        [-0.68, 0.21, 0.00], [0.76, 0.20, 0.00], [-0.76, 0.20, 0.00],
    ],
    dtype=np.float64,
)


@dataclasses.dataclass(frozen=True)
class SMPLArtifacts:
    """Numerical payload of one SMPL body model (one gender).

    Shapes mirror the MPI model: 6890 vertices, 24 joints, 10 shape betas,
    207 pose-blendshape basis vectors, 13776 triangular faces.
    """

    v_template: np.ndarray      # [V, 3] float32, rest-pose vertices (meters)
    shapedirs: np.ndarray       # [V, 3, 10] float32, shape blendshape basis
    posedirs: np.ndarray        # [V, 3, 207] float32, pose blendshape basis
    J_regressor: np.ndarray     # [24, V] float32, vertices → joints
    lbs_weights: np.ndarray     # [V, 24] float32, skinning weights (rows sum 1)
    kintree_parents: np.ndarray  # [24] int32, parent joint index (root = 0)
    faces: np.ndarray           # [F, 3] int32 triangle indices

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_joints(self) -> int:
        return self.J_regressor.shape[0]

    def validate(self) -> None:
        V, J = self.num_verts, self.num_joints
        assert self.v_template.shape == (V, 3)
        assert self.shapedirs.shape[:2] == (V, 3)
        assert self.posedirs.shape[:2] == (V, 3)
        assert self.posedirs.shape[2] == 9 * (J - 1)
        assert self.J_regressor.shape == (J, V)
        assert self.lbs_weights.shape == (V, J)
        assert self.kintree_parents.shape == (J,)
        np.testing.assert_allclose(
            self.lbs_weights.sum(axis=1), 1.0, atol=1e-4
        )

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            v_template=self.v_template,
            shapedirs=self.shapedirs,
            posedirs=self.posedirs,
            J_regressor=self.J_regressor,
            lbs_weights=self.lbs_weights,
            kintree_parents=self.kintree_parents,
            faces=self.faces,
        )

    @classmethod
    def load(cls, path: str) -> "SMPLArtifacts":
        with np.load(path) as z:
            art = cls(
                v_template=z["v_template"].astype(np.float32),
                shapedirs=z["shapedirs"].astype(np.float32),
                posedirs=z["posedirs"].astype(np.float32),
                J_regressor=z["J_regressor"].astype(np.float32),
                lbs_weights=z["lbs_weights"].astype(np.float32),
                kintree_parents=z["kintree_parents"].astype(np.int32),
                faces=z["faces"].astype(np.int32),
            )
        art.validate()
        return art


def kintree_levels(parents: np.ndarray) -> list[np.ndarray]:
    """Group joints by depth in the kinematic tree.

    Level 0 is the root; every joint's parent lies in an earlier level, so
    the global transforms compose level by level with the reference's
    parent-before-child order (``smpl_layer.py:109-119``)."""
    depth = np.zeros(len(parents), dtype=np.int64)
    for i in range(1, len(parents)):
        depth[i] = depth[parents[i]] + 1
    return [np.nonzero(depth == d)[0].astype(np.int32)
            for d in range(int(depth.max()) + 1)]


def synthetic_artifacts(seed: int = 0, num_verts: int = NUM_VERTS,
                        num_faces: int = NUM_FACES) -> SMPLArtifacts:
    """Deterministic stand-in SMPL model with real shapes and invariants.

    Vertices are scattered around their owning joint; the joint regressor
    averages each joint's own vertices (so J_regressor @ v_template lands on
    sensible joint centers); skinning weights blend each vertex's joint with
    its parent.
    """
    rng = np.random.default_rng(seed)
    J = NUM_JOINTS

    # Assign vertices to joints round-robin so every joint owns ~V/J verts.
    owner = np.arange(num_verts, dtype=np.int64) % J
    owner = rng.permutation(owner)

    v_template = (
        _REST_JOINTS[owner]
        + rng.normal(scale=0.06, size=(num_verts, 3))
    )

    J_regressor = np.zeros((J, num_verts), dtype=np.float64)
    for j in range(J):
        idx = np.nonzero(owner == j)[0]
        J_regressor[j, idx] = 1.0 / len(idx)

    w_own = 0.75 + 0.2 * rng.random(num_verts)
    lbs_weights = np.zeros((num_verts, J), dtype=np.float64)
    lbs_weights[np.arange(num_verts), owner] = w_own
    lbs_weights[np.arange(num_verts), KINTREE_PARENTS[owner]] += 1.0 - w_own
    lbs_weights /= lbs_weights.sum(axis=1, keepdims=True)

    shapedirs = rng.normal(scale=0.01, size=(num_verts, 3, NUM_BETAS))
    posedirs = rng.normal(scale=0.001, size=(num_verts, 3, NUM_POSE_BASIS))

    # Faces: random triangles among vertices of the same joint so edge /
    # normal losses and the rasterizer act on local geometry.
    faces = np.zeros((num_faces, 3), dtype=np.int32)
    per_joint = [np.nonzero(owner == j)[0] for j in range(J)]
    for f in range(num_faces):
        verts = per_joint[f % J]
        faces[f] = rng.choice(verts, size=3, replace=False)

    art = SMPLArtifacts(
        v_template=v_template.astype(np.float32),
        shapedirs=shapedirs.astype(np.float32),
        posedirs=posedirs.astype(np.float32),
        J_regressor=J_regressor.astype(np.float32),
        lbs_weights=lbs_weights.astype(np.float32),
        kintree_parents=KINTREE_PARENTS.copy(),
        faces=faces,
    )
    art.validate()
    return art


def default_artifact_path(gender: str = "neutral") -> str:
    """Location of converted real artifacts inside the repo data dir."""
    base = os.environ.get(
        "PMCE_TPU_DATA_DIR",
        os.path.join(os.path.dirname(__file__), "..", "..", "data", "base_data"),
    )
    return os.path.join(base, f"smpl_{gender}.npz")


def ensure_cached_artifacts(gender: str = "neutral", seed: int = 0
                            ) -> "SMPLArtifacts":
    """Load converted-real or cached-synthetic artifacts; generate and cache
    the synthetic stand-in on first use, so every later run (of either
    package) reads the same file."""
    path = default_artifact_path(gender)
    if os.path.isfile(path):
        return SMPLArtifacts.load(path)
    art = synthetic_artifacts(seed=seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    art.save(path)
    return art


def load_or_synthetic(gender: str = "neutral", seed: int = 0
                      ) -> SMPLArtifacts:
    """Load converted real artifacts if present, else the synthetic stand-in
    at seed + {neutral 0, female 1, male 2} (so that gendered paths are
    distinguishable), writing no cache."""
    path = default_artifact_path(gender)
    if os.path.isfile(path):
        return SMPLArtifacts.load(path)
    gender_seed = {"neutral": 0, "female": 1, "male": 2}.get(gender, 0)
    return synthetic_artifacts(seed=seed + gender_seed)
