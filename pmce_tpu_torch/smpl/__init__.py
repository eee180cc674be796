"""SMPL assets of the port: artifacts and mesh coarsening (numpy / torch)."""

from pmce_tpu_torch.smpl.artifacts import (  # noqa: F401
    SMPLArtifacts,
    ensure_cached_artifacts,
    synthetic_artifacts,
)
from pmce_tpu_torch.smpl.mesh import (  # noqa: F401
    MeshCoarsening,
    ensure_cached_coarsening,
    synthetic_coarsening,
)
