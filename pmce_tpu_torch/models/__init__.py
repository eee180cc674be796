"""PyTorch model zoo of the port: pose lifter, co-evolution decoder, PMCE."""

from pmce_tpu_torch.models.pose_lifter import PoseLifter  # noqa: F401
from pmce_tpu_torch.models.coevo import (  # noqa: F401
    CoevoBlock,
    CoevolutionDecoder,
)
from pmce_tpu_torch.models.pmce import PMCE, create_pmce  # noqa: F401
