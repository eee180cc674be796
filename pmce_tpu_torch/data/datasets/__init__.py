"""Dataset families: Human3.6M, 3DPW, MPI-INF-3DHP, COCO, MPII."""

from pmce_tpu_torch.data.datasets.base import VideoMeshDataset  # noqa: F401
from pmce_tpu_torch.data.datasets.h36m import Human36M  # noqa: F401
from pmce_tpu_torch.data.datasets.pw3d import PW3D  # noqa: F401
from pmce_tpu_torch.data.datasets.mpii3d import MPII3D  # noqa: F401
from pmce_tpu_torch.data.datasets.coco import MSCOCO  # noqa: F401
from pmce_tpu_torch.data.datasets.mpii import MPII  # noqa: F401
