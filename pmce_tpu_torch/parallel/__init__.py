"""Data parallelism and FSDP: the process group, the mesh, host→device
prefetch. Port of ``pmce_tpu/parallel/``."""

from pmce_tpu_torch.parallel.distributed import (  # noqa: F401
    host_local_slice,
    initialize,
    local_rows,
    process_count,
    process_index,
)
from pmce_tpu_torch.parallel.mesh import (  # noqa: F401
    create_mesh,
    fsdp_units,
    replicate,
    shard_fsdp,
)
from pmce_tpu_torch.parallel.prefetch import prefetch_to_device  # noqa: F401
