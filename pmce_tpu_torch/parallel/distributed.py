"""Process-group bootstrap and per-rank data sharding.

Port of ``pmce_tpu/parallel/distributed.py``:

- :func:`initialize` starts ``torch.distributed`` when this is a
  multi-process job: torchrun's environment (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or explicit arguments.
  With neither it is a no-op, and it touches no CUDA state;
- :func:`process_count` / :func:`process_index`: the world size and this
  rank (1 and 0 outside a process group);
- :func:`local_rows` is the counterpart of JAX's ``put_global_batch``:
  every rank draws the same global batch (from the same seeded
  ``MultiDataset``) and keeps rows ``[r·B/n, (r+1)·B/n)``;
- :func:`host_local_slice` is the range a rank loads when its pipeline
  reads disjoint shards. Such a rank passes the rows it loaded to the step
  as they are: under DDP and FSDP a rank's batch is its shard, and there
  is no global array to assemble (what JAX's ``shard_host_batch`` does).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               device: str = "cuda") -> bool:
    """Join the process group of a multi-process job; returns whether this
    process is in one (a second call returns True).

    ``init_method`` (``"tcp://host:port"``), ``world_size`` and ``rank``
    name the group explicitly; without them torchrun's variables must all
    be set, else this is a single-process run and nothing happens. On
    ``device="cuda"`` the backend is NCCL and the card is ``LOCAL_RANK``'s
    (the rank without it); on ``"cpu"`` it is gloo. A failed join
    raises."""
    if dist.is_initialized():
        return True
    explicit = (init_method, world_size, rank) != (None, None, None)
    if not explicit and not all(k in os.environ for k in _ENV):
        return False
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(device='cuda'): no CUDA card; "
                               "pass device='cpu' for a gloo group")
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def host_local_slice(global_len: int) -> slice:
    """The contiguous index range this rank loads. The remainder
    ``global_len % process_count`` goes to the first ranks (rank i gets
    one more row while i < remainder), so every row belongs to exactly one
    rank: a floor split would drop the tail rows from training and
    evaluation."""
    n, i = process_count(), process_index()
    per, rem = divmod(global_len, n)
    start = i * per + min(i, rem)
    return slice(start, start + per + (1 if i < rem else 0))


def local_rows(batch: dict) -> dict:
    """This rank's rows ``[r·B/n, (r+1)·B/n)`` of a global batch (a dict
    of arrays or tensors with the batch first); the whole batch in one
    process. The batch must divide by the world size."""
    n, i = process_count(), process_index()
    if n == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not "
                             f"divide over {n} ranks")
        per = v.shape[0] // n
        out[k] = v[i * per:(i + 1) * per]
    return out
