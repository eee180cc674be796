"""Host→device batches, staying ahead of the step.

Port of ``pmce_tpu/parallel/prefetch.py``. :func:`to_device` is the wire
format of a batch: numpy arrays become tensors, and under the bf16 policy
the image features travel in bf16 (the model's first dense layer casts
them to bf16 anyway, so the compute is the same for half the bytes of the
batch's largest tensor; coordinates stay f32). :func:`prefetch_to_device`
keeps ``size`` batches in flight: on the card each is copied from pinned
host memory on a side stream, without the host waiting, while the current
step runs; on the CPU it is a pass-through.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Iterable, Iterator

import numpy as np
import torch


def to_device(batch: dict, device, bf16_features: bool = False,
              stream=None) -> dict:
    """A numpy batch as tensors on ``device``. On the card the copies are
    from pinned memory and do not block the host (a copy from pageable
    memory would wait for the card's queue), enqueued on ``stream`` when
    given."""
    device = torch.device(device)
    pinned = device.type == "cuda"
    out = {}
    with (torch.cuda.stream(stream) if stream is not None
          else contextlib.nullcontext()):
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if bf16_features and k == "img_feature":
                t = t.to(torch.bfloat16)
            if pinned:
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=pinned)
    return out


def prefetch_to_device(iterator: Iterable, size: int = 2, device="cuda",
                       bf16_features: bool = False) -> Iterator[dict]:
    """Yield the batches of ``iterator`` on ``device``, ``size`` ahead.

    On the card the copies run on a side stream; the consuming stream
    waits on an event recorded after each batch's copies, and each tensor
    is marked as used by the consuming stream (``record_stream``), so that
    the allocator does not hand its memory to the side stream's next copy
    while a step still reads it."""
    device = torch.device(device)
    it = iter(iterator)
    if device.type != "cuda":
        for batch in it:
            yield to_device(batch, device, bf16_features)
        return
    side = torch.cuda.Stream(device)
    queue = collections.deque()

    def put() -> None:
        batch = next(it, None)
        if batch is None:
            return
        out = to_device(batch, device, bf16_features, side)
        done = torch.cuda.Event()
        done.record(side)
        queue.append((out, done))

    for _ in range(size):
        put()
    while queue:
        out, done = queue.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for t in out.values():
            t.record_stream(consumer)
        put()
        yield out
