"""Fixed-order segment sums: the gradients of row gathers, the same bits on
every run.

A gather's gradient sums, for each source row, the cotangents of the rows
copied from it. PyTorch's ``index_add_`` and ``index_put_(accumulate=True)``
do that with atomic adds on the card, in an order that changes from run to
run. Here each segment's members are listed once, in ascending order, in a
table padded to the longest segment with an index that points at a zero
row; the sum over the table's fixed axis is the same on every run (the
JAX package's sorted ``segment_sum`` fixes its order the same way).
"""

from __future__ import annotations

import numpy as np
import torch


def segment_table(ids, num_segments: int) -> torch.Tensor:
    """[num_segments, K] int64: row s lists, ascending, every position i
    with ``ids[i] == s``, padded with ``len(ids)`` (K: the largest
    segment, at least 1)."""
    ids = np.asarray(ids, dtype=np.int64).reshape(-1)
    if ids.size and (ids.min() < 0 or ids.max() >= num_segments):
        raise ValueError(f"segment ids outside [0, {num_segments})")
    counts = np.bincount(ids, minlength=num_segments)
    order = np.argsort(ids, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(ids.size) - starts[ids[order]]
    table = np.full((num_segments, max(1, int(counts.max(initial=0)))),
                    ids.size, dtype=np.int64)
    table[ids[order], rank] = order
    return torch.from_numpy(table)


def segment_sum(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[B, N, ...] → [B, S, ...]: out[:, s] = Σ_k x[:, table[s, k]], with
    the padding index N reading a zero row."""
    pad = torch.zeros_like(x[:, :1])
    return torch.cat([x, pad], dim=1)[:, table].sum(2)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, index, table):
        ctx.save_for_backward(table)
        return x[:, index]

    @staticmethod
    def backward(ctx, g):
        (table,) = ctx.saved_tensors
        return segment_sum(g, table), None, None


def gather_rows(x: torch.Tensor, index: torch.Tensor,
                table: torch.Tensor) -> torch.Tensor:
    """``x[:, index]`` ([B, N, ...] → [B, len(index), ...]) whose gradient
    is :func:`segment_sum` over ``table = segment_table(index, N)``."""
    return _GatherRows.apply(x, index, table)
