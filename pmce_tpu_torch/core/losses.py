"""Training losses of the port (so far: the Stage-1 coordinate loss).

Port of ``pmce_tpu/core/losses.py`` ``coord_l1`` (the reference's
``lib/core/loss.py`` CoordLoss). The mesh losses come with PMCE training.
"""

from __future__ import annotations

import torch


def coord_l1(pred: torch.Tensor, target: torch.Tensor,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """Mean L1 with the reference's multiplicative validity masking: the
    mask multiplies both sides and the mean divides by every element, so
    masked joints dilute the loss rather than renormalise it."""
    if valid is not None:
        pred = pred * valid
        target = target * valid
    return (pred - target).abs().mean()
