"""A perturbed initialisation of a port PMCE, shared by the parity tests
(through ``torch_port_common``) and ``chip_smoke.py``. Imports torch and
numpy only, so that ``chip_smoke.py`` can use it on a machine without jax.
"""

from __future__ import annotations

import numpy as np
import torch


@torch.no_grad()
def perturbed_init(model: torch.nn.Module, generator: torch.Generator):
    """Fill a port PMCE's parameters from ``generator`` so that no bias
    path hides behind a zero: products N(0, 1/fan_in), LayerNorm scales
    1 + N(0, 0.02²), biases and the lifter's pos-embeds N(0, 0.02²), the
    decoder's pos/Q/K embeds N(0, 1), the frame fusion U(±1/√T). (The
    port's own ``reset_parameters`` draws JAX's initial values, whose
    biases are zero.)"""
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        leaf = name.rsplit(".", 1)[-1]
        if name == "pose_lifter.fusion.weight":
            bound = shape[1] ** -0.5
            v = (torch.rand(shape, generator=generator) * 2 - 1) * bound
        elif leaf.endswith("_embed"):
            std = 1.0 if name.startswith("pose_mesh_coevo") else 0.02
            v = torch.randn(shape, generator=generator) * std
        elif p.ndim == 1 and leaf == "weight":         # LayerNorm scale
            v = 1.0 + torch.randn(shape, generator=generator) * 0.02
        elif p.ndim == 1:                              # biases
            v = torch.randn(shape, generator=generator) * 0.02
        else:                              # [out, in(, k)] products
            fan_in = int(np.prod(shape[1:]))
            v = torch.randn(shape, generator=generator) * fan_in ** -0.5
        p.copy_(v)
