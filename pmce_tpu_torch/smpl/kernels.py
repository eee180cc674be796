"""Linear blend skinning on the card (replaces the SMPL Pallas kernel).

Port of ``pmce_tpu/smpl/kernels.py`` ``fused_skinning``. The wrapper picks
by the device of its input: a CPU tensor runs the plain
:func:`~pmce_tpu_torch.smpl.layer.apply_skinning`; a CUDA tensor launches
the hand-written kernel of ``csrc/skinning.cu`` (full f32, one thread per
vertex, the blended [B, V, 12] transforms never written) or raises.
"""

from __future__ import annotations

import torch

from pmce_tpu_torch.ops import _cuda
from pmce_tpu_torch.smpl.layer import apply_skinning

SKINNING_LAUNCHES = _cuda.launch_counter("skinning")


def _skinning_cuda(v_posed, A_skin, lbs_weights) -> torch.Tensor:
    f32 = torch.float32
    B, V, _ = v_posed.shape
    J = A_skin.shape[1]
    if v_posed.dtype != f32 or A_skin.dtype != f32:
        raise NotImplementedError("the skinning kernel takes f32 inputs")
    v_posed, A_skin = v_posed.contiguous(), A_skin.contiguous()
    _cuda.check_cuda(v_posed, "v_posed", f32, (B, V, 3))
    _cuda.check_cuda(A_skin, "A_skin", f32, (B, J, 4, 4))
    dev = v_posed.device
    w = _cuda.to_kernel(lbs_weights, dev, f32, (V, J), "lbs_weights")
    out = torch.empty_like(v_posed)
    p = _cuda.ptr
    _cuda.SKIN.call("pmce_skinning", p(v_posed), p(A_skin), p(w), p(out),
                    B, V, J, _cuda.stream_ptr(dev))
    SKINNING_LAUNCHES.count += 1
    return out


def fused_skinning(v_posed: torch.Tensor, A_skin: torch.Tensor,
                   lbs_weights: torch.Tensor) -> torch.Tensor:
    """Skinned vertices [B, V, 3] from v_posed [B, V, 3], A_skin
    [B, J, 4, 4] (inverse-bind corrected) and lbs_weights [V, J]."""
    if v_posed.device.type == "cpu":
        return apply_skinning(v_posed, A_skin, lbs_weights)
    if v_posed.device.type != "cuda":
        raise ValueError(f"fused_skinning: unsupported device "
                         f"{v_posed.device}")
    return _skinning_cuda(v_posed, A_skin, lbs_weights)
