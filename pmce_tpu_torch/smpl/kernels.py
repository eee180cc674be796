"""Linear blend skinning on the card (replaces the SMPL Pallas kernel).

Port of ``pmce_tpu/smpl/kernels.py`` ``fused_skinning``. The wrapper picks
by the device of its input: a CPU tensor runs the plain
:func:`~pmce_tpu_torch.smpl.layer.apply_skinning`; a CUDA tensor launches
the hand-written kernel of ``csrc/skinning.cu`` (full f32, 4 vertices a
thread and a chunk of bodies a block by :func:`skinning_plan`, the blended
[B, V, 12] transforms never written) or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pmce_tpu_torch.ops import _cuda
from pmce_tpu_torch.smpl.layer import apply_skinning

SKINNING_LAUNCHES = _cuda.launch_counter("skinning")

# The kernel's block: 512 vertices (128 threads of 4); at most 32 joints
# and 16 bodies a block; the blocks an SM it is planned to hold.
SKIN_TILE = 512
SKIN_MAX_JOINTS, SKIN_MAX_BODIES, SKIN_BLOCKS_PER_SM = 32, 16, 3


class SkinPlan(NamedTuple):
    """The kernel's launch: ``grid`` (vertex tiles, body chunks) of
    ``bodies`` bodies a block (the last chunk may hold fewer), ``smem``
    bytes of shared memory a block."""

    grid: tuple[int, int]
    bodies: int
    smem: int


def skinning_plan(B: int, V: int, J: int, sm_count: int) -> SkinPlan:
    """Cut B bodies of V vertices into tiles of 512 vertices by chunks of
    bodies so that about three blocks an SM cover the card in one wave
    (each block stages its tile's weights once for all its bodies): at
    B = 256, V = 6890 on 132 SMs, 14 tiles by 26 chunks of 10 bodies."""
    if not 0 < J <= SKIN_MAX_JOINTS or B <= 0 or V <= 0:
        raise ValueError(f"skinning: B={B}, V={V}, J={J} outside the "
                         f"kernel's range (J <= {SKIN_MAX_JOINTS})")
    tiles = -(-V // SKIN_TILE)
    chunks = max(1, min(B, SKIN_BLOCKS_PER_SM * sm_count // tiles))
    bodies = min(SKIN_MAX_BODIES, -(-B // chunks))
    smem = (J * SKIN_TILE + bodies * J * 12) * 4
    return SkinPlan((tiles, -(-B // bodies)), bodies, smem)


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    plan = skinning_plan(B, V, J, _sm_count(dev))
    p = _cuda.ptr
    _cuda.SKIN.call("pmce_skinning", p(v_posed), p(A_skin), p(w), p(out),
                    B, V, J, plan.bodies, _cuda.stream_ptr(dev))
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
