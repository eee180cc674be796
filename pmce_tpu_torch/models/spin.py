"""ResNet-50 image encoder + iterative SMPL regressor (SPIN/HMR family).

Port of ``pmce_tpu/models/spin.py`` (the reference's lib/models/spin.py:
a Bottleneck ResNet-50 trunk whose global-average-pooled 2048-d feature
feeds PMCE as the per-frame image feature, and a 3-iteration SMPL
parameter regressor on it, as in the SPIN checkpoint the reference demo
loads).

Parameters carry torchvision's and SPIN's state_dict names (``conv1``,
``bn1``, ``layer{s}.{b}.conv1`` ..., ``downsample.0/1``; the regressor's
``fc1``, ``fc2``, ``decpose``, ``decshape``, ``deccam`` beside the trunk's
layers, as in SPIN's ``HMR``), so a SPIN ``checkpoint['model']`` loads
with ``load_state_dict``. Inference only: BatchNorm uses its running
statistics and the regressor's dropout is off.

``dtype`` is the compute dtype (None = f32; ``torch.bfloat16`` as flax's
``dtype=bf16``): the convolutions run on operands cast to it; BatchNorm
computes in f32 from its f32 statistics and rounds its output to it, as
flax does; the global average pool accumulates and returns f32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from pmce_tpu_torch.models.layers import init_like_jax
from pmce_tpu_torch.ops.geometry import rot6d_to_rotmat

# Neutral regressor start: identity 6d rotations, zero shape, unit cam.
_IDENT_6D = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)


def conv(x, layer: nn.Conv2d, dt):
    """``layer`` on x with operands in ``dt`` (f32 if None)."""
    if dt is None:
        return layer(x)
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.conv2d(x.to(dt), layer.weight.to(dt), bias, layer.stride,
                    layer.padding)


def batch_norm(x, bn: nn.BatchNorm2d, dt):
    """Inference BatchNorm in flax's order, ``(x − mean) · (rsqrt(var +
    eps) · scale) + bias``, in f32, rounded to ``dt``."""
    shape = (1, -1, 1, 1)
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    y = ((x.float() - bn.running_mean.view(shape)) * mul.view(shape)
         + bn.bias.view(shape))
    return y if dt is None else y.to(dt)


class Bottleneck(nn.Module):
    """torchvision bottleneck: 1×1 → 3×3 (stride) → 1×1 (×4), residual."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
            nn.BatchNorm2d(planes * 4)) if downsample else None)

    def forward(self, x, dt=None):
        out = F.relu(batch_norm(conv(x, self.conv1, dt), self.bn1, dt))
        out = F.relu(batch_norm(conv(out, self.conv2, dt), self.bn2, dt))
        out = batch_norm(conv(out, self.conv3, dt), self.bn3, dt)
        residual = x
        if self.downsample is not None:
            residual = batch_norm(conv(x, self.downsample[0], dt),
                                  self.downsample[1], dt)
        return F.relu(out + residual)


class ResNet50(nn.Module):
    """Bottleneck ResNet-50 trunk → 2048-d GAP feature.

    ``width`` scales all stages (64 = the real ResNet-50; tests shrink it).
    """

    def __init__(self, layers: tuple = (3, 4, 6, 3), width: int = 64,
                 dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, width, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        inplanes = width
        for stage, n_blocks in enumerate(layers):
            planes = width * 2 ** stage
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                blocks.append(Bottleneck(inplanes, planes, stride,
                                         downsample=(b == 0)))
                inplanes = planes * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_stages = len(layers)
        self.feat_dim = inplanes

    def forward(self, x):
        """x: [N, 3, H, W] normalized crops → [N, width·32] f32 features."""
        dt = self.dtype
        x = F.relu(batch_norm(conv(x, self.conv1, dt), self.bn1, dt))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in range(self.num_stages):
            for block in getattr(self, f"layer{stage + 1}"):
                x = block(x, dt)
        return x.float().mean((2, 3))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initial values, drawn from ``generator``: convolutions
        lecun-normal, BatchNorm scale 1 and bias 0, statistics 0 and 1."""
        for name, p in self.named_parameters():
            init_like_jax(p, name, generator)
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()


def _add_regressor(module: nn.Module, feat_dim: int, hidden: int) -> None:
    """The regressor's layers, under SPIN's names, on ``module``."""
    module.fc1 = nn.Linear(feat_dim + 24 * 6 + 10 + 3, hidden)
    module.fc2 = nn.Linear(hidden, hidden)
    module.decpose = nn.Linear(hidden, 24 * 6)
    module.decshape = nn.Linear(hidden, 10)
    module.deccam = nn.Linear(hidden, 3)


def _regress(module: nn.Module, feat: torch.Tensor, n_iter: int,
             init_pose=None, init_shape=None, init_cam=None) -> dict:
    """``n_iter`` refinement steps of (pose 6d, shape, cam) from ``feat``."""
    B = feat.shape[0]
    kw = {"dtype": feat.dtype, "device": feat.device}
    pose = (init_pose if init_pose is not None
            else torch.tensor(_IDENT_6D, **kw).repeat(B, 24))
    shape = init_shape if init_shape is not None else feat.new_zeros(B, 10)
    cam = (init_cam if init_cam is not None
           else torch.tensor([[0.9, 0.0, 0.0]], **kw).repeat(B, 1))
    for _ in range(n_iter):
        xc = torch.cat([feat, pose, shape, cam], 1)
        xc = module.fc2(module.fc1(xc))
        pose = module.decpose(xc) + pose
        shape = module.decshape(xc) + shape
        cam = module.deccam(xc) + cam
    rotmat = rot6d_to_rotmat(pose.reshape(B * 24, 6)).reshape(B, 24, 3, 3)
    return {"rotmat": rotmat, "shape": shape, "cam": cam, "pose6d": pose}


class SMPLRegressor(nn.Module):
    """Iterative (3-step) SMPL parameter regressor on a 2048-d feature."""

    def __init__(self, feat_dim: int = 2048, hidden: int = 1024,
                 n_iter: int = 3):
        super().__init__()
        self.n_iter = n_iter
        _add_regressor(self, feat_dim, hidden)

    def forward(self, feat, init_pose=None, init_shape=None, init_cam=None):
        return _regress(self, feat, self.n_iter, init_pose, init_shape,
                        init_cam)


class HMR(ResNet50):
    """Full HMR: the ResNet-50 trunk and the iterative regressor, with the
    regressor's layers beside the trunk's (SPIN's state_dict layout)."""

    def __init__(self, layers: tuple = (3, 4, 6, 3), width: int = 64,
                 hidden: int = 1024, n_iter: int = 3, dtype=None):
        super().__init__(layers, width, dtype)
        self.n_iter = n_iter
        _add_regressor(self, self.feat_dim, hidden)

    def forward(self, x, return_features: bool = False):
        feat = super().forward(x)
        out = _regress(self, feat, self.n_iter)
        return (feat, out) if return_features else out


def feature_extractor_apply(model: ResNet50, images) -> torch.Tensor:
    """2048-d features of normalized crops, without autograd (reference
    spin.py:129-143)."""
    with torch.no_grad():
        return model(images)
