"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``gpu`` marker and skips where
``torch.cuda.is_available()`` is false (this file imports no jax, so it
runs on the GPU machine, which has none):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py

(``--noconftest``: tests/conftest.py sets up jax for the JAX package's
tests.) Shapes are small but within what each kernel takes (trunk and
block C=256, GRU H a multiple of 64, chain C=64 with 2 and 8 heads,
skinning at 6890 vertices); ``chip_smoke.py`` holds the same kernels at
the full serving and training shapes. Bounds are
max|kernel - plain| / max|plain|, as in chip_smoke.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pmce_tpu_torch.ops import _cuda
from pmce_tpu_torch.ops import fused_attention as fa
from pmce_tpu_torch.ops import fused_coevo_chain as fc

pytestmark = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda", 0)


def _rand(rng, dev, *shape, scale=1.0, offset=0.0, dtype=torch.float32):
    a = rng.normal(size=shape) * scale + offset
    return torch.from_numpy(a.astype(np.float32)).to(device=dev, dtype=dtype)


def _rel(want, got) -> float:
    want, got = want.detach().float().cpu(), got.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max())


def test_trunk_kernel_matches_plain():
    dev = _card()
    rng = np.random.default_rng(0)
    B, T, J, C, hid, depth = 3, 16, 19, 256, 512, 2

    def r(*s, **k):
        return _rand(rng, dev, *s, **k)

    params = tuple(
        (r(C, scale=0.1, offset=1.0), r(C, scale=0.1),
         r(C, 3 * C, scale=C ** -0.5), r(3 * C, scale=0.02),
         r(C, C, scale=C ** -0.5), r(C, scale=0.02),
         r(C, scale=0.1, offset=1.0), r(C, scale=0.1),
         r(C, hid, scale=C ** -0.5), r(hid, scale=0.02),
         r(hid, C, scale=hid ** -0.5), r(C, scale=0.02))
        for _ in range(2 * depth))
    args = (r(B, T * J, C, dtype=torch.bfloat16), params,
            (r(C, scale=0.1, offset=1.0), r(C, scale=0.1)),
            (r(C, scale=0.1, offset=1.0), r(C, scale=0.1)),
            r(T, C, scale=0.1), T, J, depth, 8)
    _cuda.reset_launch_counts()
    got = fa.lifter_trunk(*args)
    assert _cuda.launch_counts()["lifter_trunk"] == 1
    assert got.dtype == torch.bfloat16 and got.shape == (B, T * J, C)
    assert _rel(fa.lifter_trunk_plain(*args), got) < 0.03


@pytest.mark.parametrize("B", [8, 13])
def test_gru_kernels_match_plain(B):
    """Includes a batch that is not a multiple of the 16-row tile."""
    dev = _card()
    rng = np.random.default_rng(B)
    H, steps = 64, 9
    args = (_rand(rng, dev, steps, B, 3 * H, dtype=torch.bfloat16),
            _rand(rng, dev, H, 3 * H, scale=0.2),
            _rand(rng, dev, 3 * H, scale=0.2))
    for kern, rev in ((fa.gru_layer, False), (fa.gru_layer_rev, True)):
        got = kern(*args)
        assert got.dtype == torch.bfloat16 and got.shape == (steps, B, H)
        assert _rel(fa.gru_layer_plain(*args, reverse=rev), got) < 0.01


def test_chain_kernel_matches_plain():
    dev = _card()
    rng = np.random.default_rng(1)
    B, J, V, C, NB = 5, 19, 61, 64, 2
    bf = torch.bfloat16

    def t(*s, scale=0.05, dtype=torch.float32):
        return _rand(rng, dev, *s, scale=scale, dtype=dtype)

    def ca():
        return (t(C, C), t(C), t(C, C), t(C), t(C, C), t(C), t(C, C), t(C),
                t(C, 4 * C), t(4 * C), t(4 * C, C), t(C))

    def sa():
        return (t(C, 3 * C), t(3 * C), t(C, C), t(C), t(C, 4 * C), t(4 * C),
                t(4 * C, C), t(C))

    blocks = tuple(
        (t(3, C, dtype=bf), t(C), t(3, C, dtype=bf), t(C),
         (t(J, C), t(V, C), t(J, C), t(V, C), t(V, C), t(J, C),
          t(C, C), t(C), t(C, C), t(C), ca(), ca(), sa(), sa()),
         t(C, 3), t(3), t(C, 3), t(3))
        for _ in range(NB))
    args = (t(B, J, 3, scale=0.3), t(B, V, 3, scale=0.3),
            t(B, NB, 12, C, scale=0.1), t(B, NB, 12, C, scale=0.1), blocks)
    got = fc.coevo_chain(*args, 8, 2)
    want = fc.coevo_chain_plain(*args, 8, 2)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert _rel(b, a) < 0.02


def test_chain_kernel_refuses_f32_on_card():
    dev = _card()
    joints = torch.zeros(1, 19, 3, device=dev)
    f32_blocks = ((torch.zeros(3, 64, device=dev),),)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fc.coevo_chain(joints, torch.zeros(1, 61, 3, device=dev), None, None,
                       f32_blocks)


def _block_params(rng, dev, post: bool, C=256, hid=512):
    def r(*s, **k):
        return _rand(rng, dev, *s, **k).requires_grad_(True)

    params = [r(C, scale=0.1, offset=1.0), r(C, scale=0.1),
              r(C, 3 * C, scale=C ** -0.5), r(3 * C, scale=0.02),
              r(C, C, scale=C ** -0.5), r(C, scale=0.02),
              r(C, scale=0.1, offset=1.0), r(C, scale=0.1),
              r(C, hid, scale=C ** -0.5), r(hid, scale=0.02),
              r(hid, C, scale=hid ** -0.5), r(C, scale=0.02)]
    params += ([r(C, scale=0.1, offset=1.0), r(C, scale=0.1)] if post
               else [None, None])
    return params


@pytest.mark.parametrize("N,post,masks", [(16, True, False), (17, True, True),
                                          (17, False, True)])
def test_block_kernels_match_plain(N, post, masks):
    """Forward and backward (dx, the 14 parameter gradients, the per-clip
    mask gradients) of the block kernels against the plain version's
    autograd; measured on an H100 within 0.006 of each output's largest
    magnitude (chip_smoke.py holds them at the training shapes). Two runs
    give the same gradients bit for bit."""
    dev = _card()
    rng = np.random.default_rng(N + post)
    B = 37
    params = _block_params(rng, dev, post)
    x = _rand(rng, dev, B, N, 256, dtype=torch.bfloat16).requires_grad_(True)
    bm = None
    if masks:
        u = rng.random((2, B, 1, 1))
        u[0, 0] = u[1, 1] = 1.0
        bm = tuple(torch.from_numpy(((u[i] < 0.8) / 0.8).astype(np.float32))
                   .to(dev).requires_grad_(True) for i in range(2))
    g = _rand(rng, dev, B, N, 256, dtype=torch.bfloat16)
    leaves = [x] + [p for p in params if p is not None] + list(bm or ())
    outs = []
    for fn in (fa.transformer_block, fa.transformer_block,
               fa.transformer_block_plain):
        _cuda.reset_launch_counts()
        y = fn(x, tuple(params), 8, 1e-6, 1e-6, bm)
        outs.append((y, torch.autograd.grad(y, leaves, g)))
        counts = _cuda.launch_counts()
        kernel = fn is fa.transformer_block
        assert counts["block_fwd"] == counts["block_bwd"] == int(kernel)
    (yk, gk), (_, gk2), (yp, gp) = outs
    assert yk.dtype == torch.bfloat16 and yk.shape == x.shape
    assert _rel(yp, yk) < 0.02
    for a, a2, b in zip(gk, gk2, gp):
        assert torch.equal(a, a2)
        assert _rel(b, a) < 0.02


def test_block_kernel_refuses_f32_on_card():
    dev = _card()
    params = _block_params(np.random.default_rng(0), dev, True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fa.transformer_block(torch.zeros(2, 16, 256, device=dev),
                             tuple(params), 8)


@pytest.mark.parametrize("B", [1, 9])
def test_skinning_kernel_matches_plain(B):
    """Full f32 on both sides: within 1e-6 m (measured 2.4e-7 on an H100
    at B = 256)."""
    from pmce_tpu_torch.smpl import kernels as sk
    from pmce_tpu_torch.smpl.layer import apply_skinning

    dev = _card()
    rng = np.random.default_rng(B)
    V, J = 6890, 24
    v_posed = _rand(rng, dev, B, V, 3, scale=0.3)
    A = _rand(rng, dev, B, J, 4, 4, scale=0.5)
    w = torch.softmax(_rand(rng, dev, V, J, scale=3.0), -1)
    _cuda.reset_launch_counts()
    got = sk.fused_skinning(v_posed, A, w)
    assert _cuda.launch_counts()["skinning"] == 1
    want = apply_skinning(v_posed, A, w)
    assert float((got - want).abs().max()) < 1e-6
