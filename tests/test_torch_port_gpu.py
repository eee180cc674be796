"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``gpu`` marker and skips where
``torch.cuda.is_available()`` is false (this file imports no jax, so it
runs on the GPU machine, which has none):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py

(``--noconftest``: tests/conftest.py sets up jax for the JAX package's
tests.) Shapes are small but within what each kernel takes (trunk and
block C=256, GRU H a multiple of 64, chain C=64 with 2 and 8 heads,
skinning at 6890 vertices); ``chip_smoke.py`` holds the same kernels at
the full serving and training shapes. The wrappers that have no backward
kernel recompute their gradient: the chain through its plain version, the
trunk as JAX does, through the mhsa kernels. Bounds are
max|kernel - plain| / max|plain|, as in chip_smoke.py.
"""

from __future__ import annotations

import math
from pathlib import Path
from unittest import mock

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
    """max|got - want| / max|want|; a reference of zeros (h_prev and the
    Whh gradient of a one-step scan) must be met exactly."""
    want, got = want.detach().float().cpu(), got.detach().float().cpu()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    return err / scale if scale else (0.0 if err == 0 else float("inf"))


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


@pytest.mark.parametrize("T,J", [(48, 17), (81, 17), (4, 40)])
def test_trunk_kernel_takes_groups_over_32_tokens(T, J):
    """Temporal groups of 48 and 81 frames and spatial groups of 40 joints
    (a thread per query, several queries a thread past 256): the kernel
    runs, agrees with the plain version within the 3 % of the T = 16 case,
    and a rerun is bit-identical."""
    dev = _card()
    rng = np.random.default_rng(T + J)
    B, C, hid = 2, 256, 512

    def r(*s, **k):
        return _rand(rng, dev, *s, **k)

    params = ((r(C, scale=0.1, offset=1.0), r(C, scale=0.1),
               r(C, 3 * C, scale=C ** -0.5), r(3 * C, scale=0.02),
               r(C, C, scale=C ** -0.5), r(C, scale=0.02),
               r(C, scale=0.1, offset=1.0), r(C, scale=0.1),
               r(C, hid, scale=C ** -0.5), r(hid, scale=0.02),
               r(hid, C, scale=hid ** -0.5), r(C, scale=0.02)),) * 2
    args = (r(B, T * J, C, dtype=torch.bfloat16), params,
            (r(C, scale=0.1, offset=1.0), r(C, scale=0.1)),
            (r(C, scale=0.1, offset=1.0), r(C, scale=0.1)),
            r(T, C, scale=0.1), T, J, 1, 8)
    _cuda.reset_launch_counts()
    got = fa.lifter_trunk(*args)
    assert torch.equal(got, fa.lifter_trunk(*args))
    assert _cuda.launch_counts()["lifter_trunk"] == 2
    assert _rel(fa.lifter_trunk_plain(*args), got) < 0.03


def _gru_dir(rng, dev, steps, B, H):
    """One direction as the BiGRU hands it over: bf16 projections, the f32
    ``weight_hh`` [3H, H] as its ``.t()`` view, the bias."""
    return (_rand(rng, dev, steps, B, 3 * H, dtype=torch.bfloat16),
            _rand(rng, dev, 3 * H, H, scale=H ** -0.5).t(),
            _rand(rng, dev, 3 * H, scale=0.2))


@pytest.mark.parametrize("B", [5, 32, 256])
@pytest.mark.parametrize("steps", [(1, 1), (16, 16), (9, 8)],
                         ids=["T1", "T16", "T9-8"])
@pytest.mark.parametrize("H", [64, 1024])
def test_gru_kernels_match_plain(B, steps, H):
    """The scan kernel over both directions of a BiGRU layer (each with its
    own T) and over each direction alone, against the plain version
    (batches that are not a multiple of the 32-row pair included): one
    launch each, reruns bit-identical, and an f32 weight_hh gives the bits
    of its bf16 cast (the kernel rounds at load) and of its contiguous
    copy."""
    dev = _card()
    rng = np.random.default_rng(B + H + steps[1])
    gi_f, whh_f, bhh_f = _gru_dir(rng, dev, steps[0], B, H)
    gi_b, whh_b, bhh_b = _gru_dir(rng, dev, steps[1], B, H)
    args = (gi_f, gi_b, whh_f, bhh_f, whh_b, bhh_b)
    _cuda.reset_launch_counts()
    got = fa.gru_bidir(*args)
    counts = _cuda.launch_counts()
    assert counts["gru_scan"] == counts["gru_layer"] == 1
    assert counts["gru_layer_rev"] == 1
    for a, b in zip(got, fa.gru_bidir_plain(*args)):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert _rel(b, a) < 0.01
    assert all(torch.equal(a, b) for a, b in zip(got, fa.gru_bidir(*args)))
    cast = fa.gru_bidir(gi_f, gi_b, whh_f.to(torch.bfloat16), bhh_f,
                        whh_b.to(torch.bfloat16), bhh_b)
    assert all(torch.equal(a, b) for a, b in zip(got, cast))
    assert torch.equal(fa.gru_layer(gi_f, whh_f, bhh_f), got[0])
    assert torch.equal(fa.gru_layer_rev(gi_b, whh_b, bhh_b), got[1])
    # A contiguous [H, 3H] weight: the kernel reads it through its strides.
    assert torch.equal(fa.gru_layer(gi_f, whh_f.contiguous(), bhh_f), got[0])


@pytest.mark.parametrize("B", [5, 32, 256])
@pytest.mark.parametrize("steps", [1, 16])
@pytest.mark.parametrize("H", [64, 1024])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_gru_training_kernels_match_plain(B, steps, H, reverse):
    """The saving forward and the backward scan against their plain
    versions on the same inputs (batches that are not a multiple of the
    16-row tile included), then the whole gradient against autograd of the
    plain serving scan. Bounds as max|kernel - plain| / max|plain|: the
    saved state 0.01 (the GRU's one bf16 ulp), the backward 0.02 (its bf16
    dgh rounds now and then to the neighbouring value and the carry
    passes that on). A rerun gives the same bits, and the saving forward
    also writes the bf16 rounding of Whh that the backward reads: the bits
    of a cast."""
    dev = _card()
    rng = np.random.default_rng(B + H + steps + 2 * reverse)
    gi, whh, bhh = _gru_dir(rng, dev, steps, B, H)
    g = _rand(rng, dev, steps, B, H, dtype=torch.bfloat16)
    _cuda.reset_launch_counts()
    ys, saved = fa.gru_layer_save(gi, whh, bhh, reverse)
    ys_p, saved_p = fa.gru_layer_save_plain(gi, whh, bhh, reverse)
    assert ys.dtype == torch.bfloat16 and saved.shape == (5, steps, B, H)
    assert _rel(ys_p, ys) < 0.01
    for i in range(5):
        assert _rel(saved_p[i], saved[i]) < 0.01, i
    ys2, saved2, wb = fa._gru_save(gi, whh, bhh, reverse)
    assert torch.equal(ys2, ys) and torch.equal(saved2, saved)
    assert torch.equal(wb, whh.to(torch.bfloat16))
    dgi, dgh = fa.gru_layer_bwd(g, saved, wb, reverse)
    for a, b in zip((dgi, dgh), fa.gru_layer_bwd_plain(g, saved, whh,
                                                        reverse)):
        assert a.dtype == torch.float32 and a.shape == (steps, B, 3 * H)
        assert _rel(b, a) < 0.02
    counts = _cuda.launch_counts()
    assert counts["gru_layer_save"] == 2 and counts["gru_layer_bwd"] == 1

    leaves = [t.clone().requires_grad_(True) for t in (gi, whh, bhh)]
    got = torch.autograd.grad(
        (fa.gru_layer_rev if reverse else fa.gru_layer)(*leaves), leaves, g)
    want = torch.autograd.grad(fa.gru_layer_plain(*leaves, reverse=reverse),
                               leaves, g)
    for a, b in zip(got, want):
        assert _rel(b, a) < 0.02
    counts = _cuda.launch_counts()
    assert counts["gru_layer_save"] == 3 and counts["gru_layer_bwd"] == 2
    assert counts["gru_layer"] == counts["gru_layer_rev"] == 0
    assert counts["gru_scan"] == 0


@pytest.mark.parametrize("B", [5, 32, 256])
@pytest.mark.parametrize("steps", [16, 9, 8])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_gru_backward_scan_is_one_launch_a_direction(B, steps, reverse):
    """Row 13 at the Stage-2 widths (H = 1024; the final layer's 9 and 8
    steps): one launch of the persistent backward scan runs every step of a
    direction, within 0.02 of the plain backward (the band of
    test_gru_training_kernels_match_plain), the same bits on a rerun; its
    bf16 dgi and bf16(dgh) are the bits of the f32 outputs' casts."""
    dev = _card()
    H = 1024
    rng = np.random.default_rng(7 * B + steps + reverse)
    gi, whh, bhh = _gru_dir(rng, dev, steps, B, H)
    g = _rand(rng, dev, steps, B, H, dtype=torch.bfloat16)
    _, saved, wb = fa._gru_save(gi, whh, bhh, reverse)
    _cuda.reset_launch_counts()
    dgi, dgh = fa.gru_layer_bwd(g, saved, wb, reverse)
    counts = _cuda.launch_counts()
    assert counts["gru_bwd_scan"] == counts["gru_layer_bwd"] == 1
    for a, b in zip((dgi, dgh), fa.gru_layer_bwd_plain(g, saved, whh,
                                                        reverse)):
        assert a.dtype == torch.float32 and a.shape == (steps, B, 3 * H)
        assert _rel(b, a) < 0.02
    again = fa.gru_layer_bwd(g, saved, wb, reverse)
    assert torch.equal(again[0], dgi) and torch.equal(again[1], dgh)
    dgi_b, dgh_2, dghb = fa._gru_bwd_cuda(g, saved, wb, reverse,
                                          torch.bfloat16)
    assert torch.equal(dgh_2, dgh)
    assert torch.equal(dgi_b, dgi.to(torch.bfloat16))
    assert torch.equal(dghb, dgh.to(torch.bfloat16))


def test_gru_backward_scan_refuses_a_grid_that_cannot_be_resident():
    """A backward plan claiming more SMs than the card has: the
    cooperative launch refuses it and the wrapper raises."""
    dev = _card()
    rng = np.random.default_rng(1)
    H = 4096
    gi, whh, bhh = _gru_dir(rng, dev, 2, 8, H)
    _, saved = fa.gru_layer_save_plain(gi, whh, bhh)
    wb = whh.t().to(torch.bfloat16).t()
    g = _rand(rng, dev, 2, 8, H, dtype=torch.bfloat16)
    big = fa.gru_bwd_plan(8, H, 100_000, 232_448)
    with mock.patch.object(fa, "_card_bwd_plan", lambda *a: big), \
            pytest.raises(_cuda.KernelError, match="cooperative|too large"):
        fa.gru_layer_bwd(g, saved, wb)
        torch.cuda.synchronize()


def test_serving_bigru_launches_the_scan_twice():
    """The decoder's BiGRU at full width, cut at the mid frame, under bf16
    without gradients: one scan launch per layer, against the plain
    path within the kernel's band."""
    from pmce_tpu_torch.models.layers import BiGRU

    dev = _card()
    torch.manual_seed(0)
    gru = BiGRU(2048, 1024, num_layers=2).to(dev)
    x = torch.randn(16, 32, 2048, device=dev)
    _cuda.reset_launch_counts()
    with torch.no_grad():
        got = gru(x, mid_index=8, dt=torch.bfloat16)
        counts = _cuda.launch_counts()
        with mock.patch.object(fa, "gru_bidir", fa.gru_bidir_plain):
            want = gru(x, mid_index=8, dt=torch.bfloat16)
    assert counts["gru_scan"] == 2
    assert counts["gru_layer"] == counts["gru_layer_rev"] == 2
    assert _rel(want, got) < 0.02


def test_gru_scan_refuses_a_grid_that_cannot_be_resident():
    """A plan claiming more SMs than the card has: the cooperative launch
    refuses it and the wrapper raises (no CTA waits for another that never
    runs)."""
    dev = _card()
    rng = np.random.default_rng(0)
    H = 4096
    gi, whh, bhh = _gru_dir(rng, dev, 2, 8, H)
    big = fa.gru_plan(8, H, 2, 100_000, 232_448)
    with mock.patch.object(fa, "_card_plan", lambda *a: big), \
            pytest.raises(_cuda.KernelError, match="cooperative|too large"):
        fa.gru_bidir(gi, gi, whh, bhh, whh, bhh)
        torch.cuda.synchronize()


def test_trunk_kernel_gradient_matches_plain():
    """A gradient through the trunk on the card (the kernel forward, then
    JAX's recompute with attention through the mhsa kernels) against the
    plain trunk's autograd. The two differ in where bf16 rounds (the
    recompute rounds each attention output and its probabilities, as
    ``lifter_trunk_reference`` with ``fused_mhsa`` does), hence 3 %."""
    dev = _card()
    rng = np.random.default_rng(4)
    C, hid, T, J = 256, 512, 16, 17
    w = tuple(_rand(rng, dev, *s, scale=0.05, offset=o).requires_grad_(True)
              for s, o in (((C,), 1.0), ((C,), 0.0), ((C, 3 * C), 0.0),
                           ((3 * C,), 0.0), ((C, C), 0.0), ((C,), 0.0),
                           ((C,), 1.0), ((C,), 0.0), ((C, hid), 0.0),
                           ((hid,), 0.0), ((hid, C), 0.0), ((C,), 0.0)))
    w2 = tuple(t.detach().clone().requires_grad_(True) for t in w)
    norm = (_rand(rng, dev, C, offset=1.0), _rand(rng, dev, C))
    x = _rand(rng, dev, 2, T * J, C, dtype=torch.bfloat16)
    tpe = _rand(rng, dev, T, C, scale=0.1)
    g = _rand(rng, dev, 2, T * J, C, dtype=torch.bfloat16)
    _cuda.reset_launch_counts()
    y = fa.lifter_trunk(x, (w, w2), norm, norm, tpe, T, J, 1, 8)
    y.backward(g)
    counts = _cuda.launch_counts()
    assert counts["lifter_trunk"] == 1
    assert counts["mhsa_fwd"] == counts["mhsa_bwd"] == 2
    yp = fa.lifter_trunk_plain(x, (w, w2), norm, norm, tpe, T, J, 1, 8)
    want = torch.autograd.grad(yp, w + w2, g)
    assert _rel(yp, y) <= 0.03
    for a, b in zip(want, [t.grad for t in w + w2]):
        assert _rel(a, b) <= 0.03


def _chain_args(rng, dev, B, grad=False, V=61, NB=2, bf=torch.bfloat16):
    """The chain's inputs; ``bf``: the compute dtype, which rides on the
    3 -> C projections."""
    J, C = 19, 64

    def t(*s, scale=0.05, dtype=torch.float32):
        return _rand(rng, dev, *s, scale=scale, dtype=dtype) \
            .requires_grad_(grad)

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
    return (t(B, J, 3, scale=0.3), t(B, V, 3, scale=0.3),
            t(B, NB, 12, C, scale=0.1), t(B, NB, 12, C, scale=0.1), blocks)


def test_chain_backward_is_the_plain_recompute():
    """The chain kernel's gradient is autograd of the plain version on the
    saved inputs (the JAX package's XLA recompute): the same numbers as
    the plain path's own gradient, to f32 rounding."""
    dev = _card()
    args = _chain_args(np.random.default_rng(6), dev, 3, grad=True)
    leaves = fa._tensors(args)
    outs_k = fc.coevo_chain(*args, 8, 2)
    outs_p = fc.coevo_chain_plain(*args, 8, 2)
    cot = tuple(torch.randn_like(o) for o in outs_p)
    gk = torch.autograd.grad(outs_k, leaves, cot, allow_unused=True)
    gp = torch.autograd.grad(outs_p, leaves, cot, allow_unused=True)
    assert sum(g is not None for g in gk) == sum(g is not None for g in gp)
    for a, b in zip(gk, gp):
        if b is not None:
            assert torch.allclose(a.float(), b.float(), rtol=1e-5,
                                  atol=1e-6)


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


# f32 (the serving forward's kernels, csrc/block_f32.cu, csrc/coevo_f32.cu)
# against the plain versions with TF32 off, at the serving shapes, relative
# to each output's largest magnitude. Both sides are f32 throughout and
# differ in the order of their sums (FFMA vs cuBLAS) and in exp / erf.
# chip_smoke.py measured 2.7e-7 to 5.6e-7 at these shapes on an H100.
F32_REL_TOL = 1e-5


@pytest.fixture
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def test_chain_kernel_refuses_f32_on_card(no_tf32):
    """Once refused, f32 now runs the f32 chain kernel: at the serving
    shapes (B = 256, J = 19, V = 431, 3 blocks) one ``coevo_chain_f32``
    launch a call and no bf16 one, within ``F32_REL_TOL`` of the plain
    version, a rerun bit for bit."""
    dev = _card()
    args = _chain_args(np.random.default_rng(11), dev, 256, V=431, NB=3,
                       bf=torch.float32)
    _cuda.reset_launch_counts()
    with torch.no_grad():
        got = fc.coevo_chain(*args, 8, 2)
        again = fc.coevo_chain(*args, 8, 2)
        want = fc.coevo_chain_plain(*args, 8, 2)
    counts = _cuda.launch_counts()
    assert counts["coevo_chain_f32"] == 2 and counts["coevo_chain"] == 0
    for a, a2, b in zip(got, again, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert torch.equal(a, a2)
        assert _rel(b, a) < F32_REL_TOL


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
                                          (17, False, True), (48, True, True),
                                          (64, False, False)])
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


@pytest.mark.parametrize("clips,N,hid", [(1024, 17, 512), (1088, 16, 512),
                                         (80, 48, 512), (64, 64, 512),
                                         (96, 17, 384)])
def test_block_backward_tile_program_at_the_training_shapes(clips, N, hid):
    """Row 7 at the Stage-1 step's shapes (batch 64: block 0's spatial and
    block 2's temporal half), at the seqlen-48 lifter's and the gate's 64
    tokens, and at a hidden width that is not a multiple of 256 (the fc2ᵀ
    stage's last block half full), with the post-norm and mask gradients:
    the tile program and the weight-gradient launch against the plain
    version's autograd, within 0.02 of each gradient's largest magnitude
    (chip_smoke.py's band), one counted backward, and the same bits on a
    rerun."""
    dev = _card()
    rng = np.random.default_rng(clips + N)
    params = _block_params(rng, dev, True, hid=hid)
    x = _rand(rng, dev, clips, N, 256, dtype=torch.bfloat16)
    x.requires_grad_(True)
    u = rng.random((2, clips, 1, 1))
    bm = tuple(torch.from_numpy(((u[i] < 0.8) / 0.8).astype(np.float32))
               .to(dev).requires_grad_(True) for i in range(2))
    g = _rand(rng, dev, clips, N, 256, dtype=torch.bfloat16)
    leaves = [x] + params + list(bm)
    yk = fa.transformer_block(x, tuple(params), 8, 1e-6, 1e-6, bm)
    yp = fa.transformer_block_plain(x, tuple(params), 8, 1e-6, 1e-6, bm)
    _cuda.reset_launch_counts()
    gk = torch.autograd.grad(yk, leaves, g, retain_graph=True)
    assert _cuda.launch_counts()["block_bwd"] == 1
    gk2 = torch.autograd.grad(yk, leaves, g, retain_graph=True)
    gp = torch.autograd.grad(yp, leaves, g)
    for i, (a, a2, b) in enumerate(zip(gk, gk2, gp)):
        assert torch.equal(a, a2), i
        assert bool(torch.isfinite(a).all()), i
        assert _rel(b, a) < 0.02, (i, _rel(b, a))


@pytest.mark.parametrize("clips,N,masks,post", [
    (1024, 17, False, True), (1088, 16, True, True), (512, 17, True, False),
    (544, 16, False, False)], ids=str)
@pytest.mark.parametrize("grad", [True, False], ids=["grad", "no-grad"])
def test_block_forward_tile_program_at_the_training_shapes(clips, N, masks,
                                                           post, grad):
    """Row 6 at the Stage-1 step's shapes (batch 64: [1024, 17], [1088, 16])
    and the Stage-2 step's (batch 32: [512, 17], [544, 16]), with and
    without masks and the post-norm, saving (a gradient owed) and not:
    one launch, within 0.02 of the plain version's largest magnitude
    (chip_smoke.py's band), the same bits on a rerun."""
    dev = _card()
    rng = np.random.default_rng([clips, N, masks, post])
    params = _block_params(rng, dev, post)
    x = _rand(rng, dev, clips, N, 256, dtype=torch.bfloat16)
    x.requires_grad_(grad)
    bm = None
    if masks:
        u = rng.random((2, clips, 1, 1))
        bm = tuple(torch.from_numpy(((u[i] < 0.8) / 0.8).astype(np.float32))
                   .to(dev) for i in range(2))
    with torch.set_grad_enabled(grad):
        _cuda.reset_launch_counts()
        y = fa.transformer_block(x, tuple(params), 8, 1e-6, 1e-6, bm)
        assert _cuda.launch_counts()["block_fwd"] == 1
        y2 = fa.transformer_block(x, tuple(params), 8, 1e-6, 1e-6, bm)
    with torch.no_grad():
        yp = fa.transformer_block_plain(x, tuple(params), 8, 1e-6, 1e-6, bm)
    assert bool(torch.isfinite(y).all())
    assert torch.equal(y, y2)
    assert _rel(yp, y) < 0.02


def test_block_forward_saves_what_the_backward_reads():
    """The saving epilogues of row 6's tile program: h1, qkv (q pre-scaled),
    o, x1, h2, hh, ge, y and the branches a, mo against the plain version's
    intermediates on the same inputs, each within 0.02 of its largest
    magnitude (the dtypes and layouts row 7 reads)."""
    dev = _card()
    rng = np.random.default_rng(61)
    clips, N, C = 96, 17, 256
    params = [p.detach() if p is not None else None
              for p in _block_params(rng, dev, True)]
    x = _rand(rng, dev, clips, N, C, dtype=torch.bfloat16)
    u = rng.random((2, clips, 1, 1))
    m1, m2 = (torch.from_numpy(((u[i] < 0.8) / 0.8).astype(np.float32))
              .to(dev) for i in range(2))
    with torch.no_grad():
        _, saved = fa._block_fwd_cuda(x, params, m1, m2, 8, 1e-6, 1e-6,
                                      True, True)
        (g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, w1, bb1, w2, bb2, gp,
         bpp) = params
        bf = torch.bfloat16
        xf = x.float().reshape(-1, C)
        h1 = fa.ln_f32(xf, g1, b1, 1e-6).to(bf)
        qkv = fa.mm(h1, wqkv.to(bf)) + bqkv
        qkv[:, :C] *= 1.0 / math.sqrt(32)
        q, k, v = (qkv[:, i * C:(i + 1) * C].to(bf).reshape(clips, N, C)
                   for i in range(3))
        o = fa._grouped_attention(q, k, v, 1, N, 8, False).to(bf)
        o = o.reshape(-1, C)
        a = fa.mm(o, wproj.to(bf)) + bproj
        rows1, rows2 = (m.reshape(clips, 1).repeat_interleave(N, 0)
                        for m in (m1, m2))
        x1 = xf + a * rows1
        h2 = fa.ln_f32(x1, g2, b2, 1e-6).to(bf)
        hh = fa.mm(h2, w1.to(bf)) + bb1
        ge = torch.nn.functional.gelu(hh).to(bf)
        mo = fa.mm(ge, w2.to(bf)) + bb2
        y = x1 + mo * rows2
    want = (h1, qkv.to(bf), o, x1, h2, hh, ge, y, a, mo)
    names = ("h1", "qkv", "o", "x1", "h2", "hh", "ge", "y", "a", "mo")
    for name, got, ref in zip(names, saved, want):
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        assert _rel(ref, got) < 0.02, (name, _rel(ref, got))


@pytest.mark.parametrize("clips,N", [(4096, 19), (4864, 16)])
def test_block_kernel_refuses_f32_on_card(no_tf32, clips, N):
    """Once refused, f32 tokens now run row 6's f32 serving program: at
    the serving forward's spatial and temporal shapes, with the lifter's
    post-norm, one ``block_fwd_f32`` launch and no bf16 one, within
    ``F32_REL_TOL`` of the plain version, a rerun bit for bit."""
    dev = _card()
    rng = np.random.default_rng(clips + N)
    params = tuple(p.detach() for p in _block_params(rng, dev, True))
    x = _rand(rng, dev, clips, N, 256)
    _cuda.reset_launch_counts()
    with torch.no_grad():
        got = fa.transformer_block(x, params, 8)
        assert _cuda.launch_counts()["block_fwd_f32"] == 1
        assert _cuda.launch_counts()["block_fwd"] == 0
        again = fa.transformer_block(x, params, 8)
        want = fa.transformer_block_plain(x, params, 8)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert torch.equal(got, again)
    assert _rel(want, got) < F32_REL_TOL


@pytest.mark.parametrize("why", ["grad", "masks"])
def test_block_f32_training_raises_on_card(why):
    """f32 with a gradient or with branch masks is row 6's saving program
    and row 7 in f32, queued in ROADMAP.md B2b: it raises, no kernel and no
    plain version runs."""
    dev = _card()
    rng = np.random.default_rng(5)
    params = _block_params(rng, dev, True)
    x = _rand(rng, dev, 2, 16, 256)
    masks = None
    if why == "masks":
        params = [p.detach() for p in params]
        masks = (torch.ones(2, 1, 1, device=dev),) * 2
    _cuda.reset_launch_counts()
    with mock.patch.object(fa, "transformer_block_plain",
                           side_effect=AssertionError("plain ran")), \
            pytest.raises(NotImplementedError, match="ROADMAP.md B2b"):
        fa.transformer_block(x, tuple(params), 8, branch_masks=masks)
    assert not any(_cuda.launch_counts().values())


@pytest.mark.parametrize("V", [6890, 6889])
@pytest.mark.parametrize("B", [1, 9, 256])
def test_skinning_kernel_matches_plain(B, V):
    """Full f32 on both sides: within 1e-6 m (measured 2.4e-7 on an H100
    at B = 256), at the SMPL mesh's 6890 vertices (odd bodies' rows start
    8-byte aligned) and at 6889 (not a multiple of 4: a ragged last thread
    and rows at every alignment)."""
    from pmce_tpu_torch.smpl import kernels as sk
    from pmce_tpu_torch.smpl.layer import apply_skinning

    dev = _card()
    rng = np.random.default_rng([B, V])
    J = 24
    v_posed = _rand(rng, dev, B, V, 3, scale=0.3)
    A = _rand(rng, dev, B, J, 4, 4, scale=0.5)
    w = torch.softmax(_rand(rng, dev, V, J, scale=3.0), -1)
    _cuda.reset_launch_counts()
    got = sk.fused_skinning(v_posed, A, w)
    assert _cuda.launch_counts()["skinning"] == 1
    want = apply_skinning(v_posed, A, w)
    assert float((got - want).abs().max()) < 1e-6


def test_etl_synthesis_on_the_card_matches_plain_and_the_cpu():
    """The ETL's SMPL synthesis (``data/etl/common.smpl_verts_joints``) at
    B = 1,100 bodies of the 6890-vertex stand-in: two full chunks of 512
    and one of 76, so exactly 3 skinning launches; the plain skinning on
    the card launches none and agrees within 1e-6 m (the kernel's bound;
    joints, which skinning does not touch, bit for bit); the CPU within
    1e-5 m (the blend shapes' f32 sums in another order at ~4 m)."""
    from pmce_tpu_torch.data.etl.common import smpl_verts_joints
    from pmce_tpu_torch.smpl.artifacts import synthetic_artifacts

    _card()
    art = synthetic_artifacts(seed=0)
    rng = np.random.default_rng(17)
    n = 1100
    pose = rng.normal(scale=0.3, size=(n, 72)).astype(np.float32)
    shape = rng.normal(scale=0.5, size=(n, 10)).astype(np.float32)
    trans = (rng.normal(scale=0.5, size=(n, 3))
             + [0.0, 0.0, 4.0]).astype(np.float32)
    _cuda.reset_launch_counts()
    verts, joints = smpl_verts_joints(art, pose, shape, trans)
    assert _cuda.launch_counts()["skinning"] == 3
    assert verts.shape == (n, 6890, 3) and verts.dtype == np.float32
    plain_v, plain_j = smpl_verts_joints(art, pose, shape, trans,
                                         fused=False)
    assert _cuda.launch_counts()["skinning"] == 3
    assert np.abs(verts - plain_v).max() <= 1e-6
    np.testing.assert_array_equal(joints, plain_j)
    cpu_v, cpu_j = smpl_verts_joints(art, pose, shape, trans, device="cpu")
    assert np.abs(verts - cpu_v).max() <= 1e-5
    assert np.abs(joints - cpu_j).max() <= 1e-5


# ----------------------------------------------- decoder attention blocks
def _dec_case(rng, dev, kind, shape):
    """Leaves (tensors that get gradients), the call on them, and the
    plain version's call, for one of the decoder's attention blocks."""
    def r(*s, scale=0.2, offset=0.0, dtype=torch.float32):
        return _rand(rng, dev, *s, scale=scale, offset=offset,
                     dtype=dtype).requires_grad_(True)

    B, N, C, H = shape[:4]
    hid = 4 * C
    bf = torch.bfloat16
    masks = tuple(torch.from_numpy(((rng.random((B, 1, 1)) < 0.8) / 0.8)
                                   .astype(np.float32)).to(dev)
                  for _ in range(2))
    if kind == "mhsa":
        leaves = [r(B, N, C, scale=1.0, dtype=bf), r(C, 3 * C, scale=C ** -0.5),
                  r(3 * C, scale=0.05), r(C, C, scale=C ** -0.5),
                  r(C, scale=0.05)]
        return leaves, (lambda fn, x, *p: fn(x, *p, H)), \
            (fa.fused_mhsa, fa.mhsa_plain)
    mlp = [r(C, hid, scale=C ** -0.5), r(hid, scale=0.05),
           r(hid, C, scale=hid ** -0.5), r(C, scale=0.05)]
    if kind == "ada":
        leaves = [r(B, N, C, scale=1.0, dtype=bf),
                  *(r(B, C, offset=1.0 - i % 2, dtype=bf) for i in range(4)),
                  r(C, 3 * C, scale=C ** -0.5), r(3 * C, scale=0.05),
                  r(C, C, scale=C ** -0.5), r(C, scale=0.05), *mlp]
        return leaves, (lambda fn, x, g1, b1, g2, b2, *p: fn(
            x, g1, b1, g2, b2, p, H, 1e-6, masks)), \
            (fa.ada_block, fa.ada_block_plain)
    Nk = shape[4]
    proj = []
    for _ in range(4):
        proj += [r(C, C, scale=C ** -0.5), r(C, scale=0.05)]
    leaves = [r(B, N, C, scale=1.0, dtype=bf), r(B, Nk, C, scale=1.0, dtype=bf),
              r(B, Nk, C, scale=1.0, dtype=bf),
              *(r(B, C, offset=1.0 - i % 2, dtype=bf) for i in range(8)),
              *proj, *mlp]
    return leaves, (lambda fn, xq, xk, xv, *rest: fn(
        xq, xk, xv, rest[0:8:2], rest[1:8:2], rest[8:], H, 1e-6, masks)), \
        (fa.ca_block, fa.ca_block_plain)


@pytest.mark.parametrize("kind,shape", [
    ("mhsa", (32, 17, 64, 8)), ("mhsa", (24, 17, 256, 8)),
    ("mhsa", (512, 17, 256, 8)),
    ("mhsa", (4, 100, 64, 2)), ("ada", (4, 431, 64, 2)),
    ("ada", (32, 431, 64, 2)),
    ("ada", (5, 17, 64, 8)), ("ca", (4, 17, 64, 8, 431)),
    ("ca", (4, 431, 64, 2, 17))], ids=str)
def test_decoder_attention_kernels_match_plain(kind, shape):
    """Each block kernel, forward and backward, against its plain version
    and the plain version's autograd (bf16 tokens and AdaLN vectors, f32
    weights, per-clip branch masks), within 2 % of each output's and each
    gradient's largest magnitude (the keys' bias and AdaLN β, zero
    analytically, within 2 % of the largest gradient); a second backward
    gives the same gradients bit for bit."""
    dev = _card()
    rng = np.random.default_rng([len(kind), *shape])
    leaves, call, (kernel, plain) = _dec_case(rng, dev, kind, shape)
    g = _rand(rng, dev, *leaves[0].shape, dtype=torch.bfloat16)
    y = call(kernel, *leaves)
    gk = torch.autograd.grad(y, leaves, g, retain_graph=True)
    again = torch.autograd.grad(y, leaves, g)
    yp = call(plain, *leaves)
    gp = torch.autograd.grad(yp, leaves, g)
    assert bool(torch.isfinite(y).all())
    assert _rel(yp, y) <= 0.02
    largest = max(float(t.abs().max()) for t in gp)
    zero = {"ca": (6, 14)}.get(kind, ())
    for i, (a, b) in enumerate(zip(gp, gk)):
        scale = largest if i in zero else float(a.abs().max())
        assert float((a.float() - b.float()).abs().max()) <= 0.02 * scale, i
    assert all(torch.equal(a, b) for a, b in zip(gk, again))


@pytest.mark.parametrize("shape", [(32, 17, 64, 8, 431),
                                   (32, 431, 64, 2, 17), (3, 40, 64, 4, 9)],
                         ids=str)
def test_ca_block_backward_with_mask_gradients(shape):
    """Row 11 at the Stage-2 step's two orientations (and head width 16),
    with branch masks that require grad: the tile program and the
    weight-gradient launch (one counted backward) against the plain
    version's autograd, dm1 and dm2 included, within 2 % of each gradient's
    largest magnitude (the keys' bias and AdaLN β, zero analytically, of
    the largest gradient); a rerun gives the same bits."""
    dev = _card()
    rng = np.random.default_rng(list(shape))
    leaves, call, (kernel, plain) = _dec_case(rng, dev, "ca", shape)
    B = shape[0]
    u = rng.random((2, B, 1, 1))
    u[0, 0] = u[1, 1] = 1.0
    masks = tuple(torch.from_numpy(((u[i] < 0.8) / 0.8).astype(np.float32))
                  .to(dev).requires_grad_(True) for i in range(2))
    H = shape[3]

    def run(fn):
        xq, xk, xv, *rest = leaves
        return fn(xq, xk, xv, rest[0:8:2], rest[1:8:2], rest[8:], H, 1e-6,
                  masks)

    g = _rand(rng, dev, *leaves[0].shape, dtype=torch.bfloat16)
    every = [*leaves, *masks]
    y = run(kernel)
    _cuda.reset_launch_counts()
    gk = torch.autograd.grad(y, every, g, retain_graph=True)
    assert _cuda.launch_counts()["ca_block_bwd"] == 1
    again = torch.autograd.grad(y, every, g)
    gp = torch.autograd.grad(run(plain), every, g)
    largest = max(float(t.abs().max()) for t in gp)
    for i, (a, a2, b) in enumerate(zip(gk, again, gp)):
        assert torch.equal(a, a2), i
        assert a.shape == b.shape and a.dtype == b.dtype, i
        scale = largest if i in (6, 14) else float(b.abs().max())
        assert float((a.float() - b.float()).abs().max()) <= 0.02 * scale, i


@pytest.mark.parametrize("shape", [(32, 17, 64, 8, 431),
                                   (32, 431, 64, 2, 17), (3, 40, 64, 4, 9),
                                   (3, 5, 64, 8, 72)], ids=str)
def test_ca_forward_tile_program_matches_plain_and_the_sequence(shape):
    """Row 10's tile program (one counted launch) against the plain version
    within 2 % and bit for bit on a rerun, at the Stage-2 step's two
    orientations, head width 16, and keys split so that one CTA holds none;
    every tensor it saves for row 11 (nq, nk, nv, q, k, v, o, the softmax
    max and sum, x1, h2, hh, ge, a, mo) against what the launch sequence
    saves on the same inputs, within 2 % of its largest magnitude."""
    dev = _card()
    rng = np.random.default_rng([7, *shape])
    leaves, _, _ = _dec_case(rng, dev, "ca", shape)
    H = shape[3]
    xs = [t.detach() for t in leaves[:3]]
    rest = [t.detach() for t in leaves[3:]]
    masks = tuple(torch.from_numpy(((rng.random((shape[0], 1, 1)) < 0.8)
                                    / 0.8).astype(np.float32)).to(dev)
                  for _ in range(2))

    def fwd():
        return fa._ca_fwd_cuda(xs, rest[0:8:2], rest[1:8:2], masks,
                               rest[8:], H, 1e-6, keep_branches=True)

    _cuda.reset_launch_counts()
    y, saved = fwd()
    assert _cuda.launch_counts()["ca_block_fwd"] == 1
    assert _cuda.launch_counts()["ca_block_fwd_seq"] == 0
    y2, saved2 = fwd()
    assert torch.equal(y, y2)
    assert all(torch.equal(a, b) for a, b in zip(saved[6:], saved2[6:]))
    yp = fa.ca_block_plain(*xs, rest[0:8:2], rest[1:8:2], rest[8:], H,
                           1e-6, masks)
    assert bool(torch.isfinite(y).all())
    assert _rel(yp, y) <= 0.02
    with mock.patch.object(fa, "ca_bwd_kernel_fits", lambda *a: False):
        ys, seq = fwd()
    assert _cuda.launch_counts()["ca_block_fwd_seq"] == 1
    assert _rel(ys, y) <= 0.02
    names = ("nq", "nk", "nv", "q", "k", "v", "o", "stats", "x1", "h2", "hh",
             "ge", "a", "mo")
    for name, a, b in zip(names, seq[6:], saved[6:]):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _rel(a, b) <= 0.02, name


@pytest.mark.parametrize("shape", [(32, 431, 64, 2), (3, 45, 64, 4),
                                   (2, 17, 64, 8), (2, 520, 64, 2)], ids=str)
def test_ada_block_backward_with_mask_gradients(shape):
    """Row 9 with branch masks that require grad: the tile program and the
    weight-gradient launch (one counted backward) at the Stage-2 step's
    [32, 431, 64] and two small shapes, the launch sequence over 512 tokens,
    against the plain version's autograd, dm1 and dm2 included, within 2 %
    of each gradient's largest magnitude; a rerun gives the same bits."""
    dev = _card()
    rng = np.random.default_rng(list(shape))
    leaves, _, (kernel, plain) = _dec_case(rng, dev, "ada", shape)
    B, N, _, H = shape
    u = rng.random((2, B, 1, 1))
    u[0, 0] = u[1, 1] = 1.0
    masks = tuple(torch.from_numpy(((u[i] < 0.8) / 0.8).astype(np.float32))
                  .to(dev).requires_grad_(True) for i in range(2))

    def run(fn):
        x, g1, b1, g2, b2, *p = leaves
        return fn(x, g1, b1, g2, b2, p, H, 1e-6, masks)

    g = _rand(rng, dev, *leaves[0].shape, dtype=torch.bfloat16)
    every = [*leaves, *masks]
    y = run(kernel)
    _cuda.reset_launch_counts()
    gk = torch.autograd.grad(y, every, g, retain_graph=True)
    tile = fa.ada_bwd_kernel_fits(N, 64, 256)
    counts = _cuda.launch_counts()
    assert counts["ada_block_bwd"] == int(tile)
    assert counts["ada_block_bwd_seq"] == int(not tile)
    again = torch.autograd.grad(y, every, g)
    gp = torch.autograd.grad(run(plain), every, g)
    for i, (a, a2, b) in enumerate(zip(gk, again, gp)):
        assert torch.equal(a, a2), i
        assert a.shape == b.shape and a.dtype == b.dtype, i
        assert float((a.float() - b.float()).abs().max()) <= \
            0.02 * float(b.abs().max()), i


@pytest.mark.parametrize("shape,cpc", [
    ((32, 17, 64, 8), None), ((512, 17, 256, 8), None),
    ((512, 17, 256, 8), 7), ((544, 16, 256, 8), None), ((6, 16, 64, 2), 3),
    ((5, 64, 64, 4), None), ((9, 40, 256, 8), 2)], ids=str)
def test_mhsa_forward_tile_program_matches_plain_and_the_sequence(shape,
                                                                  cpc):
    """Row 4's tile program (one counted launch, the sequence's counter 0)
    at the decoder's [32, 17, 64] (8 heads of 8), the trunk backward's
    [512, 17, 256] and [544, 16, 256] (8 heads of 32; the plan's clips a
    CTA and 7), heads of 32 and 16 at C = 64, 64 tokens, and clips split
    over tiles: within 2 % of the plain version, also at one clip a CTA
    (the key blocks then start elsewhere); bit for bit on a rerun; every
    tensor it saves for row 5 (qkv, o, the softmax max and sum) against
    the launch sequence's within 2 % of its largest magnitude; without a
    gradient owed, the same output bits."""
    dev = _card()
    rng = np.random.default_rng([11, *shape])
    leaves, _, _ = _dec_case(rng, dev, "mhsa", shape)
    x, *w = (t.detach() for t in leaves)
    H = shape[3]

    def fwd(**kw):
        return fa._mhsa_fwd_cuda(x, *w, H, clips_per_cta=cpc, **kw)

    _cuda.reset_launch_counts()
    y, saved = fwd()
    counts = _cuda.launch_counts()
    assert counts["mhsa_fwd"] == 1 and counts["mhsa_fwd_seq"] == 0
    y2, saved2 = fwd()
    assert torch.equal(y, y2)
    assert all(torch.equal(a, b) for a, b in zip(saved, saved2))
    y1, _ = fa._mhsa_fwd_cuda(x, *w, H, clips_per_cta=1)
    assert _rel(y1, y) <= 0.02
    yn, none = fwd(for_grad=False)
    assert torch.equal(y, yn) and none == (None, None, None)
    assert bool(torch.isfinite(y).all())
    assert _rel(fa.mhsa_plain(x, *w, H), y) <= 0.02
    with mock.patch.object(fa, "mhsa_fwd_kernel_fits", lambda *a: False):
        ys, seq = fwd()
    assert _cuda.launch_counts()["mhsa_fwd_seq"] == 1
    assert _rel(ys, y) <= 0.02
    for name, a, b in zip(("qkv", "o", "stats"), seq, saved):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _rel(a, b) <= 0.02, name


@pytest.mark.parametrize("shape", [(32, 17, 64, 8), (40, 17, 256, 8),
                                   (3, 16, 64, 4), (3, 16, 64, 2)], ids=str)
def test_mhsa_backward_tile_program_matches_plain(shape):
    """Row 5's tile program and weight launch (one counted backward, the
    sequence's counter 0) at the decoder's [32, 17, 64] (8 heads of 8),
    [40, 17, 256] (8 heads of 32, the trunk backward's width) and heads of
    16 and 32 at C = 64: every gradient within 2 % of its largest magnitude
    of the plain version's autograd, bit for bit on a rerun."""
    dev = _card()
    rng = np.random.default_rng([13, *shape])
    leaves, call, (kernel, plain) = _dec_case(rng, dev, "mhsa", shape)
    g = _rand(rng, dev, *leaves[0].shape, dtype=torch.bfloat16)
    y = call(kernel, *leaves)
    _cuda.reset_launch_counts()
    gk = torch.autograd.grad(y, leaves, g, retain_graph=True)
    counts = _cuda.launch_counts()
    assert counts["mhsa_bwd"] == 1 and counts["mhsa_bwd_seq"] == 0
    again = torch.autograd.grad(y, leaves, g)
    gp = torch.autograd.grad(call(plain, *leaves), leaves, g)
    for i, (a, b) in enumerate(zip(gp, gk)):
        assert bool(torch.isfinite(b).all()), i
        assert _rel(a, b) <= 0.02, i
    assert all(torch.equal(a, b) for a, b in zip(gk, again))


def test_mhsa_backward_outside_the_gate_takes_the_sequence():
    """At 72 tokens (over the tile programs' 64) the backward is the launch
    sequence, counted by ``mhsa_bwd_seq`` alone, within 2 % of the plain
    version's autograd."""
    dev = _card()
    rng = np.random.default_rng(72)
    leaves, call, (kernel, plain) = _dec_case(rng, dev, "mhsa",
                                              (3, 72, 64, 4))
    g = _rand(rng, dev, *leaves[0].shape, dtype=torch.bfloat16)
    y = call(kernel, *leaves)
    _cuda.reset_launch_counts()
    gk = torch.autograd.grad(y, leaves, g)
    counts = _cuda.launch_counts()
    assert counts["mhsa_bwd_seq"] == 1 and counts["mhsa_bwd"] == 0
    gp = torch.autograd.grad(call(plain, *leaves), leaves, g)
    for i, (a, b) in enumerate(zip(gp, gk)):
        assert _rel(a, b) <= 0.02, i


def test_mhsa_backward_stage_split_books_every_stage():
    """``mhsa_bwd_stage_split`` at [32, 17, 64] and [512, 17, 256]: one
    stamped launch, not counted, every stage booked."""
    dev = _card()
    rng = np.random.default_rng(5)
    for shape in ((32, 17, 64, 8), (512, 17, 256, 8)):
        leaves, _, _ = _dec_case(rng, dev, "mhsa", shape)
        x, wqkv, bqkv, wproj, bproj = (t.detach() for t in leaves)
        _, saved = fa._mhsa_fwd_cuda(x, wqkv, bqkv, wproj, bproj, shape[3])
        _cuda.reset_launch_counts()
        split = fa.mhsa_bwd_stage_split(torch.ones_like(x), x, wqkv, wproj,
                                        saved, shape[3])
        assert all(split[k] > 0 for k in fa.MHSA_BWD_STAGES), split
        assert _cuda.launch_counts()["mhsa_bwd"] == 0


@pytest.mark.parametrize("shape,masks", [
    ((32, 431, 64, 2), True), ((32, 431, 64, 2), False),
    ((3, 45, 64, 4), True), ((2, 17, 64, 8), True), ((2, 512, 64, 2), True)],
    ids=str)
def test_ada_forward_tile_programs_match_plain_and_the_sequence(shape,
                                                                masks):
    """Row 8's two tile programs (one counted call, the sequence's counter
    0) at the vertex stream's [32, 431, 64] with and without branch masks,
    head widths 16 and 8 and 512 tokens: within 2 % of the plain version;
    bit for bit on a rerun; every tensor it saves for row 9 (h1, qkv, o,
    the softmax max and sum, x1, h2, hh, ge, a, mo) against what the launch
    sequence saves on the same inputs within 2 % of its largest magnitude;
    without a gradient owed, the same output bits and nothing saved."""
    dev = _card()
    rng = np.random.default_rng([13, *shape])
    leaves, _, _ = _dec_case(rng, dev, "ada", shape)
    x, *rest = (t.detach() for t in leaves)
    B, H = shape[0], shape[3]
    m = (tuple(torch.from_numpy(((rng.random((B, 1, 1)) < 0.8) / 0.8)
                                .astype(np.float32)).to(dev)
               for _ in range(2)) if masks else (None, None))

    def fwd(**kw):
        return fa._ada_fwd_cuda(x, rest[:4], m, rest[4:], H, 1e-6,
                                keep_branches=masks, **kw)

    _cuda.reset_launch_counts()
    y, saved = fwd()
    counts = _cuda.launch_counts()
    assert counts["ada_block_fwd"] == 1 and counts["ada_block_fwd_seq"] == 0
    y2, saved2 = fwd()
    assert torch.equal(y, y2)
    assert all(a is b is None or torch.equal(a, b)
               for a, b in zip(saved[4:], saved2[4:]))
    yn, nosave = fwd(for_grad=False)
    assert torch.equal(y, yn) and all(t is None for t in nosave[4:12])
    yp = fa.ada_block_plain(x, *rest[:4], tuple(rest[4:]), H, 1e-6,
                            m if masks else None)
    assert bool(torch.isfinite(y).all())
    assert _rel(yp, y) <= 0.02
    with mock.patch.object(fa, "ada_fwd_kernel_fits", lambda *a: False):
        ys, seq = fwd()
    assert _cuda.launch_counts()["ada_block_fwd_seq"] == 1
    assert _rel(ys, y) <= 0.02
    names = ("h1", "qkv", "o", "stats", "x1", "h2", "hh", "ge", "a", "mo")
    for name, a, b in zip(names, seq[4:], saved[4:]):
        if a is None:
            assert b is None and not masks, name
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _rel(a, b) <= 0.02, name


def test_ada_forward_grid_fits_the_card_in_one_wave():
    """Row 8's launch B at batch 32 (4 CTAs a clip: 128) is no larger than
    the CTAs the card holds at once (cudaOccupancyMaxActiveBlocksPerMulti-
    processor x SMs) on a card of 128 SMs or more: one wave."""
    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    resident, waves = fa.ada_fwd_waves(32)
    assert resident % sms == 0 and resident >= sms
    if sms >= 128:
        assert waves == 1 and 32 * fa.ADA_FWD_CTAS <= resident


def test_decoder_attention_kernels_refuse_f32_on_card():
    dev = _card()
    rng = np.random.default_rng(9)
    leaves, call, (kernel, _) = _dec_case(rng, dev, "ada", (2, 72, 64, 2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call(kernel, leaves[0].float(), *leaves[1:])


# ------------------------------------------------- the whole-block kernel
def _coevo_block_args(rng, dev, B, J=19, V=431, C=64, grad=False):
    """bf16 features, f32 AdaLN stacks and one block's 14-tuple."""
    def t(*s, scale=0.05, offset=0.0, dtype=torch.float32):
        return _rand(rng, dev, *s, scale=scale, offset=offset,
                     dtype=dtype).requires_grad_(grad)

    def w(i, o):
        return t(i, o, scale=i ** -0.5)

    def ca():
        return (w(C, C), t(C), w(C, C), t(C), w(C, C), t(C), w(C, C), t(C),
                w(C, 4 * C), t(4 * C), w(4 * C, C), t(C))

    def sa():
        return (w(C, 3 * C), t(3 * C), w(C, C), t(C), w(C, 4 * C),
                t(4 * C), w(4 * C, C), t(C))

    params = (t(J, C, scale=1.0), t(V, C, scale=1.0), t(J, C, scale=1.0),
              t(V, C, scale=1.0), t(V, C, scale=1.0), t(J, C, scale=1.0),
              w(C, C), t(C), w(C, C), t(C), ca(), ca(), sa(), sa())
    bf = torch.bfloat16
    return (t(B, J, C, scale=1.0, dtype=bf), t(B, V, C, scale=1.0, dtype=bf),
            t(B, 12, C, scale=0.1, offset=1.0), t(B, 12, C, scale=0.1),
            params)


@pytest.mark.parametrize("V", [431, 61])
def test_coevo_block_kernel_matches_plain(V):
    """The whole-block kernel against its plain version within 2 % of each
    output's largest magnitude (the chain's band: the same block program),
    one launch a call, and a rerun bit for bit."""
    dev = _card()
    args = _coevo_block_args(np.random.default_rng(V), dev, 5, V=V)
    _cuda.reset_launch_counts()
    with torch.no_grad():
        got = fc.coevo_block(*args, 8, 2)
        again = fc.coevo_block(*args, 8, 2)
        want = fc.coevo_block_plain(*args, 8, 2)
    assert _cuda.launch_counts()["coevo_block"] == 2
    for a, a2, b in zip(got, again, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, a2)
        assert _rel(b, a) < 0.02


def test_coevo_block_runs_its_kernel_not_the_plain_version():
    """With the plain version made to raise, a bf16 forward on the card
    still succeeds: the kernel computes it."""
    dev = _card()
    args = _coevo_block_args(np.random.default_rng(2), dev, 3)
    with mock.patch.object(fc, "coevo_block_plain",
                           side_effect=AssertionError("plain version ran")), \
            torch.no_grad():
        jout, vout = fc.coevo_block(*args, 8, 2)
    assert jout.shape == (3, 19, 64) and vout.shape == (3, 431, 64)


def test_coevo_block_backward_is_the_plain_recompute():
    """The whole-block kernel's gradient is autograd of the plain version on
    the saved inputs (JAX's ``_fused_coevo_bwd``): the plain path's own
    gradient, to f32 rounding."""
    dev = _card()
    args = _coevo_block_args(np.random.default_rng(3), dev, 3, grad=True)
    leaves = fa._tensors(args)
    outs_k = fc.coevo_block(*args, 8, 2)
    outs_p = fc.coevo_block_plain(*args, 8, 2)
    cot = tuple(torch.randn_like(o) for o in outs_p)
    gk = torch.autograd.grad(outs_k, leaves, cot)
    gp = torch.autograd.grad(outs_p, leaves, cot)
    for a, b in zip(gk, gp):
        assert torch.allclose(a.float(), b.float(), rtol=1e-5, atol=1e-6)


def test_coevo_block_kernel_refuses_f32_on_card(no_tf32):
    """Once refused, f32 features now run the f32 whole block: at the
    whole-block serving forward's shapes (B = 256, V = 431) one
    ``coevo_block_f32`` launch a call, within ``F32_REL_TOL`` of the plain
    version, a rerun bit for bit; a bf16 weight beside f32 features raises
    ``ValueError``."""
    dev = _card()
    jf0, vf0, g, b, params = _coevo_block_args(np.random.default_rng(4),
                                               dev, 256)
    args = (jf0.float(), vf0.float(), g, b, params)
    _cuda.reset_launch_counts()
    with torch.no_grad():
        got = fc.coevo_block(*args, 8, 2)
        again = fc.coevo_block(*args, 8, 2)
        want = fc.coevo_block_plain(*args, 8, 2)
    counts = _cuda.launch_counts()
    assert counts["coevo_block_f32"] == 2 and counts["coevo_block"] == 0
    for a, a2, ref in zip(got, again, want):
        assert a.dtype == torch.float32 and a.shape == ref.shape
        assert torch.equal(a, a2)
        assert _rel(ref, a) < F32_REL_TOL
    mixed = params[:6] + (params[6].bfloat16(),) + params[7:]
    with torch.no_grad(), pytest.raises(ValueError, match="f32 compute"):
        fc.coevo_block(*args[:4], mixed, 8, 2)


def test_coevo_f32_plan_refuses_a_vertex_stream_over_it():
    """The f32 plan keeps two f32 [V, C] buffers in shared memory (V C 8
    bytes: 220,672 at V = 431, V <= 454); 460 vertices raise naming
    ROADMAP.md B3 (JAX's kernel takes them), the chain's too."""
    dev = _card()
    for V in (48, 431, 460):
        assert _cuda.COEVO_F32.query("pmce_coevo_f32_smem_bytes", V) \
            == V * 64 * 8
    jf0, vf0, g, b, params = _coevo_block_args(np.random.default_rng(8),
                                               dev, 1, V=460)
    with torch.no_grad(), pytest.raises(NotImplementedError,
                                        match="ROADMAP.md B3"):
        fc.coevo_block(jf0.float(), vf0.float(), g, b, params, 8, 2)
    args = _chain_args(np.random.default_rng(9), dev, 1, V=460,
                       bf=torch.float32)
    with torch.no_grad(), pytest.raises(NotImplementedError,
                                        match="ROADMAP.md B3"):
        fc.coevo_chain(*args, 8, 2)


def test_coevo_kernels_refuse_a_vertex_stream_over_shared_memory():
    """Both coevo libraries plan the same shared memory; 460 vertices are
    over sm_90's limit, and the whole block raises naming ROADMAP (JAX's
    kernel takes them) instead of running its plain version."""
    dev = _card()
    for V in (48, 431, 460):
        assert _cuda.COEVO_BLOCK.query("pmce_coevo_block_smem_bytes", V) \
            == _cuda.CHAIN.query("pmce_chain_smem_bytes", V)
    jf0, vf0, g, b, params = _coevo_block_args(np.random.default_rng(5),
                                               dev, 1, V=460)
    with pytest.raises(NotImplementedError, match="shared memory"):
        fc.coevo_block(jf0, vf0, g, b, params, 8, 2)


# ------------------------------------- reproducible Stage-2 gradients (C2)
def _stage2_case(dev, fused: bool):
    """A PMCE at the kernels' widths (lifter 256, decoder 64, 431 coarse
    vertices), depth 1, GRU 64, over a 2000-vertex stand-in mesh, bf16, its
    weights and a batch of 8 from seeds."""
    from pmce_tpu_torch.core.losses import build_face_losses
    from pmce_tpu_torch.models.pmce import PMCE
    from pmce_tpu_torch.smpl.artifacts import synthetic_artifacts

    Jm, Bm, NV, V = 17, 8, 431, 2000
    rng = np.random.default_rng(11)
    art = synthetic_artifacts(seed=0, num_verts=V, num_faces=3000)
    vj = tuple(int(i) for i in rng.integers(0, Jm, size=NV))
    model = PMCE(num_joint=Jm, vj_relation=vj, embed_dim=256, depth=1,
                 num_vertx=NV, num_verts_full=V, gru_hidden=64,
                 dtype=torch.bfloat16, fused=fused)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(dev).train()

    def r(*s, scale=1.0):
        return torch.from_numpy((rng.normal(size=s) * scale).astype(
            np.float32)).to(dev)

    def mask(*s):
        return torch.from_numpy((rng.random(s) > 0.2).astype(
            np.float32)).to(dev)

    batch = {"pose2d": r(Bm, 16, Jm, 2), "img_feature": r(Bm, 16, 2048),
             "mesh": r(Bm, V, 3, scale=0.3),
             "lift_pose3d": r(Bm, Jm, 3, scale=300),
             "reg_pose3d": r(Bm, 17, 3, scale=300),
             "mesh_valid": mask(Bm, 1, 1),
             "lift_pose3d_valid": mask(Bm, Jm, 1),
             "reg_pose3d_valid": mask(Bm, 17, 1)}
    jr = torch.from_numpy(art.J_regressor[:17].astype(np.float32)).to(dev)
    faces = torch.as_tensor(art.faces, dtype=torch.long, device=dev)
    return model, batch, jr, faces, build_face_losses(art.faces, V, dev)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_stage2_first_step_gradients_are_reproducible(fused):
    """Two first Stage-2 steps (same weights, batch and drop-path masks) give
    the same gradients bit for bit. On failure the message lists each
    parameter's largest difference."""
    from pmce_tpu_torch.core.trainer import pmce_loss

    dev = _card()
    model, batch, jr, faces, face_fn = _stage2_case(dev, fused)
    runs = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        loss, _ = pmce_loss(model, batch, faces, jr, (0.1, 20.0, 1e-3), 1.0,
                            face_fn, torch.Generator(dev).manual_seed(7))
        loss.backward()
        runs.append((loss.detach().clone(),
                     {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None}))
    (l1, g1), (l2, g2) = runs
    differ = {n: float((g1[n].float() - g2[n].float()).abs().max())
              for n in g1 if not torch.equal(g1[n], g2[n])}
    print(f"fused={fused}: {len(differ)} of {len(g1)} gradients differ "
          f"between two runs: {differ}")
    assert torch.equal(l1, l2)
    assert not differ, differ


# ----------------------------------------------------- shape gates (C3)
def test_fused_lifter_at_seqlen_48_runs_and_agrees_with_plain():
    """At T = 48, where the JAX package runs its kernels too, the fused
    bf16 lifter runs on the card's kernels: the trunk in eval mode, every
    block forward and backward (17 and 48 tokens) in training mode; both
    agree with the all-plain path (training: every gradient within 3 %, as
    chip_smoke.py's first-step band)."""
    import contextlib

    from pmce_tpu_torch.models.pose_lifter import create_pose_lifter

    dev = _card()
    rng = np.random.default_rng(12)
    pose2d = torch.from_numpy(rng.standard_normal(
        (4, 48, 17, 2), dtype=np.float32)).to(dev)
    feat = torch.from_numpy(rng.standard_normal(
        (4, 48, 2048), dtype=np.float32)).to(dev)
    model = create_pose_lifter(num_frames=48, embed_dim=256, depth=2,
                               dtype=torch.bfloat16, fused=True, device=dev)
    _cuda.reset_launch_counts()
    with torch.no_grad():
        out = model(pose2d, feat)
        with mock.patch.object(fa, "lifter_trunk", fa.lifter_trunk_plain):
            want = model(pose2d, feat)
    assert _cuda.launch_counts()["lifter_trunk"] == 1
    assert bool(torch.isfinite(out).all()) and _rel(want, out) < 0.03

    model.train()
    grads = []
    for patch in (None, fa.transformer_block_plain):
        model.zero_grad(set_to_none=True)
        ctx = (mock.patch.object(fa, "transformer_block", patch) if patch
               else contextlib.nullcontext())
        _cuda.reset_launch_counts()
        with ctx:
            y = model(pose2d, feat, torch.Generator(dev).manual_seed(3))
            y.square().mean().backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
        if patch is None:
            counts = _cuda.launch_counts()
            assert counts["block_fwd"] == counts["block_bwd"] == 4
    for n, g in grads[1].items():
        assert _rel(g, grads[0][n]) < 0.03, n


# ------------------------- the redesigned trunk (K1) and block program (K3)
def _trunk_args(rng, dev, B, T, J, depth, C=256, hid=512):
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
    return (r(B, T * J, C, dtype=torch.bfloat16), params,
            (r(C, scale=0.1, offset=1.0), r(C, scale=0.1)),
            (r(C, scale=0.1, offset=1.0), r(C, scale=0.1)),
            r(T, C, scale=0.1), T, J, depth, 8)


@pytest.mark.parametrize("B,T,J,depth", [(256, 16, 19, 3), (5, 16, 19, 1),
                                         (7, 16, 17, 1)],
                         ids=["serving", "ragged-19", "ragged-17"])
def test_trunk_block_route_matches_plain(B, T, J, depth):
    """The one-launch-per-block trunk (tiles of whole groups) within 3 % of
    the plain version, one launch of its counter and none of the long
    route, and a rerun bit for bit: at the serving batch and at batches
    whose last spatial and temporal tiles are ragged (5 x 16 frames in
    tiles of 6, 5 x 19 joint columns in tiles of 8; 7 x 17 columns). The
    widened group sizes are test_trunk_kernel_takes_groups_over_32_tokens's."""
    dev = _card()
    args = _trunk_args(np.random.default_rng(B * 1000 + T + J), dev, B, T, J,
                       depth)
    assert fa.trunk_route(T, J) == "block"
    _cuda.reset_launch_counts()
    with torch.no_grad():
        got = fa.lifter_trunk(*args)
        again = fa.lifter_trunk(*args)
        want = fa.lifter_trunk_plain(*args)
    counts = _cuda.launch_counts()
    assert counts["lifter_trunk"] == 2 and counts["lifter_trunk_long"] == 0
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    assert _rel(want, got) < 0.03


def test_trunk_long_route_takes_groups_over_the_tile():
    """Temporal groups of 130 frames (over the block kernel's 128-row tile)
    take the long route: its own counter, within 3 % of plain, a rerun bit
    for bit."""
    dev = _card()
    args = _trunk_args(np.random.default_rng(130), dev, 2, 130, 3, 1)
    assert fa.trunk_route(130, 3) == "long"
    _cuda.reset_launch_counts()
    with torch.no_grad():
        got = fa.lifter_trunk(*args)
        again = fa.lifter_trunk(*args)
        want = fa.lifter_trunk_plain(*args)
    counts = _cuda.launch_counts()
    assert counts["lifter_trunk_long"] == 2 and counts["lifter_trunk"] == 0
    assert torch.equal(got, again)
    assert _rel(want, got) < 0.03


def test_serving_trunk_takes_the_block_route():
    """The bf16 fused lifter at the serving shapes (T = 16, J = 19) launches
    the block route once per forward and never the long route."""
    from pmce_tpu_torch.models.pose_lifter import create_pose_lifter

    dev = _card()
    rng = np.random.default_rng(16)
    pose2d = torch.from_numpy(rng.standard_normal(
        (4, 16, 19, 2), dtype=np.float32)).to(dev)
    feat = torch.from_numpy(rng.standard_normal(
        (4, 16, 2048), dtype=np.float32)).to(dev)
    model = create_pose_lifter(num_joints=19, embed_dim=256, depth=3,
                               dtype=torch.bfloat16, fused=True, device=dev)
    model.eval()
    _cuda.reset_launch_counts()
    with torch.no_grad():
        model(pose2d, feat)
    counts = _cuda.launch_counts()
    assert counts["lifter_trunk"] == 1 and counts["lifter_trunk_long"] == 0


def test_trunk_stage_split_covers_every_stage():
    """The stamped instantiation books cycles to all eight stages and is
    not counted as a launch of the path."""
    dev = _card()
    args = _trunk_args(np.random.default_rng(8), dev, 3, 16, 19, 1)
    _cuda.reset_launch_counts()
    split = fa.trunk_stage_split(*args)
    assert _cuda.launch_counts()["lifter_trunk"] == 0
    assert tuple(split) == fa.TRUNK_STAGES
    assert all(v > 0 for v in split.values())


@pytest.mark.parametrize("V,J", [(48, 19), (61, 17), (61, 19), (431, 17),
                                 (431, 19), (450, 19)])
def test_coevo_block_and_chain_match_plain_across_widths(V, J):
    """Row 14 and K3 (its per-block program on the tensor cores, the
    chain skipping the joint stages whose outputs the next block
    overwrites) within 2 % of their plain versions at the vertex counts the
    gate takes (48 to 450) and 17 or 19 joints, each rerun bit for bit."""
    dev = _card()
    rng = np.random.default_rng(V * 100 + J)
    bargs = _coevo_block_args(rng, dev, 3, J=J, V=V)
    kp = bargs[4]
    bf = torch.bfloat16

    def t(*s, scale=0.05, dtype=torch.float32):
        return _rand(rng, dev, *s, scale=scale, dtype=dtype)

    blocks = tuple((t(3, 64, dtype=bf), t(64), t(3, 64, dtype=bf), t(64), kp,
                    t(64, 3), t(3), t(64, 3), t(3)) for _ in range(3))
    cargs = (t(3, J, 3, scale=0.3), t(3, V, 3, scale=0.3),
             t(3, 3, 12, 64, scale=0.1), t(3, 3, 12, 64, scale=0.1), blocks)
    with torch.no_grad():
        for kernel, plain, args in ((fc.coevo_block, fc.coevo_block_plain,
                                     bargs),
                                    (fc.coevo_chain, fc.coevo_chain_plain,
                                     cargs)):
            got, again = kernel(*args, 8, 2), kernel(*args, 8, 2)
            want = plain(*args, 8, 2)
            for a, a2, b in zip(got, again, want):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert bool(torch.isfinite(a).all())
                assert torch.equal(a, a2)
                assert _rel(b, a) < 0.02


def test_coevo_stage_split_books_every_stage():
    """The stamped instantiations of K3 and row 14 book cycles to each
    stream's stages (the chain's joint CA and SA only in its last block)
    and are not counted as launches of the path."""
    dev = _card()
    bargs = _coevo_block_args(np.random.default_rng(21), dev, 2)
    cargs = _chain_args(np.random.default_rng(22), dev, 2)
    _cuda.reset_launch_counts()
    block = fc.coevo_stage_split("block", *bargs)
    chain = fc.coevo_stage_split("chain", *cargs)
    counts = _cuda.launch_counts()
    assert counts["coevo_block"] == counts["coevo_chain"] == 0
    for split in (block, chain):
        stages = {stage for stage, _ in split}
        assert {"joint CA", "vertex CA", "joint SA", "vertex SA"} <= stages
        assert all(v > 0 for v in split.values())


def test_rigid_align_on_the_card_matches_the_cpu():
    """Batched Procrustes on the card (cuSOLVER's SVD) against the CPU's
    (LAPACK) on the same inputs, both held to the f64 answer: per half of
    the batch, the card no further from it than twice the CPU's f32
    distance plus one 2^-20 step of the largest coordinate, and PA-MPJPE
    within 1e-4 mm. The reflected half takes the det(R) < 0 branch, whose
    rotation hangs on the smallest singular vectors: f32 moves it by up to
    0.04 mm there (the CPU's own, measured), 0.001 mm on the proper half.
    With TF32 allowed by the caller the result is the same bit for bit and
    the caller's flag comes back."""
    from pmce_tpu_torch.ops.procrustes import rigid_align

    dev = _card()
    rng = np.random.default_rng(40)
    A = rng.normal(scale=300.0, size=(4096, 14, 3))
    B = 1.1 * A + rng.normal(scale=10.0, size=A.shape) + 50.0
    B[::2, :, 0] *= -1
    A = torch.from_numpy(A.astype(np.float32))
    B = torch.from_numpy(B.astype(np.float32))
    exact = rigid_align(A.double(), B.double())
    cpu = rigid_align(A, B)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        card = rigid_align(A.to(dev), B.to(dev))
        torch.backends.cuda.matmul.allow_tf32 = True
        again = rigid_align(A.to(dev), B.to(dev))
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert torch.equal(card, again)
    card = card.cpu().double()
    step = 2.0 ** -20 * float(B.abs().max())
    for half in (slice(0, None, 2), slice(1, None, 2)):
        d_card = float((card[half] - exact[half]).abs().max())
        d_cpu = float((cpu[half].double() - exact[half]).abs().max())
        assert d_card <= 2 * d_cpu + step, (half, d_card, d_cpu)

    def pa(x):
        return float((x - B.double()).norm(dim=-1).mean())

    assert abs(pa(card) - pa(exact)) <= 1e-4


def _plain_kernels():
    """Every kernel of the evaluation path through its plain version: the
    trunk, both GRU directions, the chain and the synthesis' skinning."""
    import contextlib

    from pmce_tpu_torch.smpl import kernels
    from pmce_tpu_torch.smpl.layer import apply_skinning

    stack = contextlib.ExitStack()
    for mod, name, plain in (
            (fa, "lifter_trunk", fa.lifter_trunk_plain),
            (fa, "gru_layer", fa.gru_layer_plain),
            (fa, "gru_layer_rev",
             lambda gi, w, b: fa.gru_layer_plain(gi, w, b, reverse=True)),
            (fa, "gru_bidir", fa.gru_bidir_plain),
            (fc, "coevo_chain", fc.coevo_chain_plain),
            (kernels, "fused_skinning", apply_skinning)):
        stack.enter_context(mock.patch.object(mod, name, plain))
    return stack


def test_test_cli_on_the_card_agrees_with_its_plain_path():
    """``python -m pmce_tpu_torch.main.test`` on the bf16 fused config,
    on the card by default: the kernels of its path launch, and its four
    protocol metrics agree within 2 % (the serving band) with the same run
    through every kernel's plain version, which launches none."""
    from pmce_tpu_torch.main import test as test_cli

    _card()
    cfg = str(Path(__file__).resolve().parent.parent / "configs"
              / "train_mesh_h36m_bf16.yml")
    _cuda.reset_launch_counts()
    got = test_cli.main(["--cfg", cfg])
    counts = _cuda.launch_counts()
    assert all(counts[k] > 0 for k in ("lifter_trunk", "gru_scan",
                                       "coevo_chain", "skinning")), counts
    _cuda.reset_launch_counts()
    with _plain_kernels():
        want = test_cli.main(["--cfg", cfg])
    assert not any(_cuda.launch_counts().values())
    for k in ("mpjpe", "pa_mpjpe", "mpvpe", "accel"):
        a, b = getattr(got, k), getattr(want, k)
        assert math.isfinite(a) and abs(a - b) <= 0.02 * abs(b), (k, a, b)


def test_ddp_and_fsdp_steps_equal_the_plain_step_on_the_card():
    """A small fused bf16 PMCE (embed 256, depth 2, a 600-vertex stand-in,
    GRU hidden 64), one train step on a one-process NCCL world: under DDP
    and under FSDP the same kernels launch as on the plain trainer, and
    the loss and every gradient after the reduction equal the plain
    step's (bit for bit, or within 1e-6 of the largest gradient)."""
    import socket
    import sys

    import torch.distributed as dist

    from pmce_tpu_torch.parallel import distributed, mesh as mesh_lib

    dev = _card()
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_port_parallel_worker as worker

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    assert distributed.initialize(f"tcp://localhost:{port}", 1, 0,
                                  device="cuda")
    try:
        mesh = mesh_lib.create_mesh(1, "cuda")
        data = worker.body()
        res = {}
        for mode in ("plain", "ddp", "fsdp"):
            tr = worker.make_trainer(
                "pmce", data, None if mode == "plain" else mesh,
                fsdp=mode == "fsdp", device=dev, dtype=torch.bfloat16,
                embed=256)
            state = tr.init_state()
            _cuda.reset_launch_counts()
            out = worker.step(tr, state, 1)
            torch.cuda.synchronize()
            res[mode] = (out, _cuda.launch_counts())
        want, counts = res["plain"]
        assert counts["block_fwd"] > 0 and counts["gru_layer_save"] > 0
        largest = max(float(g.abs().max()) for g in want["grads"].values()
                      if g is not None)
        for mode in ("ddp", "fsdp"):
            got, got_counts = res[mode]
            assert got_counts == counts, mode
            assert abs(got["loss"] - want["loss"]) <= 1e-6 * abs(
                want["loss"]), mode
            for n, g in want["grads"].items():
                h = got["grads"][n]
                assert (g is None) == (h is None), (mode, n)
                if g is not None:
                    assert float((h - g).abs().max()) <= 1e-6 * largest, (
                        mode, n)
    finally:
        dist.destroy_process_group()
