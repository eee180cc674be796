"""Each kernel module of the PyTorch port against the JAX package.

On the CPU every wrapper runs its plain PyTorch version; these tests hold
that version against the JAX oracle in f32 (the algorithm) and against the
JAX Pallas kernel in bf16 (interpreted off-TPU, as the JAX package's own
tests run it). The kernels themselves are held against the plain versions
on the card (tests/test_torch_port_gpu.py, and ``chip_smoke.py`` at full
size).

bf16 bounds are regression pins measured on the port, in the manner of
tests/test_bf16_canary.py: ``max|port - jax| / max|jax|``, bound ≈ 2× the
measured value. They are bf16 bands, not 1e-4, because the Pallas kernels
keep TPU workarounds the port does not (tanh-GELU, ``exp(min(s, 30))``
without a max-shift, MXU-rounded statistics) and round at a few other
points (e.g. the GRU oracle's bf16 ``h @ Whh`` output).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmce_tpu.ops import fused_attention as jfa
from pmce_tpu.ops import fused_coevo_chain as jfc
from pmce_tpu_torch.ops import _cuda
from pmce_tpu_torch.ops import fused_attention as fa
from pmce_tpu_torch.ops import fused_coevo_chain as fc

from torch_port_common import rel_max_err

BF16 = jnp.bfloat16


def _j(tree, dtype=None):
    """numpy tree → jax arrays (optionally cast)."""
    if isinstance(tree, tuple):
        return tuple(_j(t, dtype) for t in tree)
    return jnp.asarray(tree, dtype)


def _t(tree, dtype=torch.float32):
    """numpy tree → torch tensors (values already exact in ``dtype``)."""
    if isinstance(tree, tuple):
        return tuple(_t(t, dtype) for t in tree)
    return torch.from_numpy(np.asarray(tree, np.float32)).to(dtype)


# ------------------------------------------------------------ lifter trunk
T, J = 16, 19


def _trunk_case(seed, B=2, C=64, hid=128, depth=2):
    rng = np.random.default_rng(seed)

    def w(*s, scale=0.1, offset=0.0):
        return (rng.normal(size=s) * scale + offset).astype(np.float32)

    params = tuple(
        (w(C, offset=1.0), w(C), w(C, 3 * C, scale=C ** -0.5), w(3 * C),
         w(C, C, scale=C ** -0.5), w(C), w(C, offset=1.0), w(C),
         w(C, hid, scale=C ** -0.5), w(hid), w(hid, C, scale=hid ** -0.5),
         w(C))
        for _ in range(2 * depth))
    return (w(B, T * J, C, scale=1.0), params, (w(C, offset=1.0), w(C)),
            (w(C, offset=1.0), w(C)), w(T, C), depth)


def test_trunk_plain_matches_jax_reference_f32():
    x, params, ns, nt, tpe, depth = _trunk_case(0)
    want = jfa.lifter_trunk_reference(_j(x), _j(params), _j(ns), _j(nt),
                                      _j(tpe), T, J, depth, 8)
    got = fa.lifter_trunk(_t(x), _t(params), _t(ns), _t(nt), _t(tpe), T, J,
                          depth, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_trunk_plain_matches_pallas_kernel_bf16():
    x, params, ns, nt, tpe, depth = _trunk_case(1)
    want = jfa.fused_lifter_trunk(_j(x, BF16), _j(params), _j(ns), _j(nt),
                                  _j(tpe), T, J, depth, 8)
    got = fa.lifter_trunk(_t(x, torch.bfloat16), _t(params), _t(ns), _t(nt),
                          _t(tpe), T, J, depth, 8)
    assert got.dtype == torch.bfloat16
    # Measured 0.0118: tanh-GELU and the clamped softmax in the Pallas
    # kernel vs erf-GELU and the max-stabilised softmax here, through 4
    # LayerNorm'd blocks of bf16 activations.
    assert rel_max_err(want, got.float().numpy()) < 0.025


# ---------------------------------------------------------------- GRU scan
def _gru_case(seed, steps=7, B=8, H=32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(steps, B, 3 * H)).astype(np.float32),
            (rng.normal(size=(H, 3 * H)) * 0.2).astype(np.float32),
            (rng.normal(size=(3 * H,)) * 0.2).astype(np.float32))


def test_gru_plain_matches_jax_reference_f32():
    gi, whh, bhh = _gru_case(0)
    want = jfa.gru_layer_scan_reference(_j(gi), _j(whh), _j(bhh))
    got = fa.gru_layer(_t(gi), _t(whh), _t(bhh))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_gru_rev_plain_matches_jax_reference_f32():
    gi, whh, bhh = _gru_case(1)
    want = jfa.gru_layer_scan_reference(_j(gi)[::-1], _j(whh),
                                        _j(bhh))[::-1]
    got = fa.gru_layer_rev(_t(gi), _t(whh), _t(bhh))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_gru_plain_matches_pallas_kernel_bf16(reverse):
    gi, whh, bhh = _gru_case(2 + reverse, steps=9)
    jk = jfa.fused_gru_layer_rev if reverse else jfa.fused_gru_layer
    pk = fa.gru_layer_rev if reverse else fa.gru_layer
    want = jk(_j(gi, BF16), _j(whh), _j(bhh))
    got = pk(_t(gi, torch.bfloat16), _t(whh), _t(bhh))
    assert got.dtype == torch.bfloat16
    # Same math (f32 carry, f32 sums of bf16 operands, torch gate math);
    # measured bit-identical. Bound: one bf16 ulp of |h| < 1 (2^-8), the
    # most a last-bit difference of sigmoid/tanh can move a rounded ys.
    assert rel_max_err(want, got.float().numpy()) < 0.005


# ------------------------------------------------------------ decoder chain
CJ, CV, CC, NB = 19, 61, 64, 2


def _chain_case(seed, B):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.05):
        return rng.normal(size=shape, scale=scale).astype(np.float32)

    def ca():
        return (t(CC, CC), t(CC), t(CC, CC), t(CC), t(CC, CC), t(CC),
                t(CC, CC), t(CC), t(CC, 4 * CC), t(4 * CC), t(4 * CC, CC),
                t(CC))

    def sa():
        return (t(CC, 3 * CC), t(3 * CC), t(CC, CC), t(CC),
                t(CC, 4 * CC), t(4 * CC), t(4 * CC, CC), t(CC))

    blocks = tuple(
        (t(3, CC), t(CC), t(3, CC), t(CC),
         (t(CJ, CC), t(CV, CC), t(CJ, CC), t(CV, CC), t(CV, CC), t(CJ, CC),
          t(CC, CC), t(CC), t(CC, CC), t(CC), ca(), ca(), sa(), sa()),
         t(CC, 3), t(3), t(CC, 3), t(3))
        for _ in range(NB))
    inputs = (t(B, CJ, 3, scale=0.3), t(B, CV, 3, scale=0.3),
              t(B, NB, 12, CC, scale=0.1), t(B, NB, 12, CC, scale=0.1))
    return inputs, blocks


def _cast_block_proj(blocks, to):
    """The compute dtype rides on the 3 → C projection weights."""
    return tuple((to(b[0]),) + b[1:2] + (to(b[2]),) + b[3:] for b in blocks)


def test_chain_plain_matches_jax_reference_f32():
    inputs, blocks = _chain_case(0, 3)
    want = jfc.coevo_chain_reference(*_j(inputs), _j(blocks), 8, 2)
    got = fc.coevo_chain(*_t(inputs), _t(blocks), 8, 2)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=2e-4, atol=2e-4)


def test_chain_plain_matches_pallas_kernel_bf16():
    inputs, blocks = _chain_case(1, 4)
    want = jfc.fused_coevo_chain(
        *_j(inputs), _cast_block_proj(_j(blocks), lambda a: a.astype(BF16)),
        8, 2)
    got = fc.coevo_chain(
        *_t(inputs),
        _cast_block_proj(_t(blocks), lambda a: a.to(torch.bfloat16)), 8, 2)
    # Measured 0.00022 / 0.00069 (joints / vertices): the Pallas kernel's
    # tanh-GELU and clamped, unshifted softmax vs erf-GELU and the
    # max-stabilised f32 softmax, through two blocks of bf16 activations.
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert rel_max_err(b, a.numpy()) < 0.0015


# --------------------------------------------------------------- dispatch
def test_wrappers_run_plain_versions_on_cpu_without_counting():
    _cuda.reset_launch_counts()
    gi, whh, bhh = _gru_case(4)
    args = (_t(gi), _t(whh), _t(bhh))
    assert torch.equal(fa.gru_layer(*args), fa.gru_layer_plain(*args))
    assert torch.equal(fa.gru_layer_rev(*args),
                       fa.gru_layer_plain(*args, reverse=True))
    assert set(_cuda.launch_counts()) >= {
        "lifter_trunk", "gru_layer", "gru_layer_rev", "coevo_chain"}
    assert all(n == 0 for n in _cuda.launch_counts().values())


def test_wrappers_reject_devices_without_a_kernel():
    gi = torch.empty(3, 8, 96, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.gru_layer(gi, torch.empty(32, 96), torch.empty(96))
    x = torch.empty(2, T * J, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.lifter_trunk(x, (), None, None, None, T, J, 0, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        fc.coevo_chain(torch.empty(2, CJ, 3, device="meta"), None, None,
                       None, ())


def test_kernel_paths_refuse_f32_compute():
    """The kernels take bf16; f32 is never quietly run another way."""
    inputs, blocks = _chain_case(2, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fc._coevo_chain_cuda(*_t(inputs), _t(blocks), 8, 2, 1e-6)
    gi, whh, bhh = _gru_case(5)
    with pytest.raises(NotImplementedError):
        fa._gru_layer_cuda(_t(gi), _t(whh), _t(bhh), False)
    x, params, ns, nt, tpe, depth = _trunk_case(3)
    with pytest.raises(NotImplementedError):
        fa._lifter_trunk_cuda(_t(x), _t(params), _t(ns), _t(nt), _t(tpe),
                              T, J, depth, 8, 1e-6)
