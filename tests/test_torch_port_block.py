"""The port's transformer block against the JAX fused block, on the CPU.

``transformer_block`` (which on a CPU tensor runs the plain version,
``transformer_block_plain``, and PyTorch's autograd of it) against JAX
``fused_transformer_block`` and its custom VJP — the Pallas kernels
``_block_kernel`` / ``_block_bwd_kernel``, interpreted on the CPU. Width 32,
4 heads, hidden 64; masks on and off, post-norm on and off, N = 16 and 17
tokens a clip. Inputs, weights, masks and the output cotangent come from
numpy with a seed and go to both sides.

Bounds are max|port - jax| / max|jax| for y, dx, each of the 14 parameter
gradients and the two per-clip mask gradients:

- f32: 1e-4. The two sides compute the same f32 math; they differ in
  summation order, in the LayerNorm variance formula (E[x²]−E[x]² in the
  kernel, centred in the port) and in erf (a 1.5e-7 polynomial in the
  kernel).
- bf16: the JAX kernel's bf16 path runs tanh-GELU and its gradient where
  the port keeps the exact erf GELU, and rounds intermediates at other
  places; the band is pinned at about twice the largest value measured
  over these cases (0.0069 for y, 0.0079 for the gradients).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmce_tpu.ops.fused_attention import fused_transformer_block
from pmce_tpu_torch.ops import _cuda
from pmce_tpu_torch.ops import fused_attention as fa

from torch_port_common import rel_max_err

C, H, HID, B = 32, 4, 64, 6
F32_BOUND = 1e-4
BF16_BOUND = {"y": 0.015, "grad": 0.016}


def _case(seed: int, N: int, post: bool, masks: bool):
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.2, offset=0.0):
        return (rng.normal(size=shape) * scale + offset).astype(np.float32)

    params = [w(C, scale=0.1, offset=1.0), w(C, scale=0.1),
              w(C, 3 * C, scale=C ** -0.5), w(3 * C, scale=0.05),
              w(C, C, scale=C ** -0.5), w(C, scale=0.05),
              w(C, scale=0.1, offset=1.0), w(C, scale=0.1),
              w(C, HID, scale=C ** -0.5), w(HID, scale=0.05),
              w(HID, C, scale=HID ** -0.5), w(C, scale=0.05)]
    params += ([w(C, scale=0.1, offset=1.0), w(C, scale=0.1)] if post
               else [None, None])
    bm = None
    if masks:
        keep = 0.8
        # Clip 0 drops its attention branch, clip 1 its MLP branch; the
        # rest draw, so both values of each mask occur.
        u = rng.random((2, B, 1, 1))
        u[0, 0], u[1, 1] = 1.0, 1.0
        bm = tuple(((u[i] < keep) / keep).astype(np.float32)
                   for i in range(2))
    x = w(B, N, C, scale=1.0)
    g = w(B, N, C, scale=1.0)
    return x, params, bm, g


def _jax(x, params, bm, g, dtype):
    def f(x, p, m):
        return fused_transformer_block(x.astype(dtype), p, H, 1e-6, 1e-6, m)

    jp = tuple(None if p is None else jnp.asarray(p) for p in params)
    jm = None if bm is None else tuple(jnp.asarray(m) for m in bm)
    y, vjp = jax.vjp(f, jnp.asarray(x), jp, jm)
    dx, dp, dm = vjp(jnp.asarray(g).astype(dtype))
    out = {"y": y, "dx": dx}
    out.update({f"d{i}": d for i, d in enumerate(dp) if d is not None})
    if dm is not None:
        out.update({"dm1": dm[0], "dm2": dm[1]})
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _port(x, params, bm, g, dtype):
    tp = [None if p is None else torch.from_numpy(p).requires_grad_(True)
          for p in params]
    tx = torch.from_numpy(x).requires_grad_(True)
    tm = None if bm is None else tuple(
        torch.from_numpy(m).requires_grad_(True) for m in bm)
    _cuda.reset_launch_counts()
    y = fa.transformer_block(tx.to(dtype), tuple(tp), H, 1e-6, 1e-6, tm)
    assert y.dtype == dtype and y.shape == tx.shape
    leaves = [tx] + [p for p in tp if p is not None] + list(tm or ())
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(g).to(dtype))
    assert not any(_cuda.launch_counts().values())  # the plain version ran
    names = ["dx"] + [f"d{i}" for i, p in enumerate(tp) if p is not None]
    names += ["dm1", "dm2"] if tm is not None else []
    out = {"y": y}
    out.update(dict(zip(names, grads)))
    return {k: v.detach().float().numpy() for k, v in out.items()}


CASES = [(16, True, True), (17, True, False), (17, False, True),
         (16, False, False)]


@pytest.mark.parametrize("N,post,masks", CASES,
                         ids=[f"N{n}-post{int(p)}-masks{int(m)}"
                              for n, p, m in CASES])
def test_block_plain_matches_jax_fused_block_f32(N, post, masks):
    case = _case(N + 2 * post + 4 * masks, N, post, masks)
    want = _jax(*case, jnp.float32)
    got = _port(*case, torch.float32)
    assert set(got) == set(want)
    assert len(want) == 2 + (14 if post else 12) + (2 if masks else 0)
    for name in want:
        assert got[name].shape == want[name].shape, name
        err = rel_max_err(want[name], got[name])
        assert err <= F32_BOUND, (name, err)


@pytest.mark.parametrize("N,post,masks", CASES,
                         ids=[f"N{n}-post{int(p)}-masks{int(m)}"
                              for n, p, m in CASES])
def test_block_plain_matches_jax_fused_block_bf16(N, post, masks):
    case = _case(10 + N, N, post, masks)
    want = _jax(*case, jnp.bfloat16)
    got = _port(*case, torch.bfloat16)
    assert set(got) == set(want)
    for name in want:
        err = rel_max_err(want[name], got[name])
        bound = BF16_BOUND["y" if name == "y" else "grad"]
        assert err <= bound, (name, err)


def test_block_entry_takes_plain_math_beyond_64_tokens():
    """For N > 64 the JAX entry runs plain XLA and so does the port's (on
    any device); the result is the plain version's."""
    x, params, bm, _ = _case(3, 65, True, True)
    tx = torch.from_numpy(x)
    tp = tuple(None if p is None else torch.from_numpy(p) for p in params)
    tm = tuple(torch.from_numpy(m) for m in bm)
    got = fa.transformer_block(tx, tp, H, branch_masks=tm)
    want = fa.transformer_block_plain(tx, tp, H, branch_masks=tm)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_block_entry_rejects_devices_without_a_kernel():
    """A tensor on neither the CPU nor the card raises; nothing falls back
    to the plain version."""
    params = tuple(torch.empty(s, device="meta") for s in
                   ((256,), (256,), (256, 768), (768,), (256, 256), (256,),
                    (256,), (256,), (256, 512), (512,), (512, 256),
                    (256,))) + (None, None)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.transformer_block(
            torch.empty(4, 16, 256, dtype=torch.bfloat16, device="meta"),
            params, 8)
