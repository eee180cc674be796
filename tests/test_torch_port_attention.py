"""The port's decoder attention blocks against the JAX kernels, on the CPU.

``fused_mhsa``, ``ada_block`` and ``ca_block`` (on CPU tensors: the plain
versions ``mhsa_plain``, ``ada_block_plain``, ``ca_block_plain`` and
PyTorch's autograd of them) against JAX ``fused_mhsa``, ``fused_ada_block``
and ``fused_ca_block`` with their custom VJPs — the Pallas kernels of
kernel table rows 4, 5 and 8-11, interpreted on the CPU. Then the trunk's
gradient as the card computes it (``trunk_recompute``: attention through
``fused_mhsa``) against ``jax.vjp`` of ``fused_lifter_trunk``. The fused
decoder that runs these blocks is held to JAX's in
``test_torch_port_fused_decoder.py``.

Width 32, hidden 64, 3 clips; N = 17 (JAX's grouped MHSA) and 72 (> 64:
its one-clip MHSA, the AdaLN block), cross-attention both ways, (5, 72) and
(72, 5). Inputs, weights, per-clip branch masks and cotangents come from
numpy with a seed and go to both sides. Bounds are max|port - jax| /
max|jax| per output and per gradient:

- f32: 1e-4 (the same math; summation order, the AdaLN variance formula
  and JAX's erf polynomial differ).
- bf16: the JAX kernels' bf16 path takes tanh-GELU and its gradient, merged
  heads and other rounding points where the port keeps the plain math, so
  the band is pinned at about twice the largest value measured over these
  cases (values 0.0062, gradients 0.0102).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmce_tpu.ops.fused_attention import (
    fused_ada_block,
    fused_ca_block,
    fused_lifter_trunk,
    fused_mhsa,
)
from pmce_tpu_torch.ops import fused_attention as fa

C, HID, B = 32, 64, 3
F32_BOUND = 1e-4
BF16_BOUND = {"y": 0.013, "grad": 0.02}
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _rng_w(rng):
    def w(*shape, scale=0.2, offset=0.0):
        return (rng.normal(size=shape) * scale + offset).astype(np.float32)
    return w


def _masks(rng):
    """Per-clip {0, 1.25} scales; clip 0 drops the attention branch, clip 1
    the MLP branch, so both values of each mask occur."""
    u = rng.random((2, B, 1, 1))
    u[0, 0], u[1, 1] = 1.0, 1.0
    return tuple(((u[i] < 0.8) / 0.8).astype(np.float32) for i in range(2))


def _compare(want: dict, got: dict, bound: dict | float, zero=()):
    """Each output against its own largest magnitude; the gradients in
    ``zero``, zero analytically (the keys' bias and AdaLN β: one vector
    added to every key, which the softmax ignores) and so rounding noise on
    both sides, against the largest gradient."""
    largest = max(np.abs(a).max() for k, a in want.items() if k != "y")
    for k, a in want.items():
        a = np.asarray(a, np.float32)
        lim = bound if isinstance(bound, float) else (
            bound["y"] if k == "y" else bound["grad"])
        scale = largest if k in zero else np.abs(a).max()
        assert np.abs(got[k] - a).max() / scale <= lim, k


def _run(jax_fn, port_fn, arrays, g, dtype):
    """Value and gradients of every array on both sides, the first array
    (the tokens) cast to the compute dtype inside."""
    jdt, tdt = DT[dtype]
    ja = [jnp.asarray(a) for a in arrays]
    y, vjp = jax.vjp(jax_fn, *ja)
    grads = vjp(jnp.asarray(g).astype(jdt))
    want = {"y": np.asarray(y.astype(jnp.float32))}
    want.update({f"d{i}": np.asarray(d) for i, d in
                 enumerate(jax.tree_util.tree_leaves(grads))})
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = port_fn(*leaves)
    out.backward(torch.from_numpy(g).to(tdt))
    got = {"y": out.detach().float().numpy()}
    got.update({f"d{i}": t.grad.float().numpy()
                for i, t in enumerate(leaves)})
    return want, got


# ------------------------------------------------------------- row 4/5
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("N", [17, 72])
def test_mhsa_matches_jax(N, dtype):
    rng = np.random.default_rng(N)
    w = _rng_w(rng)
    H = 4
    arrays = [w(B, N, C, scale=1.0), w(C, 3 * C, scale=C ** -0.5),
              w(3 * C, scale=0.05), w(C, C, scale=C ** -0.5),
              w(C, scale=0.05)]
    g = w(B, N, C, scale=1.0)
    jdt, tdt = DT[dtype]
    want, got = _run(
        lambda x, *p: fused_mhsa(x.astype(jdt), *p, H),
        lambda x, *p: fa.fused_mhsa(x.to(tdt), *p, H), arrays, g, dtype)
    _compare(want, got, F32_BOUND if dtype == "f32" else BF16_BOUND)


# ------------------------------------------------------------- row 8/9
def _ada_case(seed):
    rng = np.random.default_rng(seed)
    w = _rng_w(rng)
    N = 72
    x = w(B, N, C, scale=1.0)
    conds = [w(B, C, scale=0.2, offset=1.0), w(B, C, scale=0.2),
             w(B, C, scale=0.2, offset=1.0), w(B, C, scale=0.2)]
    params = [w(C, 3 * C, scale=C ** -0.5), w(3 * C, scale=0.05),
              w(C, C, scale=C ** -0.5), w(C, scale=0.05),
              w(C, HID, scale=C ** -0.5), w(HID, scale=0.05),
              w(HID, C, scale=HID ** -0.5), w(C, scale=0.05)]
    return [x, *conds, *params], _masks(rng), w(B, N, C, scale=1.0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("masks", [False, True], ids=["nomask", "masks"])
def test_ada_block_matches_jax(masks, dtype):
    arrays, bm, g = _ada_case(30 + masks)
    H = 2
    jdt, tdt = DT[dtype]
    jm = tuple(jnp.asarray(m) for m in bm) if masks else None
    tm = tuple(torch.from_numpy(m) for m in bm) if masks else None
    want, got = _run(
        lambda x, g1, b1, g2, b2, *p: fused_ada_block(
            x.astype(jdt), g1, b1, g2, b2, p, H, 1e-6, jm),
        lambda x, g1, b1, g2, b2, *p: fa.ada_block(
            x.to(tdt), g1, b1, g2, b2, p, H, 1e-6, tm),
        arrays, g, dtype)
    _compare(want, got, F32_BOUND if dtype == "f32" else BF16_BOUND)


# ----------------------------------------------------------- row 10/11
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(5, 72, 4), (72, 5, 2)],
                         ids=["joints-query", "vertices-query"])
def test_ca_block_matches_jax(shape, dtype):
    Nq, Nk, H = shape
    rng = np.random.default_rng(Nq)
    w = _rng_w(rng)
    xs = [w(B, Nq, C, scale=1.0), w(B, Nk, C, scale=1.0),
          w(B, Nk, C, scale=1.0)]
    conds = [w(B, C, scale=0.2, offset=1.0 - (i % 2)) for i in range(8)]
    params = []
    for n in (C, C, C, C):
        params += [w(n, C, scale=n ** -0.5), w(C, scale=0.05)]
    params += [w(C, HID, scale=C ** -0.5), w(HID, scale=0.05),
               w(HID, C, scale=HID ** -0.5), w(C, scale=0.05)]
    bm = _masks(rng)
    g = w(B, Nq, C, scale=1.0)
    jdt, tdt = DT[dtype]
    jm = tuple(jnp.asarray(m) for m in bm)
    tm = tuple(torch.from_numpy(m) for m in bm)

    def split(a):
        # (gq, bq, gk, bk, gv, bv, g2, b2) → gammas, betas
        return tuple(a[0::2]), tuple(a[1::2])

    want, got = _run(
        lambda xq, xk, xv, *r: fused_ca_block(
            xq.astype(jdt), xk.astype(jdt), xv.astype(jdt), *split(r[:8]),
            r[8:], H, 1e-6, jm),
        lambda xq, xk, xv, *r: fa.ca_block(
            xq.to(tdt), xk.to(tdt), xv.to(tdt), *split(r[:8]), r[8:], H,
            1e-6, tm),
        [*xs, *conds, *params], g, dtype)
    # d6: normk's β; d14: wk's bias.
    _compare(want, got, F32_BOUND if dtype == "f32" else BF16_BOUND,
             zero=("d6", "d14"))


# ------------------------------------------------- the trunk's gradient
@pytest.mark.parametrize("fn", ["lifter_trunk", "trunk_recompute"])
def test_trunk_gradient_matches_jax_vjp(fn):
    """The trunk's gradient: the CPU wrapper's (autograd of the plain
    trunk) and the card's recompute (attention through ``fused_mhsa``)
    against ``jax.vjp`` of ``fused_lifter_trunk`` (interpreted)."""
    T, J, depth, H = 4, 6, 1, 4     # the JAX trunk takes T·J % 8 == 0
    rng = np.random.default_rng(40)
    w = _rng_w(rng)

    def block():
        return [w(C, scale=0.1, offset=1.0), w(C, scale=0.1),
                w(C, 3 * C, scale=C ** -0.5), w(3 * C, scale=0.05),
                w(C, C, scale=C ** -0.5), w(C, scale=0.05),
                w(C, scale=0.1, offset=1.0), w(C, scale=0.1),
                w(C, HID, scale=C ** -0.5), w(HID, scale=0.05),
                w(HID, C, scale=HID ** -0.5), w(C, scale=0.05)]

    flat = [w(B, T * J, C, scale=1.0), *block(), *block(),
            w(C, scale=0.1, offset=1.0), w(C, scale=0.1),
            w(C, scale=0.1, offset=1.0), w(C, scale=0.1), w(T, C)]
    g = w(B, T * J, C, scale=1.0)

    def unflat(a):
        return (a[0], (tuple(a[1:13]), tuple(a[13:25])), tuple(a[25:27]),
                tuple(a[27:29]), a[29])

    port = getattr(fa, fn)
    want, got = _run(
        lambda *a: fused_lifter_trunk(*unflat(a), T, J, depth, H),
        lambda *a: port(*unflat(a), T, J, depth, H), flat, g, "f32")
    _compare(want, got, F32_BOUND)
