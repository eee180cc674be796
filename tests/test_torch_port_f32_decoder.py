"""The decoder's AdaLN and CA blocks in f32 (rows 8f-11f) on the card's
routes, on the CPU.

The kernels themselves run only on the card; here the card is stood in
for (``_on_card`` true, every launch recorded instead of run):

- f32 ``ada_block`` / ``ca_block`` without a gradient, with one, with
  branch masks and with masks that require grad reach their f32 programs:
  with nothing owed one ``pmce_ada_fwd_f32`` / ``pmce_ca_fwd_f32`` call,
  otherwise ``_AdaF32Kernel`` / ``_CaF32Kernel``, whose backward is one
  ``pmce_ada_bwd_f32`` / ``pmce_ca_bwd_f32`` call; each call's pointer
  table holds the tokens, the AdaLN vectors, the mask rows and the
  parameters on their own f32 storage, and the backward's asks for the
  mask gradients only when they are owed; the bf16 programs and the plain
  versions never run;
- outside the f32 gates (C 128, hid 512, a CA block's short side over
  64; the token count is not gated) the call raises naming ROADMAP.md B3;
  mixed dtypes
  raise ``ValueError``, f16 ``NotImplementedError``; nothing launches.

The kernels' arithmetic against the plain versions: ``slow``
``test_torch_port_f32_cpu_build.py`` (the sources built for the CPU) and
the ``gpu`` tests; the plain versions against JAX:
``test_torch_port_attention.py`` and ``test_torch_port_f32_stage2.py``.
"""

from __future__ import annotations

import ctypes
import math
from unittest import mock

import numpy as np
import pytest
import torch

from pmce_tpu_torch.ops import _cuda
from pmce_tpu_torch.ops import fused_attention as fa

C = 64


def _table(ptr, n):
    arr = ctypes.cast(ptr, ctypes.POINTER(ctypes.c_void_p))
    return [arr[i] for i in range(n)]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _run(fn, *patches):
    """``fn`` with the card stood in for and ``patches`` in place; every
    plain version of the attention blocks raises if called."""
    patches = [mock.patch.object(fa, "_on_card", return_value=True),
               mock.patch.object(_cuda, "check_cuda"),
               mock.patch.object(_cuda, "stream_ptr",
                                 return_value=_cuda.P(None)),
               *(mock.patch.object(fa, name, side_effect=AssertionError(
                   f"{name} ran")) for name in (
                       "ada_block_plain", "ca_block_plain", "mhsa_plain")),
               *patches]
    for p in patches:
        p.start()
    try:
        return fn()
    finally:
        for p in reversed(patches):
            p.stop()


def _w(rng, *shape, scale=0.2, offset=0.0, grad=False):
    a = (rng.normal(size=shape) * scale + offset).astype(np.float32)
    return torch.from_numpy(a).requires_grad_(grad)


def _masks(rng, B, grad):
    return tuple(torch.from_numpy(((rng.random((B, 1, 1)) < 0.8) / 0.8)
                                  .astype(np.float32)).requires_grad_(grad)
                 for _ in range(2))


def _mlp(rng, hid, grad):
    return (_w(rng, C, hid, scale=C ** -0.5, grad=grad),
            _w(rng, hid, scale=0.05, grad=grad),
            _w(rng, hid, C, scale=hid ** -0.5, grad=grad),
            _w(rng, C, scale=0.05, grad=grad))


def _ada_case(seed, B, N, c=C, hid=256, grad=False):
    rng = np.random.default_rng(seed)
    x = _w(rng, B, N, c, scale=1.0, grad=grad)
    gb = tuple(_w(rng, B, c, scale=0.1, offset=1.0 - i % 2, grad=grad)
               for i in range(4))
    params = (_w(rng, c, 3 * c, scale=c ** -0.5, grad=grad),
              _w(rng, 3 * c, scale=0.05, grad=grad),
              _w(rng, c, c, scale=c ** -0.5, grad=grad),
              _w(rng, c, scale=0.05, grad=grad),
              _w(rng, c, hid, scale=c ** -0.5, grad=grad),
              _w(rng, hid, scale=0.05, grad=grad),
              _w(rng, hid, c, scale=hid ** -0.5, grad=grad),
              _w(rng, c, scale=0.05, grad=grad))
    return x, gb, params, rng


def _ca_case(seed, B, Nq, Nk, c=C, hid=256, grad=False):
    rng = np.random.default_rng(seed)
    xs = tuple(_w(rng, B, n, c, scale=1.0, grad=grad) for n in (Nq, Nk, Nk))
    conds = [_w(rng, B, c, scale=0.1, offset=1.0 - i % 2, grad=grad)
             for i in range(8)]
    params = tuple(t for _ in range(4) for t in (
        _w(rng, c, c, scale=c ** -0.5, grad=grad),
        _w(rng, c, scale=0.05, grad=grad))) + (
        _w(rng, c, hid, scale=c ** -0.5, grad=grad),
        _w(rng, hid, scale=0.05, grad=grad),
        _w(rng, hid, c, scale=hid ** -0.5, grad=grad),
        _w(rng, c, scale=0.05, grad=grad))
    return xs, tuple(conds[0::2]), tuple(conds[1::2]), params, rng


# Cases: nothing owed, a gradient owed, masks without a gradient, masks
# that require grad (with every other input's gradient).
ROUTES = {"no-grad": (False, None), "grad": (True, None),
          "masks": (False, "const"), "mask-grad": (True, "grad")}


@pytest.mark.parametrize("case", list(ROUTES))
def test_ada_f32_route_reaches_rows_8f_9f(case):
    """f32 ``ada_block`` at [3, 72, 64] (over 64 tokens: the model's fused
    gate), 2 heads, hid 256: one ``pmce_ada_fwd_f32`` call on x, the four
    AdaLN vectors, the mask rows and the eight parameters' own pointers;
    with a gradient owed one ``pmce_ada_bwd_f32`` call on the same inputs
    and the output's gradient, the mask gradients asked for only when the
    masks require grad; nothing else runs, one count each."""
    grad, masks = ROUTES[case]
    B, N = 3, 72
    x, gb, params, rng = _ada_case(len(case), B, N, grad=grad)
    bm = _masks(rng, B, masks == "grad") if masks else None
    seen = []

    def call(name, table, *rest):
        seen.append((name, _table(table, 24 if "bwd" in name else 17),
                     rest))

    g = torch.randn(B, N, C)
    leaves = [t for t in (x, *gb, *params, *(bm or ())) if t.requires_grad]
    _cuda.reset_launch_counts()

    def step():
        y = fa.ada_block(x, *gb, params, 2, branch_masks=bm)
        return y, (torch.autograd.grad(y, leaves, g) if grad else None)

    y, grads = _run(step, mock.patch.object(_cuda.ADA_F32, "call", call),
                    mock.patch.object(_cuda.ADA_F32, "query",
                                      return_value=64),
                    mock.patch.object(_cuda.ADA, "call", side_effect=(
                        AssertionError("bf16 ran"))))
    assert y.dtype == torch.float32 and y.shape == x.shape
    assert [s[0] for s in seen] == (
        ["pmce_ada_fwd_f32", "pmce_ada_bwd_f32"] if grad
        else ["pmce_ada_fwd_f32"])
    _, fwd, ints = seen[0]
    assert ints[:4] == (B, N, 256, 2)
    assert math.isclose(ints[4], 1e-6) and math.isclose(
        ints[5], 1 / math.sqrt(32), rel_tol=1e-6)
    assert fwd[:5] == [_ptr(t) for t in (x, *gb)]
    # The mask rows: the masks' own storage ([B, 1, 1] seen as [B]).
    assert fwd[5:7] == ([_ptr(m) for m in bm] if bm else [None, None])
    assert fwd[7:15] == [_ptr(t) for t in params]
    assert fwd[15] == y.data_ptr() and fwd[16] is not None
    counts = {k: v for k, v in _cuda.launch_counts().items() if v}
    assert counts == ({"ada_fwd_f32": 1, "ada_bwd_f32": 1} if grad
                      else {"ada_fwd_f32": 1})
    if not grad:
        return
    _, bwd, ints = seen[1]
    assert ints[:4] == (B, N, 256, 2)
    assert ints[6] == fa.f32_wgrad_splits(
        B * N, ((C, 3 * C), (C, C), (C, 256), (256, C)), torch.device("cpu"))
    assert ints[7] == int(masks == "grad")
    assert bwd[:15] == fwd[:15] and bwd[15] == g.data_ptr()
    assert all(p is not None for p in bwd[16:])
    assert len(set(bwd[15:])) == 9
    assert [t.shape for t in grads] == [t.shape for t in leaves]


@pytest.mark.parametrize("case", list(ROUTES))
@pytest.mark.parametrize("Nq,Nk,heads", [(17, 431, 8), (431, 17, 2)],
                         ids=["joints", "vertices"])
def test_ca_f32_route_reaches_rows_10f_11f(case, Nq, Nk, heads):
    """f32 ``ca_block`` in both Stage-2 orientations at 2 clips (joints
    over vertices in 8 heads of 8, vertices over joints in 2 of 32): one
    ``pmce_ca_fwd_f32`` call on the three streams, the eight AdaLN vectors
    (each gamma, then beta), the mask rows and the twelve parameters' own
    pointers; with a gradient owed one ``pmce_ca_bwd_f32`` call, the row
    ranges of each side's weight gradients, the mask gradients only when
    owed; the gradients come back in the inputs' order and shapes."""
    grad, masks = ROUTES[case]
    B = 2
    xs, gammas, betas, params, rng = _ca_case(Nq + len(case), B, Nq, Nk,
                                              grad=grad)
    bm = _masks(rng, B, masks == "grad") if masks else None
    seen = []

    def call(name, table, *rest):
        seen.append((name, _table(table, 40 if "bwd" in name else 27),
                     rest))

    g = torch.randn(B, Nq, C)
    leaves = [t for t in (*xs, *gammas, *betas, *params, *(bm or ()))
              if t.requires_grad]
    _cuda.reset_launch_counts()

    def step():
        y = fa.ca_block(*xs, gammas, betas, params, heads, branch_masks=bm)
        return y, (torch.autograd.grad(y, leaves, g) if grad else None)

    y, grads = _run(step, mock.patch.object(_cuda.CA_F32, "call", call),
                    mock.patch.object(_cuda.CA_F32, "query",
                                      return_value=64),
                    mock.patch.object(_cuda.CA, "call", side_effect=(
                        AssertionError("bf16 ran"))))
    assert y.dtype == torch.float32 and y.shape == xs[0].shape
    assert [s[0] for s in seen] == (
        ["pmce_ca_fwd_f32", "pmce_ca_bwd_f32"] if grad
        else ["pmce_ca_fwd_f32"])
    _, fwd, ints = seen[0]
    assert ints[:5] == (B, Nq, Nk, 256, heads)
    assert math.isclose(ints[6], 1 / math.sqrt(64 // heads), rel_tol=1e-6)
    conds = [t for pair in zip(gammas, betas) for t in pair]
    assert fwd[:11] == [_ptr(t) for t in (*xs, *conds)]
    assert fwd[11:13] == ([_ptr(m) for m in bm] if bm else [None, None])
    assert fwd[13:25] == [_ptr(t) for t in params]
    assert fwd[25] == y.data_ptr() and fwd[26] is not None
    counts = {k: v for k, v in _cuda.launch_counts().items() if v}
    assert counts == ({"ca_fwd_f32": 1, "ca_bwd_f32": 1} if grad
                      else {"ca_fwd_f32": 1})
    if not grad:
        return
    _, bwd, ints = seen[1]
    assert ints[:5] == (B, Nq, Nk, 256, heads)
    cpu = torch.device("cpu")
    assert ints[7:10] == (
        fa.f32_wgrad_splits(B * Nq, ((C, C), (C, C), (C, 256), (256, C)), cpu),
        fa.f32_wgrad_splits(B * Nk, ((C, C), (C, C)), cpu),
        int(masks == "grad"))
    assert bwd[:25] == fwd[:25] and bwd[25] == g.data_ptr()
    assert all(p is not None for p in bwd[26:])
    assert len(set(bwd[25:])) == 15
    assert [t.shape for t in grads] == [t.shape for t in leaves]


@pytest.mark.parametrize("kind,shape", [
    ("ada", (2, 1723, 64, 2, 512)), ("ada", (2, 72, 128, 4, 256)),
    ("ada", (2, 72, 64, 2, 512)), ("ca", (2, 80, 431, 8, 256)),
    ("ca", (2, 72, 1723, 8, 256)), ("ca", (2, 431, 17, 2, 320))], ids=str)
def test_decoder_f32_outside_the_gates_raises_naming_b3(kind, shape):
    """C 128, hid 512 (also at 1723 tokens, which the gates take) or 320
    (not a multiple of 64: the bf16 gate refuses it first), a CA block's
    short side over 64 (also over a long side of 1723): f32 raises naming
    ROADMAP.md B3 (JAX's kernels take them), with a gradient owed; no
    kernel and no plain version runs."""
    launch = mock.Mock()
    stubs = [mock.patch.object(lib, "call", launch)
             for lib in (_cuda.ADA_F32, _cuda.CA_F32, _cuda.ADA, _cuda.CA)]
    if kind == "ada":
        B, N, c, heads, hid = shape
        x, gb, params, _ = _ada_case(1, B, N, c, hid, grad=True)

        def fn():
            return fa.ada_block(x, *gb, params, heads)
    else:
        B, Nq, Nk, heads, hid = shape
        xs, gammas, betas, params, _ = _ca_case(2, B, Nq, Nk, hid=hid,
                                                grad=True)

        def fn():
            return fa.ca_block(*xs, gammas, betas, params, heads)
    match = "queued in ROADMAP.md" + (" B3" if hid % 64 == 0 else "")
    with pytest.raises(NotImplementedError, match=match):
        _run(fn, *stubs)
    assert launch.call_count == 0


@pytest.mark.parametrize("what", ["ada bf16 gamma", "ca bf16 keys",
                                  "ca bf16 weight"])
def test_decoder_f32_mixed_dtypes_raise(what):
    """f32 tokens take f32 AdaLN vectors, streams and parameters: a bf16
    one raises ``ValueError``; nothing launches."""
    launch = mock.Mock()
    stubs = [mock.patch.object(lib, "call", launch)
             for lib in (_cuda.ADA_F32, _cuda.CA_F32, _cuda.ADA, _cuda.CA)]
    if what.startswith("ada"):
        x, gb, params, _ = _ada_case(3, 2, 72, grad=True)
        gb = (gb[0].detach().bfloat16(),) + gb[1:]

        def fn():
            return fa.ada_block(x, *gb, params, 2)
    else:
        xs, gammas, betas, params, _ = _ca_case(4, 2, 17, 72, grad=True)
        if what.endswith("keys"):
            xs = (xs[0], xs[1].detach().bfloat16(), xs[2])
        else:
            params = (params[0].detach().bfloat16(),) + params[1:]

        def fn():
            return fa.ca_block(*xs, gammas, betas, params, 8)
    with pytest.raises(ValueError, match="f32"):
        _run(fn, *stubs)
    assert launch.call_count == 0


def test_decoder_f16_tokens_raise():
    launch = mock.Mock()
    x, gb, params, _ = _ada_case(5, 2, 72)
    with pytest.raises(NotImplementedError, match="bf16 or f32"):
        _run(lambda: fa.ada_block(x.half(), *gb, params, 2),
             mock.patch.object(_cuda.ADA_F32, "call", launch))
    assert launch.call_count == 0
