"""f32 training on the card's kernels (rows 6f masked, 7f, 4f, 5f), on the
CPU.

The kernels themselves run only on the card; here:

- the f32 routes with the card stood in for (``_on_card`` true, every
  launch recorded instead of run): ``transformer_block`` with a gradient
  owed, with branch masks and with masks that require grad reaches
  ``_BlockF32Kernel``, whose forward is one ``pmce_block_fwd_f32`` launch
  and whose backward one ``pmce_block_bwd_f32`` call, each on its pointer
  table (the parameters' own f32 storage, the mask rows, the branches and
  mask gradients only when owed); ``fused_mhsa`` in f32 with and without a
  gradient reaches rows 4f / 5f; no plain version runs on the card but
  JAX's own one (the block over 64 tokens); f32 shapes outside the kernels'
  gates raise naming ROADMAP.md B3, mixed and other dtypes raise (the
  AdaLN and CA blocks' f32 routes, rows 8f-11f:
  ``test_torch_port_f32_decoder.py``);
- the f32 lifter in training mode with drop path 0.2: the fused route (the
  whole block one ``transformer_block`` call, masks as branch scales) and
  the modular route give the same loss and gradients from the same
  generator, so the masks the model draws reach the block in the order the
  modules use them. Bound 1e-5 of each gradient's largest magnitude: the
  same f32 math in another order of sums.

The plain versions' parity with JAX in f32 is held elsewhere
(``test_torch_port_block.py``, ``test_torch_port_attention.py``,
``test_torch_port_train.py``).
"""

from __future__ import annotations

import ctypes
import math
from unittest import mock

import numpy as np
import pytest
import torch

from pmce_tpu_torch.core.losses import coord_l1
from pmce_tpu_torch.models.pose_lifter import create_pose_lifter
from pmce_tpu_torch.ops import _cuda
from pmce_tpu_torch.ops import fused_attention as fa

C, HID = 256, 512


def _table(ptr, n):
    arr = ctypes.cast(ptr, ctypes.POINTER(ctypes.c_void_p))
    return [arr[i] for i in range(n)]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _on_card(*extra):
    """The card stood in for: ``_on_card`` true, no device or stream
    checks; launches as ``extra`` patches them."""
    return [mock.patch.object(fa, "_on_card", return_value=True),
            mock.patch.object(_cuda, "check_cuda"),
            mock.patch.object(_cuda, "stream_ptr",
                              return_value=_cuda.P(None)), *extra]


def _run(patches, fn):
    for p in patches:
        p.start()
    try:
        return fn()
    finally:
        for p in reversed(patches):
            p.stop()


def _no_plain():
    """Every plain version of the attention kernels raises if called."""
    return [mock.patch.object(fa, name, side_effect=AssertionError(
        f"{name} ran")) for name in ("transformer_block_plain",
                                     "mhsa_plain", "ada_block_plain",
                                     "ca_block_plain")]


def _block_case(seed, clips, N, post=True, masks=None):
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.2, offset=0.0, grad=True):
        a = (rng.normal(size=shape) * scale + offset).astype(np.float32)
        return torch.from_numpy(a).requires_grad_(grad)

    params = (w(C, scale=0.1, offset=1.0), w(C, scale=0.1),
              w(C, 3 * C, scale=C ** -0.5), w(3 * C, scale=0.05),
              w(C, C, scale=C ** -0.5), w(C, scale=0.05),
              w(C, scale=0.1, offset=1.0), w(C, scale=0.1),
              w(C, HID, scale=C ** -0.5), w(HID, scale=0.05),
              w(HID, C, scale=HID ** -0.5), w(C, scale=0.05))
    params += ((w(C, scale=0.1, offset=1.0), w(C, scale=0.1)) if post
               else (None, None))
    bm = None
    if masks is not None:
        bm = tuple(torch.from_numpy(
            ((rng.random((clips, 1, 1)) < 0.8) / 0.8).astype(np.float32))
            .requires_grad_(masks == "grad") for _ in range(2))
    return w(clips, N, C, scale=1.0), params, bm


# Cases: a gradient owed without masks, masks without a gradient, and masks
# that require grad (with x's gradient).
ROUTES = {"grad": (True, None), "masks": (False, "const"),
          "mask-grad": (True, "grad")}


@pytest.mark.parametrize("case", list(ROUTES))
def test_block_f32_training_route_reaches_the_kernels(case):
    """f32 with a gradient or masks: the forward is one ``pmce_block_fwd_f32``
    launch on the tokens, the parameters' own f32 pointers and the mask
    rows; the backward (where a gradient is owed) one ``pmce_block_bwd_f32``
    call on the forward's parameters and the output's gradient, with the
    branches a / mo and the mask gradients only where the masks require
    grad; the bf16 programs and the plain version never run, and the
    counters count one launch each."""
    grad, masks = ROUTES[case]
    clips, N = 3, 17
    x, params, bm = _block_case(len(case), clips, N, masks=masks)
    x.requires_grad_(grad)
    for p in params:
        if p is not None:
            p.requires_grad_(grad)
    seen = []

    def call(name, table, *rest):
        seen.append((name, _table(table, 44 if "bwd" in name else 18),
                     rest))

    g = torch.randn(clips, N, C)
    leaves = [t for t in (x, *params, *(bm or ())) if t is not None
              and t.requires_grad]
    _cuda.reset_launch_counts()

    def step():
        y = fa.transformer_block(x, params, 8, branch_masks=bm)
        return y, (torch.autograd.grad(y, leaves, g) if grad else None)

    y, grads = _run(_on_card(
        mock.patch.object(_cuda.BLOCK_F32, "call", call),
        mock.patch.object(_cuda.BLOCK, "call",
                          side_effect=AssertionError("bf16 ran")),
        *_no_plain()), step)
    assert y.dtype == torch.float32 and y.shape == x.shape
    names = [s[0] for s in seen]
    assert names == (["pmce_block_fwd_f32", "pmce_block_bwd_f32"] if grad
                     else ["pmce_block_fwd_f32"])
    g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, w1, bb1, w2, bb2, gp, bp = params
    order = [wqkv, wproj, w1, w2, g1, b1, bqkv, bproj, g2, b2, bb1, bb2, gp,
             bp]
    _, fwd, ints = seen[0]
    assert ints[:3] == (clips, N, HID)
    assert math.isclose(ints[5], 1 / math.sqrt(32), rel_tol=1e-6)
    assert fwd[0] == x.data_ptr() and fwd[1] == y.data_ptr()
    assert fwd[2:16] == [_ptr(t) for t in order]
    # The mask rows: the masks' own storage ([clips, 1, 1] seen as [clips]).
    assert fwd[16:18] == ([_ptr(m) for m in bm] if bm else [None, None])
    counts = _cuda.launch_counts()
    assert counts["block_fwd_f32"] == 1 and counts["block_fwd"] == 0
    assert counts["block_bwd_f32"] == int(grad) and counts["block_bwd"] == 0
    if not grad:
        return
    _, bwd, ints = seen[1]
    assert ints[:3] == (clips, N, HID)
    assert ints[6] == fa.f32_wgrad_splits(
        clips * N, ((C, 3 * C), (C, C), (C, HID), (HID, C)), x.device)
    assert bwd[0] == x.data_ptr() and bwd[1] == g.data_ptr()
    assert bwd[2:18] == fwd[2:18]
    owed = masks == "grad"
    # a, mo (28, 29) and dm1, dm2 (36, 37): only for owed mask gradients;
    # every other workspace pointer is there.
    assert [bwd[i] is not None for i in (28, 29, 36, 37)] == [owed] * 4
    assert all(bwd[i] is not None for i in range(18, 44)
               if i not in (28, 29, 36, 37))
    assert len(set(bwd[18:44]) - {None}) == 26 - 4 * (not owed)
    assert len(grads) == len(leaves)
    if owed:
        assert grads[-2].shape == bm[0].shape == grads[-1].shape


def test_block_f32_dtype_gates():
    """f32 tokens with a gradient owed and a bf16 weight raise
    ``ValueError``; f16 tokens raise ``NotImplementedError``; nothing
    launches."""
    x, params, bm = _block_case(3, 2, 16, masks="grad")
    bad = params[:2] + (params[2].detach().bfloat16(),) + params[3:]
    launch = mock.Mock()
    stubs = _on_card(mock.patch.object(_cuda.BLOCK_F32, "call", launch),
                     mock.patch.object(_cuda.BLOCK, "call", launch),
                     *_no_plain())
    with pytest.raises(ValueError, match="f32 parameters"):
        _run(stubs, lambda: fa.transformer_block(x, bad, 8, branch_masks=bm))
    with pytest.raises(NotImplementedError, match="bf16 or f32"):
        _run(stubs, lambda: fa.transformer_block(
            x.detach().half().requires_grad_(True), params, 8,
            branch_masks=bm))
    assert launch.call_count == 0


def test_block_f32_over_64_tokens_runs_the_plain_version():
    """Over 64 tokens JAX's entry runs its oracle; so on the card the f32
    block with masks and a gradient runs the plain version, no kernel."""
    x, params, bm = _block_case(4, 2, 65, masks="grad")
    launch = mock.Mock()
    want = fa.transformer_block_plain(x, params, 8, branch_masks=bm)
    got = _run(_on_card(mock.patch.object(_cuda.BLOCK_F32, "call", launch)),
               lambda: fa.transformer_block(x, params, 8, branch_masks=bm))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got.sum().backward()
    assert launch.call_count == 0 and bm[0].grad is not None


def _mhsa_case(seed, clips, N, c, grad):
    rng = np.random.default_rng(seed)

    def w(*shape, scale=1.0):
        a = (rng.normal(size=shape) * scale).astype(np.float32)
        return torch.from_numpy(a).requires_grad_(grad)

    return (w(clips, N, c), w(c, 3 * c, scale=c ** -0.5), w(3 * c, scale=0.05),
            w(c, c, scale=c ** -0.5), w(c, scale=0.05))


@pytest.mark.parametrize("grad", [False, True], ids=["no-grad", "grad"])
@pytest.mark.parametrize("N", [17, 19])
def test_mhsa_f32_route_reaches_rows_4f_5f(N, grad):
    """f32 ``fused_mhsa`` at the f32 joint stream's shapes ([32, N, 64], 8
    heads): one ``pmce_mhsa_fwd_f32`` launch on the tokens and the
    parameters, saving qkv and o only with a gradient owed; with one, one
    ``pmce_mhsa_bwd_f32`` call on the forward's saved qkv and o and the
    weights; both on the plan's CTAs (here no card: a CTA an item, two
    items a clip); the bf16 library and the plain version never run."""
    leaves = _mhsa_case(N, 32, N, 64, grad)
    seen = []

    def call(name, table, *rest):
        seen.append((name, _table(table, 13 if "bwd" in name else 8), rest))

    _cuda.reset_launch_counts()
    g = torch.randn(32, N, 64)

    def step():
        y = fa.fused_mhsa(*leaves, 8)
        return y, (torch.autograd.grad(y, leaves, g) if grad else None)

    y, grads = _run(_on_card(
        mock.patch.object(_cuda.MHSA_F32, "call", call),
        mock.patch.object(_cuda.MHSA, "call",
                          side_effect=AssertionError("bf16 ran")),
        *_no_plain()), step)
    assert y.dtype == torch.float32 and y.shape == (32, N, 64)
    x, wqkv, bqkv, wproj, bproj = leaves
    name, fwd, ints = seen[0]
    ctas = fa.mhsa_f32_plan(32, N, None).ctas
    assert ctas == 64
    assert name == "pmce_mhsa_fwd_f32" and ints[:4] == (32, N, 64, 8)
    assert ints[5] == ctas and isinstance(ints[6], ctypes.c_void_p)
    assert fwd[:6] == [_ptr(t) for t in (x, wqkv, bqkv, wproj, bproj, y)]
    assert (fwd[6] is not None) == grad and (fwd[7] is not None) == grad
    counts = _cuda.launch_counts()
    assert counts["mhsa_fwd_f32"] == 1 and counts["mhsa_fwd"] == 0
    assert counts["mhsa_bwd_f32"] == int(grad) and counts["mhsa_bwd"] == 0
    if grad:
        name, bwd, ints = seen[1]
        assert name == "pmce_mhsa_bwd_f32" and len(seen) == 2
        assert ints[:4] == (32, N, 64, 8)
        assert ints[5] == fa.f32_wgrad_splits(
            32 * N, ((64, 192), (64, 64)), x.device)
        assert ints[6] == ctas
        assert bwd[0] == g.data_ptr() and bwd[1] == x.data_ptr()
        assert bwd[2:6] == [wqkv.data_ptr(), wproj.data_ptr(), fwd[6],
                            fwd[7]]
        assert all(p is not None for p in bwd)
        assert [t.shape for t in grads] == [t.shape for t in leaves]
    else:
        assert len(seen) == 1


@pytest.mark.parametrize("N,c,heads", [(65, 64, 8), (17, 320, 10)])
def test_mhsa_f32_outside_its_gate_raises_naming_b3(N, c, heads):
    """Over 64 tokens, or C over 256, f32 ``fused_mhsa`` raises naming
    ROADMAP.md B3 (JAX's kernel takes them); no kernel and no plain version
    runs."""
    leaves = _mhsa_case(N + c, 2, N, c, True)
    launch = mock.Mock()
    with pytest.raises(NotImplementedError, match="ROADMAP.md B3"):
        _run(_on_card(mock.patch.object(_cuda.MHSA_F32, "call", launch),
                      mock.patch.object(_cuda.MHSA, "call", launch),
                      *_no_plain()),
             lambda: fa.fused_mhsa(*leaves, heads))
    assert launch.call_count == 0


def test_mhsa_f32_with_bf16_weights_raises():
    x, wqkv, bqkv, wproj, bproj = _mhsa_case(5, 2, 17, 64, False)
    with torch.no_grad(), pytest.raises(ValueError, match="f32 parameters"):
        _run(_on_card(mock.patch.object(_cuda.MHSA_F32, "call")),
             lambda: fa.fused_mhsa(x, wqkv.bfloat16(), bqkv, wproj, bproj, 8))


# ------------------------------------------------ the lifter in training
def _lifter_step(fused: bool, rng_seed: int = 0):
    model = create_pose_lifter(num_joints=17, num_frames=16, embed_dim=64,
                               depth=3, drop_path_rate=0.2, dtype=None,
                               fused=fused, device="cpu", seed=3).train()
    # Nonzero biases and pos-embeds, LayerNorm scales off 1.
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    rng = np.random.default_rng(rng_seed)
    pose2d = torch.from_numpy(rng.standard_normal((4, 16, 17, 2),
                                                  dtype=np.float32))
    feat = torch.from_numpy(rng.standard_normal((4, 16, 2048),
                                                dtype=np.float32))
    target = torch.from_numpy(100 * rng.standard_normal((4, 17, 3),
                                                        dtype=np.float32))
    calls = mock.Mock(wraps=fa.transformer_block)
    with mock.patch.object(fa, "transformer_block", calls):
        pred = model(pose2d, feat, generator=torch.Generator().manual_seed(7))
    loss = coord_l1(pred, target)
    loss.backward()
    masks = [c.args[5] if len(c.args) > 5 else c.kwargs.get("branch_masks")
             for c in calls.call_args_list]
    grads = {n: p.grad for n, p in model.named_parameters()}
    return float(loss.detach()), grads, masks


def test_f32_lifter_training_fused_matches_modular_route():
    """The f32 lifter in training mode at drop path 0.2 (rates 0, 0.1 and
    0.2 for the three pairs of blocks): the fused route (six
    ``transformer_block`` calls, the first pair without masks, the other
    four with per-clip branch scales) gives the modular route's loss and
    gradients from the same generator, within 1e-5."""
    loss_f, grads_f, masks = _lifter_step(True)
    loss_m, grads_m, none = _lifter_step(False)
    assert len(masks) == 6 and not none
    assert masks[0] is None and masks[1] is None
    assert all(m is not None and m[0].shape == (m[0].shape[0], 1, 1)
               for m in masks[2:])
    # Some clip of the four masked blocks drops a branch: the draws are
    # exercised, not only the ones of keep.
    assert any(float(m.min()) == 0.0 for pair in masks[2:] for m in pair)
    assert abs(loss_f - loss_m) <= 1e-5 * abs(loss_m)
    assert set(grads_f) == set(grads_m)
    for name, g in grads_m.items():
        err = float((grads_f[name] - g).abs().max() / g.abs().max())
        assert err <= 1e-5, (name, err)
