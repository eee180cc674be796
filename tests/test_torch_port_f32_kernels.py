"""The f32 serving forward's kernels against the JAX package, on the CPU.

JAX runs rows 6, 3 and 14 through its Pallas kernels in f32 too (its gates
have no dtype condition), so ``PMCE(dtype=None, fused_attn=True)`` serves
on ``_block_kernel``, ``_chain_kernel`` or ``_coevo_kernel``. Here those
kernels run in f32, interpreted off-TPU as the JAX package's own tests run
them, against the port's plain versions (the CPU route of the f32 CUDA
kernels of ``csrc/block_f32.cu`` and ``csrc/coevo_f32.cu``):

- ``fused_transformer_block`` vs ``transformer_block_plain``, with and
  without the post-norm, at N = 16 and 19 (heads of 32, as the card's
  kernel takes them);
- ``fused_coevo_chain`` vs ``coevo_chain_plain``;
- ``fused_coevo_block`` vs ``coevo_block_plain``;
- the whole model, JAX ``PMCE(dtype=None, fused_attn=True)`` vs the port's
  ``fused=True, dtype=None``, at ``test_torch_port_model.py``'s ``CFG``
  (J = 17 and 19, with and without ``whole_block_kernel``), and the calls
  the port's model makes on that path: exactly JAX's.

Then the f32 routes on the card, with ``_on_card`` answering "card" and
every launch stubbed: one launch of each f32 program on the parameters' own
f32 pointers; f32 with a gradient or branch masks runs the block's f32
training Function (rows 6f / 7f; its routes in detail in
``test_torch_port_f32_training.py``); mixed dtypes, other dtypes and a
vertex stream over the f32 plan's shared memory raise.

Bound: 1e-4 of each output's largest magnitude, the f32 model's. The
kernels use erf through a 1.5e-7 polynomial, E[x²]−E[x]² LayerNorm
statistics and a max-stabilised softmax; the port the exact erf and
centred statistics. Measured (max over the cases): block 2.8e-7, chain
4.4e-7, whole block 2.6e-7, model 8.8e-7.
"""

from __future__ import annotations

import ctypes
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmce_tpu.models.pmce import PMCE as JaxPMCE
from pmce_tpu.ops import fused_attention as jfa
from pmce_tpu.ops import fused_coevo_chain as jfc
from pmce_tpu_torch.convert import state_dict_from_jax
from pmce_tpu_torch.models.pmce import PMCE
from pmce_tpu_torch.ops import _cuda
from pmce_tpu_torch.ops import fused_attention as fa
from pmce_tpu_torch.ops import fused_coevo_chain as fc

from torch_port_common import init_shapes, numpy_params, rel_max_err

F32_BOUND = 1e-4
C, H, HID, B = 64, 2, 128, 4            # the block: heads of 32
CJ, CV, CC, NB = 19, 61, 64, 3          # the decoder


def _j(tree):
    if isinstance(tree, tuple):
        return tuple(_j(a) for a in tree)
    return None if tree is None else jnp.asarray(tree)


def _t(tree, dtype=torch.float32):
    if isinstance(tree, tuple):
        return tuple(_t(a, dtype) for a in tree)
    return None if tree is None else torch.from_numpy(tree).to(dtype)


# ------------------------------------------------------------------ row 6
def _block_case(seed, N, post, c=C, hid=HID, clips=B):
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.2, offset=0.0):
        return (rng.normal(size=shape) * scale + offset).astype(np.float32)

    params = (w(c, scale=0.1, offset=1.0), w(c, scale=0.1),
              w(c, 3 * c, scale=c ** -0.5), w(3 * c, scale=0.05),
              w(c, c, scale=c ** -0.5), w(c, scale=0.05),
              w(c, scale=0.1, offset=1.0), w(c, scale=0.1),
              w(c, hid, scale=c ** -0.5), w(hid, scale=0.05),
              w(hid, c, scale=hid ** -0.5), w(c, scale=0.05))
    params += ((w(c, scale=0.1, offset=1.0), w(c, scale=0.1)) if post
               else (None, None))
    return w(clips, N, c, scale=1.0), params


BLOCK_CASES = [(16, True), (16, False), (19, True), (19, False)]


@pytest.mark.parametrize("N,post", BLOCK_CASES,
                         ids=[f"N{n}-post{int(p)}" for n, p in BLOCK_CASES])
def test_block_f32_plain_matches_jax_kernel(N, post):
    x, params = _block_case(N + post, N, post)
    want = jfa.fused_transformer_block(_j(x), _j(params), H, 1e-6, 1e-6)
    got = fa.transformer_block_plain(_t(x), _t(params), H)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert rel_max_err(np.asarray(want), got.numpy()) < F32_BOUND


# ------------------------------------------------------------ rows 3, 14
def _coevo_params(t, J, V):
    def w(i, o):
        return t(i, o, scale=i ** -0.5)

    def ca():
        return (w(CC, CC), t(CC), w(CC, CC), t(CC), w(CC, CC), t(CC),
                w(CC, CC), t(CC), w(CC, 4 * CC), t(4 * CC), w(4 * CC, CC),
                t(CC))

    def sa():
        return (w(CC, 3 * CC), t(3 * CC), w(CC, CC), t(CC), w(CC, 4 * CC),
                t(4 * CC), w(4 * CC, CC), t(CC))

    return (t(J, CC, scale=1.0), t(V, CC, scale=1.0), t(J, CC, scale=1.0),
            t(V, CC, scale=1.0), t(V, CC, scale=1.0), t(J, CC, scale=1.0),
            w(CC, CC), t(CC), w(CC, CC), t(CC), ca(), ca(), sa(), sa())


def _rng_t(seed):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.05, offset=0.0):
        return (rng.normal(size=shape, scale=scale) + offset).astype(
            np.float32)

    return t


def _chain_case(seed, batch=2, J=CJ, V=CV):
    t = _rng_t(seed)
    blocks = tuple(
        (t(3, CC, scale=3 ** -0.5), t(CC), t(3, CC, scale=3 ** -0.5), t(CC),
         _coevo_params(t, J, V), t(CC, 3, scale=CC ** -0.5), t(3),
         t(CC, 3, scale=CC ** -0.5), t(3))
        for _ in range(NB))
    inputs = (t(batch, J, 3, scale=0.3), t(batch, V, 3, scale=0.3),
              t(batch, NB, 12, CC, scale=0.1, offset=1.0),
              t(batch, NB, 12, CC, scale=0.1))
    return inputs, blocks


def _coevo_block_case(seed, batch=2, J=CJ, V=CV):
    t = _rng_t(seed)
    return (t(batch, J, CC, scale=1.0), t(batch, V, CC, scale=1.0),
            t(batch, 12, CC, scale=0.1, offset=1.0),
            t(batch, 12, CC, scale=0.1), _coevo_params(t, J, V))


def test_chain_f32_plain_matches_jax_kernel():
    inputs, blocks = _chain_case(0)
    want = jfc.fused_coevo_chain(*_j(inputs), _j(blocks), 8, 2)
    got = fc.coevo_chain_plain(*_t(inputs), _t(blocks), 8, 2)
    for a, ref in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == ref.shape
        assert rel_max_err(np.asarray(ref), a.numpy()) < F32_BOUND


def test_coevo_block_f32_plain_matches_jax_kernel():
    args = _coevo_block_case(1)
    want = jfa.fused_coevo_block(*_j(args), 8, 2)
    got = fc.coevo_block_plain(*_t(args), 8, 2)
    for a, ref in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == ref.shape
        assert rel_max_err(np.asarray(ref), a.numpy()) < F32_BOUND


# -------------------------------------------------------------- the model
T_, B_ = 16, 4
CFG = dict(embed_dim=64, depth=3, num_vertx=31, num_verts_full=97,
           joint_dim=64, vertx_dim=64, gru_hidden=128, seqlen=T_)
NAMES = ("mesh", "evo_pose", "pose3d")


@pytest.mark.parametrize("whole", [False, True], ids=["chain", "whole"])
@pytest.mark.parametrize("J", [17, 19], ids=["h36m17", "coco19"])
def test_pmce_f32_fused_matches_jax_kernels(J, whole):
    """JAX ``PMCE(dtype=None, fused_attn=True)`` (its f32 Pallas kernels)
    against the port's ``fused=True`` in f32 (eval), which reaches exactly
    JAX's calls: the six lifter blocks one ``transformer_block`` each with
    its post-norm (the trunk is bf16-only in both), the plain GRU scan
    (JAX's GRU kernels are bf16-only), and ``coevo_chain`` once or
    ``coevo_block`` three times."""
    rng = np.random.default_rng(J + 2 * whole)
    vj = tuple(int(i) for i in rng.integers(0, J, size=CFG["num_vertx"]))
    pose2d = rng.standard_normal((B_, T_, J, 2), dtype=np.float32)
    feat = rng.standard_normal((B_, T_, 2048), dtype=np.float32)
    jm = JaxPMCE(num_joint=J, vj_relation=vj, fused_attn=True,
                 whole_block_kernel=whole, **CFG)
    params = numpy_params(init_shapes(jm, pose2d[:1], feat[:1]), J)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(pose2d),
                             jnp.asarray(feat))
    pm = PMCE(num_joint=J, vj_relation=vj, fused=True,
              whole_block_kernel=whole, **CFG).eval()
    pm.load_state_dict(state_dict_from_jax(params, vj), strict=True)
    spies = {name: (mod, mock.Mock(wraps=getattr(mod, name)))
             for mod, name in ((fa, "transformer_block"),
                               (fa, "lifter_trunk"), (fa, "gru_bidir"),
                               (fa, "gru_bidir_plain"), (fc, "coevo_chain"),
                               (fc, "coevo_block"))}
    with torch.no_grad():
        got = _run([mock.patch.object(mod, name, spy)
                    for name, (mod, spy) in spies.items()],
                   lambda: pm(torch.from_numpy(pose2d),
                              torch.from_numpy(feat)))
    calls = {name: spy.call_count for name, (_, spy) in spies.items()}
    assert calls == {"transformer_block": 6, "lifter_trunk": 0,
                     "gru_bidir": 0, "gru_bidir_plain": 2,
                     "coevo_chain": 0 if whole else 1,
                     "coevo_block": 3 if whole else 0}
    for name, a, ref in zip(NAMES, got, want):
        assert a.dtype == torch.float32 and a.shape == ref.shape, name
        assert rel_max_err(np.asarray(ref), a.numpy()) < F32_BOUND, name


# --------------------------------------------- the f32 routes on the card
def _table(ptr, n):
    arr = ctypes.cast(ptr, ctypes.POINTER(ctypes.c_void_p))
    return [arr[i] for i in range(n)]


def _card_stubs(*extra):
    """The card stood in for: ``_on_card`` true, no device or stream checks,
    the pointer table kept on the host."""
    stack = [mock.patch.object(fa, "_on_card", return_value=True),
             mock.patch.object(fc, "_on_card", return_value=True),
             mock.patch.object(_cuda, "check_cuda"),
             mock.patch.object(_cuda, "stream_ptr",
                               return_value=_cuda.P(None)),
             mock.patch.object(fc._Table, "device", lambda self: torch.tensor(
                 self.ptrs, dtype=torch.int64))]
    return [*stack, *extra]


def _run(patches, fn):
    for p in patches:
        p.start()
    try:
        return fn()
    finally:
        for p in reversed(patches):
            p.stop()


@pytest.mark.parametrize("post", [True, False], ids=["post", "nopost"])
def test_block_f32_route_is_one_launch_on_the_parameters(post):
    """f32 tokens inside the gate: exactly one ``pmce_block_fwd_f32`` launch
    (counter ``block_fwd_f32``), its table the tokens, the output and the
    parameters' own f32 pointers (no copies, matrices [in, out]); the bf16
    program never runs."""
    x, params = _block_case(5, 19, post, c=256, hid=512, clips=3)
    tx, tp = _t(x), _t(params)
    seen = []

    def call(name, table, *rest):
        seen.append((name, _table(table, 18), rest[:3]))

    _cuda.reset_launch_counts()
    with torch.no_grad():
        out = _run(_card_stubs(
            mock.patch.object(_cuda.BLOCK_F32, "call", call),
            mock.patch.object(_cuda.BLOCK, "call",
                              side_effect=AssertionError("bf16 ran"))),
            lambda: fa.transformer_block(tx, tp, 8))
    assert out.dtype == torch.float32 and out.shape == tx.shape
    (name, ptrs, ints), = seen
    assert name == "pmce_block_fwd_f32" and ints == (3, 19, 512)
    g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, w1, bb1, w2, bb2, gp, bp = tp
    want = [tx, out, wqkv, wproj, w1, w2, g1, b1, bqkv, bproj, g2, b2, bb1,
            bb2, gp, bp]
    # No branch masks: the two mask-row pointers are null.
    assert ptrs == [None if t is None else t.data_ptr() for t in want] + [
        None, None]
    counts = _cuda.launch_counts()
    assert counts["block_fwd_f32"] == 1 and counts["block_fwd"] == 0


@pytest.mark.parametrize("why", ["grad", "masks"])
def test_block_f32_training_raises_naming_b2b(why):
    """Once refused (queued in ROADMAP.md B2b), f32 with a gradient owed or
    with branch masks now runs the f32 training Function: its forward is
    one ``pmce_block_fwd_f32`` launch (with the mask rows where masks are
    given) and, with a gradient owed, its backward one
    ``pmce_block_bwd_f32`` call; no plain version and no bf16 program
    runs."""
    x, params = _block_case(6, 16, True, c=256, hid=512, clips=2)
    tx = _t(x).requires_grad_(why == "grad")
    masks = (torch.ones(2, 1, 1), torch.ones(2, 1, 1)) if why == "masks" \
        else None
    seen = []

    def launch(name, table, *rest):
        seen.append((name, _table(table, 18)[16:]))

    def step():
        y = fa.transformer_block(tx, _t(params), 8, branch_masks=masks)
        if why == "grad":
            y.sum().backward()
        return y

    with mock.patch.object(fa, "transformer_block_plain",
                           side_effect=AssertionError("plain ran")):
        y = _run(_card_stubs(
            mock.patch.object(_cuda.BLOCK_F32, "call", launch),
            mock.patch.object(_cuda.BLOCK, "call",
                              side_effect=AssertionError("bf16 ran"))), step)
    assert y.dtype == torch.float32 and y.shape == tx.shape
    if why == "grad":
        assert [n for n, _ in seen] == ["pmce_block_fwd_f32",
                                        "pmce_block_bwd_f32"]
        assert seen[0][1] == [None, None] and tx.grad is not None
    else:
        (name, rows), = seen
        assert name == "pmce_block_fwd_f32"
        assert rows == [m.data_ptr() for m in masks]


def test_block_f32_tokens_with_bf16_weights_raise():
    x, params = _block_case(7, 16, False, c=256, hid=512, clips=2)
    tp = _t(params[:2]) + (_t(params[2], torch.bfloat16),) + _t(params[3:])
    with torch.no_grad(), pytest.raises(ValueError, match="f32 parameters"):
        _run(_card_stubs(mock.patch.object(_cuda.BLOCK_F32, "call")),
             lambda: fa.transformer_block(_t(x), tp, 8))


# A CTA's shared memory under the f32 plan (csrc/coevo_f32.cu's SMEM).
COEVO_F32_SMEM = 207744


def _coevo_stubs(seen):
    def query(name, *args):
        if name == "pmce_coevo_f32_smem_bytes":  # the library's plan
            V, S = args
            tiles = -(-V // 16)
            rows = 16 * -(-tiles // S)  # a rank's vertex rows
            return COEVO_F32_SMEM if rows <= 128 and S <= 16 else -1
        return 1024

    def call(name, *args):
        seen.append(name)

    return _card_stubs(
        mock.patch.object(_cuda.COEVO_F32, "query", query),
        mock.patch.object(_cuda.COEVO_F32, "call", call),
        mock.patch.object(_cuda.CHAIN, "call",
                          side_effect=AssertionError("bf16 ran")),
        mock.patch.object(_cuda.COEVO_BLOCK, "call",
                          side_effect=AssertionError("bf16 ran")))


@pytest.mark.parametrize("kind", ["chain", "block"])
def test_coevo_f32_route_is_one_launch(kind):
    """f32 compute: one launch of ``csrc/coevo_f32.cu``'s chain or whole
    block (counters ``coevo_chain_f32``, ``coevo_block_f32``) on a table of
    f32 weights, each matrix [in, out] as given."""
    seen, keep = [], []
    orig = fc._Table.block

    def spy(self, kp, J, V):
        orig(self, kp, J, V)
        keep.append(self)

    if kind == "chain":
        inputs, blocks = _chain_case(2, V=431)
        fn, args = fc.coevo_chain, (*_t(inputs), _t(blocks))
        kp = blocks[0][4]
    else:
        case = _coevo_block_case(3, V=431)
        fn, args = fc.coevo_block, _t(case)
        kp = case[4]
    _cuda.reset_launch_counts()
    with torch.no_grad():
        out = _run(_coevo_stubs(seen) + [
            mock.patch.object(fc._Table, "block", spy)],
            lambda: fn(*args, 8, 2))
    assert seen == [f"pmce_coevo_{kind}_f32"]
    counts = _cuda.launch_counts()
    assert counts[f"coevo_{kind}_f32"] == 1 and counts[f"coevo_{kind}"] == 0
    assert all(o.dtype == torch.float32 for o in out)
    tab = keep[0]
    assert tab.f32 and all(t.dtype == torch.float32 for t in tab.keep)
    blk = tab.keep[-fc._BLOCK_TABLE_LEN:] if kind == "block" else \
        tab.keep[4:4 + fc._BLOCK_TABLE_LEN]
    # wv2j [C, C], the SA qkv [C, 3C], the MLP's w1 [C, 4C], w2 [4C, C].
    assert np.array_equal(blk[6].numpy(), kp[6])
    assert np.array_equal(blk[34].numpy(), kp[12][0])
    assert blk[38].shape == (CC, 4 * CC) and blk[40].shape == (4 * CC, CC)


def test_coevo_f32_vertex_stream_over_the_plan_raises_naming_b3():
    """The f32 plan (clusters of up to 16 CTAs, each a tile of 16 vertex
    rows a warp: 128 rows a CTA) takes V ≤ 2048; 2064 vertices raise
    naming the limit and ROADMAP.md B3 (JAX's kernel takes them)."""
    case = _coevo_block_case(4, batch=1, V=2064)
    seen = []
    with torch.no_grad(), pytest.raises(NotImplementedError,
                                        match="V <= 2048.*ROADMAP.md B3"):
        _run(_coevo_stubs(seen), lambda: fc.coevo_block(*_t(case), 8, 2))
    assert seen == []


@pytest.mark.parametrize("kind", ["chain", "block"])
def test_coevo_f32_mixed_dtypes_raise(kind):
    """f32 compute reads every input as f32: a bf16 weight beside f32
    features raises ``ValueError``; f16 compute raises
    ``NotImplementedError``."""
    if kind == "chain":
        inputs, blocks = _chain_case(5)
        tb = _t(blocks)
        kp = tb[0][4]
        bad = ((tb[0][:4] + ((kp[:6] + (kp[6].bfloat16(),) + kp[7:]),)
                + tb[0][5:]),) + tb[1:]
        half = tuple((b[0].half(),) + b[1:] for b in tb)
        call = (lambda blks: fc.coevo_chain(*_t(inputs), blks, 8, 2))
    else:
        jf0, vf0, g, b, kp = _t(_coevo_block_case(6))
        bad = kp[:6] + (kp[6].bfloat16(),) + kp[7:]
        half = None
        call = (lambda p: fc.coevo_block(jf0, vf0, g, b, p, 8, 2))
    seen = []
    with torch.no_grad():
        with pytest.raises(ValueError, match="f32 compute"):
            _run(_coevo_stubs(seen), lambda: call(bad))
        if half is not None:
            with pytest.raises(NotImplementedError, match="bf16 or f32"):
                _run(_coevo_stubs(seen), lambda: call(half))
        else:
            with pytest.raises(NotImplementedError, match="bf16 or f32"):
                _run(_coevo_stubs(seen), lambda: fc.coevo_block(
                    jf0.half(), vf0.half(), g, b, kp, 8, 2))
    assert seen == []
