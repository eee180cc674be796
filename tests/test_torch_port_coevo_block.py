"""The whole-block decoder path of the port against the JAX package.

``coevo_block`` (the whole-block kernel: one CoevoBlock's token program
per clip, features in and out) runs its plain version on CPU tensors; here that
version and its autograd are held against JAX's ``fused_coevo_block``
(Pallas, interpreted off-TPU as the JAX package's own tests run it), its
oracle ``coevo_block_reference`` and its custom VJP, at B=2, J=19, V=81,
C=64 (the sizes of ``tests/test_fused_attention.py``'s whole-block tests).
Then the model's ``whole_block_kernel`` switch: a CoevoBlock and a reduced
PMCE against JAX's on carried weights, the decoder's gates, and the chain's
plain version rewritten over the block's (bit for bit what it was). The
kernel itself is held against the plain version on the card
(tests/test_torch_port_gpu.py, chip_smoke.py).

f32 bounds: 1e-4 of each output's (or gradient's) largest magnitude, the
port's f32 bound. bf16 bands are pins measured on the port, about twice the
measured value.
"""

from __future__ import annotations

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmce_tpu.models import coevo as jcoevo
from pmce_tpu.models.pmce import PMCE as JaxPMCE
from pmce_tpu.ops import fused_attention as jfa
from pmce_tpu_torch import convert
from pmce_tpu_torch.convert import state_dict_from_jax
from pmce_tpu_torch.models.coevo import CoevoBlock, CoevolutionDecoder
from pmce_tpu_torch.models.pmce import PMCE
from pmce_tpu_torch.ops import fused_attention as fa
from pmce_tpu_torch.ops import fused_coevo_chain as fc

from torch_port_common import init_shapes, numpy_params, rel_max_err

B, J, V, C = 2, 19, 81, 64


def _block_case(seed):
    """Projected features, AdaLN stacks and one block's 14-tuple, numpy."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.05, offset=0.0):
        return (rng.normal(size=shape, scale=scale) + offset).astype(
            np.float32)

    def w(i, o):
        return t(i, o, scale=i ** -0.5)

    def ca():
        return (w(C, C), t(C), w(C, C), t(C), w(C, C), t(C), w(C, C), t(C),
                w(C, 4 * C), t(4 * C), w(4 * C, C), t(C))

    def sa():
        return (w(C, 3 * C), t(3 * C), w(C, C), t(C), w(C, 4 * C), t(4 * C),
                w(4 * C, C), t(C))

    params = (t(J, C, scale=1.0), t(V, C, scale=1.0), t(J, C, scale=1.0),
              t(V, C, scale=1.0), t(V, C, scale=1.0), t(J, C, scale=1.0),
              w(C, C), t(C), w(C, C), t(C), ca(), ca(), sa(), sa())
    return (t(B, J, C, scale=1.0), t(B, V, C, scale=1.0),
            t(B, 12, C, scale=0.1, offset=1.0), t(B, 12, C, scale=0.1),
            params)


def _j(tree, dtype=None):
    if isinstance(tree, tuple):
        return tuple(_j(a, dtype) for a in tree)
    return jnp.asarray(tree, dtype)


def _t(tree, dtype=torch.float32, grad=False):
    if isinstance(tree, tuple):
        return tuple(_t(a, dtype, grad) for a in tree)
    return torch.from_numpy(tree).to(dtype).requires_grad_(grad)


def test_block_plain_matches_jax_kernel_and_oracle_f32():
    jf0, vf0, g, b, params = _block_case(0)
    got = fc.coevo_block(*_t((jf0, vf0, g, b)), _t(params), 8, 2)
    for want in (jfa.fused_coevo_block(*_j((jf0, vf0, g, b)), _j(params),
                                       8, 2),
                 jfa.coevo_block_reference(*_j((jf0, vf0, g, b)),
                                           _j(params), 8, 2)):
        for a, ref in zip(got, want):
            assert a.dtype == torch.float32
            assert rel_max_err(ref, a.numpy()) < 1e-4


def test_block_plain_matches_jax_kernel_bf16():
    jf0, vf0, g, b, params = _block_case(1)
    want = jfa.fused_coevo_block(*_j((jf0, vf0), jnp.bfloat16),
                                 *_j((g, b)), _j(params), 8, 2)
    got = fc.coevo_block(*_t((jf0, vf0), torch.bfloat16), *_t((g, b)),
                         _t(params), 8, 2)
    # Measured 0.0028 / 0.0058 (joints / vertices; against the oracle
    # 0.0056 / 0.0058): the Pallas kernel's tanh-GELU and MXU-rounded AdaLN
    # statistics, and the oracle's bf16 bias adds, vs erf-GELU, f32
    # statistics and f32 bias adds here, through four bf16 blocks.
    for a, ref in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert rel_max_err(ref, a.float().numpy()) < 0.012


def test_block_gradient_matches_jax_vjp_f32():
    jf0, vf0, g, b, params = _block_case(2)
    rng = np.random.default_rng(3)
    cj = rng.normal(size=(B, J, C)).astype(np.float32)
    cv = rng.normal(size=(B, V, C)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda *a: jfa.fused_coevo_block(*a, 8, 2),
        *_j((jf0, vf0, g, b)), _j(params))
    want = jax.tree_util.tree_leaves(vjp((jnp.asarray(cj),
                                          jnp.asarray(cv))))
    leaves = _t((jf0, vf0, g, b, params), grad=True)
    got_out = fc.coevo_block(*leaves[:4], leaves[4], 8, 2)
    flat = fa._tensors(leaves)
    got = torch.autograd.grad(got_out, flat,
                              (torch.from_numpy(cj), torch.from_numpy(cv)))
    assert len(got) == len(want) == 4 + 10 + 12 + 12 + 8 + 8
    largest = max(float(np.abs(w).max()) for w in want)
    for i, (a, ref) in enumerate(zip(got, want)):
        ref = np.asarray(ref)
        # The key projections' biases shift every key alike, which the
        # softmax ignores: zero up to rounding, held to the largest
        # gradient.
        scale = max(float(np.abs(ref).max()), 1e-3 * largest)
        assert float(np.abs(a.numpy() - ref).max()) <= 1e-4 * scale, i


# ------------------------------------------------------ the model's switch
def test_coevo_block_module_matches_jax_whole_block():
    """CoevoBlock(whole_block_kernel=True) in eval mode (one coevo_block
    call) against JAX's CoevoBlock(fused=True, whole_block_kernel=True),
    on the same weights: f32 and, with bf16 compute, a band."""
    rng = np.random.default_rng(4)
    joint = rng.normal(size=(B, J, 3)).astype(np.float32) * 0.5
    vertx = rng.normal(size=(B, V, 3)).astype(np.float32) * 0.5
    cond = rng.normal(size=(B, 96)).astype(np.float32)
    params = numpy_params(init_shapes(
        jcoevo.CoevoBlock(J, V, fused=True, whole_block_kernel=True),
        joint, vertx, cond), 5)
    sd = {}
    convert._coevo_block(params, "b", sd)
    blk = CoevoBlock(J, V, cond_dim=96, whole_block_kernel=True).eval()
    blk.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    for jdt, tdt, bound in ((None, None, 1e-4),
                            (jnp.bfloat16, torch.bfloat16, 0.012)):
        jm = jcoevo.CoevoBlock(J, V, dtype=jdt, fused=True,
                               whole_block_kernel=True)
        want = jm.apply({"params": params}, *_j((joint, vertx, cond)))
        with mock.patch.object(fc, "coevo_block",
                               wraps=fc.coevo_block) as call, \
                torch.no_grad():
            got = blk(*_t((joint, vertx, cond)), tdt, fused=True)
        assert call.call_count == 1
        # bf16 measured 0.0035 / 0.0060 (coordinates, joints / vertices).
        for a, ref in zip(got, want):
            assert a.dtype == torch.float32
            assert rel_max_err(ref, a.numpy()) < bound


PMCE_CFG = dict(embed_dim=64, depth=2, num_vertx=53, num_verts_full=97,
                joint_dim=64, vertx_dim=64, gru_hidden=128, seqlen=16)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pmce_whole_block_matches_jax(dtype):
    """A reduced PMCE with whole_block_kernel=True against JAX's
    create_pmce(..., fused_attn=True, whole_block_kernel=True), whose
    parameters load into the port as they are (the tree has no new leaf):
    f32 within 1e-4, bf16 within a band."""
    Jm, Bm = 17, 4
    rng = np.random.default_rng(6)
    vj = tuple(int(i) for i in rng.integers(0, Jm, size=53))
    pose2d = rng.standard_normal((Bm, 16, Jm, 2), dtype=np.float32)
    feat = rng.standard_normal((Bm, 16, 2048), dtype=np.float32)
    jdt, tdt = {"f32": (None, None),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm = JaxPMCE(num_joint=Jm, vj_relation=vj, dtype=jdt, fused_attn=True,
                 whole_block_kernel=True, **PMCE_CFG)
    params = numpy_params(init_shapes(jm, pose2d[:1], feat[:1]), 7)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(pose2d),
                             jnp.asarray(feat))
    pm = PMCE(num_joint=Jm, vj_relation=vj, dtype=tdt, fused=True,
              whole_block_kernel=True, **PMCE_CFG).eval()
    pm.load_state_dict(state_dict_from_jax(params, vj), strict=True)
    with mock.patch.object(fc, "coevo_block",
                           wraps=fc.coevo_block) as blocks, \
            mock.patch.object(fc, "coevo_chain") as chain, torch.no_grad():
        got = pm(torch.from_numpy(pose2d), torch.from_numpy(feat))
    assert blocks.call_count == 3 and chain.call_count == 0
    # bf16 measured (mesh, evo_pose, pose3d) 0.0068, 0.0061, 0.0130: the
    # Pallas kernels' TPU workarounds, as in test_torch_port_model.py.
    bounds = {"f32": (1e-4,) * 3, "bf16": (0.015, 0.012, 0.025)}[dtype]
    for a, ref, bound in zip(got, want, bounds):
        assert a.dtype == torch.float32 and np.isfinite(a.numpy()).all()
        assert rel_max_err(ref, a.numpy()) < bound


def test_decoder_gates_with_whole_block_kernel():
    """With the switch in eval mode: a coevo_block per block and never the
    chain; in training mode the modular path (neither); without ``fused``
    neither; without the switch, the chain."""
    rng = np.random.default_rng(8)
    vj = tuple(int(i) for i in rng.integers(0, 5, size=48))
    args = (torch.from_numpy(rng.normal(size=(2, 5, 3)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(2, 4, 2048)).astype(
                np.float32)))
    for whole, fused, train, calls in ((True, True, False, (3, 0)),
                                       (True, True, True, (0, 0)),
                                       (True, False, False, (0, 0)),
                                       (False, True, False, (0, 1))):
        model = CoevolutionDecoder(5, vj, num_vertx=48, num_verts_full=60,
                                   gru_hidden=16, seqlen=4, fused=fused,
                                   whole_block_kernel=whole)
        model.train(train)
        with mock.patch.object(fc, "coevo_block",
                               wraps=fc.coevo_block) as blk, \
                mock.patch.object(fc, "coevo_chain",
                                  wraps=fc.coevo_chain) as chain:
            evo, mesh = model(*args,
                              generator=torch.Generator().manual_seed(0))
        assert (blk.call_count, chain.call_count) == calls
        assert evo.shape == (2, 5, 3) and mesh.shape == (2, 60, 3)


def _chain_plain_before(joints, vertx, gammas, betas, blocks, hj, hv,
                        eps=1e-6):
    """coevo_chain_plain as it was written before it called the block's
    plain version (one block inlined per step)."""
    mm = fa.mm
    evo, vx = joints, vertx
    for blk, (wjp, bjp, wvp, bvp, kp, whj, bhj, whv, bhv) in enumerate(blocks):
        dt = wjp.dtype
        (jpos, vpos, jQ, vQ, v2jK, j2vK, wv2j, bv2j, wj2v, bj2v,
         ca_j, ca_v, sa_j, sa_v) = kp
        g, b = gammas[:, blk], betas[:, blk]
        jf = ((mm(joints.to(dt), wjp) + bjp).to(dt).float() + jpos).to(dt)
        vf = ((mm(vx.to(dt), wvp) + bvp).to(dt).float() + vpos).to(dt)
        v_as_j = (mm(vf, wv2j.to(dt)) + bv2j + v2jK).to(dt)
        j_as_v = (mm(jf, wj2v.to(dt)) + bj2v + j2vK).to(dt)
        jq = (jf.float() + jQ).to(dt)
        vq = (vf.float() + vQ).to(dt)
        joint1 = fc._ca_ffn(jq, v_as_j, vf, g[:, 0:4], b[:, 0:4], ca_j, hj,
                            eps, dt)
        vertx1 = fc._ca_ffn(vq, j_as_v, jf, g[:, 4:8], b[:, 4:8], ca_v, hv,
                            eps, dt)
        joint2 = fc._sa_ffn(joint1.to(dt), g[:, 8:10], b[:, 8:10], sa_j, hj,
                            eps, dt)
        vertx2 = fc._sa_ffn(vertx1.to(dt), g[:, 10:12], b[:, 10:12], sa_v,
                            hv, eps, dt)
        evo = (joint2 @ whj.float() + bhj) + joints
        vx = (vertx2 @ whv.float() + bhv) + vx
    return evo, vx


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_chain_plain_is_unchanged_by_its_rewrite(dt):
    rng = np.random.default_rng(9)
    blocks = []
    for s in range(2):
        jf0, vf0, g, b, params = _block_case(10 + s)
        blocks.append((_t(rng.normal(size=(3, C)).astype(np.float32) * 0.5,
                          dt), _t(np.full(C, 0.01, np.float32)),
                       _t(rng.normal(size=(3, C)).astype(np.float32) * 0.5,
                          dt), _t(np.full(C, -0.01, np.float32)),
                       _t(params),
                       _t(rng.normal(size=(C, 3)).astype(np.float32) * 0.1),
                       _t(np.full(3, 0.02, np.float32)),
                       _t(rng.normal(size=(C, 3)).astype(np.float32) * 0.1),
                       _t(np.full(3, -0.02, np.float32))))
    args = (_t(rng.normal(size=(B, J, 3)).astype(np.float32) * 0.3),
            _t(rng.normal(size=(B, V, 3)).astype(np.float32) * 0.3),
            _t(rng.normal(size=(B, 2, 12, C)).astype(np.float32) * 0.1 + 1),
            _t(rng.normal(size=(B, 2, 12, C)).astype(np.float32) * 0.1),
            tuple(blocks), 8, 2)
    for a, ref in zip(fc.coevo_chain_plain(*args), _chain_plain_before(*args)):
        assert torch.equal(a, ref)
