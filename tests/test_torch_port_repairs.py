"""Regression anchors of three port faults (ROADMAP.md section C), on the CPU.

- Initialisation: a fresh port PMCE draws what the JAX package's
  ``model.init`` draws: the same parameters exactly zero or one, products
  truncated lecun-normal (std 1/√fan_in, nothing beyond 2σ of the
  untruncated draw), the decoder's embeds N(0, 1), the frame fusion
  U(±1/√T).
- Reproducible gradients: the gathers' fixed-order backward sums
  (``ops/segments.py``) equal ``index_add_`` and PyTorch's autograd of the
  gather in f64.
- Shape gates: on the card each wrapper reaches its kernel for every
  shape the JAX package's kernel takes and the port's is built for; the
  one route to a plain version is JAX's own static test (the block over 64
  tokens), and a shape JAX's kernel takes but the port's is not built for
  raises ``NotImplementedError`` naming ROADMAP.md (the card is stood in
  for by patching the device test).
"""

from __future__ import annotations

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmce_tpu.models.pmce import PMCE as JaxPMCE
from pmce_tpu_torch.convert import state_dict_from_jax
from pmce_tpu_torch.core import losses
from pmce_tpu_torch.models.pmce import PMCE
from pmce_tpu_torch.ops import fused_attention as fa
from pmce_tpu_torch.ops import fused_coevo_chain as fc
from pmce_tpu_torch.ops.segments import gather_rows, segment_sum, segment_table

from test_torch_port_coevo_block import _block_case, _t

T = 16
CFG = dict(embed_dim=64, depth=2, num_vertx=31, num_verts_full=97,
           joint_dim=64, vertx_dim=64, gru_hidden=128, seqlen=T)
# max |w|·√fan_in of flax's truncated lecun-normal: 2σ of the untruncated
# normal, σ = 1 / 0.8796 (its std over [-2σ, 2σ] is then 1).
TRUNC_LIMIT = 2 / 0.87962566103423978


# --------------------------------------------------------- initialisation
@pytest.fixture(scope="module")
def inits():
    J = 17
    rng = np.random.default_rng(0)
    vj = tuple(int(i) for i in rng.integers(0, J, size=CFG["num_vertx"]))
    pose2d = jnp.zeros((1, T, J, 2))
    feat = jnp.zeros((1, T, 2048))
    jm = JaxPMCE(num_joint=J, vj_relation=vj, **CFG)
    want = state_dict_from_jax(jax.device_get(
        jm.init(jax.random.PRNGKey(0), pose2d, feat)))
    model = PMCE(num_joint=J, vj_relation=vj, **CFG)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return want, dict(model.named_parameters())


def test_init_zeros_and_ones_equal_jax(inits):
    want, got = inits
    assert set(want) == set(got)
    constant = 0
    for name, ref in want.items():
        for value in (0.0, 1.0):
            if bool((ref == value).all()):
                constant += 1
                assert bool((got[name] == value).all()), name
    # Every bias and LayerNorm, the lifter's pos-embeds and fusion bias.
    assert constant > len(want) // 2


def _pooled(params: dict, names) -> np.ndarray:
    """Every product weight scaled by √fan_in (torch layout [out, in, ...]),
    pooled."""
    return np.concatenate([
        params[n].detach().numpy().ravel()
        * np.prod(params[n].shape[1:]) ** 0.5 for n in names])


def test_init_products_and_embeds_have_jax_distributions(inits):
    want, got = inits
    random = [n for n, v in want.items()
              if not bool((v == 0).all() or (v == 1).all())]
    embeds = [n for n in random if n.endswith("_embed")]
    fusion = [n for n in random if n.endswith("fusion.weight")]
    products = sorted(set(random) - set(embeds) - set(fusion))
    assert all(n.startswith("pose_mesh_coevo.coevoblock") for n in embeds)
    assert len(products) > 50 and all(got[n].ndim >= 2 for n in products)
    for params in (want, got):
        z = _pooled(params, products)
        # Pooled std within six standard errors of 1 (std error of a sample
        # std: 1/√(2n)); nothing beyond the truncation.
        assert abs(z.std() - 1.0) < 6 / np.sqrt(2 * z.size), z.std()
        assert np.abs(z).max() <= TRUNC_LIMIT * (1 + 1e-5)
        e = np.concatenate([params[n].detach().numpy().ravel()
                            for n in embeds])
        assert abs(e.std() - 1.0) < 6 / np.sqrt(2 * e.size), e.std()
        (f,) = (params[n].detach().numpy() for n in fusion)
        assert 0 < np.abs(f).max() <= T ** -0.5


# ------------------------------------------------- reproducible gradients
def test_segment_sum_equals_index_add_f64():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 9, size=200)
    ids[ids == 4] = 5                    # an empty segment
    x = torch.from_numpy(rng.normal(size=(3, 200, 3)))
    table = segment_table(ids, 10)
    assert table.shape[0] == 10 and bool((table[4] == 200).all())
    want = torch.zeros(3, 10, 3, dtype=torch.float64).index_add_(
        1, torch.from_numpy(ids), x)
    torch.testing.assert_close(segment_sum(x, table), want, rtol=1e-12,
                               atol=1e-12)


def test_gather_rows_gradient_equals_autograd_f64():
    rng = np.random.default_rng(2)
    index = torch.from_numpy(rng.integers(0, 7, size=50))
    x = torch.from_numpy(rng.normal(size=(2, 7, 3))).requires_grad_(True)
    g = torch.from_numpy(rng.normal(size=(2, 50, 3)))
    y = gather_rows(x, index, segment_table(index.numpy(), 7))
    assert torch.equal(y, x[:, index])
    (got,) = torch.autograd.grad(y, x, g)
    (want,) = torch.autograd.grad(x[:, index], x, g)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_face_losses_gradient_equals_autograd_f64():
    rng = np.random.default_rng(3)
    V, F = 40, 70
    faces = np.stack([rng.choice(V - 1, size=3, replace=False)
                      for _ in range(F)])           # vertex V-1 in no face
    pred = torch.from_numpy(rng.normal(size=(2, V, 3))).requires_grad_(True)
    gt = torch.from_numpy(rng.normal(size=(2, V, 3)))
    fused = losses.build_face_losses(faces, V, device="cpu")
    ln, le = fused(pred, gt)
    got = torch.autograd.grad(ln + 3 * le, pred)[0]
    f = torch.from_numpy(faces)
    want = torch.autograd.grad(losses.normal_loss(pred, gt, f)
                               + 3 * losses.edge_length_loss(pred, gt, f),
                               pred)[0]
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert bool((got[:, V - 1] == 0).all())


# ------------------------------------------------------------ shape gates
@pytest.mark.parametrize("gate,args,fits", [
    (fa.trunk_kernel_fits, (256, 8, 512), True),
    (fa.trunk_kernel_fits, (256, 8, 1024), True),
    (fa.trunk_kernel_fits, (128, 4, 256), False),
    (fa.trunk_kernel_fits, (256, 8, 192), False),
    (fa.trunk_kernel_fits, (256, 4, 512), False),
    (fa.block_kernel_fits, (256, 8, 512), True),
    (fa.block_kernel_fits, (256, 8, 1024), True),
    (fa.block_kernel_fits, (256, 4, 512), False),
    (fa.block_kernel_fits, (256, 8, 192), False),
    (fa.block_kernel_fits, (128, 4, 256), False),
    (fa.attention_kernel_fits, (64, 8, 256), True),
    (fa.attention_kernel_fits, (64, 2, 256), True),
    (fa.attention_kernel_fits, (256, 8), True),
    (fa.attention_kernel_fits, (256, 16, 512), True),
    (fa.attention_kernel_fits, (64, 1, 256), False),         # width 64
    (fa.attention_kernel_fits, (96, 6, 384), False),
    (fa.gru_kernel_fits, (1024,), True),
    (fa.gru_kernel_fits, (96,), False),
    (fc.coevo_kernel_fits, (64, 256, 8, 2, 431), True),
    (fc.coevo_kernel_fits, (64, 256, 8, 2, 48), True),
    (fc.coevo_kernel_fits, (64, 256, 8, 2, 40), False),
    (fc.coevo_kernel_fits, (64, 256, 4, 2, 431), False),
    (fc.coevo_kernel_fits, (32, 128, 4, 1, 431), False),
])
def test_shape_gates(gate, args, fits):
    assert gate(*args) is fits


def _r(rng, *s, scale=0.05, offset=0.0):
    return torch.from_numpy(
        (rng.normal(size=s) * scale + offset).astype(np.float32))


def _block_weights(rng, C, hid):
    return (_r(rng, C, offset=1.0), _r(rng, C), _r(rng, C, 3 * C),
            _r(rng, 3 * C), _r(rng, C, C), _r(rng, C),
            _r(rng, C, offset=1.0), _r(rng, C), _r(rng, C, hid),
            _r(rng, hid), _r(rng, hid, C), _r(rng, C))


def _trunk_call(T_, J_, C=256, heads=8):
    rng = np.random.default_rng(T_ * 100 + J_)
    block = _block_weights(rng, C, 2 * C)
    x = _r(rng, 1, T_ * J_, C, scale=1.0).to(torch.bfloat16)
    args = (x, (block, block), (_r(rng, C, offset=1.0), _r(rng, C)),
            (_r(rng, C, offset=1.0), _r(rng, C)), _r(rng, T_, C),
            T_, J_, 1, heads)
    return lambda: fa.lifter_trunk(*args), lambda: fa.lifter_trunk_plain(*args)


def _block_call(N, C=256, heads=8):
    rng = np.random.default_rng(N)
    params = _block_weights(rng, C, 2 * C) + (None, None)
    x = _r(rng, 3, N, C, scale=1.0).to(torch.bfloat16)
    return (lambda: fa.transformer_block(x, params, heads),
            lambda: fa.transformer_block_plain(x, params, heads))


def _mhsa_call(heads, C=256):
    rng = np.random.default_rng(heads)
    w = _block_weights(rng, C, 2 * C)
    x = _r(rng, 3, 40, C, scale=1.0).to(torch.bfloat16)
    return (lambda: fa.fused_mhsa(x, *w[2:6], heads),
            lambda: fa.mhsa_plain(x, *w[2:6], heads))


def _gru_call(H):
    rng = np.random.default_rng(H)
    gi = _r(rng, 4, 2, 3 * H).to(torch.bfloat16)
    whh, bhh = _r(rng, H, 3 * H), _r(rng, 3 * H)
    return (lambda: fa.gru_layer(gi, whh, bhh),
            lambda: fa.gru_layer_plain(gi, whh, bhh, False))


def _coevo_call(V):
    jf0, vf0, g, b, params = _block_case(0)
    vf0, params = vf0[:, :V], params[:1] + (params[1][:V],) + \
        params[2:3] + (params[3][:V], params[4][:V]) + params[5:]
    inputs = (_t((jf0, vf0), torch.bfloat16) + _t((g, b)) + (_t(params),))
    return (lambda: fc.coevo_block(*inputs, 8, 2),
            lambda: fc.coevo_block_plain(*inputs, 8, 2))


@pytest.mark.parametrize("case,route", [
    (lambda: _trunk_call(16, 3), "kernel"),
    (lambda: _trunk_call(48, 3), "kernel"),            # seqlen 48
    (lambda: _trunk_call(81, 2), "kernel"),
    (lambda: _trunk_call(4, 40), "kernel"),
    (lambda: _trunk_call(4, 3, C=128, heads=4), "raises"),
    (lambda: _block_call(17), "kernel"),
    (lambda: _block_call(48), "kernel"),
    (lambda: _block_call(64), "kernel"),
    (lambda: _block_call(65), "plain"),                # JAX's oracle gate
    (lambda: _block_call(17, heads=4), "raises"),      # heads of width 64
    (lambda: _mhsa_call(8), "kernel"),
    (lambda: _mhsa_call(4), "raises"),
    (lambda: _gru_call(64), "kernel"),
    (lambda: _gru_call(96), "raises"),
    (lambda: _coevo_call(431), "kernel"),
    (lambda: _coevo_call(40), "raises"),
], ids=["trunk-T16", "trunk-T48", "trunk-T81", "trunk-J40", "trunk-C128",
        "block-N17", "block-N48", "block-N64", "block-N65", "block-dh64",
        "mhsa-dh32", "mhsa-dh64", "gru-H64", "gru-H96", "coevo-V431",
        "coevo-V40"])
def test_wrapper_routes_on_the_card(case, route):
    """With the device test answering "card" and every launch stubbed: a
    shape the port's kernel is built for reaches it, the block over 64
    tokens runs its plain version (as JAX runs its oracle there), and a
    shape JAX's kernel takes but the port's is not built for raises
    ``NotImplementedError`` naming ROADMAP.md."""
    kernel = mock.Mock(side_effect=RuntimeError("kernel reached"))
    call, plain = case()
    with mock.patch.object(fa, "_on_card", return_value=True), \
            mock.patch.object(fc, "_on_card", return_value=True), \
            mock.patch.object(fa, "_lifter_trunk_cuda", kernel), \
            mock.patch.object(fa._BlockKernel, "apply", kernel), \
            mock.patch.object(fa._MhsaKernel, "apply", kernel), \
            mock.patch.object(fa, "_gru_layer_cuda", kernel), \
            mock.patch.object(fc._cuda.COEVO_BLOCK, "query", kernel), \
            torch.no_grad():
        if route == "plain":
            for got, want in zip(call(), plain()):
                assert torch.equal(got, want)
            assert kernel.call_count == 0
            return
        err = (RuntimeError, "kernel reached") if route == "kernel" else \
            (NotImplementedError, "ROADMAP")
        with pytest.raises(err[0], match=err[1]):
            call()
        assert kernel.call_count == int(route == "kernel")


def test_coevo_vertex_stream_over_shared_memory_raises_on_the_card():
    """The coevo kernels ask their library for the vertex stream's shared
    memory; a stream over sm_90's limit raises (JAX's kernel takes it)."""
    call, _ = _coevo_call(431)
    with mock.patch.object(fc, "_on_card", return_value=True), \
            mock.patch.object(fc._cuda.COEVO_BLOCK, "query",
                              return_value=fc._SMEM_LIMIT + 1), \
            torch.no_grad(), \
            pytest.raises(NotImplementedError, match="shared memory"):
        call()
