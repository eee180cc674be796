"""The port's fused decoder in training mode against JAX's, on the CPU.

Under ``fused`` the decoder's blocks take the JAX package's kernel gates
(``pmce_tpu/models/layers.py:557-662``): the short joint stream's
self-attention is ``fused_mhsa`` between modular AdaLNs, the 431-vertex
(here 72-vertex, > 64) self-attention one ``ada_block``, both
cross-attentions ``ca_block``. The wrappers run their plain versions on
CPU tensors; ``test_torch_port_attention.py`` holds each to its JAX kernel.
Here: which wrapper each block reaches, and the whole decoder's loss and
every gradient against JAX's fused decoder (custom VJPs, Pallas
interpreted) in f32, within 1e-4 of each gradient's largest magnitude.
Width 32, 5 joints, 72 coarse vertices, GRU width 16, T = 4, 3 clips.
"""

from __future__ import annotations

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pmce_tpu.models import coevo as jcoevo
from pmce_tpu_torch import convert
from pmce_tpu_torch.models.coevo import CoevolutionDecoder
from pmce_tpu_torch.models.layers import DropPath
from pmce_tpu_torch.ops import fused_attention as fa

from torch_port_common import init_shapes, numpy_params

C, B = 32, 3


def _decoder(fused: bool, NV: int = 72, J: int = 5, seed: int = 0):
    rng = np.random.default_rng(seed)
    vj = tuple(int(i) for i in rng.integers(0, J, size=NV))
    return CoevolutionDecoder(num_joint=J, vj_relation=vj, num_vertx=NV,
                              num_verts_full=100, joint_dim=C, vertx_dim=C,
                              gru_hidden=16, seqlen=4, fused=fused), vj


def test_fused_gates_send_each_block_to_its_kernel():
    """Under ``fused`` in training mode: the 5-joint self-attention is
    ``fused_mhsa`` inside modular AdaLNs, the 72-vertex self-attention one
    ``ada_block``, both cross-attentions (max(5, 72) > 64) ``ca_block``;
    without ``fused`` none of them. Two blocks."""
    model, _ = _decoder(True)
    model.num_blocks = 2
    rng = np.random.default_rng(1)
    args = (torch.from_numpy(rng.normal(size=(B, 5, 3)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(B, 4, 2048)).astype(
                np.float32)))
    for fused, per_block in ((True, (1, 1, 2)), (False, (0, 0, 0))):
        model.fused = fused
        with mock.patch.object(fa, "fused_mhsa", wraps=fa.fused_mhsa) as m, \
                mock.patch.object(fa, "ada_block", wraps=fa.ada_block) as a, \
                mock.patch.object(fa, "ca_block", wraps=fa.ca_block) as c:
            model.train()(*args, generator=torch.Generator().manual_seed(0))
        assert (m.call_count, a.call_count, c.call_count) == tuple(
            2 * n for n in per_block)
        if fused:
            assert m.call_args.args[0].shape[1] == 5
            assert a.call_args.args[0].shape[1] == 72
            assert {call.args[0].shape[1] for call in c.call_args_list} \
                == {5, 72}


# --------------------------------------------- the fused decoder, trained
class _NoDropCoevoBlock(jcoevo.CoevoBlock):
    """JAX's CoevoBlock at drop-path rate 0: its training mode then runs the
    fused kernels with no branch masks, which the port can match."""

    drop_path: float = 0.0


def test_fused_decoder_training_matches_jax_f32():
    """The decoder in training mode under ``fused`` (drop-path rate 0 on
    both sides), f32: JAX runs fused_mhsa, fused_ada_block and
    fused_ca_block with their custom VJPs; the port its wrappers. The loss
    sum(mesh * a) + sum(evo_pose * b) and every gradient."""
    J, NV = 5, 72
    model, vj = _decoder(True, NV, J, seed=2)
    for mod in model.modules():
        if isinstance(mod, DropPath):
            mod.rate = 0.0
    jm = jcoevo.CoevolutionDecoder(num_joint=J, vj_relation=vj,
                                   num_vertx=NV, num_verts_full=100,
                                   joint_dim=C, vertx_dim=C, gru_hidden=16,
                                   seqlen=4, fused_attn=True)
    rng = np.random.default_rng(3)
    joints = rng.normal(size=(B, J, 3)).astype(np.float32)
    feats = rng.normal(size=(B, 4, 2048)).astype(np.float32)
    cm = rng.normal(size=(B, 100, 3)).astype(np.float32)
    ce = rng.normal(size=(B, J, 3)).astype(np.float32)
    with mock.patch.object(jcoevo, "CoevoBlock", _NoDropCoevoBlock):
        params = numpy_params(init_shapes(jm, joints, feats), 4)

        def jloss(p):
            evo, mesh = jm.apply({"params": p}, jnp.asarray(joints),
                                 jnp.asarray(feats), deterministic=False,
                                 rngs={"droppath": jax.random.PRNGKey(0),
                                       "dropout": jax.random.PRNGKey(1)})
            return jnp.sum(mesh * cm) + jnp.sum(evo * ce)

        want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(
            jax.tree_util.tree_map(jnp.asarray, params))
    sd = {}
    convert._decoder(params, "dec", sd)
    sd = {k[len("dec."):]: v for k, v in sd.items()}
    sd["vj_relation"] = torch.as_tensor(vj, dtype=torch.long)
    model.load_state_dict(sd, strict=True)
    evo, mesh = model.train()(torch.from_numpy(joints),
                              torch.from_numpy(feats),
                              generator=torch.Generator().manual_seed(0))
    loss = (mesh * torch.from_numpy(cm)).sum() + (
        evo * torch.from_numpy(ce)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    g_want = {}
    convert._decoder(jax.device_get(want_grads), "dec", g_want)
    largest = max(float(g.abs().max()) for g in g_want.values())
    for name, p in model.named_parameters():
        want = g_want[f"dec.{name}"].numpy()
        if p.grad is None:
            # Only the last block's joint stream reaches the output.
            assert name.startswith("coevoblock"), name
            assert not want.any(), name
        elif np.abs(want).max() < 1e-6 * largest:
            # The key biases: zero up to rounding on both sides.
            assert name.endswith(("wk.bias", "normk.mlp_beta.weight",
                                  "normk.mlp_beta.bias")), name
            assert np.abs(p.grad.numpy() - want).max() <= 1e-4 * largest
        else:
            err = np.abs(p.grad.numpy() - want).max() / np.abs(want).max()
            assert err <= 1e-4, name
