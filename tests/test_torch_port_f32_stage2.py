"""f32 Stage-2 training through the decoder's fused blocks, on the CPU.

A small PMCE in f32 (a V = 600 synthetic body coarsened to 72 vertices,
over 64, so that JAX's gates ``pmce_tpu/models/layers.py:557-558`` and
``:623-624`` send the vertex stream's self-attention and both
cross-attentions to ``fused_ada_block`` / ``fused_ca_block``), embed 32,
depth 1, GRU width 32, batch 8:

- the loss and every gradient of the port's fused route (``fused=True``,
  training mode: ``ada_block`` / ``ca_block``, on the CPU their plain
  versions) against ``jax.value_and_grad`` through JAX's interpreted
  Pallas kernels and their custom VJPs, both at drop-path rate 0 (JAX's
  draws cannot be the port's): loss within 1e-5 relative, each gradient
  within 1e-4 of its largest magnitude;
- the port's fused route against its modular route at drop path 0.2 from
  the same generator (so the masks reach the same modules in the same
  order; a mask that differs moves them by whole per cent): the loss
  within 1e-5, each gradient within 1e-4 of its largest magnitude (the same
  f32 math in another order of sums through the whole model: measured
  2.5e-5 at most, in the lifter's regression bias), with the fused
  route's f32 block calls counted.
"""

from __future__ import annotations

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmce_tpu.core import losses as jlosses
from pmce_tpu.models import coevo as jcoevo
from pmce_tpu.models import pmce as jpmce
from pmce_tpu.models import pose_lifter as jlifter
from pmce_tpu_torch import convert
from pmce_tpu_torch.core import losses
from pmce_tpu_torch.core.trainer import pmce_loss
from pmce_tpu_torch.models.layers import DropPath
from pmce_tpu_torch.models.pmce import PMCE
from pmce_tpu_torch.ops import fused_attention as fa
from pmce_tpu_torch.smpl.artifacts import synthetic_artifacts

from torch_port_common import init_shapes, numpy_params

T, J, B, V, NV = 16, 17, 8, 600, 72
CFG = dict(embed_dim=32, depth=1, num_vertx=NV, num_verts_full=V,
           joint_dim=64, vertx_dim=64, gru_hidden=32, seqlen=T)
WEIGHTS = (0.1, 20.0, 1e-3)   # MODEL normal / edge / joint loss weights
KEY_BIASES = ("wk.bias", "normk.mlp_beta.weight", "normk.mlp_beta.bias")
ORDER = ("mesh", "lift_pose3d", "reg_pose3d", "mesh_valid",
         "lift_pose3d_valid", "reg_pose3d_valid")


class _NoDropLifter(jlifter.PoseLifter):
    """JAX's lifter at drop-path rate 0: its training mode then draws no
    masks, which the port can match."""

    drop_path_rate: float = 0.0


class _NoDropCoevoBlock(jcoevo.CoevoBlock):
    drop_path: float = 0.0


@pytest.fixture(scope="module")
def case():
    art = synthetic_artifacts(seed=0, num_verts=V, num_faces=1200)
    rng = np.random.default_rng(20)
    jr = rng.random((J, V)).astype(np.float32)
    jr /= jr.sum(1, keepdims=True)
    vj = tuple(int(i) for i in rng.integers(0, J, size=NV))

    def mask(*shape):
        return (rng.random(shape) > 0.2).astype(np.float32)

    batch = {
        "pose2d": rng.standard_normal((B, T, J, 2), dtype=np.float32),
        "img_feature": rng.standard_normal((B, T, 2048), dtype=np.float32),
        "mesh": (rng.normal(size=(B, V, 3)) * 0.1).astype(np.float32),
        "lift_pose3d": (rng.normal(size=(B, J, 3)) * 300).astype(np.float32),
        "reg_pose3d": (rng.normal(size=(B, J, 3)) * 300).astype(np.float32),
        "mesh_valid": mask(B, 1, 1), "lift_pose3d_valid": mask(B, J, 1),
        "reg_pose3d_valid": mask(B, J, 1)}
    return art, jr, vj, batch


def _port_loss(model, art, jr, batch, gen):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = pmce_loss(model, tb, torch.as_tensor(art.faces),
                        torch.from_numpy(jr), WEIGHTS, 1.0,
                        losses.build_face_losses(art.faces, V, "cpu"), gen)
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


def test_fused_stage2_loss_and_gradients_match_jax_f32(case):
    art, jr, vj, batch = case
    jm = jpmce.PMCE(num_joint=J, vj_relation=vj, fused_attn=True, **CFG)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jface = jlosses.build_face_losses(art.faces, V)
    with mock.patch.object(jpmce, "PoseLifter", _NoDropLifter), \
            mock.patch.object(jcoevo, "CoevoBlock", _NoDropCoevoBlock):
        params = numpy_params(init_shapes(jm, batch["pose2d"][:1],
                                          batch["img_feature"][:1]), 20)

        def jloss(p):
            mesh, evo, pose3d = jm.apply(
                {"params": p}, jb["pose2d"], jb["img_feature"],
                deterministic=False,
                rngs={"droppath": jax.random.PRNGKey(0),
                      "dropout": jax.random.PRNGKey(1)})
            return jlosses.pmce_total_loss(
                mesh, evo, pose3d, *(jb[k] for k in ORDER),
                jnp.asarray(art.faces), jnp.asarray(jr), *WEIGHTS, 1.0,
                face_loss_fn=jface)[0]

        # JAX's training route runs the Pallas AdaLN and CA blocks (and
        # their custom VJPs), not the inference chain.
        with mock.patch.object(jfa_module(), "fused_ada_block",
                               wraps=jfa_module().fused_ada_block) as ada, \
                mock.patch.object(jfa_module(), "fused_ca_block",
                                  wraps=jfa_module().fused_ca_block) as ca:
            want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(
                jax.tree_util.tree_map(jnp.asarray, params))
        assert ada.call_count == 3 and ca.call_count == 6
    model = PMCE(num_joint=J, vj_relation=vj, dtype=None, fused=True, **CFG)
    model.load_state_dict(convert.state_dict_from_jax(params, vj),
                          strict=True)
    for mod in model.modules():
        if isinstance(mod, DropPath):
            mod.rate = 0.0
    loss, grads = _port_loss(model.train(), art, jr, batch,
                             torch.Generator().manual_seed(0))
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    g_want = convert.state_dict_from_jax(jax.device_get(want_grads))
    largest = max(float(g.abs().max()) for g in g_want.values())
    for name, got in grads.items():
        want = g_want[name].numpy()
        if got is None:
            # Only the last block's joint stream reaches the output.
            assert name.startswith("pose_mesh_coevo.coevoblock"), name
            assert not want.any(), name
        elif np.abs(want).max() < 1e-6 * largest:
            # The key biases: zero but for rounding on both sides.
            assert name.endswith(KEY_BIASES), name
            assert np.abs(got.numpy() - want).max() <= 1e-4 * largest
        else:
            err = np.abs(got.numpy() - want).max() / np.abs(want).max()
            assert err <= 1e-4, (name, err)


def jfa_module():
    from pmce_tpu.ops import fused_attention

    return fused_attention


def test_fused_stage2_matches_the_modular_route_at_drop_path_0_2(case):
    """Drop path 0.2 (the recipe's): the fused route's three ``ada_block``
    and six ``ca_block`` calls a step, on f32 tokens with per-clip branch
    masks, give the modular route's loss (1e-5) and gradients (1e-4) from
    the same generator."""
    art, jr, vj, batch = case
    out = {}
    for fused in (True, False):
        torch.manual_seed(0)
        model = PMCE(num_joint=J, vj_relation=vj, dtype=None, fused=fused,
                     **CFG)
        with mock.patch.object(fa, "ada_block", wraps=fa.ada_block) as ada, \
                mock.patch.object(fa, "ca_block", wraps=fa.ca_block) as ca:
            out[fused] = _port_loss(model.train(), art, jr, batch,
                                    torch.Generator().manual_seed(7))
        calls = ada.call_args_list + ca.call_args_list
        assert (ada.call_count, ca.call_count) == ((3, 6) if fused
                                                   else (0, 0))
        assert all(c.args[0].dtype == torch.float32 for c in calls)
        assert all(c.args[-1] is not None and c.args[-1][0].shape == (B, 1, 1)
                   for c in calls)
    (loss_f, grads_f), (loss_m, grads_m) = out[True], out[False]
    assert abs(loss_f - loss_m) <= 1e-5 * abs(loss_m)
    assert grads_f.keys() == grads_m.keys()
    largest = max(float(g.abs().max()) for g in grads_m.values()
                  if g is not None)
    for name, g in grads_m.items():
        assert (g is None) == (grads_f[name] is None), name
        if g is None:
            continue
        # The key biases' gradients are zero but for rounding: held to the
        # model's largest gradient.
        scale = (largest if name.endswith(KEY_BIASES)
                 else float(g.abs().max()))
        err = float((grads_f[name] - g).abs().max()) / scale
        assert err <= 1e-4, (name, err)
