"""Weights across the two packages: convert.py and the reference names.

- ``import_pmce(state_dict_from_jax(params))`` gives the JAX tree back
  exactly (same structure, bit-equal leaves), at reduced widths and at full
  width (shapes from ``jax.eval_shape``, values from numpy);
- the port's state_dict has the reference's names and shapes, so a
  reference checkpoint loads with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from pmce_tpu.models.pmce import PMCE as JaxPMCE
from pmce_tpu_torch.convert import state_dict_from_jax
from pmce_tpu_torch.models.pmce import PMCE

from torch_port_common import init_shapes, numpy_params  # puts tools/ on path

import torch_reference as ref  # noqa: E402
from import_torch_checkpoint import import_pmce  # noqa: E402

T = 16
REDUCED = dict(embed_dim=64, depth=3, num_vertx=31, num_verts_full=97,
               joint_dim=64, vertx_dim=64, gru_hidden=128)
FULL = dict(embed_dim=256, depth=3, num_vertx=431, num_verts_full=6890,
            joint_dim=64, vertx_dim=64, gru_hidden=1024)


def _vj(J, V, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(int(i) for i in rng.integers(0, J, size=V))


def _jax_tree(J, cfg, seed):
    jm = JaxPMCE(num_joint=J, vj_relation=_vj(J, cfg["num_vertx"]), **cfg)
    shapes = init_shapes(jm, np.zeros((1, T, J, 2), np.float32),
                         np.zeros((1, T, 2048), np.float32))
    return numpy_params(shapes, seed)


def _assert_same_tree(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(a),
                            jax.tree.leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape, jax.tree_util.keystr(path)
        assert np.array_equal(x, y), jax.tree_util.keystr(path)


@pytest.mark.parametrize("J,cfg", [(17, REDUCED), (19, REDUCED), (19, FULL)],
                         ids=["reduced-h36m17", "reduced-coco19", "full"])
def test_state_dict_round_trips_through_import_pmce(J, cfg):
    params = _jax_tree(J, cfg, seed=J)
    sd = state_dict_from_jax(params)
    _assert_same_tree(import_pmce(sd, depth=cfg["depth"]), params)


@pytest.mark.parametrize("J,cfg", [(17, REDUCED), (19, FULL)],
                         ids=["reduced-h36m17", "full"])
def test_port_names_and_shapes_are_the_reference_state_dict(J, cfg):
    vj = _vj(J, cfg["num_vertx"])
    tm = ref.PMCE(J, cfg["embed_dim"], cfg["depth"], vj,
                  num_vertx=cfg["num_vertx"],
                  num_verts_full=cfg["num_verts_full"],
                  joint_dim=cfg["joint_dim"], vertx_dim=cfg["vertx_dim"],
                  gru_hidden=cfg["gru_hidden"])
    pm = PMCE(num_joint=J, vj_relation=vj, **cfg)
    want = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert got == want


@pytest.mark.parametrize("J", [17, 19])
def test_reference_checkpoint_loads_strict(J):
    vj = _vj(J, REDUCED["num_vertx"], seed=J)
    tm = ref.PMCE(J, REDUCED["embed_dim"], REDUCED["depth"], vj,
                  num_vertx=31, num_verts_full=97, joint_dim=64,
                  vertx_dim=64, gru_hidden=128)
    pm = PMCE(num_joint=J, vj_relation=vj, **REDUCED)
    pm.load_state_dict(tm.state_dict(), strict=True)
    for k, v in tm.state_dict().items():
        assert torch.equal(pm.state_dict()[k], v), k


def test_converted_jax_params_load_strict():
    J = 19
    vj = _vj(J, REDUCED["num_vertx"])
    params = _jax_tree(J, REDUCED, seed=5)
    pm = PMCE(num_joint=J, vj_relation=vj, **REDUCED)
    pm.load_state_dict(state_dict_from_jax({"params": params}, vj),
                       strict=True)
    kernel = params["pose_lifter"]["spatial_block0"]["attn"]["qkv"]["kernel"]
    assert np.array_equal(
        pm.pose_lifter.SpatialBlocks[0].attn.qkv.weight.detach().numpy(),
        kernel.T)
    fw = pm.pose_lifter.fusion.weight
    assert tuple(fw.shape) == (1, T, 1, 1)
    assert np.array_equal(fw.detach().reshape(-1).numpy(),
                          params["pose_lifter"]["fusion_weight"])
