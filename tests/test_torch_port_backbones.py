"""The demo's backbones in the port against the JAX package, on the CPU.

The same seeded numpy weights (random BatchNorm statistics, so that the
inference path's normalization counts) and inputs go through the JAX
models and, converted by ``pmce_tpu_torch.convert``, through the port's:
SPIN's ResNet-50 (width 8) and HMR, ViTPose-tiny at its 256×192 crops,
and the heatmap decoding. The port's state_dicts also go back through
``tools/import_backbones.py``'s torch-checkpoint importers to the same JAX
variables, which shows that they carry torchvision's, SPIN's and mmpose's
names. f32 throughout; bounds are max|port − JAX| / max|JAX|.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import numpy_variables, rel_max_err
from import_backbones import (
    import_resnet50,
    import_spin_hmr,
    import_vitpose,
)
from pmce_tpu.models import spin as jspin
from pmce_tpu.models import vitpose as jvp
from pmce_tpu_torch import convert
from pmce_tpu_torch.models import spin, vitpose

REL_TOL = 1e-4


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def crops(n: int, hw: tuple, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (n, 3, *hw)).astype(np.float32)


def port_state(state: dict) -> dict:
    """A port module's state_dict as numpy, as a torch checkpoint's."""
    return {k: v.numpy() for k, v in state.items()}


def test_resnet50_matches_jax():
    x = crops(2, (64, 48), 0)
    jm = jspin.ResNet50(width=8)
    variables = numpy_variables(jm, x, seed=1)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))

    model = spin.ResNet50(width=8)
    model.load_state_dict(convert.resnet50_state_dict_from_jax(variables))
    got = spin.feature_extractor_apply(model.eval(), torch.from_numpy(x))
    assert got.shape == (2, 256) and got.dtype == torch.float32
    assert rel_max_err(want, got) < REL_TOL
    # torchvision names: the importer of a torch checkpoint gives back
    # the same JAX variables.
    back = import_resnet50(port_state(model.state_dict()))
    jax.tree.map(np.testing.assert_array_equal, back, numpy_tree(variables))


def test_hmr_matches_jax():
    layers = (1, 1, 1, 1)
    x = crops(3, (64, 48), 2)
    jm = jspin.HMR(layers=layers, width=8, hidden=32)
    variables = numpy_variables(jm, x, seed=3)
    want_feat, want = jm.apply(variables, jnp.asarray(x),
                               return_features=True)

    model = spin.HMR(layers=layers, width=8, hidden=32).eval()
    model.load_state_dict(convert.hmr_state_dict_from_jax(variables))
    with torch.no_grad():
        feat, got = model(torch.from_numpy(x), return_features=True)
    assert rel_max_err(want_feat, feat) < REL_TOL
    for k in ("rotmat", "shape", "cam", "pose6d"):
        assert got[k].shape == want[k].shape, k
        assert rel_max_err(want[k], got[k]) < REL_TOL, k
    back = import_spin_hmr(port_state(model.state_dict()), layers)
    jax.tree.map(np.testing.assert_array_equal, back, numpy_tree(variables))
    # The regressor alone on the same features.
    reg = spin.SMPLRegressor(feat_dim=256, hidden=32).eval()
    reg.load_state_dict({k: v for k, v in model.state_dict().items()
                         if k.split(".")[0] in ("fc1", "fc2", "decpose",
                                                "decshape", "deccam")})
    with torch.no_grad():
        alone = reg(feat)
    for k in ("rotmat", "shape", "cam"):
        torch.testing.assert_close(alone[k], got[k], rtol=0, atol=0)


@pytest.fixture(scope="module")
def vitpose_pair():
    cfg = jvp.ViTPoseConfig.tiny()
    x = crops(2, cfg.img_size, 4)
    jm = jvp.ViTPose(cfg)
    variables = numpy_variables(jm, x, seed=5)
    model = vitpose.ViTPose(vitpose.ViTPoseConfig.tiny()).eval()
    model.load_state_dict(convert.vitpose_state_dict_from_jax(variables))
    return jm, variables, model, x


def test_vitpose_tiny_matches_jax(vitpose_pair):
    jm, variables, model, x = vitpose_pair
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (2, 17, 64, 48) and got.dtype == torch.float32
    assert rel_max_err(want, got) < REL_TOL
    # mmpose names, the cls slot of pos_embed included.
    sd = port_state(model.state_dict())
    assert sd["backbone.pos_embed"].shape == (1, 16 * 12 + 1, 64)
    back = import_vitpose(sd, depth=model.cfg.depth)
    jax.tree.map(np.testing.assert_array_equal, back, numpy_tree(variables))
    # Decoding the real heatmaps: the same keypoints and scores.
    kj, sj = jvp.decode_heatmaps(jnp.asarray(want))
    kp, sp = vitpose.decode_heatmaps(torch.tensor(want))
    np.testing.assert_array_equal(kp.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))


@torch.no_grad()
def test_vitpose_fresh_weights_shapes():
    """The port's own initial values fill every parameter (flax's
    distributions, drawn from a generator) and run."""
    cfg = vitpose.ViTPoseConfig(img_size=(64, 48), embed_dim=32, depth=1,
                                num_heads=2, deconv_channels=8)
    model = vitpose.ViTPose(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    pos = model.backbone.pos_embed
    assert float(pos.abs().max()) <= 0.04
    assert float(pos.std()) > 0.005
    hm = model.eval()(torch.from_numpy(crops(1, (64, 48), 6)))
    assert hm.shape == (1, 17, 16, 12) and bool(torch.isfinite(hm).all())


def heatmap_cases() -> dict:
    rng = np.random.default_rng(7)
    N, K, h, w = 2, 17, 16, 12
    cases = {"random": rng.standard_normal((N, K, h, w)).astype(np.float32)}
    border = np.zeros((N, K, h, w), np.float32)
    # Peaks on every border and next to it, with a downhill neighbour on
    # one side (where an unconditional offset would leave the map).
    spots = [(0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1), (1, 5), (5, 1),
             (h - 2, 5), (5, w - 2), (2, 2), (h - 3, w - 3), (7, 6)]
    for k, (y, x) in enumerate(spots):
        border[:, k, y, x] = 1.0
        border[:, k, y, min(x + 1, w - 1)] = 0.5
        border[:, k, max(y - 1, 0), x] = 0.25
    cases["border"] = border
    tie = rng.uniform(0, 0.5, (N, K, h, w)).astype(np.float32)
    # Equal maxima: the first in row-major order wins on both sides.
    tie[:, :, 3, 4] = tie[:, :, 9, 2] = tie[:, :, 3, 9] = 1.0
    tie[:, 5] = 0.0                                    # all equal
    cases["tie"] = tie
    return cases


@pytest.mark.parametrize("case", ["random", "border", "tie"])
def test_decode_heatmaps_equal(case):
    hm = heatmap_cases()[case]
    kj, sj = jvp.decode_heatmaps(jnp.asarray(hm))
    kp, sp = vitpose.decode_heatmaps(torch.from_numpy(hm))
    np.testing.assert_array_equal(kp.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    if case == "tie":
        # The first maximum, (x, y) = (4, 3), ± the quarter offset.
        np.testing.assert_allclose(kp[:, 0].numpy(),
                                   np.broadcast_to([4.0, 3.0], (2, 2)),
                                   rtol=0, atol=0.25)
        np.testing.assert_array_equal(kp[:, 5].numpy(), 0.0)


def test_heatmap_to_image_coords_equal():
    rng = np.random.default_rng(8)
    kps = rng.uniform(0, 48, (5, 17, 2)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(-50, 200, (5, 2)),
                            rng.uniform(20, 300, (5, 2))],
                           1).astype(np.float32)
    want = jvp.heatmap_to_image_coords(kps, boxes, (64, 48), (256, 192))
    got = vitpose.heatmap_to_image_coords(kps, boxes, (64, 48), (256, 192))
    np.testing.assert_array_equal(got, want)
