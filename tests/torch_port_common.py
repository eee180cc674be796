"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_port_*).

Weights and inputs are drawn with numpy from a seed and handed to both
packages: the JAX package takes the numpy tree, the port takes it through
``pmce_tpu_torch.convert.state_dict_from_jax``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS.parent / "tools"))
sys.path.insert(0, str(TESTS))

from torch_port_init import perturbed_init  # noqa: E402,F401  (re-exported)


def numpy_params(shapes, seed: int):
    """Fill a tree of ShapeDtypeStructs (``jax.eval_shape`` of an init)
    with seeded numpy values: products N(0, 1/fan_in), LayerNorm scales
    1 + N(0, 0.02²), biases N(0, 0.02²), embeds N(0, 0.5²), the frame
    fusion U(±1/√T). No leaf is degenerate, so a swapped or dropped weight
    shows in the outputs."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.normal(size=shape, scale=fan_in ** -0.5)
        elif name == "scale":
            v = 1.0 + rng.normal(size=shape, scale=0.02)
        elif name == "fusion_weight":
            v = rng.uniform(-1, 1, size=shape) * shape[0] ** -0.5
        elif name.endswith("_embed"):
            v = rng.normal(size=shape, scale=0.5)
        else:
            v = rng.normal(size=shape, scale=0.02)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def numpy_variables(model, x, seed: int) -> dict:
    """Seeded numpy values for every leaf of ``model``'s variables:
    products N(0, 1/fan_in), scales 1 + N(0, 0.1²), biases N(0, 0.1²),
    position embeddings N(0, 0.5²), batch means N(0, 0.5²) and variances
    U(0.5, 2)."""
    shapes = jax.eval_shape(
        lambda a: model.init(jax.random.PRNGKey(0), a), jnp.asarray(x))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = leaf.shape
        if name == "kernel":
            v = rng.normal(size=shape, scale=np.prod(shape[:-1]) ** -0.5)
        elif name == "scale":
            v = 1.0 + rng.normal(size=shape, scale=0.1)
        elif name == "mean":
            v = rng.normal(size=shape, scale=0.5)
        elif name == "var":
            v = rng.uniform(0.5, 2.0, size=shape)
        elif name.endswith("_embed"):
            v = rng.normal(size=shape, scale=0.5)
        else:
            v = rng.normal(size=shape, scale=0.1)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def init_shapes(model, *args):
    """Parameter shapes of a flax model, without running its init."""
    return jax.eval_shape(
        lambda *a: model.init(jax.random.PRNGKey(0), *a),
        *[jnp.asarray(a) for a in args])["params"]


def rel_max_err(ref, out) -> float:
    ref = np.asarray(ref, np.float32)
    out = np.asarray(out, np.float32)
    assert np.abs(ref).max() > 1e-3, "degenerate reference output"
    return float(np.abs(out - ref).max() / np.abs(ref).max())
