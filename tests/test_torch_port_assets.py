"""Port assets vs the JAX package: SMPL stand-in, coarsening, vj_relation.

The synthetic stand-ins must be bit-identical (same numpy random calls in
the same order), and ``build_vj_relation`` must give the identical
nearest-joint relation: the port computes the downsample as an f32 numpy
contraction where the JAX package uses a HIGHEST-precision f32 einsum.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest

from pmce_tpu.models import pmce as jax_pmce
from pmce_tpu.smpl import artifacts as jax_art
from pmce_tpu.smpl import mesh as jax_mesh
from pmce_tpu_torch.models import pmce as port_pmce
from pmce_tpu_torch.smpl import artifacts as port_art
from pmce_tpu_torch.smpl import mesh as port_mesh

SMALL_VERTS, SMALL_FACES = 600, 1200
SMALL_LEVELS = (600, 150, 40)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_artifacts_identical(seed):
    a = jax_art.synthetic_artifacts(seed, SMALL_VERTS, SMALL_FACES)
    b = port_art.synthetic_artifacts(seed, SMALL_VERTS, SMALL_FACES)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype, f.name
        assert np.array_equal(x, y), f.name


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_coarsening_identical(seed):
    a = jax_mesh.synthetic_coarsening(seed, SMALL_LEVELS)
    b = port_mesh.synthetic_coarsening(seed, SMALL_LEVELS)
    assert b.sizes == SMALL_LEVELS
    for x, y in zip(a.D + a.U, b.D + b.U):
        assert np.array_equal(x, y)


def test_artifact_and_coarsening_cache_paths_shared():
    same = lambda a, b: os.path.realpath(a) == os.path.realpath(b)  # noqa
    assert same(port_art.default_artifact_path(),
                jax_art.default_artifact_path())
    assert same(port_mesh.default_coarsening_path(),
                jax_mesh.default_coarsening_path())


def test_downsample_matches_jax():
    coarse = port_mesh.synthetic_coarsening(0, SMALL_LEVELS)
    x = np.random.default_rng(0).normal(size=(2, 600, 3)).astype(np.float32)
    want = np.asarray(jax_mesh.downsample(coarse, x, 0, 2))
    got_np = port_mesh.downsample(coarse, x, 0, 2)
    import torch

    got_t = port_mesh.downsample(coarse, torch.from_numpy(x), 0, 2).numpy()
    np.testing.assert_allclose(got_np, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_t, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("full", [False, True], ids=["small", "full"])
def test_vj_relation_identical(full):
    if full:
        art = jax_art.synthetic_artifacts(0)
        coarse = jax_mesh.synthetic_coarsening(0)
    else:
        art = jax_art.synthetic_artifacts(0, SMALL_VERTS, SMALL_FACES)
        coarse = jax_mesh.synthetic_coarsening(0, SMALL_LEVELS)
    want = jax_pmce.default_assets(art, coarse)
    got = port_pmce.default_assets(art, coarse)
    assert got.vj_relation == want.vj_relation
    assert len(got.vj_relation) == coarse.sizes[-1]
    assert np.array_equal(got.joint_regressor_h36m,
                          want.joint_regressor_h36m)
