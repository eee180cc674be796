"""The port's 2D noise and occlusion models against the JAX package's.

``pmce_tpu_torch/data/{noise,noise_stats,occlusion}.py`` are numpy copies:
with the same inputs and the same ``np.random.Generator`` state they must
give the same arrays, bit for bit, and leave the generator in the same
state (tolerance: none).
"""

from __future__ import annotations

import numpy as np
import pytest

from pmce_tpu.data import noise as jnoise
from pmce_tpu.data import noise_stats as jstats
from pmce_tpu.data import occlusion as jocc
from pmce_tpu_torch.data import noise as tnoise
from pmce_tpu_torch.data import noise_stats as tstats
from pmce_tpu_torch.data import occlusion as tocc


def _pair(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


def test_noise_tables_equal_jax():
    np.testing.assert_array_equal(tnoise.KPS_SIGMAS, jnoise.KPS_SIGMAS)
    assert tnoise.KPS_SYMMETRY == jnoise.KPS_SYMMETRY
    assert tstats.MEASURED_ERROR_DISTRIBUTION == \
        jstats.MEASURED_ERROR_DISTRIBUTION
    assert tstats.H36M_JOINTS_NAME == jstats.H36M_JOINTS_NAME
    for area in (50.0, 4e4, 3e5):
        for ks in (0.1, 0.5, 0.85):
            np.testing.assert_array_equal(tnoise.oks_distance(ks, area),
                                          jnoise.oks_distance(ks, area))


@pytest.mark.parametrize("num_valid", [17, 14, 9, 4, 0])
def test_synthesize_pose_matches_jax_bit_for_bit(num_valid):
    """Every branch of the channel priors (more than 10, 6-10 and at most 5
    valid joints, no partner for an inversion) over 40 draws each."""
    rng = np.random.default_rng(num_valid)
    ra, rb = _pair(100 + num_valid)
    for _ in range(40):
        joints = np.concatenate([
            rng.uniform(0, 640, (17, 2)),
            np.zeros((17, 1))], axis=1).astype(np.float32)
        joints[rng.permutation(17)[:num_valid], 2] = 1.0
        area = float(rng.uniform(1e3, 2e5))
        got = tnoise.synthesize_pose(joints, area, ra)
        want = jnoise.synthesize_pose(joints, area, rb)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert ra.bit_generator.state == rb.bit_generator.state


def test_error_distribution_matches_jax(tmp_path):
    t, j = tstats.ErrorDistribution(), jstats.ErrorDistribution()
    for name in ("mean", "std", "weight"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    ra, rb = _pair(7)
    joints = np.random.default_rng(8).uniform(0, 1000, (5, 16, 17, 2))
    np.testing.assert_array_equal(t.perturb(joints, ra),
                                  j.perturb(joints, rb))
    assert ra.bit_generator.state == rb.bit_generator.state
    # A file either package saves loads into the other.
    t.save(str(tmp_path / "t.npz"))
    j.save(str(tmp_path / "j.npz"))
    for a, b in ((jstats.ErrorDistribution.load(str(tmp_path / "t.npz")), t),
                 (tstats.ErrorDistribution.load(str(tmp_path / "j.npz")), j)):
        np.testing.assert_array_equal(a.std, b.std)


@pytest.mark.parametrize("prob", [0.0, 0.5, 1.0])
def test_occlude_batch_matches_jax_bit_for_bit(prob):
    """All three occluder kinds (solid, noise, gradient) appear over the
    batch at prob 1."""
    images = np.random.default_rng(3).integers(
        0, 255, (24, 64, 48, 3)).astype(np.uint8)
    ra, rb = _pair(11)
    got = tocc.occlude_batch(images, ra, prob)
    want = jocc.occlude_batch(images, rb, prob)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert ra.bit_generator.state == rb.bit_generator.state
    changed = (got != images).any(axis=(1, 2, 3)).sum()
    assert changed == 0 if prob == 0 else changed > 0


def test_sample_occluder_kinds_match_jax():
    ra, rb = _pair(5)
    for _ in range(30):
        a = tocc.sample_occluder(ra, (96, 72), (0.05, 0.3))
        b = jocc.sample_occluder(rb, (96, 72), (0.05, 0.3))
        np.testing.assert_array_equal(a, b)
