"""The port's geometry and SMPL layer against the JAX package, on the CPU.

- ``ops/geometry.py``: every conversion against its JAX counterpart on the
  same numpy inputs, 1e-5 absolute on unit-scale rotations (f32 on both
  sides; the two differ only in the order of a few f32 operations).
- ``smpl/layer.py``: the forward on the plain path against JAX
  ``smpl_forward`` and against the float64 oracle of ``tests/oracles.py``,
  within 0.001 mm (1e-6 m) on a V = 600 synthetic body: every product in
  full f32 on both sides, as the JAX package pins ``Precision.HIGHEST``.
- ``smpl/kernels.py``: the plain skinning that the wrapper runs for CPU
  tensors against the JAX Pallas kernel ``fused_skinning``, interpreted,
  within 1e-6 m.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pmce_tpu.ops.geometry as jgeo
from pmce_tpu.smpl.kernels import fused_skinning as jax_fused_skinning
from pmce_tpu.smpl.layer import SMPLModel as JaxSMPL
from pmce_tpu.smpl.layer import regress_joints as jax_regress_joints
from pmce_tpu.smpl.layer import skinning_transforms as jax_transforms
from pmce_tpu.smpl.layer import smpl_forward as jax_smpl_forward
from pmce_tpu_torch.ops import _cuda
from pmce_tpu_torch.ops import geometry as tgeo
from pmce_tpu_torch.smpl import kernels as tkernels
from pmce_tpu_torch.smpl.artifacts import synthetic_artifacts
from pmce_tpu_torch.smpl.layer import SMPLModel, regress_joints, smpl_forward
from pmce_tpu_torch.smpl.layer import skinning_transforms

from oracles import smpl_forward_np

MM_1E3 = 1e-6   # 0.001 mm in meters


def _rotmats(rng, n):
    return np.array(jgeo.axis_angle_to_rotmat(
        jnp.asarray(rng.normal(scale=1.2, size=(n, 3)), jnp.float32)))


def _geometry_inputs(name, rng):
    n = 64
    if name in ("axis_angle_to_rotmat", "euler_to_rotmat"):
        # Include the zero rotation (the 1e-8 regulariser's case).
        a = rng.normal(scale=1.2, size=(n, 3))
        a[0] = 0.0
        return a.astype(np.float32)
    if name in ("quat_to_rotmat", "quat_to_axis_angle"):
        q = rng.normal(size=(n, 4))
        return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(
            np.float32)
    if name == "rot6d_to_rotmat":
        return rng.normal(size=(n, 6)).astype(np.float32)
    return _rotmats(rng, n)   # rotmat_to_quat, rotmat_to_axis_angle


GEOMETRY = ("axis_angle_to_rotmat", "quat_to_rotmat", "rot6d_to_rotmat",
            "rotmat_to_quat", "quat_to_axis_angle", "rotmat_to_axis_angle",
            "euler_to_rotmat")


@pytest.mark.parametrize("name", GEOMETRY)
def test_geometry_matches_jax(name):
    x = _geometry_inputs(name, np.random.default_rng(len(name)))
    want = np.asarray(getattr(jgeo, name)(jnp.asarray(x)))
    got = getattr(tgeo, name)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def body():
    art = synthetic_artifacts(seed=0, num_verts=600, num_faces=1200)
    rng = np.random.default_rng(7)
    pose = rng.normal(scale=0.4, size=(4, 72)).astype(np.float32)
    betas = rng.normal(scale=1.0, size=(4, 10)).astype(np.float32)
    trans = rng.normal(scale=0.5, size=(4, 3)).astype(np.float32)
    return art, pose, betas, trans


def _port(art, pose, betas, trans):
    model = SMPLModel.from_artifacts(art, device="cpu")
    assert model.device.type == "cpu"
    verts, joints = smpl_forward(
        model, torch.from_numpy(pose), torch.from_numpy(betas),
        None if trans is None else torch.from_numpy(trans))
    return verts.numpy(), joints.numpy()


@pytest.mark.parametrize("with_trans", [True, False])
def test_smpl_forward_matches_jax_and_f64_oracle(body, with_trans):
    art, pose, betas, trans = body
    trans = trans if with_trans else None
    _cuda.reset_launch_counts()
    verts, joints = _port(art, pose, betas, trans)
    assert not any(_cuda.launch_counts().values())
    assert verts.shape == (4, 600, 3) and joints.shape == (4, 24, 3)
    jv, jj = jax_smpl_forward(
        JaxSMPL.from_artifacts(art), jnp.asarray(pose), jnp.asarray(betas),
        None if trans is None else jnp.asarray(trans), fused=False)
    ov, oj = smpl_forward_np(art, pose, betas, trans)
    for got, want in ((verts, np.asarray(jv)), (joints, np.asarray(jj)),
                      (verts, ov), (joints, oj)):
        np.testing.assert_allclose(got, want, rtol=0, atol=MM_1E3)


def test_skinning_transforms_and_regressor_match_jax(body):
    art, pose, betas, _ = body
    model = SMPLModel.from_artifacts(art, device="cpu")
    got = skinning_transforms(model, torch.from_numpy(pose),
                              torch.from_numpy(betas))
    want = jax_transforms(JaxSMPL.from_artifacts(art), jnp.asarray(pose),
                          jnp.asarray(betas))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=MM_1E3)
    verts = got[0]
    np.testing.assert_allclose(
        regress_joints(model.J_regressor, verts).numpy(),
        np.asarray(jax_regress_joints(jnp.asarray(art.J_regressor),
                                      jnp.asarray(verts.numpy()))),
        rtol=0, atol=MM_1E3)


def test_plain_skinning_matches_jax_pallas_kernel(body):
    art, pose, betas, _ = body
    model = SMPLModel.from_artifacts(art, device="cpu")
    v_posed, A_skin, _ = skinning_transforms(
        model, torch.from_numpy(pose), torch.from_numpy(betas))
    _cuda.reset_launch_counts()
    got = tkernels.fused_skinning(v_posed, A_skin, model.lbs_weights)
    assert tkernels.SKINNING_LAUNCHES.count == 0   # plain version on the CPU
    want = jax_fused_skinning(jnp.asarray(v_posed.numpy()),
                              jnp.asarray(A_skin.numpy()),
                              jnp.asarray(art.lbs_weights), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=MM_1E3)


def test_skinning_entry_rejects_devices_without_a_kernel():
    with pytest.raises(ValueError, match="unsupported device"):
        tkernels.fused_skinning(torch.empty(2, 600, 3, device="meta"),
                                torch.empty(2, 24, 4, 4, device="meta"),
                                torch.empty(600, 24, device="meta"))


def test_smpl_model_defaults_to_the_card():
    import inspect

    default = inspect.signature(SMPLModel.from_artifacts).parameters[
        "device"].default
    assert default == "cuda"
