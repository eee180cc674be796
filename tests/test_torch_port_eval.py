"""The port's evaluation math against the JAX package, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages.

- ``similarity_transform`` / ``rigid_align`` (batched Procrustes, f32 on
  both sides): PA-MPJPE within 1e-4 mm, the aligned points and the
  translation within 8 f32 ulps of the largest coordinate, scale and
  rotation within 1e-5, including a reflected target, which takes the
  det(R) < 0 branch (the flip is checked to have happened);
- each function of ``ops/metrics.py`` and ``ops/coords.py`` (f32: 1e-5 of
  the largest magnitude; the numpy bbox helpers equal);
- ``evaluate_mesh`` / ``evaluate_joints`` on the same arrays, with a keep
  mask and action ids: PA-MPJPE within 1e-4 mm (the one batched Procrustes
  pass), every other number equal (the same numpy operations);
- ``sequence_accel_error`` bit for bit;
- ``tests/test_protocol_golden.py``'s goldens reproduced by the port's
  ``Human36M`` and ``PW3D`` at that test's own rtol.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmce_tpu.data import evaluation as jev
from pmce_tpu.ops import coords as jcoords
from pmce_tpu.ops import metrics as jmetrics
from pmce_tpu.ops import procrustes as jproc
from pmce_tpu_torch.data import evaluation as ev
from pmce_tpu_torch.data.datasets import PW3D, Human36M
from pmce_tpu_torch.ops import coords, metrics, procrustes
from pmce_tpu_torch.smpl.artifacts import synthetic_artifacts

from test_protocol_golden import GOLDEN

PA_TOL_MM = 1e-4
# Aligned coordinates: both sides round f32 sums of the same products in
# another order; 8 f32 ulps of the largest coordinate (measured: 4.9e-4 mm
# at 1300 mm, 3 ulps).
F32_REL = 2.0 ** -20


def _pair(seed, n=24, J=14, reflect=False):
    """Joint sets in mm, the target a scaled, rotated, shifted and noisy
    copy of the source (``reflect``: mirrored in x, so that the best
    rotation would be improper)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(scale=300.0, size=(n, J, 3))
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q *= np.sign(np.linalg.det(q))[:, None, None]
    B = 1.1 * np.einsum("nij,nkj->nki", q, A) + rng.normal(
        scale=200.0, size=(n, 1, 3)) + rng.normal(scale=10.0, size=A.shape)
    if reflect:
        B[..., 0] *= -1
    return A.astype(np.float32), B.astype(np.float32)


@pytest.mark.parametrize("reflect", [False, True],
                         ids=["proper", "reflected"])
def test_procrustes_matches_jax(reflect):
    A, B = _pair(1 + reflect, reflect=reflect)
    ta, tb = torch.from_numpy(A), torch.from_numpy(B)
    c, R, t = procrustes.similarity_transform(ta, tb)
    jc, jR, jt = jproc.similarity_transform(jnp.asarray(A), jnp.asarray(B))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0,
                               atol=F32_REL * np.abs(B).max())
    # Every R is a rotation; the reflected case needed the sign fix.
    assert torch.allclose(torch.linalg.det(R), torch.ones(len(A)),
                          atol=1e-5)
    U, _, Vh = torch.linalg.svd(torch.einsum(
        "nki,nkj->nij", ta - ta.mean(1, keepdim=True),
        tb - tb.mean(1, keepdim=True)))
    flipped = torch.linalg.det(Vh.transpose(-1, -2) @ U.transpose(-1, -2)) < 0
    assert bool(flipped.all()) if reflect else not bool(flipped.any())
    got = procrustes.rigid_align(ta, tb).numpy()
    want = np.asarray(jproc.rigid_align(jnp.asarray(A), jnp.asarray(B)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=F32_REL * np.abs(B).max())
    # The protocol's number, PA-MPJPE, within 1e-4 mm.
    pa = metrics.per_joint_error(torch.from_numpy(got), tb).mean()
    assert abs(float(pa) - float(jmetrics.pa_mpjpe(
        jnp.asarray(A), jnp.asarray(B)))) <= PA_TOL_MM


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


def test_metrics_match_jax():
    A, B = _pair(3)
    ta, tb = torch.from_numpy(A), torch.from_numpy(B)
    ja, jb = jnp.asarray(A), jnp.asarray(B)
    _close(metrics.per_joint_error(ta, tb), jmetrics.per_joint_error(ja, jb))
    for root in (0, 3, None):
        _close(metrics.mpjpe(ta, tb, root), jmetrics.mpjpe(ja, jb, root))
    _close(metrics.pa_mpjpe(ta, tb), jmetrics.pa_mpjpe(ja, jb))
    _close(metrics.mpvpe(ta, tb), jmetrics.mpvpe(ja, jb))
    _close(metrics.accel(ta), jmetrics.accel(ja))
    _close(metrics.accel_error(ta, tb), jmetrics.accel_error(ja, jb))


def test_coordinate_transforms_match_jax():
    rng = np.random.default_rng(4)
    cam = rng.normal(scale=500.0, size=(3, 10, 3)).astype(np.float32)
    cam[..., 2] = np.abs(cam[..., 2]) + 3000.0
    f = rng.uniform(900, 1200, size=(3, 2)).astype(np.float32)
    c = rng.uniform(400, 600, size=(3, 2)).astype(np.float32)
    R = np.linalg.qr(rng.normal(size=(3, 3, 3)))[0].astype(np.float32)
    t = rng.normal(scale=100.0, size=(3, 3)).astype(np.float32)
    T = torch.from_numpy
    pix = coords.cam2pixel(T(cam), T(f), T(c))
    _close(pix, jcoords.cam2pixel(cam, f, c))
    _close(coords.world2cam(T(cam), T(R), T(t)),
           jcoords.world2cam(cam, R, t))
    _close(coords.pixel2cam(pix, T(c), T(f)),
           jcoords.pixel2cam(jnp.asarray(pix.numpy()), c, f))
    _close(coords.pixel2cam(pix, T(c), T(f)), cam, tol=1e-5)
    xy = pix[..., :2]
    _close(coords.normalize_screen_coordinates(xy, 1000, 1002),
           jcoords.normalize_screen_coordinates(xy.numpy(), 1000, 1002))
    w = np.array([1000.0, 640.0, 1920.0], np.float32)
    h = np.array([1000.0, 480.0, 1080.0], np.float32)
    _close(coords.normalize_screen_coordinates(xy, T(w), T(h)),
           jcoords.normalize_screen_coordinates(xy.numpy(), w, h))
    cam3 = rng.normal(size=(3, 3)).astype(np.float32)
    _close(coords.weak_perspective_project(T(cam), T(cam3), 112.0),
           jcoords.weak_perspective_project(cam, cam3, 112.0))


@pytest.mark.parametrize("bbox", [(10.0, 20.0, 200.0, 100.0),
                                  (5.0, 5.0, 50.0, 300.0),
                                  (0.0, 0.0, 64.0, 64.0),
                                  (3.0, 4.0, 0.0, 10.0),
                                  (3.0, 4.0, 0.5, 10.0)])
def test_bbox_helpers_match_jax(bbox):
    bbox = np.array(bbox, np.float32)
    for ar, scale in ((1.0, 1.0), (0.75, 1.25)):
        got = coords.process_bbox(bbox.copy(), ar, scale)
        want = jcoords.process_bbox(bbox.copy(), ar, scale)
        if want is None:
            assert got is None
            continue
        np.testing.assert_array_equal(got, want)
        for a, b in zip(coords.get_center_scale(got),
                        jcoords.get_center_scale(want)):
            np.testing.assert_array_equal(a, b)
    joints = np.random.default_rng(5).uniform(0, 500, (17, 2))
    np.testing.assert_array_equal(coords.get_bbox(joints),
                                  jcoords.get_bbox(joints))


def _eval_case(seed=6, n=30, V=120):
    rng = np.random.default_rng(seed)
    gt = rng.normal(scale=400.0, size=(n, V, 3)).astype(np.float32)
    pred = gt + rng.normal(scale=20.0, size=gt.shape).astype(np.float32)

    def reg(k):
        jr = rng.random((k, V)).astype(np.float32)
        return jr / jr.sum(1, keepdims=True)

    names = np.array([f"s_00_vid_{i // 11:02d}" for i in range(n)])
    keep = rng.random(n) > 0.2
    actions = rng.integers(0, 15, size=n)
    actions[3] = 20            # outside the table: named by its number
    jr_h36m = reg(17)
    # Dataset GT joints: near the GT mesh's regressed joints, as the fits
    # that pass H36M's fitting gate are.
    gt_joints = (np.einsum("jv,nvk->njk", jr_h36m, gt) + rng.normal(
        scale=5.0, size=(n, 17, 3))).astype(np.float32)
    return pred, gt, reg(24), jr_h36m, names, keep, actions, gt_joints


@pytest.mark.parametrize("gt_joints", [False, True],
                         ids=["regressed-gt", "dataset-gt"])
def test_evaluate_mesh_matches_jax(gt_joints):
    pred, gt, jr_smpl, jr_h36m, names, keep, actions, gj = _eval_case()
    kw = dict(gt_h36m_joints=gj if gt_joints else None, keep_mask=keep,
              action_ids=actions)
    got = ev.evaluate_mesh(pred, gt, jr_smpl, jr_h36m, names, device="cpu",
                           **kw)
    want = jev.evaluate_mesh(pred, gt, jr_smpl, jr_h36m, names, **kw)
    for k in ("mpjpe", "mpvpe", "accel", "smpl_joint_error"):
        assert getattr(got, k) == getattr(want, k), k
    assert abs(got.pa_mpjpe - want.pa_mpjpe) <= PA_TOL_MM
    assert list(got.per_action) == list(want.per_action)
    assert "20" in got.per_action
    for k, (m, pa) in want.per_action.items():
        assert got.per_action[k][0] == m
        assert abs(got.per_action[k][1] - pa) <= PA_TOL_MM
    assert got.summary("H36M ").splitlines()[0] == \
        want.summary("H36M ").splitlines()[0]
    empty = ev.evaluate_mesh(pred, gt, jr_smpl, jr_h36m, names,
                             keep_mask=np.zeros(len(pred), bool),
                             device="cpu")
    assert (empty.mpjpe, empty.pa_mpjpe, empty.accel) == (0, 0, 0)


@pytest.mark.parametrize("root,subset", [(0, jev.H36M_EVAL_JOINTS),
                                         (-2, None)])
def test_evaluate_joints_matches_jax(root, subset):
    rng = np.random.default_rng(7)
    gt = rng.normal(scale=400.0, size=(25, 19, 3)).astype(np.float32)
    pred = gt + rng.normal(scale=30.0, size=gt.shape).astype(np.float32)
    names = np.array([f"v{i // 9}" for i in range(25)])
    keep = rng.random(25) > 0.3
    kw = dict(root_idx=root, eval_joints=subset, keep_mask=keep)
    got = ev.evaluate_joints(pred, gt, names, device="cpu", **kw)
    want = jev.evaluate_joints(pred, gt, names, **kw)
    assert (got.mpjpe, got.accel) == (want.mpjpe, want.accel)
    assert abs(got.pa_mpjpe - want.pa_mpjpe) <= PA_TOL_MM
    assert got.summary("x ") .count("\n") == 2


def test_sequence_accel_error_bit_for_bit():
    rng = np.random.default_rng(8)
    pred = rng.normal(size=(40, 14, 3))
    gt = rng.normal(size=(40, 14, 3))
    # Videos of 1, 2 and several windows, and a name that comes back.
    names = np.array(["a"] + ["b"] * 2 + ["c"] * 20 + ["a"] * 17)
    assert ev.sequence_accel_error(pred, gt, names) == \
        jev.sequence_accel_error(pred, gt, names)
    assert ev.sequence_accel_error(pred[:0], gt[:0], names[:0]) == 0.0
    assert ev.H36M_ACTION_NAMES == jev.H36M_ACTION_NAMES
    assert ev.H36M_EVAL_JOINTS == jev.H36M_EVAL_JOINTS


@pytest.mark.parametrize("name,cls", [("h36m", Human36M), ("pw3d", PW3D)])
def test_protocol_golden_in_the_port(name, cls):
    """The JAX package's frozen protocol outputs, from the port's dataset
    classes (synthesis and evaluation on the CPU)."""
    art = synthetic_artifacts(seed=0, num_verts=600, num_faces=1200)
    ds = cls.from_synthetic(art, split="test", num_videos=2,
                            frames_per_video=40, device="cpu")
    rng = np.random.default_rng(42)
    results = []
    for m in ds.mid_indices():
        gt_mesh = ds.data.mesh_cam[m]
        results.append({
            "mesh_coord": gt_mesh + rng.normal(scale=5.0,
                                               size=gt_mesh.shape),
            "mesh_coord_target": gt_mesh,
        })
    res = ds.evaluate(results, verbose=False)
    g = GOLDEN[name]
    np.testing.assert_allclose(res.mpjpe, g["mpjpe"], rtol=1e-4)
    np.testing.assert_allclose(res.pa_mpjpe, g["pa_mpjpe"], rtol=1e-3)
    np.testing.assert_allclose(res.mpvpe, g["mpvpe"], rtol=1e-4)
    np.testing.assert_allclose(res.accel, g["accel"], rtol=1e-4)


def test_full_f32_scopes_the_callers_tf32_flag():
    """The Procrustes products run with TF32 off and give the caller's
    flag back, whichever TF32 interface the caller set: setting
    ``torch.backends.cuda.matmul.allow_tf32`` around a call used to leave
    ``get_float32_matmul_precision`` raising on the next one (torch ≥ 2.9)."""
    from pmce_tpu_torch.smpl.layer import full_f32

    A, B = _pair(9)
    ta, tb = torch.from_numpy(A), torch.from_numpy(B)
    want = procrustes.rigid_align(ta, tb)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False, True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            with full_f32():
                assert not torch.backends.cuda.matmul.allow_tf32
            assert torch.backends.cuda.matmul.allow_tf32 is flag
            assert torch.equal(procrustes.rigid_align(ta, tb), want)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
