"""The port's video demo against the JAX package's, on the CPU.

Same seeded numpy inputs (and, for the models, the same weights through
``pmce_tpu_torch.convert``) through both packages:

- ``data.kp_utils``, ``data.aug``, ``smpl.joints``, ``demo.smooth_bbox``,
  the tracker (``iou_matrix``, ``track_video``) and ``video_io``'s array
  paths: equal;
- ``crop_resize_normalize`` and ``resize_frames``: within 1e-5 (of the
  0..255 scale), boxes partly outside the frame included;
- ``fit_cam_closed_form`` and ``convert_crop_cam_to_orig_img`` within
  1e-5, ``fit_cam_iterative`` (50 Adam steps) within 1e-4;
- the port's native rasterizer bit-identical to the JAX package's on the
  same mesh and camera, and within the JAX tests' bound of its own numpy
  version (±1 on at most 0.1 % of the pixels, the same skip decisions);
  the Hungarian assignment against the greedy matcher where the best pairs
  do not compete;
- the detector's forward, loss and ``decode_detections`` on the same
  weights (1e-5 relative), one Adam step (1e-5), the training renders;
- ``DemoPipeline.run`` on ``tests/test_demo_e2e.py``'s fixture (a 600-vertex
  synthetic body walking across 40 frames) with the detection keypoints,
  and with ViTPose-tiny on 30 frames: the same tracks and frames, meshes
  (m) and crop cameras within 1e-4, the full-frame cameras within 1e-4 of
  their largest magnitude;
- ``run_demo``: the card by default (without one it raises and names
  ``--device cpu``), real footage with random weights refused, and a small
  ``--synthetic`` run on the CPU that writes its outputs.
"""

from __future__ import annotations

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pmce_tpu.data import aug as jaug
from pmce_tpu.data import kp_utils as jkp
from pmce_tpu.demo import camera as jcam
from pmce_tpu.demo import detector as jdet
from pmce_tpu.demo import pipeline as jpipe
from pmce_tpu.demo import preprocess as jpre
from pmce_tpu.demo import renderer as jren
from pmce_tpu.demo import smooth_bbox as jsmooth
from pmce_tpu.demo import tracker as jtrack
from pmce_tpu.models.pmce import create_pmce as jax_create_pmce
from pmce_tpu.models.vitpose import ViTPose as JaxViTPose
from pmce_tpu.models.vitpose import ViTPoseConfig as JaxViTPoseConfig
from pmce_tpu.ops.coords import weak_perspective_project as jax_project
from pmce_tpu.smpl import joints as jjoints
from pmce_tpu.smpl.artifacts import synthetic_artifacts as jax_artifacts
from pmce_tpu.smpl.layer import SMPLModel as JaxSMPL
from pmce_tpu.smpl.layer import smpl_forward as jax_smpl_forward
from pmce_tpu.smpl.mesh import synthetic_coarsening as jax_coarsening
from pmce_tpu_torch import convert, native
from pmce_tpu_torch.data import aug, kp_utils
from pmce_tpu_torch.demo import (
    camera,
    detector,
    pipeline,
    preprocess,
    renderer,
    smooth_bbox,
    tracker,
    video_io,
)
from pmce_tpu_torch.main import run_demo
from pmce_tpu_torch.models import spin
from pmce_tpu_torch.models.pmce import create_pmce
from pmce_tpu_torch.models.vitpose import ViTPose, ViTPoseConfig
from pmce_tpu_torch.smpl import joints
from pmce_tpu_torch.smpl.artifacts import synthetic_artifacts
from pmce_tpu_torch.smpl.mesh import synthetic_coarsening

from torch_port_common import (
    init_shapes,
    numpy_params,
    numpy_variables,
    rel_max_err,
)

V = 600


def t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ host helpers
def test_kp_utils_equal():
    rng = np.random.default_rng(0)
    for src, dst in (("coco", "h36m"), ("spin", "coco19"), ("h36m", "spin"),
                     ("mpii3d_test", "h36m"), ("smpl", "common")):
        x = rng.standard_normal((3, len(kp_utils.JOINT_NAMES[src]), 3))
        np.testing.assert_array_equal(kp_utils.convert_kps(x, src, dst),
                                      jkp.convert_kps(x, src, dst))
    names = (kp_utils.JOINT_NAMES["coco"], kp_utils.JOINT_NAMES["h36m"])
    x = rng.standard_normal((17, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        kp_utils.transform_joint_to_other_db(x, *names),
        jkp.transform_joint_to_other_db(x, *names))
    for only in (False, True):
        np.testing.assert_array_equal(
            kp_utils.add_pelvis_and_neck(x, 11, 12, 5, 6, only),
            jkp.add_pelvis_and_neck(x, 11, 12, 5, 6, only))
    assert kp_utils.MPII3D_TEST_TO_H36M == jkp.MPII3D_TEST_TO_H36M
    with pytest.raises(ValueError):
        kp_utils.get_joint_names("nope")


def test_aug_equal():
    rng = np.random.default_rng(1)
    kp = rng.uniform(0, 300, (19, 3)).astype(np.float32)
    S = rng.standard_normal((19, 3)).astype(np.float32)
    pairs = ((1, 2), (5, 6), (11, 12))
    for rot, flip in ((0.0, False), (23.0, True), (-40.0, False)):
        got = aug.j2d_processing(kp, (500, 500), (30, 40, 120, 200), rot,
                                 flip, pairs)
        want = jaug.j2d_processing(kp, (500, 500), (30, 40, 120, 200), rot,
                                   flip, pairs)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(aug.j3d_processing(S, rot, flip, pairs),
                                      jaug.j3d_processing(S, rot, flip, pairs))
    for is_train in (False, True):
        np.testing.assert_array_equal(
            aug.augm_params(np.random.default_rng(2), is_train, True, 30.0),
            jaug.augm_params(np.random.default_rng(2), is_train, True, 30.0))


def test_joint_regressors_equal():
    jr = np.random.default_rng(3).random((24, V)).astype(np.float32)
    np.testing.assert_array_equal(joints.extended_joint_regressor(jr),
                                  jjoints.extended_joint_regressor(jr))
    np.testing.assert_array_equal(joints.coco17_regressor(jr),
                                  jjoints.coco17_regressor(jr))
    np.testing.assert_array_equal(joints.spin49_regressor(jr),
                                  jjoints.spin49_regressor(jr))
    assert joints.H36M_TO_J14 == jjoints.H36M_TO_J14


def test_smooth_bbox_equal():
    rng = np.random.default_rng(4)
    kps = []
    for i in range(40):
        kp = np.zeros((17, 3), np.float32)
        kp[:, 0] = 100 + i + rng.normal(scale=0.5, size=17)
        kp[:, 1] = 200 + rng.normal(scale=0.5, size=17)
        kp[::2, 1] += 80
        kp[:, 2] = 9.0
        kps.append(kp if i not in (3, 10, 11) else None)
    for a, b in zip(smooth_bbox.get_smooth_bbox_params(kps),
                    jsmooth.get_smooth_bbox_params(kps)):
        np.testing.assert_array_equal(a, b)


def tracker_detections(seed: int) -> list:
    """Two people crossing, detections shuffled, a gap, a stray box."""
    rng = np.random.default_rng(seed)
    dets = []
    for i in range(36):
        a = [100 + 3 * i, 100, 50, 100]
        b = [300 - 3 * i, 120, 60, 110]
        pair = [a, b] if i % 2 else [b, a]
        d = np.array(pair, np.float32) + rng.normal(scale=1.0, size=(2, 4))
        if 14 <= i < 17:
            d = d[:1]
        if i == 20:
            d = np.concatenate([d, [[500, 400, 20, 20]]]).astype(np.float32)
        dets.append(d.astype(np.float32))
    return dets


def test_tracker_equal():
    dets = tracker_detections(5)
    got = tracker.track_video(dets, min_frames=10)
    want = jtrack.track_video(dets, min_frames=10)
    assert got.keys() == want.keys() and len(got) == 2
    for pid in got:
        for k in ("bbox", "frames"):
            np.testing.assert_array_equal(got[pid][k], want[pid][k])
    a, b = dets[0], np.concatenate(dets[1:4])
    np.testing.assert_array_equal(tracker.iou_matrix(a, b),
                                  jtrack.iou_matrix(a, b))
    # Hungarian against the greedy matcher, where no two tracks compete.
    preds = np.stack([a[0], a[1], [900, 900, 10, 10]]).astype(np.float32)
    np.testing.assert_array_equal(tracker.assign(preds, dets[1]),
                                  tracker.assign_greedy(preds, dets[1]))
    assert list(tracker.assign(preds, dets[1])) == [1, 0, -1]


def test_video_io_arrays(tmp_path):
    frames = np.random.default_rng(6).integers(
        0, 255, (3, 8, 12, 3)).astype(np.uint8)
    np.save(tmp_path / "clip.npy", frames)
    src = video_io.open_video(str(tmp_path / "clip.npy"))
    assert (src.height, src.width, len(src)) == (8, 12, 3)
    np.testing.assert_array_equal(np.stack(list(src)), frames)
    w = video_io.ArrayVideoWriter()
    for f in frames:
        w.write(f)
    np.testing.assert_array_equal(np.stack(w.frames), frames)
    if video_io.has_ffmpeg():
        return
    with pytest.raises(RuntimeError, match="ffmpeg"):
        video_io.FFmpegVideoWriter(str(tmp_path / "x.mp4"), 8, 8)
    with pytest.raises(RuntimeError, match="ffmpeg|ffprobe"):
        video_io.FFmpegVideoSource(str(tmp_path / "nope.mp4"))


# ------------------------------------------------------- crop and resize
def test_crop_resize_equal():
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (4, 60, 80, 3)).astype(np.uint8)
    # Inside, over the left/top edge, over the right/bottom edge, and
    # larger than the frame.
    boxes = np.array([[10.5, 5.25, 30, 40], [-12, -20, 50, 44],
                      [60, 35, 37.5, 41], [-30, -25, 140, 110]], np.float32)
    for size in (16, (24, 18)):
        want = np.asarray(jpre.crop_resize_normalize(
            jnp.asarray(frames), jnp.asarray(boxes), out_size=size))
        got = preprocess.crop_resize_normalize(t(frames), t(boxes), size)
        assert got.shape == want.shape
        # 1e-5 of the 0..255 scale, in normalized units.
        assert float(np.abs(got.numpy() - want).max()) < 1e-5 / 0.225 * 255
    want = np.asarray(jpre.resize_frames(jnp.asarray(frames), (32, 48)))
    got = preprocess.resize_frames(t(frames), (32, 48)).numpy()
    assert float(np.abs(got - want).max()) < 1e-5
    np.testing.assert_array_equal(preprocess.square_crop_bbox(boxes, 1.3),
                                  jpre.square_crop_bbox(boxes, 1.3))


# ---------------------------------------------------------------- camera
def test_camera_fits_equal():
    rng = np.random.default_rng(8)
    pose3d = rng.standard_normal((6, 17, 3)).astype(np.float32)
    cam_true = np.stack([rng.uniform(0.5, 2, 6), rng.uniform(-0.3, 0.3, 6),
                         rng.uniform(-0.3, 0.3, 6)], 1).astype(np.float32)
    target = np.array(jax_project(jnp.asarray(pose3d), jnp.asarray(cam_true),
                                  250.0))
    target += rng.normal(scale=3.0, size=target.shape).astype(np.float32)
    target[0, 0] += 200.0                              # an outlier
    want = np.asarray(jcam.fit_cam_closed_form(
        jnp.asarray(pose3d), jnp.asarray(target), 250.0))
    got = camera.fit_cam_closed_form(t(pose3d), t(target), 250.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    want = np.asarray(jcam.fit_cam_iterative(
        jnp.asarray(pose3d), jnp.asarray(target), 250.0))
    got = camera.fit_cam_iterative(t(pose3d), t(target), 250.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.abs(got - camera.fit_cam_closed_form(
        t(pose3d), t(target), 250.0).numpy()).max() > 1e-3  # it moved
    bbox = np.concatenate([rng.uniform(0, 300, (6, 2)),
                           rng.uniform(50, 200, (6, 2))], 1)
    np.testing.assert_allclose(
        camera.convert_crop_cam_to_orig_img(got, bbox, 640, 480),
        jcam.convert_crop_cam_to_orig_img(got, bbox, 640, 480),
        rtol=0, atol=1e-5)


# -------------------------------------------------------------- renderer
def test_renderer_native_equal():
    art = synthetic_artifacts(seed=0, num_verts=V, num_faces=1200)
    img = np.random.default_rng(9).integers(0, 255, (90, 120, 3)).astype(
        np.uint8)
    cam = np.array([0.8, 0.9, 0.1, -0.05], np.float32)
    got = renderer.Renderer(art.faces, (120, 90)).render(img, art.v_template,
                                                         cam)
    want = jren.Renderer(art.faces, (120, 90)).render(img, art.v_template,
                                                      cam)
    np.testing.assert_array_equal(got, want)
    assert (got != img).any()
    # The numpy version: the JAX tests' bound (±1 on ≥ 99.9 % of pixels).
    screen = renderer.project_weak_perspective(art.v_template, cam, 120, 90)
    plain = img.copy()
    r = renderer.Renderer(art.faces, (120, 90))
    stats = renderer.rasterize_plain(screen, r.faces, plain,
                                     renderer.DEFAULT_COLOR, r.alpha,
                                     r.max_tri_px, r.budget_px)
    assert stats == (0, 0)
    diff = np.abs(got.astype(int) - plain.astype(int))
    assert (diff <= 1).mean() > 0.999


def test_renderer_guards_equal_to_plain():
    """Frame-scale triangles trip the per-triangle cap, many small ones
    the coverage budget: the library and the numpy version skip the same
    faces."""
    h, w = 60, 80
    rng = np.random.default_rng(10)
    big = rng.uniform([-w, -h, 0.5], [2 * w, 2 * h, 2.0], (50, 3, 3))
    base = rng.uniform([5, 5, 0.5], [w - 20, h - 20, 2.0], (150, 1, 3))
    small = base + rng.uniform(0, 15, (150, 3, 3)) * [1, 1, 0]
    verts = np.concatenate([big, small]).reshape(-1, 3).astype(np.float32)
    faces = np.arange(600, dtype=np.int32).reshape(200, 3)
    r = renderer.Renderer(faces, (w, h), max_tri_frac=0.1,
                          coverage_budget=2.0)
    out = np.zeros((h, w, 3), np.uint8)
    depth = np.full((h, w), np.inf, np.float32)
    stats = np.zeros(2, np.int32)
    color = np.asarray(renderer.DEFAULT_COLOR, np.float32)
    native.load().rasterize_mesh(
        verts.ctypes.data_as(native.F32P), len(verts),
        faces.ctypes.data_as(native.I32P), len(faces),
        out.ctypes.data_as(native.U8P), depth.ctypes.data_as(native.F32P),
        h, w, color.ctypes.data_as(native.F32P), 0.9, r.max_tri_px,
        r.budget_px, stats.ctypes.data_as(native.I32P))
    plain = np.zeros((h, w, 3), np.uint8)
    plain_stats = renderer.rasterize_plain(verts, faces, plain, color, 0.9,
                                           r.max_tri_px, r.budget_px)
    assert (int(stats[0]), int(stats[1])) == plain_stats
    assert plain_stats[0] > 0 and plain_stats[1] > 0
    assert (np.abs(out.astype(int) - plain.astype(int)) <= 1).mean() > 0.999


# -------------------------------------------------------------- detector
@pytest.fixture(scope="module")
def detector_pair():
    x = np.random.default_rng(11).random((3, 128, 128, 3)).astype(np.float32)
    jm = jdet.PersonDetector(width=8)
    params = numpy_variables(jm, x, seed=12)
    model = detector.PersonDetector(width=8)
    model.load_state_dict(convert.detector_state_dict_from_jax(params))
    boxes = np.array([[10, 20, 40, 80], [60, 5, 50, 110], [0, 30, 128, 90]],
                     np.float32)
    return jm, params, model, x, boxes


def test_detector_forward_loss_decode_equal(detector_pair):
    jm, params, model, x, boxes = detector_pair
    want = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = model(t(x))
    for k in ("heat", "size", "off"):
        assert got[k].shape == want[k].shape
        assert rel_max_err(want[k], got[k]) < 1e-5, k
    tgt = detector.make_targets(boxes)
    jtgt = jdet.make_targets(boxes)
    for k in tgt:
        np.testing.assert_array_equal(tgt[k], jtgt[k])
    want_loss = float(jdet.detector_loss(want, jtgt))
    got_loss = float(detector.detector_loss(
        got, {k: t(v) for k, v in tgt.items()}))
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
    # Decoding the same maps (one clear peak each: the tied zeros past
    # the peaks are ordered differently by the two top-k's).
    out = {k: np.asarray(v) for k, v in want.items()}
    s = out["heat"].shape[-1]
    out["heat"] = np.full_like(out["heat"], -9.0)
    for i, (iy, ix) in enumerate(((3, 4), (0, 15), (15, 7))):
        out["heat"][i, iy, ix] = 2.0
    jb, js = jdet.decode_detections({k: jnp.asarray(v)
                                     for k, v in out.items()}, top_k=1)
    gb, gs = detector.decode_detections({k: t(v) for k, v in out.items()},
                                        top_k=1)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jb), rtol=1e-6)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(js))
    assert s == 16


def test_detector_adam_step_equal(detector_pair):
    jm, params, model, x, boxes = detector_pair
    tgt = detector.make_targets(boxes)
    tx = optax.adam(1e-3)
    grads = jax.jit(jax.grad(lambda p: jdet.detector_loss(
        jm.apply(p, jnp.asarray(x)), {k: jnp.asarray(v)
                                      for k, v in tgt.items()})))(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = convert.detector_state_dict_from_jax(
        optax.apply_updates(params, updates))

    model = detector.PersonDetector(width=8)
    model.load_state_dict(convert.detector_state_dict_from_jax(params))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    detector.detector_loss(model(t(x)), {k: t(v) for k, v in
                                         tgt.items()}).backward()
    opt.step()
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=1e-5)


def test_detector_training_renders_and_cache(tmp_path):
    art = synthetic_artifacts(seed=0, num_verts=400, num_faces=700)
    jart = jax_artifacts(seed=0, num_verts=400, num_faces=700)
    frames, boxes = detector.render_training_set(art, 4, seed=3, size=64)
    jframes, jboxes = jdet.render_training_set(jart, 4, seed=3, size=64)
    np.testing.assert_allclose(boxes, jboxes, rtol=0, atol=1.0)
    assert (np.abs(frames - jframes) <= 1.5 / 255).mean() > 0.999
    kw = dict(steps=2, batch=2, n_frames=4, width=8)
    first = detector.ensure_cached_detector(art, tmp_path, device="cpu",
                                            log_fn=lambda m: None, **kw)
    again = detector.ensure_cached_detector(art, tmp_path, device="cpu",
                                            **kw)
    for a, b in zip(first.model.state_dict().values(),
                    again.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    found = again.detect_video(t((frames * 255).astype(np.uint8)))
    assert len(found) == 4 and all(f.shape[1:] == (4,) for f in found)


# -------------------------------------------------------------- pipeline
@pytest.fixture(scope="module")
def demo_setup():
    """tests/test_demo_e2e.py's fixture: a 600-vertex body sliding across
    40 frames, boxes by background subtraction, 17 projected joints as
    detection keypoints; and the same PMCE (embed 32, depth 1) in both
    packages."""
    jart = jax_artifacts(seed=0, num_verts=V, num_faces=1200)
    T, H, W = 40, 120, 160
    pose = np.zeros((T, 72), np.float32)
    pose[:, 50] = np.linspace(0, 0.6, T)
    verts, _ = jax_smpl_forward(JaxSMPL.from_artifacts(jart),
                                jnp.asarray(pose), jnp.zeros((T, 10)),
                                fused=False)
    verts = np.asarray(verts)
    r = jren.Renderer(jart.faces, resolution=(W, H), alpha=1.0)
    frames = np.full((T, H, W, 3), 30, np.uint8)
    cams = [np.array([0.45, 0.45 * (W / H), -0.6 + 1.2 * i / T, 0.0],
                     np.float32) for i in range(T)]
    for i in range(T):
        frames[i] = r.render(frames[i], verts[i], cams[i])
    dets, kps = [], []
    jr17 = np.random.default_rng(1).random((17, V)).astype(np.float32)
    jr17 /= jr17.sum(1, keepdims=True)
    for i in range(T):
        ys, xs = np.nonzero(np.any(frames[i] != 30, axis=-1))
        dets.append(np.array([[xs.min(), ys.min(), xs.max() - xs.min() + 1,
                               ys.max() - ys.min() + 1]], np.float32))
        j = jren.project_weak_perspective(jr17 @ verts[i], cams[i], W, H)
        kps.append(np.concatenate([j[:, :2], np.ones((17, 1), np.float32)],
                                  1)[None])

    jcoarse = jax_coarsening(sizes=(V, 150, 40))
    jm, _ = jax_create_pmce(num_joint=19, art=jart, coarsening=jcoarse,
                            joint_regressor_h36m=jr17, embed_dim=32, depth=1)
    params = numpy_params(init_shapes(jm, np.zeros((1, 16, 19, 2),
                                                   np.float32),
                                      np.zeros((1, 16, 2048), np.float32)),
                          seed=13)
    model, assets = create_pmce(
        num_joint=19, art=synthetic_artifacts(seed=0, num_verts=V,
                                              num_faces=1200),
        coarsening=synthetic_coarsening(sizes=(V, 150, 40)),
        joint_regressor_h36m=jr17, embed_dim=32, depth=1, device="cpu")
    model.load_state_dict(convert.state_dict_from_jax(params,
                                                      assets.vj_relation))
    wfeat = (np.random.default_rng(14).standard_normal((3 * 16 * 16, 2048))
             * 0.01).astype(np.float32)
    jax_models = jpipe.DemoModels(
        pmce_apply=jax.jit(lambda a, b: jm.apply({"params": params}, a, b)),
        feature_apply=jax.jit(lambda c: c[:, :, ::14, ::14].reshape(
            c.shape[0], -1) @ wfeat),
        pose2d_apply=None, joint_regressor=jr17, faces=jart.faces)
    port_models = pipeline.DemoModels(
        pmce_apply=model,
        feature_apply=lambda c: c[:, :, ::14, ::14].reshape(
            c.shape[0], -1) @ t(wfeat),
        pose2d_apply=None, joint_regressor=jr17, faces=jart.faces)
    return frames, dets, kps, jax_models, port_models


def run_both(demo_setup, n_frames: int, vitpose: bool):
    frames, dets, kps, jax_models, port_models = demo_setup
    frames, dets = frames[:n_frames], dets[:n_frames]
    kps = None if vitpose else kps[:n_frames]
    if vitpose:
        x = np.zeros((1, 3, 256, 192), np.float32)
        jvp = JaxViTPose(JaxViTPoseConfig.tiny())
        variables = numpy_variables(jvp, x, seed=15)
        vp = ViTPose(ViTPoseConfig.tiny()).eval()
        vp.load_state_dict(convert.vitpose_state_dict_from_jax(variables))
        jax_models = jpipe.DemoModels(**{
            **jax_models.__dict__,
            "pose2d_apply": jax.jit(lambda c: jvp.apply(variables, c))})
        port_models = pipeline.DemoModels(**{**port_models.__dict__,
                                             "pose2d_apply": vp})
    cfg = dict(min_track_frames=25, window_batch=8, feature_batch=16)
    want, want_img = jpipe.DemoPipeline(
        jax_models, jpipe.DemoConfig(**cfg)).run(
        frames, dets, keypoints_per_frame=kps, render=not vitpose)
    got, got_img = pipeline.DemoPipeline(
        port_models, pipeline.DemoConfig(**cfg), device="cpu").run(
        frames, dets, keypoints_per_frame=kps, render=not vitpose)
    assert got.keys() == want.keys() and len(got) == 1
    for pid in got:
        g, w = got[pid], want[pid]
        np.testing.assert_array_equal(g["frames"], w["frames"])
        np.testing.assert_array_equal(g["bboxes"], w["bboxes"])
        assert g["mesh"].shape == (n_frames, V, 3)
        for k in ("mesh", "cam", "orig_cam"):
            assert np.isfinite(g[k]).all(), k
        # Meshes (m) and crop cameras within 1e-4; the full-frame cameras
        # divide by the crop scale, so within 1e-4 of their largest
        # magnitude.
        np.testing.assert_allclose(g["mesh"], w["mesh"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(g["cam"], w["cam"], rtol=0, atol=1e-4)
        assert rel_max_err(w["orig_cam"], g["orig_cam"]) < 1e-4
    return got_img, want_img


def test_pipeline_matches_jax(demo_setup):
    got_img, want_img = run_both(demo_setup, 40, vitpose=False)
    assert got_img.shape == want_img.shape and got_img.dtype == np.uint8
    # The same meshes and cameras through the same rasterizer: the overlay
    # differs at most on edge pixels where the mesh moved by ~1e-6.
    assert (np.abs(got_img.astype(int) - want_img.astype(int))
            <= 1).mean() > 0.999


def test_pipeline_vitpose_matches_jax(demo_setup):
    run_both(demo_setup, 30, vitpose=True)


def test_window_helpers_equal():
    for n in (1, 5, 15, 16, 17, 40):
        assert pipeline.demo_window_list(n) == jpipe.demo_window_list(n)
        w = pipeline.demo_window_list(n)
        np.testing.assert_array_equal(pipeline.window_index_matrix(w),
                                      jpipe.window_index_matrix(w))
        arr = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
        np.testing.assert_array_equal(pipeline.gather_windows(arr, w),
                                      jpipe.gather_windows(arr, w))


# ------------------------------------------------------------------- CLI
@pytest.fixture
def small_demo(tmp_path, monkeypatch):
    """A V = 600 body where the CLI looks for it, PMCE at embed 32 and
    depth 1, and a ResNet of one block a stage (the CLI's full-width models
    are not for this CPU)."""
    base = tmp_path / "base_data"
    base.mkdir()
    synthetic_artifacts(seed=0, num_verts=V, num_faces=1200).save(
        str(base / "smpl_neutral.npz"))
    synthetic_coarsening(seed=0, sizes=(V, 150, 40)).save(
        str(base / "mesh_coarsening.npz"))
    monkeypatch.setenv("PMCE_TPU_DATA_DIR", str(base))
    monkeypatch.setattr(run_demo, "create_pmce", functools.partial(
        create_pmce, embed_dim=32, depth=1))
    monkeypatch.setattr(run_demo, "ResNet50", functools.partial(
        spin.ResNet50, (1, 1, 1, 1)))
    return tmp_path


def test_run_demo_needs_the_card_or_cpu(small_demo, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_demo.main(["--synthetic"])


def test_run_demo_refuses_random_weights(small_demo):
    clip = small_demo / "clip.npy"
    np.save(clip, np.zeros((2, 16, 16, 3), np.uint8))
    with pytest.raises(SystemExit) as e:
        run_demo.main(["--vid_file", str(clip), "--device", "cpu"])
    assert e.value.code == 2
    # Detections with keypoints still leave PMCE and SPIN random.
    np.savez(small_demo / "dets.npz",
             **{f"boxes_{i}": np.zeros((1, 4), np.float32) for i in range(2)},
             **{f"kps_{i}": np.zeros((1, 17, 3), np.float32)
                for i in range(2)})
    with pytest.raises(SystemExit):
        run_demo.main(["--vid_file", str(clip), "--device", "cpu",
                       "--detections", str(small_demo / "dets.npz")])


def test_run_demo_synthetic_on_cpu(small_demo):
    out_dir = small_demo / "demo"
    out = run_demo.main(["--synthetic", "--device", "cpu", "--frames", "20",
                         "--precision", "f32", "--no-warmup",
                         "--output", str(out_dir)])
    (res,) = out["results"].values()
    assert len(res["frames"]) == 20 and np.isfinite(res["mesh"]).all()
    assert res["mesh"].shape == (20, V, 3)
    meta = json.loads((out_dir / "demo_meta.json").read_text())
    assert meta["device"] == "cpu" and len(meta["tracks"]) == 1
    assert set(meta["stages"]["stage_seconds"]) >= {"pmce", "features",
                                                    "render", "track"}
    frames = np.load(out_dir / "demo_frames.npy")
    assert frames.shape == (20, 240, 320, 3) and frames.dtype == np.uint8
