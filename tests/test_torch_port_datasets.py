"""The port's dataset classes, packed files and factory against the JAX
package's, on the CPU.

- each of the five classes' ``from_synthetic`` (the port's synthesis runs
  its SMPL forward on the CPU here) against JAX's on a V = 600 synthetic
  body: windows, mid frames, names, masks, validities and action ids
  equal; geometry (camera-space joints and meshes, mm) within 2e-3 mm;
  the batches (MPII3D's val split zeroes its mesh and lift targets) equal
  but for the same geometry bound;
- a packed npz written by JAX's ``save_packed`` loads in the port, and the
  reverse: every field and regressor equal;
- ``factory.build_dataset`` for every shipped config: the class, split,
  stride quirks (MPII3D, and Human36M on COCO inputs, window with stride
  ``seqlen`` at train) and windows equal to JAX's; MPII3D tests on its
  ``val`` split; a packed npz under ``data_dir`` is preferred; a missing
  one under an explicitly set ``data_dir`` raises ``FileNotFoundError``;
- ``target_joint_regressor`` for each joint set, including the COCO-19
  pelvis and neck rows appended to a 17-row packed regressor.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from pmce_tpu.core.config import load_config as jax_load_config
from pmce_tpu.data import factory as jfactory
from pmce_tpu.data import packed as jpacked
from pmce_tpu.data.datasets import base as jbase
from pmce_tpu.data.datasets import (
    MPII as JMPII,
    MPII3D as JMPII3D,
    MSCOCO as JMSCOCO,
    PW3D as JPW3D,
    Human36M as JHuman36M,
)
from pmce_tpu.smpl.artifacts import synthetic_artifacts as jax_artifacts
from pmce_tpu_torch.core.config import load_config
from pmce_tpu_torch.data import factory, packed
from pmce_tpu_torch.data.datasets import MPII, MPII3D, MSCOCO, PW3D, Human36M
from pmce_tpu_torch.data.datasets import base
from pmce_tpu_torch.smpl.artifacts import synthetic_artifacts

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted((REPO / "configs").glob("*.yml"))
# Root-relative millimetres are differences of f32 camera-space values at
# ~4.5 m, where one f32 step is 0.00048 mm, and the two SMPL forwards round
# their sums in another order: measured 0.0014 mm (3 steps), as
# test_torch_port_train.py's synthetic-sequence bound.
GEOMETRY_MM = 2e-3
MM = ("joint_cam", "joint_cam_h36m", "mesh_cam")
EXACT = ("img_names", "smpl_pose", "smpl_shape", "has_smpl", "img_hw",
         "cam_idx", "mesh_valid", "lift_valid", "reg_valid")


@pytest.fixture(scope="module")
def bodies():
    return (synthetic_artifacts(seed=0, num_verts=600, num_faces=1200),
            jax_artifacts(seed=0, num_verts=600, num_faces=1200))


def _same_data(got, want):
    for k in EXACT:
        a, b = getattr(got, k), getattr(want, k)
        if b is None:
            assert a is None, k
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
    for k in MM:
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=0, atol=GEOMETRY_MM, err_msg=k)


def _same_dataset(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got.name == want.name and len(got) == len(want)
    for f in ("seqlen", "stride", "chunk_mode", "use_gt_input",
              "eval_root_idx", "eval_joint_subset"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.vid_indices, want.vid_indices)
    np.testing.assert_array_equal(got.mid_indices(), want.mid_indices())
    np.testing.assert_array_equal(got.seq_names(), want.seq_names())
    for hook in ("keep_mask", "action_ids"):
        a, b = getattr(got, hook)(), getattr(want, hook)()
        if b is None:
            assert a is None, hook
        else:
            np.testing.assert_array_equal(a, b, err_msg=hook)
    for k in ("smpl", "h36m", "coco"):
        np.testing.assert_array_equal(
            getattr(got, f"joint_regressor_{k}"),
            getattr(want, f"joint_regressor_{k}"))
    _same_data(got.data, want.data)


CASES = [
    (Human36M, JHuman36M, dict(split="test")),
    (Human36M, JHuman36M, dict(split="train", input_joint_set="coco")),
    (PW3D, JPW3D, dict(split="test")),
    (MPII3D, JMPII3D, dict(split="train")),
    (MPII3D, JMPII3D, dict(split="val")),
    (MSCOCO, JMSCOCO, dict()),
    (MPII, JMPII, dict()),
]


@pytest.mark.parametrize(
    "cls,jcls,kw", CASES,
    ids=[f"{c[0].__name__}-{c[2].get('split', 'train')}"
         + (f"-{c[2]['input_joint_set']}" if "input_joint_set" in c[2]
            else "") for c in CASES])
def test_from_synthetic_matches_jax(bodies, cls, jcls, kw):
    art, jart = bodies
    size = ({"num_images": 40} if cls in (MSCOCO, MPII)
            else {"frames_per_video": 40})
    got = cls.from_synthetic(art, device="cpu", **size, **kw)
    want = jcls.from_synthetic(jart, **size, **kw)
    assert got.device == "cpu"
    _same_dataset(got, want)
    if cls in (Human36M, PW3D):
        np.testing.assert_array_equal(got.gt_h36m_joints_mid() is None,
                                      want.gt_h36m_joints_mid() is None)
    idxs = np.arange(min(len(got), 6))
    b_got, b_want = got.get_batch(idxs), want.get_batch(idxs)
    assert set(b_got) == set(b_want)
    for k, v in b_want.items():
        scale = 1000.0 if k == "mesh" else 1.0     # the batch's mesh: m
        if k in ("mesh", "lift_pose3d", "reg_pose3d"):
            np.testing.assert_allclose(b_got[k] * scale, v * scale, rtol=0,
                                       atol=GEOMETRY_MM, err_msg=k)
        elif k not in ("pose2d", "img_feature"):
            np.testing.assert_array_equal(b_got[k], v, err_msg=k)
    if kw.get("split") == "val":
        assert got.is_val and not b_got["mesh"].any()


def test_make_synthetic_split_and_regressors_match_jax(bodies):
    art, jart = bodies
    for a, b in zip(base.synthetic_regressors(art),
                    jbase.synthetic_regressors(jart)):
        np.testing.assert_array_equal(a, b)
    jr = base.synthetic_regressors(art)[0]
    _same_data(base.make_synthetic_split(art, jr, 2, 20, 4, device="cpu"),
               jbase.make_synthetic_split(jart, jr, 2, 20, 4))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_packed_npz_round_trips_between_packages(bodies, tmp_path, writer):
    art, jart = bodies
    src = (Human36M.from_synthetic(art, frames_per_video=20, device="cpu")
           if writer == "port" else
           JHuman36M.from_synthetic(jart, frames_per_video=20))
    save = packed.save_packed if writer == "port" else jpacked.save_packed
    load = jpacked.load_packed if writer == "port" else packed.load_packed
    path = tmp_path / "Human36M_train_packed.npz"
    save(src.data, path, jr_smpl=src.joint_regressor_smpl,
         jr_h36m=src.joint_regressor_h36m, jr_coco=src.joint_regressor_coco,
         joint_valid=np.ones((len(src.data), 17), np.float32))
    data, aux = load(path)
    for f in dataclasses.fields(data):
        want = getattr(src.data, f.name)
        got = getattr(data, f.name)
        assert (got is None) == (want is None), f.name
        if want is not None:
            np.testing.assert_array_equal(got, want, err_msg=f.name)
    assert sorted(aux) == ["joint_valid", "jr_coco", "jr_h36m", "jr_smpl"]
    np.testing.assert_array_equal(aux["jr_h36m"], src.joint_regressor_h36m)
    with pytest.raises(ValueError):
        packed.save_packed(src.data, tmp_path / "x.npz", img_names=np.ones(1))
    np.savez(tmp_path / "bad.npz", x=np.ones(2))
    with pytest.raises(ValueError):
        packed.load_packed(tmp_path / "bad.npz")


def _configs(path, synthetic_samples=64, **top):
    cfg, jcfg = load_config(str(path)), jax_load_config(str(path))
    for c in (cfg, jcfg):
        c.DATASET.synthetic_samples = synthetic_samples
        for k, v in top.items():
            setattr(c, k, v)
    return cfg, jcfg


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_build_dataset_for_every_shipped_config(bodies, path, capsys):
    art, jart = bodies
    cfg, jcfg = _configs(path)
    got = factory.build_train_datasets(cfg, art, "cpu")
    want = jfactory.build_train_datasets(jcfg, jart)
    assert len(got) == len(want) == len(cfg.DATASET.train_list)
    for name, g, w in zip(cfg.DATASET.train_list, got, want):
        _same_dataset(g, w)
        quirk = name == "MPII3D" or (
            name == "Human36M" and cfg.DATASET.input_joint_set == "coco")
        assert g.stride == (cfg.DATASET.seqlen if quirk
                            else cfg.DATASET.stride)
        assert g.chunk_mode == (
            "static" if name in ("COCO", "MPII")
            else "pose" if cfg.MODEL.name == "PoseEst" else "mesh")
    g, w = (factory.build_test_dataset(cfg, art, "cpu"),
            jfactory.build_test_dataset(jcfg, jart))
    _same_dataset(g, w)
    assert g.stride == 1
    if cfg.DATASET.test_list[0] == "MPII3D":
        assert g.is_val
    out = capsys.readouterr().out
    assert out.count("[pmce-tpu-torch] dataset ") == \
        out.count("[pmce-tpu] dataset ")
    for k in ("human36", "coco", "smpl"):
        cfg.DATASET.target_joint_set = jcfg.DATASET.target_joint_set = k
        np.testing.assert_array_equal(
            factory.target_joint_regressor(cfg, g),
            jfactory.target_joint_regressor(jcfg, w))


def test_factory_packed_npz_and_missing_file(bodies, tmp_path, capsys):
    art, jart = bodies
    cfg, jcfg = _configs(CONFIGS[0], data_dir=str(tmp_path))
    for c in (cfg, jcfg):
        c.DATASET.synthetic = False
    name = cfg.DATASET.test_list[0]
    with pytest.raises(FileNotFoundError, match="explicitly configured"):
        factory.build_test_dataset(cfg, art, "cpu")
    with pytest.raises(ValueError, match="unknown dataset"):
        factory.build_dataset("Nope", cfg, art, "test", "cpu")
    src = JPW3D.from_synthetic(jart, frames_per_video=20)
    jpacked.save_packed(src.data, factory.packed_path(cfg, name, "test"),
                        jr_smpl=src.joint_regressor_smpl,
                        jr_h36m=src.joint_regressor_h36m,
                        jr_coco=src.joint_regressor_coco)
    assert factory.packed_path(cfg, name, "test") == \
        jfactory.packed_path(jcfg, name, "test")
    got = factory.build_test_dataset(cfg, art, "cpu")
    assert "← packed npz" in capsys.readouterr().out
    _same_dataset(got, jfactory.build_test_dataset(jcfg, jart))
    assert got.device == "cpu"


def test_target_joint_regressor_for_each_joint_set(bodies):
    art, _ = bodies
    cfg = load_config()
    ds = PW3D.from_synthetic(art, frames_per_video=20, device="cpu")
    for key, want in (("human36", ds.joint_regressor_h36m),
                      ("h36m", ds.joint_regressor_h36m),
                      ("coco", ds.joint_regressor_coco),
                      ("smpl", ds.joint_regressor_smpl)):
        cfg.DATASET.target_joint_set = key
        assert factory.target_joint_regressor(cfg, ds) is want
    # A packed split's raw 17-row COCO regressor gets the pelvis (hip
    # mean) and neck (shoulder mean) rows, as the JAX package appends.
    jr17 = ds.joint_regressor_coco[:17]
    ds17 = dataclasses.replace(ds, joint_regressor_coco=jr17)
    jcfg = jax_load_config()
    cfg.DATASET.target_joint_set = jcfg.DATASET.target_joint_set = "coco"
    got = factory.target_joint_regressor(cfg, ds17)
    assert got.shape == (19, 600) and got.dtype == np.float32
    np.testing.assert_array_equal(got[17], (jr17[11] + jr17[12]) / 2.0)
    np.testing.assert_array_equal(got[18], (jr17[5] + jr17[6]) / 2.0)
    np.testing.assert_array_equal(
        got, jfactory.target_joint_regressor(jcfg, ds17))
    cfg.DATASET.target_joint_set = "nope"
    with pytest.raises(ValueError):
        factory.target_joint_regressor(cfg, ds)
