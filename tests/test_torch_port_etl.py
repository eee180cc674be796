"""The port's data pipeline against the JAX package's, on the CPU.

- ``data/etl/joblib_io.load`` against ``joblib.load`` on what
  ``joblib.dump`` writes (f32 and int arrays, arrays of names, object
  arrays, lists, Fortran order, big-endian, 0-d and empty arrays), plain
  and through zlib, gzip, bz2, lzma and xz; an lz4 file, a pre-0.10 ``ZF``
  file, a truncated file and a class outside numpy raise, naming the file;
- ``tests/torch_port_etl_fixtures.py`` (the JAX-free mock writers): its
  ``joblib_dump`` read back by ``joblib.load``, and its trees against
  ``tests/etl_fixtures.py``'s on the same seed (JSON numbers, mm and px,
  within ``GEOM_MM``: the two SMPL forwards round differently; DBs, names
  and draws equal);
- each of the five ETLs with ``device="cpu"`` against JAX's on
  ``tests/etl_fixtures.py``'s mocks, field by field: names, features,
  SMPL parameters, flags, sizes and camera ids equal; geometry (mm) within
  ``GEOM_MM``; 2D (px) within ``PX``; COCO's fitting-gate masks equal
  wherever JAX's fit error lies more than ``GATE_MARGIN_PX`` from the
  threshold (the number of frames inside the margin is printed);
- each converter CLI (``python -m pmce_tpu_torch.tools.convert_*``,
  ``--device cpu``) against the JAX tool on the same tree; each npz loads
  through the other package's ``load_packed`` and through the port's
  factory into its dataset class, with JAX's file giving the same windows;
- ``convert_smpl_pkl`` and ``convert_mesh_downsampling`` byte-equal to the
  JAX tools on ``tests/test_converters.py``'s inputs;
- ``utils/perf``: records merge, stamp the device, replace the file
  atomically and never touch ``PERF.json``; the demo's and the bench's
  entries; the ETL and its CLI refuse the card where there is none.
"""

from __future__ import annotations

import collections
import importlib
import json
import os
import pickle
import sys
from pathlib import Path

import joblib
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pmce_tpu.data import etl as jetl
from pmce_tpu.data import packed as jpacked
from pmce_tpu_torch.core.config import Config
from pmce_tpu_torch.data import etl as tetl
from pmce_tpu_torch.data import factory as tfactory
from pmce_tpu_torch.data import packed as tpacked
from pmce_tpu_torch.data.etl import common as tcommon
from pmce_tpu_torch.data.etl import joblib_io
from pmce_tpu_torch.ops.coords import get_bbox
from pmce_tpu_torch.smpl.artifacts import SMPLArtifacts as TArtifacts
from pmce_tpu_torch.tools import (
    convert_coco,
    convert_h36m,
    convert_mesh_downsampling,
    convert_mpii,
    convert_mpii3d,
    convert_pw3d,
    convert_smpl_pkl,
)
from pmce_tpu_torch.utils import perf
from tests import etl_fixtures as jfix
from tests.test_converters import _mini_model, _register_fake_chumpy

import torch_port_etl_fixtures as tfix

REPO = Path(__file__).resolve().parent.parent
# f32 SMPL forwards of two packages (measured ≤ 7.4e-4 mm at ~5 m); the
# bound test_torch_port_datasets.py uses.
GEOM_MM = 2e-3
# Projections of that geometry and the noise drawn around them (measured
# ≤ 1.3e-4 px).
PX = 1e-3
GATE_MARGIN_PX = 0.01
GEOM = ("joint_cam", "joint_cam_h36m", "mesh_cam")
PIXELS = ("joint_img", "pose2d_det")
EXACT = ("features", "smpl_pose", "smpl_shape", "has_smpl", "img_hw",
         "cam_idx", "lift_valid", "reg_valid")


@pytest.fixture(scope="module")
def art():
    return jfix.small_art()


@pytest.fixture(scope="module")
def tart(art):
    return TArtifacts(**art.__dict__)


@pytest.fixture(scope="module")
def regs(art):
    return jfix.small_regressors(art.num_verts, np.random.default_rng(42))


@pytest.fixture(scope="module")
def trees(tmp_path_factory, art, regs):
    """The JAX mocks, written once: name → (root, truth)."""
    root = tmp_path_factory.mktemp("etl_trees")
    jr_h36m, jr_coco = regs
    writers = {
        "h36m": lambda r: jfix.build_h36m_mock(r, art, jr_h36m),
        "pw3d_test": lambda r: jfix.build_pw3d_mock(r, art, jr_h36m,
                                                    jr_coco, split="test"),
        "pw3d_train": lambda r: jfix.build_pw3d_mock(r, art, jr_h36m,
                                                     jr_coco, split="train"),
        "mpii3d_train": lambda r: jfix.build_mpii3d_train_mock(
            r, art, jr_h36m, jr_coco),
        "mpii3d_val": lambda r: jfix.build_mpii3d_val_mock(r),
        "coco": lambda r: jfix.build_coco_mock(r, art, jr_h36m, jr_coco),
        "mpii": lambda r: jfix.build_mpii_mock(r, art, jr_h36m, jr_coco),
    }
    out = {}
    for name, build in writers.items():
        path = str(root / name)
        out[name] = (path, build(path))
    return out


def _db_payload():
    rng = np.random.default_rng(0)
    return {
        "features": rng.normal(size=(37, 2048)).astype(np.float32),
        "img_name": np.array([f"s_01_act_02_{i:06d}.jpg" for i in range(37)]),
        "aid": np.arange(100, 137),
        "objects": np.array(["a", 3, None], dtype=object),
        "joints3D": np.asfortranarray(rng.normal(size=(6, 49, 3))),
        "big_endian": np.arange(6, dtype=">i4"),
        "scalar": np.array(2.5),
        "empty": np.zeros((0, 3), np.float32),
        "names": ["x", "y"],
        "nested": collections.OrderedDict(vals=[np.ones(3), 1.5]),
    }


def _assert_same(a, b):
    assert type(a) is type(b) or (isinstance(a, np.ndarray)
                                  and isinstance(b, np.ndarray)), (a, b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.shape == b.shape and a.dtype.newbyteorder("=") == \
            b.dtype.newbyteorder("=")
        if a.dtype.hasobject:
            assert a.tolist() == b.tolist()
        else:
            np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("compress", [0, "zlib", "gzip", "bz2", "lzma",
                                      "xz"])
def test_joblib_reader_matches_joblib(tmp_path, compress):
    path = tmp_path / "db.pt"
    joblib.dump(_db_payload(), path, compress=compress)
    got = joblib_io.load(path)
    _assert_same(joblib.load(path), got)
    assert got["big_endian"].dtype.isnative


def test_joblib_reader_reads_the_mock_feature_dbs(trees):
    dbs = [os.path.join(root, f) for root, _ in trees.values()
           for f in os.listdir(root) if f.endswith(".pt")]
    assert len(dbs) == 5   # PW3D keeps its features in JSON
    for path in dbs:
        _assert_same(joblib.load(path), joblib_io.load(path))


@pytest.mark.parametrize("compress", [0, "zlib", "gzip", "bz2", "lzma"])
def test_joblib_reader_raises_on_a_truncated_file(tmp_path, compress):
    path = tmp_path / "db.pt"
    joblib.dump(_db_payload(), path, compress=compress)
    raw = path.read_bytes()
    cut = tmp_path / "cut.pt"
    for frac in (0.002, 0.05, 0.5, 0.97):
        cut.write_bytes(raw[:max(1, int(len(raw) * frac))])
        with pytest.raises(joblib_io.JoblibFormatError, match="cut.pt"):
            joblib_io.load(cut)


def test_joblib_reader_refuses_lz4_zf_and_foreign_classes(tmp_path):
    lz4 = tmp_path / "feat.pt"
    lz4.write_bytes(b"\x04\x22\x4d\x18" + bytes(64))
    with pytest.raises(joblib_io.JoblibFormatError, match="feat.pt.*lz4"):
        joblib_io.load(lz4)
    zf = tmp_path / "old.pt"
    zf.write_bytes(b"ZF0x00000010" + bytes(16))
    with pytest.raises(joblib_io.JoblibFormatError, match="old.pt"):
        joblib_io.load(zf)
    foreign = tmp_path / "foreign.pt"
    joblib.dump({"x": collections.Counter("ab")}, foreign)
    with pytest.raises(joblib_io.JoblibFormatError,
                       match="foreign.pt.*collections.Counter"):
        joblib_io.load(foreign)


def test_joblib_reader_reads_pre_0_10_companion_arrays(tmp_path):
    """joblib < 0.10 pickled an ``NDArrayWrapper`` naming a companion .npy
    beside the main file; joblib still reads such files."""
    from joblib.numpy_pickle_compat import NDArrayWrapper

    feats = np.random.default_rng(1).normal(size=(4, 2048)).astype(np.float32)
    np.save(tmp_path / "db.pt_01.npy", feats)
    with open(tmp_path / "db.pt", "wb") as f:
        pickle.dump({"features": NDArrayWrapper("db.pt_01.npy", np.ndarray),
                     "img_name": ["a", "b"]}, f, protocol=2)
    _assert_same(joblib.load(tmp_path / "db.pt"),
                 joblib_io.load(tmp_path / "db.pt"))


@pytest.mark.parametrize("compress", [None, "zlib", "gzip", "bz2", "lzma",
                                      "xz"])
def test_fixture_writer_is_read_by_joblib(tmp_path, compress):
    path = tmp_path / "db.pt"
    payload = _db_payload()
    tfix.joblib_dump(payload, path, compress=compress)
    _assert_same(payload, joblib.load(path))
    _assert_same(payload, joblib_io.load(path))


def _json_close(a, b, where):
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _json_close(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _json_close(x, y, f"{where}[{i}]")
    elif isinstance(a, float):
        assert abs(a - b) <= GEOM_MM, (where, a, b)
    else:
        assert a == b, (where, a, b)


@pytest.mark.parametrize("name", ["h36m", "pw3d_test", "mpii3d_train",
                                  "mpii3d_val", "coco", "mpii"])
def test_port_mock_trees_match_jax_mocks(tmp_path, trees, tart, regs, name):
    jr_h36m, jr_coco = regs
    build = {
        "h36m": lambda r: tfix.build_h36m_mock(r, tart, jr_h36m),
        "pw3d_test": lambda r: tfix.build_pw3d_mock(r, tart, jr_h36m,
                                                    jr_coco, split="test"),
        "mpii3d_train": lambda r: tfix.build_mpii3d_train_mock(
            r, tart, jr_h36m, jr_coco),
        "mpii3d_val": lambda r: tfix.build_mpii3d_val_mock(r),
        "coco": lambda r: tfix.build_coco_mock(r, tart, jr_h36m, jr_coco),
        "mpii": lambda r: tfix.build_mpii_mock(r, tart, jr_h36m, jr_coco),
    }[name]
    jroot = Path(trees[name][0])
    troot = tmp_path / name
    build(str(troot))
    jfiles = sorted(p.relative_to(jroot) for p in jroot.rglob("*.*"))
    assert jfiles == sorted(p.relative_to(troot) for p in troot.rglob("*.*"))
    for rel in jfiles:
        if rel.suffix == ".json":
            _json_close(json.loads((jroot / rel).read_text()),
                        json.loads((troot / rel).read_text()), str(rel))
        else:
            _assert_same(joblib.load(jroot / rel), joblib.load(troot / rel))


def _convert(name, root, jart, tart, regs):
    """JAX's and the port's conversion of one mock tree (port on the CPU)."""
    jr_h36m, jr_coco = regs
    if name == "h36m":
        kw = dict(input_joint_set="human36", subjects=(1, 5))
        return (jetl.convert_h36m(root, "train", jart, **kw),
                tetl.convert_h36m(root, "train", tart, device="cpu", **kw))
    if name.startswith("pw3d"):
        split = name.split("_")[1]
        return (jetl.convert_pw3d(root, split, {"neutral": jart}),
                tetl.convert_pw3d(root, split, {"neutral": tart},
                                  device="cpu"))
    if name.startswith("mpii3d"):
        split = name.split("_")[1]
        return (jetl.convert_mpii3d(root, split, jart),
                tetl.convert_mpii3d(root, split, tart, device="cpu"))
    fn = {"coco": (jetl.convert_coco, tetl.convert_coco),
          "mpii": (jetl.convert_mpii, tetl.convert_mpii)}[name]
    return (fn[0](root, jart, jr_h36m, jr_coco),
            fn[1](root, tart, jr_h36m, jr_coco, device="cpu"))


def _fit_errors(root, data):
    """JAX's COCO fitting error of each converted frame, from its own
    projected joints and the annotated keypoints."""
    with open(os.path.join(root, "person_keypoints_train2014.json")) as f:
        anns = [a for a in json.load(f)["annotations"]
                if not a["iscrowd"]]
    with open(os.path.join(root, "coco_smplify_train.json")) as f:
        fitted = json.load(f)
    anns = [a for a in anns if str(a["id"]) in fitted]
    assert len(anns) == len(data)
    errs = []
    for a, jimg in zip(anns, data.joint_img):
        kp = np.asarray(a["keypoints"], np.float32).reshape(-1, 3)
        errs.append(tcommon.crop64_fit_error(
            get_bbox(jimg), kp[:, :2], jimg[:17],
            (kp[:, 2] > 0).astype(np.float32)))
    return np.asarray(errs)


def _assert_sequence_data_close(want, got, what):
    assert list(want.img_names) == list(got.img_names), what
    for name in GEOM + PIXELS + EXACT + ("mesh_valid",):
        a, b = getattr(want, name), getattr(got, name)
        if a is None:
            assert b is None, (what, name)
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, (what, name)
        if name in GEOM:
            np.testing.assert_allclose(b, a, rtol=0, atol=GEOM_MM,
                                       err_msg=f"{what} {name}")
        elif name in PIXELS:
            np.testing.assert_allclose(b, a, rtol=0, atol=PX,
                                       err_msg=f"{what} {name}")
        elif name in EXACT:
            np.testing.assert_array_equal(b, a, err_msg=f"{what} {name}")


@pytest.mark.parametrize("name", ["h36m", "pw3d_test", "pw3d_train",
                                  "mpii3d_train", "mpii3d_val", "coco",
                                  "mpii"])
def test_etl_on_the_cpu_matches_jax(trees, art, tart, regs, name):
    root, _ = trees[name]
    want, got = _convert(name, root, art, tart, regs)
    _assert_sequence_data_close(want, got, name)
    if name == "coco":
        from pmce_tpu_torch.data.etl.coco import FITTING_THR_PX

        err = _fit_errors(root, want)
        outside = np.abs(err - FITTING_THR_PX) > GATE_MARGIN_PX
        print(f"coco fitting gate: {int((~outside).sum())} of {len(err)} "
              f"frames within {GATE_MARGIN_PX} px of the threshold")
        np.testing.assert_array_equal(got.mesh_valid[outside],
                                      want.mesh_valid[outside])
        np.testing.assert_array_equal(want.mesh_valid, want.lift_valid)


_CLI = {
    # --debug: the first subject of protocol 2 (the mock has 1 and 5).
    "h36m": (convert_h36m, "convert_h36m", "Human36M", "train",
             ["--data-dir", "{root}", "--split", "train", "--debug"]),
    "pw3d_test": (convert_pw3d, "convert_pw3d", "PW3D", "test",
                  ["--data-dir", "{root}", "--split", "test"]),
    "mpii3d_train": (convert_mpii3d, "convert_mpii3d", "MPII3D", "train",
                     ["--data-dir", "{root}", "--split", "train"]),
    "mpii3d_val": (convert_mpii3d, "convert_mpii3d", "MPII3D", "val",
                   ["--data-dir", "{root}", "--split", "val"]),
    "coco": (convert_coco, "convert_coco", "COCO", "train",
             ["--annot-dir", "{root}"]),
    "mpii": (convert_mpii, "convert_mpii", "MPII", "train",
             ["--annot-dir", "{root}"]),
}


def _jax_tool(module: str):
    tools = str(REPO / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return importlib.import_module(module)


@pytest.mark.parametrize("name", list(_CLI))
def test_converter_cli_matches_the_jax_tool(tmp_path, monkeypatch, trees,
                                            art, regs, name):
    cli, tool, dataset, split, flags = _CLI[name]
    root, _ = trees[name]
    art.save(str(tmp_path / "smpl.npz"))
    for i, r in enumerate(regs):
        np.save(tmp_path / f"jr{i}.npy", r)
    common = [f.format(root=root) for f in flags] + [
        "--smpl-npz", str(tmp_path / "smpl.npz"),
        "--jr-h36m", str(tmp_path / "jr0.npy"),
        "--jr-coco", str(tmp_path / "jr1.npy")]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    packed = f"{dataset}_{split}_packed.npz"
    jout, tout = tmp_path / "jax" / packed, tmp_path / "port" / packed
    monkeypatch.setattr(sys, "argv", [tool] + common + ["--out", str(jout)])
    _jax_tool(tool).main()
    got = cli.main(common + ["--out", str(tout), "--device", "cpu"])
    assert len(got) > 0

    # Both ways: each file through the other package's reader.
    jdata, jaux = tpacked.load_packed(jout)
    tdata, taux = jpacked.load_packed(tout)
    _assert_sequence_data_close(jdata, tdata, f"{name} npz")
    assert sorted(jaux) == sorted(taux)
    for k in jaux:
        np.testing.assert_array_equal(jaux[k], taux[k])

    # The port's factory takes either file into the dataset class.
    cfg = Config()
    cfg.DATASET.seqlen = 4
    windows = []
    for d in ("jax", "port"):
        cfg.data_dir = str(tmp_path / d)
        ds = tfactory.build_dataset(dataset, cfg, TArtifacts(**art.__dict__),
                                    split, device="cpu")
        windows.append(len(ds))
    assert windows[0] == windows[1] > 0


@pytest.mark.parametrize("fmt", ["csc", "csr"])
def test_convert_smpl_pkl_bytes_equal_jax(tmp_path, fmt):
    Ch, add, transpose, created = _register_fake_chumpy()
    try:
        payload, _ = _mini_model(Ch, add, transpose, regressor_format=fmt)
        pkl = tmp_path / "basicModel.pkl"
        pkl.write_bytes(pickle.dumps(payload, protocol=2))
    finally:
        for n in created:
            sys.modules.pop(n, None)
    _jax_tool("convert_smpl_pkl").convert(str(pkl), str(tmp_path / "j.npz"))
    convert_smpl_pkl.main([str(pkl), str(tmp_path / "t.npz")])
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            assert j[k].dtype == t[k].dtype and j[k].tobytes() == \
                t[k].tobytes(), k


def test_convert_mesh_downsampling_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    sizes = (20, 10, 5)
    D, U = [], []
    for lvl in range(2):
        nf, nc = sizes[lvl], sizes[lvl + 1]
        D.append(sp.csc_matrix(rng.random((nc, nf))
                               * (rng.random((nc, nf)) > 0.5)))
        U.append(sp.csr_matrix(rng.random((nf, nc))
                               * (rng.random((nf, nc)) > 0.5)))
    src = tmp_path / "mesh_downsampling.npz"
    np.savez(src, A=np.array([sp.eye(s) for s in sizes], dtype=object),
             D=np.array(D, dtype=object), U=np.array(U, dtype=object))
    _jax_tool("convert_mesh_downsampling").convert(str(src),
                                                   str(tmp_path / "j.npz"))
    convert_mesh_downsampling.main([str(src), str(tmp_path / "t.npz")])
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert sorted(j.files) == sorted(t.files) == ["D0", "D1", "U0", "U1"]
        for k in j.files:
            assert j[k].tobytes() == t[k].tobytes(), k


def test_perf_record_merges_stamps_and_replaces_atomically(tmp_path,
                                                           monkeypatch):
    jax_perf = (REPO / "PERF.json").read_bytes()
    assert os.path.basename(perf.PERF_PATH) == "PERF_TORCH.json"
    assert "PERF_TORCH.json" in (REPO / ".gitignore").read_text().split()
    path = str(tmp_path / "perf.json")
    perf.record("serving", {"mid_frames_per_s": 1.0, "batch": 2,
                            "source": "bench_torch.py"}, path)
    perf.record("etl", {"frames": 4, "seconds": 2.0, "frames_per_s": 2.0,
                        "source": "convert_h36m"}, path, sub="h36m_train")
    data = perf.record("etl", {"frames": 6, "seconds": 3.0,
                               "frames_per_s": 2.0, "source": "convert_coco"},
                       path, sub="coco_train")
    assert json.loads(Path(path).read_text()) == data
    assert sorted(data) == ["etl", "serving"]
    assert sorted(data["etl"]) == ["coco_train", "h36m_train"]
    assert all(e["device"] == "cpu" and e["measured_unix"] > 0
               for e in (data["serving"], *data["etl"].values()))
    table = perf.render_table(data)
    assert "ETL h36m_train" in table and "| cpu |" in table

    # A failed write leaves the old file whole and no temporary behind.
    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(perf.os, "replace", fail)
    with pytest.raises(OSError):
        perf.record("serving", {"mid_frames_per_s": 9.0}, path)
    assert json.loads(Path(path).read_text()) == data
    assert os.listdir(tmp_path) == ["perf.json"]
    assert (REPO / "PERF.json").read_bytes() == jax_perf


def test_demo_and_bench_perf_entries():
    import argparse

    import bench_torch
    from pmce_tpu_torch.main import run_demo

    rep = {"fps_measured": 150.04, "stage_seconds": {"pose2d": 0.09512,
                                                     "render": 0.0791}}
    args = argparse.Namespace(synthetic=True, full_stack=True,
                              vitpose="huge", vid_file="")
    key, entry = run_demo.perf_entry(args, (48, 240, 320, 3), rep)
    assert key == "demo_full_stack" and entry["n_frames"] == 48
    assert entry["fps_measured"] == 150.04
    assert entry["config"].startswith("--synthetic --full-stack, 48 frames")
    args.full_stack = False
    assert run_demo.perf_entry(args, (48, 240, 320, 3), rep) == (None, None)
    args.synthetic, args.vid_file = False, "/data/clip.mp4"
    key, entry = run_demo.perf_entry(args, (64, 480, 640, 3), rep)
    assert key == "demo_real_footage" and "clip.mp4 (64 frames 480x640)" \
        in entry["config"]
    assert bench_torch.perf_payload({"median": 16497.14, "batch": 256,
                                     "device_ms": 10.1}) == {
        "mid_frames_per_s": 16497.1, "batch": 256, "device_ms": 10.1,
        "source": "bench_torch.py"}
    table = perf.render_table({"demo_full_stack": {**entry,
                                                   "device": "cpu"}})
    assert "150.0 frames/s" in table


def test_etl_and_cli_refuse_the_card_without_one(tmp_path, monkeypatch,
                                                 trees, tart, regs):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, _ = trees["mpii"]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tetl.convert_mpii(root, tart, *regs)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tetl.convert_mpii3d(trees["mpii3d_val"][0], "val", tart)
    for i, r in enumerate(regs):
        np.save(tmp_path / f"jr{i}.npy", r)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        convert_mpii.main(["--annot-dir", root,
                           "--jr-h36m", str(tmp_path / "jr0.npy"),
                           "--jr-coco", str(tmp_path / "jr1.npy"),
                           "--out", str(tmp_path / "x.npz")])
    assert not (tmp_path / "x.npz").exists()
