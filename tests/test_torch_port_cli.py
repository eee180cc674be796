"""The port's entry points on the CPU: ``Trainer.full_evaluate`` against
the JAX package's, the train and test CLIs, and ``bench_torch``.

- ``Trainer.full_evaluate`` (one collecting pass, then the test dataset's
  own protocol) against JAX's on the same f32 weights
  (``convert.state_dict_from_jax``) and the same synthetic test split
  (V = 600 body), for PMCE and the Stage-1 lifter on the Human3.6M and 3DPW
  protocols: every metric within 0.01 mm, the per-action table's keys
  equal;
- ``pmce_tpu_torch.main.train`` and ``.test`` with ``--device cpu`` on
  small-width configs written to ``tmp_path`` (the SMPL artifacts and mesh
  coarsening of a V = 600 body through ``PMCE_TPU_DATA_DIR``): a Stage-1
  ``--smoke`` run, then a bf16 ``fused_attn`` Stage-2 run warm-started from
  it; the checkpoints are written; the test CLI reloads the final one and
  gives the training run's final evaluation back, prints the summary, and
  writes OBJ meshes under ``--vis``; ``--resume`` restores and evaluates;
  an unknown ``MODEL.name``, ``TRAIN.fsdp`` and the card's absence raise;
- ``bench_torch.serving_rate`` at a small width on the CPU gives
  ``bench.py``'s JSON keys; its ``main`` exits nonzero without a card.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pmce_tpu.core.config import Config as JaxConfig
from pmce_tpu.core.trainer import Trainer as JaxTrainer
from pmce_tpu.core.trainer import TrainState as JaxTrainState
from pmce_tpu.data.clip_dataset import MultiDataset as JaxMultiDataset
from pmce_tpu.data.datasets import PW3D as JPW3D
from pmce_tpu.data.datasets import Human36M as JHuman36M
from pmce_tpu.models.pmce import PMCE as JaxPMCE
from pmce_tpu.models.pose_lifter import PoseLifter as JaxPoseLifter
from pmce_tpu.smpl.artifacts import synthetic_artifacts as jax_artifacts
from pmce_tpu.utils.obj_io import load_obj
from pmce_tpu_torch import convert
from pmce_tpu_torch.core.config import Config
from pmce_tpu_torch.core.trainer import H36M_EVAL_JOINTS, Trainer
from pmce_tpu_torch.data.clip_dataset import MultiDataset
from pmce_tpu_torch.data.datasets import PW3D, Human36M
from pmce_tpu_torch.main import test as test_cli
from pmce_tpu_torch.main import train as train_cli
from pmce_tpu_torch.models.pmce import PMCE
from pmce_tpu_torch.models.pose_lifter import PoseLifter
from pmce_tpu_torch.smpl.artifacts import synthetic_artifacts
from pmce_tpu_torch.smpl.mesh import synthetic_coarsening

from torch_port_common import init_shapes, numpy_params

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import bench_torch  # noqa: E402

T, V, NV = 16, 600, 40
METRIC_MM = 0.01
PMCE_CFG = dict(embed_dim=32, depth=1, num_vertx=NV, num_verts_full=V,
                joint_dim=64, vertx_dim=64, gru_hidden=32, seqlen=T)
LIFTER_CFG = dict(num_frames=T, embed_dim=32, depth=1, num_heads=4,
                  drop_path_rate=0.0)


@pytest.fixture(scope="module")
def bodies():
    return (synthetic_artifacts(seed=0, num_verts=V, num_faces=1200),
            jax_artifacts(seed=0, num_verts=V, num_faces=1200))


def _models(stage, J, seed):
    """The JAX model, its numpy parameters, and the port's model holding
    the same values."""
    rng = np.random.default_rng(seed)
    pose2d = rng.normal(size=(1, T, J, 2)).astype(np.float32)
    feat = rng.normal(size=(1, T, 2048)).astype(np.float32)
    if stage == "PMCE":
        vj = tuple(int(i) for i in rng.integers(0, J, size=NV))
        jm = JaxPMCE(num_joint=J, vj_relation=vj, **PMCE_CFG)
        params = numpy_params(init_shapes(jm, pose2d, feat), seed)
        model = PMCE(num_joint=J, vj_relation=vj, **PMCE_CFG)
        model.load_state_dict(convert.state_dict_from_jax(params, vj),
                              strict=True)
    else:
        jm = JaxPoseLifter(num_joints=J, **LIFTER_CFG)
        params = numpy_params(init_shapes(jm, pose2d, feat), seed)
        model = PoseLifter(num_joints=J, **LIFTER_CFG)
        model.load_state_dict(convert.lifter_state_dict_from_jax(params),
                              strict=True)
    return jm, params, model


@pytest.mark.parametrize("protocol", ["h36m", "pw3d"])
@pytest.mark.parametrize("stage", ["PMCE", "PoseEst"])
def test_full_evaluate_matches_jax(bodies, stage, protocol, capsys):
    art, jart = bodies
    cls, jcls = (Human36M, JHuman36M) if protocol == "h36m" else (PW3D,
                                                                  JPW3D)
    chunk = "mesh" if stage == "PMCE" else "pose"
    ds = cls.from_synthetic(art, split="test", frames_per_video=40,
                            chunk_mode=chunk, device="cpu")
    jds = jcls.from_synthetic(jart, split="test", frames_per_video=40,
                              chunk_mode=chunk)
    jm, params, model = _models(stage, ds.num_joints, seed=31)
    cfg, jcfg = Config(), JaxConfig()
    for c in (cfg, jcfg):
        c.MODEL.name = stage
        c.TEST.batch_size = 8
    root = ds.eval_root_idx
    joints = None if (stage == "PoseEst" and root != 0) else H36M_EVAL_JOINTS
    common = dict(faces=art.faces, J_reg_target=ds.joint_regressor_h36m,
                  eval_root_idx=root, eval_joints=joints,
                  log_fn=lambda s: None)
    trainer = Trainer(cfg=cfg, model=model,
                      train_data=MultiDataset([ds], seed=0), test_data=ds,
                      device="cpu", **common)
    jtrainer = JaxTrainer(cfg=jcfg, model=jm,
                          train_data=JaxMultiDataset([jds], seed=0),
                          test_data=jds, **common)
    got = trainer.full_evaluate(verbose=True)
    want = jtrainer.full_evaluate(
        JaxTrainState(params=params, opt_state=None,
                      step=jnp.zeros((), jnp.int32)), verbose=False)
    assert type(got).__name__ == type(want).__name__
    names = ("mpjpe", "pa_mpjpe", "accel") + (
        ("mpvpe", "smpl_joint_error") if stage == "PMCE" else ())
    for k in names:
        a, b = getattr(got, k), getattr(want, k)
        assert math.isfinite(a) and a > 0, k
        assert abs(a - b) <= METRIC_MM, (k, a, b)
    if stage == "PMCE" and protocol == "h36m":
        assert list(got.per_action) == list(want.per_action)
        for k, v in want.per_action.items():
            assert np.abs(np.subtract(got.per_action[k], v)).max() \
                <= METRIC_MM
    out = capsys.readouterr().out
    assert f"{ds.name} MPJPE (mm)     >> tot: {got.mpjpe:.2f}" in out


# ------------------------------------------------------------------ CLIs


@pytest.fixture
def small_body(tmp_path, monkeypatch):
    """A V = 600 body's artifacts and coarsening where the CLIs look for
    them."""
    base = tmp_path / "base_data"
    base.mkdir()
    synthetic_artifacts(seed=0, num_verts=V, num_faces=1200).save(
        str(base / "smpl_neutral.npz"))
    synthetic_coarsening(seed=0, sizes=(V, 150, NV)).save(
        str(base / "mesh_coarsening.npz"))
    monkeypatch.setenv("PMCE_TPU_DATA_DIR", str(base))
    return tmp_path


def _yml(path: Path, name: str, **groups) -> str:
    """A configs/train_mesh_h36m_bf16.yml-like config at a small width."""
    cfg = {
        "DATASET": {"train_list": ["Human36M"], "test_list": ["Human36M"],
                    "input_joint_set": "human36",
                    "target_joint_set": "human36", "synthetic": True},
        "MODEL": {"name": "PMCE", "hpe_dim": 32, "hpe_dep": 1,
                  "compute_dtype": "bfloat16", "fused_attn": True},
        "TRAIN": {"batch_size": 32, "end_epoch": 30, "lr": 1e-4},
        "TEST": {"batch_size": 8},
        "output_dir": str(path / "experiment"),
    }
    for group, values in groups.items():
        cfg[group].update(values)
    out = path / f"{name}.yml"
    out.write_text(yaml.safe_dump(cfg))
    return str(out)


def test_train_and_test_clis_on_the_cpu(small_body, capsys):
    tmp = small_body
    stage1 = _yml(tmp, "pose", MODEL={"name": "PoseEst"},
                  DATASET={"synthetic_samples": 64})
    res1 = train_cli.main(["--cfg", stage1, "--device", "cpu", "--smoke",
                           "--tag", "s1", "--seed", "5"])
    ckpt1 = tmp / "experiment" / "s1" / "checkpoint"
    assert sorted(p.name for p in ckpt1.iterdir()) == [
        "best.ckpt", "checkpoint1.ckpt", "final.ckpt"]
    assert type(res1).__name__ == "JointEvalResult"
    assert (tmp / "experiment" / "s1" / "metrics.jsonl").is_file()

    stage2 = _yml(tmp, "mesh", DATASET={"synthetic_samples": 64},
                  MODEL={"posenet_pretrained": True,
                         "posenet_path": str(ckpt1)})
    res2 = train_cli.main(["--cfg", stage2, "--device", "cpu", "--smoke",
                           "--tag", "s2"])
    out = capsys.readouterr().out
    assert f"loaded Stage-1 weights from {ckpt1}" in out
    assert "Final protocol evaluation:" in out
    assert "Human36M PA-MPJPE (mm)  >> tot:" in out
    for k in ("mpjpe", "pa_mpjpe", "mpvpe", "accel"):
        assert math.isfinite(getattr(res2, k)), k
    ckpt2 = tmp / "experiment" / "s2" / "checkpoint"
    assert (ckpt2 / "final.ckpt").is_file()

    # The test CLI on the final checkpoint gives the training run's final
    # evaluation back (same split, batches and weights).
    vis = tmp / "vis"
    res3 = test_cli.main(["--cfg", stage2, "--weights",
                          str(ckpt2 / "final.ckpt"), "--device", "cpu",
                          "--vis", str(vis)])
    out = capsys.readouterr().out
    assert "loaded weights from" in out and "(epoch 2)" in out
    assert "Human36M MPVPE (mm)     >> tot:" in out
    for k in ("mpjpe", "pa_mpjpe", "mpvpe", "accel"):
        assert getattr(res3, k) == pytest.approx(getattr(res2, k),
                                                 abs=1e-4), k
    objs = sorted(vis.glob("pred_*.obj"))
    assert objs and objs[0].name == "pred_000000.obj"
    verts, faces = load_obj(str(objs[0]))
    assert verts.shape == (V, 3) and faces.shape == (1200, 3)

    res4 = train_cli.main(["--cfg", stage2, "--device", "cpu", "--smoke",
                           "--tag", "s2", "--resume", str(ckpt2)])
    assert "resumed from epoch 2" in capsys.readouterr().out
    assert res4.mpjpe == pytest.approx(res2.mpjpe, abs=1e-4)

    test_cli.main(["--cfg", stage2, "--device", "cpu"])
    assert "WARNING: no weights given" in capsys.readouterr().out


def test_clis_refuse_what_they_cannot_run(small_body, monkeypatch):
    tmp = small_body
    # No card and no --device cpu: the CLIs raise before writing anything.
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        good = _yml(tmp, "good")
        for cli in (train_cli, test_cli):
            with pytest.raises(RuntimeError, match="no CUDA card"):
                cli.main(["--cfg", good])
    assert not (tmp / "experiment").exists()
    fsdp = _yml(tmp, "fsdp", TRAIN={"fsdp": True})
    with pytest.raises(NotImplementedError, match="A12"):
        train_cli.main(["--cfg", fsdp, "--device", "cpu"])
    bad = _yml(tmp, "bad", MODEL={"name": "PoseEstimator"})
    for cli in (train_cli, test_cli):
        with pytest.raises(ValueError, match="unknown MODEL.name"):
            cli.main(["--cfg", bad, "--device", "cpu"])


def test_bench_torch_small_on_the_cpu(monkeypatch, capsys):
    res = bench_torch.serving_rate(
        "cpu", batch=2, n_inputs=2, runs=2, iters=2, warmup=1,
        embed_dim=32, depth=1,
        art=synthetic_artifacts(seed=0, num_verts=V, num_faces=1200),
        coarse=synthetic_coarsening(seed=0, sizes=(V, 150, NV)))
    assert len(res["rates"]) == 2 and res["device_ms"] is None
    line = json.loads(json.dumps(bench_torch.result_line(res, "cpu")))
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["value"] > 0 and "cpu" in line["unit"]
    assert line["vs_baseline"] == round(
        res["median"] / bench_torch.REFERENCE_BASELINE_FPS, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_torch.main() != 0
    assert capsys.readouterr().out == ""
