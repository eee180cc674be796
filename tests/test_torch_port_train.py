"""Stage-1 lifter training in the port against the JAX package, on the CPU.

Small sizes (embed 32, 4 heads, depth ≤ 2, a V = 600 synthetic body);
weights, inputs and masks come from numpy with a seed and go to both sides.

- config: the strict overlay of ``load_config``;
- optimizer: the per-step MultiStep schedule against optax's at every
  milestone, and four adam / sgd / rmsprop steps of lr 0.05 against
  optax's on unit-scale weights (1e-5: the same update rules in f32,
  evaluated in another order; rmsprop adds eps outside the root in torch
  and inside in optax, which moves nothing at these gradient sizes);
- ``coord_l1`` against JAX (1e-6 relative);
- synthetic sequences and ``ClipDataset`` batches for one seed: the numpy
  draws equal; the SMPL-derived arrays agree to f32 rounding. Root-relative
  millimetres within 0.002 mm: they are differences of camera-space values
  at ~4.5 m, where one f32 step is 0.00048 mm (measured: 0.00096). Pixels
  and features within 2e-5 of the array's largest magnitude (measured:
  1.2e-7 and 8.7e-6);
- one f32 ``fused=True`` lift train step against JAX
  ``make_lift_train_step`` on the same converted weights with
  ``drop_path_rate=0``: the loss within 1e-5 relative, every gradient
  within 1e-4 of its largest magnitude (the block gradients go through the
  JAX block kernel's VJP, interpreted, on one side and PyTorch's autograd
  of the plain block on the other), every updated parameter within 1e-6
  (the Adam step is ±lr·sign(g) where |g| ≫ eps);
- the eval step's error sum against JAX's (1e-5 relative);
- a small ``Trainer.fit`` (2 epochs × 6 steps, lr 1e-3, as
  ``tests/test_trainer.py::test_lift_training``): the loss falls, the
  best / final / per-epoch files are written, and ``restore`` gives back
  the parameters, the optimizer and schedule state and the histories.
"""

from __future__ import annotations

import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pmce_tpu.core.config import Config as JaxConfig
from pmce_tpu.core.losses import coord_l1 as jax_coord_l1
from pmce_tpu.core.optim import build_optimizer as jax_build_optimizer
from pmce_tpu.core.optim import multistep_schedule as jax_schedule
from pmce_tpu.core.trainer import TrainState as JaxTrainState
from pmce_tpu.core.trainer import make_lift_eval_step as jax_eval_step
from pmce_tpu.core.trainer import make_lift_train_step as jax_train_step
from pmce_tpu.data.clip_dataset import ClipDataset as JaxClipDataset
from pmce_tpu.data.clip_dataset import MultiDataset as JaxMultiDataset
from pmce_tpu.data.clip_dataset import epoch_iterator as jax_epoch_iterator
from pmce_tpu.data.synthetic import generate_sequences as jax_generate
from pmce_tpu.models.pose_lifter import PoseLifter as JaxPoseLifter
from pmce_tpu.smpl.artifacts import synthetic_artifacts as jax_artifacts
from pmce_tpu_torch.convert import lifter_state_dict_from_jax
from pmce_tpu_torch.core import checkpoint as ckpt_lib
from pmce_tpu_torch.core.config import Config, load_config
from pmce_tpu_torch.core.losses import coord_l1
from pmce_tpu_torch.core.optim import build_optimizer, multistep_schedule
from pmce_tpu_torch.core.trainer import (
    Trainer,
    TrainState,
    make_lift_eval_step,
    make_lift_train_step,
)
from pmce_tpu_torch.data.clip_dataset import (
    ClipDataset,
    MultiDataset,
    epoch_iterator,
)
from pmce_tpu_torch.data.synthetic import generate_sequences
from pmce_tpu_torch.models.pmce import PMCE, create_pmce
from pmce_tpu_torch.models.pose_lifter import PoseLifter, create_pose_lifter
from pmce_tpu_torch.smpl.artifacts import synthetic_artifacts
from pmce_tpu_torch.smpl.layer import SMPLModel
from pmce_tpu_torch.utils.logging import MetricLogger

from torch_port_common import init_shapes, numpy_params, rel_max_err

T, J = 16, 17


# ------------------------------------------------------------ config, optim


def test_load_config_strict_overlay(tmp_path):
    p = tmp_path / "c.yml"
    p.write_text("MODEL:\n  name: PoseEst\n  compute_dtype: bfloat16\n"
                 "TRAIN:\n  lr: 0.01\n  lr_step: [2, 4]\n")
    cfg = load_config(str(p), overrides={"TRAIN": {"batch_size": 4}})
    assert (cfg.MODEL.name, cfg.MODEL.compute_dtype) == ("PoseEst",
                                                         "bfloat16")
    assert cfg.TRAIN.lr == 0.01 and cfg.TRAIN.lr_step == [2, 4]
    assert cfg.TRAIN.batch_size == 4
    bad = tmp_path / "bad.yml"
    bad.write_text("TRAIN:\n  learning_rate: 0.01\n")
    with pytest.raises(ValueError, match="learning_rate"):
        load_config(str(bad))
    with pytest.raises(ValueError, match="nope"):
        load_config(overrides={"MODEL": {"nope": 1}})


def test_schedule_matches_optax_at_every_milestone():
    milestones, factor, spe, lr = [10, 30, 50], 0.8, 7, 5e-5
    want = jax_schedule(lr, milestones, factor, spe)
    got = multistep_schedule(lr, milestones, factor, spe)
    cfg = Config()
    cfg.TRAIN.lr, cfg.TRAIN.lr_step, cfg.TRAIN.lr_factor = (lr, milestones,
                                                            factor)
    opt, sched = build_optimizer(cfg.TRAIN, spe,
                                 [torch.nn.Parameter(torch.zeros(1))])
    steps = sorted({0, 1, *(m * spe + d for m in milestones
                            for d in (-1, 0, 1))})
    k = 0
    for s in steps:
        while k < s:
            opt.step()
            sched.step()
            k += 1
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6)
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(want(s)),
                                   rtol=1e-6)


@pytest.mark.parametrize("name", ["adam", "sgd", "rmsprop"])
def test_optimizer_steps_match_optax(name):
    rng = np.random.default_rng(3)
    p0 = rng.normal(size=(5, 4)).astype(np.float32)
    target = rng.normal(size=(5, 4)).astype(np.float32)
    cfg, jcfg = Config(), JaxConfig()
    for c in (cfg, jcfg):
        c.TRAIN.optimizer, c.TRAIN.lr, c.TRAIN.lr_step = name, 0.05, [1]
        c.TRAIN.lr_factor = 0.5
    tx = jax_build_optimizer(jcfg.TRAIN, 2)
    jp = jnp.asarray(p0)
    js = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, sched = build_optimizer(cfg.TRAIN, 2, [tp])
    for _ in range(4):
        upd, js = tx.update(jp - target, js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.zero_grad()
        tp.grad = tp.detach() - torch.from_numpy(target)
        opt.step()
        sched.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               rtol=0, atol=1e-5)


def test_coord_l1_matches_jax():
    rng = np.random.default_rng(5)
    pred, gt = (rng.normal(size=(4, J, 3)).astype(np.float32) * 100
                for _ in range(2))
    valid = (rng.random((4, J, 1)) > 0.3).astype(np.float32)
    for v in (None, valid):
        want = float(jax_coord_l1(jnp.asarray(pred), jnp.asarray(gt),
                                  None if v is None else jnp.asarray(v)))
        got = float(coord_l1(torch.from_numpy(pred), torch.from_numpy(gt),
                             None if v is None else torch.from_numpy(v)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


# --------------------------------------------------------------------- data


@pytest.fixture(scope="module")
def body():
    art = synthetic_artifacts(seed=0, num_verts=600, num_faces=1200)
    rng = np.random.default_rng(0)
    jr = rng.random((J, 600)).astype(np.float32)
    jr /= jr.sum(1, keepdims=True)
    return art, jr


@pytest.fixture(scope="module")
def sequences(body):
    art, jr = body
    jart = jax_artifacts(seed=0, num_verts=600, num_faces=1200)
    port = [generate_sequences(art, jr, num_videos=2, frames_per_video=40,
                               seed=s, device="cpu") for s in (0, 1)]
    ref = [jax_generate(jart, jr, num_videos=2, frames_per_video=40, seed=s)
           for s in (0, 1)]
    return port, ref


EXACT = ("img_names", "smpl_pose", "smpl_shape", "has_smpl", "img_hw",
         "cam_idx")
MM = ("joint_cam", "joint_cam_h36m", "mesh_cam", "lift_pose3d",
      "reg_pose3d")
REL = ("joint_img", "pose2d_det", "features", "pose2d", "img_feature")


def _close(k, want, got):
    if k == "mesh":          # the batch's mesh is in meters
        k, want, got = "mesh_cam", want * 1000.0, got * 1000.0
    if k in MM:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-3, err_msg=k)
    else:
        assert k in REL, k
        assert rel_max_err(want, got) <= 2e-5, k


def test_synthetic_sequences_match_jax(sequences):
    for got, want in zip(*sequences):
        for k in EXACT:
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        for k in MM[:3] + REL[:3]:
            a, b = getattr(got, k), getattr(want, k)
            assert a.shape == b.shape and a.dtype == b.dtype, k
            _close(k, b, a)


@pytest.mark.parametrize("mode", ["pose", "mesh"])
def test_clip_batches_match_jax(sequences, mode):
    (p_train, p_test), (j_train, j_test) = sequences
    pd = ClipDataset(p_train, seqlen=T, stride=1, chunk_mode=mode)
    jd = JaxClipDataset(j_train, seqlen=T, stride=1, chunk_mode=mode)
    np.testing.assert_array_equal(pd.vid_indices, jd.vid_indices)
    pm = MultiDataset([pd, ClipDataset(p_test, chunk_mode=mode)], seed=4)
    jm = JaxMultiDataset([jd, JaxClipDataset(j_test, chunk_mode=mode)],
                         seed=4)
    assert len(pm) == len(jm)
    batches = [(pm.sample_batch(8), jm.sample_batch(8)) for _ in range(2)]
    batches += list(zip(epoch_iterator(pd, 12, True, 3, drop_last=False),
                        jax_epoch_iterator(jd, 12, True, 3, drop_last=False)))
    for got, want in batches:
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            if k in ("pose2d", "img_feature", "mesh", "lift_pose3d",
                     "reg_pose3d"):
                _close(k, want[k], got[k])
            else:
                np.testing.assert_array_equal(got[k], want[k])


# ------------------------------------------------------------- train steps


def _lift_case(seed=11, B=4, depth=2):
    rng = np.random.default_rng(seed)
    jm = JaxPoseLifter(num_joints=J, num_frames=T, embed_dim=32, depth=depth,
                       num_heads=4, drop_path_rate=0.0, fused_attn=True)
    batch = {
        "pose2d": rng.normal(size=(B, T, J, 2)).astype(np.float32),
        "img_feature": rng.normal(size=(B, T, 2048)).astype(np.float32),
        "lift_pose3d": (rng.normal(size=(B, J, 3)) * 300).astype(np.float32),
        "lift_pose3d_valid": (rng.random((B, J, 1)) > 0.2).astype(
            np.float32),
        "_weight": np.array([1, 1, 1, 0], np.float32)[:B],
    }
    params = numpy_params(init_shapes(jm, batch["pose2d"][:1],
                                      batch["img_feature"][:1]), seed)
    model = PoseLifter(num_joints=J, num_frames=T, embed_dim=32, depth=depth,
                       num_heads=4, drop_path_rate=0.0, fused=True)
    model.load_state_dict(lifter_state_dict_from_jax(params), strict=True)
    return jm, params, model, batch


def _cfg(lr=1e-3):
    cfg, jcfg = Config(), JaxConfig()
    for c in (cfg, jcfg):
        c.MODEL.name = "PoseEst"
        c.TRAIN.lr = lr
    return cfg, jcfg


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_lift_train_step_matches_jax_f32():
    jm, params, model, batch = _lift_case()
    cfg, jcfg = _cfg()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        pred = jm.apply({"params": p}, jb["pose2d"], jb["img_feature"],
                        deterministic=False,
                        rngs={"dropout": jax.random.PRNGKey(1),
                              "droppath": jax.random.PRNGKey(2)})
        return jax_coord_l1(pred, jb["lift_pose3d"], jb["lift_pose3d_valid"])

    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want_loss, want_grads = jax.value_and_grad(loss_fn)(jparams)
    tx = jax_build_optimizer(jcfg.TRAIN, 10)
    state = JaxTrainState(params=jparams, opt_state=tx.init(jparams),
                          step=jnp.zeros((), jnp.int32))
    state, step_loss = jax_train_step(jm, tx)(state, jb,
                                              jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(step_loss), float(want_loss),
                               rtol=1e-6)

    opt, sched = build_optimizer(cfg.TRAIN, 10, model.parameters())
    tstate = TrainState(optimizer=opt, scheduler=sched)
    loss = make_lift_train_step(model)(tstate, _tensors(batch),
                                       torch.Generator().manual_seed(0))
    assert tstate.step == 1 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)

    g_want = lifter_state_dict_from_jax(jax.device_get(want_grads))
    p_want = lifter_state_dict_from_jax(jax.device_get(state.params))
    for name, p in model.named_parameters():
        g = p.grad.numpy()
        assert rel_max_err(g_want[name].numpy(), g) <= 1e-4, name
        # Adam's first step moves each weight by lr·g/(|g| + eps): where
        # |g| is within the gradients' rounding of 0, the sign may differ.
        gw = g_want[name].numpy()
        tiny = np.abs(gw) <= 1e-5 * np.abs(gw).max()
        diff = np.abs(p.detach().numpy() - p_want[name].numpy())
        assert (diff[~tiny] <= 1e-6).all(), (name, diff[~tiny].max())


def test_lift_eval_step_matches_jax():
    jm, params, model, batch = _lift_case(seed=12)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax_eval_step(jm)(jax.tree_util.tree_map(jnp.asarray, params), jb)
    model.train()   # the eval step itself switches to eval mode
    got = make_lift_eval_step(model)(_tensors(batch))
    assert not model.training
    np.testing.assert_allclose(float(got["joint_err_sum"]),
                               float(want["joint_err_sum"]), rtol=1e-5)
    assert float(got["n"]) == float(want["n"]) == 3.0
    assert rel_max_err(want["pred_joint"], got["pred_joint"].numpy()) <= 1e-5


# --------------------------------------------------------------- trainer


@pytest.fixture(scope="module")
def datasets(sequences):
    (train, test), _ = sequences
    return (ClipDataset(train, seqlen=T, stride=1, chunk_mode="pose"),
            ClipDataset(test, seqlen=T, stride=1, chunk_mode="pose"))


def _trainer(datasets, ckpt_dir, seed=0):
    cfg, _ = _cfg()
    cfg.TRAIN.batch_size = cfg.TEST.batch_size = 8
    cfg.TRAIN.end_epoch, cfg.TRAIN.steps_per_epoch = 2, 6
    cfg.TRAIN.lr_step = [1]        # the schedule steps once, after epoch 1
    model = create_pose_lifter(num_joints=J, embed_dim=32, depth=2,
                               fused=True, device="cpu", seed=seed)
    train_ds, test_ds = datasets
    log = []
    trainer = Trainer(cfg=cfg, model=model,
                      train_data=MultiDataset([train_ds], seed=0),
                      test_data=test_ds, ckpt_dir=ckpt_dir, device="cpu",
                      log_fn=log.append)
    return trainer, log


def test_trainer_fit_checkpoints_and_restore(datasets, tmp_path):
    trainer, log = _trainer(datasets, str(tmp_path))
    state = trainer.fit()
    assert len(trainer.loss_history) == 2
    assert all(np.isfinite(trainer.loss_history))
    assert trainer.loss_history[-1] < trainer.loss_history[0]
    assert len(trainer.error_history["joint"]) == 2
    assert np.isfinite(trainer.error_history["joint"][-1])
    assert state.step == 12
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(
        1e-3 * trainer.cfg.TRAIN.lr_factor)
    assert sorted(os.listdir(tmp_path)) == ["best.ckpt", "checkpoint1.ckpt",
                                            "final.ckpt"]
    assert any(s.startswith("Epoch 2: loss") for s in log)

    fresh, _ = _trainer(datasets, "", seed=5)
    restored, epoch = fresh.restore(str(tmp_path))
    assert epoch == 2 and restored.step == 12
    assert fresh.loss_history == trainer.loss_history
    assert fresh.error_history == trainer.error_history
    for (name, a), b in zip(trainer.model.state_dict().items(),
                            fresh.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    sa, sb = state.optimizer.state_dict(), restored.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for k, v in st.items():
            torch.testing.assert_close(v, sb["state"][i][k], rtol=0, atol=0)
    assert restored.scheduler.state_dict() == state.scheduler.state_dict()


def test_checkpoint_selection_rules(tmp_path):
    for n in (9, 12, 3):
        ckpt_lib.save_checkpoint(str(tmp_path), n, 20, {"x": n})
    # Numeric, not lexicographic: checkpoint12 is the latest epoch.
    assert ckpt_lib.load_checkpoint(str(tmp_path), prefer="latest")[
        "epoch"] == 12
    ckpt_lib.save_checkpoint(str(tmp_path), 4, 20, {"x": 4}, is_best=True)
    assert ckpt_lib.load_checkpoint(str(tmp_path))["epoch"] == 4
    assert ckpt_lib.load_checkpoint(str(tmp_path), prefer="latest")[
        "epoch"] == 12
    ckpt_lib.save_checkpoint(str(tmp_path), 20, 20, {"x": 20})
    assert ckpt_lib.resolve_checkpoint(str(tmp_path), "latest").endswith(
        "final.ckpt")
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        ckpt_lib.resolve_checkpoint(str(empty), "best")


def test_metric_logger_writes_jsonl(tmp_path):
    logger = MetricLogger(out_dir=str(tmp_path))
    logger.log({"train/loss": 1.5}, step=3)
    logger.log({"error/MPJPE": 80.0})
    logger.close()
    recs = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert recs[0]["train/loss"] == 1.5 and recs[0]["step"] == 3
    assert recs[1]["error/MPJPE"] == 80.0 and "step" not in recs[1]
    assert all("time" in r for r in recs)


def test_pmce_training_names_the_kernels_it_waits_for():
    """Fused PMCE training runs the attention-block wrappers whose kernels
    (table rows 4, 5 and 8-11) it waited for: per CoevoBlock one
    ``fused_mhsa`` (the 17-joint stream), one ``ada_block`` (72 coarse
    vertices, > 64) and two ``ca_block``; the lifter's blocks through
    ``transformer_block``; and the gradient reaches every parameter of the
    blocks the output depends on (every block's vertex stream and the last
    block's joint stream: each block re-reads the lifted joints)."""
    from unittest import mock

    from pmce_tpu_torch.ops import fused_attention as fa

    model = PMCE(num_joint=J, vj_relation=(0,) * 72, embed_dim=32, depth=1,
                 num_vertx=72, num_verts_full=100, gru_hidden=32,
                 fused=True).train()
    rng = np.random.default_rng(0)
    names = ("fused_mhsa", "ada_block", "ca_block", "transformer_block")
    with mock.patch.multiple(fa, **{n: mock.MagicMock(wraps=getattr(fa, n))
                                    for n in names}):
        m = {n: getattr(fa, n) for n in names}
        outs = model(torch.from_numpy(rng.normal(size=(2, T, J, 2)).astype(
                         np.float32)),
                     torch.from_numpy(rng.normal(size=(2, T, 2048)).astype(
                         np.float32)),
                     generator=torch.Generator().manual_seed(0))
        sum(o.sum() for o in outs).backward()
        counts = tuple(m[n].call_count for n in names)
    assert counts == (3, 3, 6, 2)
    for name, p in model.pose_mesh_coevo.named_parameters():
        if "_FFN." in name and ("vertx_" in name
                                or name.startswith("coevoblock3.")):
            assert p.grad is not None and bool(p.grad.abs().sum() > 0) \
                or name.endswith(("wk.bias", "normk.mlp_beta.bias")), name


def test_entry_points_default_to_the_card():
    for fn in (create_pmce, create_pose_lifter, SMPLModel.from_artifacts,
               generate_sequences):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    field = Trainer.__dataclass_fields__["device"]
    assert field.default == "cuda"
