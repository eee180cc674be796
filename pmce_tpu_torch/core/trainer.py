"""Training and evaluation of the Stage-1 lifter: steps, epoch loop,
checkpoints.

Port of ``pmce_tpu/core/trainer.py`` for ``MODEL.name = "PoseEst"`` (the
reference's LiftTrainer / LiftTester, ``lib/core/base.py:266-388``):

- :func:`make_lift_train_step`: forward in training mode (stochastic depth
  from an explicit generator), the masked CoordLoss on the mid-frame pose,
  backward, one optimizer step and one schedule step;
- :func:`make_lift_eval_step`: root-aligned MPJPE sums over a batch;
- :class:`Trainer`: the epoch loop with the loss summed on the device and
  read once per epoch, evaluation with one read at its end, best / final /
  per-epoch checkpoints and :meth:`Trainer.restore`.

Parameters stay f32; under the bf16 policy the model's products run in
bf16 (``PoseLifter(dtype=torch.bfloat16)``), and with ``fused`` every
block of the training step is one ``transformer_block`` call: the block
kernels forward and backward on the card. Evaluation in eval mode runs
the lifter trunk kernel. PMCE mesh training, several devices and sharded
parameters are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from pmce_tpu_torch.core import checkpoint as ckpt_lib
from pmce_tpu_torch.core.config import Config
from pmce_tpu_torch.core.losses import coord_l1
from pmce_tpu_torch.core.optim import build_optimizer

# H36M protocol eval joints (reference data/Human36M/dataset.py:62).
H36M_EVAL_JOINTS = (1, 2, 3, 4, 5, 6, 8, 10, 11, 12, 13, 14, 15, 16)

# What PMCE mesh training runs that the port does not have yet.
_PMCE_PENDING = ("fused_mhsa and its backward (B4, B5)",
                 "fused_ada_block and its backward (B8, B9)",
                 "fused_ca_block and its backward (B10, B11)",
                 "the training GRU forward and backward (B12)",
                 "the mesh losses")


@dataclasses.dataclass
class TrainState:
    """What a step advances besides the model's parameters, which the
    optimizer updates in place."""

    optimizer: torch.optim.Optimizer
    scheduler: Any
    step: int = 0


def make_lift_train_step(model) -> Callable:
    """Stage-1 step: ``step_fn(state, batch, generator) -> loss``.

    The loss comes back as a 0-d device tensor (no host sync); the
    gradients stay in each parameter's ``.grad`` until the next step."""

    def step_fn(state: TrainState, batch: dict, generator=None):
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        pred = model(batch["pose2d"], batch["img_feature"],
                     generator=generator)
        loss = coord_l1(pred, batch["lift_pose3d"],
                        batch["lift_pose3d_valid"])
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return loss.detach()

    return step_fn


def make_lift_eval_step(model, root_idx: int = 0,
                        eval_joints: tuple | None = H36M_EVAL_JOINTS
                        ) -> Callable:
    """Root-aligned MPJPE of the lifter (H36M: root 0 and the 14 eval
    joints, ``Human36M/dataset.py:600-609``; PW3D: the coco pelvis and all
    joints). ``eval_fn(batch)`` returns the predictions and the weighted
    error sum and count as device tensors."""
    idx = None if eval_joints is None else list(eval_joints)

    @torch.no_grad()
    def eval_fn(batch: dict) -> dict:
        model.eval()
        pred = model(batch["pose2d"], batch["img_feature"])
        gt = batch["lift_pose3d"]
        p = pred - pred[:, root_idx][:, None]
        g = gt - gt[:, root_idx][:, None]
        if idx is not None:
            p, g = p[:, idx], g[:, idx]
        w = batch.get("_weight")
        if w is None:
            w = torch.ones(pred.shape[0], device=pred.device)
        per = (p - g).square().sum(-1).sqrt().mean(-1)
        return {"pred_joint": pred, "joint_err_sum": (per * w).sum(),
                "n": w.sum()}

    return eval_fn


@dataclasses.dataclass
class Trainer:
    """Epoch loop of Stage-1 (``PoseEst``) training on one device."""

    cfg: Config
    model: Any
    train_data: Any               # has sample_batch(batch_size) and len()
    test_data: Any | None         # a ClipDataset, or None
    ckpt_dir: str = ""
    device: Any = "cuda"
    log_fn: Callable = print
    eval_root_idx: int = 0
    eval_joints: tuple | None = H36M_EVAL_JOINTS
    metric_logger: Any = None     # optional utils.logging.MetricLogger

    def __post_init__(self):
        if self.cfg.MODEL.name == "PMCE":
            raise NotImplementedError(
                "PMCE mesh training waits for " + "; ".join(_PMCE_PENDING))
        if self.cfg.MODEL.name != "PoseEst":
            raise ValueError(f"unknown MODEL.name {self.cfg.MODEL.name!r}")
        tcfg = self.cfg.TRAIN
        self.device = torch.device(self.device)
        self.model.to(self.device)
        self.steps_per_epoch = (
            tcfg.steps_per_epoch
            or max(1, len(self.train_data) // tcfg.batch_size))
        self.loss_history: list = []
        self.error_history: dict = {"surface": [], "joint": []}
        self.train_step = make_lift_train_step(self.model)
        self.eval_step = make_lift_eval_step(
            self.model, self.eval_root_idx, self.eval_joints)

    # ---------------------------------------------------------------- init
    def init_state(self) -> TrainState:
        """Fresh optimizer and schedule over the model's parameters."""
        opt, sched = build_optimizer(self.cfg.TRAIN, self.steps_per_epoch,
                                     self.model.parameters())
        return TrainState(optimizer=opt, scheduler=sched)

    # --------------------------------------------------------------- train
    def _wire_cast(self, batch: dict) -> dict:
        """A numpy batch as tensors on the trainer's device. Under the bf16
        policy the image features travel in bf16: the model's first dense
        layer casts them to bf16 anyway, so the compute is the same for
        half the bytes of the batch's largest tensor. Coordinates stay
        f32."""
        bf16 = getattr(self.model, "dtype", None) == torch.bfloat16
        pinned = self.device.type == "cuda"
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if bf16 and k == "img_feature":
                t = t.to(torch.bfloat16)
            if pinned:
                # A copy from pinned memory lets the host go on while the
                # card still runs the previous step; one from pageable
                # memory would wait for it.
                t = t.pin_memory()
            out[k] = t.to(self.device, non_blocking=pinned)
        return out

    def train_epoch(self, state: TrainState, epoch: int) -> TrainState:
        tcfg = self.cfg.TRAIN
        # Stochastic depth draws from one stream per (seed, epoch), on the
        # trainer's device: the masks are made where they are used.
        gen = torch.Generator(self.device).manual_seed(
            tcfg.seed * 100_003 + epoch)
        # The loss is summed on the device; reading it is a host sync, so
        # that happens at the logging cadence and once at the epoch's end.
        running = None
        n = 0
        t0 = time.time()
        for _ in range(self.steps_per_epoch):
            batch = self._wire_cast(
                self.train_data.sample_batch(tcfg.batch_size))
            loss = self.train_step(state, batch, gen)
            running = loss if running is None else running + loss
            n += 1
            if (self.metric_logger is not None
                    and n % max(tcfg.print_freq, 1) == 0):
                self.metric_logger.log({"train/loss": float(loss)},
                                       step=state.step)
        avg = float(running) / n if n else 0.0   # the one sync, timed
        dt = time.time() - t0
        self.loss_history.append(avg)
        self.log_fn(f"Epoch {epoch}: loss {avg:.4f} ({n} steps, "
                    f"{n * tcfg.batch_size / max(dt, 1e-9):.0f} samples/s)")
        return state

    # ---------------------------------------------------------------- eval
    def evaluate(self, collect: bool = False):
        """Weighted error sums accumulate on the device and are read once
        at the end; the wrap-padded samples of a ragged final batch weigh
        0. Returns (joint_err, surface_err = 0, per-sample results if
        ``collect``)."""
        from pmce_tpu_torch.data.clip_dataset import epoch_iterator

        js = cnt = None
        results = []
        for batch in epoch_iterator(self.test_data, self.cfg.TEST.batch_size,
                                    shuffle=False, seed=0, drop_last=False):
            out = self.eval_step(self._wire_cast(batch))
            if js is None:
                js, cnt = out["joint_err_sum"], out["n"]
            else:
                js, cnt = js + out["joint_err_sum"], cnt + out["n"]
            if collect:
                pred = out["pred_joint"].float().cpu().numpy()
                for j in range(len(pred)):
                    results.append({"joint_coord": pred[j],
                                    "joint_coord_target":
                                        batch["lift_pose3d"][j]})
        denom = max(float(cnt) if cnt is not None else 0.0, 1.0)
        joint_err = float(js) / denom if js is not None else 0.0
        self.error_history["joint"].append(joint_err)
        self.error_history["surface"].append(0.0)
        if self.metric_logger is not None:
            self.metric_logger.log({"error/MPJPE": joint_err,
                                    "error/MPVPE": 0.0})
        self.log_fn(f"Eval: MPJPE {joint_err:.2f} mm")
        return joint_err, 0.0, results

    # ------------------------------------------------------------- restore
    def restore(self, path: str) -> tuple[TrainState, int]:
        """Resume from a checkpoint file or directory (the latest epoch):
        parameters, optimizer and schedule state, and the loss and error
        histories. Returns (state, last completed epoch)."""
        state = self.init_state()
        loaded = ckpt_lib.load_checkpoint(path, prefer="latest")
        self.model.load_state_dict(loaded["params"])
        state.optimizer.load_state_dict(loaded["opt_state"])
        state.scheduler.load_state_dict(loaded["scheduler"])
        state.step = int(loaded["step"])
        self.loss_history = list(loaded.get("train_log", []))
        if loaded.get("test_log"):
            self.error_history = {k: list(v)
                                  for k, v in loaded["test_log"].items()}
        return state, int(loaded.get("epoch", 0))

    # ----------------------------------------------------------------- fit
    def fit(self, state: TrainState | None = None) -> TrainState:
        tcfg = self.cfg.TRAIN
        if state is None:
            state = self.init_state()
        # A resumed run seeds "best" from its history, so a worse first
        # epoch does not overwrite the historical best.ckpt.
        best = min(self.error_history["joint"], default=np.inf)
        for epoch in range(tcfg.begin_epoch, tcfg.end_epoch + 1):
            state = self.train_epoch(state, epoch)
            joint_err = (self.evaluate()[0] if self.test_data is not None
                         else np.inf)
            if self.ckpt_dir:
                is_best = joint_err < best
                best = min(best, joint_err)
                ckpt_lib.save_checkpoint(
                    self.ckpt_dir, epoch, tcfg.end_epoch,
                    {"params": self.model.state_dict(),
                     "opt_state": state.optimizer.state_dict(),
                     "scheduler": state.scheduler.state_dict(),
                     "step": state.step,
                     "train_log": self.loss_history,
                     "test_log": self.error_history},
                    is_best=is_best)
        return state
