"""Training and evaluation of both stages: steps, epoch loop, checkpoints.

Port of ``pmce_tpu/core/trainer.py``: Stage-2 PMCE mesh training
(``MODEL.name = "PMCE"``, the reference's Trainer / Tester,
``lib/core/base.py:94-263``) and Stage-1 lifter training (``"PoseEst"``,
LiftTrainer / LiftTester, ``base.py:266-388``):

- :func:`make_pmce_train_step` / :func:`make_lift_train_step`: forward in
  training mode (stochastic depth from an explicit generator), the loss
  (the six-term mesh loss with its per-epoch edge gate; the masked
  CoordLoss on the mid-frame pose), backward, one optimizer step and one
  schedule step;
- :func:`make_pmce_eval_step` / :func:`make_lift_eval_step`: root-aligned
  MPJPE (and, for PMCE, MPVPE) sums over a batch;
- :class:`Trainer`: the epoch loop with the loss summed on the device and
  read once per epoch, evaluation with one read at its end, the test
  dataset's protocol evaluation (:meth:`Trainer.full_evaluate`), best /
  final / per-epoch checkpoints and :meth:`Trainer.restore`.

Parameters stay f32; under the bf16 policy the model's products run in
bf16. On that policy the BiGRU's recurrences run the GRU kernels forward
and backward on the card; with ``fused`` the lifter's blocks run the block
kernels (Stages 1 and 2), the decoder's attention blocks theirs (Stage 2),
and evaluation in eval mode runs the trunk and chain kernels. Several
devices and sharded parameters are not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable

import numpy as np
import torch

from pmce_tpu_torch.core import checkpoint as ckpt_lib
from pmce_tpu_torch.core.config import Config
from pmce_tpu_torch.core.losses import (
    build_face_losses,
    contract_vertices,
    coord_l1,
    pmce_total_loss,
)
from pmce_tpu_torch.core.optim import build_optimizer
from pmce_tpu_torch.utils.obj_io import save_obj

# H36M protocol eval joints (reference data/Human36M/dataset.py:62).
H36M_EVAL_JOINTS = (1, 2, 3, 4, 5, 6, 8, 10, 11, 12, 13, 14, 15, 16)


@dataclasses.dataclass
class TrainState:
    """What a step advances besides the model's parameters, which the
    optimizer updates in place."""

    optimizer: torch.optim.Optimizer
    scheduler: Any
    step: int = 0


def pmce_loss(model, batch: dict, faces, J_reg_target, weights: tuple,
              edge_gate: float, face_loss_fn=None, generator=None):
    """The PMCE forward and its six-term loss on one batch, in the model's
    current mode: (total, terms). ``weights`` = (normal, edge, joint)."""
    mesh, evo, pose3d = model(batch["pose2d"], batch["img_feature"],
                              generator=generator)
    return pmce_total_loss(
        mesh, evo, pose3d, batch["mesh"], batch["lift_pose3d"],
        batch["reg_pose3d"], batch["mesh_valid"],
        batch["lift_pose3d_valid"], batch["reg_pose3d_valid"], faces,
        J_reg_target, *weights, edge_gate, face_loss_fn=face_loss_fn)


def make_pmce_train_step(model, faces, J_reg_target, normal_weight: float,
                         edge_weight: float, joint_weight: float
                         ) -> Callable:
    """Stage-2 step: ``step_fn(state, batch, generator, edge_gate) ->
    (loss, terms)``, ``edge_gate`` 1.0 from the epoch after
    ``TRAIN.edge_loss_start`` on (0.0 before). ``faces`` [F, 3] and
    ``J_reg_target`` [17, V] (the target joint set's regressor) are numpy
    arrays or tensors; they go to the model's device once. The loss and
    the terms come back as 0-d device tensors (no host sync)."""
    dev = next(model.parameters()).device
    J_reg = torch.as_tensor(np.asarray(J_reg_target), dtype=torch.float32,
                            device=dev)
    # The vertex count from the regressor, not max(faces) + 1.
    face_loss_fn = build_face_losses(np.asarray(faces), J_reg.shape[1], dev)
    faces_t = torch.as_tensor(np.asarray(faces), dtype=torch.long,
                              device=dev)
    weights = (normal_weight, edge_weight, joint_weight)

    def step_fn(state: TrainState, batch: dict, generator=None,
                edge_gate: float = 0.0):
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss, terms = pmce_loss(model, batch, faces_t, J_reg, weights,
                                edge_gate, face_loss_fn, generator)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return loss.detach(), {k: v.detach() for k, v in terms.items()}

    return step_fn


def make_pmce_eval_step(model, J_reg_target,
                        eval_joints: tuple = H36M_EVAL_JOINTS) -> Callable:
    """The reference's batch metrics (``compute_both_err``,
    ``Human36M/dataset.py:611-623``): mesh and joints root-aligned by the
    predicted / ground-truth joint 0, the joint error over the 14 H36M eval
    joints, the mesh error over every vertex, in millimeters.
    ``eval_fn(batch)`` returns the predictions and the weighted error sums
    and count as device tensors."""
    dev = next(model.parameters()).device
    J_reg = torch.as_tensor(np.asarray(J_reg_target), dtype=torch.float32,
                            device=dev)
    idx = list(eval_joints)

    @torch.no_grad()
    def eval_fn(batch: dict) -> dict:
        model.eval()
        mesh, _, pose3d = model(batch["pose2d"], batch["img_feature"])
        pred_mesh = mesh * 1000.0
        gt_mesh = batch["mesh"] * 1000.0
        pred_joint = contract_vertices(J_reg, pred_mesh)
        gt_joint = batch["reg_pose3d"]
        pm = pred_mesh - pred_joint[:, :1]
        gm = gt_mesh - gt_joint[:, :1]
        pj = (pred_joint - pred_joint[:, :1])[:, idx]
        gj = (gt_joint - gt_joint[:, :1])[:, idx]
        w = batch.get("_weight")
        if w is None:
            w = torch.ones(pred_mesh.shape[0], device=pred_mesh.device)
        mesh_per = (pm - gm).square().sum(-1).sqrt().mean(-1)
        joint_per = (pj - gj).square().sum(-1).sqrt().mean(-1)
        return {"pred_mesh": pred_mesh, "pred_joint": pred_joint,
                "pose3d": pose3d, "mesh_err_sum": (mesh_per * w).sum(),
                "joint_err_sum": (joint_per * w).sum(), "n": w.sum()}

    return eval_fn


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
    """Epoch loop of PMCE (mesh) or PoseEst (lift) training on one device.

    PMCE needs ``faces`` [F, 3] and ``J_reg_target`` [17, V], the target
    joint set's regressor (numpy)."""

    cfg: Config
    model: Any
    train_data: Any               # has sample_batch(batch_size) and len()
    test_data: Any | None         # a ClipDataset, or None
    faces: Any = None
    J_reg_target: Any = None
    ckpt_dir: str = ""
    device: Any = "cuda"
    log_fn: Callable = print
    eval_root_idx: int = 0
    eval_joints: tuple | None = H36M_EVAL_JOINTS
    metric_logger: Any = None     # optional utils.logging.MetricLogger

    def __post_init__(self):
        if self.cfg.MODEL.name not in ("PMCE", "PoseEst"):
            raise ValueError(f"unknown MODEL.name {self.cfg.MODEL.name!r}")
        self.is_mesh_model = self.cfg.MODEL.name == "PMCE"
        tcfg, mcfg = self.cfg.TRAIN, self.cfg.MODEL
        self.device = torch.device(self.device)
        self.model.to(self.device)
        self.steps_per_epoch = (
            tcfg.steps_per_epoch
            or max(1, len(self.train_data) // tcfg.batch_size))
        self.loss_history: list = []
        self.error_history: dict = {"surface": [], "joint": []}
        if self.is_mesh_model:
            if self.faces is None or self.J_reg_target is None:
                raise ValueError("PMCE training needs faces and J_reg_target")
            self.train_step = make_pmce_train_step(
                self.model, self.faces, self.J_reg_target,
                mcfg.normal_loss_weight, mcfg.edge_loss_weight,
                mcfg.joint_loss_weight)
            self.eval_step = make_pmce_eval_step(
                self.model, self.J_reg_target,
                self.eval_joints or H36M_EVAL_JOINTS)
        else:
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
        edge_gate = 1.0 if epoch > tcfg.edge_loss_start else 0.0
        running = None
        n = 0
        t0 = time.time()
        for _ in range(self.steps_per_epoch):
            batch = self._wire_cast(
                self.train_data.sample_batch(tcfg.batch_size))
            terms = {}
            if self.is_mesh_model:
                loss, terms = self.train_step(state, batch, gen, edge_gate)
            else:
                loss = self.train_step(state, batch, gen)
            running = loss if running is None else running + loss
            n += 1
            if (self.metric_logger is not None
                    and n % max(tcfg.print_freq, 1) == 0):
                rec = {"train/loss": float(loss)}
                rec.update({f"train/{k}_loss": float(v)
                            for k, v in terms.items()})
                self.metric_logger.log(rec, step=state.step)
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
        0. Returns (joint_err, surface_err, per-sample results if
        ``collect``); surface_err (MPVPE) is 0 for the lifter."""
        from pmce_tpu_torch.data.clip_dataset import epoch_iterator

        sums = None
        results = []
        keys = ("joint_err_sum", "n") + (
            ("mesh_err_sum",) if self.is_mesh_model else ())
        for batch in epoch_iterator(self.test_data, self.cfg.TEST.batch_size,
                                    shuffle=False, seed=0, drop_last=False):
            out = self.eval_step(self._wire_cast(batch))
            sums = ({k: out[k] for k in keys} if sums is None
                    else {k: sums[k] + out[k] for k in keys})
            if collect:
                pred = out["pred_joint"].float().cpu().numpy()
                mesh = (out["pred_mesh"].float().cpu().numpy()
                        if self.is_mesh_model else None)
                for j in range(len(pred)):
                    if self.is_mesh_model:
                        results.append({
                            "joint_coord": pred[j], "mesh_coord": mesh[j],
                            "mesh_coord_target": batch["mesh"][j] * 1000.0,
                            "joint_coord_target": batch["reg_pose3d"][j]})
                    else:
                        results.append({"joint_coord": pred[j],
                                        "joint_coord_target":
                                            batch["lift_pose3d"][j]})
        # The one host read of the evaluation.
        sums = (dict(zip(keys, torch.stack([sums[k] for k in keys]).tolist()))
                if sums is not None else {})
        denom = max(sums.get("n", 0.0), 1.0)
        joint_err = sums.get("joint_err_sum", 0.0) / denom
        surface_err = sums.get("mesh_err_sum", 0.0) / denom
        self.error_history["joint"].append(joint_err)
        self.error_history["surface"].append(surface_err)
        if self.metric_logger is not None:
            self.metric_logger.log({"error/MPJPE": joint_err,
                                    "error/MPVPE": surface_err})
        self.log_fn(f"Eval: MPJPE {joint_err:.2f} mm"
                    + (f", MPVPE {surface_err:.2f} mm"
                       if self.is_mesh_model else ""))
        return joint_err, surface_err, results

    def full_evaluate(self, verbose: bool = True, vis_dir: str = "",
                      vis_every: int = 500):
        """The test dataset's own protocol evaluation (the reference's
        final ``dataset.evaluate(result)``, ``base.py:262-263``) over one
        collecting pass: the mesh protocol for PMCE, the joint protocol for
        the lifter. With ``vis_dir`` (the reference's ``cfg.TEST.vis``),
        every ``vis_every``-th predicted mesh is written there as an OBJ
        (reference ``Human36M/dataset.py:818-822``). As :meth:`evaluate`,
        it reads the parameters from the model, so it takes no state."""
        _, _, results = self.evaluate(collect=True)
        results = results[:len(self.test_data)]
        if vis_dir and self.is_mesh_model:
            os.makedirs(vis_dir, exist_ok=True)
            for i in range(0, len(results), max(vis_every, 1)):
                save_obj(results[i]["mesh_coord"] / 1000.0, self.faces,
                         os.path.join(vis_dir, f"pred_{i:06d}.obj"))
        if self.is_mesh_model:
            return self.test_data.evaluate(results, verbose=verbose)
        return self.test_data.evaluate_joint(results, verbose=verbose)

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
