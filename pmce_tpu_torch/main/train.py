"""Training CLI of the port.

    python -m pmce_tpu_torch.main.train --cfg configs/train_mesh_h36m_bf16.yml

Port of ``main/train.py`` (the reference's ``main/train.py``): trains the
PMCE mesh model or the Stage-1 pose lifter (``MODEL.name``) on the card,
evaluating and checkpointing every epoch (best / final / per-epoch files
under ``{output_dir}/{tag}/checkpoint``), then runs the test dataset's
protocol evaluation. ``--smoke`` cuts the run to 2 epochs × 4 steps with
batches of at most 8 and 64 synthetic samples; ``--device cpu`` runs on the
host (for tests). One seed feeds the weights, the batch draws and the
stochastic depth. Several devices (``TRAIN.fsdp``) are not ported.
"""

from __future__ import annotations

import argparse

from pmce_tpu_torch.core.config import ensure_output_dirs, load_config
from pmce_tpu_torch.core.trainer import Trainer
from pmce_tpu_torch.data.clip_dataset import MultiDataset
from pmce_tpu_torch.data.factory import (
    build_test_dataset,
    build_train_datasets,
    target_joint_regressor,
)
from pmce_tpu_torch.main.common import (
    build_model,
    describe,
    eval_protocol,
    resolve_device,
)
from pmce_tpu_torch.models.pmce import load_lifter_checkpoint
from pmce_tpu_torch.smpl.artifacts import ensure_cached_artifacts
from pmce_tpu_torch.smpl.mesh import ensure_cached_coarsening
from pmce_tpu_torch.utils.logging import MetricLogger


def main(argv: list | None = None):
    """Run the CLI on ``argv`` (default: the command line); returns the
    protocol evaluation's result."""
    p = argparse.ArgumentParser(description="Train pmce-tpu models (PyTorch)")
    p.add_argument("--cfg", type=str, required=True)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--resume", type=str, default="",
                   help="checkpoint dir/file to resume from")
    p.add_argument("--smoke", action="store_true",
                   help="2 epochs x 4 steps for a quick end-to-end check")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: the card; cpu for tests)")
    p.add_argument("--tag", type=str, default="run")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = load_config(args.cfg)
    if cfg.TRAIN.fsdp:
        raise NotImplementedError(
            "TRAIN.fsdp: training over several devices is not ported yet "
            "(ROADMAP A12); the port trains on one card")
    cfg.TRAIN.seed = args.seed
    if args.smoke:
        cfg.TRAIN.end_epoch = min(cfg.TRAIN.end_epoch, 2)
        cfg.TRAIN.steps_per_epoch = 4
        cfg.TRAIN.batch_size = min(cfg.TRAIN.batch_size, 8)
        cfg.TEST.batch_size = min(cfg.TEST.batch_size, 8)
        cfg.DATASET.synthetic_samples = 64

    dirs = ensure_output_dirs(cfg, tag=args.tag)
    print(f"[pmce-tpu-torch] device={describe(device)} out={dirs['output']}")

    art = ensure_cached_artifacts()
    coarse = ensure_cached_coarsening()
    train_list = build_train_datasets(cfg, art, device)
    test_ds = build_test_dataset(cfg, art, device)
    main_ds = train_list[0]
    model = build_model(cfg, main_ds, art, coarse, device, cfg.TRAIN.seed)
    eval_root, eval_joints = eval_protocol(cfg, test_ds)
    logger = MetricLogger(out_dir=dirs["output"], use_wandb=cfg.TRAIN.wandb,
                          run_name=args.tag)
    trainer = Trainer(
        cfg=cfg, model=model,
        train_data=MultiDataset(train_list, seed=args.seed),
        test_data=test_ds, faces=art.faces,
        J_reg_target=target_joint_regressor(cfg, main_ds),
        ckpt_dir=dirs["checkpoint"], device=device,
        eval_root_idx=eval_root, eval_joints=eval_joints,
        metric_logger=logger)

    state = None
    if args.resume:
        state, last_epoch = trainer.restore(args.resume)
        print(f"resumed from epoch {last_epoch}")
        cfg.TRAIN.begin_epoch = last_epoch + 1
    elif (cfg.MODEL.name == "PMCE" and cfg.MODEL.posenet_pretrained
            and cfg.MODEL.posenet_path):
        # Stage-2 warm start from Stage-1 weights (reference
        # PoseEstimation.py:68-74).
        load_lifter_checkpoint(trainer.model, cfg.MODEL.posenet_path)
        print(f"loaded Stage-1 weights from {cfg.MODEL.posenet_path}")

    trainer.fit(state)
    print("Final protocol evaluation:")
    result = trainer.full_evaluate()
    logger.close()
    print(f"Training finished; checkpoints in {dirs['checkpoint']}")
    return result


if __name__ == "__main__":
    main()
