"""Evaluation CLI of the port.

    python -m pmce_tpu_torch.main.test --cfg configs/test_mesh_3dpw.yml \
        --weights experiment/run/checkpoint

Port of ``main/test.py`` (the reference's ``main/test.py``): loads a
checkpoint the port's trainer wrote (a file, or a directory: best, then
final, then the latest epoch; the JAX package's msgpack files are not
read) and runs the test dataset's full protocol evaluation on the card:
MPJPE / PA-MPJPE / MPVPE / ACCEL, per action on Human3.6M. ``--vis DIR``
writes every 500th predicted mesh there as an OBJ; ``--device cpu`` runs on
the host (for tests).
"""

from __future__ import annotations

import argparse

from pmce_tpu_torch.core import checkpoint as ckpt_lib
from pmce_tpu_torch.core.config import load_config
from pmce_tpu_torch.core.trainer import Trainer
from pmce_tpu_torch.data.clip_dataset import MultiDataset
from pmce_tpu_torch.data.factory import (
    build_test_dataset,
    target_joint_regressor,
)
from pmce_tpu_torch.main.common import (
    build_model,
    describe,
    eval_protocol,
    resolve_device,
)
from pmce_tpu_torch.smpl.artifacts import ensure_cached_artifacts
from pmce_tpu_torch.smpl.mesh import ensure_cached_coarsening


def main(argv: list | None = None):
    """Run the CLI on ``argv`` (default: the command line); returns the
    protocol evaluation's result."""
    p = argparse.ArgumentParser(description="Evaluate pmce-tpu models "
                                            "(PyTorch)")
    p.add_argument("--cfg", type=str, required=True)
    p.add_argument("--weights", type=str, default="",
                   help="checkpoint path (overrides TEST.weight_path)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: the card; cpu for tests)")
    p.add_argument("--vis", type=str, default="",
                   help="dump every 500th predicted mesh as OBJ here")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = load_config(args.cfg)
    print(f"[pmce-tpu-torch] device={describe(device)}")
    art = ensure_cached_artifacts()
    coarse = ensure_cached_coarsening()
    test_ds = build_test_dataset(cfg, art, device)
    model = build_model(cfg, test_ds, art, coarse, device, seed=0)
    eval_root, eval_joints = eval_protocol(cfg, test_ds)
    trainer = Trainer(cfg=cfg, model=model,
                      train_data=MultiDataset([test_ds], seed=0),
                      test_data=test_ds, faces=art.faces,
                      J_reg_target=target_joint_regressor(cfg, test_ds),
                      device=device, eval_root_idx=eval_root,
                      eval_joints=eval_joints)

    weight_path = args.weights or cfg.TEST.weight_path
    if weight_path:
        loaded = ckpt_lib.load_checkpoint(weight_path)
        model.load_state_dict(loaded["params"])
        print(f"loaded weights from {weight_path} "
              f"(epoch {loaded.get('epoch')})")
    else:
        print("WARNING: no weights given — evaluating a random init")
    return trainer.full_evaluate(vis_dir=args.vis)


if __name__ == "__main__":
    main()
