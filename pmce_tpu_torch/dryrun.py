"""The port's multi-device dry run: one data-parallel training step of the
flagship PMCE, under DDP and then under FSDP, over N gloo processes on the
CPU.

Counterpart of ``dryrun_multichip`` in ``__graft_entry__.py``: flagship
shapes (``create_pmce(num_joint=19)``, embed 256, depth 3, 431 coarse
tokens, 6890 vertices, 103.1 M parameters), global batch N (one clip a
rank), weights from seed 0, one step each way. Rank 0 prints one line a
way; the two losses are equal, as the two ways compute the same step.

    python -m pmce_tpu_torch.dryrun N

Each process holds about 2 GB at these shapes.
"""

from __future__ import annotations

import multiprocessing
import os
import socket
import sys
import time

import numpy as np
import torch

TIMEOUT_S = 1800.0


def _rank(rank: int, n: int, port: int, art, coarse) -> None:
    """One rank: build, place and step the flagship model both ways."""
    from pmce_tpu_torch.core.config import Config
    from pmce_tpu_torch.core.trainer import Trainer
    from pmce_tpu_torch.data.clip_dataset import ClipDataset, MultiDataset
    from pmce_tpu_torch.data.synthetic import generate_sequences
    from pmce_tpu_torch.models.pmce import create_pmce
    from pmce_tpu_torch.parallel.distributed import initialize, local_rows
    from pmce_tpu_torch.parallel.mesh import create_mesh

    torch.set_num_threads(max(1, (os.cpu_count() or n) // n))
    initialize(f"tcp://localhost:{port}", n, rank, device="cpu")
    mesh = create_mesh(n, "cpu")
    rng = np.random.default_rng(0)
    jr = rng.random((19, art.num_verts)).astype(np.float32)
    jr /= jr.sum(1, keepdims=True)
    data = generate_sequences(art, jr, num_videos=1, frames_per_video=32,
                              seed=0, device="cpu")
    ds = ClipDataset(data, seqlen=16, stride=1)
    cfg = Config()
    cfg.MODEL.name = "PMCE"
    cfg.TRAIN.batch_size = n           # one clip a rank
    cfg.TRAIN.steps_per_epoch = cfg.TRAIN.end_epoch = 1
    for fsdp in (False, True):
        cfg.TRAIN.fsdp = fsdp
        model, _ = create_pmce(num_joint=19, art=art, coarsening=coarse,
                               device="cpu", seed=0)
        trainer = Trainer(cfg=cfg, model=model,
                          train_data=MultiDataset([ds], seed=0),
                          test_data=None, faces=art.faces, J_reg_target=jr,
                          device="cpu", mesh=mesh)
        state = trainer.init_state()
        n_params = sum(p.numel() for p in model.parameters())
        batch = trainer._wire_cast(local_rows(
            trainer.train_data.sample_batch(cfg.TRAIN.batch_size)))
        loss, _ = trainer.train_step(state, batch, trainer.draw_generator(1),
                                     0.0)
        loss = float(trainer._rank_sum(loss)) / n
        if rank == 0:
            print(f"dryrun_multichip({n}): flagship ({n_params / 1e6:.1f}M "
                  f"params, {art.num_verts} verts, "
                  f"fsdp={'on' if fsdp else 'off'}) one sharded train step "
                  f"OK, loss={loss:.4f}", flush=True)
        del trainer, state, model
    torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int) -> None:
    """Run the dry run over ``n_devices`` gloo processes on the CPU; raises
    if a rank fails or the run outlasts ``TIMEOUT_S``."""
    from pmce_tpu_torch.smpl.artifacts import load_or_synthetic as body
    from pmce_tpu_torch.smpl.mesh import load_or_synthetic as coarsening

    art, coarse = body(), coarsening()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, n_devices, port, art, coarse))
             for r in range(n_devices)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"dryrun_multichip({n_devices}): ranks {failed} "
                           f"failed (exit codes "
                           f"{[procs[r].exitcode for r in failed]})")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
