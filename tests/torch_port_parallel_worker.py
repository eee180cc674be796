"""The data-parallel cases of ``test_torch_port_parallel.py``, shared by
its one-process reference and its gloo ranks (run as a script, one
process a rank). Imports torch and numpy only.

A small lifter or PMCE (embed 64, depth 2, a 600-vertex stand-in coarsened
to 40 tokens, GRU hidden 64), f32, ``fused`` (the kernel wrappers' plain
routes on the CPU), global batch 4. :func:`run_case` takes the first step
on a fixed batch, evaluates, checkpoints, takes the second step, and
restores the one-process run's checkpoint into a fresh trainer for its
second step.

    python tests/torch_port_parallel_worker.py KIND INIT_METHOD RANK WORLD OUT
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import numpy as np
import torch

from pmce_tpu_torch.core.config import Config
from pmce_tpu_torch.core.trainer import Trainer
from pmce_tpu_torch.data.clip_dataset import ClipDataset, MultiDataset
from pmce_tpu_torch.data.synthetic import generate_sequences
from pmce_tpu_torch.models.pmce import PMCE
from pmce_tpu_torch.models.pose_lifter import create_pose_lifter
from pmce_tpu_torch.parallel.distributed import local_rows
from pmce_tpu_torch.parallel.mesh import full_state
from pmce_tpu_torch.smpl.artifacts import synthetic_artifacts

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_port_init import perturbed_init  # noqa: E402

T, J, V, NV, B = 16, 17, 600, 40, 4
VJ = tuple(i % J for i in range(NV))


def body():
    """The body, its regressor and two 32-frame sequences (33 Stage-2
    clips, 34 Stage-1 clips)."""
    art = synthetic_artifacts(seed=0, num_verts=V, num_faces=1200)
    rng = np.random.default_rng(0)
    jr = rng.random((J, V)).astype(np.float32)
    jr /= jr.sum(1, keepdims=True)
    seqs = generate_sequences(art, jr, num_videos=2, frames_per_video=32,
                              seed=0, device="cpu")
    return art, jr, seqs


def make_trainer(kind: str, data, mesh=None, fsdp: bool = False,
                 ckpt_dir: str = "", device="cpu", dtype=None,
                 embed: int = 64) -> Trainer:
    """The case's trainer; ``device``, ``dtype`` and ``embed`` as the card
    test sets them (bf16: the kernels' policy; embed 256: the lifter
    block kernel's width)."""
    art, jr, seqs = data
    cfg = Config()
    cfg.MODEL.name = "PMCE" if kind == "pmce" else "PoseEst"
    cfg.TRAIN.lr, cfg.TRAIN.fsdp = 1e-3, fsdp
    cfg.TRAIN.batch_size = cfg.TEST.batch_size = B
    cfg.TRAIN.steps_per_epoch, cfg.TRAIN.end_epoch = 1, 1
    if kind == "pmce":
        model = PMCE(num_joint=J, embed_dim=embed, depth=2, vj_relation=VJ,
                     num_vertx=NV, num_verts_full=V, gru_hidden=64,
                     seqlen=T, dtype=dtype, fused=True)
        perturbed_init(model, torch.Generator().manual_seed(0))
    else:
        model = create_pose_lifter(num_joints=J, embed_dim=embed, depth=2,
                                   dtype=dtype, fused=True, device="cpu",
                                   seed=0)
    ds = ClipDataset(seqs, seqlen=T, stride=1,
                     chunk_mode="mesh" if kind == "pmce" else "pose")
    return Trainer(cfg=cfg, model=model.train(),
                   train_data=MultiDataset([ds], seed=0), test_data=ds,
                   faces=art.faces, J_reg_target=jr, ckpt_dir=ckpt_dir,
                   device=device, log_fn=lambda s: None, mesh=mesh)


def full(t):
    """A parameter or gradient as a plain tensor (gathered if sharded)."""
    if t is None:
        return None
    t = t.detach()
    return t.full_tensor() if hasattr(t, "full_tensor") else t.clone()


def step(trainer: Trainer, state, epoch: int) -> dict:
    """One train step on the fixed global batch with ``epoch``'s draws:
    the loss (the mean over the ranks), every gradient after the
    reduction and every parameter after the update, gathered."""
    batch = trainer.test_data.get_batch(np.arange(B))
    if trainer.mesh is not None:
        batch = local_rows(batch)
    gen = trainer.draw_generator(epoch)
    args = (state, trainer._wire_cast(batch), gen)
    out = trainer.train_step(*args, 1.0) if trainer.is_mesh_model else \
        trainer.train_step(*args)
    loss = out[0] if isinstance(out, tuple) else out
    loss = float(trainer._rank_sum(loss)) / (
        torch.distributed.get_world_size() if trainer.mesh else 1)
    named = list(trainer.model.named_parameters())
    return {"loss": loss, "grads": {n: full(p.grad) for n, p in named},
            "params": {n: full(p) for n, p in named}}


def run_case(kind: str, data, out: Path, mesh=None, mode: str = "plain"):
    """The case on this process (``mesh`` None: the one-process
    reference); returns what rank 0 keeps."""
    fsdp = mode == "fsdp"
    tr = make_trainer(kind, data, mesh, fsdp, str(out / f"{kind}_{mode}"))
    st = tr.init_state()
    first = step(tr, st, 1)
    joint, surface, records = tr.evaluate(collect=True)
    tr.save(st, 1, False)
    second = step(tr, st, 2)
    res = {"first": first, "second": second, "eval": (joint, surface),
           "records": [r["joint_coord"] for r in records],
           "dead": sorted(n for n, g in first["grads"].items() if g is None)}
    if mesh is not None:
        # The one-process checkpoint into this world, and back out.
        fresh = make_trainer(kind, data, mesh, fsdp)
        st2, epoch = fresh.restore(str(out / f"{kind}_plain"))
        # A copy: on the CPU the full state may share the parameters'
        # storage, which the next step updates.
        res["restored"] = copy.deepcopy(full_state(fresh.model, st2.optimizer))
        res["restored_second"] = step(fresh, st2, 2)
    return res


def main(argv: list) -> None:
    kind, init_method, rank, world, out = argv
    from pmce_tpu_torch.ops import _cuda
    from pmce_tpu_torch.parallel.distributed import initialize
    from pmce_tpu_torch.parallel.mesh import create_mesh

    assert initialize(init_method, int(world), int(rank), device="cpu")
    assert initialize(init_method, int(world), int(rank), device="cpu")
    mesh = create_mesh(device_type="cpu")
    data = body()
    out = Path(out)
    res = {mode: run_case(kind, data, out, mesh, mode)
           for mode in ("ddp", "fsdp")}
    # A sharded parameter never reaches a kernel's pointer table.
    tr = make_trainer(kind, data, mesh, fsdp=True)
    tr.init_state()
    w = next(tr.model.parameters())
    for check in (lambda: _cuda.check_cuda(w, "w", w.dtype),
                  lambda: _cuda.to_kernel(w, "cpu", w.dtype, w.shape, "w")):
        try:
            check()
        except ValueError as e:
            assert "DTensor" in str(e), e
        else:
            raise AssertionError("a DTensor passed a kernel check")
    if int(rank) == 0:
        torch.save(res, out / f"{kind}_ranks.pt")
    torch.distributed.destroy_process_group()
    print(f"WORKER_OK {rank}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
