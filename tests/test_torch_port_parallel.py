"""Data parallelism and FSDP in the port (``pmce_tpu_torch/parallel``), on
the CPU.

- ``initialize`` without torchrun's environment or arguments is a no-op
  that touches no CUDA state;
- ``host_local_slice`` equals the JAX package's for uneven splits (JAX's
  process count and index monkeypatched, as ``tests/test_distributed.py``
  does);
- ``local_rows`` keeps rank r's rows ``[r·B/n, (r+1)·B/n)`` and refuses a
  batch that does not divide;
- ``prefetch_to_device`` on the CPU: every batch, in order, as tensors in
  the wire format (bf16 image features under the bf16 policy);
- the global-batch stochastic depth (``RankDraw``): N ranks' rows of every
  mask together equal one process's masks, at world size 1 bit for bit;
- ``fsdp_units`` of a full-width PMCE built on ``meta``: the units are
  disjoint and every parameter lies in one of them or in the root;
- two gloo ranks (a small f32 lifter and PMCE on the kernel wrappers'
  plain routes): under DDP and under FSDP the first step's loss (within
  1e-6 relative) and every gradient after the reduction (within 1e-5 of
  the largest) equal one process's on the global batch, and so do the
  evaluation's errors and records; the parameters without a gradient are
  the same; a rank checkpoint restores into a one-process trainer (its
  next loss within 1e-6 relative, its Adam state within the gradient
  bound), and a one-process checkpoint into the ranks, bit for bit; a
  DTensor never passes a kernel's pointer check;
- the train CLI under two gloo ranks with ``TRAIN.fsdp: true`` (torchrun's
  variables set by hand) trains, evaluates and writes its checkpoints.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pmce_tpu.parallel import distributed as jax_dist
from pmce_tpu_torch.models.layers import DropPath, RankDraw
from pmce_tpu_torch.parallel import distributed as dist_lib
from pmce_tpu_torch.parallel.mesh import fsdp_units
from pmce_tpu_torch.parallel.prefetch import prefetch_to_device

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))
import torch_port_parallel_worker as worker  # noqa: E402

LOSS_REL_TOL = 1e-6
GRAD_REL_TOL = 1e-5
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


def test_initialize_without_environment_is_a_no_op(monkeypatch):
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert dist_lib.initialize() is False
    assert dist_lib.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert not torch.cuda.is_initialized()
    assert (dist_lib.process_count(), dist_lib.process_index()) == (1, 0)


@pytest.mark.parametrize("n,total", [(3, 100), (8, 35), (4, 4), (5, 3)])
def test_host_local_slice_matches_jax(monkeypatch, n, total):
    monkeypatch.setattr(jax_dist.jax, "process_count", lambda: n)
    monkeypatch.setattr(dist_lib, "process_count", lambda: n)
    rows = []
    for i in range(n):
        monkeypatch.setattr(jax_dist.jax, "process_index", lambda i=i: i)
        monkeypatch.setattr(dist_lib, "process_index", lambda i=i: i)
        s = dist_lib.host_local_slice(total)
        assert s == jax_dist.host_local_slice(total)
        rows.extend(range(s.start, s.stop))
    assert rows == list(range(total))


def test_local_rows_of_a_global_batch(monkeypatch):
    batch = {"x": np.arange(24.0).reshape(8, 3),
             "w": torch.arange(8.0)}
    assert dist_lib.local_rows(batch) is batch
    monkeypatch.setattr(dist_lib, "process_count", lambda: 4)
    parts = []
    for i in range(4):
        monkeypatch.setattr(dist_lib, "process_index", lambda i=i: i)
        part = dist_lib.local_rows(batch)
        np.testing.assert_array_equal(part["x"], batch["x"][2 * i:2 * i + 2])
        assert torch.equal(part["w"], batch["w"][2 * i:2 * i + 2])
        parts.append(part["x"])
    np.testing.assert_array_equal(np.concatenate(parts), batch["x"])
    with pytest.raises(ValueError, match="does not divide"):
        dist_lib.local_rows({"x": np.zeros((6, 1))})


def test_prefetch_to_device_on_the_cpu_keeps_order_and_values():
    rng = np.random.default_rng(0)
    batches = [{"pose2d": rng.standard_normal((2, 3), dtype=np.float32),
                "img_feature": rng.standard_normal((2, 4), dtype=np.float32)}
               for _ in range(5)]
    got = list(prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert len(got) == 5
    for b, g in zip(batches, got):
        for k in b:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), b[k])
    wire = list(prefetch_to_device(iter(batches[:2]), device="cpu",
                                   bf16_features=True))
    assert wire[1]["img_feature"].dtype == torch.bfloat16
    assert wire[1]["pose2d"].dtype == torch.float32
    assert torch.equal(wire[1]["img_feature"], torch.from_numpy(
        batches[1]["img_feature"]).to(torch.bfloat16))


def _draws(gen_of, rows: int, calls: int = 4):
    dp = DropPath(0.2).train()
    g = gen_of()
    return [dp.mask(rows, "cpu", g) for _ in range(calls)]


@pytest.mark.parametrize("world", [2, 4])
def test_rank_draws_together_equal_one_process(world):
    """Each rank draws the global batch's masks and keeps its rows: the
    ranks' rows side by side are one process's masks, call after call (a
    mask's rows may be clips × frames, clip-major)."""
    rows = 6 * world
    whole = _draws(lambda: torch.Generator().manual_seed(3), rows)
    parts = [_draws(lambda r=r: RankDraw(torch.Generator().manual_seed(3),
                                         r, world), rows // world)
             for r in range(world)]
    for c, want in enumerate(whole):
        assert torch.equal(torch.cat([p[c] for p in parts]), want)
    assert any(bool((m == 0).any()) for m in whole)


def test_rank_draw_at_world_size_one_is_bit_identical():
    plain = _draws(lambda: torch.Generator().manual_seed(5), 7)
    one = _draws(lambda: RankDraw(torch.Generator().manual_seed(5), 0, 1), 7)
    assert all(torch.equal(a, b) for a, b in zip(plain, one))
    assert DropPath(0.2).eval().mask(7, "cpu", RankDraw(None, 0, 2)) is None


def test_fsdp_units_cover_a_full_width_pmce():
    from pmce_tpu_torch.models.pmce import PMCE

    with torch.device("meta"):
        model = PMCE(num_joint=19, vj_relation=tuple(range(19)) * 22 + (0,),
                     num_vertx=431, num_verts_full=6890)
    units = fsdp_units(model)
    assert len(units) == 2 * 3 + 3 + 1
    owned = [{id(p) for p in u.parameters()} for u in units]
    assert sum(map(len, owned)) == len(set().union(*owned))    # disjoint
    in_units = set().union(*owned)
    root = [n for n, p in model.named_parameters() if id(p) not in in_units]
    every = {id(p) for p in model.parameters()}
    assert in_units <= every
    # The root keeps the embeds, the heads, the upsample and the norms.
    assert all(not n.startswith(("pose_lifter.SpatialBlocks",
                                 "pose_lifter.TemporalBlocks",
                                 "pose_mesh_coevo.coevoblock",
                                 "pose_mesh_coevo.gru_cur")) for n in root)
    n_params = sum(p.numel() for p in model.parameters())
    assert abs(n_params / 1e6 - 103.1) < 0.1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ)
    for k in TORCHRUN_ENV:
        env.pop(k, None)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    return env


def _run_ranks(argvs: list, timeout: int, env=None) -> list:
    procs = [subprocess.Popen(a, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=REPO,
                              env=env or _env()) for a in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("ranks timed out:\n" + "\n".join(o or "" for o in outs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out[-4000:]}"
    return outs


def _grad_close(got: dict, want: dict, what: str) -> None:
    assert {n for n, g in got.items() if g is None} == {
        n for n, g in want.items() if g is None}, what
    largest = max(float(g.abs().max()) for g in want.values()
                  if g is not None)
    worst = max(float((got[n] - g).abs().max())
                for n, g in want.items() if g is not None)
    assert worst <= GRAD_REL_TOL * largest, (what, worst, largest)


def _lists(x):
    if isinstance(x, (list, tuple)):
        return [_lists(v) for v in x]
    if isinstance(x, dict):
        return {k: _lists(v) for k, v in x.items()}
    return x


def _loss_close(got: float, want: float, what: str) -> None:
    assert abs(got - want) <= LOSS_REL_TOL * abs(want), (what, got, want)


@pytest.mark.parametrize("kind", ["lifter", "pmce"])
def test_two_gloo_ranks_equal_one_process(kind, tmp_path):
    from pmce_tpu_torch.core import checkpoint as ckpt_lib

    data = worker.body()
    ref = worker.run_case(kind, data, tmp_path)
    port = _free_port()
    _run_ranks([[sys.executable, str(REPO / "tests" /
                                     "torch_port_parallel_worker.py"),
                 kind, f"tcp://localhost:{port}", str(r), "2",
                 str(tmp_path)] for r in range(2)], timeout=240)
    ranks = torch.load(tmp_path / f"{kind}_ranks.pt", weights_only=False)
    plain_ckpt = ckpt_lib.load_checkpoint(str(tmp_path / f"{kind}_plain"))
    if kind == "pmce":
        # The joint streams of the decoder blocks that feed nothing.
        assert any(".joint_SA_FFN." in n for n in ref["dead"])
    for mode, got in ranks.items():
        what = f"{kind} {mode}"
        assert got["dead"] == ref["dead"], what
        _loss_close(got["first"]["loss"], ref["first"]["loss"], what)
        _grad_close(got["first"]["grads"], ref["first"]["grads"], what)
        for a, b in zip(got["eval"], ref["eval"]):
            assert abs(a - b) <= 1e-5 * abs(b), (what, a, b)
        assert len(got["records"]) == len(ref["records"])
        # Each rank runs half the batch: f32 products blocked otherwise.
        want_rec = np.stack(ref["records"])
        np.testing.assert_allclose(
            np.stack(got["records"]), want_rec, rtol=0,
            atol=GRAD_REL_TOL * float(np.abs(want_rec).max()), err_msg=what)
        # The one-process checkpoint in the ranks: the same state back out.
        params, opt = got["restored"]
        for n, t in plain_ckpt["params"].items():
            assert torch.equal(params[n], t), (what, n)
        for i, st in plain_ckpt["opt_state"]["state"].items():
            for k, v in st.items():
                assert torch.equal(opt["state"][i][k], v), (what, i, k)
        # (The group's betas come back a list where one device keeps a
        # tuple: Adam reads them the same.)
        assert _lists(opt["param_groups"]) == _lists(
            plain_ckpt["opt_state"]["param_groups"])
        _loss_close(got["restored_second"]["loss"], ref["second"]["loss"],
                    what + " restored")
        # The ranks' checkpoint in one process.
        fresh = worker.make_trainer(kind, data)
        st, epoch = fresh.restore(str(tmp_path / f"{kind}_{mode}"))
        assert epoch == 1 and st.step == 1
        for n, p in fresh.model.named_parameters():
            assert torch.equal(p.detach(), got["first"]["params"][n]), n
        want = ref_opt = torch.load(
            tmp_path / f"{kind}_plain" / "final.ckpt",
            weights_only=True)["opt_state"]
        have = st.optimizer.state_dict()
        assert sorted(have["state"]) == sorted(want["state"]), what
        largest = max(float(s["exp_avg"].abs().max())
                      for s in ref_opt["state"].values())
        for i, s in want["state"].items():
            assert torch.equal(have["state"][i]["step"], s["step"])
            err = float((have["state"][i]["exp_avg"] - s["exp_avg"]).abs()
                        .max())
            assert err <= GRAD_REL_TOL * largest, (what, i, err)
        second = worker.step(fresh, st, 2)
        _loss_close(second["loss"], got["second"]["loss"], what + " resumed")


def test_train_cli_fsdp_over_two_gloo_ranks(tmp_path):
    """``TRAIN.fsdp: true`` trains through the CLI: two ranks with
    torchrun's variables, ``--device cpu``, a small Stage-2 yml and a V =
    600 body; rank 0 alone prints the summary and writes the
    checkpoints."""
    from pmce_tpu_torch.smpl.artifacts import synthetic_artifacts
    from pmce_tpu_torch.smpl.mesh import synthetic_coarsening

    data_dir = tmp_path / "base_data"
    data_dir.mkdir()
    synthetic_artifacts(0, 600, 1200).save(str(data_dir / "smpl_neutral.npz"))
    synthetic_coarsening(0, (600, 150, 40)).save(
        str(data_dir / "mesh_coarsening.npz"))
    text = (REPO / "configs" / "train_mesh_h36m_bf16.yml").read_text()
    text = text.replace("hpe_dim: 256", "hpe_dim: 32").replace(
        "hpe_dep: 3", "hpe_dep: 1").replace("fsdp: false", "fsdp: true")
    if "fsdp: true" not in text:
        text = text.replace("TRAIN:\n", "TRAIN:\n  fsdp: true\n", 1)
    text = text.replace("posenet_pretrained: true",
                        "posenet_pretrained: false")
    cfg = tmp_path / "mesh_fsdp.yml"
    cfg.write_text(text)
    port = _free_port()
    argvs, envs = [], []
    for r in range(2):
        env = _env()
        env.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   PMCE_TPU_DATA_DIR=str(data_dir))
        envs.append(env)
        argvs.append([sys.executable, "-m", "pmce_tpu_torch.main.train",
                      "--cfg", str(cfg), "--smoke", "--device", "cpu",
                      "--tag", "fsdp2"])
    procs = [subprocess.Popen(a, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              cwd=tmp_path, env=e)
             for a, e in zip(argvs, envs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("CLI ranks timed out:\n" + "\n".join(outs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i}:\n{out[-4000:]}"
    assert "data-parallel over 2 ranks, FSDP" in outs[0]
    assert "Training finished" in outs[0] and "MPJPE" in outs[0]
    assert "Epoch" not in outs[1] and "Training finished" not in outs[1]
    ckpts = sorted(os.listdir(tmp_path / "experiment" / "fsdp2" /
                              "checkpoint"))
    assert "final.ckpt" in ckpts and "best.ckpt" in ckpts
