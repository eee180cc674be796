"""Queue A1's leftovers in the port against the JAX package, on the CPU.

- ``smpl.artifacts.load_or_synthetic`` and ``smpl.mesh.load_or_synthetic``
  bit for bit against JAX's, on a missing file (the stand-in, seed +
  {neutral 0, female 1, male 2} for the body; no cache written) and on a
  present one (``PMCE_TPU_DATA_DIR`` pointing at a temporary directory;
  the stand-ins drawn at 600 vertices through a monkeypatched generator on
  both sides);
- ``smpl.mesh.upsample`` against JAX's (f32, within 1e-6, numpy and torch
  inputs);
- ``utils.obj_io.load_obj`` reads back ``save_obj``'s file, and reads a
  file the JAX package wrote as JAX's reader does;
- ``utils.profiler``: ``StepTimer``'s summary keys and warm-up exclusion,
  and ``trace`` writing a trace file on the CPU;
- the flagship dry run over two gloo processes (``slow``, as JAX's
  multi-process test): two lines, DDP and FSDP, with equal losses.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pmce_tpu.smpl import artifacts as jax_art
from pmce_tpu.smpl import mesh as jax_mesh
from pmce_tpu.utils import obj_io as jax_obj
from pmce_tpu.utils import profiler as jax_profiler
from pmce_tpu_torch.smpl import artifacts as port_art
from pmce_tpu_torch.smpl import mesh as port_mesh
from pmce_tpu_torch.utils import obj_io, profiler

REPO = Path(__file__).resolve().parent.parent
LEVELS = (600, 150, 40)


def _same_artifacts(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and np.array_equal(x, y), f.name


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("PMCE_TPU_DATA_DIR", str(tmp_path))
    for mod in (port_art, jax_art):
        monkeypatch.setattr(mod, "synthetic_artifacts", functools.partial(
            mod.synthetic_artifacts, num_verts=600, num_faces=1200))
    for mod in (port_mesh, jax_mesh):
        monkeypatch.setattr(mod, "synthetic_coarsening", functools.partial(
            mod.synthetic_coarsening, sizes=LEVELS))
    return tmp_path


@pytest.mark.parametrize("gender", ["neutral", "female", "male"])
def test_artifacts_load_or_synthetic_missing_file(data_dir, gender):
    got = port_art.load_or_synthetic(gender, seed=3)
    _same_artifacts(jax_art.load_or_synthetic(gender, seed=3), got)
    assert got.num_verts == 600
    assert list(data_dir.iterdir()) == []          # no cache written
    if gender != "neutral":
        assert not np.array_equal(
            got.v_template, port_art.load_or_synthetic("neutral", 3)
            .v_template)


def test_artifacts_load_or_synthetic_present_file(data_dir):
    saved = jax_art.synthetic_artifacts(seed=9)
    saved.save(str(data_dir / "smpl_female.npz"))
    got = port_art.load_or_synthetic("female")
    _same_artifacts(jax_art.load_or_synthetic("female"), got)
    _same_artifacts(saved, got)


def test_mesh_load_or_synthetic_missing_and_present(data_dir):
    for present in (False, True):
        if present:
            jax_mesh.synthetic_coarsening(seed=4).save(
                str(data_dir / "mesh_coarsening.npz"))
        else:
            assert list(data_dir.iterdir()) == []
        a = jax_mesh.load_or_synthetic(seed=1)
        b = port_mesh.load_or_synthetic(seed=1)
        assert a.sizes == b.sizes == LEVELS
        for x, y in zip(a.D + a.U, b.D + b.U):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        if not present:
            assert list(data_dir.iterdir()) == []


@pytest.mark.parametrize("n1,n2", [(1, 0), (2, 0), (2, 1)])
def test_upsample_matches_jax(n1, n2):
    coarse = port_mesh.synthetic_coarsening(0, LEVELS)
    rng = np.random.default_rng(n1 * 10 + n2)
    x = rng.normal(size=(2, LEVELS[n1], 3)).astype(np.float32)
    want = np.asarray(jax_mesh.upsample(coarse, x, n1, n2))
    got = port_mesh.upsample(coarse, x, n1, n2)
    assert got.shape == (2, LEVELS[n2], 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    got_t = port_mesh.upsample(coarse, torch.from_numpy(x), n1, n2)
    assert got_t.dtype == torch.float32
    np.testing.assert_allclose(got_t.numpy(), want, rtol=0, atol=1e-6)


def test_load_obj_round_trip_and_jax_file(tmp_path):
    rng = np.random.default_rng(0)
    verts = rng.normal(size=(30, 3)).astype(np.float32)
    faces = rng.integers(0, 30, size=(20, 3)).astype(np.int32)
    obj_io.save_obj(verts, faces, str(tmp_path / "port.obj"))
    v, f = obj_io.load_obj(str(tmp_path / "port.obj"))
    assert v.dtype == np.float32 and f.dtype == np.int32
    np.testing.assert_array_equal(v, verts)
    np.testing.assert_array_equal(f, faces)
    jax_obj.save_obj(verts, faces, str(tmp_path / "jax.obj"))
    with open(tmp_path / "jax.obj", "a") as fh:
        fh.write("\nvn 0 0 1\nf 1/1/1 2/2/1 3/3/1\n")
    for a, b in zip(obj_io.load_obj(str(tmp_path / "jax.obj")),
                    jax_obj.load_obj(str(tmp_path / "jax.obj"))):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_step_timer_summary_and_warmup():
    timer = profiler.StepTimer(warmup=2)
    assert timer.summary() == {"steps": 0}
    for i in range(5):
        with timer:
            time.sleep(0.03 if i < 2 else 0.001)
    s = timer.summary()
    assert set(s) == {"steps", "mean_s", "p50_s", "p95_s"}
    assert s["steps"] == 5 and len(timer.steady_times) == 3
    assert s["mean_s"] < 0.02 < min(timer._times[:2])    # warm-up excluded
    # The same times give JAX's summary.
    theirs = jax_profiler.StepTimer(warmup=2)
    theirs._times = list(timer._times)
    assert theirs.summary() == s


def test_trace_writes_a_trace_file(tmp_path):
    with profiler.trace(str(tmp_path)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


@pytest.mark.slow
def test_dryrun_multichip_two_gloo_ranks():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "pmce_tpu_torch.dryrun",
                           "2"], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("dryrun_multichip(2): flagship (103.1M "
                              "params, 6890 verts")]
    assert len(lines) == 2 and "fsdp=off" in lines[0] \
        and "fsdp=on" in lines[1]
    assert lines[0].split("loss=")[1] == lines[1].split("loss=")[1]
