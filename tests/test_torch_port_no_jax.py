"""The port runs where jax is not installed (the GPU machine has none).

A fresh interpreter with ``jax`` and ``flax`` made unimportable imports
every module of ``pmce_tpu_torch`` (the CLIs of ``pmce_tpu_torch.main``
among them, whose import runs nothing; ``parallel``, ``dryrun`` and
``utils.profiler`` by name too) and ``bench_torch.py``, runs a tiny
f32 forward on the CPU, and runs the decoder's attention-block wrappers
(``fused_mhsa``, ``ada_block``, ``ca_block``) forward and backward, and
runs the demo's pieces: the native renderer and tracker (built with g++),
the crop, a small ResNet and ViTPose.
"""

from __future__ import annotations

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    sys.modules["jax"] = None
    sys.modules["flax"] = None
    import numpy as np
    import torch
    import pmce_tpu_torch
    for m in pkgutil.walk_packages(pmce_tpu_torch.__path__, "pmce_tpu_torch."):
        importlib.import_module(m.name)
    import bench_torch
    from pmce_tpu_torch import dryrun, parallel
    from pmce_tpu_torch.utils import profiler
    assert callable(dryrun.dryrun_multichip) and callable(parallel.initialize)
    assert callable(profiler.trace)
    assert {"pmce_tpu_torch.parallel.mesh", "pmce_tpu_torch.parallel.prefetch",
            "pmce_tpu_torch.parallel.distributed"} <= set(sys.modules)
    from pmce_tpu_torch.main import test, train
    assert callable(train.main) and callable(test.main)
    assert callable(bench_torch.serving_rate)
    from pmce_tpu_torch.models.pmce import create_pmce
    from pmce_tpu_torch.smpl.artifacts import synthetic_artifacts
    from pmce_tpu_torch.smpl.mesh import synthetic_coarsening
    art = synthetic_artifacts(0, 600, 1200)
    coarse = synthetic_coarsening(0, (600, 150, 40))
    model, assets = create_pmce(17, art, coarse, embed_dim=32, depth=1,
                                device="cpu", seed=0)
    rng = np.random.default_rng(0)
    pose2d = torch.from_numpy(rng.standard_normal((2, 16, 17, 2),
                                                  dtype=np.float32))
    feat = torch.from_numpy(rng.standard_normal((2, 16, 2048),
                                                dtype=np.float32))
    with torch.no_grad():
        mesh, evo, pose3d = model(pose2d, feat)
    assert mesh.shape == (2, 600, 3) and evo.shape == (2, 17, 3)
    assert pose3d.shape == (2, 17, 3)
    assert all(bool(torch.isfinite(t).all()) for t in (mesh, evo, pose3d))
    from pmce_tpu_torch.ops import fused_attention as fa
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.randn(*s, generator=g).requires_grad_(True)

    C, H = 32, 2
    mlp = (r(C, 64), r(64), r(64, C), r(C))
    attn = (r(C, 3 * C), r(3 * C), r(C, C), r(C))
    proj = tuple(t for _ in range(4) for t in (r(C, C), r(C)))
    outs = (fa.fused_mhsa(r(2, 5, C), *attn, H),
            fa.ada_block(r(2, 70, C), r(2, C), r(2, C), r(2, C), r(2, C),
                         attn + mlp, H),
            fa.ca_block(r(2, 70, C), r(2, 5, C), r(2, 5, C),
                        tuple(r(2, C) for _ in range(4)),
                        tuple(r(2, C) for _ in range(4)), proj + mlp, H))
    sum(o.sum() for o in outs).backward()
    assert all(t.grad is not None for t in attn + mlp + proj)
    from pmce_tpu_torch.demo.preprocess import crop_resize_normalize
    from pmce_tpu_torch.demo.renderer import Renderer
    from pmce_tpu_torch.demo.tracker import track_video
    from pmce_tpu_torch.main import run_demo
    from pmce_tpu_torch.models.spin import ResNet50
    from pmce_tpu_torch.models.vitpose import ViTPose, ViTPoseConfig
    assert callable(run_demo.main)
    frames = np.full((2, 48, 64, 3), 30, np.uint8)
    img = Renderer(art.faces, (64, 48)).render(
        frames[0], art.v_template, np.array([0.8, 0.8, 0.0, 0.0]))
    assert (img != 30).any()
    tracks = track_video([np.array([[5.0, 5, 20, 30]])] * 3, min_frames=2)
    assert len(tracks) == 1
    crops = crop_resize_normalize(torch.from_numpy(frames),
                                  torch.tensor([[0.0, 0, 48, 48]] * 2), 64)
    with torch.no_grad():
        assert ResNet50(layers=(1, 1, 1, 1), width=8).eval()(
            crops).shape == (2, 256)
        vp = ViTPose(ViTPoseConfig(img_size=(64, 48), embed_dim=32, depth=1,
                                   num_heads=2, deconv_channels=8)).eval()
        assert vp(crops[:, :, :, :48]).shape == (2, 17, 16, 12)
    assert not any(k == "pmce_tpu" or k.startswith("pmce_tpu.")
                   for k in sys.modules)
    print("OK")
""")


def test_port_imports_and_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")


def test_port_sources_never_import_jax():
    """No module of the package, nor chip_smoke.py or bench_torch.py,
    imports jax, flax or the JAX package (checked on the import statements
    themselves), and no C++ or CUDA source of the package includes a file
    of the JAX package. The git-ignored build directory holds no source of
    the package."""
    files = [p for p in (REPO / "pmce_tpu_torch").rglob("*.py")
             if "_build" not in p.relative_to(REPO).parts]
    files += [REPO / "chip_smoke.py", REPO / "bench_torch.py"]
    assert REPO / "pmce_tpu_torch" / "main" / "train.py" in files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "flax", "pmce_tpu"), (path, name)
    for path in (REPO / "pmce_tpu_torch").rglob("*"):
        if path.suffix in (".cc", ".cu", ".cuh", ".h") and \
                "_build" not in path.relative_to(REPO).parts:
            for line in path.read_text().splitlines():
                if line.lstrip().startswith("#include"):
                    assert "pmce_tpu/" not in line, (path, line)
