"""The port runs where jax is not installed (the GPU machine has none).

A fresh interpreter with ``jax`` and ``flax`` made unimportable imports
every module of ``pmce_tpu_torch`` and runs a tiny f32 forward on the CPU.
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
    """No module of the package, nor chip_smoke.py, imports jax, flax or
    the JAX package (checked on the import statements themselves). The
    git-ignored build directory holds no source of the package."""
    files = [p for p in (REPO / "pmce_tpu_torch").rglob("*.py")
             if "_build" not in p.relative_to(REPO).parts]
    files.append(REPO / "chip_smoke.py")
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
