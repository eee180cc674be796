#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PMCE on one NVIDIA GPU and check it.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits nonzero):

1. card and build: the card's name and power limit (nvidia-smi), then the
   three kernel libraries built from ``pmce_tpu_torch/csrc`` with nvcc;
2. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes of the full-width B=256 serving forward, with its tolerance,
   and both timed with CUDA events (median after warm-up);
3. serving forward: ``create_pmce(num_joint=19, dtype=bfloat16, fused=True,
   device="cuda")`` at full width, random weights from a seed, B=256. The
   launch counters are zeroed just before it and read just after: every
   kernel of the path must have launched. Its outputs must be finite, of
   the expected shapes, and agree with the same model run through the plain
   versions; a small f32 input must agree with the same model on the CPU.
   Then its throughput in mid-frames/s.

The second-to-last line is one JSON object with the kernels' numbers; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the ``pmce_tpu_torch`` package beside this file, it prints no
result and exits nonzero.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
B, T, J, C = 256, 16, 19, 256

# The TPU kernel each wrapper replaces (file:line of the Pallas body).
REPLACES = {
    "lifter_trunk": "pmce_tpu/ops/fused_attention.py:3011",
    "gru_layer": "pmce_tpu/ops/fused_attention.py:2279",
    "gru_layer_rev": "pmce_tpu/ops/fused_attention.py:2279",
    "coevo_chain": "pmce_tpu/ops/fused_coevo_chain.py:118",
}
SOURCES = {
    "lifter_trunk": "pmce_tpu_torch/csrc/lifter_trunk.cu",
    "gru_layer": "pmce_tpu_torch/csrc/gru_scan.cu",
    "gru_layer_rev": "pmce_tpu_torch/csrc/gru_scan.cu",
    "coevo_chain": "pmce_tpu_torch/csrc/coevo_chain.cu",
}
# Kernel vs plain version on identical inputs, as max|kernel - plain| over
# max|plain|. Both compute f32 sums of the same bf16 operands with the same
# cast points; they differ in summation order and in exp/erf/tanh, so now
# and then an intermediate rounds to the neighbouring bf16 value and the
# difference propagates. First measured on an H100 (700 W): trunk 0.0625
# absolute (LayerNorm-scaled outputs), GRU 0.0039 (one bf16 ulp of |h| < 1),
# chain 0.11 on vertices up to ~17 (0.7 %).
TOL = {"lifter_trunk": 0.03, "gru_layer": 0.01, "gru_layer_rev": 0.01,
       "coevo_chain": 0.02}
# Serving outputs, kernel path vs plain path, relative to each output's
# largest magnitude (first measured: 0.5 %, 0.3 %, 0.7 %).
SERVE_REL_TOL = 0.02


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def median_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


class Inputs:
    """Seeded random tensors on a device (drawn on the CPU, then moved)."""

    def __init__(self, seed: int, device):
        import torch

        self.gen = torch.Generator().manual_seed(seed)
        self.device = device

    def __call__(self, *shape, scale=1.0, offset=0.0, dtype=None):
        import torch

        t = torch.randn(*shape, generator=self.gen) * scale + offset
        return t.to(device=self.device, dtype=dtype or torch.float32)


def trunk_case(r, batch: int, depth: int = 3, hid: int = 512):
    import torch

    def block():
        return (r(C, scale=0.1, offset=1.0), r(C, scale=0.1),
                r(C, 3 * C, scale=C ** -0.5), r(3 * C, scale=0.02),
                r(C, C, scale=C ** -0.5), r(C, scale=0.02),
                r(C, scale=0.1, offset=1.0), r(C, scale=0.1),
                r(C, hid, scale=C ** -0.5), r(hid, scale=0.02),
                r(hid, C, scale=hid ** -0.5), r(C, scale=0.02))

    x = r(batch, T * J, C, dtype=torch.bfloat16)
    params = tuple(block() for _ in range(2 * depth))
    norm_s = (r(C, scale=0.1, offset=1.0), r(C, scale=0.1))
    norm_t = (r(C, scale=0.1, offset=1.0), r(C, scale=0.1))
    return (x, params, norm_s, norm_t, r(T, C, scale=0.1), T, J, depth, 8)


def gru_case(r, steps: int, batch: int, H: int = 1024):
    import torch

    return (r(steps, batch, 3 * H, dtype=torch.bfloat16),
            r(H, 3 * H, scale=H ** -0.5), r(3 * H, scale=0.1))


def chain_case(r, batch: int, V: int = 431, NB: int = 3, c: int = 64):
    import torch

    bf = torch.bfloat16

    def w(i, o):
        return r(i, o, scale=i ** -0.5)

    def ca():
        return (w(c, c), r(c, scale=0.02), w(c, c), r(c, scale=0.02),
                w(c, c), r(c, scale=0.02), w(c, c), r(c, scale=0.02),
                w(c, 4 * c), r(4 * c, scale=0.02), w(4 * c, c),
                r(c, scale=0.02))

    def sa():
        return (w(c, 3 * c), r(3 * c, scale=0.02), w(c, c), r(c, scale=0.02),
                w(c, 4 * c), r(4 * c, scale=0.02), w(4 * c, c),
                r(c, scale=0.02))

    blocks = []
    for _ in range(NB):
        kp = (r(J, c), r(V, c), r(J, c), r(V, c), r(V, c), r(J, c),
              w(c, c), r(c, scale=0.02), w(c, c), r(c, scale=0.02),
              ca(), ca(), sa(), sa())
        blocks.append((w(3, c).to(bf), r(c, scale=0.02), w(3, c).to(bf),
                       r(c, scale=0.02), kp, w(c, 3), r(3, scale=0.02),
                       w(c, 3), r(3, scale=0.02)))
    return (r(batch, J, 3, scale=0.3), r(batch, V, 3, scale=0.3),
            r(batch, NB, 12, c, scale=0.1, offset=1.0),
            r(batch, NB, 12, c, scale=0.1), tuple(blocks), 8, 2)


def check_kernels(device) -> dict:
    """Phase 2: every kernel against its plain version at main-path shapes."""
    import torch

    from pmce_tpu_torch.ops import fused_attention as fa
    from pmce_tpu_torch.ops import fused_coevo_chain as fc

    r = Inputs(1, device)
    rows = {}

    def compare(name, kernel, plain, args, label):
        with torch.no_grad():
            out_k = kernel(*args)
            out_p = plain(*args)
            torch.cuda.synchronize()
            outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
            outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
            for a in outs_k:
                if not bool(torch.isfinite(a).all()):
                    raise RuntimeError(f"{name} {label}: non-finite output")
            err = max(max_err(a, b) for a, b in zip(outs_k, outs_p))
            scale = max(float(b.float().abs().max()) for b in outs_p)
            mean = max(float((a.float() - b.float()).abs().mean())
                       for a, b in zip(outs_k, outs_p))
            ms = median_ms(lambda: kernel(*args))
            plain_ms = median_ms(lambda: plain(*args), iters=5)
        ok = err <= TOL[name] * scale
        print(f"[kernels] {name} {label}: max_abs_err={err:.6g} "
              f"mean_abs_err={mean:.3g} max|plain|={scale:.4g} "
              f"(tol {TOL[name]} x max|plain|) kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms{'' if ok else '  FAIL'}", flush=True)
        if not ok:
            raise RuntimeError(f"{name} {label}: kernel disagrees with its "
                               f"plain version ({err} > {TOL[name]} x "
                               f"{scale})")
        row = rows.setdefault(name, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row.setdefault("ms", ms)
        row.setdefault("plain_ms", plain_ms)

    compare("lifter_trunk", fa.lifter_trunk, fa.lifter_trunk_plain,
            trunk_case(r, B), f"B={B} T*J={T * J} C={C}")
    for steps in (16, 9):
        compare("gru_layer", fa.gru_layer, fa.gru_layer_plain,
                gru_case(r, steps, B), f"T={steps} B={B} H=1024")
    for steps in (16, 8):
        compare("gru_layer_rev", fa.gru_layer_rev,
                lambda gi, w, b: fa.gru_layer_plain(gi, w, b, reverse=True),
                gru_case(r, steps, B), f"T={steps} B={B} H=1024")
    compare("coevo_chain", fc.coevo_chain, fc.coevo_chain_plain,
            chain_case(r, B), f"B={B} J={J} V=431 C=64")
    return rows


def serve(device) -> tuple[float, dict]:
    """Phase 3: the full-width bf16 serving forward on the kernel path."""
    from unittest import mock

    import numpy as np
    import torch

    from pmce_tpu_torch.models.pmce import create_pmce
    from pmce_tpu_torch.ops import _cuda
    from pmce_tpu_torch.ops import fused_attention as fa
    from pmce_tpu_torch.ops import fused_coevo_chain as fc
    from pmce_tpu_torch.smpl.artifacts import ensure_cached_artifacts
    from pmce_tpu_torch.smpl.mesh import ensure_cached_coarsening

    t0 = time.time()
    art = ensure_cached_artifacts()
    coarse = ensure_cached_coarsening()
    model, _ = create_pmce(num_joint=J, art=art, coarsening=coarse,
                           dtype=torch.bfloat16, fused=True, device=device,
                           seed=0)
    nparams = sum(p.numel() for p in model.parameters())
    print(f"[serve] model ready: {nparams / 1e6:.1f} M params, "
          f"{time.time() - t0:.1f} s (artifacts, assets, weights)", flush=True)

    rng = np.random.default_rng(0)
    pose2d = torch.from_numpy(
        rng.standard_normal((B, T, J, 2), dtype=np.float32)).to(device)
    img_feat = torch.from_numpy(
        rng.standard_normal((B, T, 2048), dtype=np.float32)).to(device)

    with torch.no_grad():
        _cuda.reset_launch_counts()
        mesh, evo, pose3d = model(pose2d, img_feat)
        torch.cuda.synchronize()
        counts = _cuda.launch_counts()
    print(f"[serve] launches on the serving forward: {counts}", flush=True)
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the main path: {missing}")

    expect = {"mesh": (B, art.num_verts, 3), "evo_pose": (B, J, 3),
              "pose3d": (B, J, 3)}
    outs = {"mesh": mesh, "evo_pose": evo, "pose3d": pose3d}
    for name, t in outs.items():
        if tuple(t.shape) != expect[name] or t.dtype != torch.float32:
            raise RuntimeError(f"{name}: {tuple(t.shape)} {t.dtype}")
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"{name}: non-finite values")

    # The same model through the plain versions (this comparison only).
    with torch.no_grad(), \
            mock.patch.object(fa, "lifter_trunk", fa.lifter_trunk_plain), \
            mock.patch.object(fa, "gru_layer", fa.gru_layer_plain), \
            mock.patch.object(fa, "gru_layer_rev",
                              lambda gi, w, b: fa.gru_layer_plain(
                                  gi, w, b, reverse=True)), \
            mock.patch.object(fc, "coevo_chain", fc.coevo_chain_plain):
        plain = dict(zip(("mesh", "evo_pose", "pose3d"),
                         model(pose2d, img_feat)))
    for name, t in outs.items():
        scale = float(plain[name].abs().max())
        err = max_err(t, plain[name])
        print(f"[serve] {name} kernel vs plain path: max_abs_err={err:.6g} "
              f"(max |x| {scale:.4g}, tol {SERVE_REL_TOL} x max)", flush=True)
        if err > SERVE_REL_TOL * scale:
            raise RuntimeError(f"{name}: kernel path disagrees with plain")

    check_f32_small(model, device)

    iters = 10
    with torch.no_grad():
        for _ in range(2):
            model(pose2d, img_feat)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            model(pose2d, img_feat)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    fps = B * iters / dt
    print(f"[serve] bf16 fused forward, B={B}: {dt / iters * 1e3:.3f} ms per "
          f"batch, {fps:.1f} mid-frames/s on {card_line()}", flush=True)
    return fps, counts


def check_f32_small(model, device) -> None:
    """A small f32 input through the modular path: the card vs the CPU."""
    import copy

    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = copy.deepcopy(model).float()
    for m in (f32.pose_lifter, f32.pose_mesh_coevo):
        m.dtype, m.fused = None, False
    rng = np.random.default_rng(1)
    pose2d = torch.from_numpy(rng.standard_normal((2, T, J, 2),
                                                  dtype=np.float32))
    img_feat = torch.from_numpy(rng.standard_normal((2, T, 2048),
                                                    dtype=np.float32))
    with torch.no_grad():
        on_card = f32(pose2d.to(device), img_feat.to(device))
        on_cpu = f32.cpu()(pose2d, img_feat)
    for name, a, b in zip(("mesh", "evo_pose", "pose3d"), on_card, on_cpu):
        err = max_err(a.cpu(), b)
        tol = 1e-3 * max(1.0, float(b.abs().max()))
        print(f"[serve] f32 B=2 card vs CPU {name}: max_abs_err={err:.3g} "
              f"(tol {tol:.3g}, TF32 off)", flush=True)
        if err > tol:
            raise RuntimeError(f"f32 {name}: card and CPU disagree")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "pmce_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no pmce_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from pmce_tpu_torch.ops import _cuda

    device = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}", flush=True)
    print(f"[card] python {sys.version.split()[0]}, torch {torch.__version__}"
          f", CUDA {torch.version.cuda}", flush=True)
    t0 = time.time()
    _cuda.build_all()
    print(f"[build] 3 kernel libraries built and loaded in "
          f"{time.time() - t0:.1f} s", flush=True)
    for lib in _cuda.LIBRARIES:
        log = lib.path.with_suffix(".log")
        if log.is_file():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[build] {lib.source}: {line.strip()}", flush=True)

    rows = check_kernels(device)
    fps, counts = serve(device)

    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": counts[name],
                "max_abs_err": rows[name]["max_abs_err"],
                "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"]}
               for name in REPLACES]
    print(f"[card] {card}; serving {fps:.1f} mid-frames/s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
