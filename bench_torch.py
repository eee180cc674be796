#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: PMCE serving throughput on one card.

    python3 bench_torch.py

The port's counterpart of ``bench.py`` (which measures the JAX package).
It prints, on earlier lines, the card and the spread of the runs and the
device time of one forward, then one JSON line:

  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Measured: end-to-end PMCE inference (Stage-1 lifting and Stage-2
co-evolution decoding to the full 6890-vertex mesh) in recovered
mid-frames per second, in the serving configuration of ``chip_smoke.py``'s
phase 3 and ``pmce_tpu_torch/tools/compare_serving.py``:
``create_pmce(num_joint=19, dtype=torch.bfloat16, fused=True)`` (the
lifter trunk, GRU scan and decoder chain kernels), weights from seed 0
perturbed by ``tests/torch_port_init.perturbed_init``, batch 256 of 16
frames, 8 seeded input pairs. After a warm-up, 5 runs of 32 forwards, each
timed on the host clock ending in ``torch.cuda.synchronize()``; ``value``
is the median rate. The device time of one forward is the sum of the
kernels' times over 5 profiled forwards (``torch.profiler``), divided by 5.

``vs_baseline`` is against ``bench.py``'s ``REFERENCE_BASELINE_FPS``: 3500
mid-frames/s, an estimate of the reference's PyTorch forward on its RTX
3090 (the reference publishes no numbers). ``--record-perf [--perf-path
P]`` records the result under ``serving`` in the port's perf file
(``pmce_tpu_torch/utils/perf.py``: ``PERF_TORCH.json`` by default, stamped
with the card); otherwise the script writes no file. ``PERF.json`` and the
README block made from it belong to the JAX package. Without a CUDA card it
exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
REFERENCE_BASELINE_FPS = 3500.0


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def serving_rate(device, batch: int = 256, frames: int = 16,
                 joints: int = 19, n_inputs: int = 8, runs: int = 5,
                 iters: int = 32, warmup: int = 2,
                 embed_dim: int = 256, depth: int = 3, art=None,
                 coarse=None) -> dict:
    """Serving throughput of the bf16 fused PMCE on ``device``.

    Returns ``rates`` (mid-frames/s of each run of ``iters`` forwards),
    their ``median``, and ``device_ms`` (kernel time of one forward from
    ``torch.profiler``; None off the card). ``art`` / ``coarse`` default to
    the cached SMPL artifacts and mesh coarsening."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for path in (str(REPO / "tests"), str(REPO)):
        if path not in sys.path:
            sys.path.insert(0, path)
    from pmce_tpu_torch.models.pmce import create_pmce
    from pmce_tpu_torch.smpl.artifacts import ensure_cached_artifacts
    from pmce_tpu_torch.smpl.mesh import ensure_cached_coarsening
    from torch_port_init import perturbed_init

    device = torch.device(device)
    on_card = device.type == "cuda"
    art = art if art is not None else ensure_cached_artifacts()
    coarse = coarse if coarse is not None else ensure_cached_coarsening()
    model, _ = create_pmce(num_joint=joints, art=art, coarsening=coarse,
                           embed_dim=embed_dim, depth=depth,
                           seqlen=frames, dtype=torch.bfloat16, fused=True,
                           device=device, seed=0)
    perturbed_init(model, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    inputs = [
        (torch.from_numpy(rng.normal(size=(batch, frames, joints, 2))
                          .astype(np.float32)).to(device),
         torch.from_numpy(rng.normal(size=(batch, frames, 2048))
                          .astype(np.float32)).to(device))
        for _ in range(n_inputs)]

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    rates = []
    with torch.no_grad():
        for i in range(warmup):
            model(*inputs[i % n_inputs])
        sync()
        for _ in range(runs):
            t0 = time.perf_counter()
            for i in range(iters):
                model(*inputs[i % n_inputs])
            sync()
            rates.append(batch * iters / (time.perf_counter() - t0))
        device_ms = None
        profiled = 5
        if on_card:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for i in range(profiled):
                    model(*inputs[i % n_inputs])
                sync()
            device_ms = sum(
                e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
            ) / 1e3 / profiled
    return {"rates": rates, "median": statistics.median(rates),
            "device_ms": device_ms, "batch": batch, "iters": iters}


def result_line(res: dict, card: str) -> dict:
    """``bench.py``'s JSON keys for a ``serving_rate`` result measured on
    ``card`` (its name and power limit)."""
    fps = res["median"]
    return {
        "metric": "pmce_mesh_recovery_throughput_torch",
        "value": round(fps, 1),
        "unit": (f"mid-frames/s on {card} (PyTorch/CUDA port, batch "
                 f"{res['batch']}, bf16 fused serving path, median of "
                 f"{len(res['rates'])} runs of {res['iters']} forwards on "
                 f"the host clock ending in torch.cuda.synchronize)"),
        "vs_baseline": round(fps / REFERENCE_BASELINE_FPS, 2),
    }


def perf_payload(res: dict) -> dict:
    """``bench.py``'s ``serving`` fields that apply to the port (no
    ``vs_baseline``, a TPU-era ratio; no ``tflops_implied``: the port
    counts no FLOPs here), with the device time of one forward."""
    return {"mid_frames_per_s": round(res["median"], 1),
            "batch": res["batch"], "device_ms": res["device_ms"],
            "source": "bench_torch.py"}


def main(argv: list | None = None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record-perf", action="store_true",
                    help="record the result under 'serving' in the port's "
                         "perf file")
    ap.add_argument("--perf-path", default=None,
                    help="perf file of --record-perf (default "
                         "PERF_TORCH.json at the repository root)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(f"[bench_torch] {card}", flush=True)
    res = serving_rate(torch.device("cuda", 0))
    rates = res["rates"]
    print(f"[bench_torch] {len(rates)} runs of {res['iters']} forwards: "
          + ", ".join(f"{r:.1f}" for r in rates)
          + f" mid-frames/s (min {min(rates):.1f}, median "
          f"{res['median']:.1f}, max {max(rates):.1f})", flush=True)
    print(f"[bench_torch] device time of one forward: "
          f"{res['device_ms']:.3f} ms (torch.profiler, kernels summed)",
          flush=True)
    if args.record_perf:
        sys.path.insert(0, str(REPO))
        from pmce_tpu_torch.utils import perf

        perf.record("serving", perf_payload(res), path=args.perf_path,
                    device="cuda")
    print(json.dumps(result_line(res, card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
