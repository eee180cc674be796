"""The serving forward's rate and device time, for comparing two trees.

    python3 pmce_tpu_torch/tools/compare_serving.py [--root DIR] [--tag T]
        [--rounds N]

Imports ``pmce_tpu_torch`` (and ``tests/torch_port_init.py``) from ``DIR``
(default: the tree this script is in; an unpacked earlier commit, say) and
builds the flagship serving model as ``chip_smoke.py``'s phase 3 does:
``create_pmce(num_joint=19)``, bf16, ``fused=True``, batch 256, 16 frames,
weights from seed 0 perturbed by ``perturbed_init``; and, on the same
weights, the ``whole_block_kernel`` model of phase 3b. For each it prints:

- ``N`` rates in turns (chain, whole-block, chain, ...): mid-frames/s on
  the host clock around 10 forwards ending in a synchronise, after 2
  warm-ups, as phase 3 reads it;
- the device time of one forward by kernel (``torch.profiler`` over 5
  forwards): the sum, the busy share of the profiled wall time, and the
  lifter trunk's (K1's) kernel time.

Every line starts with ``[TAG]`` and the card's name and power limit are
printed first. Run it once a tree, in turns (parent, tree, tree, parent,
...), in one call, so that the trees share the card's state.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

B, T, J = 256, 16, 19


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    sys.path.insert(1, str(Path(args.root) / "tests"))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("compare_serving: no CUDA device", file=sys.stderr)
        return 2
    from pmce_tpu_torch.models.pmce import create_pmce
    from pmce_tpu_torch.smpl.artifacts import ensure_cached_artifacts
    from pmce_tpu_torch.smpl.mesh import ensure_cached_coarsening
    from torch_port_init import perturbed_init

    tag = f"[{args.tag}]"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"{tag} {card}; pmce_tpu_torch from {args.root}", flush=True)
    dev = torch.device("cuda", 0)
    art, coarse = ensure_cached_artifacts(), ensure_cached_coarsening()
    models = {}
    for name, whole in (("chain", False), ("whole-block", True)):
        models[name], _ = create_pmce(
            num_joint=J, art=art, coarsening=coarse, dtype=torch.bfloat16,
            fused=True, whole_block_kernel=whole, device=dev, seed=0)
    perturbed_init(models["chain"], torch.Generator().manual_seed(0))
    models["whole-block"].load_state_dict(models["chain"].state_dict())
    rng = np.random.default_rng(0)
    pose2d = torch.from_numpy(
        rng.standard_normal((B, T, J, 2), dtype=np.float32)).to(dev)
    img_feat = torch.from_numpy(
        rng.standard_normal((B, T, 2048), dtype=np.float32)).to(dev)

    def rate(model, iters=10):
        with torch.no_grad():
            for _ in range(2):
                model(pose2d, img_feat)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                model(pose2d, img_feat)
            torch.cuda.synchronize()
        return B * iters / (time.perf_counter() - t0)

    def device_ms(model, n=5):
        with torch.no_grad():
            for _ in range(2):
                model(pose2d, img_feat)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(n):
                    model(pose2d, img_feat)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / n
        total = trunk = 0.0
        for e in prof.events():
            if (e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)):
                ms = e.time_range.elapsed_us() / 1e3 / n
                total += ms
                if "block_kernel" in e.name and "tb::" in e.name:
                    trunk += ms
        return total, wall, trunk

    rates = {name: [] for name in models}
    for _ in range(args.rounds):
        for name, model in models.items():
            rates[name].append(rate(model))
    for name, model in models.items():
        got = rates[name]
        print(f"{tag} {name}: mid-frames/s " + ", ".join(
            f"{x:.1f}" for x in got) + f" (median {statistics.median(got):.1f})",
            flush=True)
        total, wall, trunk = device_ms(model)
        print(f"{tag} {name}: {total:.3f} ms of kernel time a forward in "
              f"{wall:.3f} ms of wall time (busy {total / wall:.1%}); K1 "
              f"(lifter trunk) {trunk:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
