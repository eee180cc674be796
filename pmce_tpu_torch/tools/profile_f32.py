"""Device time by kernel of the f32 training kernels on the card, and rows
4f / 5f against a variant source of ``csrc/mhsa_f32.cu``.

    python3 pmce_tpu_torch/tools/profile_f32.py [--variant VARIANT.cu]

At the main paths' shapes (rows 6f / 7f: the Stage-1 spatial [1024, 17,
256] and temporal [1088, 16, 256] blocks, hid 512, the post-norm, branch
masks at rate 0.2; rows 4f / 5f: the f32 joint stream's [32, 17, 64] and
[32, 19, 64] in heads of 8; TF32 off) it prints the median of 20
CUDA-event-timed calls of each wrapper (the forward; the backward as the
autograd call) after 5 warm-ups, and each kernel's device time a call
from ``torch.profiler`` over 5 calls. With ``--variant``, the variant
(built with the port's nvcc flags and ``csrc/`` on its include path into
its own library under ``pmce_tpu_torch/_build/``; it must export the
entry points of ``csrc/mhsa_f32.cu``) and the tree's rows 4f / 5f are
timed in turns (variant, tree, tree, variant, 3 rounds) in one process,
and the two builds' bits compared.
"""

from __future__ import annotations

import argparse
import hashlib
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from pmce_tpu_torch.ops import _cuda  # noqa: E402
from pmce_tpu_torch.ops import fused_attention as fa  # noqa: E402


class VariantLibrary(_cuda.CudaLibrary):
    """A mhsa_f32 source outside ``csrc/``, built beside the tree's."""

    def __init__(self, src: Path):
        super().__init__("mhsa_f32", "pmce_mhsa_f32_error_string",
                         _cuda.MHSA_F32.signatures)
        self.src = src

    @property
    def path(self) -> Path:
        digest = hashlib.sha1(self.src.read_bytes()).hexdigest()[:12]
        return _cuda.BUILD_DIR / f"mhsa_f32_variant-{digest}.so"

    def build_command(self):
        out = self.path
        tmp = out.with_suffix(".tmp")
        return ([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC),
                 "-o", str(tmp), str(self.src)], tmp, out)


def device_ms(fn, n: int = 5) -> dict:
    """{kernel: device ms a call} over n calls of fn (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[0]: e.self_device_time_total / n / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def show(tag: str, wrapper_ms: float, kernels: dict) -> None:
    total = sum(kernels.values())
    print(f"{tag}: wrapper {wrapper_ms:.4f} ms; on the card {total:.4f} ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in
                      sorted(kernels.items(), key=lambda kv: -kv[1])),
          flush=True)


def mhsa_case(rng, dev, N: int):
    def r(*s, scale=1.0):
        a = rng.normal(size=s) * scale
        return torch.from_numpy(a.astype("float32")).to(
            dev).requires_grad_(True)

    leaves = [r(cs.BM, N, 64), r(64, 192, scale=0.125), r(192, scale=0.05),
              r(64, 64, scale=0.125), r(64, scale=0.05)]
    g = torch.from_numpy(rng.normal(size=(cs.BM, N, 64)).astype(
        "float32")).to(dev)
    return leaves, g


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_f32: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    builds = {"tree": _cuda.MHSA_F32}
    if args.variant is not None:
        builds["variant"] = VariantLibrary(args.variant.resolve())
    _cuda._build([_cuda.BLOCK_F32, *builds.values()])
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(4)

    for clips, N in ((cs.BT * cs.T, cs.JT), (cs.BT * cs.JT, cs.T)):
        x, params, masks, g = cs.block_case(rng, dev, clips, N, 0.2)
        x = x.detach().float().requires_grad_(True)
        g = g.float()
        leaves = [x, *params]

        def fwd():
            return fa.transformer_block(x, params, 8, 1e-6, 1e-6, masks)

        y = fwd()

        def bwd():
            return torch.autograd.grad(y, leaves, g, retain_graph=True)

        show(f"row 6f [{clips}, {N}, 256]", cs.median_ms(fwd, 20, 5),
             device_ms(fwd))
        show(f"row 7f [{clips}, {N}, 256]", cs.median_ms(bwd, 20, 5),
             device_ms(bwd))
        del x, params, masks, g, leaves, y
        torch.cuda.empty_cache()

    for N in (cs.JT, cs.J):
        leaves, g = mhsa_case(rng, dev, N)

        def fwd():
            return fa.fused_mhsa(*leaves, 8)

        def bwd():
            return torch.autograd.grad(fwd(), leaves, g)

        times = {tag: {"4f": [], "5f": []} for tag in builds}
        kernels, outs = {}, {}
        order = (["variant", "tree", "tree", "variant"] * 3
                 if "variant" in builds else ["tree"])
        for tag in order:
            _cuda.MHSA_F32 = builds[tag]
            outs[tag] = (fwd(), *bwd())
            y = outs[tag][0]
            times[tag]["4f"].append(cs.median_ms(fwd, 20, 5))
            times[tag]["5f"].append(cs.median_ms(
                lambda: torch.autograd.grad(y, leaves, g,
                                            retain_graph=True), 20, 5))
            kernels[tag] = (device_ms(fwd), device_ms(
                lambda: torch.autograd.grad(y, leaves, g,
                                            retain_graph=True)))
        _cuda.MHSA_F32 = builds["tree"]
        for tag in builds:
            for i, row in enumerate(("4f", "5f")):
                show(f"row {row} [{cs.BM}, {N}, 64] {tag} (median of "
                     f"{len(times[tag][row])} rounds: "
                     + ", ".join(f"{t:.4f}" for t in times[tag][row]) + ")",
                     statistics.median(times[tag][row]), kernels[tag][i])
        if "variant" in builds:
            same = [torch.equal(a, b) for a, b in
                    zip(outs["tree"], outs["variant"])]
            print(f"rows 4f / 5f [{cs.BM}, {N}, 64]: tree and variant give "
                  f"the same bits: out {same[0]}, dx {same[1]}, weights "
                  f"{same[2:]}", flush=True)


if __name__ == "__main__":
    main()
