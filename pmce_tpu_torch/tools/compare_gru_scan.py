"""Time the GRU scan kernel of this tree against a variant source of
``csrc/gru_scan.cu`` (an earlier version, say) in one process on the card.

    python3 pmce_tpu_torch/tools/compare_gru_scan.py VARIANT.cu

Both are built with the port's nvcc flags (the variant with ``csrc/`` on
its include path) into separate libraries under ``pmce_tpu_torch/_build/``;
the wrappers look the library up at call time, so each timing swaps one
in. The variant must export the same C entry points. Checks that both give
the same bits, then prints, per repetition and in turns (variant, tree,
tree, variant), the time of one launch (CUDA events over 50 back-to-back
launches after 5 warm-ups) of both directions at B = 256 (layer 0's 16 +
16 steps, layer 1's 9 + 8), at B = 32 and 5, and of the saving variant at
the Stage-2 step's shape (one direction, T = 16, B = 32); then each
build's stage split at B = 256, 16 + 16 steps.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from pmce_tpu_torch.ops import _cuda  # noqa: E402
from pmce_tpu_torch.ops import fused_attention as fa  # noqa: E402

H = 1024


class VariantLibrary(_cuda.CudaLibrary):
    """A gru_scan source outside ``csrc/``, built beside the tree's own."""

    def __init__(self, src: Path):
        super().__init__("gru_scan", "pmce_gru_error_string",
                         _cuda.GRU.signatures)
        self.src = src

    @property
    def path(self) -> Path:
        digest = hashlib.sha1(self.src.read_bytes()).hexdigest()[:12]
        return _cuda.BUILD_DIR / f"gru_scan_variant-{digest}.so"

    def build_command(self):
        out = self.path
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        return ([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC),
                 "-o", str(tmp), str(self.src)], tmp, out)


def launch_ms(fn, n: int = 50) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def split_line(args) -> str:
    split = fa.gru_stage_split(*args)
    total = sum(split[k] for k in fa.GRU_STAGES)
    return (", ".join(f"{k} {split[k] / total:.1%}" for k in fa.GRU_STAGES)
            + f"; {total / split['ctas'] / split['steps']:.0f} cycles a "
            "step a CTA")


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    tree, variant = _cuda.GRU, VariantLibrary(Path(sys.argv[1]).resolve())
    _cuda._build([tree, variant])
    tree.load()
    variant.load()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    def direction(steps, batch):
        return (rnd(steps, batch, 3 * H, dtype=torch.bfloat16),
                rnd(3 * H, H, scale=H ** -0.5).t(), rnd(3 * H, scale=0.1))

    cases = {}
    for tf, tb, batch in ((16, 16, 256), (9, 8, 256), (16, 16, 32),
                          (9, 8, 5)):
        (gf, wf, bf), (gb, wb, bb) = direction(tf, batch), direction(tb,
                                                                     batch)
        cases[f"T={tf}+{tb} B={batch}"] = (gf, gb, wf, bf, wb, bb)
    save = direction(16, 32)
    builds = (("variant", variant), ("tree", tree))
    with torch.no_grad():
        for label, args in cases.items():
            outs = []
            for _, lib in builds:
                _cuda.GRU = lib
                outs.append((fa.gru_bidir(*args), fa._gru_save(*save, False)))
            same = all(torch.equal(a, b) for a, b in zip(
                [*outs[0][0], *outs[0][1]], [*outs[1][0], *outs[1][1]]))
            print(f"{label}: variant and tree give the same bits: {same}",
                  flush=True)
            if not same:
                return 1
        for rep in range(3):
            for name, lib in (*builds, *builds[::-1]):
                _cuda.GRU = lib
                times = {label: launch_ms(lambda a=args: fa.gru_bidir(*a))
                         for label, args in cases.items()}
                times["save T=16 B=32"] = launch_ms(
                    lambda: fa._gru_save(*save, False))
                print(f"rep {rep} {name}: " + ", ".join(
                    f"{k} {v:.4f} ms" for k, v in times.items()), flush=True)
        for name, lib in builds:
            _cuda.GRU = lib
            print(f"{name} split: "
                  + split_line(cases["T=16+16 B=256"]), flush=True)
    _cuda.GRU = tree
    return 0


if __name__ == "__main__":
    sys.exit(main())
