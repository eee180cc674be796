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

The backward scan (row 13) the same way at the Stage-2 step's shapes (one
direction, B = 32: T = 16 forward and reverse, T = 9 and 8), after a check
that both builds agree within 0.02 of the largest gradient (their sums run
in different orders, so their bits may differ). A variant without
``pmce_gru_bwd_scan`` (a build from before the persistent backward) is
driven through its per-step entry points, ``pmce_gru_bwd_first`` and
``pmce_gru_bwd_step``, one host call a step, as its wrapper did.
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


# The per-step backward's entry points of builds from before the
# persistent backward scan.
LEGACY_BWD = {
    "pmce_gru_bwd_first": (_cuda.I, (_cuda.P,) * 10 + (_cuda.I, _cuda.I,
                                                       _cuda.P)),
    "pmce_gru_bwd_step": (_cuda.I, (_cuda.P,) * 13 + (_cuda.I, _cuda.I,
                                                      _cuda.I, _cuda.P)),
}


class VariantLibrary(_cuda.CudaLibrary):
    """A gru_scan source outside ``csrc/``, built beside the tree's own;
    it binds the entry points it exports of the tree's and the legacy
    backward's."""

    def __init__(self, src: Path):
        super().__init__("gru_scan", "pmce_gru_error_string",
                         {**_cuda.GRU.signatures, **LEGACY_BWD})
        self.src = src

    def load(self):
        if self._lib is None:
            import ctypes

            lib = ctypes.CDLL(str(self.path))
            self.signatures = {k: v for k, v in self.signatures.items()
                               if hasattr(lib, k)}
        return super().load()

    def exports(self, name: str) -> bool:
        return name in self.signatures

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


def legacy_bwd(lib, g, saved, wb, reverse):
    """The per-step backward of earlier builds: a gate-only launch, then one
    launch a step (its wrapper, as it drove them)."""
    T, B, H = g.shape
    f32, bf16 = torch.float32, torch.bfloat16
    dev = g.device
    Bp = -(-B // 16) * 16
    dgi = torch.empty(T, B, 3 * H, device=dev, dtype=f32)
    dgh = torch.empty_like(dgi)
    dghb = torch.zeros(2, Bp, 3 * H, device=dev, dtype=bf16)
    dh = torch.empty(B, H, device=dev, dtype=f32)
    stream = _cuda.stream_ptr(dev)
    p = _cuda.ptr

    def state(t):
        return (p(g[t]), *(p(saved[i, t]) for i in range(5)))

    def grads(t, slot):
        return (p(dgi[t]), p(dgh[t]), p(dghb[slot]))

    rows = list(range(T)) if reverse else list(range(T - 1, -1, -1))
    lib.call("pmce_gru_bwd_first", *state(rows[0]), *grads(rows[0], 0),
             p(dh), B, H, stream)
    for i in range(1, T):
        t, tn = rows[i - 1], rows[i]
        lib.call("pmce_gru_bwd_step", p(dghb[(i - 1) % 2]), p(wb),
                 p(saved[2, t]), p(dh), *state(tn), *grads(tn, i % 2), B, Bp,
                 H, stream)
    return dgi, dgh


def backward(lib, g, saved, wb, reverse):
    """One backward scan of a direction on ``lib``: (dgi, dgh) f32."""
    if isinstance(lib, VariantLibrary) and not lib.exports(
            "pmce_gru_bwd_scan"):
        return legacy_bwd(lib, g, saved, wb, reverse)
    _cuda.GRU = lib
    return fa._gru_bwd_cuda(g, saved, wb, reverse)[:2]


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
        # The backward scan at the Stage-2 step's shapes, from one saving
        # forward each (the tree's build).
        _cuda.GRU = tree
        bwd_cases = {}
        for steps, rev in ((16, False), (16, True), (9, False), (8, True)):
            gi, w, b = direction(steps, 32)
            _, saved, wb = fa._gru_save(gi, w, b, rev)
            g = rnd(steps, 32, H, scale=0.1, dtype=torch.bfloat16)
            bwd_cases[f"bwd T={steps}{' rev' if rev else ''} B=32"] = (
                g, saved, wb, rev)
        for label, args in bwd_cases.items():
            (a1, a2), (b1, b2) = (backward(lib, *args) for _, lib in builds)
            rel = max(float((x - y).abs().max() / y.abs().max())
                      for x, y in ((a1, b1), (a2, b2)))
            print(f"{label}: variant vs tree, max|diff| / max|tree| "
                  f"{rel:.3g}", flush=True)
            if rel > 0.02:
                return 1
        for rep in range(3):
            for name, lib in (*builds, *builds[::-1]):
                times = {label: launch_ms(
                    lambda a=args, lb=lib: backward(lb, *a))
                    for label, args in bwd_cases.items()}
                print(f"rep {rep} {name}: " + ", ".join(
                    f"{k} {v:.4f} ms" for k, v in times.items()), flush=True)
        _cuda.GRU = tree
        split = fa.gru_bwd_stage_split(*bwd_cases["bwd T=16 B=32"])
        total = sum(split[k] for k in fa.GRU_BWD_STAGES)
        print("tree bwd split: " + ", ".join(
            f"{k} {split[k] / total:.1%}" for k in fa.GRU_BWD_STAGES)
            + f"; {total / split['ctas'] / split['steps']:.0f} cycles a step "
            "a CTA", flush=True)
    _cuda.GRU = tree
    return 0


if __name__ == "__main__":
    sys.exit(main())
