"""Time rows 6f / 7f of this tree against a variant source of
``csrc/block_f32.cu`` (an earlier version, say) in one process on the card.

    python3 pmce_tpu_torch/tools/compare_block_f32.py VARIANT.cu

Both are built with the port's nvcc flags (the variant with ``csrc/`` on
its include path) into separate libraries under ``pmce_tpu_torch/_build/``;
the wrappers look the library up at call time, so each timing swaps one
in. The variant must export ``pmce_block_fwd_f32`` and
``pmce_block_bwd_f32``; a variant whose entry points take no CTA count
(the grid of a CTA a tile, before the persistent grid) is called without
it, with the wrappers' plan at a CTA a tile. TF32 off throughout; over 3
rounds in turns (variant, tree, tree, variant) it prints

- at the f32 serving forward's two shapes ([4096, 19, 256] spatial,
  [4864, 16, 256] temporal, hid 512, the post-norm): row 6f without a
  gradient, the median of 20 CUDA-event-timed wrapper calls after 5
  warm-ups;
- at Stage 1's two shapes ([1024, 17, 256] spatial, [1088, 16, 256]
  temporal, branch masks at rate 0.2): row 6f's masked forward without a
  gradient, row 7f's autograd call (``torch.autograd.grad`` over the
  block's output) timed the same way, and row 7f on the card (its kernels'
  device time a call from ``torch.profiler`` over 5 calls);

each build's median, the plain version's time, ``nn.TransformerEncoder``'s
in f32 in the same process (no-grad forward at the serving shapes, forward
with grad and its autograd backward at Stage 1's), each build's largest
difference from the plain version relative to its largest magnitude
(outputs; at Stage 1 also every gradient) and whether the tree gives the
same bits on a rerun.
"""

from __future__ import annotations

import hashlib
import re
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
from pmce_tpu_torch.tools.profile_f32 import device_ms  # noqa: E402

ROUNDS = 3
TURNS = ("variant", "tree", "tree", "variant")


class VariantLibrary(_cuda.CudaLibrary):
    """A block_f32 source outside ``csrc/``, built beside the tree's. A
    source whose forward takes no ``ctas`` is called without the CTA
    count (``legacy``)."""

    def __init__(self, src: Path):
        self.legacy = re.search(r"pmce_block_fwd_f32\([^)]*\bctas\b",
                                src.read_text()) is None
        sigs = _cuda.BLOCK_F32.signatures
        if self.legacy:
            sigs = {name: (rt, args[:-2] + args[-1:])
                    for name, (rt, args) in sigs.items()}
        super().__init__("block_f32", "pmce_block_f32_error_string", sigs)
        self.src = src

    @property
    def path(self) -> Path:
        digest = hashlib.sha1(self.src.read_bytes()).hexdigest()[:12]
        return _cuda.BUILD_DIR / f"block_f32_variant-{digest}.so"

    def build_command(self):
        out = self.path
        tmp = out.with_suffix(".tmp")
        return ([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC),
                 "-o", str(tmp), str(self.src)], tmp, out)

    def call(self, name: str, *args):
        if self.legacy:
            args = args[:-2] + args[-1:]
        super().call(name, *args)


class Builds:
    """The two builds, swapped into the wrappers by tag."""

    def __init__(self, variant: Path):
        self.libs = {"variant": VariantLibrary(variant),
                     "tree": _cuda.BLOCK_F32}
        self.resident = fa._block_f32_resident

    def use(self, tag: str) -> None:
        lib = self.libs[tag]
        _cuda.BLOCK_F32 = lib
        legacy = getattr(lib, "legacy", False)
        fa._block_f32_resident = ((lambda device: None) if legacy
                                  else self.resident)


def rel(a, b) -> float:
    return float((a.detach() - b.detach()).abs().max() / b.abs().max())


def fmt(ts) -> str:
    return (", ".join(f"{t:.4f}" for t in ts)
            + f" (median {statistics.median(ts):.4f})")


def in_turns(builds: Builds, timers: dict) -> dict:
    """{timer: {tag: [ms a turn]}} over ROUNDS rounds of TURNS."""
    times = {name: {tag: [] for tag in builds.libs} for name in timers}
    for _ in range(ROUNDS):
        for tag in TURNS:
            builds.use(tag)
            for name, fn in timers.items():
                times[name][tag].append(fn())
    builds.use("tree")
    return times


def serving(builds: Builds, dev, rng) -> None:
    for clips, N in ((cs.B * cs.T, cs.J), (cs.B * cs.J, cs.T)):
        x, params, _, _ = cs.block_case(rng, dev, clips, N, 0.0)
        x = x.detach().float()
        params = tuple(t.detach() for t in params)

        def call():
            return fa.transformer_block(x, params, 8)

        with torch.no_grad():
            y = fa.transformer_block_plain(x, params, 8)
            outs = {}
            for tag in builds.libs:
                builds.use(tag)
                outs[tag] = call()
            builds.use("tree")
            same = torch.equal(call(), outs["tree"])
            times = in_turns(builds, {"6f": lambda: cs.median_ms(call, 20, 5)})
            plain_ms = cs.median_ms(
                lambda: fa.transformer_block_plain(x, params, 8), iters=10)
            enc = cs.library_encoder(x, params).eval()
            lib_ms = cs.median_ms(lambda: enc(x), 20, 5)
        print(f"[{clips}, {N}, {cs.C}] row 6f serving: " + "; ".join(
            f"{tag} {fmt(ts)}" for tag, ts in times["6f"].items())
            + f" ms; plain {plain_ms:.4f} ms; nn.TransformerEncoder f32 "
            f"no-grad {lib_ms:.4f} ms; vs plain: variant "
            f"{rel(outs['variant'], y):.3g}, tree {rel(outs['tree'], y):.3g}"
            f"; the tree's rerun gives the same bits: {same}", flush=True)
        del x, params, y, outs, enc
        torch.cuda.empty_cache()


def stage1(builds: Builds, dev, rng) -> None:
    for clips, N in ((cs.BT * cs.T, cs.JT), (cs.BT * cs.JT, cs.T)):
        x, params, masks, g = cs.block_case(rng, dev, clips, N, 0.2)
        x = x.detach().float().requires_grad_(True)
        g = g.float()
        leaves = [x, *params]

        def fwd():
            return fa.transformer_block(x, params, 8, 1e-6, 1e-6, masks)

        def fwd_nograd():
            with torch.no_grad():
                return fwd()

        yp = fa.transformer_block_plain(x, params, 8, 1e-6, 1e-6, masks)
        gp = torch.autograd.grad(yp, leaves, g)
        errs, ys = {}, {}
        for tag in builds.libs:
            builds.use(tag)
            y = ys[tag] = fwd()
            gk = torch.autograd.grad(y, leaves, g, retain_graph=True)
            errs[tag] = (rel(fwd_nograd(), yp),
                         max(rel(a, b) for a, b in zip(gk, gp)))
        builds.use("tree")
        again = torch.autograd.grad(fwd(), leaves, g)
        same = all(torch.equal(a, b) for a, b in zip(
            again, torch.autograd.grad(ys["tree"], leaves, g,
                                       retain_graph=True)))

        def bwd():
            y = ys["tree" if _cuda.BLOCK_F32 is builds.libs["tree"]
                    else "variant"]
            return torch.autograd.grad(y, leaves, g, retain_graph=True)

        def card():
            return sum(device_ms(bwd).values())

        times = in_turns(builds, {
            "6f masked": lambda: cs.median_ms(fwd_nograd, 20, 5),
            "7f autograd call": lambda: cs.median_ms(bwd, 20, 5),
            "7f on the card": card})
        kernels = {}
        for tag in builds.libs:
            builds.use(tag)
            kernels[tag] = device_ms(bwd)
        builds.use("tree")
        enc = cs.library_encoder(x, params).train()
        xin = x.detach().requires_grad_(True)
        lib_f = cs.median_ms(lambda: enc(xin), 20, 5)
        ylib = enc(xin)
        lib_leaves = [xin, *enc.parameters()]
        lib_b = cs.median_ms(lambda: torch.autograd.grad(
            ylib, lib_leaves, g, retain_graph=True), 20, 5)
        where = f"[{clips}, {N}, {cs.C}] masks rate 0.2"
        for name, per_tag in times.items():
            print(f"{where} row {name}: " + "; ".join(
                f"{tag} {fmt(ts)}" for tag, ts in per_tag.items()) + " ms",
                flush=True)
        for tag, ks in kernels.items():
            print(f"{where} row 7f {tag} kernels: " + ", ".join(
                f"{k} {v:.4f}" for k, v in sorted(ks.items(),
                                                   key=lambda kv: -kv[1]))
                + " ms", flush=True)
        print(f"{where} nn.TransformerEncoder f32: forward with grad "
              f"{lib_f:.4f} ms, autograd backward {lib_b:.4f} ms; vs plain "
              f"(output, worst gradient): " + "; ".join(
                  f"{tag} {e[0]:.3g}, {e[1]:.3g}" for tag, e in errs.items())
              + f"; the tree's rerun gives the same bits: {same}",
              flush=True)
        del x, params, masks, g, leaves, yp, gp, ys, enc, xin, ylib
        del lib_leaves
        torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("compare_block_f32: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    builds = Builds(Path(sys.argv[1]).resolve())
    _cuda._build(list(builds.libs.values()))
    print("variant entry points: " + ("without a CTA count (a CTA a tile)"
          if builds.libs["variant"].legacy else "with a CTA count"),
          flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2)
    stage1(builds, dev, rng)
    serving(builds, dev, rng)


if __name__ == "__main__":
    main()
