"""Time rows 8f-11f (the f32 decoder blocks' forwards and backwards) of
this tree against variant sources of ``csrc/ada_f32.cu``, ``csrc/ca_f32.cu``,
``csrc/f32_ops.cuh`` and ``csrc/dec_tc32.cuh`` (an earlier version, say) in
one process on the card.

    python3 pmce_tpu_torch/tools/compare_dec_f32.py VARIANT_DIR [--step]
        [--vertices V]

VARIANT_DIR holds the variant's ``ada_f32.cu``, ``ca_f32.cu``,
``f32_ops.cuh`` and ``dec_tc32.cuh`` (e.g. ``git show
HEAD~1:pmce_tpu_torch/csrc/ada_f32.cu`` into a git-ignored directory);
each is built with the port's nvcc flags and VARIANT_DIR before ``csrc/``
on the include path into its own library under ``pmce_tpu_torch/_build/``,
and the wrappers look the library up at call time, so a timing swaps one
in. A variant whose forwards or backwards take no CTA count (the grids of
64-row chunks) is called without it. TF32 off throughout. At phase 13a's
three shapes (the AdaLN block at [32, 431, 64] in 2 heads of 32; the CA
block with joints [32, 17, 64] over vertices [32, 431, 64] in 8 heads of
8, and vertices over joints in 2 heads of 32; hid 256; branch masks at rate
0.2, requiring their gradient in the backward; ``--vertices 1723``: the
two-level mesh's vertex stream in place of 431, which sources before PR 26
do not take: there pass the tree's own ``pmce_tpu_torch/csrc`` as
VARIANT_DIR) it prints

- the tree's plans on this card (``f32_dec_fwd_plan`` and
  ``f32_dec_plan``: each program's CTAs, items and waves, the splits);
- over 3 rounds in turns (variant, tree, tree, variant): the forward's
  kernels' device time a call (``torch.profiler`` over 5 calls of the
  block without a gradient: every launch of the forward, the rows
  launch included), the backward's autograd call (``torch.autograd.grad``
  over the block's output, the median of 20 CUDA-event-timed calls after 5
  warm-ups) and its kernels' device time a call, each build's median, and
  the plain version's forward and autograd call beside them;
- each build's device time by kernel, forward and backward (the forward's
  programs under their own names: ``rows_kernel``, ``fwd_attn_kernel``,
  ``fwd_tail_kernel``);
- each build's largest difference from the plain version (the forward's
  output; the output and every gradient, each relative to its own largest
  magnitude; the CA block's key bias and key AdaLN beta, zero
  analytically, to the largest gradient), and whether the tree reruns bit
  for bit;
- the per-step sums a f32 Stage-2 step launches by build: the forwards (3
  AdaLN, 3 CA of joints over vertices, 3 of vertices over joints) and the
  backwards (3 AdaLN, 1 CA of joints over vertices, 3 of vertices over
  joints).

With ``--step``: phase 4's Stage-1 training (``chip_smoke.train``) for
the warm start, then phase 13b's f32 Stage-2 train step (batch 32) timed
in turns with each build (host clock, the median of 10 after 3 warm-ups)
with its kernels' device time by build.
"""

from __future__ import annotations

import argparse
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


def shapes(V: int) -> tuple:
    """(kind, Nq, heads, Nk, label): phase 13a's shapes at V vertices."""
    return (("ada", V, 2, 0, f"AdaLN block [32, {V}, 64], 2 heads"),
            ("ca", cs.JT, 8, V, f"CA joints [32, 17] over vertices [32, {V}]"
                                ", 8 heads"),
            ("ca", V, 2, cs.JT, f"CA vertices [32, {V}] over joints [32, 17]"
                                ", 2 heads"))
# How many of each a f32 Stage-2 step launches (chip_smoke's
# F32_STAGE2_STEP: ada_fwd_f32 3, ca_fwd_f32 6, three each way;
# ada_bwd_f32 3, ca_bwd_f32 4, of which one joint-query).
PER_STEP = {"forward": (3, 3, 3), "backward": (3, 1, 3)}


class VariantLibrary(_cuda.CudaLibrary):
    """A variant source built beside the tree's; ``legacy``: which of its
    entry points ("fwd", "bwd") take no CTA count."""

    def __init__(self, tree: _cuda.CudaLibrary, src: Path):
        text = src.read_text()
        self.legacy = {d for d in ("fwd", "bwd") if re.search(
            rf"_{d}_f32\([^)]*\bctas\b", text) is None}
        sigs = dict(tree.signatures)
        for name, (rt, args) in tree.signatures.items():
            if self._legacy(name):
                sigs[name] = (rt, args[:-2] + args[-1:])
            elif name == "pmce_ca_f32_workspace" and "bwd" in self.legacy:
                sigs[name] = (rt, args[:-1])
        super().__init__(tree.source, tree.error_fn, sigs)
        self.src = src

    def _legacy(self, name: str) -> bool:
        return any(name.endswith(f"_{d}_f32") for d in self.legacy)

    @property
    def path(self) -> Path:
        digest = hashlib.sha1()
        for f in sorted(self.src.parent.glob("*.cuh")) + [self.src]:
            digest.update(f.read_bytes())
        return (_cuda.BUILD_DIR
                / f"{self.source}_variant-{digest.hexdigest()[:12]}.so")

    def build_command(self):
        out = self.path
        tmp = out.with_suffix(".tmp")
        return ([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(self.src.parent),
                 "-I", str(_cuda.CSRC), "-o", str(tmp), str(self.src)], tmp,
                out)

    def call(self, name: str, *args):
        if self._legacy(name):
            args = args[:-2] + args[-1:]
        super().call(name, *args)

    def query(self, name: str, *args):
        if "bwd" in self.legacy and name == "pmce_ca_f32_workspace":
            args = args[:-1]
        return super().query(name, *args)


class Builds:
    """The two builds of each library, swapped into the wrappers by tag."""

    def __init__(self, variant_dir: Path):
        self.libs = {
            "variant": (VariantLibrary(_cuda.ADA_F32,
                                       variant_dir / "ada_f32.cu"),
                        VariantLibrary(_cuda.CA_F32,
                                       variant_dir / "ca_f32.cu")),
            "tree": (_cuda.ADA_F32, _cuda.CA_F32)}
        self.current = "tree"

    def use(self, tag: str) -> None:
        _cuda.ADA_F32, _cuda.CA_F32 = self.libs[tag]
        self.current = tag


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


def print_plan(dev, cases) -> None:
    resident = fa._dec_f32_resident(dev)
    for kind, Nq, _, Nk, label in cases:
        for way, plan in (
                ("forward", fa.f32_dec_fwd_plan(kind, cs.BM, Nq, Nk or Nq,
                                                resident)),
                ("backward", fa.f32_dec_plan(kind, cs.BM, Nq, Nk or Nq,
                                             resident))):
            print(f"{way} plan, {label}, {resident} SMs: ctas {plan.ctas}, "
                  f"query splits {plan.splits_q}; " + "; ".join(
                      f"{p.name} {p.ctas} CTAs over {len(p.items)} items, "
                      f"{p.waves} wave(s)" + (f", ranges {list(p.ranges)}"
                                              if p.ranges else "")
                      for p in plan.programs), flush=True)


def block_case(builds: Builds, dev, rng, kind, Nq, heads, Nk, label):
    """One shape: errors, bits, the timings in turns. Returns the per-call
    device ms by build, {"forward": {tag: ms}, "backward": {tag: ms}}."""
    leaves, call, (kernel, plain) = cs.decoder_case(rng, dev, kind, cs.BM, Nq,
                                                    64, heads, Nk)
    leaves = [t.detach().float().requires_grad_(True) for t in leaves]
    call.masks = tuple(m.detach().requires_grad_(True) for m in call.masks)
    every = [*leaves, *call.masks]
    g = torch.from_numpy(rng.normal(size=leaves[0].shape).astype(
        "float32")).to(dev)
    zero = (6, 14) if kind == "ca" else ()

    def grads(fn):
        y = call(fn, *leaves)
        return (y, *torch.autograd.grad(y, every, g))

    want = grads(plain)
    largest = max(float(t.abs().max()) for t in want[1:])

    def err(got):
        return max(float((a - b).abs().max()) / (
            largest if i - 1 in zero else float(b.abs().max()))
            for i, (a, b) in enumerate(zip(got, want)))

    def fwd():
        with torch.no_grad():
            return call(kernel, *leaves)

    with torch.no_grad():
        y_plain = call(plain, *leaves)
    errs, fwd_errs, ys = {}, {}, {}
    for tag in builds.libs:
        builds.use(tag)
        got = grads(kernel)
        errs[tag] = err(got)
        y = fwd()
        fwd_errs[tag] = float((y - y_plain).abs().max()
                              / y_plain.abs().max())
        ys[tag] = call(kernel, *leaves)
    builds.use("tree")
    same = all(torch.equal(a, b) for a, b in zip(grads(kernel),
                                                    grads(kernel)))
    same_fwd = torch.equal(fwd(), fwd())

    def bwd():
        return torch.autograd.grad(ys[builds.current], every, g,
                                   retain_graph=True)

    times = in_turns(builds, {
        "forward on the card": lambda: sum(device_ms(fwd).values()),
        "backward autograd call": lambda: cs.median_ms(bwd, 20, 5),
        "backward on the card": lambda: sum(device_ms(bwd).values())})
    kernels = {}
    for tag in builds.libs:
        builds.use(tag)
        kernels[tag] = {"forward": device_ms(fwd), "backward": device_ms(bwd)}
    builds.use("tree")
    with torch.no_grad():
        plain_fwd_ms = cs.median_ms(lambda: call(plain, *leaves), 5, 2)
    yp = call(plain, *leaves)
    plain_ms = cs.median_ms(lambda: torch.autograd.grad(
        yp, every, g, retain_graph=True), 5, 2)
    for name, per_tag in times.items():
        print(f"{label}: {name}: " + "; ".join(
            f"{tag} {fmt(ts)}" for tag, ts in per_tag.items()) + " ms",
            flush=True)
    for tag, ways in kernels.items():
        for way, ks in ways.items():
            print(f"{label}: {tag} {way} kernels: " + ", ".join(
                f"{k} {v:.4f}" for k, v in sorted(ks.items(),
                                                   key=lambda kv: -kv[1]))
                + " ms", flush=True)
    print(f"{label}: plain forward {plain_fwd_ms:.4f} ms, plain autograd "
          f"call {plain_ms:.4f} ms; forward vs plain: "
          + ", ".join(f"{tag} {e:.3g}" for tag, e in fwd_errs.items())
          + "; backward vs plain: "
          + ", ".join(f"{tag} {e:.3g}" for tag, e in errs.items())
          + f"; the tree's reruns give the same bits: forward {same_fwd}, "
          f"backward {same}", flush=True)
    del leaves, every, g, want, ys, yp, y_plain
    torch.cuda.empty_cache()
    return {way: {tag: statistics.median(ts)
                  for tag, ts in times[f"{way} on the card"].items()}
            for way in ("forward", "backward")}


def stage2_step(builds: Builds, dev) -> None:
    """Phase 13b's f32 Stage-2 step with each build, in turns."""
    from pmce_tpu_torch.smpl.layer import full_f32

    _, _, stage1 = cs.train(str(dev), False)
    with full_f32():
        cfg = cs.mesh_h36m_config(str(stage1["ckpt"]), True)
        cfg.MODEL.compute_dtype = "float32"
        trainer, batch, *_ = cs.stage2_parts(str(dev), stage1, cfg,
                                             "[compare]")
        state = trainer.init_state()
        gen = torch.Generator(dev).manual_seed(1)

        def step():
            trainer.train_step(state, batch, gen, 1.0)

        def kernel_ms():
            return sum(device_ms(step, 3).values())

        times = in_turns(builds, {
            "step": lambda: cs.median_step_ms(step, 10),
            "kernels": kernel_ms})
        for name, per_tag in times.items():
            print(f"f32 Stage-2 train step, batch {cs.BM}: {name} "
                  + "; ".join(f"{tag} {fmt(ts)}"
                              for tag, ts in per_tag.items()) + " ms",
                  flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("variant_dir", type=Path)
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--vertices", type=int, default=431)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("compare_dec_f32: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    builds = Builds(args.variant_dir.resolve())
    _cuda._build([lib for libs in builds.libs.values() for lib in libs])
    legacy = builds.libs["variant"][0].legacy
    print("variant entry points without a CTA count (grids of 64-row "
          f"chunks): {sorted(legacy) or 'none'}", flush=True)
    dev = torch.device("cuda", 0)
    cases = shapes(args.vertices)
    print_plan(dev, cases)
    rng = np.random.default_rng(22)
    per_call = [block_case(builds, dev, rng, *shape) for shape in cases]
    for way, per_step in PER_STEP.items():
        print(f"the decoder {way}s' device time a f32 Stage-2 step ("
              + ", ".join(f"{n} {label.split(' [')[0]}" for n, (*_, label)
                          in zip(per_step, cases)) + "): " + "; ".join(
                  f"{tag} "
                  f"{sum(n * c[way][tag] for n, c in zip(per_step, per_call)):.4f}"
                  " ms" for tag in builds.libs), flush=True)
    if args.step:
        stage2_step(builds, dev)


if __name__ == "__main__":
    main()
