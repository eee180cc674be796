"""Device time by kernel of the f32 training kernels on the card, and rows
4f / 5f against a variant source of ``csrc/mhsa_f32.cu``.

    python3 pmce_tpu_torch/tools/profile_f32.py [--variant VARIANT.cu]
    python3 pmce_tpu_torch/tools/profile_f32.py --chain [--variant VARIANT.cu]

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
and the two builds' bits compared. ``--chain`` times rows 3f and 14f
alone (the f32 decoder chain and whole block, ``csrc/coevo_f32.cu``, no
gradient): the chain at the f32 Stage-2 evaluation batch (64 clips of 17
joints and 431 vertices: ``chip_smoke.py`` phase 13b's
``TEST.batch_size``) and at the f32 serving batch (256 clips of 19
joints), the whole block at 256 clips of 19 joints. It prints the
wrappers' plan (``coevo_f32_plan``, the clusters the card holds at once),
the build's ptxas report (registers, stack, spills), each case's bound at
the 3xTF32 and the f32 FFMA rates, and per build the median wrapper time,
the device time by kernel and the largest difference from the plain
version relative to its largest magnitude. With ``--variant`` (an earlier
``coevo_f32.cu``, for example ``git show HEAD~1:pmce_tpu_torch/csrc/
coevo_f32.cu`` into a git-ignored directory; built with ``csrc/`` on its
include path; a source with the FFMA body's workspace entry points is
called as that body was) the variant and the tree are timed in turns
(variant, tree, tree, variant; 3 rounds) in one process; ``--variant``
given more than once times each in the same turns.
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


class CoevoVariant(_cuda.CudaLibrary):
    """A coevo_f32 source outside ``csrc/``, built beside the tree's; a
    source with the FFMA body's workspace entry points (``ffma``) keeps
    that body's signatures."""

    def __init__(self, src: Path):
        self.src = src
        self.ffma = "pmce_coevo_f32_workspace_bytes" in src.read_text()
        sigs = dict(_cuda.COEVO_F32.signatures)
        if self.ffma:
            P, I, F = _cuda.P, _cuda.I, _cuda.F
            sigs = {"pmce_coevo_f32_workspace_bytes": (_cuda.L, (I, I)),
                    "pmce_coevo_chain_f32": (I, (P,) * 7 + (I,) * 4
                                             + (F,) * 3 + (P,)),
                    "pmce_coevo_block_f32": (I, (P,) * 8 + (I,) * 3
                                             + (F,) * 3 + (P,))}
        super().__init__("coevo_f32", "pmce_coevo_f32_error_string", sigs)

    @property
    def path(self) -> Path:
        # Headers beside the variant come before csrc/'s on its include
        # path: both are part of its build.
        digest = hashlib.sha1(self.src.read_bytes())
        for f in (sorted(self.src.parent.glob("*.cuh"))
                  + sorted(_cuda.CSRC.glob("*.cuh"))):
            digest.update(f.read_bytes())
        name = f"coevo_f32_variant-{digest.hexdigest()[:12]}.so"
        return _cuda.BUILD_DIR / name

    def build_command(self):
        out = self.path
        tmp = out.with_suffix(".tmp")
        return ([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC),
                 "-o", str(tmp), str(self.src)], tmp, out)


def ffma_call(lib, kind, args):
    """The FFMA body's entry points, called as its wrappers did: the
    pointer table, a per-clip workspace, one CTA a clip."""
    from pmce_tpu_torch.ops import fused_coevo_chain as fc

    p = _cuda.ptr
    scales = (1.0 / 8 ** 0.5, 1.0 / 32 ** 0.5)  # heads of 8 and of 32
    if kind == "chain":
        joints, vertx, g, b, blocks = args[:5]
        B, J, _ = joints.shape
        V = vertx.shape[1]
        tab = fc._chain_table(blocks, vertx.device, 64, 256, J, V, True)
        ptrs = tab.device()
        jout = torch.empty(B, J, 3, device=vertx.device)
        vout = vertx.clone()
        ws = torch.empty(B * lib.query("pmce_coevo_f32_workspace_bytes", J, V),
                         device=vertx.device, dtype=torch.uint8)
        lib.call("pmce_coevo_chain_f32", p(joints), p(jout), p(vout), p(g),
                 p(b), p(ptrs), p(ws), B, J, V, len(blocks), 1e-6, *scales,
                 _cuda.stream_ptr(vertx.device))
        return jout, vout
    jf0, vf0, g, b, kp = args[:5]
    B, J, _ = jf0.shape
    V = vf0.shape[1]
    tab = fc._Table(vf0.device, 64, 256, True)
    tab.block(kp, J, V)
    ptrs = tab.device()
    jout, vout = torch.empty_like(jf0), torch.empty_like(vf0)
    ws = torch.empty(B * lib.query("pmce_coevo_f32_workspace_bytes", J, V),
                     device=vf0.device, dtype=torch.uint8)
    lib.call("pmce_coevo_block_f32", p(jf0), p(vf0), p(jout), p(vout), p(g),
             p(b), p(ptrs), p(ws), B, J, V, 1e-6, *scales,
             _cuda.stream_ptr(vf0.device))
    return jout, vout


def chain(dev, variants) -> None:
    """Rows 3f (the Stage-2 evaluation batch and the serving batch) and 14f
    (the serving batch), the tree's build and the variants' in turns."""
    from pmce_tpu_torch.ops import fused_coevo_chain as fc

    builds = {"tree": _cuda.COEVO_F32}
    for v in variants:
        tag = f"variant {v.parent.name}/{v.stem}"
        builds[tag] = CoevoVariant(v.resolve())
    _cuda._build(list(builds.values()))
    for tag, lib in builds.items():
        lib.load()
        log = lib.path.with_suffix(".log")
        report = [ln.strip() for ln in log.read_text().splitlines()
                  if "cf32" in ln or "Used" in ln or "spill" in ln]
        print(f"ptxas ({tag}, {lib.path.name}):\n  " + "\n  ".join(report),
              flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for s in (1, 2, 4, 8):
        print(f"clusters of {s} CTAs the card holds at once: "
              f"{_cuda.COEVO_F32.query('pmce_coevo_f32_clusters', s)}",
              flush=True)

    def run(tag, kind, args):
        if tag != "tree" and builds[tag].ffma:
            return ffma_call(builds[tag], kind, args)
        saved = _cuda.COEVO_F32
        _cuda.COEVO_F32 = builds[tag]
        try:
            return (fc.coevo_chain if kind == "chain" else fc.coevo_block)(
                *args)
        finally:
            _cuda.COEVO_F32 = saved

    cases = (("chain", 64, cs.JT), ("chain", cs.B, cs.J),
             ("block", cs.B, cs.J))
    for kind, batch, joints in cases:
        cs.J = joints  # chain_case's and coevo_block_case's joint count
        r = cs.Inputs(13, dev)
        if kind == "chain":
            jt, vx, g, b, blocks, hj, hv = cs.chain_case(r, batch)
            blocks = tuple((blk[0].float(), blk[1], blk[2].float(), *blk[3:])
                           for blk in blocks)
            args = (jt, vx, g, b, blocks, hj, hv)
            plain = fc.coevo_chain_plain
        else:
            jf0, vf0, g, b, kp, hj, hv = cs.coevo_block_case(r, batch)
            args = (jf0.float(), vf0.float(), g, b, kp, hj, hv)
            plain = fc.coevo_block_plain
        plan = fa.coevo_f32_plan(batch, joints, 431, sms)
        row = "3f" if kind == "chain" else "14f"
        with torch.no_grad():
            want = plain(*args)
            flops = cs.count_flops(lambda: plain(*args))
            nbytes = cs.tensor_bytes(args, want)
            tf32_ms, _ = cs.bound(flops, nbytes, "tf32x3")
            ffma_ms, _ = cs.bound(flops, nbytes, "f32")
            print(f"row {row} B={batch} J={joints} V=431: {plan}; bound "
                  f"{tf32_ms:.4f} ms at 3xTF32, {ffma_ms:.4f} ms at the f32 "
                  f"FFMA peak ({flops / 1e9:.2f} GFLOP); plain "
                  f"{cs.median_ms(lambda: plain(*args), 5, 2):.4f} ms",
                  flush=True)
            times = {tag: [] for tag in builds}
            kernels, errs, outs = {}, {}, {}
            others = [tag for tag in builds if tag != "tree"]
            order = (others + ["tree", "tree"] + others[::-1]) * 3
            for tag in order:
                got = run(tag, kind, args)
                again = run(tag, kind, args)
                torch.cuda.synchronize()
                errs[tag] = (max(float((a - w).abs().max() / w.abs().max())
                                 for a, w in zip(got, want)),
                             all(torch.equal(a, c)
                                 for a, c in zip(got, again)))
                outs[tag] = got
                times[tag].append(cs.median_ms(lambda: run(tag, kind, args),
                                               20, 5))
                kernels[tag] = device_ms(lambda: run(tag, kind, args))
            for tag in builds:
                show(f"row {row} B={batch} J={joints} {tag} (vs plain "
                     f"{errs[tag][0]:.3g}, a rerun bit for bit: "
                     f"{errs[tag][1]}; median of {len(times[tag])} rounds: "
                     + ", ".join(f"{t:.4f}" for t in times[tag]) + ")",
                     statistics.median(times[tag]), kernels[tag])
        del args, want, outs
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", type=Path, action="append", default=[])
    ap.add_argument("--chain", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_f32: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    if args.chain:
        chain(dev, args.variant)
        return
    builds = {"tree": _cuda.MHSA_F32}
    if args.variant:
        builds["variant"] = VariantLibrary(args.variant[0].resolve())
    _cuda._build([_cuda.BLOCK_F32, *builds.values()])
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
