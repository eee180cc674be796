"""Rows K3 / 14 (the decoder chain and whole block in bf16) and 3f / 14f
(in f32) on the card: their plans, the shipped 431 vertices against a
variant's sources in turns, and the two-level coarsening's 1723.

    python3 pmce_tpu_torch/tools/profile_coevo.py [--variant VARIANT_DIR]
        [--vertices 431 1723] [--rounds 3]

VARIANT_DIR holds another version's ``coevo_chain.cu``,
``coevo_block.cu`` and ``coevo_ops.cuh`` and / or ``coevo_f32.cu`` (a
source it does not hold is the tree's alone; e.g. ``for f
in coevo_chain.cu coevo_block.cu coevo_ops.cuh coevo_f32.cu; do git show
HEAD~1:pmce_tpu_torch/csrc/$f > _variants/parent/$f; done``, a git-ignored
directory); each is built with the port's nvcc flags, VARIANT_DIR before
``csrc/`` on the include path, into its own library under
``pmce_tpu_torch/_build/``. A variant whose bf16 entry points take no
cluster size (one CTA a clip, the sources before the cluster program) is
called as its wrappers called it. TF32 off throughout.

Cases: the chain at the serving batch (256 clips of 19 joints) and at the
Stage-2 evaluation batch (64 clips of 17 joints), the whole block at the
serving batch, each in bf16 (rows K3, 14) and f32 (3f, 14f). It prints
the builds' ptxas reports (registers, stack, spills), the clusters of S
CTAs the card holds at once (both bf16 libraries' ``pmce_coevo_clusters``,
``pmce_coevo_f32_clusters``), then per
case and vertex count the wrappers' plan (``coevo_plan``,
``coevo_f32_plan``: S, each rank's rows, CTAs, clusters, waves), the
bound (the plain version's products by PyTorch's flop counter at the bf16
or 3xTF32 rate, the inputs and outputs once at the HBM rate; the f32 FFMA
bound beside), the plain version's time (at 1723 and 256 clips: over
chunks of 32 clips, as ``chip_smoke.plain_by_clips``), and per build over
``--rounds`` rounds in turns (variant, tree, tree, variant; at a V the
variant's plan does not take, the tree alone): the kernel's device time a call
(``torch.profiler`` over 5 calls), the median of 10 CUDA-event-timed
calls of the entry point after 3 warm-ups, the largest difference from
the plain version relative to its largest magnitude, whether a rerun
gives the same bits and whether the tree's outputs equal the variant's
bit for bit.
"""

from __future__ import annotations

import argparse
import hashlib
import math
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from pmce_tpu_torch.ops import _cuda  # noqa: E402
from pmce_tpu_torch.ops import fused_attention as fa  # noqa: E402
from pmce_tpu_torch.ops import fused_coevo_chain as fc  # noqa: E402
from pmce_tpu_torch.tools.profile_f32 import device_ms  # noqa: E402

LIBS = {"coevo_chain": "CHAIN", "coevo_block": "COEVO_BLOCK",
        "coevo_f32": "COEVO_F32"}


class Variant(_cuda.CudaLibrary):
    """One of VARIANT_DIR's sources, built beside the tree's; ``one_cta``:
    its bf16 entry points take no cluster size."""

    def __init__(self, vdir: Path, source: str):
        self.vdir = vdir
        tree = getattr(_cuda, LIBS[source])
        sigs = dict(tree.signatures)
        text = (vdir / f"{source}.cu").read_text()
        self.one_cta = source != "coevo_f32" and "int S," not in text
        # The most vertices the variant's plan takes.
        self.max_v = (450 if self.one_cta else 1024 if source == "coevo_f32"
                      and "MAX_S = 16" not in text else 2048)
        if self.one_cta:
            P, I, F = _cuda.P, _cuda.I, _cuda.F
            n_ptr = 7 if source == "coevo_chain" else 8
            n_int = 4 if source == "coevo_chain" else 3
            sigs = {k: v for k, v in sigs.items() if "cluster" not in k}
            entry = ("pmce_coevo_chain" if source == "coevo_chain"
                     else "pmce_coevo_block")
            sigs[entry] = (I, (P,) * n_ptr + (I,) * n_int + (F,) * 3 + (P,))
        super().__init__(source, tree.error_fn, sigs)

    @property
    def path(self) -> Path:
        digest = hashlib.sha1((self.vdir / f"{self.source}.cu").read_bytes())
        for f in (sorted(self.vdir.glob("*.cuh"))
                  + sorted(_cuda.CSRC.glob("*.cuh"))):
            digest.update(f.read_bytes())
        return _cuda.BUILD_DIR / (f"{self.source}_variant-"
                                  f"{digest.hexdigest()[:12]}.so")

    def build_command(self):
        out = self.path
        tmp = out.with_suffix(".tmp")
        return ([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(self.vdir), "-I",
                 str(_cuda.CSRC), "-o", str(tmp),
                 str(self.vdir / f"{self.source}.cu")], tmp, out)


def one_cta_call(lib, kind, args):
    """A variant's bf16 entry point without a cluster size, called as its
    wrappers did: the pointer table, B clips' joint workspace."""
    p = _cuda.ptr
    scales = (1.0 / math.sqrt(8), 1.0 / math.sqrt(32))
    dev = args[0].device
    stream = _cuda.stream_ptr(dev)
    if kind == "chain":
        joints, vertx, g, b, blocks = args[:5]
        B, J, _ = joints.shape
        V = vertx.shape[1]
        tab = fc._chain_table(blocks, dev, 64, 256, J, V, False)
        ptrs = tab.device()  # tab keeps the weights' copies alive
        jout = torch.empty(B, J, 3, device=dev)
        vout = vertx.clone()
        ws = torch.empty(B * lib.query("pmce_chain_workspace_bytes", J),
                         device=dev, dtype=torch.uint8)
        lib.call("pmce_coevo_chain", p(joints), p(jout), p(vout), p(g), p(b),
                 p(ptrs), p(ws), B, J, V, len(blocks), 1e-6, *scales, stream)
        return jout, vout
    jf0, vf0, g, b, kp = args[:5]
    B, J, _ = jf0.shape
    V = vf0.shape[1]
    tab = fc._Table(dev, 64, 256)
    tab.block(kp, J, V)
    ptrs = tab.device()
    jout, vout = torch.empty_like(jf0), torch.empty_like(vf0)
    ws = torch.empty(B * lib.query("pmce_coevo_block_workspace_bytes", J),
                     device=dev, dtype=torch.uint8)
    lib.call("pmce_coevo_block", p(jf0), p(vf0), p(jout), p(vout), p(g),
             p(b), p(ptrs), p(ws), B, J, V, 1e-6, *scales, stream)
    return jout, vout


def case_args(kind: str, f32: bool, batch: int, joints: int, V: int, dev):
    """``chip_smoke``'s chain / whole-block inputs (seed 13), cast to f32
    for rows 3f / 14f."""
    r = cs.Inputs(13, dev)
    if kind == "chain":
        jt, vx, g, b, blocks, hj, hv = cs.chain_case(r, batch, V=V,
                                                     joints=joints)
        if f32:
            blocks = tuple((blk[0].float(), blk[1], blk[2].float(), *blk[3:])
                           for blk in blocks)
        return (jt, vx, g, b, blocks, hj, hv)
    jf0, vf0, g, b, kp, hj, hv = cs.coevo_block_case(r, batch, V=V,
                                                     joints=joints)
    if f32:
        jf0, vf0 = jf0.float(), vf0.float()
    return (jf0, vf0, g, b, kp, hj, hv)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", type=Path)
    ap.add_argument("--vertices", type=int, nargs="+", default=[431, 1723])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_coevo: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    vdir = args.variant.resolve() if args.variant else None
    variants = {s: Variant(vdir, s) for s in LIBS
                if vdir is not None and (vdir / f"{s}.cu").is_file()}
    trees = {s: getattr(_cuda, n) for s, n in LIBS.items()}
    _cuda._build([*trees.values(), *variants.values()])
    for tag, libs in (("tree", trees), ("variant", variants)):
        for lib in libs.values():
            lib.load()
            log = lib.path.with_suffix(".log").read_text().splitlines()
            keep = [ln.strip() for ln in log
                    if "Compiling entry" in ln or "Used" in ln
                    or "spill" in ln]
            print(f"ptxas ({tag}, {lib.path.name}):\n  " + "\n  ".join(keep),
                  flush=True)
    for V in args.vertices:
        for J in (17, 19):
            for S in (2, 4, 8):
                smem = _cuda.CHAIN.query("pmce_coevo_cluster_smem_bytes", J,
                                         V, S)
                held = [lib.query("pmce_coevo_clusters", J, V, S)
                        for lib in (_cuda.CHAIN, _cuda.COEVO_BLOCK)]
                print(f"bf16 V={V} J={J} S={S}: a rank's shared memory "
                      f"{smem} B; clusters the card holds: chain {held[0]}, "
                      f"whole block {held[1]}", flush=True)
    for s in (1, 2, 4, 8, 16):
        print(f"f32: clusters of {s} CTAs the card holds at once: "
              f"{_cuda.COEVO_F32.query('pmce_coevo_f32_clusters', s)}",
              flush=True)

    def run(tag, kind, f32, call_args):
        fn = fc.coevo_chain if kind == "chain" else fc.coevo_block
        if tag == "tree":
            return fn(*call_args)
        lib = variants["coevo_f32" if f32 else f"coevo_{kind}"]
        if lib.one_cta:
            return one_cta_call(lib, kind, call_args)
        name = LIBS[lib.source]
        saved = getattr(_cuda, name)
        setattr(_cuda, name, lib)
        try:
            return fn(*call_args)
        finally:
            setattr(_cuda, name, saved)

    cases = (("chain", cs.B, cs.J), ("chain", 64, cs.JT),
             ("block", cs.B, cs.J))
    for f32 in (False, True):
        for V in args.vertices:
            for kind, batch, joints in cases:
                row = {("chain", False): "K3", ("block", False): "14",
                       ("chain", True): "3f", ("block", True): "14f"}[
                           (kind, f32)]
                call_args = case_args(kind, f32, batch, joints, V, dev)
                plain = (fc.coevo_chain_plain if kind == "chain"
                         else fc.coevo_block_plain)
                plan = (fa.coevo_f32_plan(batch, joints, V, sms) if f32
                        else fc.coevo_plan(batch, joints, V, sms))
                with torch.no_grad():
                    want = cs.plain_by_clips(plain, call_args)
                    flops = cs.count_flops(
                        lambda: cs.plain_by_clips(plain, call_args))
                    nbytes = cs.tensor_bytes(call_args, want)
                    peak = "tf32x3" if f32 else "bf16"
                    bound_ms, by = cs.bound(flops, nbytes, peak)
                    plain_ms = cs.median_ms(
                        lambda: cs.plain_by_clips(plain, call_args), 3, 1)
                tag = f"row {row} B={batch} J={joints} V={V}"
                ffma = (f", f32 FFMA {cs.bound(flops, nbytes, 'f32')[0]:.4f}"
                        if f32 else "")
                print(f"{tag}: {plan}; bound {bound_ms:.4f} ms by {by} "
                      f"({flops / 1e9:.2f} GFLOP{ffma}); plain "
                      f"{plain_ms:.4f} ms; on {card}", flush=True)
                var = variants.get("coevo_f32" if f32 else f"coevo_{kind}")
                builds = (["variant", "tree"] if var is not None
                          and V <= var.max_v else ["tree"])
                order = (builds[::-1] + builds) * args.rounds
                times = {b: [] for b in builds}
                dev_ms = {b: [] for b in builds}
                outs = {}
                with torch.no_grad():
                    for b in order:
                        got = run(b, kind, f32, call_args)
                        again = run(b, kind, f32, call_args)
                        torch.cuda.synchronize()
                        rel = max(float((a.float() - w.float()).abs().max()
                                        / w.float().abs().max())
                                  for a, w in zip(got, want))
                        same = all(torch.equal(a, c)
                                   for a, c in zip(got, again))
                        outs[b] = (got, rel, same)
                        times[b].append(cs.median_ms(
                            lambda: run(b, kind, f32, call_args), 10, 3))
                        kern = device_ms(lambda: run(b, kind, f32,
                                                     call_args))
                        dev_ms[b].append(sum(
                            v for k, v in kern.items() if "coevo" in k
                            or "chain" in k or "block" in k))
                for b in builds:
                    got, rel, same = outs[b]
                    print(f"{tag} {b}: on the card "
                          f"{statistics.median(dev_ms[b]):.4f} ms ("
                          + ", ".join(f"{t:.4f}" for t in dev_ms[b])
                          + f"), entry point "
                          f"{statistics.median(times[b]):.4f} ms ("
                          + ", ".join(f"{t:.4f}" for t in times[b])
                          + f"); vs plain {rel:.3g}; a rerun bit for bit: "
                          f"{same}", flush=True)
                if "variant" in outs:
                    equal = all(torch.equal(a, c) for a, c in zip(
                        outs["tree"][0], outs["variant"][0]))
                    print(f"{tag}: tree and variant bit for bit: {equal}",
                          flush=True)
                del call_args, want, outs
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
