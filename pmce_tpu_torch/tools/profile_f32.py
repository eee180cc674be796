"""Device time by kernel of the f32 training kernels on the card, and rows
4f / 5f and the f32 weight-gradient launch against a variant's sources.

    python3 pmce_tpu_torch/tools/profile_f32.py [--variant VARIANT_DIR]

At the main paths' shapes (rows 6f / 7f: the Stage-1 spatial [1024, 17,
256] and temporal [1088, 16, 256] blocks, hid 512, the post-norm, branch
masks at rate 0.2; rows 4f / 5f: the f32 joint stream's [32, 17, 64] and
[32, 19, 64] in heads of 8; TF32 off) it prints the median of 20
CUDA-event-timed calls of each wrapper (6f / 7f: the forward, the backward
as the autograd call) after 5 warm-ups, and each kernel's device time a
call from ``torch.profiler`` over 5 calls. Rows 4f / 5f: the forward with a
gradient owed (saving) and without, and the backward's one call (its tile
program and its weight gradients apart, by kernel), each against the plain
version (the output and every gradient relative to its largest magnitude).
The weight-gradient launch of ``csrc/f32_ops.cuh`` alone (a small entry
point built over the header: ``WGRAD_PROBE``) at the jobs of row 7f at
Stage 1 (M = 17,408: dW of [256, 768], [256, 256], [256, 512], [512, 256]
with the vector sums over 132 tiles), row 9f ([32, 431]: [64, 192],
[64, 64], [64, 256], [256, 64]), row 11f both ways (the query side's four
jobs and the key side's two, at 544 / 13,792 rows) and row 5f, each
against an f64 product; the 3xTF32 and the FFMA bounds beside. With
``--variant VARIANT_DIR`` (a git-ignored directory holding an earlier
``mhsa_f32.cu`` and ``f32_ops.cuh``, e.g. ``for f in mhsa_f32.cu
f32_ops.cuh; do git show HEAD~1:pmce_tpu_torch/csrc/$f >
_variants/parent/$f; done``; built with VARIANT_DIR before ``csrc/`` on
the include path) both are timed in turns with the tree (variant, tree,
tree, variant; 3 rounds) in one process; a variant whose entry points take
no CTA count (the FFMA bodies, a CTA a clip, transposed weight copies in
their workspace) is called as their wrappers did. The builds' ptxas
reports (registers, stack, spills) are printed first. Rows 3f and 14f
(the f32 decoder chain and whole block) are timed by
``tools/profile_coevo.py``.
"""

from __future__ import annotations

import argparse
import ctypes
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


class VariantLibrary(_cuda.CudaLibrary):
    """A variant's ``mhsa_f32.cu`` built beside the tree's, the headers of
    its directory first on the include path; ``ffma``: its entry points
    take no CTA count (the FFMA bodies' signatures)."""

    def __init__(self, vdir: Path):
        self.vdir = vdir
        self.src = vdir / "mhsa_f32.cu"
        self.ffma = re.search(r"pmce_mhsa_fwd_f32\([^)]*\bctas\b",
                              self.src.read_text()) is None
        sigs = _cuda.MHSA_F32.signatures
        if self.ffma:
            sigs = {name: (rt, args[:-2] + args[-1:])
                    for name, (rt, args) in sigs.items()}
        super().__init__("mhsa_f32", "pmce_mhsa_f32_error_string", sigs)

    @property
    def path(self) -> Path:
        digest = _digest(self.src, self.vdir)
        return _cuda.BUILD_DIR / f"mhsa_f32_variant-{digest}.so"

    def build_command(self):
        out = self.path
        tmp = out.with_suffix(".tmp")
        return ([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(self.vdir),
                 "-I", str(_cuda.CSRC), "-o", str(tmp), str(self.src)], tmp,
                out)


def _digest(src, vdir) -> str:
    digest = hashlib.sha1(src.encode() if isinstance(src, str)
                          else src.read_bytes())
    for d in ([vdir] if vdir is not None else []) + [_cuda.CSRC]:
        for f in sorted(d.glob("*.cuh")):
            digest.update(f.read_bytes())
    return digest.hexdigest()[:12]


# The weight-gradient launch alone: csrc/f32_ops.cuh's launch_wgrad over a
# table of (A, dY, dW) pointers per job, the range partials, the vector
# partials and their sum; the same source builds over any f32_ops.cuh that
# has the Jobs description.
WGRAD_PROBE = r"""
#include "common.cuh"
#include "f32_ops.cuh"
extern "C" int pmce_f32_wgrad_probe(void* const* p, int n, const int* dims,
                                    int M, int splits, int vtiles, int vlen,
                                    void* stream) {
  f32ops::Jobs J = {};
  for (int i = 0; i < n; ++i) {
    J.job[i].A = static_cast<const float*>(p[3 * i]);
    J.job[i].Y = static_cast<const float*>(p[3 * i + 1]);
    J.job[i].out = static_cast<float*>(p[3 * i + 2]);
    J.job[i].K = dims[2 * i];
    J.job[i].Ncol = dims[2 * i + 1];
  }
  J.n = n;
  J.M = M;
  J.splits = splits;
  J.ws = static_cast<float*>(p[3 * n]);
  J.vpart = static_cast<const float*>(p[3 * n + 1]);
  J.vout = static_cast<float*>(p[3 * n + 2]);
  J.vtiles = vtiles;
  J.vlen = vlen;
  return static_cast<int>(
      f32ops::launch_wgrad(J, static_cast<cudaStream_t>(stream)));
}
PMCE_EXPORT_ERROR_STRING(pmce_f32_wgrad_probe_error)
"""


class WgradProbe(_cuda.CudaLibrary):
    """``WGRAD_PROBE`` built over the tree's ``f32_ops.cuh`` (``vdir``
    None) or a variant directory's."""

    def __init__(self, vdir: Path | None):
        P, I = _cuda.P, _cuda.I
        super().__init__("wgrad_probe", "pmce_f32_wgrad_probe_error", {
            "pmce_f32_wgrad_probe": (I, (P, I, P, I, I, I, I, P))})
        self.vdir = vdir
        # An FFMA-era header (64 x 64 tiles, no CTA tiles of its own) is
        # called with its wrappers' row ranges, min(16, M / 64).
        self.ffma = vdir is not None and "tfirst" not in (
            vdir / "f32_ops.cuh").read_text()

    @property
    def path(self) -> Path:
        tag = "variant" if self.vdir is not None else "tree"
        return (_cuda.BUILD_DIR
                / f"wgrad_probe_{tag}-{_digest(WGRAD_PROBE, self.vdir)}.so")

    def build_command(self):
        src = self.path.with_suffix(".cu")
        src.write_text(WGRAD_PROBE)
        out = self.path
        tmp = out.with_suffix(".tmp")
        inc = ([] if self.vdir is None else ["-I", str(self.vdir)]) + [
            "-I", str(_cuda.CSRC)]
        return ([_cuda._nvcc(), *_cuda.NVCC_FLAGS, *inc, "-o", str(tmp),
                 str(src)], tmp, out)


def ptxas_report(tag: str, lib) -> None:
    log = lib.path.with_suffix(".log")
    keep = [ln.strip() for ln in log.read_text().splitlines()
            if "entry function" in ln or "Used" in ln or "spill" in ln]
    print(f"ptxas ({tag}, {lib.path.name}):\n  " + "\n  ".join(keep),
          flush=True)


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
    ap.add_argument("--variant", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_f32: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    vdir = args.variant.resolve() if args.variant else None
    builds = {"tree": _cuda.MHSA_F32}
    probes = {"tree": WgradProbe(None)}
    if vdir is not None:
        builds["variant"] = VariantLibrary(vdir)
        probes["variant"] = WgradProbe(vdir)
    _cuda._build([_cuda.BLOCK_F32, *builds.values(), *probes.values()])
    for tag in builds:
        ptxas_report(f"{tag} mhsa_f32", builds[tag])
        ptxas_report(f"{tag} weight gradients", probes[tag])
    turns = (["variant", "tree", "tree", "variant"] * 3 if vdir is not None
             else ["tree"] * 3)
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
        mhsa_rows(dev, rng, N, builds, turns)
    for label, sides in wgrad_cases():
        wgrad_case(dev, label, sides, probes, turns)


def mhsa_calls(lib, leaves, g, heads: int):
    """(forward saving, forward without a gradient, backward) of a build
    of ``csrc/mhsa_f32.cu``: the tree's through its wrappers, an FFMA
    body's as its wrappers called it."""
    x, wqkv, bqkv, wproj, bproj = (t.detach() for t in leaves)
    if not getattr(lib, "ffma", False):
        def fwd(grad):
            saved = _cuda.MHSA_F32
            _cuda.MHSA_F32 = lib
            try:
                return fa._mhsa_fwd_f32_cuda(x, wqkv, bqkv, wproj, bproj,
                                             heads, grad)
            finally:
                _cuda.MHSA_F32 = saved

        def bwd(saved_state):
            saved = _cuda.MHSA_F32
            _cuda.MHSA_F32 = lib
            try:
                dx, (dwqkv, dbqkv, dwproj, dbproj) = fa._mhsa_bwd_f32_cuda(
                    g, x, wqkv, wproj, saved_state, heads)
            finally:
                _cuda.MHSA_F32 = saved
            return dx, dwqkv, dbqkv, dwproj, dbproj
        return fwd, bwd

    clips, N, C = x.shape
    M, qscale = clips * N, 1.0 / (C // heads) ** 0.5
    stream = _cuda.stream_ptr(x.device)

    def buf(*shape):
        return torch.empty(*shape, device=x.device, dtype=torch.float32)

    def fwd(grad):
        out, qkv = torch.empty_like(x), buf(M, 3 * C)
        o = buf(M, C) if grad else None
        lib.call("pmce_mhsa_fwd_f32", _cuda.ptr_table(
            x, wqkv, bqkv, wproj, bproj, out, qkv, o), clips, N, C, heads,
            qscale, stream)
        return out, (qkv, o)

    def bwd(saved_state):
        splits = min(16, max(1, M // 64))  # the FFMA bodies' ranges
        ws = (buf(3 * C, C), buf(C, C), buf(M, 3 * C), buf(clips, 4 * C),
              buf(splits, 4 * C * C // 4096, 4096))
        dx, dwqkv, dwproj, dbias = (torch.empty_like(x), buf(C, 3 * C),
                                    buf(C, C), buf(4 * C))
        lib.call("pmce_mhsa_bwd_f32", _cuda.ptr_table(
            g, x, wqkv, wproj, *saved_state, *ws, dx, dwqkv, dwproj, dbias),
            clips, N, C, heads, qscale, splits, stream)
        return dx, dwqkv, dbias[:3 * C], dwproj, dbias[3 * C:]
    return fwd, bwd


def mhsa_rows(dev, rng, N: int, builds: dict, turns) -> None:
    """Rows 4f / 5f at [BM, N, 64] in 8 heads, every build in turns."""
    leaves, g = mhsa_case(rng, dev, N)
    y = fa.mhsa_plain(*leaves, 8)
    want = (y.detach(), *torch.autograd.grad(y, leaves, g))
    flops_f = cs.count_flops(lambda: fa.mhsa_plain(*leaves, 8))
    flops_b = cs.count_flops(lambda: torch.autograd.grad(
        fa.mhsa_plain(*leaves, 8), leaves, g))
    for row, fl, nb in (("4f", flops_f, cs.tensor_bytes(leaves, y)),
                        ("5f", flops_b - flops_f,
                         cs.tensor_bytes(g, leaves, want[1:]))):
        print(f"row {row} [{cs.BM}, {N}, 64]: bound "
              f"{cs.bound(fl, nb, 'tf32x3')[0]:.5f} ms at 3xTF32, "
              f"{cs.bound(fl, nb, 'f32')[0]:.5f} at the f32 FFMA peak "
              f"({fl / 1e6:.1f} MFLOP, {nb / 1e6:.2f} MB)", flush=True)
    calls = {tag: mhsa_calls(lib, leaves, g, 8) for tag, lib in builds.items()}
    parts = ("4f saving", "4f no gradient", "5f")
    times = {tag: {k: [] for k in parts} for tag in builds}
    kernels = {}
    for tag in turns:
        fwd, bwd = calls[tag]
        out, saved = fwd(True)
        got = (out, *bwd(saved))
        again = (fwd(True)[0], *bwd(fwd(True)[1]))
        torch.cuda.synchronize()
        errs = [float((a - w).abs().max() / w.abs().max())
                for a, w in zip(got, want)]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        fns = {"4f saving": lambda: fwd(True),
               "4f no gradient": lambda: fwd(False),
               "5f": lambda: bwd(saved)}
        for k, fn in fns.items():
            times[tag][k].append(cs.median_ms(fn, 20, 5))
        kernels[tag] = {k: device_ms(fn) for k, fn in fns.items()}
        kernels[tag]["errs"] = (errs, same)
    for tag in builds:
        errs, same = kernels[tag]["errs"]
        print(f"rows 4f / 5f [{cs.BM}, {N}, 64] {tag}: vs plain out "
              f"{errs[0]:.3g}, gradients {max(errs[1:]):.3g}; a rerun bit "
              f"for bit: {same}", flush=True)
        for k in parts:
            show(f"row {k} [{cs.BM}, {N}, 64] {tag} (median of "
                 f"{len(times[tag][k])} rounds: "
                 + ", ".join(f"{t:.4f}" for t in times[tag][k]) + ")",
                 statistics.median(times[tag][k]), kernels[tag][k])


def wgrad_cases():
    """(label, sides): each side (M, [(K, Ncol), ...], vtiles, vlen) one
    launch_wgrad call, as rows 7f, 9f, 11f and 5f make them."""
    m1 = cs.BT * cs.T * cs.JT  # 17,408 rows at Stage 1
    mq, mk = cs.BM * cs.JT, cs.BM * 431
    c, hid = 64, 256
    dec = [(c, c), (c, c), (c, hid), (hid, c)]
    return (("row 7f, Stage 1 [17,408 rows]",
             [(m1, [(256, 768), (256, 256), (256, 512), (512, 256)], 132,
               fa._block_vec_layout(256, 512)[1])]),
            ("row 9f [32, 431]",
             [(mk, [(c, 3 * c), (c, c), (c, hid), (hid, c)], 0, 0)]),
            ("row 11f joints over vertices",
             [(mq, dec, 0, 0), (mk, [(c, c), (c, c)], 0, 0)]),
            ("row 11f vertices over joints",
             [(mk, dec, 0, 0), (mq, [(c, c), (c, c)], 0, 0)]),
            ("row 5f [32, 17, 64]",
             [(mq, [(c, 3 * c), (c, c)], 2 * cs.BM, 4 * c)]))


def wgrad_case(dev, label, sides, probes, turns, splits_of=None) -> None:
    """One row's weight-gradient launches, every build in turns, against
    f64 products; each launch's row ranges ``splits_of(M, jobs)`` (by
    default the tree's plan, :func:`fa.f32_wgrad_plan`)."""
    if splits_of is None:
        def splits_of(M, jobs):
            return fa.f32_wgrad_splits(M, jobs, dev)
    gen = torch.Generator(device=dev).manual_seed(len(label))
    calls, wants, flops, nbytes = [], [], 0, 0
    for M, jobs, vtiles, vlen in sides:
        ffma = min(16, max(1, M // 64))
        splits = splits_of(M, jobs)
        tensors, dims, outs = [], [], []
        for K, n in jobs:
            a = torch.randn(M, K, device=dev, generator=gen)
            y = torch.randn(M, n, device=dev, generator=gen)
            out = torch.empty(K, n, device=dev)
            tensors += [a, y, out]
            dims += [K, n]
            outs.append(out)
            wants.append(a.double().t() @ y.double())
            flops += 2 * M * K * n
            nbytes += 4 * (M * (K + n) + K * n)
        ws = torch.empty(max(splits, ffma),
                         sum(k * n for k, n in jobs) // 4096, 4096,
                         device=dev)
        vp = (torch.randn(vtiles, vlen, device=dev, generator=gen)
              if vlen else None)
        vo = torch.empty(vlen, device=dev) if vlen else None
        table = _cuda.ptr_table(*tensors, ws, vp, vo)
        arr = (ctypes.c_int * len(dims))(*dims)
        calls.append((table, arr, len(jobs), M, splits, ffma, vtiles, vlen,
                      outs, tensors, ws, vp, vo))
    stream = _cuda.stream_ptr(dev)

    def run(lib):
        got = []
        for table, arr, n, M, splits, ffma, vtiles, vlen, outs, *_ in calls:
            lib.call("pmce_f32_wgrad_probe", table, n,
                     ctypes.cast(arr, ctypes.c_void_p), M,
                     ffma if lib.ffma else splits, vtiles, vlen, stream)
            got += outs
        return got

    print(f"weight gradients, {label}: {len(wants)} jobs over "
          f"{[s[0] for s in sides]} rows, row ranges "
          f"{[c[4] for c in calls]} (an FFMA-era header's "
          f"{[c[5] for c in calls]}); bound "
          f"{cs.bound(flops, nbytes, 'tf32x3')[0]:.4f} ms at 3xTF32, "
          f"{cs.bound(flops, nbytes, 'f32')[0]:.4f} at the f32 FFMA peak "
          f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)", flush=True)
    times = {tag: [] for tag in probes}
    kernels, errs = {}, {}
    for tag in turns:
        lib = probes[tag]
        got = [t.clone() for t in run(lib)]
        again = run(lib)
        torch.cuda.synchronize()
        errs[tag] = (max(float((a.double() - w).abs().max() / w.abs().max())
                         for a, w in zip(got, wants)),
                     all(torch.equal(a, b) for a, b in zip(got, again)))
        times[tag].append(cs.median_ms(lambda: run(lib), 20, 5))
        kernels[tag] = device_ms(lambda: run(lib))
    for tag in probes:
        show(f"weight gradients, {label}, {tag} (vs f64 {errs[tag][0]:.3g}, "
             f"a rerun bit for bit: {errs[tag][1]}; median of "
             f"{len(times[tag])} rounds: "
             + ", ".join(f"{t:.4f}" for t in times[tag]) + ")",
             statistics.median(times[tag]), kernels[tag])
    del calls, wants
    torch.cuda.empty_cache()

if __name__ == "__main__":
    main()
