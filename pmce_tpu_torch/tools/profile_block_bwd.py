"""Where the lifter block (rows 6 and 7) and the decoder's cross-attention
block backward (row 11) spend their time on the card.

    python3 pmce_tpu_torch/tools/profile_block_bwd.py [--root DIR] [--tag T]
        [--rows block,ca]

Imports ``pmce_tpu_torch`` from ``DIR`` (default: the tree this script is
in; an unpacked earlier commit, say) and builds its block library. At the
Stage-1 training step's two shapes, with the shared post-norm and f32
weights as ``chip_smoke.py``'s ``block_case`` makes them:
``[1024, 17, 256]`` (block 0's spatial half, no masks) and
``[1088, 16, 256]`` (block 2's temporal half, drop-path rate 0.2), it
prints for the backward wrapper ``_block_bwd_cuda`` (one call: every launch
of the backward, no autograd around it):

- ``wrapper ms``: CUDA events around 20 back-to-back calls after 5
  warm-ups, per call;
- ``host ms``: the host's time in one call, from an idle card (the median
  of 20 calls, each after a synchronise), i.e. the Python and ctypes work
  that enqueues the launches;
- the device time of each kernel it launches (``torch.profiler`` over 5
  calls; launches and ms per call), and their sum.

The same for the forward wrapper ``_block_fwd_cuda`` (``fwd``); where
the tree has the backward's tile program, its clock64() stage split
(``block_bwd_stage_split``: each stage's share of the cycles summed over
the tiles, and the cycles a tile). Every
line starts with ``[TAG]`` and the card's name and power limit are printed
first, so that two trees' runs in one call can be told apart.

``--rows ca`` adds the cross-attention block's backward wrapper
``_ca_bwd_cuda`` (row 11) at the Stage-2 step's two orientations, batch 32,
C = 64, hid = 256, drop-path masks at rate 0.2: joints over vertices
(17 queries, 431 keys, 8 heads) and vertices over joints (431 over 17, 2
heads), with the same four readings; where the tree has the backward's
tile program, its stage split (``ca_bwd_stage_split``).
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--rows", default="block,ca")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pmce_tpu_torch.ops import _cuda
    from pmce_tpu_torch.ops import fused_attention as fa

    if not torch.cuda.is_available():
        print("profile_block_bwd: no CUDA device", file=sys.stderr)
        return 2
    tag = f"[{args.tag}]"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"{tag} {card}; pmce_tpu_torch from {fa.__file__}", flush=True)
    _cuda.BLOCK.load()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2)
    C, hid = 256, 512

    def r(*shape, scale=1.0, offset=0.0, dtype=torch.float32):
        a = rng.normal(size=shape) * scale + offset
        return torch.from_numpy(a.astype("float32")).to(dev, dtype)

    def events_ms(fn, n=20):
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

    def host_ms(fn, n=20):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(times)

    def kernels(fn, n=5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = e.cuda_time_total
            if t > 0 and e.device_type.name == "CUDA":
                rows.append((t / n / 1e3, e.count // n, e.key))
        return sorted(rows, reverse=True)

    def report(where, name, fn):
        ms = events_ms(fn)
        hms = host_ms(fn)
        rows = kernels(fn)
        busy = sum(t for t, _, _ in rows)
        print(f"{where} {name}: wrapper {ms:.4f} ms, host {hms:.4f} ms, "
              f"kernels {busy:.4f} ms in {sum(c for _, c, _ in rows)} "
              "launches", flush=True)
        for t, cnt, key in rows:
            print(f"{where} {name}:   {t:8.4f} ms {cnt:3d}x {key[:100]}",
                  flush=True)

    rows_wanted = args.rows.split(",")
    if "ca" in rows_wanted:
        profile_ca(tag, dev, rng, report)
    if "block" not in rows_wanted:
        return 0
    for label, clips, N, rate in (("spatial", 1024, 17, 0.0),
                                  ("temporal", 1088, 16, 0.2)):
        params = (r(C, scale=0.1, offset=1.0), r(C, scale=0.1),
                  r(C, 3 * C, scale=C ** -0.5), r(3 * C, scale=0.02),
                  r(C, C, scale=C ** -0.5), r(C, scale=0.02),
                  r(C, scale=0.1, offset=1.0), r(C, scale=0.1),
                  r(C, hid, scale=C ** -0.5), r(hid, scale=0.02),
                  r(hid, C, scale=hid ** -0.5), r(C, scale=0.02),
                  r(C, scale=0.1, offset=1.0), r(C, scale=0.1))
        m1 = m2 = None
        if rate:
            keep = 1.0 - rate
            m1, m2 = (torch.from_numpy(((rng.random((clips, 1, 1)) < keep)
                                        / keep).astype("float32")).to(dev)
                      for _ in range(2))
        x = r(clips, N, C, dtype=torch.bfloat16)
        g = r(clips, N, C, dtype=torch.bfloat16)
        where = f"{tag} {label} [{clips}, {N}, {C}]"
        with torch.no_grad():
            def fwd():
                return fa._block_fwd_cuda(x, params, m1, m2, 8, 1e-6, 1e-6,
                                          True, False)

            _, saved = fwd()

            def bwd():
                return fa._block_bwd_cuda(g, x, params, m1, m2, saved, 8,
                                          1e-6, 1e-6, False)

            for name, fn in (("bwd", bwd), ("fwd", fwd)):
                report(where, name, fn)
            if hasattr(fa, "block_fwd_stage_split"):
                split = fa.block_fwd_stage_split(
                    x, params, 8, None if m1 is None else (m1, m2))
                total = sum(split[k] for k in fa.TRUNK_STAGES)
                print(f"{where} forward tile program: {split['tiles']} "
                      f"tiles, {total / split['tiles']:.0f} cycles a tile; "
                      + ", ".join(f"{k} {split[k] / total:.1%}"
                                  for k in fa.TRUNK_STAGES), flush=True)
            if hasattr(fa, "block_bwd_stage_split"):
                split = fa.block_bwd_stage_split(
                    x, params, 8, None if m1 is None else (m1, m2))
                total = sum(split[k] for k in fa.BLOCK_BWD_STAGES)
                print(f"{where} tile program: {split['tiles']} tiles, "
                      f"{total / split['tiles']:.0f} cycles a tile; "
                      + ", ".join(f"{k} {split[k] / total:.1%}"
                                  for k in fa.BLOCK_BWD_STAGES), flush=True)
        del saved, x, g, params
        torch.cuda.empty_cache()
    return 0


def profile_ca(tag, dev, rng, report) -> None:
    """Row 11 at the Stage-2 step's two orientations (see the module
    docstring)."""
    import torch

    from pmce_tpu_torch.ops import fused_attention as fa

    B, c, hid = 32, 64, 256

    def r(*shape, scale=0.2, offset=0.0, dtype=torch.float32):
        a = rng.normal(size=shape) * scale + offset
        return torch.from_numpy(a.astype("float32")).to(dev, dtype)

    for label, Nq, Nk, heads in (("joints over vertices", 17, 431, 8),
                                 ("vertices over joints", 431, 17, 2)):
        keep = 0.8
        masks = tuple(torch.from_numpy(((rng.random((B, 1, 1)) < keep)
                                        / keep).astype("float32")).to(dev)
                      for _ in range(2))
        xs = (r(B, Nq, c, scale=1.0, dtype=torch.bfloat16),
              r(B, Nk, c, scale=1.0, dtype=torch.bfloat16),
              r(B, Nk, c, scale=1.0, dtype=torch.bfloat16))
        conds = [r(B, c, scale=0.1, offset=1.0 - i % 2) for i in range(8)]
        params = []
        for i, o in ((c, c),) * 4 + ((c, hid), (hid, c)):
            params += [r(i, o, scale=i ** -0.5), r(o, scale=0.02)]
        g = r(B, Nq, c, scale=1.0, dtype=torch.bfloat16)
        where = f"{tag} ca {label} [{B}, {Nq}, {c}] over {Nk}, {heads} heads"
        with torch.no_grad():
            _, saved = fa._ca_fwd_cuda(xs, conds[0::2], conds[1::2], masks,
                                       params, heads, 1e-6)
            report(where, "bwd", lambda: fa._ca_bwd_cuda(
                g, xs, params, saved, heads, 1e-6))
            if hasattr(fa, "ca_bwd_stage_split"):
                split = fa.ca_bwd_stage_split(g, xs, params, saved, heads,
                                              1e-6)
                total = sum(split[k] for k in fa.CA_BWD_STAGES)
                print(f"{where} tile program: {split['ctas']} CTAs, "
                      f"{total / split['ctas']:.0f} cycles a CTA; "
                      + ", ".join(f"{k} {split[k] / total:.1%}"
                                  for k in fa.CA_BWD_STAGES), flush=True)
        del saved, xs, g, params
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
