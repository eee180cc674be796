"""Where the lifter block (rows 6 and 7), the decoder's AdaLN and
cross-attention blocks (rows 8-11), the self-attention forward and
backward (rows 4 and 5) and skinning (row 15) spend their time on the card.

    python3 pmce_tpu_torch/tools/profile_block_bwd.py [--root DIR] [--tag T]
        [--rows block,ca,ada,mhsa,skin]

Imports ``pmce_tpu_torch`` from ``DIR`` (default: the tree this script is
in; an unpacked earlier commit, say) and builds its libraries. At the
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

``--rows ca`` adds the cross-attention block (rows 10 and 11) at the
Stage-2 step's two orientations, batch 32, C = 64, hid = 256, drop-path
masks at rate 0.2: joints over vertices (17 queries, 431 keys, 8 heads)
and vertices over joints (431 over 17, 2 heads): the forward wrapper
``_ca_fwd_cuda`` (saving, as for a gradient) and the backward wrapper
``_ca_bwd_cuda`` with the same four readings, and ``autograd ms``: CUDA
events around 20 calls of what the training step runs, ``ca_block`` with
grad (``fwd``) or ``torch.autograd.grad`` through it (``bwd``); where the
tree has them, the tile programs' stage splits (``ca_fwd_stage_split``,
``ca_bwd_stage_split``). ``--rows ada`` the same for the AdaLN block (rows
8 and 9) at the vertex stream's ``[32, 431, 64]``, 2 heads
(``_ada_fwd_cuda``, ``_ada_bwd_cuda``, ``ada_block``,
``ada_bwd_stage_split``; where the tree has them, the forward's two tile
programs' stage split, ``ada_fwd_stage_split``, and the CTAs of its launch
B the card holds at once). Where the tree has the tile programs, each
one's device time at 24 clips and at 32 beside the clusters of 4 CTAs the
card holds at once (``pmce_ca_tile_clusters``, ``pmce_ada_tile_clusters``):
whether the batch runs in one wave. ``--rows mhsa``: row 4's forward
wrapper ``_mhsa_fwd_cuda`` (saving, as for a gradient) with the same
readings and ``fused_mhsa`` under autograd, at the decoder's joint stream
``[32, 17, 64]`` (8 heads of 8) and the trunk backward's ``[512, 17,
256]`` (8 heads of 32), beside one PyTorch call of the same function
(``F.multi_head_attention_forward`` in bf16 with grad, timed only); where
the tree has the tile program, its stage split
(``mhsa_fwd_stage_split``) and its device time at each shape's plan and
at other clips a CTA (1, 4 and 7 at the trunk's shape). Then row 5, the
backward wrapper ``_mhsa_bwd_cuda`` on that forward's saved state, with
the same four readings (``autograd``: ``torch.autograd.grad`` through
``fused_mhsa``); where the tree has the backward's tile program, its
stage split (``mhsa_bwd_stage_split``) and its two launches against the
launch sequence it replaced (``_mhsa_bwd_seq``, kept for the shapes
outside the gate) on the same inputs: CUDA events around 20 calls of
each, and each one's kernels' device time, in turns (program, sequence,
sequence, program). ``--rows skin``: ``fused_skinning`` at B = 256
bodies of V = 6890 vertices, 24 joints (f32, random transforms, softmax
weights), CUDA events around 20 calls and the kernel's device time,
beside one ``torch.einsum`` of the same function (TF32 off).
"""

from __future__ import annotations

import argparse
import inspect
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--rows", default="block,ca,ada,mhsa,skin")
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

    def report(where, name, fn, autograd=None):
        ms = events_ms(fn)
        hms = host_ms(fn)
        rows = kernels(fn)
        busy = sum(t for t, _, _ in rows)
        with torch.enable_grad():
            agm = (f", autograd {events_ms(autograd):.4f} ms"
                   if autograd else "")
        print(f"{where} {name}: wrapper {ms:.4f} ms, host {hms:.4f} ms, "
              f"kernels {busy:.4f} ms in {sum(c for _, c, _ in rows)} "
              f"launches{agm}", flush=True)
        for t, cnt, key in rows:
            print(f"{where} {name}:   {t:8.4f} ms {cnt:3d}x {key[:100]}",
                  flush=True)

    rows_wanted = args.rows.split(",")
    def tile_ms(fn, name):
        return sum(t for t, _, key in kernels(fn) if name in key)

    if "ca" in rows_wanted:
        _cuda.CA.load()
        profile_ca(tag, dev, rng, report, tile_ms)
    if "ada" in rows_wanted:
        _cuda.ADA.load()
        profile_ada(tag, dev, rng, report, tile_ms)
    if "mhsa" in rows_wanted:
        _cuda.MHSA.load()
        profile_mhsa(tag, dev, rng, report, events_ms, kernels)
    if "skin" in rows_wanted:
        _cuda.SKIN.load()
        profile_skinning(tag, dev, rng, events_ms, kernels)
    if "block" not in rows_wanted:
        return 0
    _cuda.BLOCK.load()
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


# A batch within the clusters of 4 CTAs an H100 SXM holds at once (30, as
# `pmce_ca_tile_clusters` reads it): one wave of the tile programs.
WAVE_CLIPS = 24


def _waves(where, clusters, what, n, t_n, B, t_B) -> None:
    """The tile program's device time at n clips (one wave) and at B."""
    print(f"{where} {what} tile program: {clusters} clusters of 4 CTAs "
          f"co-resident; {n} clips {t_n:.4f} ms ({-(-n // clusters)} "
          f"wave), {B} clips {t_B:.4f} ms ({-(-B // clusters)} waves)",
          flush=True)


def _split_line(where, what, split, stages) -> None:
    total = sum(split[k] for k in stages)
    print(f"{where} {what}: {split['ctas']} CTAs, "
          f"{total / split['ctas']:.0f} cycles a CTA; "
          + ", ".join(f"{k} {split[k] / total:.1%}" for k in stages),
          flush=True)


def _masks(rng, dev, B):
    import torch

    return tuple(torch.from_numpy(((rng.random((B, 1, 1)) < 0.8) / 0.8)
                                  .astype("float32")).to(dev)
                 for _ in range(2))


def profile_ca(tag, dev, rng, report, tile_ms) -> None:
    """Rows 10 and 11 at the Stage-2 step's two orientations (see the
    module docstring)."""
    import torch

    from pmce_tpu_torch.ops import _cuda
    from pmce_tpu_torch.ops import fused_attention as fa

    B, c, hid = 32, 64, 256

    def r(*shape, scale=0.2, offset=0.0, dtype=torch.float32):
        a = rng.normal(size=shape) * scale + offset
        return torch.from_numpy(a.astype("float32")).to(dev, dtype)

    for label, Nq, Nk, heads in (("joints over vertices", 17, 431, 8),
                                 ("vertices over joints", 431, 17, 2)):
        masks = _masks(rng, dev, B)
        xs = (r(B, Nq, c, scale=1.0, dtype=torch.bfloat16),
              r(B, Nk, c, scale=1.0, dtype=torch.bfloat16),
              r(B, Nk, c, scale=1.0, dtype=torch.bfloat16))
        conds = [r(B, c, scale=0.1, offset=1.0 - i % 2) for i in range(8)]
        params = []
        for i, o in ((c, c),) * 4 + ((c, hid), (hid, c)):
            params += [r(i, o, scale=i ** -0.5), r(o, scale=0.02)]
        g = r(B, Nq, c, scale=1.0, dtype=torch.bfloat16)
        where = f"{tag} ca {label} [{B}, {Nq}, {c}] over {Nk}, {heads} heads"
        leaves = [t.clone().requires_grad_(True)
                  for t in (*xs, *conds, *params)]

        def call():
            return fa.ca_block(*leaves[:3], leaves[3:11:2], leaves[4:11:2],
                               leaves[11:], heads, 1e-6, masks)

        with torch.enable_grad():
            y = call()
        with torch.no_grad():
            def fwd():
                return fa._ca_fwd_cuda(xs, conds[0::2], conds[1::2], masks,
                                       params, heads, 1e-6)

            _, saved = fwd()
            report(where, "fwd", fwd, call)
            report(where, "bwd", lambda: fa._ca_bwd_cuda(
                g, xs, params, saved, heads, 1e-6),
                lambda: torch.autograd.grad(y, leaves, g, retain_graph=True))
            if hasattr(fa, "ca_fwd_stage_split"):
                _split_line(where, "forward tile program",
                            fa.ca_fwd_stage_split(xs, conds[0::2],
                                                  conds[1::2], params, heads,
                                                  1e-6, masks),
                            fa.CA_FWD_STAGES)
            if hasattr(fa, "ca_bwd_stage_split"):
                _split_line(where, "tile program",
                            fa.ca_bwd_stage_split(g, xs, params, saved,
                                                  heads, 1e-6),
                            fa.CA_BWD_STAGES)
            if hasattr(fa, "ca_fwd_stage_split"):
                n = WAVE_CLIPS
                m24 = tuple(m[:n] for m in masks)
                x24 = tuple(t[:n] for t in xs)
                c24 = [t[:n] for t in conds]
                _, s24 = fa._ca_fwd_cuda(x24, c24[0::2], c24[1::2], m24,
                                         params, heads, 1e-6)
                _waves(where, _cuda.CA.query("pmce_ca_tile_clusters", 1),
                       "forward", n, tile_ms(lambda: fa._ca_fwd_cuda(
                           x24, c24[0::2], c24[1::2], m24, params, heads,
                           1e-6), "ca_fwd_tile"), B, tile_ms(fwd,
                                                             "ca_fwd_tile"))
                _waves(where, _cuda.CA.query("pmce_ca_tile_clusters", 0),
                       "backward", n, tile_ms(lambda: fa._ca_bwd_cuda(
                           g[:n], x24, params, s24, heads, 1e-6),
                           "ca_bwd_tile"), B, tile_ms(lambda: fa._ca_bwd_cuda(
                               g, xs, params, saved, heads, 1e-6),
                               "ca_bwd_tile"))
        del saved, xs, g, params, leaves, y
        torch.cuda.empty_cache()


def profile_ada(tag, dev, rng, report, tile_ms) -> None:
    """Rows 8 and 9 at the vertex stream's [32, 431, 64], 2 heads (see the
    module docstring)."""
    import torch

    from pmce_tpu_torch.ops import _cuda
    from pmce_tpu_torch.ops import fused_attention as fa

    B, N, c, hid, heads = 32, 431, 64, 256, 2

    def r(*shape, scale=0.2, offset=0.0, dtype=torch.float32):
        a = rng.normal(size=shape) * scale + offset
        return torch.from_numpy(a.astype("float32")).to(dev, dtype)

    masks = _masks(rng, dev, B)
    x = r(B, N, c, scale=1.0, dtype=torch.bfloat16)
    conds = [r(B, c, scale=0.1, offset=1.0 - i % 2) for i in range(4)]
    params = [r(c, 3 * c, scale=c ** -0.5), r(3 * c, scale=0.02),
              r(c, c, scale=c ** -0.5), r(c, scale=0.02),
              r(c, hid, scale=c ** -0.5), r(hid, scale=0.02),
              r(hid, c, scale=hid ** -0.5), r(c, scale=0.02)]
    g = r(B, N, c, scale=1.0, dtype=torch.bfloat16)
    where = f"{tag} ada [{B}, {N}, {c}], {heads} heads"
    leaves = [t.clone().requires_grad_(True) for t in (x, *conds, *params)]

    def call():
        return fa.ada_block(leaves[0], *leaves[1:5], leaves[5:], heads, 1e-6,
                            masks)

    with torch.enable_grad():
        y = call()
    with torch.no_grad():
        def fwd():
            return fa._ada_fwd_cuda(x, conds, masks, params, heads, 1e-6)

        _, saved = fwd()
        report(where, "fwd", fwd, call)
        if "for_grad" in inspect.signature(fa._ada_fwd_cuda).parameters:
            report(where, "fwd, no gradient owed", lambda: fa._ada_fwd_cuda(
                x, conds, masks, params, heads, 1e-6, for_grad=False))
        report(where, "bwd", lambda: fa._ada_bwd_cuda(
            g, x, params, saved, heads, 1e-6),
            lambda: torch.autograd.grad(y, leaves, g, retain_graph=True))
        if hasattr(fa, "ada_fwd_stage_split"):
            _split_line(where, "forward tile programs A and B",
                        fa.ada_fwd_stage_split(x, conds, params, heads, 1e-6,
                                               masks), fa.ADA_FWD_STAGES)
            resident, waves = fa.ada_fwd_waves(B)
            print(f"{where} forward launch B: {resident} CTAs co-resident, "
                  f"{B} clips {B * fa.ADA_FWD_CTAS} CTAs: {waves} wave(s)",
                  flush=True)
        if hasattr(fa, "ada_bwd_stage_split"):
            _split_line(where, "tile program",
                        fa.ada_bwd_stage_split(g, x, params, saved, heads,
                                               1e-6), fa.ADA_BWD_STAGES)
            n = WAVE_CLIPS
            m24 = tuple(m[:n] for m in masks)
            c24 = [t[:n] for t in conds]
            _, s24 = fa._ada_fwd_cuda(x[:n], c24, m24, params, heads, 1e-6)
            _waves(where, _cuda.ADA.query("pmce_ada_tile_clusters"),
                   "backward", n, tile_ms(lambda: fa._ada_bwd_cuda(
                       g[:n], x[:n], params, s24, heads, 1e-6),
                       "ada_bwd_tile"), B, tile_ms(lambda: fa._ada_bwd_cuda(
                           g, x, params, saved, heads, 1e-6),
                           "ada_bwd_tile"))
    del saved, x, g, params, leaves, y
    torch.cuda.empty_cache()


def profile_mhsa(tag, dev, rng, report, events_ms, kernels) -> None:
    """Row 4's forward at the decoder's joint stream and the trunk
    backward's spatial shape (see the module docstring)."""
    import torch
    import torch.nn.functional as F

    from pmce_tpu_torch.ops import fused_attention as fa

    def r(*shape, scale=0.2, dtype=torch.float32):
        a = rng.normal(size=shape) * scale
        return torch.from_numpy(a.astype("float32")).to(dev, dtype)

    bf = torch.bfloat16
    for label, clips, N, c, cpcs in (("joint", 32, 17, 64, (1, 2)),
                                     ("trunk", 512, 17, 256, (1, 4, 7))):
        heads = 8
        x = r(clips, N, c, scale=1.0, dtype=bf)
        w = [r(c, 3 * c, scale=c ** -0.5), r(3 * c, scale=0.02),
             r(c, c, scale=c ** -0.5), r(c, scale=0.02)]
        where = f"{tag} mhsa {label} [{clips}, {N}, {c}], {heads} heads"
        leaves = [t.clone().requires_grad_(True) for t in (x, *w)]
        lib = [x.transpose(0, 1).contiguous(), w[0].t().to(bf).contiguous(),
               w[1].to(bf), w[2].t().to(bf).contiguous(), w[3].to(bf)]
        lib = [t.requires_grad_(True) for t in lib]

        def library():
            q, w_in, b_in, w_out, b_out = lib
            return F.multi_head_attention_forward(
                q, q, q, c, heads, w_in, b_in, None, None, False, 0.0, w_out,
                b_out, training=True, need_weights=False)[0]

        with torch.no_grad():
            report(where, "fwd", lambda: fa._mhsa_fwd_cuda(x, *w, heads),
                   lambda: fa.fused_mhsa(*leaves, heads))
            if "for_grad" in inspect.signature(fa._mhsa_fwd_cuda).parameters:
                report(where, "fwd, no gradient owed",
                       lambda: fa._mhsa_fwd_cuda(x, *w, heads,
                                                 for_grad=False))
        with torch.enable_grad():
            print(f"{where} library F.multi_head_attention_forward, bf16, "
                  f"with grad: {events_ms(library):.4f} ms", flush=True)
        if hasattr(fa, "mhsa_fwd_stage_split"):
            with torch.no_grad():
                _split_line(where, "tile program",
                            fa.mhsa_fwd_stage_split(x, *w, heads),
                            fa.MHSA_FWD_STAGES)
                for cpc in cpcs:
                    ms = sum(t for t, _, key in kernels(
                        lambda: fa._mhsa_fwd_cuda(x, *w, heads,
                                                  clips_per_cta=cpc))
                        if "mhf" in key)
                    print(f"{where} tile program at {cpc} clips a CTA "
                          f"({-(-clips // cpc)} CTAs): {ms:.4f} ms on the "
                          "card", flush=True)
        profile_mhsa_bwd(where, x, w, leaves, heads, r, report, events_ms,
                         kernels)
        torch.cuda.empty_cache()


def profile_mhsa_bwd(where, x, w, leaves, heads, r, report, events_ms,
                     kernels) -> None:
    """Row 5 on a saving forward's state (see the module docstring)."""
    import torch

    from pmce_tpu_torch.ops import fused_attention as fa

    g = r(*x.shape, scale=1.0, dtype=torch.bfloat16)
    with torch.no_grad():
        _, saved = fa._mhsa_fwd_cuda(x, *w, heads)
    with torch.enable_grad():
        y = fa.fused_mhsa(*leaves, heads)

    def program():
        return fa._mhsa_bwd_cuda(g, x, w[0], w[2], saved, heads)

    with torch.no_grad():
        report(where, "bwd", program, lambda: torch.autograd.grad(
            y, leaves, g, retain_graph=True))
    if not hasattr(fa, "mhsa_bwd_stage_split"):
        return
    with torch.no_grad():
        _split_line(where, "backward tile program", fa.mhsa_bwd_stage_split(
            g, x, w[0], w[2], saved, heads), fa.MHSA_BWD_STAGES)

        def sequence():
            return fa._mhsa_bwd_seq(g, x, w[0], w[2], saved, heads)

        for name, fn in (("program", program), ("sequence", sequence),
                         ("sequence", sequence), ("program", program)):
            ms = events_ms(fn)
            rows = kernels(fn)
            print(f"{where} bwd {name}: {ms:.4f} ms a call, kernels "
                  f"{sum(t for t, _, _ in rows):.4f} ms in "
                  f"{sum(c for _, c, _ in rows)} launches", flush=True)


def profile_skinning(tag, dev, rng, events_ms, kernels) -> None:
    """Row 15 at the synthesis' shape (see the module docstring)."""
    import torch

    from pmce_tpu_torch.smpl import kernels as sk

    torch.backends.cuda.matmul.allow_tf32 = False
    B, V, J = 256, 6890, 24

    def r(*shape, scale):
        a = rng.normal(size=shape) * scale
        return torch.from_numpy(a.astype("float32")).to(dev)

    v, A = r(B, V, 3, scale=0.3), r(B, J, 4, 4, scale=0.5)
    w = torch.softmax(r(V, J, scale=3.0), -1)
    vh = torch.cat([v, torch.ones_like(v[..., :1])], -1)
    A3 = A[:, :, :3, :].contiguous()
    where = f"{tag} skinning B={B} V={V} J={J}"
    for name, fn in (("kernel", lambda: sk.fused_skinning(v, A, w)),
                     ("library torch.einsum",
                      lambda: torch.einsum("vj,bjmk,bvk->bvm", w, A3, vh))):
        ms = events_ms(fn)
        rows = kernels(fn)
        print(f"{where} {name}: {ms:.4f} ms a call, kernels "
              f"{sum(t for t, _, _ in rows):.4f} ms in "
              f"{sum(c for _, c, _ in rows)} launches", flush=True)


if __name__ == "__main__":
    sys.exit(main())
