"""What the converter CLIs (``convert_{h36m,pw3d,coco,mpii,mpii3d}.py``)
share: the flags the port adds to JAX's (``--device``, ``--record-perf``,
``--perf-path``), the body model and the packed output."""

from __future__ import annotations

import argparse
import time

import numpy as np

from pmce_tpu_torch.data.etl.common import resolve_device
from pmce_tpu_torch.data.packed import save_packed
from pmce_tpu_torch.smpl.artifacts import SMPLArtifacts, load_or_synthetic
from pmce_tpu_torch.utils import perf


def parse(ap: argparse.ArgumentParser, argv: list | None):
    """Add the port's flags to JAX's, parse ``argv`` and check
    ``--device`` before anything is loaded."""
    ap.add_argument("--device", default="cuda",
                    help="device of the SMPL synthesis: the card unless "
                         "--device cpu is given (without a card, the "
                         "default raises)")
    ap.add_argument("--record-perf", action="store_true",
                    help="record the conversion's frames/s under 'etl' in "
                         "the port's perf file")
    ap.add_argument("--perf-path", default=None,
                    help="perf file of --record-perf (default "
                         "PERF_TORCH.json at the repository root)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    return args


def body(path: str | None) -> SMPLArtifacts:
    """``--smpl-npz`` (``convert_smpl_pkl``'s output) or the port's
    neutral ``load_or_synthetic``."""
    return SMPLArtifacts.load(path) if path else load_or_synthetic("neutral")


def finish(args, data, jr_smpl, jr_h36m, jr_coco, dataset: str,
           split: str, t0: float) -> None:
    """Write the packed npz, print its size and, with ``--record-perf``,
    record frames/s from ``t0`` (``time.perf_counter``) to the written
    file."""
    save_packed(data, args.out, jr_smpl=jr_smpl, jr_h36m=jr_h36m,
                jr_coco=jr_coco)
    seconds = time.perf_counter() - t0
    print(f"wrote {args.out}: {len(data)} frames in {seconds:.2f} s")
    if args.record_perf:
        perf.record("etl", {
            "frames": len(data), "seconds": round(seconds, 3),
            "frames_per_s": round(len(data) / seconds, 1),
            "source": f"python -m pmce_tpu_torch.tools.convert_{dataset} "
                      f"(split {split})",
        }, path=args.perf_path, device=args.device,
            sub=f"{dataset}_{split}")


def load_regressor(path: str | None) -> np.ndarray | None:
    return np.load(path) if path else None
