"""Run ``chip_smoke.py``'s phase 8 (the video demo on the kernels and under
``plain_everything``) several times in one process on the card and print,
for each run, how the two paths' camera fits compare.

    python3 pmce_tpu_torch/tools/demo_cameras.py [--runs N]

Run from the repository's root. Each run trains the detector anew (as
phase 8 does), runs the demo both ways and prints phase 8's lines: the
meshes' and the fitted joints' projections' differences against their
tolerances, and the fit's conditioning (the joints' RMS distance from
their mean, how far the kernels' joints lie from the plain's, the scales
s and the windows clamped at 1e-3 or 4, and the cameras' differences as
(s, tx, ty) and as (s, s·tx, s·ty)). A run whose check fails is reported
and the next one starts. The last line is one JSON object with every
run's numbers.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    import chip_smoke as cs
    from pmce_tpu_torch.ops import _cuda

    if not torch.cuda.is_available():
        raise SystemExit("demo_cameras.py runs on the card")
    _cuda.build_all()
    print(f"[demo_cameras] {cs.card_line()}", flush=True)
    runs = []
    for i in range(args.runs):
        try:
            dm = cs.demo(torch.device("cuda"))
            runs.append({"run": i, "ok": True, "bands": dm["bands"],
                         "cam_fit": dm["cam_fit"]})
        except RuntimeError as e:
            runs.append({"run": i, "ok": False, "error": str(e)})
        print(f"[demo_cameras] run {i}: {json.dumps(runs[-1])}", flush=True)
    print(json.dumps({"runs": runs}))
    return 0 if all(r["ok"] for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
