"""CLI: convert reference-format MSCOCO sources to a packed npz.

    python -m pmce_tpu_torch.tools.convert_coco --annot-dir .../annotations \
        --jr-h36m J_regressor_h36m_correct.npy \
        --jr-coco J_regressor_coco.npy --out COCO_train_packed.npz

Port of ``tools/convert_coco.py``: JAX's flags plus ``--device``,
``--record-perf`` and ``--perf-path``. Source layout:
``pmce_tpu_torch/data/etl/coco.py``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from pmce_tpu_torch.data.etl import convert_coco
from pmce_tpu_torch.tools import etl_cli


def main(argv: list | None = None):
    """Run the CLI on ``argv`` (default: the command line); returns the
    converted ``SequenceData``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--annot-dir", required=True)
    ap.add_argument("--smpl-npz", default=None)
    ap.add_argument("--jr-h36m", required=True)
    ap.add_argument("--jr-coco", required=True)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for the precomputed 2D detector noise")
    ap.add_argument("--out", required=True)
    args = etl_cli.parse(ap, argv)

    t0 = time.perf_counter()
    art = etl_cli.body(args.smpl_npz)
    jr_h36m = np.load(args.jr_h36m)
    jr_coco = np.load(args.jr_coco)
    data = convert_coco(args.annot_dir, art, jr_h36m, jr_coco,
                        seed=args.seed, device=args.device)
    etl_cli.finish(args, data, art.J_regressor, jr_h36m, jr_coco, "coco",
                   "train", t0)
    return data


if __name__ == "__main__":
    main()
