"""CLI: convert reference-format MPI-INF-3DHP sources to a packed npz.

    python -m pmce_tpu_torch.tools.convert_mpii3d --data-dir .../mpii3d \
        --split train --jr-h36m J_regressor_h36m_correct.npy \
        --out MPII3D_train_packed.npz

Port of ``tools/convert_mpii3d.py``: JAX's flags plus ``--device``,
``--record-perf`` and ``--perf-path``. The val split runs no SMPL. Source
layout: ``pmce_tpu_torch/data/etl/mpii3d.py``.
"""

from __future__ import annotations

import argparse
import time

from pmce_tpu_torch.data.etl import convert_mpii3d
from pmce_tpu_torch.tools import etl_cli


def main(argv: list | None = None):
    """Run the CLI on ``argv`` (default: the command line); returns the
    converted ``SequenceData``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--split", default="train", choices=["train", "val"])
    ap.add_argument("--smpl-npz", default=None)
    ap.add_argument("--jr-h36m", required=True)
    ap.add_argument("--jr-coco", default=None)
    ap.add_argument("--out", required=True)
    args = etl_cli.parse(ap, argv)

    t0 = time.perf_counter()
    art = etl_cli.body(args.smpl_npz)
    data = convert_mpii3d(args.data_dir, args.split, art, device=args.device)
    etl_cli.finish(args, data, art.J_regressor,
                   etl_cli.load_regressor(args.jr_h36m),
                   etl_cli.load_regressor(args.jr_coco), "mpii3d",
                   args.split, t0)
    return data


if __name__ == "__main__":
    main()
