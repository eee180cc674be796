"""CLI: convert reference-format Human3.6M sources to a packed npz.

    python -m pmce_tpu_torch.tools.convert_h36m --data-dir .../h36m_data \
        --split train --input-joint-set human36 \
        --smpl-npz data/smpl_neutral.npz \
        --jr-h36m data/J_regressor_h36m_correct.npy \
        --jr-coco data/joint_regressor_coco.npy \
        --out data/Human36M_train_packed.npz

Port of ``tools/convert_h36m.py``: JAX's flags, plus ``--device`` (the
SMPL synthesis on the card unless ``--device cpu``), ``--record-perf`` and
``--perf-path``. Source layout: ``pmce_tpu_torch/data/etl/h36m.py``.
"""

from __future__ import annotations

import argparse
import time

from pmce_tpu_torch.data.etl import convert_h36m
from pmce_tpu_torch.tools import etl_cli


def main(argv: list | None = None):
    """Run the CLI on ``argv`` (default: the command line); returns the
    converted ``SequenceData``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--split", default="train", choices=["train", "test"])
    ap.add_argument("--input-joint-set", default="human36",
                    choices=["human36", "coco"])
    ap.add_argument("--smpl-npz", default=None,
                    help="converted SMPL artifacts (convert_smpl_pkl)")
    ap.add_argument("--jr-h36m", required=True,
                    help="J_regressor_h36m_correct.npy ([17, 6890])")
    ap.add_argument("--jr-coco", default=None,
                    help="COCO-17 joint regressor npy ([17, 6890])")
    ap.add_argument("--out", required=True)
    ap.add_argument("--debug", action="store_true",
                    help="first subject only (reference --debug)")
    args = etl_cli.parse(ap, argv)

    t0 = time.perf_counter()
    art = etl_cli.body(args.smpl_npz)
    data = convert_h36m(args.data_dir, args.split, art,
                        input_joint_set=args.input_joint_set,
                        debug=args.debug, device=args.device)
    etl_cli.finish(args, data, art.J_regressor,
                   etl_cli.load_regressor(args.jr_h36m),
                   etl_cli.load_regressor(args.jr_coco), "h36m",
                   args.split, t0)
    return data


if __name__ == "__main__":
    main()
