"""CLI: convert reference-format 3DPW sources to a packed npz.

    python -m pmce_tpu_torch.tools.convert_pw3d --data-dir .../pw3d_data \
        --split test --smpl-male M.npz --smpl-female F.npz \
        --jr-h36m J_regressor_h36m_correct.npy --out PW3D_test_packed.npz

Port of ``tools/convert_pw3d.py``: gendered SMPL GT from --smpl-male /
--smpl-female (missing genders fall back to neutral); JAX's flags plus
``--device``, ``--record-perf`` and ``--perf-path``. Source layout:
``pmce_tpu_torch/data/etl/pw3d.py``.
"""

from __future__ import annotations

import argparse
import time

from pmce_tpu_torch.data.etl import convert_pw3d
from pmce_tpu_torch.smpl.artifacts import SMPLArtifacts
from pmce_tpu_torch.tools import etl_cli


def main(argv: list | None = None):
    """Run the CLI on ``argv`` (default: the command line); returns the
    converted ``SequenceData``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--split", default="test", choices=["train", "test"])
    ap.add_argument("--smpl-npz", default=None, help="neutral artifacts")
    ap.add_argument("--smpl-male", default=None)
    ap.add_argument("--smpl-female", default=None)
    ap.add_argument("--jr-h36m", required=True)
    ap.add_argument("--jr-coco", default=None)
    ap.add_argument("--out", required=True)
    args = etl_cli.parse(ap, argv)

    t0 = time.perf_counter()
    neutral = etl_cli.body(args.smpl_npz)
    arts = {"neutral": neutral}
    for gender, path in (("male", args.smpl_male),
                         ("female", args.smpl_female)):
        if path:
            arts[gender] = SMPLArtifacts.load(path)
        else:
            print(f"warning: no --smpl-{gender} given; "
                  f"falling back to neutral for {gender} subjects")
    data = convert_pw3d(args.data_dir, args.split, arts, device=args.device)
    etl_cli.finish(args, data, neutral.J_regressor,
                   etl_cli.load_regressor(args.jr_h36m),
                   etl_cli.load_regressor(args.jr_coco), "pw3d",
                   args.split, t0)
    return data


if __name__ == "__main__":
    main()
