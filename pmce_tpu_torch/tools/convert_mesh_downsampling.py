#!/usr/bin/env python
"""Offline converter: COMA ``mesh_downsampling.npz`` → dense operators.

Port of ``tools/convert_mesh_downsampling.py``: the output is what
``pmce_tpu_torch.smpl.mesh.MeshCoarsening.load`` reads, the same file the
JAX tool writes. Unpickling the source's matrices needs scipy (numpy
imports ``scipy.sparse`` to rebuild them); nothing else.

The reference's file stores pickled scipy-sparse A/U/D matrix lists (its
lib/models/backbones/mesh.py:49-57). This converts them once into dense
row-major operators (431×6890 f32 ≈ 11 MB).

Usage:
  python -m pmce_tpu_torch.tools.convert_mesh_downsampling \
      mesh_downsampling.npz data/base_data/mesh_coarsening.npz
"""

from __future__ import annotations

import argparse

import numpy as np

from pmce_tpu_torch.smpl.mesh import MeshCoarsening


def convert(src: str, out: str) -> None:
    data = np.load(src, encoding="latin1", allow_pickle=True)
    D = [np.asarray(m.todense(), dtype=np.float32) for m in data["D"]]
    U = [np.asarray(m.todense(), dtype=np.float32) for m in data["U"]]

    mesh = MeshCoarsening(D=tuple(D), U=tuple(U))
    mesh.validate()
    mesh.save(out)
    print(f"wrote {out}: sizes={mesh.sizes}")


def main(argv: list | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("src")
    ap.add_argument("out")
    a = ap.parse_args(argv)
    convert(a.src, a.out)


if __name__ == "__main__":
    main()
