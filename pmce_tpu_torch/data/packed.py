"""Packed-array dataset files: the real-data path.

Port of ``pmce_tpu/data/packed.py``, with the same npz format, so that a
file the JAX package's converters (``tools/convert_*.py``) wrote loads here
unchanged, and the reverse. One compressed npz per dataset split holds the
``SyntheticSequenceData`` per-frame arrays plus the dataset's joint
regressors; ``load_packed`` restores them and the dataset classes build
their windowed views.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pmce_tpu_torch.data.synthetic import SyntheticSequenceData

# The packed format is the SyntheticSequenceData layout; the alias makes the
# real-data intent explicit at call sites.
SequenceData = SyntheticSequenceData

_OPTIONAL = ("mesh_valid", "lift_valid", "reg_valid")
_FIELDS = [f.name for f in dataclasses.fields(SyntheticSequenceData)
           if f.name not in _OPTIONAL]

# Joint regressors stored beside the frame arrays, so that a packed npz is
# self-contained (the reference loads them from its SMPL wrapper,
# data/Human36M/dataset.py:49-75).
_REGRESSOR_KEYS = ("jr_smpl", "jr_h36m", "jr_coco")


def save_packed(data: SequenceData, path,
                jr_smpl: np.ndarray | None = None,
                jr_h36m: np.ndarray | None = None,
                jr_coco: np.ndarray | None = None,
                **extra: np.ndarray) -> None:
    """Write one dataset split as a compressed npz."""
    arrays = {}
    for name in _FIELDS + [o for o in _OPTIONAL
                           if getattr(data, o) is not None]:
        v = getattr(data, name)
        if v.dtype.kind in ("U", "S", "O"):
            v = np.asarray(v, dtype=np.str_)
        arrays[name] = v
    for key, v in zip(_REGRESSOR_KEYS, (jr_smpl, jr_h36m, jr_coco)):
        if v is not None:
            arrays[key] = np.asarray(v, dtype=np.float32)
    for key, v in extra.items():
        if key in arrays:
            raise ValueError(f"extra key {key!r} collides with a base field")
        arrays[key] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def load_packed(path) -> tuple[SequenceData, dict]:
    """Load a packed split.

    Returns:
      (SequenceData, aux) where aux holds the regressors (``jr_smpl`` /
      ``jr_h36m`` / ``jr_coco`` when present) and any extra arrays the
      converter stored (e.g. per-frame joint validity).
    """
    with np.load(path, allow_pickle=False) as z:
        missing = [f for f in _FIELDS if f not in z.files]
        if missing:
            raise ValueError(
                f"{path}: not a packed dataset npz (missing {missing})")
        kwargs = {f: z[f] for f in _FIELDS}
        for o in _OPTIONAL:
            if o in z.files:
                kwargs[o] = z[o]
        aux = {k: z[k] for k in z.files
               if k not in _FIELDS and k not in _OPTIONAL}
    return SequenceData(**kwargs), aux
