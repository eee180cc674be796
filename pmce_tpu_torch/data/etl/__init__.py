"""Offline ETL of the port: reference-format dataset sources → packed npz
splits.

Port of ``pmce_tpu/data/etl/``, with the same five exported names. Each
submodule converts one dataset family from the exact on-disk layout the
reference consumes (COCO-style annotation JSONs, joblib feature DBs,
NeuralAnnot / SMPLify fit JSONs) into the port's packed ``SequenceData``
arrays. The SMPL ground-truth synthesis runs once, batched, on the card
(each function's ``device``, the CPU only when asked for), so the training
path never touches JSON or per-sample Python. ``joblib_io`` reads the
feature DBs without joblib; it has no JAX counterpart.
"""

from pmce_tpu_torch.data.etl.coco import convert_coco
from pmce_tpu_torch.data.etl.h36m import convert_h36m
from pmce_tpu_torch.data.etl.mpii import convert_mpii
from pmce_tpu_torch.data.etl.mpii3d import convert_mpii3d
from pmce_tpu_torch.data.etl.pw3d import convert_pw3d

__all__ = [
    "convert_h36m", "convert_pw3d", "convert_mpii3d", "convert_coco",
    "convert_mpii",
]
