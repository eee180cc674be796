"""Dataset construction from a configuration.

Port of ``pmce_tpu/data/factory.py``: an explicit registry in place of the
reference's ``eval(f'{name}.dataset')(...)`` (``lib/core/base.py:23``).

Resolution order per dataset:

1. a packed real-data npz ``{cfg.data_dir}/{Name}_{split}_packed.npz``
   (written by the offline ETL, ``python -m
   pmce_tpu_torch.tools.convert_*`` or the JAX package's
   ``tools/convert_*``: the same format) when it exists and
   ``DATASET.synthetic`` is off;
2. otherwise the deterministic synthetic fixtures (the SMPL forward of the
   synthesis on ``device``).

Every resolution is printed (``dataset → source``), and a missing packed
npz under an explicitly configured ``data_dir`` is an error: a mistyped
path must not train on synthetic fixtures.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from pmce_tpu_torch.core.config import Config
from pmce_tpu_torch.data.datasets import MPII, MPII3D, MSCOCO, PW3D, Human36M
from pmce_tpu_torch.smpl.artifacts import SMPLArtifacts

_REGISTRY = {
    "Human36M": Human36M,
    "PW3D": PW3D,
    "MPII3D": MPII3D,
    "COCO": MSCOCO,
    "MPII": MPII,
}


def packed_path(cfg: Config, name: str, split: str) -> str:
    """Canonical location of a converted split (the converters' output)."""
    return osp.join(cfg.data_dir, f"{name}_{split}_packed.npz")


def build_dataset(name: str, cfg: Config, art: SMPLArtifacts, split: str,
                  device="cuda"):
    """Build one dataset by registry name: the packed npz if present, the
    synthetic fixtures otherwise. ``device`` runs the synthesis' SMPL
    forward and the dataset's evaluation."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown dataset {name!r}; known: {sorted(_REGISTRY)}"
        ) from None

    # Reference stride quirks (train only): MPII3D always windows with
    # stride 16 (MPII3D/dataset.py:90), and so does Human36M fed COCO-set
    # inputs (Human36M/dataset.py:94-97): non-overlapping windows, not the
    # configured stride.
    stride = cfg.DATASET.stride if split == "train" else 1
    if split == "train" and (
            name == "MPII3D"
            or (name == "Human36M"
                and cfg.DATASET.input_joint_set == "coco")):
        stride = cfg.DATASET.seqlen
    kw = dict(seqlen=cfg.DATASET.seqlen, stride=stride,
              use_gt_input=cfg.DATASET.use_gt_input, device=device,
              # Stage-1 keeps every window; mesh training drops windows
              # whose mid frame lacks an SMPL fit (dataset.py:99-103).
              chunk_mode="pose" if cfg.MODEL.name == "PoseEst"
              else "mesh")

    path = packed_path(cfg, name, split)
    if osp.isfile(path) and not cfg.DATASET.synthetic:
        print(f"[pmce-tpu-torch] dataset {name}/{split} ← packed npz {path}")
        if cls is Human36M:
            return cls.from_packed(
                path, split=split,
                input_joint_set=cfg.DATASET.input_joint_set, **kw)
        return cls.from_packed(path, split=split, **kw)

    if not cfg.DATASET.synthetic and cfg.data_dir != Config().data_dir:
        # data_dir was pointed somewhere on purpose: a missing packed file
        # there is a configuration error, not a request for fixtures.
        raise FileNotFoundError(
            f"dataset {name}/{split}: no packed npz at {path} although "
            f"data_dir={cfg.data_dir!r} is explicitly configured. Run the "
            f"offline ETL (python -m pmce_tpu_torch.tools.convert_*) or set "
            f"DATASET.synthetic: true to request fixture data.")

    reason = ("DATASET.synthetic: true" if cfg.DATASET.synthetic
              else f"no packed npz at {path}")
    print(f"[pmce-tpu-torch] dataset {name}/{split} ← synthetic fixtures "
          f"({reason})")
    frames = max(2 * cfg.DATASET.seqlen,
                 cfg.DATASET.synthetic_samples // 2)
    if cls in (MSCOCO, MPII):
        return cls.from_synthetic(art, num_images=frames, **kw)
    if cls is Human36M:
        return cls.from_synthetic(
            art, split=split, num_videos=2, frames_per_video=frames,
            input_joint_set=cfg.DATASET.input_joint_set, **kw)
    return cls.from_synthetic(art, split=split, num_videos=2,
                              frames_per_video=frames, **kw)


def build_train_datasets(cfg: Config, art: SMPLArtifacts,
                         device="cuda") -> list:
    return [build_dataset(n, cfg, art, "train", device)
            for n in cfg.DATASET.train_list]


def build_test_dataset(cfg: Config, art: SMPLArtifacts, device="cuda"):
    name = cfg.DATASET.test_list[0]
    split = "test" if name != "MPII3D" else "val"
    return build_dataset(name, cfg, art, split, device)


def target_joint_regressor(cfg: Config, dataset) -> np.ndarray:
    """``cfg.DATASET.target_joint_set`` as the dataset's regressor
    (reference ``base.py:50,102``, without its eval())."""
    key = cfg.DATASET.target_joint_set
    if key in ("human36", "h36m"):
        return dataset.joint_regressor_h36m
    if key == "coco":
        jr = dataset.joint_regressor_coco
        if jr is not None and jr.shape[0] == 17:
            # Packed splits store the raw 17-row J_regressor_coco; the
            # COCO-19 convention appends pelvis (hip mean) and neck
            # (shoulder mean) rows.
            jr = np.concatenate(
                [jr, (jr[11] + jr[12])[None] / 2.0,
                 (jr[5] + jr[6])[None] / 2.0]).astype(np.float32)
        return jr
    if key == "smpl":
        return dataset.joint_regressor_smpl
    raise ValueError(f"unknown target joint set {key!r}")
