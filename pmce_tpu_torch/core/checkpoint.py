"""Checkpoints with the reference's payload and selection rules.

Port of ``pmce_tpu/core/checkpoint.py``: the payload is the model's
state_dict, the optimizer's (and scheduler's) state, the epoch, the
train-loss history and the test-error history, written with ``torch.save``
(the reference's ``main/train.py:57-64``). Files: ``checkpoint{epoch}.ckpt``
every epoch, ``final.ckpt`` at the last epoch, ``best.ckpt`` on the best
joint error (``funcs_utils.py:111-128``). The JAX package's msgpack
checkpoints are not read here.
"""

from __future__ import annotations

import os
import re

import torch


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(ckpt_dir: str, epoch: int, end_epoch: int,
                    payload: dict, is_best: bool | None = None) -> str:
    """Write one epoch's checkpoint (and the best alias); returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = _to_cpu(dict(payload, epoch=epoch))
    name = "final.ckpt" if epoch == end_epoch else f"checkpoint{epoch}.ckpt"
    path = os.path.join(ckpt_dir, name)
    torch.save(payload, path)
    if is_best:
        torch.save(payload, os.path.join(ckpt_dir, "best.ckpt"))
    return path


def _latest_numbered(ckpt_dir: str) -> str | None:
    """Highest-EPOCH ``checkpoint{N}.ckpt`` (numeric, not lexicographic:
    a string sort would resume 'checkpoint9' over 'checkpoint12')."""
    best_n, best_f = -1, None
    for f in os.listdir(ckpt_dir):
        m = re.fullmatch(r"checkpoint(\d+)\.ckpt", f)
        if m and int(m.group(1)) > best_n:
            best_n, best_f = int(m.group(1)), f
    return best_f


def resolve_checkpoint(path: str, prefer: str = "best") -> str:
    """A checkpoint file for ``path``. For a directory, ``prefer`` sets the
    order: ``"best"`` (evaluation: best → final → latest epoch) or
    ``"latest"`` (resume: final → latest epoch → best; resuming from
    best.ckpt would silently rewind completed epochs)."""
    if not os.path.isdir(path):
        return path
    order = ("best.ckpt", "final.ckpt") if prefer == "best" else (
        "final.ckpt",)
    for cand in order:
        p = os.path.join(path, cand)
        if os.path.isfile(p):
            return p
    latest = _latest_numbered(path)
    if latest is None and prefer == "latest" and os.path.isfile(
            os.path.join(path, "best.ckpt")):
        latest = "best.ckpt"
    if latest is None:
        raise FileNotFoundError(f"no checkpoint in {path}")
    return os.path.join(path, latest)


def load_checkpoint(path: str, prefer: str = "best",
                    map_location="cpu") -> dict:
    """Load a checkpoint file, or pick one from a directory (see
    :func:`resolve_checkpoint`)."""
    return torch.load(resolve_checkpoint(path, prefer),
                      map_location=map_location, weights_only=True)
