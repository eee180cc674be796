"""Clip windowing: group frames into videos, emit fixed-length windows.

The port's own copy of ``pmce_tpu/data/chunker.py`` (numpy only). Parity
target: reference lib/_img_utils.py:27-92
(``split_into_chunks_pose`` / ``split_into_chunks_mesh``), including:
- video grouping by the image-name prefix (name minus its last 11 chars);
- ``view_as_windows(seqlen, stride)`` window starts;
- the mesh variant drops windows whose MID frame has no SMPL parameters
  (marker: a length-1 pose array in the reference; here an explicit boolean
  ``has_smpl`` array);
- the VIBE-compat tail trim: when ``stride != seqlen``, drop trailing
  windows so the last window end matches the last non-overlapping
  16-frame chunk boundary.

Pure numpy, host-side (runs once at dataset construction).
"""

from __future__ import annotations

import numpy as np


def video_groups(img_names: np.ndarray) -> list[np.ndarray]:
    """Split frame indices into per-video runs (order-preserving)."""
    vid_names = np.array([str(n)[:-11] for n in img_names])
    names, first = np.unique(vid_names, return_index=True)
    order = np.argsort(first)
    first = first[order]
    return np.split(np.arange(len(vid_names)), first[1:])


def _windows(indexes: np.ndarray, seqlen: int, stride: int) -> np.ndarray:
    """All length-``seqlen`` windows with the given stride ([n, seqlen])."""
    n = (len(indexes) - seqlen) // stride + 1
    starts = np.arange(n) * stride
    return indexes[starts[:, None] + np.arange(seqlen)[None, :]]


def _vibe_tail_trim(start_finish: list, indexes: np.ndarray,
                    seqlen: int) -> list:
    """Reference's match_vibe trim (lib/_img_utils.py:46-52,81-87)."""
    if len(indexes) < 16:
        return start_finish
    n16 = (len(indexes) - 16) // 16 + 1
    last_vibe_end = indexes[(n16 - 1) * 16 + 15]
    for j in range(1, len(start_finish) + 1):
        if start_finish[-j][-1] == last_vibe_end:
            if j != 1:
                start_finish = start_finish[:-j + 1]
            break
    return start_finish


def split_into_chunks_pose(img_names, seqlen: int, stride: int,
                           match_vibe: bool = True) -> np.ndarray:
    """Window starts/ends for pose training: [[start, end], ...]."""
    out = []
    for indexes in video_groups(np.asarray(img_names)):
        if len(indexes) < seqlen:
            continue
        chunks = _windows(indexes, seqlen, stride)
        start_finish = chunks[:, (0, -1)].tolist()
        if stride != seqlen and match_vibe:
            start_finish = _vibe_tail_trim(start_finish, indexes, seqlen)
        out += start_finish
    return np.array(out)


def split_into_chunks_mesh(img_names, seqlen: int, stride: int,
                           has_smpl, match_vibe: bool = True) -> np.ndarray:
    """Window starts/ends for mesh training; drops windows whose mid frame
    lacks SMPL parameters."""
    has_smpl = np.asarray(has_smpl, dtype=bool)
    out = []
    for indexes in video_groups(np.asarray(img_names)):
        if len(indexes) < seqlen:
            continue
        chunks = _windows(indexes, seqlen, stride)
        keep = has_smpl[chunks[:, seqlen // 2]]
        chunks = chunks[keep]
        if len(chunks) == 0:
            continue
        start_finish = chunks[:, (0, -1)].tolist()
        if stride != seqlen and match_vibe:
            start_finish = _vibe_tail_trim(start_finish, indexes, seqlen)
        out += start_finish
    return np.array(out)
