"""Multi-person bbox tracking (SORT-style, detector-agnostic).

Port of ``pmce_tpu/demo/tracker.py``: the output contract of the
reference demo's external multi-person-tracker (main/run_demo.py:199-215),
``{person_id: {"bbox": [N, 4 cx cy w h], "frames": [N]}}``. The
association (Hungarian on 1 − IoU) runs in the port's C++ library
(``pmce_tpu_torch/native/tracker.cc``); the motion model is
constant-velocity prediction in numpy. :func:`assign_greedy` is the numpy
greedy matcher the tests hold it to where the two must agree.

The detector is pluggable: any per-frame list of [K, 4] xywh boxes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pmce_tpu_torch import native


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU for xywh boxes: [N, 4] × [M, 4] → [N, M]."""
    ax1, ay1 = a[:, 0], a[:, 1]
    ax2, ay2 = a[:, 0] + a[:, 2], a[:, 1] + a[:, 3]
    bx1, by1 = b[:, 0], b[:, 1]
    bx2, by2 = b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
    ix = np.maximum(0.0, np.minimum(ax2[:, None], bx2[None])
                    - np.maximum(ax1[:, None], bx1[None]))
    iy = np.maximum(0.0, np.minimum(ay2[:, None], by2[None])
                    - np.maximum(ay1[:, None], by1[None]))
    inter = ix * iy
    union = (a[:, 2] * a[:, 3])[:, None] + (b[:, 2] * b[:, 3])[None] - inter
    return np.where(union > 0, inter / union, 0.0)


def assign(tracks: np.ndarray, dets: np.ndarray,
           min_iou: float = 0.3) -> np.ndarray:
    """Track→detection assignment ([N] det index or -1), Hungarian on
    1 − IoU in the native library."""
    n, m = len(tracks), len(dets)
    if n == 0:
        return np.empty(0, np.int32)
    if m == 0:
        return np.full(n, -1, np.int32)
    t = np.ascontiguousarray(tracks, np.float32)
    d = np.ascontiguousarray(dets, np.float32)
    out = np.empty(n, np.int32)
    native.load().iou_assign(t.ctypes.data_as(native.F32P), n,
                             d.ctypes.data_as(native.F32P), m, min_iou,
                             out.ctypes.data_as(native.I32P))
    return out


def assign_greedy(tracks: np.ndarray, dets: np.ndarray,
                  min_iou: float = 0.3) -> np.ndarray:
    """Greedy highest-IoU-first matching in numpy: the Hungarian
    assignment's result wherever the best pairs do not compete."""
    n, m = len(tracks), len(dets)
    out = np.full(n, -1, np.int32)
    if n == 0 or m == 0:
        return out
    iou = iou_matrix(tracks, dets)
    taken = np.zeros(m, bool)
    order = np.dstack(np.unravel_index(np.argsort(-iou, axis=None),
                                       iou.shape))[0]
    for ti, di in order:
        if out[ti] == -1 and not taken[di] and iou[ti, di] >= min_iou:
            out[ti] = di
            taken[di] = True
    return out


@dataclasses.dataclass
class _Track:
    track_id: int
    bbox: np.ndarray            # xywh
    velocity: np.ndarray        # d(xywh)/frame
    frames: list
    bboxes: list
    misses: int = 0
    hits: int = 1


class BBoxTracker:
    """Constant-velocity IoU tracker producing the reference contract."""

    def __init__(self, min_iou: float = 0.3, max_misses: int = 15,
                 min_track_len: int = 2):
        self.min_iou = min_iou
        self.max_misses = max_misses
        self.min_track_len = min_track_len
        self._tracks: list[_Track] = []
        self._finished: list[_Track] = []
        self._next_id = 1

    def step(self, frame_idx: int, dets: np.ndarray) -> None:
        """Advance one frame with [K, 4] xywh detections."""
        dets = np.asarray(dets, np.float32).reshape(-1, 4)
        for t in self._tracks:
            t.bbox = t.bbox + t.velocity
        preds = (np.stack([t.bbox for t in self._tracks])
                 if self._tracks else np.empty((0, 4), np.float32))
        match = assign(preds, dets, self.min_iou)

        taken = set()
        for t, di in zip(list(self._tracks), match):
            if di >= 0:
                new = dets[di]
                t.velocity = 0.5 * t.velocity + 0.5 * (new - t.bbox)
                t.bbox = new
                t.frames.append(frame_idx)
                t.bboxes.append(new.copy())
                t.misses = 0
                t.hits += 1
                taken.add(int(di))
            else:
                t.misses += 1
                if t.misses > self.max_misses:
                    self._tracks.remove(t)
                    self._finished.append(t)
        for di in range(len(dets)):
            if di not in taken:
                self._tracks.append(_Track(
                    track_id=self._next_id, bbox=dets[di].copy(),
                    velocity=np.zeros(4, np.float32),
                    frames=[frame_idx], bboxes=[dets[di].copy()]))
                self._next_id += 1

    def results(self, min_frames: int = 1) -> dict:
        """Tracklets in the reference contract ({pid: bbox/frames})."""
        out = {}
        for t in self._finished + self._tracks:
            if len(t.frames) < max(min_frames, self.min_track_len):
                continue
            bb = np.stack(t.bboxes)
            # xywh → center format (cx, cy, w, h), as the tracker's output.
            cxy = bb[:, :2] + bb[:, 2:] / 2.0
            out[t.track_id] = {
                "bbox": np.concatenate([cxy, bb[:, 2:]], axis=1),
                "frames": np.asarray(t.frames, np.int64),
            }
        return out


def track_video(detections_per_frame: list, min_iou: float = 0.3,
                min_frames: int = 25) -> dict:
    """Run the tracker over a whole video's detections."""
    tracker = BBoxTracker(min_iou=min_iou)
    for i, dets in enumerate(detections_per_frame):
        tracker.step(i, np.asarray(dets, np.float32).reshape(-1, 4))
    return tracker.results(min_frames=min_frames)
