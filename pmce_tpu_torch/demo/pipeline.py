"""End-to-end in-the-wild video pipeline: video → tracked 3D meshes → video.

Port of ``pmce_tpu/demo/pipeline.py``, with the stages of the reference's
main/run_demo.py:176-446:
  decode → person tracking → per-crop 2D pose (ViTPose) → per-crop ResNet
  features → sliding 16-frame windows → PMCE mesh recovery → per-window
  camera fit → mesh overlay render → encode.

- ViTPose and the feature extractor run batched over all (frame × person)
  crops (the reference calls mmpose one frame × one person at a time);
- cropping is the batched resampling product (``preprocess.py``) on the
  device, so the raw frames cross to the card once (``upload_frames``) and
  each tracklet's frames are a gather on the card;
- the per-window 300-step Adam camera fit is one closed-form batched
  least-squares solve (``camera.py``);
- windows go through PMCE ``window_batch`` at a time, the last batch padded
  to that size, so the model sees one shape.

With ``DemoConfig.telemetry`` each stage's wall time is taken with the
card synchronized before its clock stops.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch

from pmce_tpu_torch.data.aug import j2d_processing
from pmce_tpu_torch.data.kp_utils import add_pelvis_and_neck
from pmce_tpu_torch.demo.camera import (
    convert_crop_cam_to_orig_img,
    fit_cam_closed_form,
)
from pmce_tpu_torch.demo.preprocess import (
    crop_resize_normalize,
    square_crop_bbox,
)
from pmce_tpu_torch.demo.renderer import Renderer
from pmce_tpu_torch.demo.tracker import iou_matrix, track_video
from pmce_tpu_torch.models.vitpose import (
    decode_heatmaps,
    heatmap_to_image_coords,
)
from pmce_tpu_torch.ops.coords import (
    get_bbox,
    normalize_screen_coordinates,
    process_bbox,
)


def demo_window_list(n: int, seqlen: int = 16) -> list:
    """The reference's sliding windows with edge-padded singletons
    (lib/utils/_dataset_demo.py:91-95): every one of the n frames gets
    exactly one window whose mid frame is that frame.

    Tracklets shorter than one window (the reference never sees these —
    its MIN_NUM_FRAMES gate is 25, ours clamps to the clip length) get one
    singleton window per frame, keeping the one-window-per-frame invariant
    the camera fit depends on."""
    if n < seqlen:
        return [[i, i] for i in range(n)]
    seq = [[i, i + seqlen - 1] for i in range(n - seqlen + 1)]
    for i in range(1, seqlen // 2 + 1):
        seq.insert(0, [seqlen // 2 - i, seqlen // 2 - i])
    for i in range(1, seqlen // 2):
        seq.append([n - seqlen // 2 + i, n - seqlen // 2 + i])
    return seq


def window_index_matrix(windows: list, seqlen: int = 16) -> np.ndarray:
    """Window list → [W, seqlen] frame-index matrix (singletons repeat)."""
    out = np.empty((len(windows), seqlen), np.int32)
    for i, (s, e) in enumerate(windows):
        out[i] = s if s == e else np.arange(s, s + seqlen)
    return out


def gather_windows(arr: np.ndarray, windows: list,
                   seqlen: int = 16) -> np.ndarray:
    """[N, ...] per-frame array → [W, seqlen, ...] window batch (host)."""
    return np.asarray(arr)[window_index_matrix(windows, seqlen)]


@dataclasses.dataclass
class DemoModels:
    """The model stages the pipeline calls (each on the pipeline's
    device, without autograd)."""

    pmce_apply: Callable          # (pose2d [B,T,J,2], feat [B,T,2048]) →
                                  #   (mesh, evo_pose, pose3d)
    feature_apply: Callable       # crops [N,3,224,224] → [N,2048]
    pose2d_apply: Callable | None  # crops [N,3,256,192] → heatmaps; None =
                                   # use detector keypoints directly
    joint_regressor: np.ndarray   # [17, V] for the camera fit, in the 2D
                                  # keypoints' joint order (COCO-17;
                                  # smpl/joints.py coco17_regressor)
    faces: np.ndarray


@dataclasses.dataclass
class DemoConfig:
    seqlen: int = 16
    crop_scale: float = 1.1
    virtual_crop_size: int = 500
    min_track_frames: int = 25
    feature_batch: int = 64
    window_batch: int = 32
    pose_crop_hw: tuple = (256, 192)
    # Per-stage wall timing, the card synchronized before each stage's
    # clock stops.
    telemetry: bool = False


class DemoPipeline:
    def __init__(self, models: DemoModels, config: DemoConfig | None = None,
                 device="cuda"):
        self.m = models
        self.cfg = config or DemoConfig()
        self.device = torch.device(device)
        self._verbose = bool(os.environ.get("PMCE_TPU_VERBOSE"))
        self._t0 = time.time()
        self.stage_seconds = collections.defaultdict(float)
        self._transfer_seconds = 0.0

    def _log(self, msg: str) -> None:
        if self._verbose:
            print(f"[pipeline +{time.time() - self._t0:7.1f}s] {msg}",
                  flush=True)

    def reset_telemetry(self) -> None:
        """Zero the stage clocks (between the warm-up pass, which absorbs
        every shape's first call, and the measured pass)."""
        self.stage_seconds = collections.defaultdict(float)
        self._transfer_seconds = 0.0

    def add_stage_seconds(self, name: str, seconds: float) -> None:
        """Account an external stage (the person detector, which runs
        before the pipeline owns the frames) into the stage table."""
        self.stage_seconds[name] += seconds

    # -------------------------------------------------------- telemetry
    def sync(self) -> None:
        """Wait for the card's queue (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def _stage(self, name: str, *, transfer: bool = False):
        """Time one stage, the card synchronized before the clock stops."""
        if not self.cfg.telemetry:
            yield
            return
        t0 = time.perf_counter()
        yield
        self.sync()
        dt = time.perf_counter() - t0
        self.stage_seconds[name] += dt
        if transfer:
            self._transfer_seconds += dt

    def stage_report(self, n_frames: int) -> dict:
        """Per-stage seconds, their total and the frames/s it gives."""
        total = sum(self.stage_seconds.values())
        return {
            "stage_seconds": dict(self.stage_seconds),
            "transfer_seconds": self._transfer_seconds,
            "total_seconds": total,
            "fps_measured": n_frames / total if total else float("nan"),
        }

    def print_stage_table(self, n_frames: int) -> dict:
        rep = self.stage_report(n_frames)
        print(f"{'stage':<14}{'seconds':>9}  share")
        for name, s in sorted(rep["stage_seconds"].items(),
                              key=lambda kv: -kv[1]):
            share = s / rep["total_seconds"] * 100.0
            print(f"{name:<14}{s:>9.4f}  {share:4.1f}%")
        print(f"{'TOTAL':<14}{rep['total_seconds']:>9.4f}  "
              f"-> {rep['fps_measured']:.1f} fps "
              f"(host-to-device copies {rep['transfer_seconds']:.4f} s)")
        return rep

    # ------------------------------------------------------------ stages
    def upload_frames(self, frames: np.ndarray) -> torch.Tensor:
        """Copy the whole video to the device once; the detector and every
        tracklet's crops then gather from this stack."""
        with self._stage("h2d_frames", transfer=True):
            frames_dev = torch.from_numpy(
                np.ascontiguousarray(frames)).to(self.device)
        return frames_dev

    def keypoints_for_crops(self, frames_dev: torch.Tensor,
                            crop_boxes: np.ndarray, n: int) -> np.ndarray:
        """2D keypoints (COCO-17 + score, full-frame pixels) [n, 17, 3] for
        person crops of the (padded) device-resident frame stack; only the
        decoded keypoints come back to the host."""
        ch, cw = self.cfg.pose_crop_hw
        # Grow the square box to the 256:192 aspect about the person's
        # center (mmpose's xywh2cs).
        boxes = crop_boxes.copy()
        new_h = boxes[:, 2] * ch / cw
        boxes[:, 1] -= (new_h - boxes[:, 3]) / 2.0
        boxes[:, 3] = new_h
        pad_n = len(frames_dev) - len(boxes)
        boxes_pad = (np.concatenate(
            [boxes, np.repeat(boxes[-1:], pad_n, axis=0)])
            if pad_n else boxes)
        boxes_dev = torch.from_numpy(boxes_pad).to(self.device)
        kps = []
        B = self.cfg.feature_batch
        for i in range(0, len(frames_dev), B):
            # Box width → cw columns, height → ch rows: the scales
            # heatmap_to_image_coords inverts.
            crops = crop_resize_normalize(frames_dev[i:i + B],
                                          boxes_dev[i:i + B],
                                          out_size=(ch, cw))
            hm = self.m.pose2d_apply(crops)
            k_hm, scores = decode_heatmaps(hm)
            k_img = heatmap_to_image_coords(
                k_hm.cpu().numpy(), boxes_pad[i:i + B],
                heatmap_size=tuple(hm.shape[2:]), crop_size=(ch, cw))
            kps.append(np.concatenate(
                [k_img, scores.cpu().numpy()[..., None]], axis=-1))
        return np.concatenate(kps)[:n]

    def run_tracklet(self, frames: np.ndarray, bboxes_cxcywh: np.ndarray,
                     frame_ids: np.ndarray,
                     keypoints: np.ndarray | None = None,
                     video_dev: torch.Tensor | None = None) -> dict:
        """Process one person tracklet.

        Args:
          frames: [N, H, W, 3] uint8 — the tracklet's frames.
          bboxes_cxcywh: [N, 4] tracker output (cx, cy, w, h).
          frame_ids: [N] original frame indices.
          keypoints: optional [N, 17, 3] detector keypoints (skips ViTPose).
          video_dev: optional device-resident full-video stack
            (:meth:`upload_frames`); the tracklet's frames are then a
            gather on the device instead of a fresh copy.

        Returns:
          {"mesh": [N, V, 3], "cam": [N, 3], "orig_cam": [N, 4],
           "bboxes": [N, 4 xywh], "frames": [N]}.
        """
        cfg = self.cfg
        dev = self.device
        H, W = frames.shape[1:3]
        xy = bboxes_cxcywh[:, :2] - bboxes_cxcywh[:, 2:] / 2.0
        xywh = np.concatenate([xy, bboxes_cxcywh[:, 2:]], axis=1)
        crop_boxes = square_crop_bbox(xywh, scale=cfg.crop_scale)

        self._log(f"tracklet: {len(frames)} frames")
        n = len(frames)
        B = cfg.feature_batch
        pad_n = (-n) % B
        boxes_pad_np = (np.concatenate(
            [crop_boxes, np.repeat(crop_boxes[-1:], pad_n, axis=0)])
            if pad_n else crop_boxes)
        if video_dev is not None:
            idx = np.concatenate([frame_ids, np.repeat(frame_ids[-1:], pad_n)])
            frames_dev = video_dev.index_select(
                0, torch.from_numpy(idx.astype(np.int64)).to(dev))
            boxes_dev = torch.from_numpy(boxes_pad_np).to(dev)
        else:
            with self._stage("h2d_frames", transfer=True):
                frames_dev = torch.from_numpy(np.concatenate(
                    [frames, np.repeat(frames[-1:], pad_n, axis=0)])).to(dev)
                boxes_dev = torch.from_numpy(boxes_pad_np).to(dev)

        # --- 2D keypoints (COCO-17 + pelvis/neck → 19) ---
        if keypoints is None:
            if self.m.pose2d_apply is None:
                raise ValueError(
                    "no keypoints supplied and DemoModels.pose2d_apply is "
                    "None — pass keypoints_per_frame or configure a 2D "
                    "pose model")
            with self._stage("pose2d"):
                keypoints = self.keypoints_for_crops(frames_dev, crop_boxes,
                                                     n)
        kp19 = add_pelvis_and_neck(keypoints[..., :2], lhip=11, rhip=12,
                                   lshoulder=5, rshoulder=6)

        self._log("2d keypoints ready")
        # --- per-frame image features (device-resident) ---
        with self._stage("features"):
            feats = []
            for i in range(0, n + pad_n, B):
                crops = crop_resize_normalize(frames_dev[i:i + B],
                                              boxes_dev[i:i + B],
                                              out_size=224)
                feats.append(self.m.feature_apply(crops))
            feats_dev = torch.cat(feats)[:n]          # [N, 2048] on device
        self._log("features ready")

        # --- clip windows → PMCE (window gather on the device) ---
        windows = demo_window_list(n, cfg.seqlen)
        norm_kp_dev = normalize_screen_coordinates(
            torch.from_numpy(np.ascontiguousarray(kp19, np.float32)).to(dev),
            W, H)
        win_idx = window_index_matrix(windows, cfg.seqlen)
        nw = len(windows)
        WB = cfg.window_batch
        pad = (-nw) % WB
        if pad:
            win_idx = np.concatenate(
                [win_idx, np.repeat(win_idx[-1:], pad, axis=0)])
        win_idx_dev = torch.from_numpy(win_idx.astype(np.int64)).to(dev)

        with self._stage("pmce"):
            meshes = []
            for i in range(0, nw + pad, WB):
                idx = win_idx_dev[i:i + WB]
                mesh_b, _evo, _p3d = self.m.pmce_apply(norm_kp_dev[idx],
                                                       feats_dev[idx])
                meshes.append(mesh_b)
            mesh = torch.cat(meshes)[:nw].float().cpu().numpy()  # meters
        self._log("meshes ready")

        # --- camera fit (closed form, batched) ---
        # Target: the mid-frame 2D joints mapped into the virtual crop.
        vsize = cfg.virtual_crop_size
        with self._stage("camera_fit"):
            pred_joints = np.einsum("jv,nvk->njk", self.m.joint_regressor,
                                    mesh)             # [N, 17, 3] meters
            targets = np.zeros((n, 17, 2), np.float32)
            fit_boxes = np.zeros((n, 4), np.float32)
            for i in range(n):
                tight = get_bbox(kp19[i])
                bbox1 = process_bbox(tight, aspect_ratio=1.0, scale=1.25)
                if bbox1 is None:
                    bbox1 = tight
                fit_boxes[i] = bbox1
                warped, _ = j2d_processing(
                    kp19[i].copy(), (vsize, vsize), bbox1, 0, False, ())
                targets[i] = warped[:17, :2]
            cam = fit_cam_closed_form(torch.from_numpy(pred_joints),
                                      torch.from_numpy(targets),
                                      vsize / 2.0).numpy()
            # Full-frame cameras for rendering: the fit is against the
            # virtual crop around the person, converted through its box.
            orig_cam = convert_crop_cam_to_orig_img(cam, fit_boxes, W, H)
        self._log("cameras fit")

        return {"mesh": mesh, "cam": cam, "orig_cam": orig_cam,
                "bboxes": xywh, "frames": np.asarray(frame_ids)}

    # ------------------------------------------------------- whole video
    @torch.no_grad()
    def run(self, frames: np.ndarray, detections_per_frame: list,
            keypoints_per_frame: list | None = None,
            render: bool = True,
            frames_dev: torch.Tensor | None = None) -> tuple:
        """Full pipeline over a frame stack.

        Args:
          frames: [T, H, W, 3] uint8.
          detections_per_frame: list of [K, 4] xywh person boxes per frame.
          keypoints_per_frame: optional list of [K, 17, 3] keypoints
            aligned with the detections (skips the ViTPose stage).
          frames_dev: optional device-resident copy of ``frames`` from
            :meth:`upload_frames` (shared with the detector); made here if
            absent.

        Returns:
          (results dict {person_id: tracklet outputs},
           rendered frames [T, H, W, 3] or None).
        """
        if frames_dev is None:
            frames_dev = self.upload_frames(frames)
        # The reference's MIN_NUM_FRAMES=25, clamped to the clip length so
        # that short videos still produce tracks.
        with self._stage("track"):
            tracks = track_video(detections_per_frame,
                                 min_frames=min(self.cfg.min_track_frames,
                                                len(frames)))
        results = {}
        for pid, tr in tracks.items():
            f_ids = tr["frames"]
            kps = None
            if keypoints_per_frame is not None:
                # Associate each frame's keypoint set with this track by
                # IoU against the track's box.
                rows = []
                for j, f in enumerate(f_ids):
                    cands = np.asarray(keypoints_per_frame[f], np.float32)
                    if cands.ndim == 2:
                        cands = cands[None]
                    k = 0
                    if len(cands) > 1:
                        kp_boxes = np.stack(
                            [get_bbox(c[:, :2]) for c in cands])
                        cx, cy, w, h = tr["bbox"][j]
                        tb = np.array([[cx - w / 2, cy - h / 2, w, h]],
                                      np.float32)
                        k = int(np.argmax(iou_matrix(kp_boxes, tb)[:, 0]))
                    rows.append(cands[k])
                kps = np.stack(rows)
            results[pid] = self.run_tracklet(
                frames[f_ids], tr["bbox"], f_ids, keypoints=kps,
                video_dev=frames_dev)

        rendered = None
        if render and results:
            with self._stage("render"):
                H, W = frames.shape[1:3]
                renderer = Renderer(self.m.faces, resolution=(W, H))
                rendered = frames.copy()
                for t in range(len(frames)):
                    # Depth-sort people by bbox top edge, as the
                    # reference's prepare_rendering_results (bbox[1]).
                    persons = []
                    for pid, res in results.items():
                        hit = np.nonzero(res["frames"] == t)[0]
                        if len(hit):
                            i = int(hit[0])
                            persons.append((res["bboxes"][i][1], pid, i))
                    persons.sort(key=lambda p: p[0])
                    for _, pid, i in persons:
                        res = results[pid]
                        rendered[t] = renderer.render(
                            rendered[t], res["mesh"][i], res["orig_cam"][i])
        return results, rendered
