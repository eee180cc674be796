"""Video demo CLI of the port.

    python -m pmce_tpu_torch.main.run_demo --synthetic --full-stack \
        --vitpose huge

Port of ``main/run_demo.py`` (the reference's main/run_demo.py): decode →
track → 2D pose → features → PMCE → camera fit → render → encode, on the
card unless ``--device cpu`` is given. The flags are the JAX CLI's, with
``--device`` in place of ``--platform``:

- ``--synthetic`` renders a moving body (no input needed); with
  ``--full-stack`` the first-party detector (trained on synthetic SMPL
  renders at first use, then cached) finds it and ViTPose (Huge unless
  ``--vitpose`` says otherwise) gives its 2D keypoints, in place of the
  rendering's own boxes and joints;
- ``--vid_file`` (.mp4 through ffmpeg, or .npy frames) with
  ``--detections`` (an npz of ``boxes_<t>`` and optional ``kps_<t>``) or the
  first-party detector. Real footage with randomly initialized stages is
  refused unless ``--allow-random-weights`` is given;
- ``--weights`` a PMCE checkpoint of the port's trainer; ``--spin-weights``
  and ``--vitpose-weights`` the reference's torch files (a SPIN
  ``checkpoint['model']``, an mmpose ``state_dict``), whose names the
  port's modules carry;
- ``--precision bf16`` (the default) serves PMCE in bf16 on its kernels
  (the lifter trunk, the GRU scan and the decoder chain) and runs the
  backbones' products in bf16, the heatmap head in f32; ``f32`` runs
  everything in f32 on the plain path.

It writes ``demo_meta.json`` (the stage table when telemetry is on),
``demo_frames.npy`` and, where ffmpeg is installed, ``demo_output.mp4``
under ``--output``. ``--record-perf [--perf-path P]`` records the stage
table in the port's perf file (``pmce_tpu_torch/utils/perf.py``,
``PERF_TORCH.json`` by default): ``demo_full_stack`` for ``--synthetic
--full-stack``, ``demo_real_footage`` for ``--vid_file``. Recording is
opt-in in both modes; JAX's CLI records the synthetic full-stack run
unconditionally, but here that would make every run (``chip_smoke.py``'s
among them) rewrite a file in the tree.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from pmce_tpu_torch.core import checkpoint as ckpt_lib
from pmce_tpu_torch.demo import video_io
from pmce_tpu_torch.demo.detector import ensure_cached_detector
from pmce_tpu_torch.demo.pipeline import DemoConfig, DemoModels, DemoPipeline
from pmce_tpu_torch.demo.renderer import Renderer, project_weak_perspective
from pmce_tpu_torch.main.common import describe, resolve_device
from pmce_tpu_torch.models.pmce import create_pmce
from pmce_tpu_torch.models.spin import ResNet50
from pmce_tpu_torch.models.vitpose import ViTPose, ViTPoseConfig
from pmce_tpu_torch.smpl.artifacts import ensure_cached_artifacts
from pmce_tpu_torch.smpl.joints import coco17_regressor
from pmce_tpu_torch.smpl.layer import SMPLModel, smpl_forward
from pmce_tpu_torch.smpl.mesh import ensure_cached_coarsening
from pmce_tpu_torch.utils import perf


def _synthetic_video(art, T=48, H=240, W=320):
    """A body turning an arm while it slides across the frame, rendered on
    a flat background; with its tight boxes, its projected 17 joints as
    keypoints, and the 17-row regressor that gives them."""
    model = SMPLModel.from_artifacts(art, device="cpu")
    pose = np.zeros((T, 72), np.float32)
    pose[:, 50] = np.linspace(0, 0.8, T)
    with torch.no_grad():
        verts, _ = smpl_forward(model, torch.from_numpy(pose),
                                torch.zeros(T, 10), fused=False)
    verts = verts.numpy()
    renderer = Renderer(art.faces, resolution=(W, H), alpha=1.0)
    frames = np.full((T, H, W, 3), 30, np.uint8)
    cams = [np.array([0.45, 0.45 * (W / H), -0.6 + 1.2 * t / T, 0.0],
                     np.float32) for t in range(T)]
    for t in range(T):
        frames[t] = renderer.render(frames[t], verts[t], cams[t])

    dets, kps = [], []
    jr17 = np.random.default_rng(1).random(
        (17, art.num_verts)).astype(np.float32)
    jr17 /= jr17.sum(1, keepdims=True)
    for t in range(T):
        fg = np.any(frames[t] != 30, axis=-1)
        ys, xs = np.nonzero(fg)
        dets.append(np.array([[xs.min(), ys.min(),
                               xs.max() - xs.min() + 1,
                               ys.max() - ys.min() + 1]], np.float32))
        j = project_weak_perspective(jr17 @ verts[t], cams[t], W, H)
        kps.append(np.concatenate(
            [j[:, :2], np.ones((17, 1), np.float32)], 1)[None])
    return frames, dets, kps, jr17


def _load_torch_weights(module: torch.nn.Module, path: str) -> None:
    """The reference's torch file into ``module``: the checkpoint's
    ``model`` or ``state_dict`` entry (or the file itself), restricted to
    the module's names, which must all be there."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    sd = raw.get("model", raw.get("state_dict", raw))
    own = module.state_dict()
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"{path}: {len(missing)} of the model's "
                       f"{len(own)} tensors missing, e.g. {missing[:3]}")
    module.load_state_dict({k: sd[k] for k in own})


def perf_entry(args, frames_shape, stage_rep: dict) -> tuple:
    """(key, payload) of ``--record-perf`` for a run on frames of
    ``frames_shape`` [T, H, W, 3]: JAX's keys and fields, or (None, None)
    for a run JAX does not record (synthetic without the full stack)."""
    T, H, W = frames_shape[:3]
    if args.synthetic and args.full_stack:
        key = "demo_full_stack"
        config = (f"--synthetic --full-stack, {T} frames {H}x{W}, "
                  f"ViTPose-{args.vitpose}")
    elif args.vid_file:
        key = "demo_real_footage"
        config = (f"--vid_file {os.path.basename(args.vid_file)} ({T} "
                  f"frames {H}x{W}), ViTPose-{args.vitpose}")
    else:
        return None, None
    return key, {
        "config": config, "n_frames": int(T),
        "fps_measured": round(stage_rep["fps_measured"], 2),
        "stage_seconds": {k: round(v, 4) for k, v in
                          stage_rep["stage_seconds"].items()},
        "source": "python -m pmce_tpu_torch.main.run_demo --record-perf",
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="pmce-tpu video demo (PyTorch)")
    p.add_argument("--vid_file", type=str, default="",
                   help="input video (.mp4 via ffmpeg, or .npy frames)")
    p.add_argument("--synthetic", action="store_true",
                   help="self-contained synthetic-video demo")
    p.add_argument("--detections", type=str, default="",
                   help="npz with boxes_<t> ([K,4] xywh) and optional "
                        "kps_<t> ([K,17,3]) per frame")
    p.add_argument("--weights", type=str, default="",
                   help="PMCE checkpoint of the port's trainer (dir or file)")
    p.add_argument("--output", type=str, default="output/demo_torch")
    p.add_argument("--frames", type=int, default=48,
                   help="synthetic-mode video length")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: the card; cpu for tests)")
    p.add_argument("--vitpose", choices=["tiny", "huge", "off"],
                   default="off",
                   help="2D pose stage ('off' uses detection keypoints)")
    p.add_argument("--vitpose-weights", type=str, default="",
                   help="mmpose ViTPose checkpoint (torch state_dict)")
    p.add_argument("--spin-weights", type=str, default="",
                   help="SPIN checkpoint (torch; its ResNet-50 is used)")
    p.add_argument("--allow-random-weights", action="store_true",
                   help="run real footage with randomly initialized "
                        "model stages (structure check only — outputs "
                        "are meaningless)")
    p.add_argument("--telemetry", action="store_true",
                   help="per-stage wall timing, the card synchronized "
                        "before each stage's clock stops (always on with "
                        "--synthetic)")
    p.add_argument("--full-stack", action="store_true",
                   help="with --synthetic: run the detector and ViTPose "
                        "stages on the synthetic footage instead of "
                        "handing the pipeline its boxes/keypoints")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the telemetry warm-up pass (stage times then "
                        "include first calls: cuDNN plans, allocations)")
    p.add_argument("--precision", choices=["bf16", "f32"], default="bf16",
                   help="bf16: PMCE served in bf16 on its kernels, the "
                        "backbones' products in bf16, the heatmap head "
                        "f32; f32: everything f32 on the plain path")
    p.add_argument("--record-perf", action="store_true",
                   help="record the stage table in the port's perf file "
                        "(demo_full_stack / demo_real_footage)")
    p.add_argument("--perf-path", type=str, default=None,
                   help="perf file of --record-perf (default "
                        "PERF_TORCH.json at the repository root)")
    return p


def main(argv: list | None = None) -> dict:
    """Run the CLI on ``argv`` (default: the command line). Returns the
    run's results: ``results`` (per person: mesh, cam, orig_cam, bboxes,
    frames), ``rendered``, ``fps``, ``stages`` (the stage report or None)
    and, for ``--synthetic``, ``gt_boxes`` (the rendered body's tight
    boxes)."""
    p = build_parser()
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    print(f"[pmce-tpu-torch demo] device={describe(device)}", flush=True)

    art = ensure_cached_artifacts()
    coarse = ensure_cached_coarsening()
    gt_boxes = None
    detector = None
    if args.synthetic:
        frames, dets, kps, jr17 = _synthetic_video(art, T=args.frames)
        gt_boxes = np.concatenate(dets)
        if args.full_stack:
            # Every stage the reference demo pays for: the detector finds
            # the person and ViTPose (Huge, its model class) gives 2D.
            dets, kps = None, None
            if args.vitpose == "off":
                args.vitpose = "huge"
    else:
        if not args.vid_file:
            p.error("--vid_file or --synthetic required")
        if args.detections:
            z = np.load(args.detections)
        # COCO-17-ordered regressor: the camera fit pairs mesh-regressed
        # joints with COCO 2D keypoints, so both share the COCO order.
        jr17 = coco17_regressor(art.J_regressor)

    # Real footage with randomly initialized stages gives meaningless
    # meshes: refuse before anything is built, unless asked.
    if not args.synthetic:
        pose_stage_random = (not args.vitpose_weights and (
            args.vitpose != "off" or not args.detections
            or "kps_0" not in z.files))
        random_stages = [name for name, random in (
            ("PMCE (--weights)", not args.weights),
            ("SPIN features (--spin-weights)", not args.spin_weights),
            ("ViTPose 2D pose (--vitpose-weights)", pose_stage_random),
        ) if random]
        if random_stages and not args.allow_random_weights:
            p.error("real-video run would use RANDOM weights for: "
                    + "; ".join(random_stages)
                    + ". Provide the listed weight flags, or pass "
                      "--allow-random-weights for a structure-only run.")
        frames = np.stack(list(video_io.open_video(args.vid_file)))
        if args.detections:
            dets = [z[f"boxes_{t}"] for t in range(len(frames))]
            kps = ([z[f"kps_{t}"] for t in range(len(frames))]
                   if "kps_0" in z.files else None)
        else:
            dets, kps = None, None
    if dets is None:
        detector = ensure_cached_detector(art, device=device)

    bf16 = args.precision == "bf16"
    cdtype = torch.bfloat16 if bf16 else None
    model, _ = create_pmce(num_joint=19, art=art, coarsening=coarse,
                           joint_regressor_h36m=jr17, dtype=cdtype,
                           fused=bf16, device=device, seed=0)
    if args.weights:
        model.load_state_dict(ckpt_lib.load_checkpoint(args.weights)["params"])

    resnet = ResNet50(dtype=cdtype)
    if args.spin_weights:
        _load_torch_weights(resnet, args.spin_weights)
    else:
        resnet.reset_parameters(torch.Generator().manual_seed(1))
    resnet = resnet.to(device).eval()

    if kps is None and args.vitpose == "off":
        print("note: no detection keypoints available; enabling the "
              "ViTPose stage (tiny; pass --vitpose huge "
              "--vitpose-weights ... for real weights)")
        args.vitpose = "tiny"
    pose2d_apply = None
    if args.vitpose != "off":
        cfg_vp = (ViTPoseConfig.huge(dtype=cdtype) if args.vitpose == "huge"
                  else ViTPoseConfig.tiny(dtype=cdtype))
        vp = ViTPose(cfg_vp)
        if args.vitpose_weights:
            _load_torch_weights(vp, args.vitpose_weights)
        else:
            vp.reset_parameters(torch.Generator().manual_seed(2))
        pose2d_apply = vp.to(device).eval()
        kps = None  # the ViTPose path

    telemetry = args.telemetry or args.synthetic
    pipe = DemoPipeline(
        DemoModels(pmce_apply=model, feature_apply=resnet,
                   pose2d_apply=pose2d_apply, joint_regressor=jr17,
                   faces=art.faces),
        DemoConfig(telemetry=telemetry), device=device)

    def one_pass():
        """The detector (if any) and the pipeline, on one copy of the
        video on the device; the detector is a stage of the table."""
        frames_dev = pipe.upload_frames(frames)
        d = dets
        if detector is not None:
            td = time.perf_counter()
            d = detector.detect_video(frames_dev)
            pipe.sync()
            pipe.add_stage_seconds("detect", time.perf_counter() - td)
        return pipe.run(frames, d, keypoints_per_frame=kps, render=True,
                        frames_dev=frames_dev)

    if telemetry and not args.no_warmup:
        # Pass 1 absorbs the first calls (cuDNN plans, allocations); the
        # stage table is pass 2's.
        t0 = time.perf_counter()
        one_pass()
        print(f"[telemetry] warm-up pass: {time.perf_counter() - t0:.2f} s "
              f"(not in the stage table)")
        pipe.reset_telemetry()

    t0 = time.perf_counter()
    results, rendered = one_pass()
    dt = time.perf_counter() - t0
    fps = len(frames) / dt
    print(f"processed {len(frames)} frames in {dt:.3f} s -> {fps:.1f} "
          f"frames/s end to end ({len(results)} tracked people)")
    stage_rep = (pipe.print_stage_table(len(frames))
                 if telemetry and results else None)
    if stage_rep and args.record_perf:
        key, payload = perf_entry(args, frames.shape, stage_rep)
        if key:
            perf.record(key, payload, path=args.perf_path, device=device)

    os.makedirs(args.output, exist_ok=True)
    meta = {str(pid): {"frames": r["frames"].tolist()}
            for pid, r in results.items()}
    with open(os.path.join(args.output, "demo_meta.json"), "w") as f:
        json.dump({"fps_end_to_end": fps, "device": describe(device),
                   "tracks": meta, "stages": stage_rep}, f, indent=2)
    out = {"results": results, "rendered": rendered, "fps": fps,
           "stages": stage_rep, "gt_boxes": gt_boxes}
    if rendered is None:
        print(f"no people tracked; wrote {args.output}/demo_meta.json only")
        return out
    np.save(os.path.join(args.output, "demo_frames.npy"), rendered)
    if video_io.has_ffmpeg():
        out_path = os.path.join(args.output, "demo_output.mp4")
        w = video_io.FFmpegVideoWriter(out_path, rendered.shape[2],
                                       rendered.shape[1])
        for fr in rendered:
            w.write(fr)
        w.close()
        print(f"wrote {out_path}")
    else:
        print(f"wrote {args.output}/demo_frames.npy (no ffmpeg on host)")
    return out


if __name__ == "__main__":
    main()
