"""First-party person detector: anchor-free center-point detection.

Port of ``pmce_tpu/demo/detector.py``. It closes the reference demo's
external dependency (a CUDA YOLOv3 through the multi-person-tracker
package, main/run_demo.py:199-215, whose weights are downloads): a small
anchor-free network (CenterNet-style: stride-8 center heatmap + box size +
sub-cell offset) trained on synthetic SMPL renders from the port's own
SMPL layer and rasterizer, with no external weights.

- [N, S, S, 3] frames in 0..1 (resized on the frames' device by the crop
  stage's resampler) → heat [N, s, s], size and offset [N, s, s, 2], the
  JAX model's channels-last outputs; the convolutions run NCHW;
- decode = 3×3 max-pool peak suppression + top-k; the host sees the final
  boxes per frame;
- training: penalty-reduced focal loss on the heatmap + masked L1 on size
  and offset (the CenterNet objective), Adam at lr 1e-3, 600 steps of 32
  renders; the initial weights are flax's, drawn from an explicit
  ``torch.Generator``. The trained weights are cached under
  ``pmce_tpu_torch/_cache/`` (git-ignored).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pmce_tpu_torch.models.layers import init_like_jax

INPUT_SIZE = 128          # square detector input (resized from the frame)
STRIDE = 8                # heatmap stride
CACHE_DIR = Path(__file__).resolve().parent.parent / "_cache"


class ConvBlock(nn.Module):
    """3×3 conv (no bias) → GroupNorm (flax's eps 1e-6) → ReLU."""

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, 3, stride=stride, padding=1,
                              bias=False)
        self.norm = nn.GroupNorm(min(8, features), features, eps=1e-6)

    def forward(self, x):
        return F.relu(self.norm(self.conv(x)))


class PersonDetector(nn.Module):
    """[N, S, S, 3] (0..1 floats) → center/size/offset maps at stride 8."""

    def __init__(self, width: int = 32):
        super().__init__()
        w = width
        plan = ((3, w, 2), (w, w, 1), (w, 2 * w, 2), (2 * w, 2 * w, 1),
                (2 * w, 4 * w, 2), (4 * w, 4 * w, 1), (4 * w, 4 * w, 1))
        self.blocks = nn.Sequential(*(ConvBlock(i, o, s) for i, o, s in plan))
        self.head_heat = nn.Conv2d(4 * w, 1, 1)
        self.head_size = nn.Conv2d(4 * w, 2, 1)
        self.head_off = nn.Conv2d(4 * w, 2, 1)

    def forward(self, x: torch.Tensor) -> dict:
        x = self.blocks(x.permute(0, 3, 1, 2))
        return {"heat": self.head_heat(x)[:, 0],
                "size": self.head_size(x).permute(0, 2, 3, 1),
                "off": self.head_off(x).permute(0, 2, 3, 1)}

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initial values, drawn from ``generator``: convolutions
        lecun-normal, biases 0 but the heat head's −2.19, GroupNorm scale
        1 and bias 0."""
        for name, p in self.named_parameters():
            init_like_jax(p, name, generator)
        self.head_heat.bias.fill_(-2.19)


# ------------------------------------------------------------------ decode
def decode_detections(out: dict, top_k: int = 4) -> tuple:
    """Center maps → boxes.

    Returns:
      boxes [N, top_k, 4] (x, y, w, h) in INPUT_SIZE pixels, scores
      [N, top_k] (sigmoid heat, 0 where suppressed by peak NMS).
    """
    heat = torch.sigmoid(out["heat"])                      # [N, s, s]
    peak = F.max_pool2d(heat[:, None], 3, stride=1, padding=1)[:, 0]
    heat = torch.where(heat == peak, heat, 0.0)
    N, s, _ = heat.shape
    scores, idx = heat.reshape(N, s * s).topk(top_k, dim=-1)
    ys = (idx // s).float()
    xs = (idx % s).float()

    def gather(m):
        return m.reshape(N, s * s, 2).gather(
            1, idx[..., None].expand(N, top_k, 2))

    wh = gather(out["size"]) * INPUT_SIZE                  # [N, k, 2]
    off = gather(out["off"])
    cx = (xs + 0.5 + off[..., 0]) * STRIDE
    cy = (ys + 0.5 + off[..., 1]) * STRIDE
    boxes = torch.stack([cx - wh[..., 0] / 2, cy - wh[..., 1] / 2,
                         wh[..., 0], wh[..., 1]], -1)
    return boxes, scores


# -------------------------------------------------------------------- loss
def make_targets(boxes: np.ndarray) -> dict:
    """GT boxes [N, 4] (one person per frame, INPUT_SIZE px) → dense maps."""
    n = len(boxes)
    s = INPUT_SIZE // STRIDE
    heat = np.zeros((n, s, s), np.float32)
    size = np.zeros((n, s, s, 2), np.float32)
    off = np.zeros((n, s, s, 2), np.float32)
    mask = np.zeros((n, s, s), np.float32)
    for i, (x, y, w, h) in enumerate(boxes):
        # Continuous center in cell units; the peak cell is the one whose
        # center (index + 0.5) is nearest, and the offset is relative to
        # that cell center: decode inverts exactly, (i + 0.5 + off) · S.
        cx, cy = (x + w / 2) / STRIDE, (y + h / 2) / STRIDE
        ix = int(np.clip(np.floor(cx), 0, s - 1))
        iy = int(np.clip(np.floor(cy), 0, s - 1))
        # Gaussian splat with radius from the box size (CenterNet recipe),
        # centered on the peak cell so that argmax is the annotated cell.
        sigma = max(1.0, min(w, h) / STRIDE / 3.0)
        yy, xx = np.mgrid[0:s, 0:s]
        g = np.exp(-((xx - ix) ** 2 + (yy - iy) ** 2) / (2 * sigma ** 2))
        heat[i] = np.maximum(heat[i], g)
        size[i, iy, ix] = (w / INPUT_SIZE, h / INPUT_SIZE)
        off[i, iy, ix] = (cx - 0.5 - ix, cy - 0.5 - iy)
        mask[i, iy, ix] = 1.0
    return {"heat": heat, "size": size, "off": off, "mask": mask}


def detector_loss(out: dict, tgt: dict) -> torch.Tensor:
    """Penalty-reduced focal loss + masked L1 on size/offset."""
    p = torch.sigmoid(out["heat"])
    pos = (tgt["heat"] >= 0.999).float()
    neg_w = (1.0 - tgt["heat"]) ** 4
    eps = 1e-6
    pos_loss = -torch.log(p + eps) * (1 - p) ** 2 * pos
    neg_loss = -torch.log(1 - p + eps) * p ** 2 * neg_w * (1 - pos)
    n_pos = pos.sum().clamp_min(1.0)
    focal = (pos_loss.sum() + neg_loss.sum()) / n_pos

    m = tgt["mask"][..., None]
    l1_size = ((out["size"] - tgt["size"]).abs() * m).sum() / n_pos
    l1_off = ((out["off"] - tgt["off"]).abs() * m).sum() / n_pos
    return focal + 5.0 * l1_size + 1.0 * l1_off


# ---------------------------------------------------------------- training
def render_training_set(art, n: int, seed: int = 0,
                        size: int = INPUT_SIZE) -> tuple:
    """Synthetic SMPL renders + tight GT boxes.

    Random poses/shapes through the port's SMPL layer on the CPU (plain
    skinning, ``fused=False``, as JAX's renders), random weak-perspective
    cameras, random background gray + noise; box = the rendered
    silhouette's tight bbox.
    """
    from pmce_tpu_torch.demo.renderer import Renderer
    from pmce_tpu_torch.smpl.layer import SMPLModel, smpl_forward

    rng = np.random.default_rng(seed)
    model = SMPLModel.from_artifacts(art, device="cpu")
    pose = rng.normal(scale=0.25, size=(n, 72)).astype(np.float32)
    pose[:, :3] = rng.normal(scale=0.6, size=(n, 3))
    shape = rng.normal(scale=0.7, size=(n, 10)).astype(np.float32)
    with torch.no_grad():
        verts, _ = smpl_forward(model, torch.from_numpy(pose),
                                torch.from_numpy(shape), fused=False)
    verts = verts.numpy()
    renderer = Renderer(art.faces, resolution=(size, size), alpha=1.0)

    frames = np.empty((n, size, size, 3), np.float32)
    boxes = np.empty((n, 4), np.float32)
    for i in range(n):
        bg = int(rng.integers(20, 120))
        frame = np.full((size, size, 3), bg, np.uint8)
        frame += rng.integers(0, 25, frame.shape).astype(np.uint8)
        scale = 0.3 + 0.35 * rng.random()
        cam = np.array([scale, scale, rng.uniform(-0.5, 0.5),
                        rng.uniform(-0.3, 0.3)], np.float32)
        before = frame.copy()
        frame = renderer.render(frame, verts[i], cam)
        fg = np.any(frame != before, axis=-1)
        ys, xs = np.nonzero(fg)
        if len(xs) == 0:       # body out of frame: retry with centered cam
            cam = np.array([0.45, 0.45, 0.0, 0.0], np.float32)
            frame = renderer.render(before, verts[i], cam)
            fg = np.any(frame != before, axis=-1)
            ys, xs = np.nonzero(fg)
        boxes[i] = (xs.min(), ys.min(), xs.max() - xs.min() + 1,
                    ys.max() - ys.min() + 1)
        frames[i] = frame.astype(np.float32) / 255.0
    return frames, boxes


def train_detector(art, steps: int = 600, batch: int = 32,
                   n_frames: int = 512, seed: int = 0, lr: float = 1e-3,
                   width: int = 32, device="cuda",
                   log_fn=None) -> PersonDetector:
    """Train a PersonDetector on synthetic renders (kept on ``device``);
    returns it in eval mode. The batches are drawn as JAX's are, from
    ``np.random.default_rng(seed)``."""
    frames, boxes = render_training_set(art, n_frames, seed=seed)
    frames = torch.from_numpy(frames).to(device)
    targets = {k: torch.from_numpy(v).to(device)
               for k, v in make_targets(boxes).items()}
    model = PersonDetector(width=width).to(device)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    rng = np.random.default_rng(seed)
    for i in range(steps):
        idx = torch.from_numpy(rng.integers(len(frames), size=batch)).to(
            device)
        loss = detector_loss(model(frames[idx]),
                             {k: v[idx] for k, v in targets.items()})
        opt.zero_grad()
        loss.backward()
        opt.step()
        if log_fn is not None and (i + 1) % 100 == 0:
            log_fn(f"detector step {i + 1}/{steps}: loss {loss.item():.4f}")
    return model.eval()


# --------------------------------------------------------------- inference
class Detector:
    """Frame-batch person detection with resize bookkeeping."""

    def __init__(self, model: PersonDetector, score_thresh: float = 0.3):
        self.model = model.eval()
        self.score_thresh = score_thresh

    def detect_video(self, frames: torch.Tensor, batch: int = 64) -> list:
        """frames [T, H, W, 3] uint8 (a tensor on the detector's device,
        e.g. ``DemoPipeline.upload_frames``' stack, so that the video
        crosses to the card once) → per-frame [n_i, 4] float boxes
        (full-frame pixels) for the tracker."""
        from pmce_tpu_torch.demo.preprocess import resize_frames

        T, H, W = frames.shape[:3]
        sx, sy = W / INPUT_SIZE, H / INPUT_SIZE
        out = []
        with torch.no_grad():
            for i in range(0, T, batch):
                small = resize_frames(frames[i:i + batch],
                                      (INPUT_SIZE, INPUT_SIZE))
                boxes, scores = decode_detections(self.model(small))
                for b, s in zip(boxes.cpu().numpy(), scores.cpu().numpy()):
                    bb = b[s >= self.score_thresh]
                    out.append(np.stack([bb[:, 0] * sx, bb[:, 1] * sy,
                                         bb[:, 2] * sx, bb[:, 3] * sy], -1)
                               if len(bb) else np.zeros((0, 4), np.float32))
        return out


def ensure_cached_detector(art, cache_dir: str | Path | None = None,
                           device="cuda", log_fn=print,
                           **train_kw) -> Detector:
    """Load the cached synthetic-trained detector, training it on first use
    (the self-contained replacement for the reference's external YOLOv3).
    The cache key carries the training hyperparameters: weights trained at
    another width would not load."""
    cache_dir = Path(cache_dir or CACHE_DIR)
    cache_dir.mkdir(parents=True, exist_ok=True)
    tag = "_".join(f"{k}{v}" for k, v in sorted(train_kw.items()))
    path = cache_dir / f"person_detector{('_' + tag) if tag else ''}.pt"
    width = train_kw.get("width", 32)
    if path.is_file():
        model = PersonDetector(width=width)
        model.load_state_dict(torch.load(path, map_location="cpu",
                                         weights_only=True))
        model = model.to(device)
    else:
        log_fn("no cached detector: training on synthetic renders "
               "(one-time)...")
        model = train_detector(art, device=device, log_fn=log_fn, **train_kw)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        torch.save(model.state_dict(), tmp)
        os.replace(tmp, path)
    return Detector(model)
