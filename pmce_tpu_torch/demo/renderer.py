"""Mesh overlay renderer (weak-perspective, z-buffered).

Port of ``pmce_tpu/demo/renderer.py`` (the reference's pyrender/OSMesa
renderer, demo/renderer.py:37-118: a weak-perspective camera and the
Rx(180°) mesh flip). The rasterization runs in the port's C++ library
(``pmce_tpu_torch/native/rasterizer.cc``); :func:`rasterize_plain` is the
same algorithm in numpy, the plain reference the tests hold it to.

Pathological-input guards: a CPU rasterizer pays per scanned pixel, so a
broken camera fit that projects screen-filling triangles would cost
O(faces·H·W) per frame. Two guards bound it to O(H·W): a per-triangle
clipped-bbox cap (``max_tri_frac`` of the frame) and a cumulative coverage
budget (``coverage_budget`` frames' worth of scanned bbox area). Both use
the clipped bbox, so the C++ library and the numpy version make identical
skip decisions; skip counts are in ``Renderer.last_stats``.
"""

from __future__ import annotations

import numpy as np

from pmce_tpu_torch import native

DEFAULT_COLOR = (255.0 * 1.0, 255.0 * 0.6059142480254321, 255.0 * 0.5)


def project_weak_perspective(verts: np.ndarray, cam: np.ndarray,
                             width: int, height: int) -> np.ndarray:
    """Mesh (meters, camera frame) → screen-space (px, px, depth).

    cam: (sx, sy, tx, ty) full-frame weak-perspective camera (the output of
    ``convert_crop_cam_to_orig_img``). Applies the reference's Rx(180°)
    flip (y and z negated) before projection.
    """
    v = verts.copy()
    v[:, 1] *= -1.0
    v[:, 2] *= -1.0
    sx, sy, tx, ty = [float(c) for c in cam]
    x = (v[:, 0] + tx) * sx          # normalized [-1, 1]
    y = (v[:, 1] + ty) * sy
    px = (x + 1.0) * 0.5 * width
    py = (y + 1.0) * 0.5 * height
    return np.stack([px, py, v[:, 2]], axis=-1).astype(np.float32)


def rasterize_plain(verts: np.ndarray, faces: np.ndarray,
                    image: np.ndarray, color, alpha: float,
                    max_tri_px: float = 0.0,
                    budget_px: float = 0.0) -> tuple[int, int]:
    """The C++ rasterizer's algorithm and skip rules in numpy, compositing
    into ``image`` in place.

    Returns (faces skipped by the per-triangle cap, faces dropped by the
    coverage budget), as the library's ``stats`` out-param.
    """
    h, w = image.shape[:2]
    depth = np.full((h, w), np.inf, np.float32)
    light = np.array([-0.25, -0.35, -0.90])
    light /= np.linalg.norm(light)
    tri = verts[faces]                               # [F, 3, 3]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12
    shade = 0.35 + 0.65 * np.abs(n @ light)
    color = np.asarray(color, np.float32)

    n_skip_area = 0
    n_skip_budget = 0
    scanned = 0.0
    for f in range(len(faces)):
        (x0, y0, z0), (x1, y1, z1), (x2, y2, z2) = tri[f]
        xmin = max(0, int(np.floor(min(x0, x1, x2))))
        xmax = min(w - 1, int(np.ceil(max(x0, x1, x2))))
        ymin = max(0, int(np.floor(min(y0, y1, y2))))
        ymax = min(h - 1, int(np.ceil(max(y0, y1, y2))))
        if xmin > xmax or ymin > ymax:
            continue
        bbox_px = float(xmax - xmin + 1) * float(ymax - ymin + 1)
        if max_tri_px > 0 and bbox_px > max_tri_px:
            n_skip_area += 1
            continue
        if budget_px > 0 and scanned + bbox_px > budget_px:
            n_skip_budget += 1
            continue
        scanned += bbox_px
        denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
        if abs(denom) < 1e-12:
            continue
        ys, xs = np.mgrid[ymin:ymax + 1, xmin:xmax + 1]
        fx, fy = xs + 0.5, ys + 0.5
        w0 = ((y1 - y2) * (fx - x2) + (x2 - x1) * (fy - y2)) / denom
        w1 = ((y2 - y0) * (fx - x2) + (x0 - x2) * (fy - y2)) / denom
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        z = w0 * z0 + w1 * z1 + w2 * z2
        closer = inside & (z < depth[ymin:ymax + 1, xmin:xmax + 1])
        if not closer.any():
            continue
        dsub = depth[ymin:ymax + 1, xmin:xmax + 1]
        dsub[closer] = z[closer]
        isub = image[ymin:ymax + 1, xmin:xmax + 1]
        lit = np.clip(color * shade[f], 0, 255)
        isub[closer] = ((1 - alpha) * isub[closer]
                        + alpha * lit).astype(np.uint8)
    return n_skip_area, n_skip_budget


class Renderer:
    """Composites posed meshes onto video frames.

    API parity with the reference Renderer: ``render(img, verts, cam,
    color)`` returns the frame with the mesh overlay.

    ``max_tri_frac``: per-triangle clipped-bbox cap as a fraction of the
    frame area (0 disables). ``coverage_budget``: total scanned-bbox
    budget in frame areas (0 disables). After each ``render`` call,
    ``last_stats`` holds (faces skipped by the cap, faces dropped by the
    budget) — nonzero values mean the camera fit was degenerate.
    """

    def __init__(self, faces: np.ndarray, resolution: tuple,
                 alpha: float = 0.9, max_tri_frac: float = 0.05,
                 coverage_budget: float = 16.0):
        self.faces = np.ascontiguousarray(faces, np.int32)
        self.width, self.height = resolution
        self.alpha = float(alpha)
        frame_px = float(self.width) * float(self.height)
        self.max_tri_px = float(max_tri_frac) * frame_px
        self.budget_px = float(coverage_budget) * frame_px
        self.last_stats = (0, 0)
        self._lib = native.load()

    def render(self, img: np.ndarray, verts: np.ndarray,
               cam: np.ndarray, color=DEFAULT_COLOR) -> np.ndarray:
        """img: [H, W, 3] uint8; verts: [V, 3] meters; cam: (sx, sy, tx,
        ty)."""
        out = np.ascontiguousarray(img, np.uint8).copy()
        screen = np.ascontiguousarray(project_weak_perspective(
            verts, cam, self.width, self.height), np.float32)
        color_arr = np.asarray(color, np.float32)
        depth = np.full((self.height, self.width), np.inf, np.float32)
        stats = np.zeros(2, np.int32)
        self._lib.rasterize_mesh(
            screen.ctypes.data_as(native.F32P), len(screen),
            self.faces.ctypes.data_as(native.I32P), len(self.faces),
            out.ctypes.data_as(native.U8P),
            depth.ctypes.data_as(native.F32P), self.height, self.width,
            color_arr.ctypes.data_as(native.F32P), self.alpha,
            self.max_tri_px, self.budget_px,
            stats.ctypes.data_as(native.I32P))
        self.last_stats = (int(stats[0]), int(stats[1]))
        return out
