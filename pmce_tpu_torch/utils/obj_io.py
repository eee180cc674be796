"""Wavefront OBJ mesh writer and reader (the visual-check artifact).

Port of ``pmce_tpu/utils/obj_io.py`` (the reference's ``save_obj``,
``lib/funcs_utils.py:52-58``): evaluation dumps every N-th predicted mesh
for visual inspection.
"""

from __future__ import annotations

import numpy as np


def save_obj(verts: np.ndarray, faces: np.ndarray, path: str) -> None:
    """Write vertices [V, 3] and triangle indices [F, 3] as an .obj."""
    verts = np.asarray(verts)
    faces = np.asarray(faces)
    # Plain "f a b c" (the reference's format): v/vt syntax would
    # reference a texture-coordinate table this file never writes.
    lines = [f"v {v[0]} {v[1]} {v[2]}" for v in verts]
    lines += [f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}" for f in faces]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def load_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read back vertices [V, 3] (f32) and faces [F, 3] (int32, 0-based)
    written by :func:`save_obj`; a face's ``v/vt/vn`` corners keep their
    vertex index."""
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                faces.append([int(p.split("/")[0]) - 1 for p in parts[1:4]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)
