"""Wavefront OBJ mesh writer (the visual-check artifact).

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
