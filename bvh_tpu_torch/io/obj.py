"""Minimal Wavefront OBJ loader.

Counterpart of `bvh_tpu.io.obj`, a numpy-only copy of it.

Behavior-compatible with the reference's test-utility loader
(reference: test/load_obj.cpp:56-96): only `v` and `f` records are
honored, face indices may be negative (relative to the current vertex
count) or 1-based positive, `v/vt/vn` forms are accepted with the
texture/normal indices ignored, and polygons are fan-triangulated as
(p0, p_i, p_{i+1}).

Returns vertex arrays as numpy; conversion to tensors happens at the
build/traversal boundary.
"""

from __future__ import annotations

import numpy as np


def load_obj(path: str, dtype=np.float32):
    """Load triangles from an OBJ file.

    Returns `(p0, p1, p2)` numpy arrays of shape [num_tris, 3].
    """
    vertices: list[tuple[float, float, float]] = []
    tri_indices: list[tuple[int, int, int]] = []

    with open(path, "r", errors="replace") as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            parts = s.split()
            if parts[0] == "v" and len(parts) >= 4:
                vertices.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif parts[0] == "f" and len(parts) >= 4:
                idx = []
                for tok in parts[1:]:
                    head = tok.split("/")[0]
                    if not head:
                        continue
                    i = int(head)
                    # Negative indices are relative to the end
                    # (reference: load_obj.cpp:79).
                    j = len(vertices) + i if i < 0 else i - 1
                    idx.append(j)
                # Fan triangulation (reference: load_obj.cpp:77-91).
                for k in range(2, len(idx)):
                    tri_indices.append((idx[0], idx[k - 1], idx[k]))

    verts = np.asarray(vertices, dtype)
    if not tri_indices:
        empty = np.zeros((0, 3), dtype)
        return empty, empty.copy(), empty.copy()
    tris = np.asarray(tri_indices, np.int64)
    return verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
