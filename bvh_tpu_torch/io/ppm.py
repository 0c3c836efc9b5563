"""Binary PPM (P6) image writer, matching the reference benchmark's
output format (reference: test/benchmark.cpp:250-255). Counterpart of
`bvh_tpu.io.ppm`, a numpy-only copy of it."""

from __future__ import annotations

import numpy as np


def save_ppm(path: str, pixels) -> None:
    """`pixels`: [height, width, 3] array; floats in [0, 1] are scaled to
    bytes, integer arrays are written as-is."""
    pixels = np.asarray(pixels)
    if pixels.dtype != np.uint8:
        pixels = np.clip(pixels * 255.0 + 0.5, 0, 255).astype(np.uint8)
    h, w = pixels.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6 {w} {h} 255\n".encode())
        f.write(pixels.tobytes())
