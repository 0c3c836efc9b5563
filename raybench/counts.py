"""The least time a frame's work can take on the card: its bytes and
float32 operations, counted from the frame's inputs only, over the
card's published peaks (`peaks.json`).

A frame reads each ray once (origin, direction, tmin, tmax: 32 bytes),
writes each hit once (t, u, v and the triangle id: 16 bytes), and reads
the scene's triangle rows (p0, e1, e2, n: 48 bytes a triangle) and the
treelet cut's tables (the top table, the treelet tables and the super
tables) once each. The treelet tables carry the triangle rows again in
their leaf columns, so a triangle counts twice: the bound is a little
high, never low. Every ray makes at least one triangle test, 40
float32 operations. How the program schedules the work (fused, split,
repeated or re-run kernels) does not change these counts.
"""

from __future__ import annotations

import json
import os

RAY_BYTES = 32
HIT_BYTES = 16
TRI_BYTES = 48
TEST_FLOPS = 40


def render_work(rays: int, n_tris: int, table_bytes: int) -> dict:
    """{"bytes", "flops"} of one frame of `rays` rays."""
    return {"bytes": rays * (RAY_BYTES + HIT_BYTES) + n_tris * TRI_BYTES
            + table_bytes,
            "flops": rays * TEST_FLOPS}


def peaks(kind: str) -> dict | None:
    """{"bytes_per_s", "flops_per_s"} of the card named `kind`
    (`torch.cuda.get_device_name()`), or None if the table lacks it."""
    with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as f:
        return json.load(f).get(kind)


def least_seconds(work: dict, peak: dict) -> float:
    """The larger of bytes over bandwidth and operations over the float32
    rate."""
    return max(work["bytes"] / peak["bytes_per_s"],
               work["flops"] / peak["flops_per_s"])
