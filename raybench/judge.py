"""The comparison that decides `correct`: the program's answers for a
sample of rays against the plain reference (`reference/`).

For each sampled ray the program reports (t, triangle id); a miss is
t = +inf. The reference brackets the sound answers in float64 with the
float32 test's error bounds (`reference/intersect.py`). Three numbers
are compared, each with a limit set in the traffic file:

- `wrong_hits`: rays whose reported hit cannot be a hit: the triangle
  id and t disagree on hit or miss, the triangle cannot be hit by the
  ray at all, or (closest hit) t lies nearer than any possible hit, or
  (any hit) the ray has no possible occluder;
- `late_hits`: rays that miss a hit every float32 rounding finds
  (closest hit: t beyond the nearest sure hit, a miss included; any
  hit: unoccluded while a sure occluder exists);
- `t_gap`: the largest gap between a reported t and the float64 t of
  the reported triangle, in units of that pair's float32 error bound.
"""

from __future__ import annotations

import torch

from raybench.reference import intersect

def judge(tris, rays, t_prog, prim_prog, *, any_hit: bool) -> dict:
    """The three numbers for rays (org, dir, tmin, tmax) and the
    program's answers t_prog [S] (float) and prim_prog [S] (int64)."""
    org, dirs, tmin, tmax = rays
    n = tris.shape[0]
    t = t_prog.to(torch.float64)
    prim = prim_prog.to(torch.int64)
    valid = (prim >= 0) & (prim < n)
    finite = torch.isfinite(t)
    wrong = valid != finite
    hit = valid & finite
    t_sure, t_poss = intersect.brackets(tris, org, dirs, tmin, tmax)
    gap = 0.0
    if hit.any():
        idx = torch.nonzero(hit).squeeze(1)
        ts, ms, poss = intersect.pair(tris, org[idx], dirs[idx], tmin[idx],
                                      tmax[idx], prim[idx])
        bad = ~poss
        gap = float(((t[idx] - ts).abs() / ms).max())
        wrong[idx] |= bad
    if any_hit:
        wrong |= hit & torch.isinf(t_poss)
        late = ~hit & torch.isfinite(t_sure)
    else:
        wrong |= hit & (t < t_poss)
        late = torch.where(hit, t, float("inf")) > t_sure
    return {"wrong_hits": int(wrong.sum()), "late_hits": int(late.sum()),
            "t_gap": gap}


def merge(parts) -> dict:
    """The numbers of several samples as one: counts add, gaps take the
    largest."""
    out = {"wrong_hits": 0, "late_hits": 0, "t_gap": 0.0}
    for p in parts:
        out["wrong_hits"] += p["wrong_hits"]
        out["late_hits"] += p["late_hits"]
        out["t_gap"] = max(out["t_gap"], p["t_gap"])
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit."""
    return all(numbers[k] <= limits[k] for k in numbers)
