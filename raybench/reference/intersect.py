"""Brute-force closest-hit and any-hit brackets, in float64.

Every sampled ray is tested against every triangle with the
Möller–Trumbore test of the upstream library (tri.h:56-74, the port's
`geom/tri.py`): c = p0 - o, r = d x c, det = n . d, u = (r . e2) / det,
v = (r . e1) / det, t = (n . c) / det, with e1 = p0 - p1, e2 = p2 - p0,
n = e1 x e2. The four numerators and det are linear in the ray's
(d, d x o, o, 1), so one float64 matrix product per block of triangles
gives them all.

The program computes the same test in float32, so near an edge or a
bound its answer may go either way. Each pair's numerators and
determinant therefore get an error bound, K float32 roundings of the
terms the float32 test sums (products of |d|, |c|, |e1|, |e2|), and the
reference keeps for each ray:

- `t_sure`: the nearest t of a pair that is a hit under every rounding
  within the bounds, at the largest t those roundings give; +inf if
  none;
- `t_poss`: the nearest t of a pair that is a hit under some rounding
  within the bounds, at the smallest t those roundings give; +inf if
  none.

A sound closest hit lies in [t_poss, t_sure]; a sound any-hit ray is
occluded if `t_sure` is finite and unoccluded if `t_poss` is infinite.
`pair` gives a claimed (ray, triangle) pair's own float64 t, its t
margin and whether it can be a hit at all.
"""

from __future__ import annotations

import torch

EPS32 = 2.0 ** -24          # float32 unit roundoff
TOL32 = 2.0 ** -23          # the test's tolerance, -finfo(float32).eps
K = 16                      # roundings the bound allows a float32 test
BLOCK = 1 << 25             # ray x triangle pairs in one block


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def tri_frames(tris):
    """float64 (p0, e1, e2, n) of [n, 3, 3] triangles."""
    p = tris.to(torch.float64)
    p0 = p[:, 0]
    e1 = p0 - p[:, 1]
    e2 = p[:, 2] - p0
    return p0, e1, e2, _cross(e1, e2)


def _ray_features(org, dirs):
    """[S, 11] float64: d, d x o, o, 1, |o|^2."""
    o = org.to(torch.float64)
    d = dirs.to(torch.float64)
    one = torch.ones_like(o[:, :1])
    return torch.cat([d, _cross(d, o), o, one, (o * o).sum(1, keepdim=True)],
                     dim=1)


def _tri_features(p0, e1, e2, n):
    """[5, n, 11] float64 rows whose products with `_ray_features` give
    u * det, v * det, det, t * det and |p0 - o|^2."""
    z3 = torch.zeros_like(p0)
    z1 = torch.zeros_like(p0[:, :1])
    one = torch.ones_like(z1)
    pn = (p0 * n).sum(1, keepdim=True)
    pp = (p0 * p0).sum(1, keepdim=True)
    u = torch.cat([_cross(p0, e2), -e2, z3, z1, z1], dim=1)
    v = torch.cat([_cross(p0, e1), -e1, z3, z1, z1], dim=1)
    det = torch.cat([n, z3, z3, z1, z1], dim=1)
    t = torch.cat([z3, z3, -n, pn, z1], dim=1)
    cc = torch.cat([z3, z3, -2 * p0, pp, one], dim=1)
    return torch.stack([u, v, det, t, cc])


def _tests(prods, dn, n1, n2, tmin, tmax):
    """Per pair: (t, margin of t, sure, possible). `prods` are the five
    products (u * det, v * det, det, t * det, |c|^2), `dn` is |d|,
    `n1`, `n2` are |e1|, |e2|, all broadcast to one shape.

    With the determinant's sign s, D = |det| and the numerators
    U = s u det, V = s v det, T = s t det, each known to within its
    float32 bound (dD, dU, dV, dT), the test u >= -tol, v >= -tol,
    u + v <= 1 + tol, tmin <= t <= tmax holds for every rounding
    (sure) or for some rounding (possible). Where dD >= D the
    determinant's sign is unknown: the pair is possible when U and V
    are within their noise, at any t in range, and never sure."""
    un, vn, det, tn, cc = prods
    c = cc.clamp_min(0).sqrt()
    a = n1 * n2                                   # |e1| |e2| >= |n|
    dD = K * EPS32 * a * dn
    dU = K * EPS32 * dn * c * n2
    dV = K * EPS32 * dn * c * n1
    dT = K * EPS32 * a * c
    s = torch.where(det < 0, -1.0, 1.0)
    D, U, V, T = det.abs(), s * un, s * vn, s * tn
    Dhi, Dlo = D + dD, D - dD
    signed = Dlo > 0
    t = T / D
    t_hi = torch.where(signed, (T + dT) / Dlo, float("inf"))
    t_lo = torch.where(signed, (T - dT) / torch.where(T - dT >= 0, Dhi, Dlo),
                       tmin)
    t_lo = torch.maximum(t_lo, tmin)
    poss_signed = (signed & (U + dU >= -TOL32 * Dhi) & (V + dV >= -TOL32 * Dhi)
                   & (U + V - dU - dV <= (1 + TOL32) * Dhi)
                   & (t_hi >= tmin) & (t_lo <= tmax))
    poss_loose = (~signed & ((U.abs() - dU) <= (1 + TOL32) * Dhi)
                  & ((V.abs() - dV) <= (1 + TOL32) * Dhi))
    poss = poss_signed | poss_loose
    sure = (signed & (U - dU >= 0) & (V - dV >= 0)
            & (U + V + dU + dV <= Dlo)
            & ((T - dT) / Dhi >= tmin) & (t_hi <= tmax))
    t = torch.where(signed, t, tmin)
    mt = torch.where(signed, torch.maximum(t_hi - t, t - t_lo), float("inf"))
    return t, mt, sure, poss, t_lo, t_hi


def _ray_terms(org, dirs, tmin, tmax):
    d = dirs.to(torch.float64)
    return (_ray_features(org, dirs), d.norm(dim=1, keepdim=True),
            tmin.to(torch.float64)[:, None], tmax.to(torch.float64)[:, None])


def brackets(tris, org, dirs, tmin, tmax):
    """(t_sure [S], t_poss [S]) float64 for rays (org, dirs [S, 3],
    tmin, tmax [S]) against every triangle of `tris` [n, 3, 3], in
    blocks of about `BLOCK` pairs."""
    p0, e1, e2, n = tri_frames(tris)
    n1, n2 = e1.norm(dim=1), e2.norm(dim=1)
    F, dn, lo, hi = _ray_terms(org, dirs, tmin, tmax)
    S = F.shape[0]
    t_sure = torch.full((S,), float("inf"), dtype=torch.float64,
                        device=F.device)
    t_poss = t_sure.clone()
    inf = t_sure[:, None]
    step = max(1, BLOCK // max(1, S))
    for s in range(0, p0.shape[0], step):
        sl = slice(s, s + step)
        G = _tri_features(p0[sl], e1[sl], e2[sl], n[sl])
        _, _, sure, poss, t_lo, t_hi = _tests(
            [F @ g.T for g in G], dn, n1[sl][None], n2[sl][None], lo, hi)
        t_sure = torch.minimum(t_sure, torch.where(sure, t_hi, inf).amin(1))
        t_poss = torch.minimum(t_poss, torch.where(poss, t_lo, inf).amin(1))
    return t_sure, t_poss


def pair(tris, org, dirs, tmin, tmax, prim):
    """For each ray's claimed triangle `prim` [S] (valid ids only):
    (t, margin of t, possible), each [S], in float64."""
    p0, e1, e2, n = tri_frames(tris[prim])
    F, dn, lo, hi = _ray_terms(org, dirs, tmin, tmax)
    G = _tri_features(p0, e1, e2, n)
    t, mt, _, poss, _, _ = _tests(
        [(F * g).sum(1, keepdim=True) for g in G], dn,
        e1.norm(dim=1)[:, None], e2.norm(dim=1)[:, None], lo, hi)
    return t[:, 0], mt[:, 0], poss[:, 0]


def lower_precision(tris, org, dirs, tmin, tmax, dtype=torch.bfloat16):
    """The control: the same test computed in `dtype` (bfloat16, the
    precision below float32) over every triangle, as the program would
    answer: (t [S] float32, +inf on a miss; triangle id [S] int64, -1 on
    a miss), the nearest hit of each ray."""
    p = tris.to(dtype)
    p0 = p[:, 0]
    e1 = p0 - p[:, 1]
    e2 = p[:, 2] - p0
    n = _cross(e1, e2)
    o, d = org.to(dtype), dirs.to(dtype)
    lo, hi = tmin.to(dtype)[:, None], tmax.to(dtype)[:, None]
    tol = -torch.finfo(dtype).eps
    S = o.shape[0]
    best = torch.full((S,), float("inf"), dtype=torch.float32,
                      device=o.device)
    arg = torch.full((S,), -1, dtype=torch.int64, device=o.device)
    step = max(1, BLOCK // 4 // max(1, S))
    for s in range(0, p0.shape[0], step):
        sl = slice(s, s + step)
        c = p0[None, sl] - o[:, None]
        r = _cross(d[:, None].expand_as(c), c)
        inv = 1.0 / (n[None, sl] * d[:, None]).sum(-1)
        u = (r * e2[None, sl]).sum(-1) * inv
        v = (r * e1[None, sl]).sum(-1) * inv
        t = (n[None, sl] * c).sum(-1) * inv
        ok = ((u >= tol) & (v >= tol) & (1 - u - v >= tol)
              & (t >= lo) & (t <= hi))
        tt = torch.where(ok, t.float(), float("inf"))
        m, i = tt.min(1)
        better = m < best
        best = torch.where(better, m, best)
        arg = torch.where(better, i + s, arg)
    return best, arg
