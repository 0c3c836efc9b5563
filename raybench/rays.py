"""Ray sets made on the card, by the rules of a traffic file.

Three generators, chosen by the traffic file's `rays.kind`:

- "pinhole": the upstream benchmark's pinhole camera
  (test/benchmark.cpp:343-359; the port's `cli/camera.py`): through
  pixel (x, y), row-major in y then x, the direction
  d + (2x/W - 1) r + (2y/H - 1) u, in float64, then cast to float32;
  tmin 0, tmax the largest float32. The poses are a camera path: each
  stands inside the box grid, in the middle of a corridor between
  columns, and looks along a yaw and a pitch in [-pitch_deg,
  pitch_deg], stratified so that the path has one pose in each of the
  grid's blocks, each yaw band, each pitch and height band.
- "shadow": next-event rays of a path tracer. Origins are uniform
  points on uniformly drawn triangles of the scene; each ray runs
  toward one of `lights` point lights above the grid, with the
  unnormalised direction light - origin, tmin `tmin` and tmax 1.
- "diffuse": a path tracer's diffuse bounce, closest hit (Aila and
  Laine, HPG 2009). Each ray leaves a uniform point of the scene's
  surface: a triangle drawn with probability proportional to its area
  (the inverse of a float64 running sum of the areas), then a uniform
  point on it by the square-root rule `shadow` uses. Its direction is
  cosine-weighted on the hemisphere of the side it leaves: a uniform
  point of the unit disk lifted to the hemisphere (Malley's method),
  on an orthonormal frame of that side's unit normal, in float64,
  normalised, then cast to float32; tmin `tmin`, tmax the largest
  float32. The side: with n = (p1 - p0) x (p2 - p0), the box grid's
  triangles (its first 12 * grid_side(n_tris)**2 rows) face into
  their box (`scenes.CUBE_FACES`; the tests check it), so their rays
  leave about -n, out of the box; the detail triangles are two-sided
  slivers, and each ray draws its side. Departure from a path
  tracer: the origins are points of every surface, not the camera's
  visible hits. A float64 reference cannot find a million primary
  hits among 10M triangles in a run's time, and taking the program's
  own hits would make the traffic depend on the code under test.

The sets are drawn from the traffic's own `ray_seed`, so every run gets
the same sets and the same work; the run's seed orders the frames (and
draws the rays the check samples). A seed that drew the rays would
change the work: a single ray that enters many treelets raises the
render's portal cap for its whole frame (PERF.md). Each generator
returns `sets` tuples (org [R, 3], dir [R, 3], tmin [R], tmax [R]) of
float32 tensors on the scene's device, in the order the frames visit
them.
"""

from __future__ import annotations

import math

import torch

from raybench import scenes

POSE_STREAM = 100
SHADOW_STREAM = 200
DIFFUSE_STREAM = 400
ORDER_STREAM = 500


def _strata(g, count, device):
    """`count` numbers in [0, 1), one in each of `count` equal bands, in
    a random order."""
    perm = torch.randperm(count, generator=g, device=device)
    u = torch.rand(count, generator=g, device=device, dtype=torch.float64)
    return (perm.to(torch.float64) + u) / count


def interior_poses(spec: dict, n_tris: int, device):
    """The path's [P, 3] eyes and [P, 3] unit view directions, float64."""
    g = scenes.generator(spec["ray_seed"], POSE_STREAM, device)
    P = int(spec["poses"])
    side = scenes.grid_side(n_tris)
    blocks = math.ceil(math.sqrt(P))
    k = torch.arange(P, device=device)
    bx = (k % blocks).to(torch.float64)
    bz = (k // blocks % blocks).to(torch.float64)
    u = torch.rand((4, P), generator=g, device=device, dtype=torch.float64)
    corridors = max(1, side - 1)
    i = torch.floor((bx + u[0]) / blocks * corridors)
    j = torch.floor((bz + u[1]) / blocks * corridors)
    # the corridor between column i and i + 1 is free of boxes from
    # pitch * i + the widest box to pitch * (i + 1)
    mid = (scenes.BOX_WIDTH[1] + scenes.PITCH) / 2
    jitter = (scenes.PITCH - scenes.BOX_WIDTH[1]) / 2 * 0.75
    x = scenes.PITCH * i + mid + (2 * u[2] - 1) * jitter
    z = scenes.PITCH * j + mid + (2 * u[3] - 1) * jitter
    h_lo, h_hi = spec["eye_height"]
    y = h_lo + _strata(g, P, device) * (h_hi - h_lo)
    yaw = _strata(g, P, device) * 2 * math.pi
    pitch = (2 * _strata(g, P, device) - 1) * math.radians(spec["pitch_deg"])
    eye = torch.stack([x, y, z], dim=1)
    d = torch.stack([torch.cos(pitch) * torch.cos(yaw), torch.sin(pitch),
                     torch.cos(pitch) * torch.sin(yaw)], dim=1)
    return eye, d


def pinhole(eye, d, width: int, height: int):
    """One pose's rays, by cli/camera.py's arithmetic: float64, then
    float32."""
    up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64, device=eye.device)
    d = d / torch.linalg.vector_norm(d)
    r = torch.linalg.cross(d, up)
    r = r / torch.linalg.vector_norm(r)
    u = torch.linalg.cross(r, d)
    x = torch.arange(width, dtype=torch.float64, device=eye.device)
    y = torch.arange(height, dtype=torch.float64, device=eye.device)
    gv, gu = torch.meshgrid(2.0 * y / height - 1.0, 2.0 * x / width - 1.0,
                            indexing="ij")
    dirs = (d[None] + gu.reshape(-1, 1) * r[None]
            + gv.reshape(-1, 1) * u[None])
    R = width * height
    org = eye.to(torch.float32).expand(R, 3).contiguous()
    tmin = torch.zeros(R, dtype=torch.float32, device=eye.device)
    tmax = torch.full((R,), torch.finfo(torch.float32).max,
                      dtype=torch.float32, device=eye.device)
    return org, dirs.to(torch.float32), tmin, tmax


def pinhole_sets(spec: dict, tris, seed: int):
    eye, d = interior_poses(spec, tris.shape[0], tris.device)
    sets = [pinhole(eye[p], d[p], spec["width"], spec["height"])
            for p in range(eye.shape[0])]
    return in_order(sets, seed)


def in_order(sets, seed: int):
    """The sets in the order the seed's frames visit them."""
    g = scenes.generator(seed, ORDER_STREAM, "cpu")
    return [sets[i] for i in torch.randperm(len(sets), generator=g)]


def shadow_sets(spec: dict, tris, seed: int):
    device = tris.device
    g = scenes.generator(spec["ray_seed"], SHADOW_STREAM, device)
    n = tris.shape[0]
    side = scenes.grid_side(n)
    L = int(spec["lights"])
    lx = _strata(g, L, device) * scenes.PITCH * side
    lz = _strata(g, L, device) * scenes.PITCH * side
    h_lo, h_hi = spec["light_height"]
    ly = h_lo + torch.rand(L, generator=g, device=device,
                           dtype=torch.float64) * (h_hi - h_lo)
    lights = torch.stack([lx, ly, lz], dim=1).to(torch.float32)
    R = int(spec["count"])
    sets = []
    for _ in range(int(spec["sets"])):
        tri = torch.randint(n, (R,), generator=g, device=device)
        which = torch.randint(L, (R,), generator=g, device=device)
        a, b = torch.rand((2, R, 1), generator=g, device=device)
        a = torch.sqrt(a)
        p = tris[tri]
        org = (1 - a) * p[:, 0] + a * (1 - b) * p[:, 1] + a * b * p[:, 2]
        dirs = lights[which] - org
        tmin = torch.full((R,), float(spec["tmin"]), device=device)
        tmax = torch.ones(R, device=device)
        sets.append((org.contiguous(), dirs.contiguous(), tmin, tmax))
    return in_order(sets, seed)


def area_cdf(tris):
    """[n] float64 running sum of the triangles' doubled areas, and the
    [n, 3] float64 geometric normals n = (p1 - p0) x (p2 - p0) under it."""
    p = tris.to(torch.float64)
    n = torch.linalg.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    return torch.cumsum(torch.linalg.vector_norm(n, dim=1), 0), n


def diffuse_draw(tris, cdf, normals, count: int, g):
    """`count` diffuse rays over the scene `tris`, by `area_cdf`'s sum
    and normals: float64 origins [R, 3] and unit directions [R, 3], the
    triangle each leaves [R] and the unit normal of its side [R, 3]."""
    device = tris.device
    n = tris.shape[0]
    boxes = 12 * scenes.grid_side(n) ** 2
    u = torch.rand((6, count), generator=g, device=device,
                   dtype=torch.float64)
    tri = torch.searchsorted(cdf, u[0] * cdf[-1], right=True)
    tri = tri.clamp_(max=n - 1)
    a = torch.sqrt(u[1])[:, None]
    b = u[2][:, None]
    p = tris[tri].to(torch.float64)
    org = (1 - a) * p[:, 0] + a * (1 - b) * p[:, 1] + a * b * p[:, 2]
    side = torch.where((tri < boxes) | (u[3] < 0.5), -1.0, 1.0)
    nrm = normals[tri]
    nrm = nrm * (side / torch.linalg.vector_norm(nrm, dim=1))[:, None]
    # Malley: a uniform point of the unit disk, lifted to the hemisphere
    r = torch.sqrt(u[4])
    phi = 2 * math.pi * u[5]
    x, y = r * torch.cos(phi), r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1 - u[4], min=0))
    # an orthonormal frame (t, s, nrm) (Duff et al., JCGT 2017)
    nx, ny, nz = nrm.unbind(1)
    sg = torch.where(nz >= 0, 1.0, -1.0)
    h = -1 / (sg + nz)
    k = nx * ny * h
    t = torch.stack([1 + sg * nx * nx * h, sg * k, -sg * nx], dim=1)
    s = torch.stack([k, sg + ny * ny * h, -ny], dim=1)
    d = x[:, None] * t + y[:, None] * s + z[:, None] * nrm
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    return org, d, tri, nrm


def diffuse_sets(spec: dict, tris, seed: int):
    device = tris.device
    g = scenes.generator(spec["ray_seed"], DIFFUSE_STREAM, device)
    cdf, normals = area_cdf(tris)
    R = int(spec["count"])
    sets = []
    for _ in range(int(spec["sets"])):
        org, d, _, _ = diffuse_draw(tris, cdf, normals, R, g)
        tmin = torch.full((R,), float(spec["tmin"]), device=device)
        tmax = torch.full((R,), torch.finfo(torch.float32).max,
                          device=device)
        sets.append((org.to(torch.float32), d.to(torch.float32), tmin,
                     tmax))
    return in_order(sets, seed)


GENERATORS = {"pinhole": pinhole_sets, "shadow": shadow_sets,
              "diffuse": diffuse_sets}


def ray_sets(spec: dict, tris, seed: int):
    """The traffic's ray sets (`spec` is its `rays` object) over the
    scene `tris` [n, 3, 3]."""
    return GENERATORS[spec["kind"]](spec, tris, seed)
