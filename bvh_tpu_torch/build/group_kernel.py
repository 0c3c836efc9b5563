"""Per-group binned-SAH build (kernel B3): plain version and dispatcher.

Counterpart of `bvh_tpu.build.group_kernel` (`_group_build_kernel_ls`
and `_group_build_kernel`, the "ls" and "bfs" variants launched by
`group_forest_build`). For each Morton-grid group g of
`sizes[g] <= P` primitives it builds the whole binned-SAH subtree
(reference: binned_sah_builder.h:82-156, top_down_sah_builder.h:89-125):

- 8 bins per axis; a lane's bin is `pos = c * scale + offset` clamped
  with `where(pos > 0, ..)` then `where(pos < 7, ..)` before the
  truncating cast (NaN goes to bin 0, +inf to bin 7);
- leaf cost `half_area * ((count + 2^lc - 1) >> lc)`, non-split cost
  `node_area * (count' - cost_ratio)`, a NaN cost counts as +inf, and
  ties go to the axis-major first minimum (strict <);
- when SAH declines a node above max_leaf_size, or its split leaves a
  side empty, the exact median of the largest axis splits it, stable by
  (value, lane);
- SATO order (the larger-area child in the lower slot), slots allocated
  in BFS order; row 7 of a node carries the minimum half-area of its
  ancestors (max float at the root).

Layouts (as `bvh_tpu`):
  pf   [16, G*P] f32  rows 0..dim-1 centres, dim..2dim-1 bb_min,
                      2dim..3dim-1 bb_max
  nbf  [8, G*NCAP] f32 rows 0..2dim-1 interleaved bounds, 6 half-area,
                      7 ancestor minimum half-area
  nbi  [8, G*NCAP] i32 rows 0 begin, 1 end (local), 2 first child slot
                      (-1 = leaf), 3 zero ("ls") or the BFS queue
                      ("bfs"), 4..7 zero
  src  [G*P] i32      the source lane of each final position
  cnt  [G] i32        node count per group

`group_forest_build` runs the CUDA kernel (csrc/group_build.cu) for a
tensor on a CUDA device and `group_forest_build_ref`, the plain
version, for a tensor on the CPU. Both are level-synchronous: the
kernel works a group's open nodes of one BFS level together (a warp a
node of at most 128 lanes, the whole CTA a larger one) and gives the
level's splitting nodes their children's slots by a scan in slot order,
as the plain version does over all groups at once.

The "bfs" variant of `bvh_tpu` builds the same tree one node an
iteration and leaves its work queue in `nbi` row 3 (`bvh_tpu`
group_kernel.py:133-134, 360-368); here it is kernel B3's tree (or the
plain version's) with that row written after it by `bfs_queue_row`.
"""

from __future__ import annotations

import torch

from bvh_tpu_torch import kernels
from bvh_tpu_torch.core import bbox as bbox_ops
from bvh_tpu_torch.core import utils

BIN_COUNT = 8  # reference: binned_sah_builder.h:18
_F32 = torch.float32
_I64 = torch.int64
_BIG = torch.finfo(_F32).max
_INF = float("inf")
VARIANTS = ("ls", "bfs")


def _first_max_axis(diag):
    """Index of the first maximum along the last axis (vec.h:33)."""
    largest = torch.zeros(diag.shape[0], dtype=_I64, device=diag.device)
    best = diag[:, 0]
    for d in range(1, diag.shape[1]):
        gtr = diag[:, d] > best
        largest = torch.where(gtr, d, largest)
        best = torch.where(gtr, diag[:, d], best)
    return largest


def _sah_split(cnt, bmn, bmx, log_cluster):
    """Best (cost, axis, bin) of N nodes from their per-bin counts
    [N, dim, B] and boxes [N, dim, B, dim], in the kernel's operation
    order: right-to-left suffix costs, then the left-to-right sweep."""
    N, dim, B = cnt.shape
    dev = cnt.device
    off = (1 << log_cluster) - 1

    def prims(c):
        return ((c + off) >> log_cluster).to(_F32)

    best_cost = torch.full((N,), _INF, dtype=_F32, device=dev)
    best_axis = torch.zeros(N, dtype=_I64, device=dev)
    best_bin = torch.ones(N, dtype=_I64, device=dev)
    for d in range(dim):
        right_cost = [None] * B
        rmn = torch.full((N, dim), _BIG, dtype=_F32, device=dev)
        rmx = torch.full((N, dim), -_BIG, dtype=_F32, device=dev)
        rcnt = torch.zeros(N, dtype=_I64, device=dev)
        for i in range(B - 1, 0, -1):
            rmn = torch.minimum(rmn, bmn[:, d, i])
            rmx = torch.maximum(rmx, bmx[:, d, i])
            rcnt = rcnt + cnt[:, d, i]
            ha = bbox_ops.get_half_area(rmn, rmx)
            right_cost[i] = torch.where(rcnt > 0, ha * prims(rcnt), _INF)
        lmn = torch.full((N, dim), _BIG, dtype=_F32, device=dev)
        lmx = torch.full((N, dim), -_BIG, dtype=_F32, device=dev)
        lcnt = torch.zeros(N, dtype=_I64, device=dev)
        for i in range(B - 1):
            lmn = torch.minimum(lmn, bmn[:, d, i])
            lmx = torch.maximum(lmx, bmx[:, d, i])
            lcnt = lcnt + cnt[:, d, i]
            ha = bbox_ops.get_half_area(lmn, lmx)
            # leaf_cost(left) + right_cost: XLA contracts the product
            cost = torch.where(lcnt > 0, utils.fast_mul_add(
                ha, prims(lcnt), right_cost[i + 1]), _INF)
            cost = torch.where(torch.isnan(cost), _INF, cost)
            better = cost < best_cost
            best_cost = torch.where(better, cost, best_cost)
            best_axis = torch.where(better, d, best_axis)
            best_bin = torch.where(better, i + 1, best_bin)
    return best_cost, best_axis, best_bin


def _monotone_key(v):
    """int32 key of float32 values whose signed order is the float order
    (-0 before +0), as the kernel's median search uses (`bvh_tpu`
    group_kernel.py:680-682); carried in int64."""
    bits = v.view(torch.int32).to(_I64)
    return torch.where(bits < 0, -(1 << 31) - bits - 1, bits)


def group_forest_build_ref(pf, sizes, *, dim: int, P: int, NCAP=None,
                           min_leaf: int = 1, max_leaf: int = 8,
                           log_cluster: int = 0, cost_ratio: float = 1.0):
    """Plain PyTorch version of kernel B3, level-synchronous over all
    groups at once: each iteration processes every open node of every
    group's current BFS level (about tree-depth iterations in all).
    Per node it runs the kernel's scalar sequence; the per-bin counts
    and boxes, the child boxes and the partition ranks are integer sums
    and min/max reductions, exact in any order. The median fallback
    takes the first half of a stable sort by (value key, lane), which
    is the set the kernel's binary search selects."""
    dev = pf.device
    G = pf.shape[1] // P
    if NCAP is None:
        NCAP = 2 * P
    B = BIN_COUNT
    off = (1 << log_cluster) - 1
    ratio = torch.tensor(cost_ratio, dtype=_F32, device=dev)
    sizes = sizes.to(_I64)

    # lane L = g * P + l holds [centres, bb_min, bb_max] and its source lane
    lanes = pf[:3 * dim].T.contiguous()
    src = torch.arange(P, dtype=_I64, device=dev).repeat(G)
    valid = (torch.arange(P, device=dev)[None, :] < sizes[:, None]).reshape(-1)
    mn_root = torch.where(valid[:, None], lanes[:, dim:2 * dim],
                          _BIG).view(G, P, dim).amin(1)
    mx_root = torch.where(valid[:, None], lanes[:, 2 * dim:],
                          -_BIG).view(G, P, dim).amax(1)

    nbf = torch.zeros((G, 8, NCAP), dtype=_F32, device=dev)
    nbi = torch.zeros((G, 8, NCAP), dtype=_I64, device=dev)
    nbi[:, 2] = -1
    nbf[:, 0:2 * dim:2, 0] = mn_root
    nbf[:, 1:2 * dim:2, 0] = mx_root
    nbf[:, 6, 0] = bbox_ops.get_half_area(mn_root, mx_root)
    nbf[:, 7, 0] = _BIG
    nbi[:, 1, 0] = sizes
    nbi[:, 2, 0] = torch.where(sizes <= min_leaf, -1, 0)
    tail = torch.ones(G, dtype=_I64, device=dev)

    # the open nodes of the current level, in (group, slot) order
    ng = torch.nonzero(sizes > min_leaf).squeeze(1)
    nslot = torch.zeros_like(ng)
    nb = torch.zeros_like(ng)
    ne = sizes[ng]
    nrow = nbf[ng, :, 0]
    while ng.numel():
        N = ng.numel()
        sz = ne - nb
        starts = torch.cumsum(sz, 0) - sz
        node = torch.repeat_interleave(torch.arange(N, device=dev), sz)
        pos = nb[node] + torch.arange(node.numel(), device=dev) - starts[node]
        L = ng[node] * P + pos
        c = lanes[L, :dim]
        lmn = lanes[L, dim:2 * dim]
        lmx = lanes[L, 2 * dim:]
        nmn = nrow[:, 0:2 * dim:2]
        nmx = nrow[:, 1:2 * dim:2]

        # binning (binned_sah_builder.h:82-99)
        bscale = B / (nmx - nmn)
        boff = -nmn * bscale
        posf = utils.fast_mul_add(c, bscale[node], boff[node])
        posf = torch.where(posf > 0, posf, 0.0)
        posf = torch.where(posf < B - 1, posf, float(B - 1))
        key = ((node[:, None] * dim + torch.arange(dim, device=dev)) * B
               + posf.to(_I64)).reshape(-1)
        cnt = torch.bincount(key, minlength=N * dim * B).view(N, dim, B)
        idx = key[:, None].expand(-1, dim)
        bmn = torch.full((N * dim * B, dim), _BIG, dtype=_F32,
                         device=dev).scatter_reduce(
            0, idx, lmn.repeat_interleave(dim, 0), "amin").view(N, dim, B, dim)
        bmx = torch.full((N * dim * B, dim), -_BIG, dtype=_F32,
                         device=dev).scatter_reduce(
            0, idx, lmx.repeat_interleave(dim, 0), "amax").view(N, dim, B, dim)

        # SAH sweep and the per-node decisions (:101-156)
        best_cost, best_axis, best_bin = _sah_split(cnt, bmn, bmx, log_cluster)
        pc_node = ((sz + off) >> log_cluster).to(_F32)
        sah_ok = best_cost < nrow[:, 6] * (pc_node - ratio)
        diag = nmx - nmn
        largest = _first_max_axis(diag)
        split_val = utils.fast_mul_add(
            diag.gather(1, best_axis[:, None]).squeeze(1) / B,
            best_bin.to(_F32), nmn.gather(1, best_axis[:, None]).squeeze(1))
        gl = c.gather(1, best_axis[node][:, None]).squeeze(1) < split_val[node]
        count_left = torch.zeros(N, dtype=_I64, device=dev).index_add_(
            0, node, gl.to(_I64))
        degenerate = sah_ok & ((count_left == 0) | (count_left == sz))
        do_split = sah_ok | (sz > max_leaf)
        use_fb = do_split & (~sah_ok | degenerate)
        half = (sz + 1) // 2

        # median fallback (:118-126): the first `half` lanes by
        # (value, lane) on the largest axis go left
        fb = torch.nonzero(use_fb[node]).squeeze(1)
        if fb.numel():
            v = c.gather(1, largest[node][:, None]).squeeze(1)[fb]
            skey = (node[fb] << 33) + (_monotone_key(v) + (1 << 31))
            order = torch.sort(skey, stable=True).indices
            fnode = node[fb][order]
            k = torch.arange(fb.numel(), device=dev)
            first = torch.full((N,), fb.numel(), dtype=_I64,
                               device=dev).scatter_reduce(0, fnode, k, "amin")
            gl[fb[order]] = (k - first[fnode]) < half[fnode]
        mid = nb + torch.where(use_fb, half, count_left)

        # stable partition of every splitting node's lanes
        gli = gl.to(_I64)
        ecs = torch.cumsum(gli, 0) - gli
        lrank = ecs - ecs[starts[node]]
        new_pos = torch.where(gl, nb[node] + lrank,
                              mid[node] + pos - nb[node] - lrank)
        ws = do_split[node]
        dst = ng[node[ws]] * P + new_pos[ws]
        moved = L[ws]
        lanes[dst] = lanes[moved]
        src[dst] = src[moved]

        # child boxes and SATO order (top_down_sah_builder.h:100-125)
        ck = (2 * node + (~gl).to(_I64))[ws]
        cidx = ck[:, None].expand(-1, dim)
        cmn = torch.full((2 * N, dim), _BIG, dtype=_F32,
                         device=dev).scatter_reduce(
            0, cidx, lmn[ws], "amin").view(N, 2, dim)
        cmx = torch.full((2 * N, dim), -_BIG, dtype=_F32,
                         device=dev).scatter_reduce(
            0, cidx, lmx[ws], "amax").view(N, 2, dim)
        area = bbox_ops.get_half_area(cmn, cmx)
        swap = area[:, 0] < area[:, 1]

        # slots: children of the level's splitting nodes, in parent-slot
        # order per group, from the group's tail
        si = do_split.to(_I64)
        ecs = torch.cumsum(si, 0) - si
        gfirst = torch.full((G,), N, dtype=_I64, device=dev).scatter_reduce(
            0, ng, torch.arange(N, device=dev), "amin")
        cbase = tail[ng] + 2 * (ecs - ecs[gfirst[ng]])
        tail = tail.index_add(0, ng, 2 * si)
        nbi[ng, 2, nslot] = torch.where(do_split, cbase, -1)

        s = torch.nonzero(do_split).squeeze(1)
        anc = torch.minimum(nrow[s, 7], nrow[s, 6])
        bounds_a = (nb[s], mid[s])
        bounds_b = (mid[s], ne[s])
        rows, begins, ends = [], [], []
        for k in (0, 1):
            from_b = swap[s] if k == 0 else ~swap[s]
            side = from_b.to(_I64)
            row = torch.zeros((s.numel(), 8), dtype=_F32, device=dev)
            row[:, 0:2 * dim:2] = cmn[s, side]
            row[:, 1:2 * dim:2] = cmx[s, side]
            row[:, 6] = area[s, side]
            row[:, 7] = anc
            rows.append(row)
            begins.append(torch.where(from_b, bounds_b[0], bounds_a[0]))
            ends.append(torch.where(from_b, bounds_b[1], bounds_a[1]))
            nbf[ng[s], :, cbase[s] + k] = row
            nbi[ng[s], 0, cbase[s] + k] = begins[k]
            nbi[ng[s], 1, cbase[s] + k] = ends[k]

        # the next level: open children, interleaved (c0, c1) per parent
        cg = ng[s].repeat_interleave(2)
        cslot = (cbase[s][:, None] + torch.arange(2, device=dev)).reshape(-1)
        cb = torch.stack(begins, 1).reshape(-1)
        ce = torch.stack(ends, 1).reshape(-1)
        crow = torch.stack(rows, 1).reshape(-1, 8)
        keep = (ce - cb) > min_leaf
        ng, nslot, nb, ne, nrow = (cg[keep], cslot[keep], cb[keep], ce[keep],
                                   crow[keep])

    cnt_out = torch.where(sizes > 0, tail, 0).to(torch.int32)
    return (nbf.permute(1, 0, 2).reshape(8, G * NCAP),
            nbi.permute(1, 0, 2).reshape(8, G * NCAP).to(torch.int32),
            src.to(torch.int32), cnt_out)


def bfs_queue_row(nbi, G: int, NCAP: int, min_leaf: int) -> torch.Tensor:
    """`nbi` with row 3 set to the BFS kernel's work queue, in place.

    That kernel (`bvh_tpu` group_kernel.py:133-134, 360-368) queues the
    root at queue position 0 when it holds more than min_leaf prims, and
    each node it splits appends those of its children (slots tail,
    tail + 1) that do. Slots are handed out in pop order, so the queue
    lists every node of more than min_leaf prims (including those the
    SAH then closed as leaves) in slot order; the rest of the row stays
    zero. Torch ops only, on the device of `nbi`, with no host sync."""
    rows = nbi.view(8, G, NCAP)
    opened = (rows[1] - rows[0]) > min_leaf
    pos = torch.where(opened, torch.cumsum(opened, dim=1) - 1, NCAP)
    slots = torch.arange(NCAP, dtype=nbi.dtype, device=nbi.device)
    queue = torch.zeros((G, NCAP + 1), dtype=nbi.dtype, device=nbi.device)
    queue.scatter_(1, pos, slots.expand(G, NCAP))  # column NCAP: the rest
    rows[3] = queue[:, :NCAP]
    return nbi


def group_forest_build(pf, sizes, *, dim: int, P: int, NCAP=None,
                       min_leaf: int = 1, max_leaf: int = 8,
                       log_cluster: int = 0, cost_ratio: float = 1.0,
                       variant: str = "ls"):
    """Kernel B3 over G = pf.shape[1] // P groups: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. `variant`: "ls"
    or "bfs" (`bvh_tpu` group_kernel.py:866-869), the same tree; "bfs"
    also writes the BFS queue into `nbi` row 3 (`bfs_queue_row`).
    Returns (nbf [8, G*NCAP] f32, nbi [8, G*NCAP] i32, src [G*P] i32,
    cnt [G] i32)."""
    if variant not in VARIANTS:
        raise ValueError(f"group_forest_build: unknown variant {variant!r}; "
                         f"one of {VARIANTS}")
    if NCAP is None:
        NCAP = 2 * P
    out = _group_forest_build(pf, sizes, dim=dim, P=P, NCAP=NCAP,
                              min_leaf=min_leaf, max_leaf=max_leaf,
                              log_cluster=log_cluster, cost_ratio=cost_ratio)
    if variant == "bfs":
        bfs_queue_row(out[1], pf.shape[1] // P, NCAP, min_leaf)
    return out


def _group_forest_build(pf, sizes, *, dim, P, NCAP, min_leaf, max_leaf,
                        log_cluster, cost_ratio):
    """`group_forest_build`'s "ls" output."""
    if P % 128:
        raise ValueError(f"group_forest_build: P={P} must be a multiple "
                         "of 128")
    kw = dict(dim=dim, P=P, NCAP=NCAP, min_leaf=min_leaf, max_leaf=max_leaf,
              log_cluster=log_cluster, cost_ratio=cost_ratio)
    if pf.device.type == "cpu":
        return group_forest_build_ref(pf, sizes, **kw)
    if pf.device.type != "cuda":
        raise ValueError(f"group_forest_build: unsupported device {pf.device}")
    if dim != 3:
        raise ValueError(f"group_forest_build: the CUDA kernel takes dim 3, "
                         f"not {dim}")
    if NCAP < 2 * P - 1:
        raise ValueError(f"group_forest_build: NCAP={NCAP} cannot hold the "
                         f"2P-1={2 * P - 1} nodes of a full group")
    G = pf.shape[1] // P
    if (pf.dtype != _F32 or pf.dim() != 2 or pf.shape != (16, G * P)
            or not pf.is_contiguous()):
        raise ValueError("group_forest_build: pf must be a contiguous "
                         "[16, G*P] float32 tensor")
    if (sizes.device != pf.device or sizes.dtype != torch.int32
            or sizes.shape != (G,) or not sizes.is_contiguous()):
        raise ValueError(f"group_forest_build: sizes must be a contiguous "
                         f"[{G}] int32 tensor on {pf.device}")
    max_p = kernels.group_build_max_p()
    if P > max_p:
        raise ValueError(
            f"group_forest_build: P={P} does not fit a block's shared memory "
            f"(44 bytes a lane); this card allows P <= {max_p}")
    nbf = torch.empty((8, G * NCAP), dtype=_F32, device=pf.device)
    nbi = torch.empty((8, G * NCAP), dtype=torch.int32, device=pf.device)
    src = torch.empty(G * P, dtype=torch.int32, device=pf.device)
    cnt = torch.empty(G, dtype=torch.int32, device=pf.device)
    kernels.GROUP_BUILD.launch(
        pf.data_ptr(), sizes.data_ptr(), G, P, NCAP, min_leaf, max_leaf,
        log_cluster, float(cost_ratio), nbf.data_ptr(), nbi.data_ptr(),
        src.data_ptr(), cnt.data_ptr())
    return nbf, nbi, src, cnt
