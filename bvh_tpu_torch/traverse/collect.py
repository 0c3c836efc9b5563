"""Phase-A portal collect (kernel B2): plain version and dispatcher.

Counterpart of `bvh_tpu.traverse.collect.collect_kernel`. For each ray
it walks the binary top region of a treelet-decomposed BVH and records
every portal (treelet root) whose box the ray enters, with its entry
distance (reference: bvh.h:124-182, node.h:68-88, restricted to the top
region). The per-treelet continuation is the wide-treelet traversal.

Top table: [16, Pt] f32, one column per top inner node's child pair;
rows 0-5 left bounds, 6-11 right bounds, 12-13 the children's index
words as f32. A word with a nonzero low nibble is a portal,
`tid << 4 | 1`.

`collect_portals` runs the CUDA kernel (csrc/collect.cu) for a tensor
on a CUDA device and `collect_portals_ref`, the plain PyTorch version,
for a tensor on the CPU.
"""

from __future__ import annotations

import torch

from bvh_tpu_torch import kernels
from bvh_tpu_torch.core.utils import add_ulp_magnitude, robust_max, robust_min

_EPS = torch.finfo(torch.float32).eps
_BIG = torch.finfo(torch.float32).max


def slab_inverse(org, dir_, robust: bool):
    """(inv, inv_org, inv_pad, neg) of [3, B] origins and directions,
    as the reference kernels compute them (collect.py:44-56): robust
    takes the plain 1/dir, fast the clamped safe inverse; the far plane
    of the robust test uses inv padded by 2 ulps."""
    inv = 1.0 / dir_
    if not robust:
        big = torch.full_like(dir_, _BIG)
        inv = torch.where(dir_.abs() <= _EPS,
                          torch.where(torch.signbit(dir_), -big, big), inv)
    return inv, -inv * org, add_ulp_magnitude(inv, 2), torch.signbit(dir_)


def slab_planes(lo, hi, d, org, inv, inv_org, inv_pad, neg, robust: bool):
    """Near and far plane distances on axis d for [B] bounds."""
    nb = torch.where(neg[d], hi, lo)
    fb = torch.where(neg[d], lo, hi)
    if robust:
        return (nb - org[d]) * inv[d], (fb - org[d]) * inv_pad[d]
    return nb * inv[d] + inv_org[d], fb * inv[d] + inv_org[d]


def collect_portals_ref(top_node_t, rays, root_word: int, *, robust: bool,
                        stack_depth: int, max_portals: int):
    """Plain PyTorch version of the collect kernel: a vectorised state
    machine over [rows, R] tensors, one step per loop iteration, as the
    reference's while loop (collect.py:122-205).

    rays: [8, R] f32 (org 0-2, dir 3-5, tmin 6, tmax 7).
    Returns ptid [MP, R] i32 (-1 unused), ptent [MP, R] f32 (+inf
    unused), stats [3, R] i32: portal count (counting past the cap),
    stack high-water mark, sticky stack-overflow flag. A push onto a
    full stack drops the bottom entry and sets the flag (ROADMAP C3)."""
    R = rays.shape[1]
    dev = rays.device
    org, dir_, tmin, tmax0 = rays[0:3], rays[3:6], rays[6], rays[7]
    inv, inv_org, inv_pad, neg = slab_inverse(org, dir_, robust)
    MP = max_portals
    i64 = torch.int64

    def slab(b):
        t0, t1 = tmin, tmax0
        for d in range(3):
            tn, tf = slab_planes(b[2 * d], b[2 * d + 1], d, org, inv,
                                 inv_org, inv_pad, neg, robust)
            t0 = robust_max(tn, t0)
            t1 = robust_min(tf, t1)
        return t0, t1

    lanes = torch.arange(R, device=dev)
    stack = torch.zeros((stack_depth, R), dtype=i64, device=dev)
    sp = torch.zeros(R, dtype=i64, device=dev)
    top = torch.full((R,), root_word, dtype=i64, device=dev)
    active = tmin <= tmax0
    ptid = torch.full((MP, R), -1, dtype=i64, device=dev)
    ptent = torch.full((MP, R), float("inf"), dtype=torch.float32,
                       device=dev)
    pcnt = torch.zeros(R, dtype=i64, device=dev)
    hwm = torch.zeros(R, dtype=i64, device=dev)
    ovf = torch.zeros(R, dtype=torch.bool, device=dev)
    n_cols = top_node_t.shape[1]

    def record(mask, word, t):
        m = mask & (pcnt < MP)
        ptid[pcnt[m], lanes[m]] = word[m] >> 4
        ptent[pcnt[m], lanes[m]] = t[m]
        return pcnt + mask.to(i64)

    while bool(active.any()):
        top_is_leaf = (top & 15) != 0
        pcnt = record(active & top_is_leaf, top, tmin)
        do_node = active & ~top_is_leaf
        col = ((top >> 4) >> 1).clamp(0, n_cols - 1)
        nrow = top_node_t[:, col]
        tl0, tl1 = slab(nrow[0:6])
        tr0, tr1 = slab(nrow[6:12])
        idx_l = nrow[12].to(i64)
        idx_r = nrow[13].to(i64)
        hit_l = (tl0 <= tl1) & do_node
        hit_r = (tr0 <= tr1) & do_node
        leaf_l = (idx_l & 15) != 0
        leaf_r = (idx_r & 15) != 0
        pcnt = record(hit_l & leaf_l, idx_l, tl0)
        pcnt = record(hit_r & leaf_r, idx_r, tr0)

        dl = hit_l & ~leaf_l
        dr = hit_r & ~leaf_r
        both = dl & dr
        swap = tl0 > tr0
        near = torch.where(swap, idx_r, idx_l)
        far = torch.where(swap, idx_l, idx_r)
        new_top = torch.where(both, near, torch.where(dl, idx_l, idx_r))
        descend = dl | dr

        # top-at-row-0 shift stack: a push shifts down, dropping the
        # bottom row when the stack is full
        push = both
        stack = torch.where(push, torch.cat([far[None], stack[:-1]]), stack)
        ovf = ovf | (push & (sp >= stack_depth))
        sp = torch.where(push, (sp + 1).clamp(max=stack_depth), sp)
        hwm = torch.maximum(hwm, sp)

        need_pop = active & ~descend
        can_pop = need_pop & (sp > 0)
        sp = sp - can_pop.to(i64)
        popped = stack[0]
        stack = torch.where(can_pop, torch.cat([stack[1:], stack[:1] * 0]),
                            stack)
        top = torch.where(descend, new_top, torch.where(can_pop, popped, top))
        active = active & ~(need_pop & ~can_pop)

    stats = torch.stack([pcnt, hwm, ovf.to(i64)])
    return ptid.to(torch.int32), ptent, stats.to(torch.int32)


def collect_portals(top_node_t, rays, root_word: int, *, robust: bool,
                    stack_depth: int, max_portals: int):
    """Phase-A collect: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Same outputs as `collect_portals_ref`."""
    if rays.device.type == "cpu":
        return collect_portals_ref(top_node_t, rays, root_word,
                                   robust=robust, stack_depth=stack_depth,
                                   max_portals=max_portals)
    if rays.device.type != "cuda":
        raise ValueError(f"collect_portals: unsupported device {rays.device}")
    if not 1 <= stack_depth <= kernels.TOP_STACK_MAX:
        raise ValueError(f"collect_portals: top stack depth {stack_depth} "
                         f"exceeds the kernel's {kernels.TOP_STACK_MAX}")
    for name, t, rows in (("top_node_t", top_node_t, 16), ("rays", rays, 8)):
        if (t.device != rays.device or t.dtype != torch.float32
                or t.dim() != 2 or t.shape[0] != rows
                or not t.is_contiguous()):
            raise ValueError(f"collect_portals: {name} must be a contiguous "
                             f"[{rows}, N] float32 tensor on {rays.device}")
    R = rays.shape[1]
    ptid = torch.empty((max_portals, R), dtype=torch.int32,
                       device=rays.device)
    ptent = torch.empty((max_portals, R), dtype=torch.float32,
                        device=rays.device)
    stats = torch.empty((3, R), dtype=torch.int32, device=rays.device)
    kernels.COLLECT.launch(
        top_node_t.data_ptr(), top_node_t.shape[1], rays.data_ptr(), R,
        int(root_word), int(robust), stack_depth, max_portals,
        ptid.data_ptr(), ptent.data_ptr(), stats.data_ptr())
    return ptid, ptent, stats
