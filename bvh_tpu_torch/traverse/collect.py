"""Binary portal collect: phase A (kernel B2) and phase A2 (kernel B4),
plain versions and dispatchers.

B2 is the counterpart of `bvh_tpu.traverse.collect.collect_kernel`. For
each ray it walks the binary top region of a treelet-decomposed BVH and
records every portal (treelet root) whose box the ray enters, with its
entry distance (reference: bvh.h:124-182, node.h:68-88, restricted to
the top region). The per-treelet continuation is the wide-treelet
traversal.

B4 is the counterpart of `_collect_core` in
`bvh_tpu.traverse.wide_treelet` (:1158), run by `_phase_a2` (:1333) for
two-level scenes: the same walk per (ray, super) pair, over the super's
own pair table [16, Ps] from root word 1 << 4, folding the slab planes
with NaN-propagating min/max as the reference does there (ROADMAP C6,
C10). Its kernel reads the super tables as `WideTreelets.sup_cols`
[S, Ps, 16], a pair's 14 floats in one 64-byte row; its plain version
reads the same storage as the [S, 16, Ps] `WideTreelets.sup_table`
view, the reference's layout.

Top table: [16, Pt] f32, one column per top inner node's child pair;
rows 0-5 left bounds, 6-11 right bounds, 12-13 the children's index
words as f32. A word with a nonzero low nibble is a portal,
`tid << 4 | 1`.

`collect_portals` and `collect_super_pairs` run the CUDA kernels
(csrc/collect.cu) for tensors on a CUDA device, and `collect_portals_ref`
and `collect_super_pairs_plain` (`collect_super_pairs_ref` on
`sup_cols`' transposed view), the plain PyTorch versions, for tensors on
the CPU.
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
    """Plain PyTorch version of kernel B2: a vectorised state machine
    over [rows, R] tensors, one step per loop iteration, as the
    reference's while loop (collect.py:122-205).

    rays: [8, R] f32 (org 0-2, dir 3-5, tmin 6, tmax 7).
    Returns ptid [MP, R] i32 (-1 unused), ptent [MP, R] f32 (+inf
    unused), stats [3, R] i32: portal count (counting past the cap),
    stack high-water mark, sticky stack-overflow flag. A push onto a
    full stack drops the bottom entry and sets the flag (ROADMAP C3)."""
    n_cols = top_node_t.shape[1]
    return _collect_ref(lambda col: top_node_t[:, col.clamp(0, n_cols - 1)],
                        rays, root_word, robust=robust,
                        stack_depth=stack_depth, max_portals=max_portals,
                        nan_minmax=False)


def collect_super_pairs_ref(sup_table, sid, rays, *, robust: bool,
                            stack_depth: int, max_new: int):
    """Plain PyTorch version of kernel B4: the walk of
    `collect_portals_ref` per (ray, super) pair, over the pair's table
    `sup_table[sid]` [16, Ps] from root word 1 << 4, with NaN-propagating
    min/max (wide_treelet.py:1200-1201).

    sid: [L] int32 supers; rays: [8, L] f32. Returns ntid [max_new, L]
    i32 (treelet ids, -1 unused), nt [max_new, L] f32 (+inf unused),
    stats [3, L] i32 (recordable-portal count, stack high-water mark,
    overflow)."""
    n_cols = sup_table.shape[2]
    s = sid.to(torch.int64)
    return _collect_ref(
        lambda col: sup_table[s, :, col.clamp(0, n_cols - 1)].T, rays,
        1 << 4, robust=robust, stack_depth=stack_depth, max_portals=max_new,
        nan_minmax=True)


def collect_super_pairs_plain(sup_cols, sid, rays, *, robust: bool,
                              stack_depth: int, max_new: int):
    """`collect_super_pairs_ref` on the super rows [S, Ps, 16]
    (`WideTreelets.sup_cols`) that the kernel takes, through their
    [S, 16, Ps] view: the plain version with the kernel's inputs."""
    return collect_super_pairs_ref(sup_cols.transpose(1, 2), sid, rays,
                                   robust=robust, stack_depth=stack_depth,
                                   max_new=max_new)


def _collect_ref(fetch, rays, root_word: int, *, robust: bool,
                 stack_depth: int, max_portals: int, nan_minmax: bool):
    """The collect state machine; `fetch(col)` returns the [16, R] pair
    columns `col` of each ray's table."""
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
            if nan_minmax:
                t0 = torch.maximum(tn, t0)
                t1 = torch.minimum(tf, t1)
            else:
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

    def record(mask, word, t):
        m = mask & (pcnt < MP)
        ptid[pcnt[m], lanes[m]] = word[m] >> 4
        ptent[pcnt[m], lanes[m]] = t[m]
        return pcnt + mask.to(i64)

    while bool(active.any()):
        top_is_leaf = (top & 15) != 0
        pcnt = record(active & top_is_leaf, top, tmin)
        do_node = active & ~top_is_leaf
        nrow = fetch((top >> 4) >> 1)
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


def check_super_inputs(sup_cols, sid, rays, stack_depth: int) -> None:
    """Raise ValueError unless B4's inputs are what its kernel takes: a
    contiguous, 16-byte aligned [S, Ps, 16] f32 row table
    (`WideTreelets.sup_cols`, not the [S, 16, Ps] `sup_table`), [L]
    int32 sid and [8, L] f32 rays on one device, and a stack within the
    compiled capacity."""
    if not 1 <= stack_depth <= kernels.TOP_STACK_MAX:
        raise ValueError(f"collect_super_pairs: stack depth {stack_depth} "
                         f"exceeds the kernel's {kernels.TOP_STACK_MAX}")
    L = sid.shape[0]
    if (sup_cols.device != rays.device or sup_cols.dtype != torch.float32
            or sup_cols.dim() != 3 or sup_cols.shape[2] != 16
            or not sup_cols.is_contiguous() or sup_cols.data_ptr() % 16):
        raise ValueError("collect_super_pairs: the super tables must be the "
                         "row layout, a contiguous 16-byte aligned "
                         f"[S, Ps, 16] float32 tensor on {rays.device} "
                         "(WideTreelets.sup_cols)")
    if (sid.device != rays.device or sid.dtype != torch.int32
            or sid.dim() != 1 or not sid.is_contiguous()):
        raise ValueError("collect_super_pairs: sid must be a contiguous [L] "
                         f"int32 tensor on {rays.device}")
    if (rays.dtype != torch.float32 or tuple(rays.shape) != (8, L)
            or not rays.is_contiguous()):
        raise ValueError("collect_super_pairs: rays must be a contiguous "
                         "[8, L] float32 tensor")


def collect_super_pairs(sup_cols, sid, rays, *, robust: bool,
                        stack_depth: int, max_new: int):
    """Phase A2 over the super tables [S, Ps, 16]
    (`WideTreelets.sup_cols`): kernel B4 for CUDA tensors, the plain
    version (`collect_super_pairs_plain`) for CPU tensors. Same outputs
    as `collect_super_pairs_ref`."""
    if rays.device.type == "cpu":
        return collect_super_pairs_plain(sup_cols, sid, rays, robust=robust,
                                         stack_depth=stack_depth,
                                         max_new=max_new)
    if rays.device.type != "cuda":
        raise ValueError(f"collect_super_pairs: unsupported device "
                         f"{rays.device}")
    check_super_inputs(sup_cols, sid, rays, stack_depth)
    L = sid.shape[0]
    ntid = torch.empty((max_new, L), dtype=torch.int32, device=rays.device)
    nt = torch.empty((max_new, L), dtype=torch.float32, device=rays.device)
    stats = torch.empty((3, L), dtype=torch.int32, device=rays.device)
    kernels.COLLECT_SUPER.launch(
        sup_cols.data_ptr(), sup_cols.shape[1], sid.data_ptr(),
        rays.data_ptr(), L, int(robust), stack_depth, max_new,
        ntid.data_ptr(), nt.data_ptr(), stats.data_ptr())
    return ntid, nt, stats
