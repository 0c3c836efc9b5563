"""Each ray's portal list in entry order: the render driver's portal
sort (phase A) and phase A2's merge, plain versions and dispatchers.

Phase A (kernel B2) leaves a ray's portal records [MP, R] in walk
order, `min(count, MP)` of them and then -1 / +inf. The render wants
them ascending by entry t, stably (the JAX package's `_render_jit`
sorts the columns with `jax.lax.sort`, bvh_tpu/traverse/wide_treelet.py
:1892). In a two-level scene the supers are split off first: the
super list in entry order, cut at `mps`, and the treelet list, each
super replaced by -1 / +inf (:1740-1760); each A2 round then merges the
new treelet portals of a ray's K2 supers (kernel B4's records, in
(record, pair) order) stably after the ray's equal keys and cuts the
list at MP (:1840-1873). Every order here is the one
`torch.sort(..., dim=0, stable=True)` gives on a CUDA tensor: the key
is the float's bits as CUDA's radix sort orders them, with -0.0 equal
to +0.0 (cub's digit extractor), -NaN first and +NaN last; equal keys
keep their record order.

- `sort_columns`: the sorted lists [MP, Rc] of the rays `sel`;
- `split_columns`: the same records as a two-level scene's super list
  [mps, Rc], supers per ray, treelet list [MP, Rc] and its length;
- `merge_columns`: one A2 round's merge, in place, and each merged
  list's finite count.

Each runs the kernel of csrc/portal_sort.cu for CUDA tensors and the
plain version (`*_plain`: the torch sorts over the padded columns, the
code the kernel replaced) for tensors on the CPU (or the meta device,
where it only carries shapes). A plain version takes its dispatcher's
arguments, so either can stand in for the other; the counts it does not
need (`cnt`, `ncnt`) it ignores, since the padding already marks them.

A treelet list's length (`tlen`) is the slot after its last portal
(tid != -1): every slot from there on holds -1 / +inf. The kernel keeps
it so that a merge reads only a list's portals.
"""

from __future__ import annotations

import torch

from bvh_tpu_torch import kernels

_I32, _I64, _F32 = torch.int32, torch.int64, torch.float32


# ------------------------------------------------------------ plain versions
def sort_columns_plain(ptid, ptent, cnt, sel):
    """The portal records of rays `sel`, each ray's sorted ascending by
    entry t, stably: (tid [MP, len(sel)] int64, tent f32). `cnt` is
    not read."""
    tent, order = torch.sort(ptent[:, sel], dim=0, stable=True)
    return torch.gather(ptid[:, sel].to(_I64), 0, order), tent


def list_length(tid):
    """[Rc] int32: each column's slot after its last portal (tid != -1),
    0 for an empty list."""
    slot = torch.arange(1, tid.shape[0] + 1, device=tid.device)[:, None]
    return torch.where(tid != -1, slot, 0).amax(0).to(_I32)


def split_columns_plain(ptid, ptent, cnt, sel, *, T: int, mps: int):
    """`sort_columns_plain`, then the two-level split: supers are the
    portals tid >= T. Returns (tid [MP, Rc] int64, tent f32: the treelet
    list, each super replaced by -1 / +inf and moved back stably;
    sup [mps, Rc] int32: the supers (tid - T) in entry order, cut at
    mps, -1 past; nsup [Rc] int32: supers a ray recorded, uncut; tlen
    [Rc] int32: the treelet list's length)."""
    tid, tent = sort_columns_plain(ptid, ptent, cnt, sel)
    Rc = tid.shape[1]
    is_sup = tid >= T
    order = torch.sort((~is_sup).to(torch.int8), dim=0, stable=True).indices
    sup = torch.where(is_sup, tid - T, -1).gather(0, order)[:mps]
    if sup.shape[0] < mps:
        sup = torch.cat([sup, sup.new_full((mps - sup.shape[0], Rc), -1)])
    main_t, order = torch.sort(torch.where(is_sup, float("inf"), tent),
                               dim=0, stable=True)
    main_id = torch.where(is_sup, -1, tid).gather(0, order)
    return (main_id, main_t, sup.to(_I32), is_sup.sum(0).to(_I32),
            list_length(main_id))


def merge_columns_plain(tid, tent, tlen, rsel, jj, rr, ntid, nt, ncnt, *,
                        k2: int, max_new: int):
    """One A2 round's merge into the treelet lists tid [MP, Rc] int64,
    tent f32 and their lengths tlen [Rc] int32, in place, at the columns
    `rsel` [Rr]: pair i of kernel B4's records ntid [max_new, L] int32,
    nt f32 is window slot jj[i] of ray rr[i]; a ray's new records, laid
    out (record, slot), are sorted stably by entry t and merged after
    its list's equal keys; the first MP are kept (`ncnt`, B4's record
    counts, is not read). Returns the merged lists' finite counts [Rr]
    int32, before the cut."""
    MP = tid.shape[0]
    Rr = rsel.numel()
    new_id = torch.full((max_new, k2, Rr), -1, dtype=_I64, device=tid.device)
    new_t = torch.full((max_new, k2, Rr), float("inf"), dtype=_F32,
                       device=tid.device)
    new_id[:, jj, rr] = ntid.to(_I64)
    new_t[:, jj, rr] = nt
    cat_t, order = torch.sort(
        torch.cat([tent[:, rsel], new_t.reshape(-1, Rr)]), dim=0, stable=True)
    cat_id = torch.cat([tid[:, rsel], new_id.reshape(-1, Rr)]).gather(0, order)
    tent[:, rsel] = cat_t[:MP]
    tid[:, rsel] = cat_id[:MP]
    tlen[rsel] = list_length(cat_id[:MP])
    return torch.isfinite(cat_t).sum(0).to(_I32)


# -------------------------------------------------------------- dispatchers
def _check(name, cond, what):
    if not cond:
        raise ValueError(f"{name}: {what}")


def _check_records(name, ptid, ptent, cnt, sel):
    dev = ptent.device
    MP, R = ptent.shape if ptent.dim() == 2 else (-1, -1)
    _check(name, ptent.dtype == _F32 and ptent.dim() == 2
           and ptent.is_contiguous(), "ptent must be a contiguous [MP, R] "
           "float32 tensor")
    _check(name, ptid.dtype == _I32 and tuple(ptid.shape) == (MP, R)
           and ptid.is_contiguous() and ptid.device == dev,
           f"ptid must be a contiguous [MP, R] int32 tensor on {dev}")
    _check(name, cnt.dtype == _I32 and tuple(cnt.shape) == (R,)
           and cnt.is_contiguous() and cnt.device == dev,
           f"cnt must be a contiguous [R] int32 tensor on {dev}")
    _check(name, sel.dtype == _I64 and sel.dim() == 1
           and sel.is_contiguous() and sel.device == dev,
           f"sel must be a contiguous [Rc] int64 tensor on {dev}")


def sort_columns(ptid, ptent, cnt, sel):
    """`sort_columns_plain` of phase A's records ptid [MP, R] int32,
    ptent f32 with counts cnt [R] int32 (B2's stats[0]; slots from
    min(cnt, MP) on hold -1 / +inf) at the rays sel [Rc] int64: the
    kernel for CUDA tensors, which reads only each ray's records, the
    plain version for CPU tensors."""
    if ptent.device.type != "cuda":
        return sort_columns_plain(ptid, ptent, cnt, sel)
    _check_records("sort_columns", ptid, ptent, cnt, sel)
    MP, R = ptent.shape
    Rc = sel.numel()
    tid = torch.empty((MP, Rc), dtype=_I64, device=ptent.device)
    tent = torch.empty((MP, Rc), dtype=_F32, device=ptent.device)
    kernels.PORTAL_SORT.launch(
        ptid.data_ptr(), ptent.data_ptr(), cnt.data_ptr(), R, MP,
        sel.data_ptr(), Rc, -1, 0, tid.data_ptr(), tent.data_ptr(), None,
        None, None)
    return tid, tent


def split_columns(ptid, ptent, cnt, sel, *, T: int, mps: int):
    """`split_columns_plain` (same inputs as `sort_columns`): the kernel,
    in one launch, for CUDA tensors, the plain version for CPU
    tensors."""
    if ptent.device.type != "cuda":
        return split_columns_plain(ptid, ptent, cnt, sel, T=T, mps=mps)
    _check_records("split_columns", ptid, ptent, cnt, sel)
    _check("split_columns", T >= 0 and mps >= 1, "needs T >= 0, mps >= 1")
    MP, R = ptent.shape
    Rc = sel.numel()
    dev = ptent.device
    tid = torch.empty((MP, Rc), dtype=_I64, device=dev)
    tent = torch.empty((MP, Rc), dtype=_F32, device=dev)
    sup = torch.empty((mps, Rc), dtype=_I32, device=dev)
    nsup = torch.empty(Rc, dtype=_I32, device=dev)
    tlen = torch.empty(Rc, dtype=_I32, device=dev)
    kernels.PORTAL_SORT.launch(
        ptid.data_ptr(), ptent.data_ptr(), cnt.data_ptr(), R, MP,
        sel.data_ptr(), Rc, T, mps, tid.data_ptr(), tent.data_ptr(),
        sup.data_ptr(), nsup.data_ptr(), tlen.data_ptr())
    return tid, tent, sup, nsup, tlen


def merge_columns(tid, tent, tlen, rsel, jj, rr, ntid, nt, ncnt, *, k2: int,
                  max_new: int):
    """`merge_columns_plain`; ncnt [L] int32 is B4's record count per
    pair (stats[0], past the cap). The kernel, which reads only the
    lists' portals and the pairs' records and writes only the slots that
    change, for CUDA tensors; the plain version for CPU tensors."""
    if tent.device.type != "cuda":
        return merge_columns_plain(tid, tent, tlen, rsel, jj, rr, ntid, nt,
                                   ncnt, k2=k2, max_new=max_new)
    dev = tent.device
    MP, Rc = tent.shape if tent.dim() == 2 else (-1, -1)
    L = ncnt.numel()
    name = "merge_columns"
    _check(name, tent.dtype == _F32 and tent.dim() == 2
           and tent.is_contiguous(), "tent must be a contiguous [MP, Rc] "
           "float32 tensor")
    _check(name, tid.dtype == _I64 and tuple(tid.shape) == (MP, Rc)
           and tid.is_contiguous() and tid.device == dev,
           f"tid must be a contiguous [MP, Rc] int64 tensor on {dev}")
    _check(name, tlen.dtype == _I32 and tuple(tlen.shape) == (Rc,)
           and tlen.is_contiguous() and tlen.device == dev,
           f"tlen must be a contiguous [Rc] int32 tensor on {dev}")
    _check(name, rsel.dtype == _I64 and rsel.dim() == 1
           and rsel.is_contiguous() and rsel.device == dev,
           f"rsel must be a contiguous [Rr] int64 tensor on {dev}")
    _check(name, all(t.shape == (L,) and t.device == dev for t in (jj, rr)),
           f"jj and rr must be [L] tensors on {dev}")
    _check(name, ncnt.dtype == _I32 and ncnt.is_contiguous()
           and ncnt.device == dev, f"ncnt must be a contiguous [L] int32 "
           f"tensor on {dev}")
    for t, dt in ((ntid, _I32), (nt, _F32)):
        _check(name, t.dtype == dt and tuple(t.shape) == (max_new, L)
               and t.is_contiguous() and t.device == dev,
               f"ntid and nt must be contiguous [max_new, L] int32 and "
               f"float32 tensors on {dev}")
    _check(name, 1 <= k2 and max_new >= 1 and k2 * max_new < (1 << 31),
           "needs k2 >= 1 and max_new >= 1")
    Rr = rsel.numel()
    pair = torch.full((k2, Rr), -1, dtype=_I32, device=dev)
    pair[jj, rr] = torch.arange(L, dtype=_I32, device=dev)
    dest = torch.empty((max_new, L), dtype=_I32, device=dev)
    fcnt = torch.empty(Rr, dtype=_I32, device=dev)
    kernels.PORTAL_MERGE.launch(
        tid.data_ptr(), tent.data_ptr(), tlen.data_ptr(), MP, Rc,
        rsel.data_ptr(), Rr, pair.data_ptr(), k2, ntid.data_ptr(),
        nt.data_ptr(), ncnt.data_ptr(), L, max_new, dest.data_ptr(),
        fcnt.data_ptr())
    return fcnt
