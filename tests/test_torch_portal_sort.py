"""The portal ordering (`traverse/portal_sort.py`) on the CPU, where its
dispatchers take the plain versions: they launch nothing, and the
render driver's new split of the work (the two-level split done by the
phase-A ordering, each A2 round's merge a call of its own, the treelet
lists' lengths kept beside them) gives what the render driver's single
`expand_supers` gave before, on the two-level cut of the scene of
tests/test_torch_trace.py (sponza_class(3000, 3), a MEDIUM tree built by
the port, 32x32 primary rays, max_prims=128, super_prims=512) and on
crafted columns. The kernel itself is held to the plain versions on the
card (tests/test_torch_cuda.py, `-k portal`).
"""

import pytest
import torch

from bvh_tpu_torch import kernels
from bvh_tpu_torch.build.default import DefaultConfig, Quality, build_default
from bvh_tpu_torch.cli.camera import primary_rays
from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri
from bvh_tpu_torch.io.scenes import scene_camera, sponza_class
from bvh_tpu_torch.traverse import portal_sort as ps
from bvh_tpu_torch.traverse import wide_treelet as wt


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """At these sizes torch's intra-op threads gain nothing and contend
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def two_level():
    tris = sponza_class(3000, seed=3)
    tt = torch.from_numpy(tris)
    bvh = build_default(tt.min(1).values, tt.max(1).values, tt.mean(1),
                        DefaultConfig(quality=Quality.MEDIUM))
    flat = PrecomputedTri.from_tri(Tri(tt[:, 0], tt[:, 1], tt[:, 2])).as_flat()
    eye, d, up = scene_camera(tris)
    rays = primary_rays(eye, d, up, 32, 32, device="cpu")
    tl = wt.build_wide_treelets(bvh, flat, max_prims=128, super_prims=512)
    assert tl.sup_cols.shape[0] > 1
    return tl, wt.pack_rays(rays)


@pytest.fixture
def no_launch(monkeypatch):
    """Make any launch of the ordering's kernels fail the test."""
    def refuse(*args):
        raise AssertionError("a CPU tensor launched a kernel")

    for k in (kernels.PORTAL_SORT, kernels.PORTAL_MERGE):
        monkeypatch.setattr(k, "launch", refuse)


def _expand_supers_before(tl, portals, rays_c, *, robust, sup_stack, mps,
                          max_new, max_portals):
    """The render driver's phase A2 as it was before the ordering had a kernel:
    the split and every merge as torch sorts over the padded columns of
    phase A's sorted lists (`portals.tid`, supers included)."""
    T = tl.table.shape[0]
    i64 = torch.int64
    tid, tent = portals.tid, portals.tent
    Rc = tid.shape[1]
    is_sup = tid >= T
    bits = 0
    if Rc and int(is_sup.sum(0).max()) > mps:
        bits |= 1
    order = torch.sort((~is_sup).to(torch.int8), dim=0, stable=True).indices
    sup_id = torch.where(is_sup, tid - T, -1).gather(0, order)[:mps]
    if sup_id.shape[0] < mps:
        sup_id = torch.cat([sup_id, sup_id.new_full(
            (mps - sup_id.shape[0], Rc), -1)])
    main_t, order = torch.sort(torch.where(is_sup, float("inf"), tent),
                               dim=0, stable=True)
    main_id = torch.where(is_sup, -1, tid).gather(0, order)
    diag = dict(a2_rounds=0, a2_pairs=0, sup_ovf=False)
    scur = torch.zeros(Rc, dtype=i64)
    lanes = torch.arange(Rc)
    steps = torch.arange(wt.K2)[:, None]
    while True:
        cur = torch.where(scur < mps, sup_id.gather(
            0, scur.clamp(max=mps - 1)[None])[0], -1)
        rsel = lanes[cur >= 0]
        if rsel.numel() == 0:
            break
        idx = scur[rsel][None, :] + steps
        wsid = torch.where(idx < mps, sup_id[:, rsel].gather(
            0, idx.clamp(max=mps - 1)), -1)
        jj, rr = torch.nonzero(wsid >= 0, as_tuple=True)
        perm = torch.sort(wsid[jj, rr], stable=True).indices
        jj, rr = jj[perm], rr[perm]
        ntid, nt, stats = wt.collect_super_pairs(
            tl.sup_cols, wsid[jj, rr].to(torch.int32).contiguous(),
            rays_c[:, rsel[rr]].contiguous(), robust=robust,
            stack_depth=sup_stack, max_new=max_new)
        diag["a2_rounds"] += 1
        diag["a2_pairs"] += rr.numel()
        if rr.numel():
            if int(stats[0].max()) > max_new:
                bits |= 2
            diag["sup_ovf"] |= bool(stats[2].any())
        Rr = rsel.numel()
        new_id = torch.full((max_new, wt.K2, Rr), -1, dtype=i64)
        new_t = torch.full((max_new, wt.K2, Rr), float("inf"))
        new_id[:, jj, rr] = ntid.to(i64)
        new_t[:, jj, rr] = nt
        cat_t, order = torch.sort(
            torch.cat([main_t[:, rsel], new_t.reshape(-1, Rr)]), dim=0,
            stable=True)
        cat_id = torch.cat([main_id[:, rsel],
                            new_id.reshape(-1, Rr)]).gather(0, order)
        if int(torch.isfinite(cat_t).sum(0).max()) > max_portals:
            bits |= 4
        main_t[:, rsel] = cat_t[:max_portals]
        main_id[:, rsel] = cat_id[:max_portals]
        scur[rsel] += wt.K2
    return main_id, main_t, bits, diag


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _tail_is_empty(tid, tent, tlen):
    slot = torch.arange(tid.shape[0])[:, None]
    past = slot >= tlen[None, :].to(torch.int64)
    return bool((tid[past] == -1).all() and torch.isinf(tent[past]).all()
                and (tid.gather(0, (tlen.to(torch.int64) - 1).clamp(min=0)
                                [None])[0] != -1)[tlen > 0].all())


# the render's caps, then caps small enough to set each A2 overflow bit
CAPS = {"render": {}, "mps": dict(mps=1), "max_new": dict(max_new=1),
        "max_portals": dict(max_portals=8)}


@pytest.mark.parametrize("robust", [False, True])
@pytest.mark.parametrize("case", sorted(CAPS))
def test_split_then_merges_equal_the_single_expand(two_level, no_launch,
                                                   case, robust):
    """Phase A's ordering split at mps, then `expand_supers`' merges,
    against the same rays' phase A2 as the render driver made it before:
    treelet lists, bits and diag equal; the lists' lengths are right."""
    tl, packed = two_level
    caps = dict(wt.wide_treelet_caps(tl, wt.portals_per_round(tl)),
                **CAPS[case])
    kw = dict(robust=robust, top_stack=tl.top_depth + 1,
              max_portals=caps["max_portals"])
    full = wt.collect_and_sort(tl, packed, **kw)
    split = wt.collect_and_sort(tl, packed, mps=caps["mps"], **kw)
    assert torch.equal(full.sel, split.sel)
    rays_c = packed[:, full.sel]
    a2 = dict(robust=robust, sup_stack=tl.sup_depth + 1, mps=caps["mps"],
              max_new=caps["max_new"], max_portals=caps["max_portals"])
    want = _expand_supers_before(tl, full, rays_c, **a2)
    got = wt.expand_supers(tl, split, rays_c, **a2)
    assert torch.equal(got[0], want[0])
    assert torch.equal(_bits(got[1]), _bits(want[1]))
    assert got[2:] == want[2:]
    assert want[3]["a2_rounds"] > 0
    assert (want[2] != 0) == (case != "render")
    assert _tail_is_empty(got[0], got[1], split.sup.tlen)


def test_expand_supers_needs_the_split(two_level):
    tl, packed = two_level
    portals = wt.collect_and_sort(tl, packed, robust=False,
                                  top_stack=tl.top_depth + 1, max_portals=64)
    with pytest.raises(ValueError, match="split"):
        wt.expand_supers(tl, portals, packed[:, portals.sel], robust=False,
                         sup_stack=tl.sup_depth + 1, mps=16, max_new=16,
                         max_portals=64)


def _crafted(MP=12, R=9, T=20, seed=0):
    """Phase-A-shaped records: ray c holds cnt[c] records (0, a few,
    exactly MP, past MP), then -1 / +inf; entry t with ties, -0.0 and
    +0.0, and a valid +inf; ids below T are treelets, from T supers."""
    g = torch.Generator().manual_seed(seed)
    cnt = torch.tensor([0, 3, MP, MP + 5, 1, 7, 2, MP - 1, 5][:R],
                       dtype=torch.int32)
    ptid = torch.full((MP, R), -1, dtype=torch.int32)
    ptent = torch.full((MP, R), float("inf"))
    for c in range(R):
        n = min(int(cnt[c]), MP)
        ptid[:n, c] = torch.randint(0, T + 6, (n,), generator=g,
                                    dtype=torch.int32)
        ptent[:n, c] = torch.randint(0, 4, (n,), generator=g).float()
    ptent[0, 2], ptent[1, 2], ptent[2, 2] = -0.0, 0.0, float("inf")
    ptent[3, 3], ptent[4, 3] = 0.0, -0.0
    return ptid, ptent, cnt


def test_sort_columns_is_the_plain_version(no_launch):
    ptid, ptent, cnt = _crafted()
    sel = torch.nonzero(cnt > 0).squeeze(1)
    got = ps.sort_columns(ptid, ptent, cnt, sel)
    want = ps.sort_columns_plain(ptid, ptent, cnt, sel)
    tent, order = torch.sort(ptent[:, sel], dim=0, stable=True)
    assert torch.equal(got[0], want[0])
    assert torch.equal(_bits(got[1]), _bits(want[1]))
    assert torch.equal(got[0], ptid[:, sel].to(torch.int64).gather(0, order))
    assert torch.equal(_bits(got[1]), _bits(tent))


@pytest.mark.parametrize("mps", [1, 3, 16])
def test_split_columns_is_the_plain_split(no_launch, mps):
    T = 20
    ptid, ptent, cnt = _crafted(T=T)
    sel = torch.nonzero(cnt > 0).squeeze(1)
    tid, tent, sup, nsup, tlen = ps.split_columns(ptid, ptent, cnt, sel, T=T,
                                                  mps=mps)
    full, full_t = ps.sort_columns_plain(ptid, ptent, cnt, sel)
    is_sup = full >= T
    assert sup.shape == (mps, sel.numel()) and sup.dtype == torch.int32
    assert torch.equal(nsup, is_sup.sum(0).to(torch.int32))
    for r in range(sel.numel()):
        want_sup = (full[:, r][is_sup[:, r]] - T)[:mps]
        assert torch.equal(sup[:len(want_sup), r].to(torch.int64), want_sup)
        assert (sup[len(want_sup):, r] == -1).all()
        keep = tid[:, r] != -1
        assert torch.equal(tid[:, r][keep], full[:, r][~is_sup[:, r]
                                                     & (full[:, r] != -1)])
    assert _tail_is_empty(tid, tent, tlen)


def test_merge_columns_is_the_plain_merge(no_launch):
    """One merge into crafted treelet lists: the new records of a ray's
    window slots, ties with its list's keys and with each other, one
    pair past max_new, one ray without a pair in its second slot."""
    T, max_new = 20, 3
    ptid, ptent, cnt = _crafted(T=T)
    sel = torch.nonzero(cnt > 0).squeeze(1)
    tid, tent, _, _, tlen = ps.split_columns(ptid, ptent, cnt, sel, T=T,
                                             mps=4)
    rsel = torch.tensor([0, 2, 3, 5])
    jj = torch.tensor([0, 1, 0, 0, 1, 0, 1])
    rr = torch.tensor([0, 0, 1, 2, 2, 3, 3])
    L = jj.numel()
    g = torch.Generator().manual_seed(1)
    ncnt = torch.tensor([2, 3, 0, 5, 1, 3, 2], dtype=torch.int32)
    ntid = torch.full((max_new, L), -1, dtype=torch.int32)
    nt = torch.full((max_new, L), float("inf"))
    for i in range(L):
        n = min(int(ncnt[i]), max_new)
        ntid[:n, i] = torch.randint(0, T, (n,), generator=g,
                                    dtype=torch.int32)
        nt[:n, i] = torch.randint(0, 4, (n,), generator=g).float()
    nt[0, 0] = -0.0
    want_tid, want_t = tid.clone(), tent.clone()
    MP = tid.shape[0]
    new_id = torch.full((max_new, wt.K2, 4), -1, dtype=torch.int64)
    new_t = torch.full((max_new, wt.K2, 4), float("inf"))
    new_id[:, jj, rr] = ntid.to(torch.int64)
    new_t[:, jj, rr] = nt
    cat_t, order = torch.sort(torch.cat([want_t[:, rsel],
                                         new_t.reshape(-1, 4)]), dim=0,
                              stable=True)
    cat_id = torch.cat([want_tid[:, rsel],
                        new_id.reshape(-1, 4)]).gather(0, order)
    want_t[:, rsel] = cat_t[:MP]
    want_tid[:, rsel] = cat_id[:MP]
    fcnt = ps.merge_columns(tid, tent, tlen, rsel, jj, rr, ntid, nt, ncnt,
                            k2=wt.K2, max_new=max_new)
    assert torch.equal(tid, want_tid)
    assert torch.equal(_bits(tent), _bits(want_t))
    assert torch.equal(fcnt, torch.isfinite(cat_t).sum(0).to(torch.int32))
    assert _tail_is_empty(tid, tent, tlen)



@pytest.mark.parametrize("name", ["sort_columns", "split_columns",
                                  "merge_columns"])
def test_plain_version_takes_the_dispatchers_arguments(name):
    """Each plain version has its dispatcher's signature, so that one
    stands in for the other (the card tests swap them into the render
    driver) with no adapter."""
    import inspect
    assert inspect.signature(getattr(ps, f"{name}_plain")) == \
        inspect.signature(getattr(ps, name))
