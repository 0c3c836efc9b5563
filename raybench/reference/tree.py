"""Checks of a binary BVH against its triangles, in plain PyTorch.

The tree is read in the upstream library's layout (node.h, index.h):
node bounds [N, 6] interleaved (min x, max x, min y, ...), index words
first << 4 | count, where count 0 marks an inner node whose children
are first and first + 1, and a leaf holds prim_ids[first:first + count].
"""

from __future__ import annotations

import torch


def check_tree(bounds, index, prim_ids, node_count: int, tris) -> dict:
    """{"tree_bad_prims", "tree_bad_boxes"}: the triangles of `tris`
    [n, 3, 3] that are not in exactly one leaf reached from the root,
    and the boxes reached from the root that do not enclose what is
    under them (a child's box, or a leaf triangle's vertices), counted
    exactly."""
    n = tris.shape[0]
    device = tris.device
    index = index[:node_count].to(torch.int64)
    box = bounds[:node_count].to(torch.float64)
    bmin, bmax = box[:, 0::2], box[:, 1::2]
    first, count = index >> 4, index & 15
    seen = torch.zeros(n, dtype=torch.int64, device=device)
    bad_boxes = 0
    bad_links = 0
    vmin = tris.to(torch.float64).amin(1)
    vmax = tris.to(torch.float64).amax(1)
    frontier = torch.zeros(1, dtype=torch.int64, device=device)
    visits = 0
    while frontier.numel():
        visits += frontier.numel()
        if visits > node_count:          # a cycle, or a node reached twice
            bad_links += 1
            break
        leaf = count[frontier] > 0
        leaves, inner = frontier[leaf], frontier[~leaf]
        # leaves: every position of their ranges, its triangle in the box
        cnt = count[leaves]
        pos = (torch.repeat_interleave(first[leaves], cnt)
               + torch.arange(int(cnt.sum()), device=device)
               - torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt))
        owner = torch.repeat_interleave(leaves, cnt)
        okpos = (pos >= 0) & (pos < prim_ids.shape[0])
        bad_links += int((~okpos).sum())
        pid = prim_ids[pos[okpos]].to(torch.int64)
        owner = owner[okpos]
        okid = (pid >= 0) & (pid < n)
        bad_links += int((~okid).sum())
        pid, owner = pid[okid], owner[okid]
        seen += torch.bincount(pid, minlength=n)
        bad_boxes += int(((vmin[pid] < bmin[owner])
                          | (vmax[pid] > bmax[owner])).any(1).sum())
        # inner nodes: both children inside the node count, in the box
        kids = torch.stack([first[inner], first[inner] + 1], 1)
        okkid = ((kids > 0) & (kids < node_count)).all(1)
        bad_links += int((~okkid).sum())
        inner, kids = inner[okkid], kids[okkid]
        bad_boxes += int(((bmin[kids] < bmin[inner][:, None])
                          | (bmax[kids] > bmax[inner][:, None]))
                         .any(2).any(1).sum())
        frontier = kids.reshape(-1)
    bad_prims = int((seen != 1).sum()) + bad_links
    return {"tree_bad_prims": bad_prims, "tree_bad_boxes": bad_boxes}
