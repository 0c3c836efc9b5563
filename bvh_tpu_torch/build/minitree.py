"""Mini-tree builder configuration and Morton-grid grouping.

Counterpart of the part of `bvh_tpu.build.minitree` that the fast
mini-tree build uses (reference: mini_tree_builder.h:30-43, 84-91,
160-193): the config, and steps 2-3 of the pipeline (Morton-grid bin per
primitive, then the greedy merge of adjacent small bins). The
level-synchronous `build_minitree` itself is not ported yet (ROADMAP A9).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bvh_tpu_torch.build.sah import TopDownConfig
from bvh_tpu_torch.core import utils


@dataclasses.dataclass(frozen=True)
class MiniTreeConfig(TopDownConfig):
    """Names and defaults of mini_tree_builder.h:30-43."""

    enable_pruning: bool = True
    pruning_area_ratio: float = 0.01
    parallel_threshold: int = 1024
    log2_grid_dim: int = 4


def merge_small_bins(bin_sizes: np.ndarray, threshold: int) -> np.ndarray:
    """Greedy grouping of adjacent bins (merge_small_bins, 84-91): a bin
    joins the current group while the group's size stays within
    `threshold`. Returns the group id of every bin."""
    group = np.empty(len(bin_sizes), np.int64)
    acc, gid = 0, 0
    for i, size in enumerate(bin_sizes.tolist()):
        if acc > 0 and acc + size > threshold:
            gid += 1
            acc = size
        else:
            acc += size
        group[i] = gid
    return group


def _grid_groups(centers: torch.Tensor, config: MiniTreeConfig):
    """Group id of every primitive (dense, in Morton order) and the bin
    count. The bounds of the centres are a plain min/max, which is
    exact in any order (the reference reduces them on its executor,
    161-167); the 4096-entry greedy merge runs on the host."""
    n, dim = centers.shape
    grid_dim = 1 << config.log2_grid_dim
    bin_count = 1 << (config.log2_grid_dim * dim)
    cmin = centers.amin(0)
    cmax = centers.amax(0)
    # grid_scale = grid_dim * safe_inverse(diagonal) (172)
    scale = grid_dim * utils.safe_inverse(cmax - cmin)
    offset = -cmin * scale
    p = utils.fast_mul_add(centers, scale, offset)
    p = torch.where(p > 0, p, 0.0)  # robust_max(.., 0) (180)
    coord = torch.clamp(p, max=float(grid_dim - 1)).to(torch.int64)
    bins = utils.morton_encode(coord, dim) & (bin_count - 1)
    if config.enable_pruning:
        sizes = torch.bincount(bins, minlength=bin_count).cpu().numpy()
        group_of_bin = torch.from_numpy(
            merge_small_bins(sizes, config.parallel_threshold)).to(
            centers.device)
    else:
        # without pruning every bin is its own group (192-193)
        group_of_bin = torch.arange(bin_count, device=centers.device)
    return group_of_bin[bins], bin_count
