"""Quality-based builder selection facade.

Counterpart of `bvh_tpu.build.default` (reference:
src/bvh/v2/default_builder.h). The pipeline selection is the
reference's:

- parallel path (prim count >= parallel_threshold): the mini-tree
  build, plus reinsertion for HIGH (33-46);
- serial path: binned for LOW, sweep for MEDIUM and HIGH, plus
  reinsertion for HIGH (49-62);
- the mini-tree config: pruning off for LOW, pruning area ratio 0.01
  for HIGH and 0.1 for MEDIUM (65-73).

The parallel path of float32 3D inputs is `build_minitree_fast` on
every device: kernel B3 on a CUDA device, its plain version on the CPU.
Every other dim and float type takes the level-synchronous
`build_minitree`, which builds the same tree as `build_minitree_fast`
where both apply (as in `bvh_tpu`, build/default.py:104-111).
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from bvh_tpu_torch.build.binned import build_binned
from bvh_tpu_torch.build.minitree import MiniTreeConfig, build_minitree
from bvh_tpu_torch.build.minitree_fast import build_minitree_fast
from bvh_tpu_torch.build.reinsertion import ReinsertionConfig, optimize_reinsertion
from bvh_tpu_torch.build.sah import TopDownConfig
from bvh_tpu_torch.build.sweep import build_sweep
from bvh_tpu_torch.core import trace
from bvh_tpu_torch.core.types import Bvh


class Quality(enum.Enum):
    """reference: default_builder.h:21."""

    LOW = "low"
    MEDIUM = "medium"
    HIGH = "high"


@dataclasses.dataclass(frozen=True)
class DefaultConfig(TopDownConfig):
    """Names and defaults of default_builder.h:23-30."""

    quality: Quality = Quality.HIGH
    parallel_threshold: int = 1024


def _mini_tree_config(config: DefaultConfig) -> MiniTreeConfig:
    """reference: make_mini_tree_config, default_builder.h:65-73."""
    return MiniTreeConfig(
        sah=config.sah,
        min_leaf_size=config.min_leaf_size,
        max_leaf_size=config.max_leaf_size,
        enable_pruning=config.quality != Quality.LOW,
        pruning_area_ratio=0.01 if config.quality == Quality.HIGH else 0.1,
        parallel_threshold=config.parallel_threshold,
    )


def _use_fast_minitree(bb_min, bb_max, centers) -> bool:
    """The per-group build (kernel B3 and its plain version) takes
    float32 3D tensors."""
    return (centers.dim() == 2 and centers.shape[1] == 3
            and all(x.dtype == torch.float32
                    for x in (bb_min, bb_max, centers)))


@trace.spanned("bvh.build_default")
def build_default(bb_min, bb_max, centers,
                  config: DefaultConfig | None = None,
                  parallel: bool = True) -> Bvh:
    """Build a BVH over [n, dim] primitive boxes and centres on their
    device, selecting the pipeline by quality. `parallel=True` mirrors
    the thread-pool overload (default_builder.h:33-46): inputs with at
    least `parallel_threshold` primitives take the mini-tree path.
    `parallel=False` forces the serial overload (49-62)."""
    if config is None:
        config = DefaultConfig()
    n = centers.shape[0]
    tdc = TopDownConfig(sah=config.sah, min_leaf_size=config.min_leaf_size,
                        max_leaf_size=config.max_leaf_size)

    if parallel and n >= config.parallel_threshold:
        build = (build_minitree_fast
                 if _use_fast_minitree(bb_min, bb_max, centers)
                 else build_minitree)
        bvh = build(bb_min, bb_max, centers, _mini_tree_config(config))
        if config.quality == Quality.HIGH:
            bvh = optimize_reinsertion(bvh, ReinsertionConfig())
        return bvh

    if config.quality == Quality.LOW:
        return build_binned(bb_min, bb_max, centers, tdc)
    bvh = build_sweep(bb_min, bb_max, centers, tdc)
    if config.quality == Quality.HIGH:
        bvh = optimize_reinsertion(bvh, ReinsertionConfig())
    return bvh
