"""bvh_tpu_torch — the PyTorch and CUDA port of `bvh_tpu`.

The package mirrors `bvh_tpu`'s layout (core, geom, io, api, cli,
build, traverse, par, and the examples), so each module's counterpart
is found under the same name; `par` scales traversal and the mini-tree
build over the ranks of a torch.distributed process group. Plain tensor code is PyTorch; the hot kernels (the per-group
binned-SAH build; the wide-treelet render's phase-A portal collect, its
phase-A2 super expansion and 8-wide treelet traversal; the single-launch
binary traversal) are hand-written CUDA under `csrc/`, built at first
use by `kernels.py`. The entry points (`cli.benchmark`, `api.flat`) run
on the card unless the caller names another device.
Every kernel has a plain PyTorch version beside it, which runs for
tensors on the CPU.

The package imports torch and numpy only; it never imports jax or
`bvh_tpu`.
"""

__version__ = "0.1.0"

from bvh_tpu_torch.core.ray import Ray  # noqa: F401
from bvh_tpu_torch.core.types import Bvh, Index  # noqa: F401
