"""bvh_tpu_torch — the PyTorch and CUDA port of `bvh_tpu`.

The package mirrors `bvh_tpu`'s layout (core, geom, io, api, cli,
traverse), so each module's counterpart is found under the same name.
Plain tensor code is PyTorch; the two hot kernels of the wide-treelet
render (phase-A portal collect and the 8-wide treelet traversal) are
hand-written CUDA under `csrc/`, built at first use by `kernels.py`.
Every kernel has a plain PyTorch version beside it, which runs for
tensors on the CPU.

The package imports torch and numpy only; it never imports jax or
`bvh_tpu`.
"""

__version__ = "0.1.0"

from bvh_tpu_torch.core.ray import Ray  # noqa: F401
from bvh_tpu_torch.core.types import Bvh, Index  # noqa: F401
