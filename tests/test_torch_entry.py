"""The port's driver entry (`bvh_tpu_torch/entry.py`) on the CPU:
`entry()`'s render step over the binned build of the golden triangles
gives `__graft_entry__.entry()`'s t bits and prim ids (with XLA's FMA
rounding, `xla_rounding`, as the binned builder's tests use), and
`dryrun_multichip(2)` runs the sharded build and trace on two gloo
ranks of the CPU (one spawn), the build bit-identical to
`build_minitree`.
"""

import numpy as np
import torch

import __graft_entry__
from bvh_tpu_torch import entry as tentry
from test_torch_build import xla_rounding  # noqa: F401 - fixture


def test_entry_matches_graft_entry(xla_rounding):
    jfn, jargs = __graft_entry__.entry()
    jt, jpid = (np.asarray(x) for x in jfn(*jargs))
    fn, args = tentry.entry(device="cpu")
    t, pid = fn(*args)
    assert t.shape == (256,) and np.isfinite(jt).sum() > 100
    assert np.array_equal(t.numpy().view(np.int32), jt.view(np.int32))
    assert np.array_equal(pid.numpy(), jpid.astype(np.int64))
    assert args[0].bounds.device == torch.device("cpu")


def test_dryrun_multichip_two_ranks():
    res = tentry.dryrun_multichip(2, device="cpu")
    assert res["ranks"] == 2 and res["device"] == "cpu"
    assert res["prims"] == 36 and res["nodes"] > 1
    assert res["rays"] == 120 and res["hits"] > 50
