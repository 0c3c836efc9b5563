"""The port's executors (bvh_tpu_torch/par/executor.py) against
tests/test_executor.py's cases and bvh_tpu's executors on the CPU.

Float sums over values spread across eight decades round differently in
a left fold and in the halving schedule; each port executor must give
its bvh_tpu counterpart's bits. The mesh cases are in
tests/test_torch_par.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.par.executor import ParallelExecutor as JParallel
from bvh_tpu.par.executor import SequentialExecutor as JSequential
from bvh_tpu_torch.build.minitree import build_minitree
from bvh_tpu_torch.par.executor import ParallelExecutor, SequentialExecutor


def bbox_reduce(ex, c):
    big = torch.finfo(c.dtype).max
    return ex.reduce(
        (c, c),
        lambda a, b: (torch.minimum(a[0], b[0]), torch.maximum(a[1], b[1])),
        (torch.full((3,), big), torch.full((3,), -big)))


def test_sequential_reduce_ordered():
    out = SequentialExecutor().reduce(torch.tensor([1.0, 2.0, 3.0, 4.0]),
                                      torch.add, torch.tensor(0.0))
    assert float(out) == 10.0


def test_sequential_for_each():
    out = SequentialExecutor().for_each(5, lambda carry, i: carry + i,
                                        torch.tensor(0))
    assert int(out) == 10


def test_parallel_for_each():
    out = ParallelExecutor(device="cpu").for_each(8, lambda i: i * i)
    assert out.tolist() == [i * i for i in range(8)]


@pytest.mark.parametrize("n", [1, 2, 7, 64, 129])
def test_parallel_reduce_odd_sizes(n):
    vals = torch.arange(n, dtype=torch.float32) + 1.0
    out = ParallelExecutor().reduce(vals, torch.add, torch.tensor(0.0))
    assert float(out) == n * (n + 1) / 2


def test_parallel_reduce_pytree_bbox():
    """The consumer pattern: build_minitree's scene-bounds reduce
    (mini_tree_builder.h:161-167)."""
    rng = np.random.default_rng(0)
    c = torch.from_numpy(rng.uniform(-5, 5, (201, 3)).astype(np.float32))
    mn, mx = bbox_reduce(ParallelExecutor(), c)
    assert torch.equal(mn, c.amin(0)) and torch.equal(mx, c.amax(0))
    smn, smx = bbox_reduce(SequentialExecutor(), c)
    assert torch.equal(smn, mn) and torch.equal(smx, mx)


@pytest.mark.parametrize("n", [3, 100, 1001])
def test_float_sums_give_bvh_tpu_bits(n):
    """Each executor equals bvh_tpu's bit for bit where the two
    schedules differ."""
    rng = np.random.default_rng(n)
    vals = (rng.standard_normal(n) * 10.0 ** rng.uniform(-4, 4, n)).astype(
        np.float32)
    zero_t, zero_j = torch.tensor(0.0), jnp.asarray(0.0, jnp.float32)
    seq = SequentialExecutor().reduce(torch.from_numpy(vals), torch.add,
                                      zero_t)
    par = ParallelExecutor().reduce(torch.from_numpy(vals), torch.add,
                                    zero_t)
    jseq = JSequential().reduce(jnp.asarray(vals), jnp.add, zero_j)
    jpar = JParallel().reduce(jnp.asarray(vals), jnp.add, zero_j)
    assert seq.numpy().tobytes() == np.asarray(jseq).tobytes()
    assert par.numpy().tobytes() == np.asarray(jpar).tobytes()
    if n > 3:
        assert seq.numpy().tobytes() != par.numpy().tobytes()


def test_minitree_consumes_executor():
    """build_minitree(executor=...) builds the same tree under either
    strategy and under the default (min/max joins are
    order-independent)."""
    rng = np.random.default_rng(4)
    cc = rng.uniform(0, 10, (300, 3)).astype(np.float32)
    h = rng.uniform(0.01, 0.5, (300, 3)).astype(np.float32)
    mn, mx, cc = (torch.from_numpy(x) for x in (cc - h, cc + h, cc))
    a = build_minitree(mn, mx, cc, executor=SequentialExecutor())
    b = build_minitree(mn, mx, cc, executor=ParallelExecutor())
    d = build_minitree(mn, mx, cc)
    for t in (b, d):
        nc = a.node_count
        assert t.node_count == nc
        assert torch.equal(a.bounds[:nc], t.bounds[:nc])
        assert torch.equal(a.index[:nc], t.index[:nc])
        assert torch.equal(a.prim_ids, t.prim_ids)
