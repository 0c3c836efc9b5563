"""The core helpers of `bvh_tpu_torch.core` against bvh_tpu's, and the
`api` package's exports: `uint_type_for`, `scatter_max` (JAX's
`.at[i].max(v, mode="drop")`: negative indices wrap once, indices still
out of range drop, duplicates combine by max), `round_up_log2`,
`make_bitmask` and `index_dtype_for`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.core import types as jtypes
from bvh_tpu.core import utils as jutils
from bvh_tpu_torch.core import types, utils

FLOATS = {"float32": torch.float32, "float64": torch.float64,
          "float16": torch.float16, "bfloat16": torch.bfloat16}


def _name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@pytest.mark.parametrize("name", sorted(FLOATS))
def test_uint_type_for(name):
    got = utils.uint_type_for(FLOATS[name])
    assert _name(got) == jutils.uint_type_for(jnp.dtype(name)).name
    assert got.itemsize == FLOATS[name].itemsize


@pytest.mark.parametrize("name", ["float32", "float64"])
def test_index_dtype_for(name):
    got = types.index_dtype_for(FLOATS[name])
    assert _name(got) == jtypes.index_dtype_for(jnp.dtype(name)).name


def test_index_dtype_for_refuses_half():
    """Only float32 and float64 scalars have an index word, in both."""
    with pytest.raises(KeyError):
        jtypes.index_dtype_for(jnp.dtype("float16"))
    with pytest.raises(KeyError):
        types.index_dtype_for(torch.float16)


def test_int_helpers():
    for i in list(range(0, 70)) + [1023, 1024, 1025, 1 << 40]:
        assert utils.round_up_log2(i) == jutils.round_up_log2(i)
    for bits in (0, 1, 4, 31, 32, 63, 64):
        assert utils.make_bitmask(bits) == jutils.make_bitmask(bits)


def test_scatter_max_wraps_and_drops():
    got = utils.scatter_max(torch.zeros(4), [-1, 4, -5, 1, 1],
                            [5.0, 6.0, 7.0, 2.0, 3.0])
    want = jutils.scatter_max(jnp.zeros(4), jnp.asarray([-1, 4, -5, 1, 1]),
                              jnp.asarray([5.0, 6.0, 7.0, 2.0, 3.0]))
    assert got.tolist() == [0.0, 3.0, 0.0, 5.0] == np.asarray(want).tolist()


@pytest.mark.parametrize("dtype, shape", [
    ("float32", (37,)), ("int32", (37,)), ("float32", (11, 3))])
def test_scatter_max_random_duplicates(dtype, shape):
    rng = np.random.default_rng(len(shape) + len(dtype))
    n = shape[0]
    target = (rng.normal(size=shape) * 4).astype(dtype)
    idx = rng.integers(-2 * n, 2 * n, 200)
    vals = (rng.normal(size=(200, *shape[1:])) * 4).astype(dtype)
    got = utils.scatter_max(torch.from_numpy(target), torch.from_numpy(idx),
                            torch.from_numpy(vals))
    want = jutils.scatter_max(jnp.asarray(target), jnp.asarray(idx),
                              jnp.asarray(vals))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.from_numpy(target).dtype


def test_api_exports():
    from bvh_tpu_torch.api import FlatApi, bvh2d, bvh2f, bvh3d, bvh3f

    assert all(isinstance(a, FlatApi) for a in (bvh2f, bvh3f, bvh2d, bvh3d))
    assert (bvh3f.dim, bvh2d.dim) == (3, 2)
