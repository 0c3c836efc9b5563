"""The profiling probes' plain versions against the JAX tools' Pallas
kernels, in interpret mode on the CPU:

- T5, `wide_step_probe_ref` against `make_kernel` of tools/probe_tpu.py
  (loaded by file path), launched as its `run_probe` launches it, at
  B = C = 128 and 16 iterations, on the tool's own inputs and on inputs
  where about 59% of the slab tests hit;
- T6, `column_fetch_ref` against the tool's `kern_bf` and `kern_i8`
  (closures inside its `main()`, restated here), at ROWS = 12, P = 64,
  B = 32, 8 iterations, through the wrapper on the kernel's column copy;
  the copy's layout and the wrapper's checks of it;
- the tool's byte-transport check.

Why T5 needs the `xla_rounding` fixture: XLA's CPU backend contracts
lo * inv_dir + inv_org into one FMA inside the interpret-mode kernel
(ROADMAP C5), where the port and the CUDA kernel round the product and
the sum apart. With XLA's rounding given to `fast_mul_add` the plain
version is bit-equal; without it the slab distances move by a few ulps,
which can flip a hit on a box edge, and the accumulators agree within
the tolerance stated in the test.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bvh_tpu_torch.tools import probe_int8_fetch as tf
from bvh_tpu_torch.tools import probe_tpu as tp
from test_torch_build import xla_rounding  # noqa: F401 - fixture

TOOLS = pathlib.Path(__file__).parents[1] / "tools"


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def probe_tool():
    return _tool("probe_tpu")


def _pallas_probe(tool, table, rays, sort8, chains, iters):
    """tools/probe_tpu.py's kernel as `run_probe` launches it (:145-158),
    in interpret mode."""
    C, B = table.shape[1], rays.shape[1]
    kernel = tool.make_kernel(B, C, tp.ROWS, sort8, chains, tp.STACK_DEPTH,
                              iters)
    f = pl.pallas_call(
        kernel,
        grid_spec=pl.GridSpec(
            grid=(1,),
            in_specs=[pl.BlockSpec((tp.ROWS, C), lambda i: (0, 0)),
                      pl.BlockSpec((8, B), lambda i: (0, 0))],
            out_specs=pl.BlockSpec((8, B), lambda i: (0, 0))),
        out_shape=jax.ShapeDtypeStruct((8, B), jnp.float32),
        interpret=True)
    return np.asarray(f(jnp.asarray(table.numpy()), jnp.asarray(rays.numpy())))


def _inputs(kind):
    if kind == "tool":
        return tp.tool_inputs(128, 128, np.random.default_rng(0))
    return tp.hitting_inputs(128, 128)


PROBE_CASES = [(False, 1), (True, 1), (False, 2), (True, 4)]


@pytest.mark.parametrize("kind", ["tool", "hitting"])
@pytest.mark.parametrize("sort8, chains", PROBE_CASES)
def test_wide_step_probe_matches_pallas(probe_tool, kind, sort8, chains,
                                        xla_rounding):
    table, rays = _inputs(kind)
    want = _pallas_probe(probe_tool, table, rays, sort8, chains, 16)
    share = []
    got = tp.wide_step_probe_ref(table, rays, sort8=sort8, chains=chains,
                                 stack_depth=tp.STACK_DEPTH, iters=16,
                                 hit_share=share)
    assert got.numpy().tobytes() == want.tobytes()
    assert not got[chains:].any()
    if kind == "hitting":
        # the share found is 0.59 (with and without sort8)
        assert 0.2 <= share[0] <= 0.8
        all_miss = torch.tensor(16 * tp.MISS, dtype=torch.float32)
        assert (got[0] != all_miss).float().mean() > 0.9
    else:
        assert share[0] < 0.02


@pytest.mark.parametrize("sort8, chains", PROBE_CASES)
def test_wide_step_probe_without_xla_rounding(probe_tool, sort8, chains):
    """Without XLA's FMA rounding: the slab distances differ by ulps, so
    a lane's sum of 16 keys differs by a few ulps of its keys (relative
    1.7e-6 found, with sort8 on the hitting inputs; bit-equal
    elsewhere), unless a hit flips on a box edge, which changes the
    lane's path: at most 2 of 128 lanes may do that (none found)."""
    table, rays = _inputs("hitting")
    want = _pallas_probe(probe_tool, table, rays, sort8, chains, 16)
    got = tp.wide_step_probe_ref(table, rays, sort8=sort8, chains=chains,
                                 stack_depth=tp.STACK_DEPTH,
                                 iters=16).numpy()
    close = np.isclose(got, want, rtol=1e-5, atol=1e-5)
    assert (~close).any(0).sum() <= 2


def test_wide_step_probe_floor_modulo_and_truncation():
    """The step's next column: astype(int32) truncates toward zero and
    jnp's `%` is a floor modulo. Column 0 pushes word 5 and has
    words[1] = -7.7, so step 1 reads column (5 + (-7) + 0) mod 128 = 126,
    which holds a box the ray enters at t = 0.5 (flooring -7.7 would
    read column 125, which holds none)."""
    C = 128
    table = torch.zeros((tp.ROWS, C))
    table[0:48:2] = 1.0       # empty boxes (lo > hi) everywhere
    table[1:48:2] = -1.0
    table[0:6:2, 0], table[1:6:2, 0] = 0.25, 2.0    # slot 0 of column 0
    table[0:6:2, 126], table[1:6:2, 126] = 0.5, 2.0
    table[48, 0] = 5.0
    table[49, 0] = -7.7
    rays = torch.zeros((8, 4))
    rays[3:6] = 1.0
    out = tp.wide_step_probe_ref(table, rays, sort8=False, chains=1,
                                 stack_depth=4, iters=2)
    assert torch.equal(out[0], torch.full((4,), 0.75))


def _kern_bf(idx_ref, tab_ref, o_ref, *, P, B, rows, iters):
    """tools/probe_int8_fetch.py's `kern_bf` (:35-46)."""
    def body(i, acc):
        ix = idx_ref[...] + i
        iota = jax.lax.broadcasted_iota(jnp.int32, (P, B), 0)
        oh = (iota == ix % P).astype(jnp.bfloat16)
        d = jax.lax.dot_general(tab_ref[...], oh, (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32)
        return acc + d
    o_ref[...] = jax.lax.fori_loop(0, iters, body,
                                   jnp.zeros((rows, B), jnp.float32))


def _kern_i8(idx_ref, tab_ref, o_ref, *, P, B, rows, iters):
    """tools/probe_int8_fetch.py's `kern_i8` (:48-59)."""
    def body(i, acc):
        ix = idx_ref[...] + i
        iota = jax.lax.broadcasted_iota(jnp.int32, (P, B), 0)
        oh = (iota == ix % P).astype(jnp.int8)
        d = jax.lax.dot_general(tab_ref[...], oh, (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.int32)
        return acc + d
    o_ref[...] = jax.lax.fori_loop(0, iters, body,
                                   jnp.zeros((rows, B), jnp.int32))


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_column_fetch_matches_pallas(dtype):
    rows, P, B, iters = 12, 64, 32, 8
    tab_bf, tab_i8, idx = tf.make_inputs(rows, rows, P, B, device="cpu")
    table = tab_bf if dtype == "bf16" else tab_i8
    got = tf.column_fetch(tf.column_copy(table), idx, iters, rows)
    if dtype == "bf16":
        jtab = jnp.asarray(table.view(torch.int16).numpy()).view(jnp.bfloat16)
        kern, odt = _kern_bf, jnp.float32
    else:
        jtab = jnp.asarray(table.numpy())
        kern, odt = _kern_i8, jnp.int32
    f = pl.pallas_call(
        lambda i, t, o: kern(i, t, o, P=P, B=B, rows=rows, iters=iters),
        out_shape=jax.ShapeDtypeStruct((rows, B), odt), interpret=True)
    want = np.asarray(f(jnp.asarray(idx.numpy()[None, :]), jtab))
    assert got.numpy().tobytes() == want.tobytes()
    # the sum is the fetches' sum: idx + i wraps past P on some lanes
    assert ((idx + iters) > P).any()


@pytest.mark.parametrize("dtype, rows, run", [("bf16", 156, 4),
                                               ("int8", 216, 8),
                                               ("bf16", 13, 4),
                                               ("int8", 21, 8)])
def test_column_copy_is_the_padded_transpose(dtype, rows, run):
    """The kernel's [P, rows_pad] copy: column c of the table is row c,
    rows_pad the rows rounded up to the kernel's 8-byte run, the padding
    zero;
    the wrapper's plain path on it is the plain version on the table."""
    tab_bf, tab_i8, idx = tf.make_inputs(rows, rows, 40, 24, device="cpu")
    table = tab_bf if dtype == "bf16" else tab_i8
    cols = tf.column_copy(table)
    width = -(-rows // run) * run
    assert tf.run_length(table.dtype) == run
    assert cols.shape == (40, width) and cols.dtype == table.dtype
    assert cols.is_contiguous()
    want = torch.zeros((40, width), dtype=table.dtype)
    want[:, :rows] = table.t()
    assert torch.equal(cols.view(torch.int8 if dtype == "int8"
                                 else torch.int16),
                       want.view(torch.int8 if dtype == "int8"
                                 else torch.int16))
    # idx past P and below 0 are taken mod P, as (idx + i) % P is
    idx = idx.clone()
    idx[:3] = torch.tensor([39, 40 + 7, -5], dtype=torch.int32)
    assert torch.equal(tf.column_fetch(cols, idx, 50, rows),
                       tf.column_fetch_ref(table, idx, 50))


def test_column_fetch_rejects_a_wrong_copy():
    tab_bf, tab_i8, idx = tf.make_inputs(21, 21, 32, 8, device="cpu")
    cols = tf.column_copy(tab_bf)      # [32, 24]
    for bad, rows in ((tab_bf.t(), 21),                 # not contiguous
                      (tab_bf.t().contiguous(), 21),    # not padded
                      (cols, 20),                       # padded past a run
                      (cols, 25),                       # too narrow
                      (cols.float(), 21),               # wrong type
                      (cols[:, None], 21)):             # wrong rank
        with pytest.raises(ValueError, match="column_copy"):
            tf.column_fetch(bad, idx, 4, rows)
    cols8 = tf.column_copy(tab_i8)     # [32, 24]
    with pytest.raises(ValueError, match="column_copy"):
        tf.column_fetch(cols8, idx, 4, 16)
    assert torch.equal(tf.column_fetch(cols8, idx, 4, 21),
                       tf.column_fetch_ref(tab_i8, idx, 4))


def test_column_fetch_window_product_is_the_sum():
    """The library yardstick's 0/1 window matrix sums exactly the
    fetches: in int8 (as int64 here) the product equals the kernel's
    plain version."""
    _, tab_i8, idx = tf.make_inputs(24, 24, 64, 40, device="cpu")
    w = tf.window_matrix(idx, 64, 8, torch.int64)
    assert torch.equal(tab_i8.to(torch.int64) @ w,
                       tf.column_fetch_ref(tab_i8, idx, 8).to(torch.int64))


def test_byte_transport_matches_tool(capsys):
    assert tf.byte_transport_exact()
    assert tf.byte_transport_exact(3.0e-39)   # a subnormal
    assert tf.byte_transport_exact(-0.0)
