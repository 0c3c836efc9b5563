"""Kernel T5's sorting network as shuffle layers, and the reference's
stack (ROADMAP C18), on the CPU.

- The layered network: the 19 comparators as 6 layers of disjoint
  pairs, from the partner words that `kernels.py` compiles into kernel
  T5 (`csrc/probes.cu` runs the layers in every lane's registers on the
  ray's 8 gathered keys). Modelled as 8 lanes, each taking its
  partner's key and word a layer, both lanes of a pair deciding from
  k[a] > k[b], it must equal the port's and `bvh_tpu`'s `_sort8` (and
  the JAX tool's) bit for bit, keys and words, on tie-heavy keys: ties
  are the common case (every miss is keyed 1e30), and the order the
  network leaves among equal keys moves words[0] and words[1], and with
  them every later step of the probe.
- C18: in tools/probe_tpu.py sp never leaves 0, so every step pushes
  words[0] into slot 0 and pops it back. So any stack of 2 or more
  slots gives the same output, and a stack of 1 differs only where the
  pop's max(., 0) (taken over more than one row) would have cut a
  negative word. Checked on the tool's Pallas kernel in interpret mode,
  with the plain version beside it.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bvh_tpu.traverse import wide_treelet as jwt
from bvh_tpu_torch import kernels
from bvh_tpu_torch.tools import probe_tpu as tp
from bvh_tpu_torch.traverse import wide_treelet as twt
from test_torch_build import xla_rounding  # noqa: F401 - fixture

ROOT = pathlib.Path(__file__).parents[1]
MISS = np.float32(1e30)


@pytest.fixture(scope="module")
def probe_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_tool_probe_tpu_layers", ROOT / "tools" / "probe_tpu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pallas_probe(tool, table, rays, stack_depth, iters=16):
    """The tool's kernel (sort8, one chain) as `run_probe` launches it
    (tools/probe_tpu.py:145-158), in interpret mode."""
    C, B = table.shape[1], rays.shape[1]
    f = pl.pallas_call(
        tool.make_kernel(B, C, tp.ROWS, True, 1, stack_depth, iters),
        grid_spec=pl.GridSpec(
            grid=(1,),
            in_specs=[pl.BlockSpec((tp.ROWS, C), lambda i: (0, 0)),
                      pl.BlockSpec((8, B), lambda i: (0, 0))],
            out_specs=pl.BlockSpec((8, B), lambda i: (0, 0))),
        out_shape=jax.ShapeDtypeStruct((8, B), jnp.float32),
        interpret=True)
    return np.asarray(f(jnp.asarray(table.numpy()), jnp.asarray(rays.numpy())))


def layered_sort8(keys, words):
    """The kernel's network: keys, words [8, B]. In each layer lane c
    takes the key and word of its partner (nibble c of the layer's
    word; itself outside the layer's pairs); the pair (a, b), a < b,
    swaps where k[a] > k[b], which both lanes compute, the lower lane
    taking the smaller key."""
    k, w = keys.copy(), words.copy()
    lane = np.arange(8)
    for word in kernels.sort8_partner_words():
        partner = (word >> (4 * lane)) & 0xF
        pk, pw = k[partner], w[partner]
        lower = (lane < partner)[:, None]
        swap = np.where(lower, k > pk, pk > k)
        k, w = np.where(swap, pk, k), np.where(swap, pw, w)
    return k, w


def tie_keys(B: int, seed: int = 0):
    """[8, B] keys where equal keys are the rule: all the miss key; the
    miss key with a few equal entry t (0.0 and -0.0 among them);
    shuffled duplicates of three values; and distinct values. Words
    are a permutation of 0..7 a column (plus 8 x the column), so the
    order among equal keys shows in them."""
    rng = np.random.default_rng(seed)
    keys = np.full((8, B), MISS, np.float32)
    kind = np.arange(B) % 4
    for b in range(B):
        if kind[b] == 1:
            n = rng.integers(1, 5)
            t = rng.choice(np.float32([0.0, -0.0, 0.5, 1.25]))
            keys[rng.choice(8, n, replace=False), b] = t
        elif kind[b] == 2:
            vals = rng.uniform(0, 4, 3).astype(np.float32)
            keys[:, b] = rng.permutation(np.r_[vals[[0, 0, 0, 1, 1]],
                                               [MISS, MISS], vals[2]])
        elif kind[b] == 3:
            keys[:, b] = rng.uniform(0, 4, 8).astype(np.float32)
    words = np.stack([rng.permutation(8) for _ in range(B)], 1)
    return keys, (words + 8 * np.arange(B)).astype(np.int32)


def test_layers_are_the_reference_comparators():
    """The layers, flattened, are the 19 comparators in the port's
    order (the reference's); each layer's pairs are disjoint, so a
    layer equals its comparators one after another; and the kernel is
    built with these layers' partner words."""
    flat = [p for layer in kernels.SORT8_LAYERS for p in layer]
    assert flat == [tuple(p) for p in twt._SORT8_PAIRS]
    assert len(kernels.SORT8_LAYERS) == 6 and len(flat) == 19
    for layer in kernels.SORT8_LAYERS:
        lanes = [c for pair in layer for c in pair]
        assert len(set(lanes)) == len(lanes)
    for i, w in enumerate(kernels.sort8_partner_words()):
        assert f"-DBVH_SORT8_LAYER{i}={w:#010x}u" in kernels.NVCC_FLAGS
    src = (ROOT / "bvh_tpu_torch" / "csrc" / "probes.cu").read_text()
    for i in range(6):
        assert f"BVH_SORT8_LAYER{i}" in src


@pytest.mark.parametrize("seed", [0, 1])
def test_layered_network_equals_sort8(probe_tool, seed):
    keys, words = tie_keys(512, seed)
    k_lay, w_lay = layered_sort8(keys, words)
    # the port's network
    kt, wt = twt._sort8(list(torch.from_numpy(keys)),
                        list(torch.from_numpy(words)))
    assert np.stack([x.numpy() for x in kt]).tobytes() == k_lay.tobytes()
    assert np.array_equal(np.stack([x.numpy() for x in wt]), w_lay)
    # bvh_tpu's, and the JAX tool's
    kj, wj = jwt._sort8(jnp.asarray(keys), jnp.asarray(words))
    assert np.concatenate([np.asarray(x) for x in kj]).tobytes() == \
        k_lay.tobytes()
    assert np.array_equal(np.concatenate([np.asarray(x) for x in wj]), w_lay)
    ko, wo = probe_tool._sort8(jnp.asarray(keys), jnp.asarray(words))
    assert np.asarray(ko).tobytes() == k_lay.tobytes()
    assert np.array_equal(np.asarray(wo), w_lay)
    # the ties are real: a stable sort would order some words otherwise
    order = np.argsort(keys, axis=0, kind="stable")
    stable_w = np.take_along_axis(words, order, 0)
    assert (stable_w[:2] != w_lay[:2]).any()


def test_reference_stack_never_leaves_slot_zero(probe_tool, xla_rounding):
    """C18 on hitting inputs (B = C = 128, sort8, 16 iterations)."""
    table, rays = tp.hitting_inputs(128, 128)
    out = {}
    for depth in (1, 2, 24):
        want = pallas_probe(probe_tool, table, rays, depth)
        got = tp.wide_step_probe_ref(table, rays, sort8=True, chains=1,
                                     stack_depth=depth, iters=16).numpy()
        assert got.tobytes() == want.tobytes()
        out[depth] = want
    assert out[2].tobytes() == out[24].tobytes()
    differ = int((out[1][0] != out[24][0]).sum())
    assert differ == 116
