"""The column layout of the treelet tables that kernel B1 reads
(`WideTreelets.table_cols`, [T, P, 64], the one stored copy), and the
row layout of the super tables that kernel B4 reads
(`WideTreelets.sup_cols`, [S, Ps, 16]), on the fixture of
tests/test_torch_wide_treelet.py (sponza_class(3000, 3), MEDIUM tree,
32x32 primary rays, max_prims=256):

- `table` is a view of it, and it is the [T, 64, P] table transposed,
  bit for bit, in one-level and two-level scenes, and
  `wide_treelets_from_numpy` of bvh_tpu's scene makes the same tables;
  likewise `sup_table` of `sup_cols`, whose padding is zero;
- `check_pair_inputs` takes the column layout and refuses the row
  layout, a strided view and a misaligned start; `check_super_inputs`
  takes the super rows and refuses the [S, 16, Ps] layout, a strided
  view and a misaligned start;
- the traversal's plain version on the column copy equals it on the
  row tables, and so does the ablation tool's chain table.
"""

import numpy as np
import pytest
import torch

from bvh_tpu_torch.tools import ablate_kernel as ak
from bvh_tpu_torch.traverse import collect as tcol
from bvh_tpu_torch.traverse import wide_treelet as twt
from test_torch_wide_kernels import pairs  # noqa: F401 - shared fixture
from test_torch_wide_treelet import scene  # noqa: F401 - shared fixture


@pytest.fixture(scope="module")
def scenes(scene):
    """The fixture's one-level scene and a two-level cut of its tree."""
    two = twt.build_wide_treelets(scene["tbvh"], torch.from_numpy(
        np.array(scene["jflat"])), max_prims=128, super_prims=512)
    assert two.sup_table.shape[0] > 0
    return {"one_level": scene["ttl"], "two_level": two}


@pytest.mark.parametrize("cut", ["one_level", "two_level"])
def test_table_cols_is_the_transpose(scenes, cut):
    """One stored copy: `table` is a view of `table_cols`, and the column
    tables are the row tables transposed, bit for bit."""
    tl = scenes[cut]
    T, rows, P = tl.table.shape
    assert rows == twt.ROWS and tl.table_cols.shape == (T, P, rows)
    assert tl.table_cols.is_contiguous()
    assert tl.table.data_ptr() == tl.table_cols.data_ptr()
    want = tl.table.transpose(1, 2).contiguous().numpy()
    assert tl.table_cols.numpy().tobytes() == want.tobytes()


def test_from_numpy_makes_the_same_copy(scene):
    tl = twt.wide_treelets_from_numpy(scene["jtl"], "cpu")
    want = np.ascontiguousarray(np.asarray(scene["jtl"].table).transpose(
        0, 2, 1))
    assert tl.table_cols.numpy().tobytes() == want.tobytes()
    assert torch.equal(tl.table_cols, scene["ttl"].table_cols)


@pytest.mark.parametrize("source", ["build", "from_numpy"])
def test_sup_cols_is_the_transpose(scene, scenes, source):
    """One stored copy of the super tables: `sup_table` is a view of
    `sup_cols`, whose rows are the [S, 16, Ps] tables' columns padded
    with zeros to 64 bytes, bit for bit."""
    tl = scenes["two_level"]
    if source == "from_numpy":
        tl = twt.wide_treelets_from_numpy(tl, "cpu")
    S, Ps, rows = tl.sup_cols.shape
    assert S > 0 and rows == 16 and Ps % 128 == 0
    assert tl.sup_cols.is_contiguous() and tl.sup_table.shape == (S, 16, Ps)
    assert tl.sup_table.data_ptr() == tl.sup_cols.data_ptr()
    assert (tl.sup_table.untyped_storage().data_ptr()
            == tl.sup_cols.untyped_storage().data_ptr())
    want = tl.sup_table.transpose(1, 2).contiguous().numpy()
    assert tl.sup_cols.numpy().tobytes() == want.tobytes()
    assert not tl.sup_cols[:, :, 14:].any()
    assert torch.equal(tl.sup_cols, scenes["two_level"].sup_cols)


def test_check_super_inputs_takes_only_the_row_layout(scenes):
    tl = scenes["two_level"]
    sid = torch.zeros(4, dtype=torch.int32)
    rays = torch.zeros((8, 4))
    tcol.check_super_inputs(tl.sup_cols, sid, rays, 8)
    misaligned = torch.zeros(tl.sup_cols.numel() + 1)[1:].view(
        tl.sup_cols.shape)
    for bad in (tl.sup_table, tl.sup_table.contiguous(),
                tl.sup_cols[:, ::2], misaligned):
        with pytest.raises(ValueError, match="row layout"):
            tcol.check_super_inputs(bad, sid, rays, 8)
    with pytest.raises(ValueError, match="stack depth"):
        tcol.check_super_inputs(tl.sup_cols, sid, rays, 65)


def test_check_pair_inputs_takes_only_the_column_layout(scene, pairs):
    tid, rays = pairs
    tl = scene["ttl"]
    twt.check_pair_inputs("t", tl.table_cols, tid, rays, 8)
    misaligned = torch.zeros(tl.table_cols.numel() + 1)[1:].view(
        tl.table_cols.shape)
    for bad in (tl.table, tl.table.contiguous(), tl.table_cols[:, ::2],
                misaligned):
        with pytest.raises(ValueError, match="column layout"):
            twt.check_pair_inputs("t", bad, tid, rays, 8)


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_traversal_on_columns_equals_rows(scene, pairs, any_hit):
    tid, rays = pairs
    tl = scene["ttl"]
    kw = dict(any_hit=any_hit, robust=False,
              stack_depth=7 * tl.wide_depth + 8)
    got = twt.traverse_pairs(tl.table_cols, tid, rays, **kw)
    want = twt.traverse_pairs_ref(tl.table, tid, rays, **kw)
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == w.numpy().tobytes()
    assert torch.isfinite(got[0][0]).sum() > 50


def test_chain_cols_is_the_chain_table_transposed():
    want = ak.make_chain_table(20, 128).transpose(0, 2, 1)
    got = ak.chain_cols(20, 128, "cpu")
    assert got.shape == (1, 128, 64)
    assert got.numpy().tobytes() == np.ascontiguousarray(want).tobytes()
