"""Column-fetch probe (T6), the counterpart of tools/probe_int8_fetch.py.

The JAX tool asked whether the TPU fetches a table column faster as a
bf16 or an int8 one-hot matrix product, at San-Miguel table widths
(`kern_bf`, `kern_i8`, :35-59). Kernel `column_fetch` (csrc/probes.cu)
computes the same function with plain loads:

    out[r, b] = sum over i < iters of table[r, (idx[b] + i) mod P]

in order of i, a bf16 table summed in float32 and an int8 table in
int32. It reads the table's columns as rows, a [P, rows] copy made once
by `column_copy` (rows padded to the kernel's 8-byte run), as the
window matrix below is made once for the library's product. Beside it
the tool times what this card's library offers for the same fetch, as
yardsticks the port never calls: `index_select` of one column set, the
TPU's own method (the one-hot product, `matmul` in bf16 and `_int_mm` in
int8), and one product with the 0/1 window matrix, which sums all
`iters` fetches in one call. Every time is the device's own (`queued`
in timing.py), the median of `REPS` calls.

    python -m bvh_tpu_torch.tools.probe_int8_fetch [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from bvh_tpu_torch import kernels
from bvh_tpu_torch.tools.timing import guard, log, time_calls, timed

ROWS_BF, ROWS_I8 = 156, 216
P, B = 1280, 512
ITERS = 200
REPS = 21  # calls whose median each time is
# a thread of the kernel loads one run of a column a fetch, 8 bytes
# (csrc/probes.cu): 4 bf16 or 8 int8
RUN_BYTES = 8


def make_inputs(rows_bf=ROWS_BF, rows_i8=ROWS_I8, p=P, b=B, seed=0,
                device="cuda"):
    """The tool's inputs (:29-33), made with numpy from `seed`: a
    standard-normal bf16 table (rounded from float32), an int8 table
    and one column index per lane, idx [b] int32 in [0, p)."""
    rng = np.random.default_rng(seed)
    tab_bf = torch.from_numpy(
        rng.standard_normal((rows_bf, p)).astype(np.float32)).to(
            torch.bfloat16)
    tab_i8 = torch.from_numpy(rng.integers(-128, 128, (rows_i8, p))
                              .astype(np.int8))
    idx = torch.from_numpy(rng.integers(0, p, b).astype(np.int32))
    return tab_bf.to(device), tab_i8.to(device), idx.to(device)


def _acc_dtype(table):
    return torch.int32 if table.dtype == torch.int8 else torch.float32


def column_fetch_ref(table, idx, iters: int):
    """Plain version of kernel `column_fetch`: `iters` column fetches,
    summed one after another (one rounding an add in float32)."""
    acc = _acc_dtype(table)
    cols = idx.to(torch.int64)
    out = torch.zeros((table.shape[0], idx.numel()), dtype=acc,
                      device=table.device)
    for i in range(iters):
        out += table[:, (cols + i) % table.shape[1]].to(acc)
    return out


def run_length(dtype) -> int:
    """Rows of a column in one run: 4 bf16 or 8 int8."""
    return RUN_BYTES // torch.empty(0, dtype=dtype).element_size()


def column_copy(table):
    """The kernel's layout of a [rows, P] table: its columns as rows,
    [P, rows_pad], with rows_pad = rows rounded up to the run and the
    padding zero."""
    rows, p = table.shape
    run = run_length(table.dtype)
    cols = torch.zeros((p, rows + -rows % run), dtype=table.dtype,
                       device=table.device)
    cols[:, :rows] = table.t()
    return cols


def check_copy(cols, rows: int) -> None:
    """Raise unless `cols` is `column_copy`'s layout of a table of
    `rows` rows: a contiguous [P, rows_pad] bf16 or int8 tensor, rows_pad
    = rows rounded up to the run."""
    ok = cols.dtype in (torch.bfloat16, torch.int8) and cols.dim() == 2
    if ok:
        run = run_length(cols.dtype)
        width = cols.shape[1]
        ok = (width % run == 0 and width - run < rows <= width
              and cols.is_contiguous())
    if not ok:
        raise ValueError(f"column_fetch: cols must be column_copy's "
                         f"contiguous [P, {rows} rounded up to the run] "
                         "bfloat16 or int8 tensor")


def column_fetch(cols, idx, iters: int, rows: int):
    """Kernel `column_fetch` for CUDA tensors, the plain version for CPU
    tensors. cols = `column_copy(table)` of a [rows, P] bf16 or int8
    table; idx [B] int32, taken mod P. Returns [rows, B] (a view of the
    kernel's lane-major output), float32 for bf16 and int32 for int8."""
    check_copy(cols, rows)
    if cols.device.type == "cpu":
        return column_fetch_ref(cols[:, :rows].t(), idx, iters)
    if cols.device.type != "cuda":
        raise ValueError(f"column_fetch: unsupported device {cols.device}")
    if cols.data_ptr() % RUN_BYTES:
        raise ValueError(f"column_fetch: cols must be {RUN_BYTES}-byte "
                         "aligned")
    if (idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous()
            or idx.device != cols.device):
        raise ValueError("column_fetch: idx must be a contiguous [B] int32 "
                         f"tensor on {cols.device}")
    p, width = cols.shape
    if iters < 0 or (p == 0 and iters and idx.numel()):
        raise ValueError(f"column_fetch: {iters} fetches from {p} columns")
    out = torch.empty((idx.numel(), width), dtype=_acc_dtype(cols),
                      device=cols.device)
    kernels.COLUMN_FETCH.launch(
        cols.data_ptr(), int(cols.dtype == torch.int8), width, p,
        idx.data_ptr(), idx.numel(), iters, out.data_ptr())
    return out[:, :rows].t()


def window_matrix(idx, p: int, iters: int, dtype):
    """W [p, B]: W[c, b] = 1 where column c is one of lane b's `iters`
    fetches, so table @ W is the whole sum in one product (iters <= p,
    each column at most once)."""
    c = torch.arange(p, device=idx.device)[:, None]
    return ((c - idx.to(torch.int64)[None, :]) % p < iters).to(dtype)


def _product(table, m):
    """The library's product in the table's type: bf16 `matmul`, int8
    `_int_mm` (int32 out)."""
    if table.dtype == torch.int8:
        return torch._int_mm(table, m)
    return torch.matmul(table, m)


def probe(table, idx, iters: int, device, n: int = REPS) -> dict:
    """Kernel (or plain version) against its plain version, then the
    kernel's and the library's times. Raises if the kernel disagrees.
    Returns ms per call of each (the device's time, the median of n
    calls; `ms_host` with the wrapper's host time, `copy_ms` the column
    copy's, one call), and the kernel's output."""
    name = "int8" if table.dtype == torch.int8 else "bf16"
    rows = table.shape[0]
    copy_ms, tcols = time_calls(lambda: column_copy(table), device, 1)
    out = column_fetch(tcols, idx, iters, rows)
    ref = column_fetch_ref(table, idx, iters)
    if not bool(torch.equal(out, ref)):
        raise AssertionError(f"column_fetch ({name}) differs from its "
                             "plain version")
    res = dict(out=out, equal=True, copy_ms=copy_ms)
    res["ms"] = timed(f"column_fetch {name}", lambda: column_fetch(
        tcols, idx, iters, rows), out, device, n, queued=True)
    res["ms_host"] = timed(f"column_fetch {name}", lambda: column_fetch(
        tcols, idx, iters, rows), out, device, n)
    res["plain_ms"] = timed(f"column_fetch_ref {name}", lambda:
                            column_fetch_ref(table, idx, iters), out,
                            device, 1)
    p = table.shape[1]
    cols = idx.to(torch.int64)
    one = table[:, cols]
    oh = window_matrix(idx, p, 1, table.dtype)
    win = window_matrix(idx, p, iters, table.dtype)
    lib = {"index_select": lambda: torch.index_select(table, 1, cols),
           "one_hot": lambda: _product(table, oh),
           "window": lambda: _product(table, win)}
    for key, fn in lib.items():
        first = fn()
        if key == "window":
            # one product sums every fetch: exact in int8; in bf16 the
            # float32 sum runs in another order and is rounded to bf16
            ok = (bool(torch.equal(first, out)) if table.dtype == torch.int8
                  else bool(torch.allclose(first.float(), out, rtol=2 ** -7,
                                           atol=1e-3)))
        else:
            ok = bool(torch.equal(first.to(one.dtype), one))
        if not ok:
            raise AssertionError(f"the library's {key} ({name}) is not the "
                                 "fetch")
        ms, last = time_calls(fn, device, n, queued=True)
        guard(f"{key} {name}", last, first)
        res[f"{key}_ms"] = ms
    return res


def byte_transport_exact(x: float = -123.456) -> bool:
    """The JAX tool's check (:84-89): one float32 split into its 4 bytes
    and put back together is the same float."""
    x = np.float32(x)
    b = np.frombuffer(x.tobytes(), np.uint8).astype(np.int32)
    rec = b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24
    y = np.frombuffer(np.int32(rec).tobytes(), np.float32)[0]
    return bool(x == y)


def launch_floor_ms(device, n: int = REPS):
    """The device's time for one empty kernel, timed as the fetches are
    (queued, the median of n), the floor under every time above; None
    off the card."""
    if torch.device(device).type != "cuda":
        return None
    return time_calls(lambda: torch.cuda._sleep(0), device, n, queued=True)[0]


def run(device="cuda", iters: int = ITERS, n: int = REPS) -> dict:
    """Both tables at the tool's shapes. Returns {"bf16": ..., "int8":
    ..., "floor_ms": ...}, the first two as `probe` returns them, the
    last `launch_floor_ms`."""
    tab_bf, tab_i8, idx = make_inputs(device=device)
    out = {"floor_ms": launch_floor_ms(device, n)}
    if out["floor_ms"] is not None:
        log(f"# T6 launch floor (one empty kernel, timed as the calls "
            f"below): {out['floor_ms'] * 1e3:.2f} us")
    for name, tab in (("bf16", tab_bf), ("int8", tab_i8)):
        r = probe(tab, idx, iters, device, n)
        out[name] = r
        per = {"kernel": r["ms"] * 1e3 / iters}
        for k in ("index_select", "one_hot", "window"):
            per[k] = r[f"{k}_ms"] * 1e3 / (iters if k == "window" else 1)
        log(f"# T6 column fetch {name} [{tab.shape[0]}, {tab.shape[1]}] x "
            f"{idx.numel()} lanes x {iters}: kernel equal to plain: "
            f"{r['equal']}; us per fetch: "
            + ", ".join(f"{k} {v:.4f}" for k, v in per.items())
            + f" (medians of {n}); kernel {r['ms'] * 1e3:.2f} us a call, "
            f"{r['ms_host'] * 1e3:.2f} with the wrapper's host time; column "
            f"copy {r['copy_ms'] * 1e3:.2f} us once; plain version "
            f"{r['plain_ms']:.3f} ms a call")
    log(f"# T6 byte transport exact: {byte_transport_exact()}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args()
    run(args.device, args.iters)


if __name__ == "__main__":
    main()
