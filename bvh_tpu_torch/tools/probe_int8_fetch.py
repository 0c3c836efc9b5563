"""Column-fetch probe (T6), the counterpart of tools/probe_int8_fetch.py.

The JAX tool asked whether the TPU fetches a table column faster as a
bf16 or an int8 one-hot matrix product, at San-Miguel table widths
(`kern_bf`, `kern_i8`, :35-59). Kernel `column_fetch` (csrc/probes.cu)
computes the same function with plain loads:

    out[r, b] = sum over i < iters of table[r, (idx[b] + i) mod P]

in order of i, a bf16 table summed in float32 and an int8 table in
int32. Beside it the tool times what this card's library offers for
the same fetch, as yardsticks the port never calls: `index_select` of
one column set, the TPU's own method (the one-hot product, `matmul` in
bf16 and `_int_mm` in int8), and one product with the 0/1 window
matrix, which sums all `iters` fetches in one call.

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


def column_fetch(table, idx, iters: int):
    """Kernel `column_fetch` for CUDA tensors, the plain version for CPU
    tensors. table [rows, P] bf16 or int8; idx [B] int32 in [0, P).
    Returns [rows, B], float32 for bf16 and int32 for int8."""
    if table.device.type == "cpu":
        return column_fetch_ref(table, idx, iters)
    if table.device.type != "cuda":
        raise ValueError(f"column_fetch: unsupported device {table.device}")
    if (table.dtype not in (torch.bfloat16, torch.int8) or table.dim() != 2
            or not table.is_contiguous()):
        raise ValueError("column_fetch: table must be a contiguous "
                         "[rows, P] bfloat16 or int8 tensor")
    if (idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous()
            or idx.device != table.device):
        raise ValueError("column_fetch: idx must be a contiguous [B] int32 "
                         f"tensor on {table.device}")
    rows, p = table.shape
    if idx.numel() and not (0 <= int(idx.min()) and int(idx.max()) < p):
        raise ValueError(f"column_fetch: idx must lie in [0, {p})")
    out = torch.empty((rows, idx.numel()), dtype=_acc_dtype(table),
                      device=table.device)
    kernels.COLUMN_FETCH.launch(
        table.data_ptr(), int(table.dtype == torch.int8), rows, p,
        idx.data_ptr(), idx.numel(), iters, out.data_ptr())
    return out


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


def probe(table, idx, iters: int, device, n: int = 5) -> dict:
    """Kernel (or plain version) against its plain version, then the
    kernel's and the library's times. Raises if the kernel disagrees.
    Returns ms per call of each, and the kernel's output."""
    name = "int8" if table.dtype == torch.int8 else "bf16"
    out = column_fetch(table, idx, iters)
    ref = column_fetch_ref(table, idx, iters)
    if not bool(torch.equal(out, ref)):
        raise AssertionError(f"column_fetch ({name}) differs from its "
                             "plain version")
    res = dict(out=out, equal=True)
    res["ms"] = timed(f"column_fetch {name}", lambda: column_fetch(
        table, idx, iters), out, device, n)
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
        ms, last = time_calls(fn, device, n)
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


def run(device="cuda", iters: int = ITERS, n: int = 5) -> dict:
    """Both tables at the tool's shapes. Returns {"bf16": ..., "int8":
    ...} as `probe` returns them."""
    tab_bf, tab_i8, idx = make_inputs(device=device)
    out = {}
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
            + f"; plain version {r['plain_ms']:.3f} ms a call")
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
