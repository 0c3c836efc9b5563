"""Bit-exact BVH (de)serialization in the C++ v2 format.

Counterpart of `bvh_tpu.io.serialize` (reference: bvh.h:220-242,
node.h:90-102, stream.h:10-32). Byte layout:

    [node_count : IndexType] [prim_count : IndexType]
    node_count times: [bounds : 2*dim scalars] [index : IndexType]
    prim_count times: [prim_id : IndexType]

Native-endian raw bytes. IndexType is uint32 for float32 trees and
uint64 for float64. The port carries index words as int64 and casts to
IndexType here, where the bytes are written.
"""

from __future__ import annotations

import io as _io

import numpy as np
import torch

from bvh_tpu_torch.core.types import Bvh, bvh_from_numpy

_INDEX_FOR_SCALAR = {
    np.dtype(np.float32): np.dtype(np.uint32),
    np.dtype(np.float64): np.dtype(np.uint64),
}


def _node_record(scalar: np.dtype, index_t: np.dtype, two_dim: int):
    return np.dtype([("bounds", scalar, (two_dim,)), ("index", index_t)],
                    align=False)


def serialize(bvh: Bvh, stream) -> None:
    """Write `bvh` to a binary stream (reference: bvh.h:220-229)."""
    nc, pc = int(bvh.node_count), int(bvh.prim_count)
    bounds = bvh.bounds[:nc].cpu().numpy()
    scalar = bounds.dtype
    index_t = _INDEX_FOR_SCALAR[scalar]
    stream.write(np.asarray([nc, pc], index_t).tobytes())
    packed = np.empty(nc, _node_record(scalar, index_t, bounds.shape[1]))
    packed["bounds"] = bounds
    packed["index"] = bvh.index[:nc].cpu().numpy().astype(index_t)
    stream.write(packed.tobytes())
    stream.write(bvh.prim_ids[:pc].cpu().numpy().astype(index_t).tobytes())


def _read_exact(stream, n: int, what: str) -> bytes:
    data = stream.read(n)
    if len(data) != n:
        raise EOFError(f"truncated BVH stream: expected {n} bytes for "
                       f"{what}, got {len(data)}")
    return data


def deserialize(stream, dim: int = 3, scalar_dtype=np.float32,
                device="cuda") -> Bvh:
    """Read a BVH from a binary stream onto `device`, the card unless
    the caller names another (reference: bvh.h:231-242)."""
    scalar = np.dtype(scalar_dtype)
    index_t = _INDEX_FOR_SCALAR[scalar]
    isz = index_t.itemsize
    header = np.frombuffer(_read_exact(stream, 2 * isz, "header"), index_t)
    nc, pc = int(header[0]), int(header[1])
    rec = _node_record(scalar, index_t, 2 * dim)
    packed = np.frombuffer(_read_exact(stream, rec.itemsize * nc, "nodes"),
                           rec)
    prim_ids = np.frombuffer(_read_exact(stream, isz * pc, "prim ids"),
                             index_t)
    return bvh_from_numpy(packed["bounds"], packed["index"], prim_ids,
                          nc, pc, device)


def save_bvh(bvh: Bvh, path: str) -> None:
    with open(path, "wb") as f:
        serialize(bvh, f)


def load_bvh(path: str, dim: int = 3, scalar_dtype=np.float32,
             device="cuda") -> Bvh:
    with open(path, "rb") as f:
        return deserialize(f, dim, scalar_dtype, device)


def serialize_to_bytes(bvh: Bvh) -> bytes:
    buf = _io.BytesIO()
    serialize(bvh, buf)
    return buf.getvalue()


def deserialize_from_bytes(data: bytes, dim: int = 3,
                           scalar_dtype=np.float32, device="cuda") -> Bvh:
    return deserialize(_io.BytesIO(data), dim, scalar_dtype, device)


def bvh_equal(a: Bvh, b: Bvh) -> bool:
    """Deep structural equality (reference: bvh.h:30-31)."""
    na, nb = int(a.node_count), int(b.node_count)
    pa, pb = int(a.prim_count), int(b.prim_count)
    if (na, pa) != (nb, pb):
        return False
    return (torch.equal(a.bounds[:na].cpu(), b.bounds[:nb].cpu())
            and torch.equal(a.index[:na].cpu(), b.index[:nb].cpu())
            and torch.equal(a.prim_ids[:pa].cpu(), b.prim_ids[:pb].cpu()))
