"""ctypes bindings for the native C runtime (`native/bvh_c.cpp`).

Counterpart of `bvh_tpu.api.native`. The library implements the
reference's C API over the v2 byte format, so a tree it builds loads
into the port (io/serialize.py) and into `bvh_tpu` alike. It is built
at first use with

    g++ -std=c++20 -O2 -fPIC -shared -ffp-contract=off -pthread

into `bvh_tpu_torch/_build/`, keyed by a hash of its sources, so a
checkout needs nothing prebuilt.
"""

from __future__ import annotations

import ctypes
import os
import tempfile

import numpy as np

from bvh_tpu_torch.kernels import build_shared_library

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SOURCES = [os.path.join(_NATIVE_DIR, "bvh_c.cpp"),
            os.path.join(_NATIVE_DIR, "bvh_c.h")]


class BuildConfigC(ctypes.Structure):
    _fields_ = [
        ("quality", ctypes.c_int),
        ("min_leaf_size", ctypes.c_size_t),
        ("max_leaf_size", ctypes.c_size_t),
        ("parallel_threshold", ctypes.c_size_t),
    ]


# bool (*)(void* user_data, float* ray, size_t begin, size_t end): the
# leaf callback of the intersect calls; `ray` is the (org, dir, tmin,
# tmax) record, whose tmax the callback may shorten (c_api/bvh.h:64-77).
CALLBACK3F = ctypes.CFUNCTYPE(
    ctypes.c_bool, ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
    ctypes.c_size_t, ctypes.c_size_t,
)


class Callback3f(ctypes.Structure):
    _fields_ = [("user_data", ctypes.c_void_p), ("user_fn", CALLBACK3F)]


def library_path() -> str:
    """Path of the built library; compiles it on first use."""
    return build_shared_library(
        ["g++", "-std=c++20", "-O2", "-fPIC", "-shared",
         "-ffp-contract=off", "-pthread"],
        _SOURCES[:1], _SOURCES, "libbvh_c")


def load_library(path: str | None = None):
    """The native library (`library_path()`), or the library at `path`
    that links `native/bvh_c.cpp` in, with the bvh3f_* and thread-pool
    calls' ctypes signatures."""
    lib = ctypes.CDLL(path or library_path())
    lib.bvh_thread_pool_create.restype = ctypes.c_void_p
    lib.bvh_thread_pool_create.argtypes = [ctypes.c_size_t]
    lib.bvh_thread_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.bvh3f_build.restype = ctypes.c_void_p
    lib.bvh3f_build.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.POINTER(BuildConfigC),
    ]
    lib.bvh3f_destroy.argtypes = [ctypes.c_void_p]
    lib.bvh3f_save.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.bvh3f_load.restype = ctypes.c_void_p
    lib.bvh3f_load.argtypes = [ctypes.c_void_p]
    for name in ("node_count", "prim_count"):
        fn = getattr(lib, f"bvh3f_get_{name}")
        fn.restype = ctypes.c_size_t
        fn.argtypes = [ctypes.c_void_p]
    lib.bvh3f_get_prim_id.restype = ctypes.c_size_t
    lib.bvh3f_get_prim_id.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.bvh3f_refit.argtypes = [ctypes.c_void_p]
    lib.bvh3f_optimize.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    for suffix in ("", "_robust", "_any", "_any_robust"):
        getattr(lib, f"bvh3f_intersect_ray{suffix}").argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(Callback3f)]
    return lib


def _libc():
    libc = ctypes.CDLL(None)
    libc.fopen.restype = ctypes.c_void_p
    libc.fopen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    libc.fclose.argtypes = [ctypes.c_void_p]
    return libc


class NativeBvh3f:
    """Minimal wrapper over the bvh3f_* surface (the refit, optimize and
    intersect calls are bound on `lib`)."""

    def __init__(self, lib=None):
        self.lib = lib or load_library()

    def build(self, bb_min, bb_max, centers, quality=2, threads=0):
        """Build over per-primitive boxes and centers ([n, 3] each).
        `threads` > 0 runs the thread-pooled mini-tree pipeline (the
        reference's default build); quality 2 adds reinsertion."""
        centers = np.ascontiguousarray(centers, np.float32)
        boxes = np.empty((len(centers), 6), np.float32)
        boxes[:, 0:3] = bb_min
        boxes[:, 3:6] = bb_max
        cfg = BuildConfigC(quality, 1, 8, 1024)
        pool = self.lib.bvh_thread_pool_create(threads) if threads else None
        try:
            handle = self.lib.bvh3f_build(
                pool, boxes.ctypes.data_as(ctypes.c_void_p),
                centers.ctypes.data_as(ctypes.c_void_p), len(centers),
                ctypes.byref(cfg))
        finally:
            if pool:
                self.lib.bvh_thread_pool_destroy(pool)
        return handle

    def save(self, handle, path: str) -> None:
        libc = _libc()
        f = libc.fopen(path.encode(), b"wb")
        if not f:
            raise OSError(f"cannot open {path} for writing")
        try:
            self.lib.bvh3f_save(handle, f)
        finally:
            libc.fclose(f)

    def load(self, path: str):
        """A handle to the tree in the v2 file at `path`."""
        libc = _libc()
        f = libc.fopen(path.encode(), b"rb")
        if not f:
            raise OSError(f"cannot open {path} for reading")
        try:
            return self.lib.bvh3f_load(f)
        finally:
            libc.fclose(f)

    def to_bytes(self, handle) -> bytes:
        """The tree's v2 bytes."""
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "tree.bvh")
            self.save(handle, path)
            with open(path, "rb") as f:
                return f.read()

    def destroy(self, handle) -> None:
        self.lib.bvh3f_destroy(handle)

    def node_count(self, handle) -> int:
        return self.lib.bvh3f_get_node_count(handle)

    def prim_ids(self, handle) -> np.ndarray:
        n = self.lib.bvh3f_get_prim_count(handle)
        return np.asarray([self.lib.bvh3f_get_prim_id(handle, i)
                           for i in range(n)])

    def intersect_closest(self, handle, org, dir, tris, robust=True):  # noqa: A002 - matches reference
        """Closest hit of one ray through the native traversal, with a
        Python leaf callback over the triangles `tris` [n, 3, 3] by prim
        id (bvh_tpu/api/native.py:139-183): (prim position, t), or
        (-1, inf) on a miss."""
        state = {"prim": -1, "t": np.inf}
        prim_ids = self.prim_ids(handle)
        tris = np.asarray(tris)

        def tri_hit(p0, e1, e2, nrm, o, d, tmin, tmax):
            c = p0 - o
            r = np.cross(d, c)
            det = float(np.dot(nrm, d))
            if det == 0:
                return None
            inv = 1.0 / det
            u = float(np.dot(r, e2)) * inv
            v = float(np.dot(r, e1)) * inv
            w = 1.0 - u - v
            eps = -np.finfo(np.float32).eps
            if u >= eps and v >= eps and w >= eps:
                t = float(np.dot(nrm, c)) * inv
                if tmin <= t <= tmax:
                    return t
            return None

        @CALLBACK3F
        def cb(_user, ray_ptr, begin, end):
            ray = np.ctypeslib.as_array(ray_ptr, shape=(8,))
            hit_any = False
            for i in range(begin, end):
                tri = tris[prim_ids[i]]
                t = tri_hit(tri[0], tri[0] - tri[1], tri[2] - tri[0],
                            np.cross(tri[0] - tri[1], tri[2] - tri[0]),
                            ray[0:3], ray[3:6], ray[6], ray[7])
                if t is not None:
                    state["prim"] = i
                    state["t"] = t
                    ray[7] = t
                    hit_any = True
            return hit_any

        ray = np.asarray([*org, *dir, 0.0, np.finfo(np.float32).max],
                         np.float32)
        callback = Callback3f(None, cb)
        fn = (self.lib.bvh3f_intersect_ray_robust if robust
              else self.lib.bvh3f_intersect_ray)
        fn(handle, ray.ctypes.data_as(ctypes.c_void_p), ctypes.byref(callback))
        return state["prim"], state["t"]
