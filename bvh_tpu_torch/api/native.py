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


def library_path() -> str:
    """Path of the built library; compiles it on first use."""
    return build_shared_library(
        ["g++", "-std=c++20", "-O2", "-fPIC", "-shared",
         "-ffp-contract=off", "-pthread"],
        _SOURCES[:1], _SOURCES, "libbvh_c")


def load_library():
    lib = ctypes.CDLL(library_path())
    lib.bvh_thread_pool_create.restype = ctypes.c_void_p
    lib.bvh_thread_pool_create.argtypes = [ctypes.c_size_t]
    lib.bvh_thread_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.bvh3f_build.restype = ctypes.c_void_p
    lib.bvh3f_build.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.POINTER(BuildConfigC),
    ]
    lib.bvh3f_destroy.argtypes = [ctypes.c_void_p]
    lib.bvh3f_get_node_count.restype = ctypes.c_size_t
    lib.bvh3f_get_node_count.argtypes = [ctypes.c_void_p]
    lib.bvh3f_save.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


def _libc():
    libc = ctypes.CDLL(None)
    libc.fopen.restype = ctypes.c_void_p
    libc.fopen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    libc.fclose.argtypes = [ctypes.c_void_p]
    return libc


class NativeBvh3f:
    """Minimal wrapper over the bvh3f_* surface."""

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
