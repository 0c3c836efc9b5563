"""Build and bind the port's hand-written CUDA kernels.

The sources in `csrc/` are compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
         -std=c++17 -shared -Xcompiler -fPIC -Xptxas=-v

(one nvcc process per source, all started together), then linked into
`_build/libbvh_kernels-<hash>.so`, keyed by a hash of the sources and
flags, and loaded with ctypes. `-fmad=false` keeps nvcc from
contracting `nb*inv_dir + inv_org` and the Möller–Trumbore sums into
FMAs, which would flip hits on box and triangle edges; there is no
`--use_fast_math`, so `1.0f/x` stays IEEE. The ptxas report (registers,
spills) is kept beside the library as `<name>.log`.

Each kernel is a `Kernel` with a launch count: the dispatcher adds one
where it launches the kernel, and nowhere else, so a run can show that
its main path went through the kernels. There is no fallback: without
CUDA or nvcc, `library()` raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG, "_build")
CSRC = os.path.join(_PKG, "csrc")
CUDA_SOURCES = [os.path.join(CSRC, "collect.cu"),
                os.path.join(CSRC, "wide_treelet.cu"),
                os.path.join(CSRC, "group_build.cu"),
                os.path.join(CSRC, "binary_traverse.cu"),
                os.path.join(CSRC, "probes.cu"),
                os.path.join(CSRC, "portal_sort.cu"),
                os.path.join(CSRC, "super_walk.cu")]
CUDA_HEADERS = [os.path.join(CSRC, "slab.cuh"),
                os.path.join(CSRC, "collect_step.cuh"),
                os.path.join(CSRC, "portal_key.cuh")]
# Stack capacities compiled into the kernels; a wrapper raises when
# asked for a deeper stack.
TOP_STACK_MAX = 64
WIDE_STACK_MAX = 256
BINARY_STACK_MAX = 128
PROBE_STACK_MAX = 32
# Records a warp of the super walk stages in shared memory: it walks at
# most this many over max_new supers at once (32 at max_new 32).
SUPER_WALK_RECORDS = 1024
# The 19 comparators of the reference's `_sort8`, in its order, as 6
# layers of disjoint pairs; kernel T5 is compiled with them (each lane
# of a ray runs them on the ray's 8 keys).
SORT8_LAYERS = (((0, 1), (2, 3), (4, 5), (6, 7)),
                ((0, 2), (1, 3), (4, 6), (5, 7)),
                ((1, 2), (5, 6)),
                ((0, 4), (1, 5), (2, 6), (3, 7)),
                ((2, 4), (3, 5)),
                ((1, 2), (3, 4), (5, 6)))


def sort8_partner_words() -> list[int]:
    """Each layer of SORT8_LAYERS as one word: nibble c holds lane c's
    partner, lane c itself where the layer has no pair of c."""
    words = []
    for layer in SORT8_LAYERS:
        partner = list(range(8))
        for a, b in layer:
            partner[a], partner[b] = b, a
        words.append(sum(p << (4 * c) for c, p in enumerate(partner)))
    return words


NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v", f"-DBVH_TOP_STACK_MAX={TOP_STACK_MAX}",
              f"-DBVH_WIDE_STACK_MAX={WIDE_STACK_MAX}",
              f"-DBVH_BINARY_STACK_MAX={BINARY_STACK_MAX}",
              f"-DBVH_PROBE_STACK_MAX={PROBE_STACK_MAX}",
              f"-DBVH_SUPER_WALK_RECORDS={SUPER_WALK_RECORDS}",
              *(f"-DBVH_SORT8_LAYER{i}={w:#010x}u"
                for i, w in enumerate(sort8_partner_words()))]


def build_shared_library(command, sources, hashed, stem: str) -> str:
    """Compile `sources` with `command` into `_build/<stem>-<hash>.so`,
    unless that file exists. The hash covers the command and every
    file in `hashed`. Each source compiles to an object in a process of
    its own, all started together, and the objects are then linked.
    The build writes private temporary files and renames the library,
    so concurrent first uses do not see a partial one.
    Raises RuntimeError with the compiler's output if the build fails."""
    h = hashlib.sha256(" ".join(command).encode())
    for path in hashed:
        with open(path, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{i}.o" for i in range(len(sources))]
    compile_cmd = [c for c in command if c != "-shared"]
    procs = [subprocess.Popen([*compile_cmd, "-c", src, "-o", obj],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for src, obj in zip(sources, objs)]
    log = ""
    try:
        for p in procs:
            o, e = p.communicate()
            log += o + e
        if any(p.returncode for p in procs):
            raise RuntimeError(f"building {stem} failed:\n{log}")
        proc = subprocess.run([*command, *objs, "-o", tmp],
                              capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"building {stem} failed:\n{log}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    with open(out[:-3] + ".log", "w") as f:
        f.write(log)
    os.replace(tmp, out)
    return out


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # table, Pt, rays, R, root, robust, stack_depth, max_portals,
    # ptid, ptent, stats, stream
    "bvh_collect_portals": [_VP, _I, _VP, _I, _I, _I, _I, _I,
                            _VP, _VP, _VP, _VP],
    # sup_cols [S, Ps, 16], Ps, sid, rays, L, robust, stack_depth,
    # max_new, ntid, nt, stats, stream
    "bvh_collect_super_pairs": [_VP, _I, _VP, _VP, _I, _I, _I, _I,
                                _VP, _VP, _VP, _VP],
    # ptid, ptent, cnt, R, MP, sel, Rc, T (< 0: no split), mps, tid, tent,
    # sup, nsup, tlen (the last three null without a split), stream
    "bvh_portal_sort": [_VP, _VP, _VP, _I, _I, _VP, _I, _I, _I, _VP, _VP,
                        _VP, _VP, _VP, _VP],
    # tid, tent, tlen, MP, Rc, rsel, Rr, pair, k2, ntid, nt, ncnt, L,
    # max_new, dest (scratch), fcnt, stream
    "bvh_portal_merge": [_VP, _VP, _VP, _I, _I, _VP, _I, _VP, _I, _VP, _VP,
                         _VP, _I, _I, _VP, _VP, _VP],
    # sup_cols, Ps, sid [mps, Rc], nsup, mps, rays, Rc, tid [MP, Rc] i64,
    # tent, tlen, MP, gone (or null), robust, stack_depth, max_new,
    # max_portals, k2, lanes, cols, stats (7 ints, zeroed by the call),
    # stream
    "bvh_super_walk": [_VP, _I, _VP, _VP, _I, _VP, _I, _VP, _VP, _VP, _I,
                       _VP, _I, _I, _I, _I, _I, _I, _VP, _VP, _VP],
    # pairs [P, 16], tris [n, 12], rays, R, root_word, any_hit, robust,
    # stack_depth, out_f, out_i, next (the work counter, one int, zero
    # at the launch), steps (or null), stream
    "bvh_binary_traverse_tris": [_VP, _VP, _VP, _I, _I, _I, _I, _I,
                                 _VP, _VP, _VP, _VP, _VP],
    # dim, pairs [P, 4*(dim+1)], spheres [n, 4 or 8], rays, R, root_word,
    # any_hit, robust, stack_depth, out_f, out_i, next (as B5's),
    # steps (or null), stream
    "bvh_sphere_traverse": [_I, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP, _VP,
                            _VP, _VP, _VP],
    # table_cols, T, P, tid, rays, L, any_hit, robust, stack_depth,
    # out_f, out_i, next (work counter), count (the valid pairs, one int
    # on the device, or null), stream
    "bvh_wide_treelet_traverse": [_VP, _I, _I, _VP, _VP, _I, _I, _I, _I,
                                  _VP, _VP, _VP, _VP, _VP],
    # table_cols, T, P, tid [MP, Rc] i64, tent, MP, rays, Rc, late (or
    # null), k (the window), any_hit, robust, stack_depth, out_f, out_pos,
    # out_ovf, stats (4 ints, zeroed by the call), stream
    "bvh_wide_treelet_walk": [_VP, _I, _I, _VP, _VP, _I, _VP, _I, _VP, _I,
                              _I, _I, _I, _VP, _VP, _VP, _VP, _VP],
    # table_cols, T, P, tid, rays, L, variant, stack_depth, out_f, out_i,
    # next, stream
    "bvh_wide_treelet_ablate": [_VP, _I, _I, _VP, _VP, _I, _I, _I,
                                _VP, _VP, _VP, _VP],
    # table, C, rays, B, sort8, chains, stack_depth, iters, out, stream
    "bvh_wide_step_probe": [_VP, _I, _VP, _I, _I, _I, _I, _I, _VP, _VP],
    # C, B, sort8, chains, stack_depth, out[4]
    "bvh_wide_step_probe_launch": [_I, _I, _I, _I, _I, ctypes.POINTER(_I)],
    # cols, int8, width (rows_pad), P, idx, B, iters, out, stream
    "bvh_column_fetch": [_VP, _I, _I, _I, _VP, _I, _I, _VP, _VP],
    # pf, sizes, G, P, NCAP, min_leaf, max_leaf, log_cluster, cost_ratio,
    # nbf, nbi, src, cnt, stream
    "bvh_group_build": [_VP, _VP, _I, _I, _I, _I, _I, _I, _F,
                        _VP, _VP, _VP, _VP, _VP],
    "bvh_group_build_max_p": [ctypes.POINTER(_I)],
    # P, out
    "bvh_group_build_occupancy": [_I, ctypes.POINTER(_I)],
    # out
    "bvh_binary_traverse_occupancy": [ctypes.POINTER(_I)],
    # dim, out
    "bvh_sphere_traverse_occupancy": [_I, ctypes.POINTER(_I)],
}


def _library_path() -> str:
    return build_shared_library([_nvcc(), *NVCC_FLAGS], CUDA_SOURCES,
                                CUDA_SOURCES + CUDA_HEADERS,
                                "libbvh_kernels")


@functools.cache
def library() -> ctypes.CDLL:
    """Build (first use only) and load the kernels' shared library."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the kernels run only "
                           "on a CUDA device")
    lib = ctypes.CDLL(_library_path())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.bvh_cuda_error_string.argtypes = [ctypes.c_int]
    lib.bvh_cuda_error_string.restype = ctypes.c_char_p
    return lib


def group_build_max_p() -> int:
    """The largest group capacity P whose shared memory fits one block
    of the group build kernel on the current device."""
    out = _I(0)
    err = library().bvh_group_build_max_p(ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"bvh_group_build_max_p: CUDA error {err}")
    return out.value


def group_build_occupancy(P: int) -> int:
    """The group build kernel's CTAs that one SM of the current device
    holds at once at group capacity P (CUDA's occupancy calculator on
    its registers, threads and shared memory)."""
    out = _I(0)
    err = library().bvh_group_build_occupancy(P, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"bvh_group_build_occupancy: CUDA error {err}")
    return out.value


def sphere_traverse_occupancy(dim: int) -> int:
    """The warps of kernel B6 (closest hit, fast slab) that one SM of
    the current device holds at once at `dim` (CUDA's occupancy
    calculator on its registers, threads and stack)."""
    out = _I(0)
    err = library().bvh_sphere_traverse_occupancy(dim, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"bvh_sphere_traverse_occupancy: CUDA error {err}")
    return out.value


def binary_traverse_occupancy() -> int:
    """The warps of kernel B5 (closest hit, fast slab) that one SM of
    the current device holds at once."""
    out = _I(0)
    err = library().bvh_binary_traverse_occupancy(ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"bvh_binary_traverse_occupancy: CUDA error {err}")
    return out.value


def wide_step_probe_launch(C: int, B: int, sort8: bool, chains: int,
                           stack_depth: int) -> dict[str, int]:
    """The launch kernel T5 makes on the current device for these
    arguments: threads a block, blocks, dynamic shared memory bytes
    (the staged table and the stacks) and blocks an SM."""
    out = (_I * 4)()
    err = library().bvh_wide_step_probe_launch(C, B, int(sort8), chains,
                                               stack_depth, out)
    if err != 0:
        raise RuntimeError(f"bvh_wide_step_probe_launch: CUDA error {err}")
    return dict(zip(("block", "grid", "smem", "per_sm"), out))


# the node types of CUgraphNodeType (cuda.h), in their order
_GRAPH_NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
                     "wait_event", "event_record", "semaphore_signal",
                     "semaphore_wait", "mem_alloc", "mem_free", "mem_op",
                     "conditional")


def graph_node_counts(graph: int) -> dict[str, int]:
    """The nodes of a captured CUDA graph by type, and their total: the
    graph is a cudaGraph_t handle (`torch.cuda.CUDAGraph(keep_graph=True)
    .raw_cuda_graph()`), read with libcuda's cuGraphGetNodes and
    cuGraphNodeGetType."""
    cuda = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    err = cuda.cuGraphGetNodes(_VP(graph), None, ctypes.byref(n))
    nodes = (_VP * n.value)()
    if err == 0:
        err = cuda.cuGraphGetNodes(_VP(graph), nodes, ctypes.byref(n))
    out = {"total": n.value}
    for node in nodes[:n.value]:
        kind = _I(0)
        err = err or cuda.cuGraphNodeGetType(_VP(node), ctypes.byref(kind))
        name = (_GRAPH_NODE_TYPES[kind.value]
                if kind.value < len(_GRAPH_NODE_TYPES) else str(kind.value))
        out[name] = out.get(name, 0) + 1
    if err != 0:
        raise RuntimeError(f"graph_node_counts: libcuda error {err}")
    return out


def ptxas_figures(fragment: str) -> dict[str, dict[str, int]]:
    """From the compiler's report: registers, static shared memory,
    stack frame and spill bytes of every entry function whose mangled
    name holds `fragment`."""
    out: dict[str, dict[str, int]] = {}
    name = None
    for line in build_log().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)'?", line)
        if m:
            name = m.group(1) if fragment in m.group(1) else None
            if name:
                out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(frame=int(m.group(1)), spill_stores=int(
                m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out[name]["smem"] = int(m.group(1))
    return out


def build_log() -> str:
    """The compiler's report for the kernels' library (ptxas
    registers, shared memory and spills per kernel)."""
    with open(_library_path()[:-3] + ".log") as f:
        return f.read()


class Kernel:
    """One entry point of the library, with its launch count."""

    def __init__(self, name: str, symbol: str):
        self.name = name
        self.symbol = symbol
        self.launches = 0

    def launch(self, *args) -> None:
        """Launch on PyTorch's current stream; raise if CUDA refused
        the launch (the C entry point returns cudaGetLastError())."""
        lib = library()
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, self.symbol)(*args, stream)
        if err != 0:
            msg = lib.bvh_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.name}: CUDA error {err} ({msg})")
        self.launches += 1


COLLECT = Kernel("collect_portals", "bvh_collect_portals")
WIDE_TREELET = Kernel("traverse_pairs", "bvh_wide_treelet_traverse")
WALK = Kernel("walk_portals", "bvh_wide_treelet_walk")
GROUP_BUILD = Kernel("group_build", "bvh_group_build")
COLLECT_SUPER = Kernel("collect_super_pairs", "bvh_collect_super_pairs")
BINARY_TRAVERSE = Kernel("binary_traverse", "bvh_binary_traverse_tris")
SPHERE_TRAVERSE = Kernel("sphere_traverse", "bvh_sphere_traverse")
PORTAL_SORT = Kernel("portal_sort", "bvh_portal_sort")
PORTAL_MERGE = Kernel("portal_merge", "bvh_portal_merge")
SUPER_WALK = Kernel("walk_supers", "bvh_super_walk")
# the profiling tools' kernels (bvh_tpu_torch/tools/)
WIDE_TREELET_ABLATE = Kernel("traverse_pairs_ablate", "bvh_wide_treelet_ablate")
WIDE_STEP_PROBE = Kernel("wide_step_probe", "bvh_wide_step_probe")
COLUMN_FETCH = Kernel("column_fetch", "bvh_column_fetch")
KERNELS = (COLLECT, WIDE_TREELET, WALK, GROUP_BUILD, COLLECT_SUPER,
           BINARY_TRAVERSE, SPHERE_TRAVERSE, PORTAL_SORT, PORTAL_MERGE,
           SUPER_WALK, WIDE_TREELET_ABLATE,
           WIDE_STEP_PROBE, COLUMN_FETCH)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
