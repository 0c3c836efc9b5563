// Per-group binned-SAH build (kernel B3) for Hopper.
//
// Replaces the Pallas kernel `_group_build_kernel_ls`
// (bvh_tpu/build/group_kernel.py:383), launched by `group_forest_build`
// (:924) from the fast mini-tree build. For each Morton-grid group of
// sizes[g] <= P primitives it builds the whole binned-SAH subtree: 8 bins
// per axis, axis-major first-minimum ties, the clamped binning, the exact
// median fallback on the largest axis (stable by value, then lane), SATO
// child order and BFS slot order. See bvh_tpu_torch/build/group_kernel.py
// for the rules and the layouts; the plain version there
// (`group_forest_build_ref`) gives the same output bit for bit.
//
// What bounds it on the card: the serial chain of nodes inside a group.
// A group's tree is built node after node in BFS order (its "bfs" twin,
// `_group_build_kernel` :77, shows that this order gives the same output
// as the level-synchronous one), and each node costs a handful of block
// barriers plus one thread's 42-step SAH sweep, whatever its size. The
// design gives each group one CTA of 256 threads, keeps the group's
// primitives (9 float rows and the source lane) and an equal partition
// buffer in shared memory, 80 bytes per lane, so that the per-node passes
// over a node's lanes never touch device memory; the node table goes
// straight to device memory, written by thread 0 alone. Groups run in
// parallel, several CTAs per SM. The TPU kernel's one-hot matrix
// products (partition, broadcasts, table writes) and its roll scans are
// not carried over: a partition is a block-wide exclusive scan and a
// scatter into shared memory.
//
// Exactness: every product and sum is written with __fmul_rn/__fadd_rn/
// __fdiv_rn (the library builds with -fmad=false as well), in the TPU
// kernel's operation order. Min and max reductions use an integer key
// whose order is the float order (-0 before +0), so they are exact in any
// order; counts are integers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 8;
constexpr int kDim = 3;
constexpr int kRows = 3 * kDim;  // centres, bb_min, bb_max
constexpr int kBinSlots = kDim * kBins;
// shared bytes per lane: kRows floats + the source lane, twice
constexpr int kSmemPerLane = 2 * (kRows + 1) * 4;

__device__ __forceinline__ float big() { return __int_as_float(0x7f7fffff); }
__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// Signed-int key with the float's total order; its own inverse on the
// negative half.
__device__ __forceinline__ int fkey(float f) {
    int i = __float_as_int(f);
    return i >= 0 ? i : (i ^ 0x7fffffff);
}
__device__ __forceinline__ float fval(int k) {
    return __int_as_float(k >= 0 ? k : (k ^ 0x7fffffff));
}
__device__ __forceinline__ float fmin_t(float a, float b) {
    return fkey(b) < fkey(a) ? b : a;
}
__device__ __forceinline__ float fmax_t(float a, float b) {
    return fkey(b) > fkey(a) ? b : a;
}

// (d0 + d1) * d2 + d0 * d1 (bbox.h:32-38)
__device__ __forceinline__ float half_area(float d0, float d1, float d2) {
    return __fadd_rn(__fmul_rn(__fadd_rn(d0, d1), d2), __fmul_rn(d0, d1));
}

// The median search's key: the float order as int32 (group_kernel.py:680).
__device__ __forceinline__ int median_key(float v) {
    int b = __float_as_int(v);
    return b < 0 ? (int)(0x80000000u - (unsigned)b - 1u) : b;
}

struct Node {
    int go, open, b, e;
    float mn[kDim], mx[kDim], area, anc, bscale[kDim], boff[kDim];
    int tail;
    // decisions
    int best_axis, largest, sah_ok;
    float split_val;
};

struct Scratch {
    int cnt[kBinSlots];
    int kmn[kBinSlots * kDim];
    int kmx[kBinSlots * kDim];
    int box[4 * kDim];  // [side][min keys, max keys]
    int warp[kWarps];
};

// Sum over the block; every thread gets the total. Two barriers.
__device__ int block_sum(int v, Scratch& sc) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) sc.warp[threadIdx.x >> 5] = v;
    __syncthreads();
    int t = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += sc.warp[w];
    __syncthreads();
    return t;
}

// Exclusive prefix of `flag` in thread order, and the block total. Two
// barriers.
__device__ int block_excl_scan(int flag, int& total, Scratch& sc) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    int x = flag;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) sc.warp[w] = x;
    __syncthreads();
    int before = 0, t = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
        const int s = sc.warp[i];
        before += i < w ? s : 0;
        t += s;
    }
    __syncthreads();
    total = t;
    return before + x - flag;
}

// Min/max keys of the boxes of lanes [lo, mid) (side 0) and [mid, hi)
// (side 1) into sc.box; sc.box must hold the identities.
__device__ void reduce_boxes(const float* bmn, const float* bmx, int P,
                             int lo, int mid, int hi, Scratch& sc) {
    int k[2][2 * kDim];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int a = 0; a < kDim; ++a) {
            k[s][a] = fkey(big());
            k[s][kDim + a] = fkey(-big());
        }
    for (int l = lo + threadIdx.x; l < hi; l += kThreads) {
        const int s = l < mid ? 0 : 1;
#pragma unroll
        for (int a = 0; a < kDim; ++a) {
            const int kn = fkey(bmn[a * P + l]), kx = fkey(bmx[a * P + l]);
            if (s == 0) {
                k[0][a] = min(k[0][a], kn);
                k[0][kDim + a] = max(k[0][kDim + a], kx);
            } else {
                k[1][a] = min(k[1][a], kn);
                k[1][kDim + a] = max(k[1][kDim + a], kx);
            }
        }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int a = 0; a < kDim; ++a) {
            int vn = k[s][a], vx = k[s][kDim + a];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
                vn = min(vn, __shfl_xor_sync(0xffffffffu, vn, o));
                vx = max(vx, __shfl_xor_sync(0xffffffffu, vx, o));
            }
            if ((threadIdx.x & 31) == 0) {
                atomicMin(&sc.box[s * 2 * kDim + a], vn);
                atomicMax(&sc.box[s * 2 * kDim + kDim + a], vx);
            }
        }
}

__device__ void reset_boxes(Scratch& sc) {
    for (int i = threadIdx.x; i < 4 * kDim; i += kThreads)
        sc.box[i] = (i % (2 * kDim)) < kDim ? fkey(big()) : fkey(-big());
}

// One CTA per group. pf: [16, GP] rows (centres 0-2, bb_min 3-5,
// bb_max 6-8); nbf/nbi: [8, G*NCAP]; src: [G*P]; cnt: [G].
__global__ void __launch_bounds__(kThreads)
group_build_kernel(const float* __restrict__ pf, const int* __restrict__ sizes,
                   int P, int NCAP, int min_leaf, int max_leaf, int log_cluster,
                   float cost_ratio, float* __restrict__ nbf,
                   int* __restrict__ nbi, int* __restrict__ src_out,
                   int* __restrict__ cnt_out) {
    extern __shared__ float smem[];
    float* cen = smem;                                   // [3][P]
    float* bmn = cen + kDim * P;                         // [3][P]
    float* bmx = bmn + kDim * P;                         // [3][P]
    int* lsrc = reinterpret_cast<int*>(bmx + kDim * P);  // [P]
    float* buf = reinterpret_cast<float*>(lsrc + P);     // [9][P]
    int* bsrc = reinterpret_cast<int*>(buf + kRows * P);  // [P]

    __shared__ Node nd;
    __shared__ Scratch sc;

    const int g = blockIdx.x, tid = threadIdx.x;
    const int G = gridDim.x;
    const long GP = (long)G * P, GN = (long)G * NCAP;
    const int size = sizes[g];
    float* tbf = nbf + (long)g * NCAP;  // row r of this group at r * GN
    int* tbi = nbi + (long)g * NCAP;
    const int off = (1 << log_cluster) - 1;

    for (int l = tid; l < P; l += kThreads) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
            smem[r * P + l] = pf[r * GP + (long)g * P + l];
        lsrc[l] = l;
    }
    for (int s = tid; s < NCAP; s += kThreads)
#pragma unroll
        for (int r = 0; r < 8; ++r) {
            tbf[r * GN + s] = 0.0f;
            tbi[r * GN + s] = r == 2 ? -1 : 0;
        }
    reset_boxes(sc);
    __syncthreads();

    // the root: bounds of lanes [0, size)
    reduce_boxes(bmn, bmx, P, 0, size, size, sc);
    __syncthreads();
    if (tid == 0) {
        float d[kDim];
        for (int a = 0; a < kDim; ++a) {
            const float mn = fval(sc.box[a]), mx = fval(sc.box[kDim + a]);
            tbf[(2 * a) * GN] = mn;
            tbf[(2 * a + 1) * GN] = mx;
            d[a] = __fsub_rn(mx, mn);
        }
        tbf[6 * GN] = half_area(d[0], d[1], d[2]);
        tbf[7 * GN] = big();
        tbi[0] = 0;
        tbi[GN] = size;
        tbi[2 * GN] = size <= min_leaf ? -1 : 0;
        nd.tail = 1;
    }
    __syncthreads();  // sc.box is reset below

    for (int q = 0;; ++q) {
        // ---- phase 0: thread 0 loads node q; everyone resets scratch
        if (tid == 0) {
            nd.go = q < nd.tail;
            if (nd.go) {
                nd.b = tbi[q];
                nd.e = tbi[GN + q];
                nd.open = nd.e - nd.b > min_leaf;
                for (int a = 0; a < kDim; ++a) {
                    nd.mn[a] = tbf[(2 * a) * GN + q];
                    nd.mx[a] = tbf[(2 * a + 1) * GN + q];
                    nd.bscale[a] = __fdiv_rn((float)kBins,
                                             __fsub_rn(nd.mx[a], nd.mn[a]));
                    nd.boff[a] = __fmul_rn(-nd.mn[a], nd.bscale[a]);
                }
                nd.area = tbf[6 * GN + q];
                nd.anc = tbf[7 * GN + q];
            }
        }
        for (int i = tid; i < kBinSlots; i += kThreads) sc.cnt[i] = 0;
        for (int i = tid; i < kBinSlots * kDim; i += kThreads) {
            sc.kmn[i] = fkey(big());
            sc.kmx[i] = fkey(-big());
        }
        reset_boxes(sc);
        __syncthreads();
        if (!nd.go) break;
        if (!nd.open) {
            __syncthreads();
            continue;
        }
        const int b = nd.b, e = nd.e, sz = e - b;

        // ---- binning (binned_sah_builder.h:82-99)
        for (int l = b + tid; l < e; l += kThreads) {
#pragma unroll
            for (int d = 0; d < kDim; ++d) {
                float p = __fadd_rn(__fmul_rn(cen[d * P + l], nd.bscale[d]),
                                    nd.boff[d]);
                p = p > 0.0f ? p : 0.0f;
                p = p < (float)(kBins - 1) ? p : (float)(kBins - 1);
                const int k = d * kBins + __float2int_rz(p);
                atomicAdd(&sc.cnt[k], 1);
#pragma unroll
                for (int a = 0; a < kDim; ++a) {
                    atomicMin(&sc.kmn[k * kDim + a], fkey(bmn[a * P + l]));
                    atomicMax(&sc.kmx[k * kDim + a], fkey(bmx[a * P + l]));
                }
            }
        }
        __syncthreads();

        // ---- SAH sweep and decisions, one thread (:101-156)
        if (tid == 0) {
            float best_cost = inf();
            int best_axis = 0, best_bin = 1;
            for (int d = 0; d < kDim; ++d) {
                float right_cost[kBins];
                float rmn[kDim], rmx[kDim], lmn[kDim], lmx[kDim];
                int rcnt = 0, lcnt = 0;
                for (int a = 0; a < kDim; ++a) {
                    rmn[a] = lmn[a] = big();
                    rmx[a] = lmx[a] = -big();
                }
                for (int i = kBins - 1; i > 0; --i) {
                    const int k = d * kBins + i;
                    for (int a = 0; a < kDim; ++a) {
                        rmn[a] = fmin_t(rmn[a], fval(sc.kmn[k * kDim + a]));
                        rmx[a] = fmax_t(rmx[a], fval(sc.kmx[k * kDim + a]));
                    }
                    rcnt += sc.cnt[k];
                    const float ha = half_area(__fsub_rn(rmx[0], rmn[0]),
                                               __fsub_rn(rmx[1], rmn[1]),
                                               __fsub_rn(rmx[2], rmn[2]));
                    right_cost[i] = rcnt > 0
                        ? __fmul_rn(ha, (float)((rcnt + off) >> log_cluster))
                        : inf();
                }
                for (int i = 0; i < kBins - 1; ++i) {
                    const int k = d * kBins + i;
                    for (int a = 0; a < kDim; ++a) {
                        lmn[a] = fmin_t(lmn[a], fval(sc.kmn[k * kDim + a]));
                        lmx[a] = fmax_t(lmx[a], fval(sc.kmx[k * kDim + a]));
                    }
                    lcnt += sc.cnt[k];
                    const float ha = half_area(__fsub_rn(lmx[0], lmn[0]),
                                               __fsub_rn(lmx[1], lmn[1]),
                                               __fsub_rn(lmx[2], lmn[2]));
                    float cost = lcnt > 0
                        ? __fadd_rn(__fmul_rn(ha, (float)((lcnt + off) >> log_cluster)),
                                    right_cost[i + 1])
                        : inf();
                    if (isnan(cost)) cost = inf();
                    if (cost < best_cost) {  // strict: first minimum wins
                        best_cost = cost;
                        best_axis = d;
                        best_bin = i + 1;
                    }
                }
            }
            const float pc = (float)((sz + off) >> log_cluster);
            nd.sah_ok = best_cost < __fmul_rn(nd.area, __fsub_rn(pc, cost_ratio));
            float diag[kDim];
            for (int a = 0; a < kDim; ++a) diag[a] = __fsub_rn(nd.mx[a], nd.mn[a]);
            int largest = 0;
            float dl = diag[0];
            for (int a = 1; a < kDim; ++a)
                if (diag[a] > dl) {
                    largest = a;
                    dl = diag[a];
                }
            nd.best_axis = best_axis;
            nd.largest = largest;
            nd.split_val = __fadd_rn(
                __fmul_rn(__fdiv_rn(diag[best_axis], (float)kBins), (float)best_bin),
                nd.mn[best_axis]);
        }
        __syncthreads();
        const int best_axis = nd.best_axis, largest = nd.largest;
        const bool sah_ok = nd.sah_ok;
        const float split_val = nd.split_val;

        int local = 0;
        for (int l = b + tid; l < e; l += kThreads)
            local += cen[best_axis * P + l] < split_val ? 1 : 0;
        const int count_left = block_sum(local, sc);
        const bool degenerate = sah_ok && (count_left == 0 || count_left == sz);
        const bool do_split = sah_ok || sz > max_leaf;
        const bool use_fb = do_split && (!sah_ok || degenerate);
        const int half = (sz + 1) / 2;
        if (!do_split) {
            if (tid == 0) tbi[2 * GN + q] = -1;
            __syncthreads();
            continue;
        }

        // ---- median fallback (:118-126): the half-th smallest key by
        // binary search, then ties admitted in lane order
        int lo = 0, need = 0;
        if (use_fb) {
            lo = INT32_MIN;
            int hi = INT32_MAX;
            for (int it = 0; it < 33; ++it) {
                const int mk = (lo >> 1) + (hi >> 1) + (lo & hi & 1);
                int c = 0;
                for (int l = b + tid; l < e; l += kThreads)
                    c += median_key(cen[largest * P + l]) <= mk ? 1 : 0;
                if (block_sum(c, sc) >= half) hi = mk; else lo = mk + 1;
            }
            int c = 0;
            for (int l = b + tid; l < e; l += kThreads)
                c += median_key(cen[largest * P + l]) < lo ? 1 : 0;
            need = half - block_sum(c, sc);
        }
        const int mid = b + (use_fb ? half : count_left);

        // ---- stable partition into the buffer, in tiles of the block
        int carry_left = 0, carry_tie = 0;
        for (int t0 = b; t0 < e; t0 += kThreads) {
            const int l = t0 + tid;
            const bool in = l < e;
            bool gl;
            if (use_fb) {
                const int k = in ? median_key(cen[largest * P + l]) : 0;
                const bool tie = in && k == lo;
                int ties;
                const int tie_rank = carry_tie + block_excl_scan(tie, ties, sc);
                gl = in && (k < lo || (tie && tie_rank < need));
                carry_tie += ties;
            } else {
                gl = in && cen[best_axis * P + l] < split_val;
            }
            int lefts;
            const int lrank = carry_left + block_excl_scan(gl, lefts, sc);
            if (in) {
                const int np = gl ? b + lrank : mid + (l - b - lrank);
#pragma unroll
                for (int r = 0; r < kRows; ++r) buf[r * P + np] = smem[r * P + l];
                bsrc[np] = lsrc[l];
            }
            carry_left += lefts;
        }
        __syncthreads();
        for (int l = b + tid; l < e; l += kThreads) {
#pragma unroll
            for (int r = 0; r < kRows; ++r) smem[r * P + l] = buf[r * P + l];
            lsrc[l] = bsrc[l];
        }
        __syncthreads();

        // ---- child boxes, SATO order, slots (top_down_sah_builder.h:
        // 100-125)
        reduce_boxes(bmn, bmx, P, b, mid, e, sc);
        __syncthreads();
        if (tid == 0) {
            float cmn[2][kDim], cmx[2][kDim], area[2];
            for (int s = 0; s < 2; ++s) {
                for (int a = 0; a < kDim; ++a) {
                    cmn[s][a] = fval(sc.box[s * 2 * kDim + a]);
                    cmx[s][a] = fval(sc.box[s * 2 * kDim + kDim + a]);
                }
                area[s] = half_area(__fsub_rn(cmx[s][0], cmn[s][0]),
                                    __fsub_rn(cmx[s][1], cmn[s][1]),
                                    __fsub_rn(cmx[s][2], cmn[s][2]));
            }
            const bool swap = area[0] < area[1];
            const float anc = fminf(nd.anc, nd.area);
            const int tail = nd.tail;
            const int cb[2] = {b, mid}, ce[2] = {mid, e};
            for (int c = 0; c < 2; ++c) {
                const int s = swap ? 1 - c : c;  // c0 is side A unless swapped
                const int slot = tail + c;
                for (int a = 0; a < kDim; ++a) {
                    tbf[(2 * a) * GN + slot] = cmn[s][a];
                    tbf[(2 * a + 1) * GN + slot] = cmx[s][a];
                }
                tbf[6 * GN + slot] = area[s];
                tbf[7 * GN + slot] = anc;
                tbi[slot] = cb[s];
                tbi[GN + slot] = ce[s];
                tbi[2 * GN + slot] = -1;
            }
            tbi[2 * GN + q] = tail;
            nd.tail = tail + 2;
        }
        __syncthreads();
    }

    for (int l = tid; l < P; l += kThreads) src_out[(long)g * P + l] = lsrc[l];
    if (tid == 0) cnt_out[g] = size > 0 ? nd.tail : 0;
}

}  // namespace

// pf [16, G*P] f32; sizes [G] i32; outputs nbf [8, G*NCAP] f32, nbi
// [8, G*NCAP] i32, src [G*P] i32, cnt [G] i32. Needs NCAP >= 2P - 1 and
// 80 * P bytes of dynamic shared memory. Returns cudaGetLastError()
// after the launch (or the error of the shared-memory opt-in).
extern "C" int bvh_group_build(const float* pf, const int* sizes, int G, int P,
                               int NCAP, int min_leaf, int max_leaf,
                               int log_cluster, float cost_ratio, float* nbf,
                               int* nbi, int* src, int* cnt, void* stream) {
    const int smem = kSmemPerLane * P;
    cudaError_t err = cudaFuncSetAttribute(
        group_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (G > 0)
        group_build_kernel<<<G, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
            pf, sizes, P, NCAP, min_leaf, max_leaf, log_cluster, cost_ratio,
            nbf, nbi, src, cnt);
    return static_cast<int>(cudaGetLastError());
}

// The largest P whose shared memory fits one block on the current device:
// the opt-in limit less the kernel's static shared memory, over 80 bytes.
extern "C" int bvh_group_build_max_p(int* out) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&optin,
                                     cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, group_build_kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    *out = static_cast<int>((optin - (long)attr.sharedSizeBytes) / kSmemPerLane);
    return 0;
}
