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
// What bounds it on the card: the chain of levels inside a group, and
// how many groups the card holds at once. The design, like the TPU
// kernel and the plain version, is level-synchronous: one CTA of 256
// threads a group, and all open nodes of one BFS level are processed
// together, in two passes split by block barriers:
//
//   A. decide: bin the node's lanes, run the SAH sweep, and keep the
//      decision (split or not, SAH or fallback, axis, bin) in the node's
//      row 3 of nbi, which is zero in the output and zero again after B;
//   scan: an exclusive scan of the level's split flags in slot order
//      gives each splitting node its children's slots, tail + 2 * rank,
//      which is the order in which a sequential BFS allocates them;
//   B. split: the stable partition (or the median fallback), the child
//      boxes, and the two child rows written to their slots.
//
// A node of at most kWarpMax lanes is worked by one warp with no block
// barrier: per-warp bins in shared memory, the sweep over 24 lanes with
// segmented shuffle scans and a (cost, index) argmin, ballot ranks for
// the partition, redux reductions for counts and the child boxes. Warps
// take nodes from a shared counter. Larger nodes (the top levels) are
// worked by the whole CTA, one after another, with block sums and scans.
//
// To hold all groups of a launch on the card at once (G = 267 at the
// 262K build; 132 SMs), the CTA keeps 44 bytes a lane in shared memory:
// the 9 float rows stay where they were loaded and only a 4-byte lane
// permutation (and a buffer for it) is partitioned, and
// __launch_bounds__(256, 3) caps the registers so that 3 CTAs fit an SM.
//
// Exactness: every product and sum is written with __fmul_rn/__fadd_rn/
// __fdiv_rn (the library builds with -fmad=false as well), in the TPU
// kernel's operation order. Min and max reductions use an integer key
// whose order is the float order (-0 before +0), so they are exact in any
// order; counts are integers. The sweep's suffix and prefix boxes are
// such reductions, each cost is the sequential sweep's expression, and
// the argmin keeps the first minimum in axis-major order, so the parallel
// sweep picks what the sequential one picks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;  // CTAs per SM that the registers must allow
constexpr int kBins = 8;
constexpr int kDim = 3;
constexpr int kRows = 3 * kDim;  // centres, bb_min, bb_max
constexpr int kBinSlots = kDim * kBins;
// nodes of at most this many lanes are worked by one warp
constexpr int kWarpMax = 128;
// larger nodes of one level: at most P / (kWarpMax + 1)
constexpr int kMaxLarge = 64;
// shared bytes per lane: kRows floats, the permutation and its buffer
constexpr int kSmemPerLane = (kRows + 2) * 4;
constexpr unsigned kFull = 0xffffffffu;

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

// (d0 + d1) * d2 + d0 * d1 (bbox.h:32-38)
__device__ __forceinline__ float half_area(float d0, float d1, float d2) {
    return __fadd_rn(__fmul_rn(__fadd_rn(d0, d1), d2), __fmul_rn(d0, d1));
}

// The median search's key: the float order as int32 (group_kernel.py:680).
__device__ __forceinline__ int median_key(float v) {
    int b = __float_as_int(v);
    return b < 0 ? (int)(0x80000000u - (unsigned)b - 1u) : b;
}

struct Bins {
    int cnt[kBinSlots];
    int kmn[kBinSlots * kDim];
    int kmx[kBinSlots * kDim];
};

struct Shared {
    Bins bins[kWarps];  // one set a warp; the CTA path uses bins[0]
    int box[4 * kDim];  // [side][min keys, max keys]
    int warp[kWarps];
    int large[kMaxLarge];
    int nlarge, next;
};

struct Params {
    int P, max_leaf, log_cluster;
    float cost_ratio;
    long GN;
};

// One group's lanes in shared memory: rows [9][P] in load order, and
// perm[pos] = the lane at position pos (the output's source lane).
struct Lanes {
    const float* rows;
    int* perm;
    int* buf;
};

// One node as stored in the group's table (tbf/tbi point at slot 0).
struct Node {
    int b, e;
    float mn[kDim], mx[kDim];
};

__device__ __forceinline__ Node load_node(const float* tbf, const int* tbi,
                                          long GN, int s) {
    Node n;
    n.b = tbi[s];
    n.e = tbi[GN + s];
#pragma unroll
    for (int a = 0; a < kDim; ++a) {
        n.mn[a] = tbf[(2 * a) * GN + s];
        n.mx[a] = tbf[(2 * a + 1) * GN + s];
    }
    return n;
}

// ---- the two ways of working a node: one warp, or the whole CTA

struct WarpGroup {
    static constexpr int kSize = 32;
    static constexpr bool kIsWarp = true;
    __device__ int rank() const { return threadIdx.x & 31; }
    __device__ void sync() const { __syncwarp(); }
    __device__ int sum(int v) const { return __reduce_add_sync(kFull, v); }
    // exclusive prefix of `flag` in lane order, and the total
    __device__ int excl_scan(int flag, int& total) const {
        const unsigned m = __ballot_sync(kFull, flag);
        total = __popc(m);
        return __popc(m & ((1u << rank()) - 1u));
    }
    // over the warp, into every lane: side s's min keys k[6s..6s+2] and
    // max keys k[6s+3..6s+5]
    __device__ void reduce_keys(int (&k)[4 * kDim]) const {
#pragma unroll
        for (int i = 0; i < 4 * kDim; ++i)
            k[i] = (i % (2 * kDim)) < kDim ? __reduce_min_sync(kFull, k[i])
                                           : __reduce_max_sync(kFull, k[i]);
    }
};

struct CtaGroup {
    static constexpr int kSize = kThreads;
    static constexpr bool kIsWarp = false;
    Shared& sh;
    __device__ int rank() const { return threadIdx.x; }
    __device__ void sync() const { __syncthreads(); }
    // Sum over the block; every thread gets the total. Two barriers.
    __device__ int sum(int v) const {
        v = __reduce_add_sync(kFull, v);
        if ((threadIdx.x & 31) == 0) sh.warp[threadIdx.x >> 5] = v;
        __syncthreads();
        int t = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) t += sh.warp[w];
        __syncthreads();
        return t;
    }
    // Exclusive prefix of `flag` in thread order, and the block total.
    // Two barriers.
    __device__ int excl_scan(int flag, int& total) const {
        const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
        const unsigned m = __ballot_sync(kFull, flag);
        if (lane == 0) sh.warp[w] = __popc(m);
        __syncthreads();
        int before = 0, t = 0;
#pragma unroll
        for (int i = 0; i < kWarps; ++i) {
            const int s = sh.warp[i];
            before += i < w ? s : 0;
            t += s;
        }
        __syncthreads();
        total = t;
        return before + __popc(m & ((1u << lane) - 1u));
    }
    // As WarpGroup's, over the block through sh.box. Three barriers.
    __device__ void reduce_keys(int (&k)[4 * kDim]) const {
        if (threadIdx.x < 4 * kDim)
            sh.box[threadIdx.x] =
                (threadIdx.x % (2 * kDim)) < kDim ? fkey(big()) : fkey(-big());
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 4 * kDim; ++i) {
            const bool is_min = (i % (2 * kDim)) < kDim;
            const int v = is_min ? __reduce_min_sync(kFull, k[i])
                                 : __reduce_max_sync(kFull, k[i]);
            if ((threadIdx.x & 31) == 0) {
                if (is_min)
                    atomicMin(&sh.box[i], v);
                else
                    atomicMax(&sh.box[i], v);
            }
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 4 * kDim; ++i) k[i] = sh.box[i];
        __syncthreads();
    }
};

// The SAH sweep of one node's bins (binned_sah_builder.h:101-156) by the
// 32 lanes of a warp: lane t < 24 holds bin t % 8 of axis t / 8. The
// sequential sweep's right-to-left boxes are segmented suffix reductions,
// its left-to-right boxes prefix reductions; lane i's candidate is the
// split before bin i + 1, at the sequential expression's cost. Returns
// the first minimum in axis-major order: (cost, index = axis * 8 + bin
// - 1), where every cost is +inf it is (inf, 0), the sweep's start.
__device__ __forceinline__ int sah_sweep(const Bins& bn, int log_cluster,
                                         float& best_cost) {
    const int t = threadIdx.x & 31, i = t & 7;
    const int off = (1 << log_cluster) - 1;
    int c = 0, kn[kDim], kx[kDim];
#pragma unroll
    for (int a = 0; a < kDim; ++a) {
        kn[a] = fkey(big());
        kx[a] = fkey(-big());
    }
    if (t < kBinSlots) {
        c = bn.cnt[t];
#pragma unroll
        for (int a = 0; a < kDim; ++a) {
            kn[a] = bn.kmn[t * kDim + a];
            kx[a] = bn.kmx[t * kDim + a];
        }
    }
    int sc = c, pc = c, sn[kDim], sx[kDim], pn[kDim], px[kDim];
#pragma unroll
    for (int a = 0; a < kDim; ++a) {
        sn[a] = pn[a] = kn[a];
        sx[a] = px[a] = kx[a];
    }
#pragma unroll
    for (int o = 1; o < kBins; o <<= 1) {
        const bool down = i + o < kBins, up = i >= o;
        const int ys = __shfl_down_sync(kFull, sc, o, kBins);
        const int yp = __shfl_up_sync(kFull, pc, o, kBins);
        if (down) sc += ys;
        if (up) pc += yp;
#pragma unroll
        for (int a = 0; a < kDim; ++a) {
            const int dn = __shfl_down_sync(kFull, sn[a], o, kBins);
            const int dx = __shfl_down_sync(kFull, sx[a], o, kBins);
            const int un = __shfl_up_sync(kFull, pn[a], o, kBins);
            const int ux = __shfl_up_sync(kFull, px[a], o, kBins);
            if (down) {
                sn[a] = min(sn[a], dn);
                sx[a] = max(sx[a], dx);
            }
            if (up) {
                pn[a] = min(pn[a], un);
                px[a] = max(px[a], ux);
            }
        }
    }
    // right_cost[i] of the sequential sweep: bins i..7
    const float ha_r = half_area(__fsub_rn(fval(sx[0]), fval(sn[0])),
                                 __fsub_rn(fval(sx[1]), fval(sn[1])),
                                 __fsub_rn(fval(sx[2]), fval(sn[2])));
    const float right = sc > 0
        ? __fmul_rn(ha_r, (float)((sc + off) >> log_cluster)) : inf();
    const float right_next = __shfl_down_sync(kFull, right, 1, kBins);
    // left bins 0..i plus right_cost[i + 1]
    const float ha_l = half_area(__fsub_rn(fval(px[0]), fval(pn[0])),
                                 __fsub_rn(fval(px[1]), fval(pn[1])),
                                 __fsub_rn(fval(px[2]), fval(pn[2])));
    float cost = pc > 0
        ? __fadd_rn(__fmul_rn(ha_l, (float)((pc + off) >> log_cluster)),
                    right_next)
        : inf();
    if (isnan(cost) || t >= kBinSlots || i == kBins - 1) cost = inf();
    int idx = (t >> 3) * kBins + i;
    if (t >= kBinSlots) idx = 32 + t;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const float oc = __shfl_xor_sync(kFull, cost, o);
        const int oi = __shfl_xor_sync(kFull, idx, o);
        if (oc < cost || (oc == cost && oi < idx)) {
            cost = oc;
            idx = oi;
        }
    }
    best_cost = cost;
    return idx >= 32 ? 0 : idx;
}

// ---- pass A: bin a node, sweep, keep the decision in nbi row 3:
// bit 0 split, bit 1 SAH accepted, bits 2-3 axis, bits 4-7 bin.
template <class G>
__device__ void decide(const G& grp, Bins& bn, const Lanes& ln,
                       const Params& p, const float* tbf, int* tbi, int s) {
    const Node n = load_node(tbf, tbi, p.GN, s);
    const int sz = n.e - n.b, r = grp.rank();
    float bscale[kDim], boff[kDim];
#pragma unroll
    for (int a = 0; a < kDim; ++a) {
        bscale[a] = __fdiv_rn((float)kBins, __fsub_rn(n.mx[a], n.mn[a]));
        boff[a] = __fmul_rn(-n.mn[a], bscale[a]);
    }
    for (int i = r; i < kBinSlots * kDim; i += G::kSize) {
        if (i < kBinSlots) bn.cnt[i] = 0;
        bn.kmn[i] = fkey(big());
        bn.kmx[i] = fkey(-big());
    }
    grp.sync();
    // binning (binned_sah_builder.h:82-99)
    const int P = p.P;
    for (int l = n.b + r; l < n.e; l += G::kSize) {
        const int x = ln.perm[l];
        int kn[kDim], kx[kDim];
#pragma unroll
        for (int a = 0; a < kDim; ++a) {
            kn[a] = fkey(ln.rows[(kDim + a) * P + x]);
            kx[a] = fkey(ln.rows[(2 * kDim + a) * P + x]);
        }
#pragma unroll
        for (int d = 0; d < kDim; ++d) {
            float q = __fadd_rn(__fmul_rn(ln.rows[d * P + x], bscale[d]), boff[d]);
            q = q > 0.0f ? q : 0.0f;
            q = q < (float)(kBins - 1) ? q : (float)(kBins - 1);
            const int k = d * kBins + __float2int_rz(q);
            atomicAdd(&bn.cnt[k], 1);
#pragma unroll
            for (int a = 0; a < kDim; ++a) {
                atomicMin(&bn.kmn[k * kDim + a], kn[a]);
                atomicMax(&bn.kmx[k * kDim + a], kx[a]);
            }
        }
    }
    grp.sync();
    if (G::kIsWarp || threadIdx.x < 32) {
        float best_cost;
        const int idx = sah_sweep(bn, p.log_cluster, best_cost);
        if ((threadIdx.x & 31) == 0) {
            const int off = (1 << p.log_cluster) - 1;
            const float pc = (float)((sz + off) >> p.log_cluster);
            const float area = tbf[6 * p.GN + s];
            const bool sah_ok =
                best_cost < __fmul_rn(area, __fsub_rn(pc, p.cost_ratio));
            const bool split = sah_ok || sz > p.max_leaf;
            tbi[3 * p.GN + s] = split
                ? 1 | (sah_ok ? 2 : 0) | ((idx / kBins) << 2)
                      | ((idx % kBins + 1) << 4)
                : 0;
        }
    }
    grp.sync();  // the bins are reset by the next node
}

// ---- pass B: split a node whose decision says so, into the slots that
// the scan wrote to its row 2 (top_down_sah_builder.h:89-125).
template <class G>
__device__ void split(const G& grp, const Lanes& ln, const Params& p,
                      float* tbf, int* tbi, int s) {
    const long GN = p.GN;
    const int dec = tbi[3 * GN + s];
    if (!(dec & 1)) return;
    const Node n = load_node(tbf, tbi, GN, s);
    const int b = n.b, e = n.e, sz = e - b, r = grp.rank(), P = p.P;
    const bool sah_ok = dec & 2;
    const int best_axis = (dec >> 2) & 3, best_bin = (dec >> 4) & 15;
    float diag[kDim];
#pragma unroll
    for (int a = 0; a < kDim; ++a) diag[a] = __fsub_rn(n.mx[a], n.mn[a]);
    int largest = 0;
    float dl = diag[0];
#pragma unroll
    for (int a = 1; a < kDim; ++a)
        if (diag[a] > dl) {
            largest = a;
            dl = diag[a];
        }
    const float split_val = __fadd_rn(
        __fmul_rn(__fdiv_rn(diag[best_axis], (float)kBins), (float)best_bin),
        n.mn[best_axis]);
    const float* cen_s = ln.rows + best_axis * P;
    const float* cen_l = ln.rows + largest * P;

    int local = 0;
    for (int l = b + r; l < e; l += G::kSize)
        local += cen_s[ln.perm[l]] < split_val ? 1 : 0;
    const int count_left = grp.sum(local);
    const bool degenerate = sah_ok && (count_left == 0 || count_left == sz);
    const bool use_fb = !sah_ok || degenerate;
    const int half = (sz + 1) / 2;

    // median fallback (:118-126): the half-th smallest key by binary
    // search, then ties admitted in lane order
    int lo = 0, need = 0;
    if (use_fb) {
        lo = INT32_MIN;
        int hi = INT32_MAX;
        for (int it = 0; it < 33; ++it) {
            const int mk = (lo >> 1) + (hi >> 1) + (lo & hi & 1);
            int c = 0;
            for (int l = b + r; l < e; l += G::kSize)
                c += median_key(cen_l[ln.perm[l]]) <= mk ? 1 : 0;
            if (grp.sum(c) >= half) hi = mk; else lo = mk + 1;
        }
        int c = 0;
        for (int l = b + r; l < e; l += G::kSize)
            c += median_key(cen_l[ln.perm[l]]) < lo ? 1 : 0;
        need = half - grp.sum(c);
    }
    const int mid = b + (use_fb ? half : count_left);

    // stable partition of the permutation into the buffer, in tiles of
    // the group, and the two sides' boxes
    int k[4 * kDim];
#pragma unroll
    for (int i = 0; i < 4 * kDim; ++i)
        k[i] = (i % (2 * kDim)) < kDim ? fkey(big()) : fkey(-big());
    int carry_left = 0, carry_tie = 0;
    for (int t0 = b; t0 < e; t0 += G::kSize) {
        const int l = t0 + r;
        const bool in = l < e;
        const int x = in ? ln.perm[l] : 0;
        bool gl;
        if (use_fb) {
            const int key = in ? median_key(cen_l[x]) : 0;
            const bool tie = in && key == lo;
            int ties;
            const int tie_rank = carry_tie + grp.excl_scan(tie, ties);
            gl = in && (key < lo || (tie && tie_rank < need));
            carry_tie += ties;
        } else {
            gl = in && cen_s[x] < split_val;
        }
        int lefts;
        const int lrank = carry_left + grp.excl_scan(gl, lefts);
        if (in) {
            ln.buf[gl ? b + lrank : mid + (l - b - lrank)] = x;
            const int side = gl ? 0 : 2 * kDim;
#pragma unroll
            for (int a = 0; a < kDim; ++a) {
                const int kn = fkey(ln.rows[(kDim + a) * P + x]);
                const int kx = fkey(ln.rows[(2 * kDim + a) * P + x]);
                if (side == 0) {
                    k[a] = min(k[a], kn);
                    k[kDim + a] = max(k[kDim + a], kx);
                } else {
                    k[2 * kDim + a] = min(k[2 * kDim + a], kn);
                    k[3 * kDim + a] = max(k[3 * kDim + a], kx);
                }
            }
        }
        carry_left += lefts;
    }
    grp.sync();
    for (int l = b + r; l < e; l += G::kSize) ln.perm[l] = ln.buf[l];
    grp.reduce_keys(k);

    // child boxes, SATO order, slots (top_down_sah_builder.h:100-125)
    if (r == 0) {
        float cmn[2][kDim], cmx[2][kDim], area[2];
#pragma unroll
        for (int sd = 0; sd < 2; ++sd) {
#pragma unroll
            for (int a = 0; a < kDim; ++a) {
                cmn[sd][a] = fval(k[sd * 2 * kDim + a]);
                cmx[sd][a] = fval(k[sd * 2 * kDim + kDim + a]);
            }
            area[sd] = half_area(__fsub_rn(cmx[sd][0], cmn[sd][0]),
                                 __fsub_rn(cmx[sd][1], cmn[sd][1]),
                                 __fsub_rn(cmx[sd][2], cmn[sd][2]));
        }
        const bool swap = area[0] < area[1];
        const float anc = fminf(tbf[7 * GN + s], tbf[6 * GN + s]);
        const int cbase = tbi[2 * GN + s];
        const int cb[2] = {b, mid}, ce[2] = {mid, e};
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const int sd = swap ? 1 - c : c;  // c0 is side A unless swapped
            const int slot = cbase + c;
#pragma unroll
            for (int a = 0; a < kDim; ++a) {
                tbf[(2 * a) * GN + slot] = sd ? cmn[1][a] : cmn[0][a];
                tbf[(2 * a + 1) * GN + slot] = sd ? cmx[1][a] : cmx[0][a];
            }
            tbf[6 * GN + slot] = sd ? area[1] : area[0];
            tbf[7 * GN + slot] = anc;
            tbi[slot] = sd ? cb[1] : cb[0];
            tbi[GN + slot] = sd ? ce[1] : ce[0];
            tbi[2 * GN + slot] = -1;
        }
        tbi[3 * GN + s] = 0;
    }
    grp.sync();
}

// The next slot of [lb, le) for this warp to take, or -1.
__device__ __forceinline__ int next_slot(Shared& sh, int lb, int le) {
    int k = 0;
    if ((threadIdx.x & 31) == 0) k = atomicAdd(&sh.next, 1);
    k = __shfl_sync(kFull, k, 0) + lb;
    return k < le ? k : -1;
}

// One CTA per group. pf: [16, GP] rows (centres 0-2, bb_min 3-5,
// bb_max 6-8); nbf/nbi: [8, G*NCAP]; src: [G*P]; cnt: [G].
__global__ void __launch_bounds__(kThreads, kMinBlocks)
group_build_kernel(const float* __restrict__ pf, const int* __restrict__ sizes,
                   int P, int NCAP, int min_leaf, int max_leaf, int log_cluster,
                   float cost_ratio, float* __restrict__ nbf,
                   int* __restrict__ nbi, int* __restrict__ src_out,
                   int* __restrict__ cnt_out) {
    extern __shared__ float smem[];
    __shared__ Shared sh;
    float* rows = smem;                                   // [9][P]
    int* perm = reinterpret_cast<int*>(rows + kRows * P);  // [P]
    const Lanes ln{rows, perm, perm + P};

    const int g = blockIdx.x, tid = threadIdx.x;
    const long GP = (long)gridDim.x * P;
    const Params p{P, max_leaf, log_cluster, cost_ratio,
                   (long)gridDim.x * NCAP};
    const long GN = p.GN;
    const int size = sizes[g];
    float* tbf = nbf + (long)g * NCAP;  // row r of this group at r * GN
    int* tbi = nbi + (long)g * NCAP;

    for (int l = tid; l < P; l += kThreads) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
            rows[r * P + l] = pf[r * GP + (long)g * P + l];
        perm[l] = l;
    }
    for (int s = tid; s < NCAP; s += kThreads)
#pragma unroll
        for (int r = 0; r < 8; ++r) {
            tbf[r * GN + s] = 0.0f;
            tbi[r * GN + s] = r == 2 ? -1 : 0;
        }
    __syncthreads();

    // the root: bounds of lanes [0, size)
    {
        int k[4 * kDim];
#pragma unroll
        for (int i = 0; i < 4 * kDim; ++i)
            k[i] = (i % (2 * kDim)) < kDim ? fkey(big()) : fkey(-big());
        for (int l = tid; l < size; l += kThreads)
#pragma unroll
            for (int a = 0; a < kDim; ++a) {
                k[a] = min(k[a], fkey(rows[(kDim + a) * P + l]));
                k[kDim + a] = max(k[kDim + a], fkey(rows[(2 * kDim + a) * P + l]));
            }
        const CtaGroup cta{sh};
        cta.reduce_keys(k);
        if (tid == 0) {
            float d[kDim];
            for (int a = 0; a < kDim; ++a) {
                const float mn = fval(k[a]), mx = fval(k[kDim + a]);
                tbf[(2 * a) * GN] = mn;
                tbf[(2 * a + 1) * GN] = mx;
                d[a] = __fsub_rn(mx, mn);
            }
            tbf[6 * GN] = half_area(d[0], d[1], d[2]);
            tbf[7 * GN] = big();
            tbi[0] = 0;
            tbi[GN] = size;
            tbi[2 * GN] = size <= min_leaf ? -1 : 0;
        }
    }
    __syncthreads();

    const WarpGroup warp{};
    const CtaGroup cta{sh};
    int lb = 0, le = 1;  // the current level's slots
    while (lb < le) {
        // ---- pass A: warps take the small open nodes, the CTA the large
        if (tid == 0) {
            sh.next = 0;
            sh.nlarge = 0;
        }
        __syncthreads();
        for (int s; (s = next_slot(sh, lb, le)) >= 0;) {
            const int sz = tbi[GN + s] - tbi[s];
            if (sz <= min_leaf) continue;
            if (sz > kWarpMax) {
                if ((tid & 31) == 0) sh.large[atomicAdd(&sh.nlarge, 1)] = s;
                continue;
            }
            decide(warp, sh.bins[tid >> 5], ln, p, tbf, tbi, s);
        }
        __syncthreads();
        const int nlarge = sh.nlarge;
        for (int i = 0; i < nlarge; ++i)
            decide(cta, sh.bins[0], ln, p, tbf, tbi, sh.large[i]);

        // ---- scan: children of the level's splitting nodes, in slot
        // order, from the tail
        int carry = 0;
        for (int c0 = lb; c0 < le; c0 += kThreads) {
            const int s = c0 + tid;
            const int f = s < le ? tbi[3 * GN + s] & 1 : 0;
            int total;
            const int rank = carry + cta.excl_scan(f, total);
            if (s < le) tbi[2 * GN + s] = f ? le + 2 * rank : -1;
            carry += total;
        }

        // ---- pass B: split, warps and then the CTA
        if (tid == 0) sh.next = 0;
        __syncthreads();
        for (int s; (s = next_slot(sh, lb, le)) >= 0;) {
            const int sz = tbi[GN + s] - tbi[s];
            if (sz > min_leaf && sz <= kWarpMax) split(warp, ln, p, tbf, tbi, s);
        }
        __syncthreads();
        for (int i = 0; i < nlarge; ++i)
            split(cta, ln, p, tbf, tbi, sh.large[i]);
        __syncthreads();
        lb = le;
        le += 2 * carry;
    }

    for (int l = tid; l < P; l += kThreads) src_out[(long)g * P + l] = perm[l];
    if (tid == 0) cnt_out[g] = size > 0 ? le : 0;
}

int smem_bytes(int P) { return kSmemPerLane * P; }

}  // namespace

// pf [16, G*P] f32; sizes [G] i32; outputs nbf [8, G*NCAP] f32, nbi
// [8, G*NCAP] i32, src [G*P] i32, cnt [G] i32. Needs NCAP >= 2P - 1 and
// 44 * P bytes of dynamic shared memory. Returns cudaGetLastError()
// after the launch (or the error of the shared-memory opt-in).
extern "C" int bvh_group_build(const float* pf, const int* sizes, int G, int P,
                               int NCAP, int min_leaf, int max_leaf,
                               int log_cluster, float cost_ratio, float* nbf,
                               int* nbi, int* src, int* cnt, void* stream) {
    const int smem = smem_bytes(P);
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
// the opt-in limit less the kernel's static shared memory, over 44 bytes,
// and at most what the list of a level's large nodes can hold.
extern "C" int bvh_group_build_max_p(int* out) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&optin,
                                     cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, group_build_kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long by_smem = (optin - (long)attr.sharedSizeBytes) / kSmemPerLane;
    const long by_list = (long)kMaxLarge * (kWarpMax + 1) - 1;
    *out = static_cast<int>(by_smem < by_list ? by_smem : by_list);
    return 0;
}

// The CTAs of the group build that one SM holds at once at capacity P,
// from the kernel's registers, threads and shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int bvh_group_build_occupancy(int P, int* out) {
    const int smem = smem_bytes(P);
    cudaError_t err = cudaFuncSetAttribute(
        group_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            out, group_build_kernel, kThreads, smem);
    return static_cast<int>(err);
}
