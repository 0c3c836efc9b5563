// Binary portal collect for Hopper: phase A (kernel B2) and phase A2
// (kernel B4).
//
// B2 replaces the Pallas kernel `collect_kernel`
// (bvh_tpu/traverse/collect.py:25), launched from `_render_jit`
// (bvh_tpu/traverse/wide_treelet.py:1505-1532). For each ray it walks
// the binary top region of the tree, stored as a [16, Pt] f32 pair
// table (rows 0-5 left child bounds, 6-11 right child bounds, 12-13
// the children's index words as f32), and records every portal (a
// treelet root, word = tid << 4 | 1) whose box the ray enters, with its
// entry distance, up to `max_portals`. The count goes on counting past
// the cap so that an overflow is exact. One thread takes one ray: a
// step reads one 14-float column of a table that is a few tens of KB
// and stays in L1/L2, and does two slab tests; records are written at
// [k, r], so writes coalesce across the threads of a warp. The TPU
// version fetched the column with a one-hot matrix product because
// Mosaic cannot gather per lane; here a column is an ordinary load.
//
// B4 replaces the Pallas kernels `_sup_kernel_pair`/`_sup_kernel_dma`
// (bvh_tpu/traverse/wide_treelet.py:1283-1330, launched from
// `_phase_a2` :1333), whose body is `_collect_core` (:1158): the same
// walk per (ray, super) pair, over that super's mid-region pair table
// from root word 1 << 4, recording treelet portals up to `max_new`. The
// TPU version scheduled pairs in 128-lane runs per super with DMA
// windows. Here the super tables are `WideTreelets.sup_cols` [S, Ps, 16]
// f32, a pair's 14 floats in one 64-byte row, and the kernel
// (`collect_pairs_kernel<Robust>`) takes one lane a pair, a warp 32
// neighbouring pairs (`expand_supers` sorts them by super, so a warp
// reads one super's rows):
// - One row a step: four 16-byte loads from one address, where the
//   kernel this replaced read 14 scalars Ps floats apart (14 sectors a
//   step) from the [S, 16, Ps] layout.
// - Each output slot written once: records as the walk makes them, then
//   -1 and +inf into each lane's unused slots [pcnt, max_new), slot by
//   slot across the warp once its lanes are done, so that those writes
//   coalesce (the kernel this replaced wrote every slot first and the
//   recorded ones again). The outputs, 2 x max_new x 4 bytes a pair, are
//   most of B4's bytes.
// - Fewer instructions a step: the robust or fast slab test is a
//   template argument, and the NaN-propagating fold takes three
//   instructions a plane where bvh::nan_max takes five.
// What bounds it on the card: at the San-Miguel-class scene's first A2
// round (118,456 pairs) the launch is a single wave of about 28 warps
// an SM, so its time is that of the warps with the longest walks (82
// steps), each step a load that waits on the step before and about a
// hundred instructions; the bytes would take a sixth of it. On an H100
// 80GB HBM3 at 700 W this kernel took 0.067-0.070 ms where the kernel
// this replaced took 0.075 in the same calls. Tried there and dropped
// (tools/compare_checkouts.py, PERF.md): persistent warps that refill
// idle lanes from a work counter, each lane filling its unused slots as
// its pair ends (0.118-0.120 ms: those writes no longer coalesce, and
// the wave already holds every pair), and the same with every slot
// written when a lane takes its pair (0.076).
//
// Exactness: the slab arithmetic, the robust/fast inverse and its
// 2-ulp pad, near-first descent with `swap = tl0 > tr0`, and the
// root-is-portal case follow the references step for step. The planes
// fold with each reference's own min/max: NaN-swallowing
// robust_max/min in B2 (collect.py:117-118), NaN-propagating
// jnp.maximum/minimum in B4 (wide_treelet.py:1200-1201, ROADMAP C6, C10).
// Unlike the references (B2 does not clamp `sp` on a push, ROADMAP C3;
// B4 clamps it silently, C9), a push onto a full stack drops the
// bottom entry, keeps `sp` at the capacity and sets a sticky overflow
// flag; they agree whenever the stack is sized to the region's depth
// + 1.

#include "slab.cuh"

namespace {

constexpr int kTopStackMax = BVH_TOP_STACK_MAX;  // set by kernels.py

// jnp.maximum / jnp.minimum for B4 in three instructions each, where
// bvh::nan_max and nan_min take five: NaN in either operand yields NaN,
// here with the payload of the operand it came from. No NaN distance
// reaches B4's outputs: a pair records only a box it hits, whose entry
// distance is a number, and a NaN fails every comparison either way.
__device__ __forceinline__ float max_nan(float a, float b) {
    return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
    return (a < b || a != a) ? a : b;
}

template <bool NanMinMax>
__device__ __forceinline__ void slab(const bvh::RayInv& r, const float* b,
                                     float tmin, float tmax, bool robust,
                                     float& t0, float& t1) {
    t0 = tmin;
    t1 = tmax;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        float tn, tf;
        bvh::slab_axis(r, i, b[2 * i], b[2 * i + 1], robust, tn, tf);
        t0 = NanMinMax ? max_nan(tn, t0) : bvh::robust_max(tn, t0);
        t1 = NanMinMax ? min_nan(tf, t1) : bvh::robust_min(tf, t1);
    }
}

// One node step of the collect walk, B2's and B4's: the slab tests of
// both children of the pair row `row` (boxes in 0-11, the index words as
// f32 in 12-13), a portal child that the ray enters recorded (left
// first), then descent near-first with the far child pushed (a push onto
// a full stack drops the bottom entry and sets the sticky overflow
// flag). Returns whether it descended; if not, the caller pops.
template <bool NanMinMax, class Record>
__device__ __forceinline__ bool collect_step(const bvh::RayInv& ray,
                                             const float* row, float tmin,
                                             float tmax, bool robust,
                                             int* stack, int stack_depth,
                                             int& sp, int& top, int& ovf,
                                             Record&& record) {
    float tl0, tl1, tr0, tr1;
    slab<NanMinMax>(ray, row, tmin, tmax, robust, tl0, tl1);
    slab<NanMinMax>(ray, row + 6, tmin, tmax, robust, tr0, tr1);
    const int idx_l = static_cast<int>(row[12]);
    const int idx_r = static_cast<int>(row[13]);
    const bool hit_l = tl0 <= tl1, hit_r = tr0 <= tr1;
    const bool leaf_l = (idx_l & 15) != 0, leaf_r = (idx_r & 15) != 0;
    if (hit_l && leaf_l) record(idx_l, tl0);
    if (hit_r && leaf_r) record(idx_r, tr0);
    const bool dl = hit_l && !leaf_l, dr = hit_r && !leaf_r;
    if (dl && dr) {
        const bool swap = tl0 > tr0;
        top = swap ? idx_r : idx_l;
        const int far = swap ? idx_l : idx_r;
        if (sp < stack_depth) {
            stack[sp++] = far;
        } else {
            for (int k = 0; k + 1 < stack_depth; ++k) stack[k] = stack[k + 1];
            stack[stack_depth - 1] = far;
            ovf = 1;
        }
    } else if (dl || dr) {
        top = dl ? idx_l : idx_r;
    }
    return dl || dr;
}

// B2's walk of one ray (lane r of R) over one pair table; records go to
// ptid/ptent [max_portals, R], stats [3, R] (count, stack high-water
// mark, overflow).
__device__ void collect_walk(const float* __restrict__ table, int Pt,
                             const float* __restrict__ rays, int R, int r,
                             int root_word, bool robust, int stack_depth,
                             int max_portals, int* __restrict__ ptid,
                             float* __restrict__ ptent,
                             int* __restrict__ stats) {
    float o[3], d[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        o[i] = rays[i * R + r];
        d[i] = rays[(3 + i) * R + r];
    }
    const float tmin = rays[6 * R + r];
    const float tmax = rays[7 * R + r];
    const bvh::RayInv ray = bvh::make_ray_inv(o, d, robust);

    for (int k = 0; k < max_portals; ++k) {
        ptid[k * R + r] = -1;
        ptent[k * R + r] = __int_as_float(0x7f800000);  // +inf
    }

    int stack[kTopStackMax];
    int sp = 0, top = root_word, pcnt = 0, hwm = 0, ovf = 0;
    bool active = tmin <= tmax;
    auto record = [&](int word, float t) {
        if (pcnt < max_portals) {
            ptid[pcnt * R + r] = word >> 4;
            ptent[pcnt * R + r] = t;
        }
        ++pcnt;
    };

    while (active) {
        bool descend = false;
        if ((top & 15) != 0) {
            // a portal handed down as the top word (single-treelet
            // scenes): record it at t = tmin
            record(top, tmin);
        } else {
            const int col = (top >> 4) >> 1;
            float row[14];
#pragma unroll
            for (int i = 0; i < 14; ++i) row[i] = __ldg(table + i * Pt + col);
            descend = collect_step<false>(ray, row, tmin, tmax, robust, stack,
                                          stack_depth, sp, top, ovf, record);
        }
        hwm = max(hwm, sp);
        if (!descend) {
            if (sp > 0)
                top = stack[--sp];
            else
                active = false;
        }
    }
    stats[r] = pcnt;
    stats[R + r] = hwm;
    stats[2 * R + r] = ovf;
}

__global__ void collect_kernel(const float* __restrict__ table, int Pt,
                               const float* __restrict__ rays, int R,
                               int root_word, bool robust, int stack_depth,
                               int max_portals, int* __restrict__ ptid,
                               float* __restrict__ ptent,
                               int* __restrict__ stats) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    collect_walk(table, Pt, rays, R, r, root_word, robust, stack_depth,
                 max_portals, ptid, ptent, stats);
}

// B4's launch: threads a block and the CTAs an SM its registers must
// allow.
constexpr int kA2Block = 128;
constexpr int kA2MinBlocks = 8;

// Kernel B4: the walk of pair i (one lane a pair, a warp 32 neighbouring
// pairs, which `expand_supers` sorts by super) over its super's rows
// sup_cols[sid[i]] [Ps, 16] from root word 1 << 4. A word it descends to
// is never a portal (portals are recorded, not entered), so the walk has
// no root-is-portal step. Records go to their slots as the walk makes
// them; once the warp's lanes are done, each lane's unused slots
// [pcnt, max_new) get -1 and +inf, slot by slot across the warp, so that
// those writes coalesce.
template <bool Robust>
__global__ void __launch_bounds__(kA2Block, kA2MinBlocks)
collect_pairs_kernel(const float4* __restrict__ sup_cols, int Ps,
                     const int* __restrict__ sid,
                     const float* __restrict__ rays, int L, int stack_depth,
                     int max_new, int* __restrict__ ntid,
                     float* __restrict__ nt, int* __restrict__ stats) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= L) return;
    float o[3], d[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        o[a] = rays[a * L + i];
        d[a] = rays[(3 + a) * L + i];
    }
    const float tmin = rays[6 * L + i];
    const float tmax = rays[7 * L + i];
    const bvh::RayInv ray = bvh::make_ray_inv(o, d, Robust);
    const float4* table = sup_cols + static_cast<size_t>(sid[i]) * Ps * 4;

    int stack[kTopStackMax];
    int sp = 0, top = 1 << 4, pcnt = 0, hwm = 0, ovf = 0;
    bool active = tmin <= tmax;
    auto record = [&](int word, float t) {
        if (pcnt < max_new) {
            ntid[pcnt * L + i] = word >> 4;
            nt[pcnt * L + i] = t;
        }
        ++pcnt;
    };

    while (active) {
        // one node step: both children of the pair at `top`, one row
        const float4* p = table + static_cast<size_t>((top >> 4) >> 1) * 4;
        float row[16];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
            const float4 q = __ldg(p + v);
            row[4 * v] = q.x;
            row[4 * v + 1] = q.y;
            row[4 * v + 2] = q.z;
            row[4 * v + 3] = q.w;
        }
        const bool descend = collect_step<true>(ray, row, tmin, tmax, Robust,
                                                stack, stack_depth, sp, top,
                                                ovf, record);
        hwm = max(hwm, sp);
        if (!descend) {
            if (sp > 0)
                top = stack[--sp];
            else
                active = false;
        }
    }
    // the unused slots, slot by slot: the warp's lanes write neighbouring
    // words of one slot row together
    for (int k = 0; k < max_new; ++k) {
        if (k >= pcnt) {
            ntid[k * L + i] = -1;
            nt[k * L + i] = __int_as_float(0x7f800000);  // +inf
        }
    }
    stats[i] = pcnt;
    stats[L + i] = hwm;
    stats[2 * L + i] = ovf;
}

}  // namespace

extern "C" const char* bvh_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// table [16, Pt] f32; rays [8, R] f32 (org, dir, tmin, tmax); outputs
// ptid [max_portals, R] i32, ptent [max_portals, R] f32 and
// stats [3, R] i32 (portal count, stack high-water mark, overflow).
// Returns cudaGetLastError() after the launch.
extern "C" int bvh_collect_portals(const float* table, int Pt,
                                   const float* rays, int R, int root_word,
                                   int robust, int stack_depth,
                                   int max_portals, int* ptid, float* ptent,
                                   int* stats, void* stream) {
    if (R > 0) {
        const int block = 128;
        collect_kernel<<<(R + block - 1) / block, block, 0,
                         static_cast<cudaStream_t>(stream)>>>(
            table, Pt, rays, R, root_word, robust != 0, stack_depth,
            max_portals, ptid, ptent, stats);
    }
    return static_cast<int>(cudaGetLastError());
}

// sup_cols [S, Ps, 16] f32, 16-byte aligned (a pair's rows 0-13 of the
// reference's [16, Ps] table, then padding); sid [L] i32, the super of
// each pair; rays [8, L] f32; outputs ntid [max_new, L] i32, nt
// [max_new, L] f32 and stats [3, L] i32 (recordable-portal count, stack
// high-water mark, overflow). Returns cudaGetLastError() after the launch.
extern "C" int bvh_collect_super_pairs(const float* sup_cols, int Ps,
                                       const int* sid, const float* rays,
                                       int L, int robust, int stack_depth,
                                       int max_new, int* ntid, float* nt,
                                       int* stats, void* stream) {
    if (L > 0) {
        const int grid = (L + kA2Block - 1) / kA2Block;
        const cudaStream_t s = static_cast<cudaStream_t>(stream);
        const float4* cols = reinterpret_cast<const float4*>(sup_cols);
        if (robust)
            collect_pairs_kernel<true><<<grid, kA2Block, 0, s>>>(
                cols, Ps, sid, rays, L, stack_depth, max_new, ntid, nt, stats);
        else
            collect_pairs_kernel<false><<<grid, kA2Block, 0, s>>>(
                cols, Ps, sid, rays, L, stack_depth, max_new, ntid, nt, stats);
    }
    return static_cast<int>(cudaGetLastError());
}
