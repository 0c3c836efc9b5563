// The binary portal-collect walk, shared by phase A (kernel B2), phase
// A2's rounds (kernel B4, csrc/collect.cu) and phase A2 in one launch
// (the super walk, csrc/super_walk.cu): one node step over a pair row,
// and B4's whole walk of one (ray, super) pair.
//
// Exactness: the slab arithmetic, the robust/fast inverse and its 2-ulp
// pad, near-first descent with `swap = tl0 > tr0`, and the root-is-portal
// case follow the references step for step. The planes fold with each
// reference's own min/max: NaN-swallowing robust_max/min in B2
// (bvh_tpu/traverse/collect.py:117-118), NaN-propagating
// jnp.maximum/minimum in B4 (bvh_tpu/traverse/wide_treelet.py:1200-1201,
// ROADMAP C6, C10). Unlike the references (B2 does not clamp `sp` on a
// push, ROADMAP C3; B4 clamps it silently, C9), a push onto a full stack
// drops the bottom entry, keeps `sp` at the capacity and sets a sticky
// overflow flag; they agree whenever the stack is sized to the region's
// depth + 1.
#pragma once

#include "slab.cuh"

namespace bvh {

constexpr int kTopStackMax = BVH_TOP_STACK_MAX;  // set by kernels.py

// jnp.maximum / jnp.minimum for B4 in three instructions each, where
// nan_max and nan_min take five: NaN in either operand yields NaN, here
// with the payload of the operand it came from. No NaN distance reaches
// B4's outputs: a pair records only a box it hits, whose entry distance
// is a number, and a NaN fails every comparison either way.
__device__ __forceinline__ float max_nan(float a, float b) {
    return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
    return (a < b || a != a) ? a : b;
}

template <bool NanMinMax>
__device__ __forceinline__ void collect_slab(const RayInv& r, const float* b,
                                             float tmin, float tmax,
                                             bool robust, float& t0,
                                             float& t1) {
    t0 = tmin;
    t1 = tmax;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        float tn, tf;
        slab_axis(r, i, b[2 * i], b[2 * i + 1], robust, tn, tf);
        t0 = NanMinMax ? max_nan(tn, t0) : robust_max(tn, t0);
        t1 = NanMinMax ? min_nan(tf, t1) : robust_min(tf, t1);
    }
}

// One node step of the collect walk, B2's and B4's: the slab tests of
// both children of the pair row `row` (boxes in 0-11, the index words as
// f32 in 12-13), a portal child that the ray enters recorded (left
// first), then descent near-first with the far child pushed (a push onto
// a full stack drops the bottom entry and sets the sticky overflow
// flag). Returns whether it descended; if not, the caller pops.
template <bool NanMinMax, class Record>
__device__ __forceinline__ bool collect_step(const RayInv& ray,
                                             const float* row, float tmin,
                                             float tmax, bool robust,
                                             int* stack, int stack_depth,
                                             int& sp, int& top, int& ovf,
                                             Record&& record) {
    float tl0, tl1, tr0, tr1;
    collect_slab<NanMinMax>(ray, row, tmin, tmax, robust, tl0, tl1);
    collect_slab<NanMinMax>(ray, row + 6, tmin, tmax, robust, tr0, tr1);
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

// Kernel B4's walk of one (ray, super) pair over the super's rows
// `table` [Ps, 16] (a pair's 14 floats and 2 of padding: four 16-byte
// loads from one address a step) from root word 1 << 4, calling
// `record(word, t)` for every treelet portal the ray enters, in walk
// order. A word it descends to is never a portal (portals are recorded,
// not entered), so the walk has no root-is-portal step. Returns the
// stack high-water mark; `ovf` is set by a push onto a full stack.
template <bool Robust, class Record>
__device__ __forceinline__ int walk_super(const float4* __restrict__ table,
                                          const RayInv& ray, float tmin,
                                          float tmax, int stack_depth,
                                          int& ovf, Record&& record) {
    int stack[kTopStackMax];
    int sp = 0, top = 1 << 4, hwm = 0;
    bool active = tmin <= tmax;
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
    return hwm;
}

}  // namespace bvh
