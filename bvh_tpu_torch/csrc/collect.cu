// Phase-A portal collect (kernel B2) for Hopper.
//
// Replaces the Pallas kernel `collect_kernel`
// (bvh_tpu/traverse/collect.py:25), launched from `_render_jit`
// (bvh_tpu/traverse/wide_treelet.py:1505-1532). For each ray it walks
// the binary top region of the tree, stored as a [16, Pt] f32 pair
// table (rows 0-5 left child bounds, 6-11 right child bounds, 12-13
// the children's index words as f32), and records every portal (a
// treelet root, word = tid << 4 | 1) whose box the ray enters, with its
// entry distance, up to `max_portals`. The count goes on counting past
// the cap so that an overflow is exact.
//
// What bounds it on the card: latency of dependent loads. A step reads
// one 14-float column of a table that is a few tens of KB at sponza
// scale and stays in L1/L2, and does two slab tests; a ray takes tens
// of such steps, each waiting on the last. The design gives each ray
// one thread and relies on many resident warps to hide that latency;
// portal records are written at [k, r], so writes coalesce across the
// threads of a warp. The TPU version fetched the column with a one-hot
// matrix product because Mosaic cannot gather per lane; here a column
// is an ordinary load.
//
// Exactness: the slab arithmetic, the robust/fast inverse and its
// 2-ulp pad, NaN-swallowing robust_max/min, near-first descent with
// `swap = tl0 > tr0`, and the root-is-portal case follow the reference
// step for step. Unlike the reference (which does not clamp `sp` on a
// push, ROADMAP C3), a push onto a full stack drops the bottom entry,
// keeps `sp` at the capacity and sets a sticky overflow flag; the two
// agree whenever the stack is sized top_depth + 1.

#include "slab.cuh"

namespace {

constexpr int kTopStackMax = BVH_TOP_STACK_MAX;  // set by kernels.py

__device__ __forceinline__ void slab(const bvh::RayInv& r, const float* b,
                                     float tmin, float tmax, bool robust,
                                     float& t0, float& t1) {
    t0 = tmin;
    t1 = tmax;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        float tn, tf;
        bvh::slab_axis(r, i, b[2 * i], b[2 * i + 1], robust, tn, tf);
        t0 = bvh::robust_max(tn, t0);
        t1 = bvh::robust_min(tf, t1);
    }
}

__global__ void collect_kernel(const float* __restrict__ table, int Pt,
                               const float* __restrict__ rays, int R,
                               int root_word, bool robust, int stack_depth,
                               int max_portals, int* __restrict__ ptid,
                               float* __restrict__ ptent,
                               int* __restrict__ stats) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
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
            float tl0, tl1, tr0, tr1;
            slab(ray, row, tmin, tmax, robust, tl0, tl1);
            slab(ray, row + 6, tmin, tmax, robust, tr0, tr1);
            const int idx_l = static_cast<int>(row[12]);
            const int idx_r = static_cast<int>(row[13]);
            const bool hit_l = tl0 <= tl1, hit_r = tr0 <= tr1;
            const bool leaf_l = (idx_l & 15) != 0, leaf_r = (idx_r & 15) != 0;
            if (hit_l && leaf_l) record(idx_l, tl0);
            if (hit_r && leaf_r) record(idx_r, tr0);
            const bool dl = hit_l && !leaf_l, dr = hit_r && !leaf_r;
            descend = dl || dr;
            if (dl && dr) {
                const bool swap = tl0 > tr0;
                top = swap ? idx_r : idx_l;
                const int far = swap ? idx_l : idx_r;
                if (sp < stack_depth) {
                    stack[sp++] = far;
                } else {
                    for (int k = 0; k + 1 < stack_depth; ++k)
                        stack[k] = stack[k + 1];
                    stack[stack_depth - 1] = far;
                    ovf = 1;
                }
            } else if (descend) {
                top = dl ? idx_l : idx_r;
            }
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
