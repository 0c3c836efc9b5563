// Whole binary-BVH traversal per ray (kernel B5) for Hopper.
//
// Replaces the Pallas kernel `_kernel` (bvh_tpu/traverse/pallas_kernel.py:93),
// launched from `_pallas_intersect_tris` (:351). Each ray walks the
// binary tree from the root word to the end in one launch: closest or
// any hit, fast or robust slab test, one primitive per leaf step, with
// per-ray counts of inner steps (nstat) and leaves entered (lstat).
//
// Layout: node pairs as rows, pair k = children (2k+1, 2k+2):
// node_b [P, 12] f32 (left box, right box, interleaved min/max) and
// node_w [P, 2] i32 (the children's index words, `first << 4 | count`;
// integers, so trees past 2^24 nodes keep exact words, where the TPU
// version carried them as f32); primitives by position in prim_ids order.
//
// What bounds it on the card: latency of dependent loads. A ray takes
// tens of steps, each a 48-byte pair row (or a 48-byte primitive row)
// that depends on the last; the tables are small next to the 50 MB L2
// at the scenes the CLI routes here. The design gives each ray one
// thread and relies on many resident warps to hide that latency; the
// TPU's VMEM caps (2,048 nodes and prims) are gone, so the kernel takes
// a tree of any size. The leaf test is a template parameter (triangles
// now; spheres with kernel B6).
//
// Exactness: the state machine of `_kernel` (:184-280) step for step:
// leaf step, then inner step with near/far order by entry t for closest
// hit and left first for any hit, then pop; robust_max/robust_min fold
// the slab planes (node.h:105-117). Where the reference's shift stack
// silently drops its bottom entry on a push at `sp == stack_depth`
// (:253-262), this kernel drops it too and sets a sticky overflow flag
// that the wrapper turns into an error (ROADMAP C8).

#include "slab.cuh"

namespace {

constexpr int kBinaryStackMax = BVH_BINARY_STACK_MAX;  // set by kernels.py

// Möller–Trumbore on one triangle row p0|e1|e2|n (tri.h:56-74), every
// operation rounded on its own, as the plain version computes it.
struct TriLeaf {
    const float* tris;  // [M, 12]

    __device__ __forceinline__ bool test(int pos, const bvh::RayInv& r,
                                         float tmin, float tmax, float& t,
                                         float& u, float& v) const {
        const float* q = tris + static_cast<size_t>(pos) * 12;
        float p0[3], e1[3], e2[3], n[3], c[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            p0[i] = __ldg(q + i);
            e1[i] = __ldg(q + 3 + i);
            e2[i] = __ldg(q + 6 + i);
            n[i] = __ldg(q + 9 + i);
            c[i] = __fsub_rn(p0[i], r.org[i]);
        }
        const float* d = r.dir;
        const float rv[3] = {
            __fsub_rn(__fmul_rn(d[1], c[2]), __fmul_rn(d[2], c[1])),
            __fsub_rn(__fmul_rn(d[2], c[0]), __fmul_rn(d[0], c[2])),
            __fsub_rn(__fmul_rn(d[0], c[1]), __fmul_rn(d[1], c[0]))};
        auto dot = [](const float* a, const float* b) {
            return __fadd_rn(__fadd_rn(__fmul_rn(a[0], b[0]),
                                       __fmul_rn(a[1], b[1])),
                             __fmul_rn(a[2], b[2]));
        };
        const float inv_det = __fdiv_rn(1.0f, dot(n, d));
        u = __fmul_rn(dot(rv, e2), inv_det);
        v = __fmul_rn(dot(rv, e1), inv_det);
        const float w = __fsub_rn(__fsub_rn(1.0f, u), v);
        t = __fmul_rn(dot(n, c), inv_det);
        const float tol = -bvh::kEps;
        return u >= tol && v >= tol && w >= tol && t >= tmin && t <= tmax;
    }
};

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

template <class Leaf, bool AnyHit>
__global__ void binary_traverse_kernel(const float* __restrict__ node_b,
                                       const int* __restrict__ node_w,
                                       Leaf leaf,
                                       const float* __restrict__ rays, int R,
                                       int root_word, bool robust,
                                       int stack_depth,
                                       float* __restrict__ out_f,
                                       int* __restrict__ out_i) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    float o[3], d[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        o[i] = rays[i * R + r];
        d[i] = rays[(3 + i) * R + r];
    }
    const float tmin = rays[6 * R + r];
    float tmax = rays[7 * R + r];
    const bvh::RayInv ray = bvh::make_ray_inv(o, d, robust);

    int stack[kBinaryStackMax];
    int sp = 0, top = root_word, leaf_cur = 0, leaf_rem = 0;
    int best_pos = -1, nstat = 0, lstat = 0, ovf = 0;
    float best_t = __int_as_float(0x7f800000), best_u = 0.0f, best_v = 0.0f;
    bool active = tmin <= tmax;

    while (active) {
        bool need_pop = false;
        if (leaf_rem > 0) {
            // leaf step: one primitive
            float t, u, v;
            const bool hit = leaf.test(leaf_cur, ray, tmin, tmax, t, u, v);
            if (hit) {
                best_t = t;
                best_u = u;
                best_v = v;
                best_pos = leaf_cur;
                if (!AnyHit) tmax = t;
            }
            ++leaf_cur;
            --leaf_rem;
            if (AnyHit && hit) break;
            need_pop = leaf_rem == 0;
        } else if ((top & 15) != 0) {
            // enter a leaf
            ++lstat;
            leaf_cur = top >> 4;
            leaf_rem = top & 15;
        } else {
            // inner step: both children of the current node
            ++nstat;
            const int k = (top >> 4) >> 1;
            const float4* row4 = reinterpret_cast<const float4*>(node_b) + 3 * k;
            float row[12];
#pragma unroll
            for (int i = 0; i < 3; ++i) {
                const float4 q = __ldg(row4 + i);
                row[4 * i] = q.x;
                row[4 * i + 1] = q.y;
                row[4 * i + 2] = q.z;
                row[4 * i + 3] = q.w;
            }
            const int2 w = __ldg(reinterpret_cast<const int2*>(node_w) + k);
            float tl0, tl1, tr0, tr1;
            slab(ray, row, tmin, tmax, robust, tl0, tl1);
            slab(ray, row + 6, tmin, tmax, robust, tr0, tr1);
            const bool hit_l = tl0 <= tl1, hit_r = tr0 <= tr1;
            if (hit_l && hit_r) {
                const bool swap = !AnyHit && tl0 > tr0;
                top = swap ? w.y : w.x;
                const int far = swap ? w.x : w.y;
                if (sp < stack_depth) {
                    stack[sp++] = far;
                } else {
                    for (int i = 0; i + 1 < stack_depth; ++i)
                        stack[i] = stack[i + 1];
                    stack[stack_depth - 1] = far;
                    ovf = 1;
                }
            } else if (hit_l) {
                top = w.x;
            } else if (hit_r) {
                top = w.y;
            } else {
                need_pop = true;
            }
        }
        if (need_pop) {
            if (sp > 0)
                top = stack[--sp];
            else
                active = false;
        }
    }
    out_f[r] = best_t;
    out_f[R + r] = best_u;
    out_f[2 * R + r] = best_v;
    out_i[r] = best_pos;
    out_i[R + r] = nstat;
    out_i[2 * R + r] = lstat;
    out_i[3 * R + r] = ovf;
}

}  // namespace

// node_b [P, 12] f32, node_w [P, 2] i32, tris [M, 12] f32 by position,
// rays [8, R] f32 (org, dir, tmin, tmax); outputs out_f [3, R] f32
// (t, u, v; t = +inf on a miss) and out_i [4, R] i32 (position or -1,
// nstat, lstat, stack overflow). Returns cudaGetLastError().
extern "C" int bvh_binary_traverse_tris(const float* node_b, const int* node_w,
                                        const float* tris, const float* rays,
                                        int R, int root_word, int any_hit,
                                        int robust, int stack_depth,
                                        float* out_f, int* out_i,
                                        void* stream) {
    if (R > 0) {
        const int block = 128;
        const int grid = (R + block - 1) / block;
        const cudaStream_t s = static_cast<cudaStream_t>(stream);
        const TriLeaf leaf{tris};
        if (any_hit)
            binary_traverse_kernel<TriLeaf, true><<<grid, block, 0, s>>>(
                node_b, node_w, leaf, rays, R, root_word, robust != 0,
                stack_depth, out_f, out_i);
        else
            binary_traverse_kernel<TriLeaf, false><<<grid, block, 0, s>>>(
                node_b, node_w, leaf, rays, R, root_word, robust != 0,
                stack_depth, out_f, out_i);
    }
    return static_cast<int>(cudaGetLastError());
}
