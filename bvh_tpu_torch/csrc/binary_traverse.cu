// Whole binary-BVH traversal per ray for Hopper: kernel B5 (triangle
// leaves, 3D) and kernel B6 (sphere leaves, 2D, 3D and 4D).
//
// B5 replaces the Pallas kernel `_kernel`
// (bvh_tpu/traverse/pallas_kernel.py:93), launched from
// `_pallas_intersect_tris` (:351); B6 replaces `_kernel`
// (bvh_tpu/traverse/pallas_sphere.py:88), launched from
// `_pallas_intersect_spheres` (:381). Each ray walks the binary tree
// from the root word to the end in one launch: closest or any hit, fast
// or robust slab test, one primitive per leaf step, with per-ray counts
// of inner steps (nstat) and leaves entered (lstat). One kernel template
// over <Dim, Leaf, AnyHit> serves both.
//
// Layout: node pairs as rows, pair k = children (2k+1, 2k+2):
// node_b [P, 4*Dim] f32 (left box, right box, interleaved min/max) and
// node_w [P, 2] i32 (the children's index words, `first << 4 | count`;
// integers, so trees past 2^24 nodes keep exact words, where the TPU
// versions carried them as f32); primitives by position in prim_ids
// order: triangles [M, 12] (p0|e1|e2|n), spheres [M, Dim+1] (centre,
// radius). Rays [2*Dim+2, R] f32 (org, dir, tmin, tmax).
//
// What bounds it on the card: latency of dependent loads. A ray takes
// tens of steps, each a 16*Dim-byte pair row (or a primitive row) that
// depends on the last; the tables of the scenes run here sit in the
// 50 MB L2. The design gives each ray one thread and relies on many
// resident warps to hide that latency; the TPU's VMEM caps (2,048 nodes
// and prims) are gone, so the kernel takes a tree of any size.
//
// Exactness: the state machine of the Pallas kernels step for step:
// leaf step, then inner step with near/far order by entry t for closest
// hit and left first for any hit, then pop; robust_max/robust_min fold
// the slab planes (node.h:105-117) and clamp the sphere's roots. Where
// the reference's shift stacks silently drop their bottom entry on a
// push at `sp == stack_depth` (pallas_kernel.py:253-262,
// pallas_sphere.py:229-231), this kernel drops it too and sets a sticky
// overflow flag that the wrapper turns into an error (ROADMAP C8, C12).

#include "slab.cuh"

namespace {

constexpr int kBinaryStackMax = BVH_BINARY_STACK_MAX;  // set by kernels.py

// Möller–Trumbore on one triangle row p0|e1|e2|n (tri.h:56-74), every
// operation rounded on its own, as the plain version computes it.
struct TriLeaf {
    const float* tris;  // [M, 12]

    __device__ __forceinline__ bool test(int pos, const bvh::RayInvN<3>& r,
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

// The quadratic test of one sphere row centre|radius (sphere.h:31-49),
// every operation rounded on its own in the plain version's order
// (geom/sphere.py): dot products accumulated left to right, then
// c = -r*r + oc.oc and delta = b*b - (4a)*c.
template <int Dim>
struct SphereLeaf {
    const float* sph;  // [M, Dim + 1]

    __device__ __forceinline__ bool test(int pos, const bvh::RayInvN<Dim>& r,
                                         float tmin, float tmax, float& t,
                                         float& u, float& v) const {
        const float* q = sph + static_cast<size_t>(pos) * (Dim + 1);
        float oc[Dim];
#pragma unroll
        for (int i = 0; i < Dim; ++i) oc[i] = __fsub_rn(r.org[i], __ldg(q + i));
        const float rad = __ldg(q + Dim);
        float a = __fmul_rn(r.dir[0], r.dir[0]);
        float bh = __fmul_rn(r.dir[0], oc[0]);
        float cc = __fmul_rn(oc[0], oc[0]);
#pragma unroll
        for (int i = 1; i < Dim; ++i) {
            a = __fadd_rn(__fmul_rn(r.dir[i], r.dir[i]), a);
            bh = __fadd_rn(__fmul_rn(r.dir[i], oc[i]), bh);
            cc = __fadd_rn(__fmul_rn(oc[i], oc[i]), cc);
        }
        const float b = __fmul_rn(2.0f, bh);
        const float c = __fadd_rn(__fmul_rn(-rad, rad), cc);
        const float delta =
            __fadd_rn(__fmul_rn(b, b), -__fmul_rn(__fmul_rn(4.0f, a), c));
        const float inv = __fdiv_rn(-0.5f, a);
        // max(delta, 0) as the plain version writes it: NaN and -0 pass
        const float sq = __fsqrt_rn(delta < 0.0f ? 0.0f : delta);
        const float t0 = bvh::robust_max(__fmul_rn(__fadd_rn(b, sq), inv), tmin);
        const float t1 = bvh::robust_min(__fmul_rn(__fsub_rn(b, sq), inv), tmax);
        t = t0;
        u = t0;
        v = t1;
        return delta >= 0.0f && t0 <= t1;
    }
};

template <int Dim>
__device__ __forceinline__ void slab(const bvh::RayInvN<Dim>& r,
                                     const float* b, float tmin, float tmax,
                                     bool robust, float& t0, float& t1) {
    t0 = tmin;
    t1 = tmax;
#pragma unroll
    for (int i = 0; i < Dim; ++i) {
        float tn, tf;
        bvh::slab_axis(r, i, b[2 * i], b[2 * i + 1], robust, tn, tf);
        t0 = bvh::robust_max(tn, t0);
        t1 = bvh::robust_min(tf, t1);
    }
}

template <int Dim, class Leaf, bool AnyHit>
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
    float o[Dim], d[Dim];
#pragma unroll
    for (int i = 0; i < Dim; ++i) {
        o[i] = rays[i * R + r];
        d[i] = rays[(Dim + i) * R + r];
    }
    const float tmin = rays[2 * Dim * R + r];
    float tmax = rays[(2 * Dim + 1) * R + r];
    const bvh::RayInvN<Dim> ray = bvh::make_ray_inv(o, d, robust);

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
            const float4* row4 = reinterpret_cast<const float4*>(node_b) + Dim * k;
            float row[4 * Dim];
#pragma unroll
            for (int i = 0; i < Dim; ++i) {
                const float4 q = __ldg(row4 + i);
                row[4 * i] = q.x;
                row[4 * i + 1] = q.y;
                row[4 * i + 2] = q.z;
                row[4 * i + 3] = q.w;
            }
            const int2 w = __ldg(reinterpret_cast<const int2*>(node_w) + k);
            float tl0, tl1, tr0, tr1;
            slab(ray, row, tmin, tmax, robust, tl0, tl1);
            slab(ray, row + 2 * Dim, tmin, tmax, robust, tr0, tr1);
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

template <int Dim, class Leaf>
void launch(const float* node_b, const int* node_w, Leaf leaf,
            const float* rays, int R, int root_word, int any_hit, int robust,
            int stack_depth, float* out_f, int* out_i, void* stream) {
    if (R <= 0) return;
    const int block = 128;
    const int grid = (R + block - 1) / block;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (any_hit)
        binary_traverse_kernel<Dim, Leaf, true><<<grid, block, 0, s>>>(
            node_b, node_w, leaf, rays, R, root_word, robust != 0,
            stack_depth, out_f, out_i);
    else
        binary_traverse_kernel<Dim, Leaf, false><<<grid, block, 0, s>>>(
            node_b, node_w, leaf, rays, R, root_word, robust != 0,
            stack_depth, out_f, out_i);
}

}  // namespace

// Kernel B5. node_b [P, 12] f32, node_w [P, 2] i32, tris [M, 12] f32 by
// position, rays [8, R] f32 (org, dir, tmin, tmax); outputs out_f [3, R]
// f32 (t, u, v; t = +inf on a miss) and out_i [4, R] i32 (position or
// -1, nstat, lstat, stack overflow). Returns cudaGetLastError().
extern "C" int bvh_binary_traverse_tris(const float* node_b, const int* node_w,
                                        const float* tris, const float* rays,
                                        int R, int root_word, int any_hit,
                                        int robust, int stack_depth,
                                        float* out_f, int* out_i,
                                        void* stream) {
    launch<3>(node_b, node_w, TriLeaf{tris}, rays, R, root_word, any_hit,
              robust, stack_depth, out_f, out_i, stream);
    return static_cast<int>(cudaGetLastError());
}

// Kernel B6, dim 2, 3 or 4. node_b [P, 4*dim] f32, node_w [P, 2] i32,
// sph [M, dim+1] f32 by position, rays [2*dim+2, R] f32; outputs as
// B5's, with t = u = the entry distance t0 and v = the exit distance t1.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for another dim.
extern "C" int bvh_binary_traverse_spheres(int dim, const float* node_b,
                                           const int* node_w, const float* sph,
                                           const float* rays, int R,
                                           int root_word, int any_hit,
                                           int robust, int stack_depth,
                                           float* out_f, int* out_i,
                                           void* stream) {
    switch (dim) {
        case 2:
            launch<2>(node_b, node_w, SphereLeaf<2>{sph}, rays, R, root_word,
                      any_hit, robust, stack_depth, out_f, out_i, stream);
            break;
        case 3:
            launch<3>(node_b, node_w, SphereLeaf<3>{sph}, rays, R, root_word,
                      any_hit, robust, stack_depth, out_f, out_i, stream);
            break;
        case 4:
            launch<4>(node_b, node_w, SphereLeaf<4>{sph}, rays, R, root_word,
                      any_hit, robust, stack_depth, out_f, out_i, stream);
            break;
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
