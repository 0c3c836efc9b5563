// Whole binary-BVH traversal per ray for Hopper: kernel B5 (triangle
// leaves, 3D) and kernel B6 (sphere leaves, 2D, 3D and 4D), one walk
// generic over its leaf.
//
// B5 replaces the Pallas kernel `_kernel`
// (bvh_tpu/traverse/pallas_kernel.py:93), launched from
// `_pallas_intersect_tris` (:351); B6 replaces `_kernel`
// (bvh_tpu/traverse/pallas_sphere.py:88), launched from
// `_pallas_intersect_spheres` (:381). Each ray walks the binary tree
// from the root word to the end in one launch: closest or any hit, fast
// or robust slab test, one primitive per leaf step, with per-ray counts
// of inner steps (nstat) and leaves entered (lstat).
//
// Both are `binary_traverse_kernel<Dim, Leaf, AnyHit, Robust, Stats>`:
// B5 its <3, TriLeaf> instances, B6 its <Dim, SphereLeaf<Dim>> ones.
// Tables, each 16-byte aligned, one row a step: node pairs as rows, pair
// k = children (2k+1, 2k+2), `pairs` [P, 4*(Dim+1)] f32 = left box,
// right box (interleaved min/max), the two children's index words as
// their int32 bits (`first << 4 | count`; integers, so trees past 2^24
// nodes keep exact words, where the TPU versions carried them as f32),
// zero padding: 48, 64 or 80 bytes, Dim + 1 16-byte loads from one
// address. Leaves by position in prim_ids order: a triangle row
// p0|e1|e2|n [M, 12] (48 bytes, three 16-byte loads), a sphere row
// centre and radius [M, 4] (2D, 3D) or [M, 8] (4D). Rays [2*Dim+2, R]
// f32 (org, dir, tmin, tmax).
//
// What bounds the walk on the card: the latency of each step's load,
// which depends on the step before (27, 39 and 128 inner steps a ray in
// 2D, 3D and 4D at phase 14's scale case, whose tables sit in the 50 MB
// L2), with the warps' lanes at different steps. The design:
// - One aligned row a step, above.
// - One step a lane an iteration: a node step or a primitive test, the
//   first test of a leaf entering it (the one-thread-a-ray kernel this
//   replaced spent an iteration on the entry), with no vote between
//   steps.
// - Persistent warps where the rays end at very different depths (B5,
//   B6 in 2D and 3D). Every kSteps steps a warp looks at its idle
//   lanes; once Leaf::kRefill are idle they take the next rays in
//   launch order from a work counter, and each ray's results go to its
//   own index. The grid is what the card holds at once. In 4D a warp
//   takes its 32 rays once and the grid covers the rays: on an H100 80GB
//   HBM3 at 700 W the refill saved 11% in 3D and cost 0.7% in 4D.
// - Fewer instructions a step: the fast or robust slab test is a
//   template argument, and the slab distances fold with fmaxf/fminf (one
//   instruction each): the running entry and exit distances start at
//   tmin and tmax and are never NaN, so a NaN plane is dropped as by
//   robust_max/robust_min; they are only compared, never stored, so the
//   sign of a zero does not matter.
// The stack stays a local array of BVH_BINARY_STACK_MAX words. Tried on
// the card for B6 and dropped: a while-while loop (Aila and Laine, HPG
// 2009: node steps until the warp's lanes are at leaves, then the
// leaves' tests), with or without exits for waiting lanes, since it ran
// the warps' lanes one kind of step at a time and lost in 2D and 4D; a
// vote between steps; the stack's top in a register; prefetching the
// pushed child's row; each CTA taking rays from its own share of the
// launch order; 10 or 12 CTAs an SM, and blocks of 256 (fewer registers
// a thread: slower). B5 on the 262K tree (1,048,576 primary rays, 9.3M
// inner steps, 0.72M triangle tests) took 0.212 ms where the
// one-thread-a-ray kernel took 0.219-0.221 in the same calls, and 0.243
// without the refill (H100 80GB HBM3, 700 W; tools/compare_checkouts.py);
// tried for B5 and dropped: 6 or 10 CTAs an SM, 8 or 32 steps between
// looks, refill at 16 idle lanes, the triangle's t tested before its u
// and v, and __frcp_rn for the reciprocal of the determinant.
// - A launch takes its work counter already zero, a slot of a ring that
//   is zeroed once a ring-full of launches has used it. On the H100
//   80GB HBM3 at 700 W (tools/compare_checkouts.py) a memset before
//   each launch cost 1.8-1.9 µs of device time (3% of the Cornell box's
//   0.06 ms), and the kernel's last warp resetting it, with an atomic a
//   warp on one address, cost 0.13 ms in 4D.
//
// Exactness: the state machine of the Pallas kernels step for step:
// leaf step, then inner step with near/far order by entry t for closest
// hit and left first for any hit, then pop; the triangle test is
// Möller–Trumbore with every operation rounded on its own, and the
// sphere's roots are clamped with robust_max/robust_min. The walk visits
// the same nodes and leaves in the same order as the reference's loop,
// so its outputs are those of the plain version bit for bit. Where the
// reference's shift stacks silently drop their bottom entry on a push at
// `sp == stack_depth` (pallas_kernel.py:253-262,
// pallas_sphere.py:229-231), the kernel drops it too and sets a sticky
// overflow flag that the wrapper turns into an error (ROADMAP C8, C12).

#include "slab.cuh"

namespace {

constexpr int kBinaryStackMax = BVH_BINARY_STACK_MAX;  // set by kernels.py

// The walk's launch: threads a block, the CTAs an SM its registers must
// allow, the steps a lane runs between two looks at its warp's idle
// lanes, and the bit pattern of +inf. Each leaf sets the idle lanes a
// warp waits for before it takes new rays (kRefill; 0: each warp takes
// 32 rays once and the grid covers the rays).
constexpr int kBlock = 128;
constexpr int kMinBlocks = 8;
constexpr int kSteps = 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kInfBits = 0x7f800000;

// Möller–Trumbore on one triangle row q = p0|e1|e2|n (tri.h:56-74), every
// operation rounded on its own, as the plain version computes it (63
// and 64 registers: 32 warps an SM). A warp refills once 24 lanes are
// idle.
struct TriLeaf {
    static constexpr int kVec = 3;
    static constexpr int kRefill = 24;

    __device__ static __forceinline__ bool test(const float* q,
                                                const bvh::RayInvN<3>& r,
                                                float tmin, float tmax,
                                                float& t, float& u, float& v) {
        float c[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) c[i] = __fsub_rn(q[i], r.org[i]);
        const float* e1 = q + 3;
        const float* e2 = q + 6;
        const float* n = q + 9;
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

// The quadratic test of one sphere, centre q[0, Dim) and radius q[Dim]
// (sphere.h:31-49), every operation rounded on its own in the plain
// version's order (geom/sphere.py): dot products accumulated left to
// right, then c = -r*r + oc.oc and delta = b*b - (4a)*c. A hit reports
// t = u = the entry distance t0 and v = the exit distance t1, clamped to
// [tmin, tmax] (48, 56 and 64 registers in 2D, 3D and 4D: 40, 36 and
// 32 warps an SM). Refill at 24 idle lanes in 2D and 3D, none in 4D.
template <int Dim>
struct SphereLeaf {
    static constexpr int kVec = Dim < 4 ? 1 : 2;
    static constexpr int kRefill = Dim < 4 ? 24 : 0;

    __device__ static __forceinline__ bool test(const float* q,
                                                const bvh::RayInvN<Dim>& r,
                                                float tmin, float tmax,
                                                float& t, float& u, float& v) {
        float oc[Dim];
#pragma unroll
        for (int i = 0; i < Dim; ++i) oc[i] = __fsub_rn(r.org[i], q[i]);
        const float rad = q[Dim];
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
        t = bvh::robust_max(__fmul_rn(__fadd_rn(b, sq), inv), tmin);
        v = bvh::robust_min(__fmul_rn(__fsub_rn(b, sq), inv), tmax);
        u = t;
        return delta >= 0.0f && t <= v;
    }
};

// float4s a pair row takes
template <int Dim>
constexpr int kPairVec = Dim + 1;

template <int N>
__device__ __forceinline__ void load_row(const float4* p, float (&row)[4 * N]) {
#pragma unroll
    for (int v = 0; v < N; ++v) {
        const float4 q = __ldg(p + v);
        row[4 * v] = q.x;
        row[4 * v + 1] = q.y;
        row[4 * v + 2] = q.z;
        row[4 * v + 3] = q.w;
    }
}

// Whether the ray enters box b (interleaved min/max) within [tmin, tmax],
// and its entry distance.
template <int Dim, bool Robust>
__device__ __forceinline__ bool box_hit(const bvh::RayInvN<Dim>& r,
                                        const float* b, float tmin,
                                        float tmax, float& t0) {
    float lo = tmin, hi = tmax;
#pragma unroll
    for (int i = 0; i < Dim; ++i) {
        float tn, tf;
        bvh::slab_axis(r, i, b[2 * i], b[2 * i + 1], Robust, tn, tf);
        lo = fmaxf(lo, tn);
        hi = fminf(hi, tf);
    }
    t0 = lo;
    return lo <= hi;
}

template <int Dim, class Leaf, bool AnyHit, bool Robust, bool Stats>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
binary_traverse_kernel(const float4* __restrict__ pairs,
                       const float4* __restrict__ leaves,
                       const float* __restrict__ rays, int R, int root_word,
                       int stack_depth, float* __restrict__ out_f,
                       int* __restrict__ out_i, int* __restrict__ next,
                       unsigned long long* __restrict__ stats) {
    const int lane = threadIdx.x & 31;
    // The lane's ray i and its state, `active` while it has steps to run;
    // `cur` and `rem` the next primitive of the leaf being tested and the
    // primitives left in it.
    int stack[kBinaryStackMax];
    int i = 0, sp = 0, ovf = 0, top = 0, cur = 0, rem = 0;
    int best_pos = -1, nstat = 0, lstat = 0;
    float tmin = 0.0f, tmax = 0.0f, best_t = 0.0f, best_u = 0.0f, best_v = 0.0f;
    bvh::RayInvN<Dim> ray;
    bool active = false, more = true;
    unsigned lane_steps = 0, warp_steps = 0;  // Stats: SIMT efficiency

    auto finish = [&]() {
        out_f[i] = best_t;
        out_f[R + i] = best_u;
        out_f[2 * R + i] = best_v;
        out_i[i] = best_pos;
        out_i[R + i] = nstat;
        out_i[2 * R + i] = lstat;
        out_i[3 * R + i] = ovf;
    };
    // The stack: a push onto a full stack drops the bottom entry and sets
    // the sticky overflow flag; a pop of an empty stack returns false.
    auto push = [&](int w) {
        if (sp < stack_depth) {
            stack[sp++] = w;
        } else {
            for (int k = 0; k + 1 < stack_depth; ++k) stack[k] = stack[k + 1];
            stack[stack_depth - 1] = w;
            ovf = 1;
        }
    };
    auto pop = [&](int& w) {
        if (sp == 0) return false;
        w = stack[--sp];
        return true;
    };
    // one node step: both children of the pair at `top`
    auto node_step = [&]() {
        ++nstat;
        float row[4 * kPairVec<Dim>];
        load_row<kPairVec<Dim>>(
            pairs + static_cast<size_t>(top >> 5) * kPairVec<Dim>, row);
        float tl, tr;
        const bool hit_l = box_hit<Dim, Robust>(ray, row, tmin, tmax, tl);
        const bool hit_r = box_hit<Dim, Robust>(ray, row + 2 * Dim, tmin, tmax, tr);
        const int wl = __float_as_int(row[4 * Dim]);
        const int wr = __float_as_int(row[4 * Dim + 1]);
        if (hit_l && hit_r) {
            const bool swap = !AnyHit && tl > tr;
            top = swap ? wr : wl;
            push(swap ? wl : wr);
        } else if (hit_l || hit_r) {
            top = hit_l ? wl : wr;
        } else if (!pop(top)) {
            active = false;
        }
    };
    // one primitive test; the first enters the leaf at `top`, the last pops
    auto leaf_step = [&]() {
        if (rem == 0) {
            ++lstat;
            cur = top >> 4;
            rem = top & 15;
        }
        float q[4 * Leaf::kVec];
        load_row<Leaf::kVec>(leaves + static_cast<size_t>(cur) * Leaf::kVec, q);
        float t, u, v;
        const bool hit = Leaf::test(q, ray, tmin, tmax, t, u, v);
        if (hit) {
            best_t = t;
            best_u = u;
            best_v = v;
            best_pos = cur;
            if (!AnyHit) tmax = t;
        }
        ++cur;
        --rem;
        if (AnyHit && hit) {
            rem = 0;
            active = false;
        } else if (rem == 0 && !pop(top)) {
            active = false;
        }
    };

    for (;;) {
        // ---- refill: the warp's idle lanes take the next rays in order
        unsigned idle = __ballot_sync(kFull, !active);
        if (more && __popc(idle) >= (Leaf::kRefill ? Leaf::kRefill : 32)) {
            int first = 0;
            if (lane == 0) first = atomicAdd(next, __popc(idle));
            first = __shfl_sync(kFull, first, 0);
            more = Leaf::kRefill && first + __popc(idle) < R;
            if (!active) {
                i = first + __popc(idle & ((1u << lane) - 1u));
                if (i < R) {
                    float o[Dim], d[Dim];
#pragma unroll
                    for (int a = 0; a < Dim; ++a) {
                        o[a] = rays[a * R + i];
                        d[a] = rays[(Dim + a) * R + i];
                    }
                    tmin = rays[2 * Dim * R + i];
                    tmax = rays[(2 * Dim + 1) * R + i];
                    ray = bvh::make_ray_inv(o, d, Robust);
                    sp = ovf = nstat = lstat = rem = 0;
                    top = root_word;
                    best_pos = -1;
                    best_t = __int_as_float(kInfBits);
                    best_u = best_v = 0.0f;
                    active = tmin <= tmax;
                    if (!active) finish();
                }
            }
            idle = __ballot_sync(kFull, !active);
        }
        if (idle == kFull) {
            if (more) continue;
            break;
        }
        // ---- kSteps steps a lane, each a primitive test or a node step
        const bool was_active = active;
        for (int k = 0; k < kSteps; ++k) {
            const bool testing = active && (rem > 0 || (top & 15) != 0);
            if (Stats) {
                // a warp step runs each kind of step that a lane takes
                warp_steps += (__ballot_sync(kFull, testing) != 0) +
                              (__ballot_sync(kFull, active && !testing) != 0);
                lane_steps += active;
            }
            if (testing)
                leaf_step();
            else if (active)
                node_step();
        }
        if (was_active && !active) finish();
    }
    if (Stats) {
        atomicAdd(stats, static_cast<unsigned long long>(lane_steps));
        if (lane == 0) atomicAdd(stats + 1, static_cast<unsigned long long>(warp_steps));
    }
}

template <int Dim, class Leaf, bool AnyHit, bool Robust, bool Stats>
int launch_walk(const float* pairs, const float* leaves, const float* rays,
                int R, int root_word, int stack_depth, float* out_f,
                int* out_i, int* next, unsigned long long* stats,
                cudaStream_t stream) {
    // with refill, enough warps to fill the card, each taking rays until
    // none is left; without, a lane a ray
    constexpr auto kernel = binary_traverse_kernel<Dim, Leaf, AnyHit, Robust, Stats>;
    int grid = (R + kBlock - 1) / kBlock, full = grid;
    cudaError_t err = cudaSuccess;
    if (Leaf::kRefill) err = bvh::persistent_grid<kernel>(kBlock, full);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid < full ? grid : full, kBlock, 0, stream>>>(
        reinterpret_cast<const float4*>(pairs),
        reinterpret_cast<const float4*>(leaves), rays, R, root_word,
        stack_depth, out_f, out_i, next, stats);
    return static_cast<int>(cudaGetLastError());
}

template <int Dim, class Leaf>
int dispatch(const float* pairs, const float* leaves, const float* rays,
             int R, int root_word, int any_hit, int robust, int stack_depth,
             float* out_f, int* out_i, int* next, unsigned long long* stats,
             void* stream) {
    if (R <= 0) return static_cast<int>(cudaGetLastError());
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WALK_ARGS pairs, leaves, rays, R, root_word, stack_depth, out_f, out_i, next, stats, s
    if (stats) {
        if (any_hit || robust) return static_cast<int>(cudaErrorInvalidValue);
        return launch_walk<Dim, Leaf, false, false, true>(WALK_ARGS);
    }
    if (any_hit)
        return robust ? launch_walk<Dim, Leaf, true, true, false>(WALK_ARGS)
                      : launch_walk<Dim, Leaf, true, false, false>(WALK_ARGS);
    return robust ? launch_walk<Dim, Leaf, false, true, false>(WALK_ARGS)
                  : launch_walk<Dim, Leaf, false, false, false>(WALK_ARGS);
#undef WALK_ARGS
}

// The warps of the walk (closest hit, fast slab) that one SM holds at
// once, from its registers, threads and local stack
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
template <int Dim, class Leaf>
int occupancy(int* out) {
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, binary_traverse_kernel<Dim, Leaf, false, false, false>,
        kBlock, 0);
    *out = blocks * kBlock / 32;
    return static_cast<int>(err);
}

}  // namespace

// Both entry points: outputs out_f [3, R] f32 (t, u, v; t = +inf on a
// miss) and out_i [4, R] i32 (position or -1, nstat, lstat, stack
// overflow); next: the work counter, one int that is zero at the launch
// (the wrappers hand each launch an unused slot of a zeroed ring,
// `walk_counter`, so that a launch needs no memset); stats: null,
// or two u64 to which the launch adds its lanes' steps and its warps'
// steps (an inner step or a primitive test; closest hit, fast slab
// only). They return cudaGetLastError(), or cudaErrorInvalidValue for a
// stats launch that is not closest hit with the fast slab.

// Kernel B5. pairs [P, 16] f32 (left box, right box, the two index
// words' int32 bits, padding), tris [M, 12] f32 by position (p0, e1, e2,
// n), both 16-byte aligned; rays [8, R] f32 (org, dir, tmin, tmax).
extern "C" int bvh_binary_traverse_tris(const float* pairs, const float* tris,
                                        const float* rays, int R,
                                        int root_word, int any_hit,
                                        int robust, int stack_depth,
                                        float* out_f, int* out_i, int* next,
                                        unsigned long long* stats,
                                        void* stream) {
    return dispatch<3, TriLeaf>(pairs, tris, rays, R, root_word, any_hit,
                                robust, stack_depth, out_f, out_i, next,
                                stats, stream);
}

// Kernel B6, dim 2, 3 or 4. pairs [P, 4*(dim+1)] f32 (as B5's), sph
// [M, 4] (dim 2, 3) or [M, 8] (dim 4) f32 by position (centre, radius,
// padding), both 16-byte aligned; rays [2*dim+2, R] f32. A hit reports
// t = u = the entry distance t0 and v = the exit distance t1.
// cudaErrorInvalidValue for another dim.
extern "C" int bvh_sphere_traverse(int dim, const float* pairs,
                                   const float* sph, const float* rays, int R,
                                   int root_word, int any_hit, int robust,
                                   int stack_depth, float* out_f, int* out_i,
                                   int* next, unsigned long long* stats,
                                   void* stream) {
#define B6_ARGS pairs, sph, rays, R, root_word, any_hit, robust, stack_depth, out_f, out_i, next, stats, stream
    switch (dim) {
        case 2: return dispatch<2, SphereLeaf<2>>(B6_ARGS);
        case 3: return dispatch<3, SphereLeaf<3>>(B6_ARGS);
        case 4: return dispatch<4, SphereLeaf<4>>(B6_ARGS);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef B6_ARGS
}

// The warps of kernel B5 (closest hit, fast slab) that one SM holds.
extern "C" int bvh_binary_traverse_occupancy(int* out) {
    return occupancy<3, TriLeaf>(out);
}

// The warps of kernel B6 (closest hit, fast slab, dim 2, 3 or 4) that
// one SM holds.
extern "C" int bvh_sphere_traverse_occupancy(int dim, int* out) {
    switch (dim) {
        case 2: return occupancy<2, SphereLeaf<2>>(out);
        case 3: return occupancy<3, SphereLeaf<3>>(out);
        case 4: return occupancy<4, SphereLeaf<4>>(out);
        default: *out = 0; return static_cast<int>(cudaErrorInvalidValue);
    }
}
