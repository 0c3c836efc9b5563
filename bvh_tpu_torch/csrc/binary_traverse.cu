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
// of inner steps (nstat) and leaves entered (lstat).
//
// B5: `binary_traverse_kernel<3, TriLeaf, AnyHit>`, one thread per ray
// and one loop whose iteration is a leaf step, a leaf entry or an inner
// step. Node pairs as rows, pair k = children (2k+1, 2k+2): node_b
// [P, 12] f32 (left box, right box, interleaved min/max) and node_w
// [P, 2] i32 (the children's index words, `first << 4 | count`; integers,
// so trees past 2^24 nodes keep exact words, where the TPU versions
// carried them as f32); triangles by position in prim_ids order [M, 12]
// (p0|e1|e2|n). Rays [2*Dim+2, R] f32 (org, dir, tmin, tmax).
//
// B6: `sphere_traverse_kernel<Dim, AnyHit, Robust, Stats>`.
// What bounds it on the card: the latency of each step's load, which
// depends on the step before (27, 39 and 128 inner steps a ray in 2D, 3D
// and 4D at phase 14's scale case, whose tables sit in the 50 MB L2),
// with the warps' lanes at different steps. The design:
// - One aligned row a step. A pair row holds both boxes and both index
//   words (their int32 bits), padded to (Dim + 1) float4: 48, 64 or 80
//   bytes, read with Dim + 1 16-byte loads from one address; a sphere
//   row holds the centre and radius in one float4 (2D, 3D) or two (4D).
//   (B5's layout reads a pair's boxes and words from two tables, and a
//   row of Dim + 1 floats is not aligned.)
// - One step a lane an iteration: a node step or a sphere test, the
//   first test of a leaf entering it (B5's loop spends an iteration on
//   the entry), with no vote between steps.
// - Persistent warps in 2D and 3D. Rays end at very different depths,
//   so a warp that waited for its longest ray ran with idle lanes. Every
//   kSphSteps steps a warp looks at its idle lanes; once kSphRefill are
//   idle they take the next rays in launch order from a work counter,
//   and each ray's results go to its own index. The grid is what the
//   card holds at once. In 4D a warp takes its 32 rays once and the
//   grid covers the rays: on an H100 80GB HBM3 at 700 W the refill
//   saved 11% in 3D and cost 0.7% in 4D.
// - Fewer instructions a step: the fast or robust slab test is a
//   template argument, and the slab distances fold with fmaxf/fminf (one
//   instruction each): the running entry and exit distances start at
//   tmin and tmax and are never NaN, so a NaN plane is dropped as by
//   robust_max/robust_min; they are only compared, never stored, so the
//   sign of a zero does not matter.
// The stack stays a local array of BVH_BINARY_STACK_MAX words. Tried on
// the card and dropped: a while-while loop (Aila and Laine, HPG 2009:
// node steps until the warp's lanes are at leaves, then the leaves'
// tests), with or without exits for waiting lanes, since it ran the
// warps' lanes one kind of step at a time and lost in 2D and 4D; a vote
// between steps; the stack's top in a register; prefetching the pushed
// child's row; each CTA taking rays from its own share of the launch
// order; 10 or 12 CTAs an SM, and blocks of 256 (fewer registers a
// thread: slower).
//
// Exactness: the state machine of the Pallas kernels step for step:
// leaf step, then inner step with near/far order by entry t for closest
// hit and left first for any hit, then pop; robust_max/robust_min fold
// the slab planes (node.h:105-117) and clamp the sphere's roots. B6
// visits the same nodes and leaves in the same order as B5's loop, so
// its outputs are those of the plain version bit for bit. Where the
// reference's shift stacks silently drop their bottom entry on a push at
// `sp == stack_depth` (pallas_kernel.py:253-262,
// pallas_sphere.py:229-231), these kernels drop it too and set a sticky
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

// The quadratic test of one sphere, centre q[0, Dim) and radius q[Dim]
// (sphere.h:31-49), every operation rounded on its own in the plain
// version's order (geom/sphere.py): dot products accumulated left to
// right, then c = -r*r + oc.oc and delta = b*b - (4a)*c. t0 and t1 are
// the entry and exit distances, clamped to [tmin, tmax].
template <int Dim>
__device__ __forceinline__ bool sphere_hit(const float* q,
                                           const bvh::RayInvN<Dim>& r,
                                           float tmin, float tmax, float& t0,
                                           float& t1) {
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
    t0 = bvh::robust_max(__fmul_rn(__fadd_rn(b, sq), inv), tmin);
    t1 = bvh::robust_min(__fmul_rn(__fsub_rn(b, sq), inv), tmax);
    return delta >= 0.0f && t0 <= t1;
}

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

// ---- kernel B6 --------------------------------------------------------

// B6's launch: threads a block and the CTAs an SM its registers must
// allow (48, 56 and 64 registers in 2D, 3D and 4D: 40, 36 and 32 warps
// an SM); the steps a lane runs between two looks at its warp's idle
// lanes, and per dim the idle lanes a warp waits for before it takes
// new rays, 0 for no refill (each warp takes 32 rays once and the grid
// covers the rays).
constexpr int kSphBlock = 128;
constexpr int kSphMinBlocks = 8;
constexpr int kSphSteps = 16;
template <int Dim>
constexpr int kSphRefill = Dim < 4 ? 24 : 0;
constexpr unsigned kFull = 0xffffffffu;

// float4s a pair row and a sphere row take
template <int Dim>
constexpr int kPairVec = Dim + 1;
template <int Dim>
constexpr int kSphVec = Dim < 4 ? 1 : 2;

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

template <int Dim, bool AnyHit, bool Robust, bool Stats>
__global__ void __launch_bounds__(kSphBlock, kSphMinBlocks)
sphere_traverse_kernel(const float4* __restrict__ pairs,
                       const float4* __restrict__ sph,
                       const float* __restrict__ rays, int R, int root_word,
                       int stack_depth, float* __restrict__ out_f,
                       int* __restrict__ out_i, int* __restrict__ next,
                       unsigned long long* __restrict__ stats) {
    const int lane = threadIdx.x & 31;
    // The lane's ray i and its state, `active` while it has steps to run;
    // `cur` and `rem` the next sphere of the leaf being tested and the
    // spheres left in it.
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
    // one sphere test; the first enters the leaf at `top`, the last pops
    auto leaf_step = [&]() {
        if (rem == 0) {
            ++lstat;
            cur = top >> 4;
            rem = top & 15;
        }
        float q[4 * kSphVec<Dim>];
        load_row<kSphVec<Dim>>(sph + static_cast<size_t>(cur) * kSphVec<Dim>, q);
        float t0, t1;
        const bool hit = sphere_hit<Dim>(q, ray, tmin, tmax, t0, t1);
        if (hit) {
            best_t = t0;
            best_u = t0;
            best_v = t1;
            best_pos = cur;
            if (!AnyHit) tmax = t0;
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
        if (more && __popc(idle) >= (kSphRefill<Dim> ? kSphRefill<Dim> : 32)) {
            int first = 0;
            if (lane == 0) first = atomicAdd(next, __popc(idle));
            first = __shfl_sync(kFull, first, 0);
            more = kSphRefill<Dim> && first + __popc(idle) < R;
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
                    best_t = __int_as_float(0x7f800000);
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
        // ---- kSphSteps steps a lane, each a sphere test or a node step
        const bool was_active = active;
        for (int k = 0; k < kSphSteps; ++k) {
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

template <int Dim, bool AnyHit, bool Robust, bool Stats>
int launch_spheres(const float* pairs, const float* sph, const float* rays,
                   int R, int root_word, int stack_depth, float* out_f,
                   int* out_i, int* next, unsigned long long* stats,
                   cudaStream_t stream) {
    // with refill, enough warps to fill the card, each taking rays until
    // none is left; without, a lane a ray
    constexpr auto kernel = sphere_traverse_kernel<Dim, AnyHit, Robust, Stats>;
    int grid = (R + kSphBlock - 1) / kSphBlock, full = grid;
    cudaError_t err = cudaSuccess;
    if (kSphRefill<Dim>) err = bvh::persistent_grid<kernel>(kSphBlock, full);
    if (err == cudaSuccess) err = cudaMemsetAsync(next, 0, sizeof(int), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid < full ? grid : full, kSphBlock, 0, stream>>>(
        reinterpret_cast<const float4*>(pairs),
        reinterpret_cast<const float4*>(sph), rays, R, root_word, stack_depth,
        out_f, out_i, next, stats);
    return static_cast<int>(cudaGetLastError());
}

template <int Dim>
int dispatch_spheres(const float* pairs, const float* sph, const float* rays,
                     int R, int root_word, int any_hit, int robust,
                     int stack_depth, float* out_f, int* out_i, int* next,
                     unsigned long long* stats, cudaStream_t s) {
#define B6_ARGS pairs, sph, rays, R, root_word, stack_depth, out_f, out_i, next, stats, s
    if (stats) {
        if (any_hit || robust) return static_cast<int>(cudaErrorInvalidValue);
        return launch_spheres<Dim, false, false, true>(B6_ARGS);
    }
    if (any_hit)
        return robust ? launch_spheres<Dim, true, true, false>(B6_ARGS)
                      : launch_spheres<Dim, true, false, false>(B6_ARGS);
    return robust ? launch_spheres<Dim, false, true, false>(B6_ARGS)
                  : launch_spheres<Dim, false, false, false>(B6_ARGS);
#undef B6_ARGS
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

// Kernel B6, dim 2, 3 or 4. pairs [P, 4*(dim+1)] f32 (left box, right
// box, the two index words' int32 bits, padding), sph [M, 4] (dim 2, 3)
// or [M, 8] (dim 4) f32 by position (centre, radius, padding), both
// 16-byte aligned; rays [2*dim+2, R] f32; outputs as B5's, with t = u =
// the entry distance t0 and v = the exit distance t1; next: one int of
// scratch (the work counter). stats: null, or two u64 to which the
// launch adds its lanes' steps and its warps' steps (an inner step or a
// sphere test; closest hit, fast slab only). Returns cudaGetLastError(),
// or cudaErrorInvalidValue for another dim or a stats launch that is not
// closest hit with the fast slab.
extern "C" int bvh_sphere_traverse(int dim, const float* pairs,
                                   const float* sph, const float* rays, int R,
                                   int root_word, int any_hit, int robust,
                                   int stack_depth, float* out_f, int* out_i,
                                   int* next, unsigned long long* stats,
                                   void* stream) {
    if (R <= 0) return static_cast<int>(cudaGetLastError());
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dim) {
        case 2:
            return dispatch_spheres<2>(pairs, sph, rays, R, root_word, any_hit,
                                       robust, stack_depth, out_f, out_i, next,
                                       stats, s);
        case 3:
            return dispatch_spheres<3>(pairs, sph, rays, R, root_word, any_hit,
                                       robust, stack_depth, out_f, out_i, next,
                                       stats, s);
        case 4:
            return dispatch_spheres<4>(pairs, sph, rays, R, root_word, any_hit,
                                       robust, stack_depth, out_f, out_i, next,
                                       stats, s);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

// The warps of kernel B6 (closest hit, fast slab, dim 2, 3 or 4) that
// one SM holds at once, from its registers, threads and local stack
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int bvh_sphere_traverse_occupancy(int dim, int* out) {
    int blocks = 0;
    cudaError_t err = cudaErrorInvalidValue;
    if (dim == 2)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, sphere_traverse_kernel<2, false, false, false>, kSphBlock, 0);
    else if (dim == 3)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, sphere_traverse_kernel<3, false, false, false>, kSphBlock, 0);
    else if (dim == 4)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, sphere_traverse_kernel<4, false, false, false>, kSphBlock, 0);
    *out = blocks * kSphBlock / 32;
    return static_cast<int>(err);
}
