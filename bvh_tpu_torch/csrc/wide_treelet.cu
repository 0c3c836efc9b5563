// Wide treelet traversal (kernel B1) for Hopper.
//
// Replaces the Pallas kernel `_traverse_core`
// (bvh_tpu/traverse/wide_treelet.py:741), launched per grid block by
// `_wide_kernel_dma` (:1042) from `_phase_b` (:1096). For each
// (ray, treelet) pair it walks the treelet's 8-wide BVH. It reads the
// treelet tables in the column layout, cols[T, P, 64] f32
// (`WideTreelets.table_cols`, the transpose of the reference's
// table[T, 64, P]), so that one column is 256 contiguous bytes:
//   node column: rows 0-47 the 8 children's bounds (lo/hi per axis),
//                rows 48-55 the children's words as f32
//                (inner child: col << 4; quad leaf: first col << 4 | n);
//   quad column: 4 triangles, rows q*13 .. q*13+11 = p0|e1|e2|n and
//                row q*13+12 the global prim position (-1 = padding).
// Each step is a leaf step (4 Möller–Trumbore tests of one quad
// column), or an inner step (8 slab tests, the 19-comparator `_sort8`
// network by entry t, or by slot for any-hit, and far-to-near pushes),
// followed by a pop, in the order of the reference's `one_step`
// (:812-992), so per-pair active steps and stack high-water marks
// match it exactly.
//
// What bounds it on the card: dependent loads, one step's column after
// the last, and the instructions of a step, with a warp's lanes at
// different steps. The design:
// - Loads. In the [T, 64, P] layout every float of a step was its own
//   32-byte sector, P floats from the next; in the column layout an
//   inner step's 56 floats are 14 aligned 16-byte loads and a quad
//   step's 52 floats 13, all issued through the read-only path before
//   any is used, so a step waits for about one memory latency.
// - Registers. The sorted keys and words stay in registers: the
//   far-to-near pushes are unrolled with a predicate a slot (one store
//   each to its final place when they all fit), so no array but the
//   stack (a per-thread local array) is indexed at run time;
//   __launch_bounds__ holds 5 CTAs of 128 an SM without spills.
// - Instructions. The slab min/max are one max.NaN/min.NaN each; the
//   reciprocal is __frcp_rn; any-hit, whose network sorts slot keys,
//   takes its hit slots in slot order without the network; the step
//   that enters a quad leaf runs in the same pass as the leaf's first.
// - Lanes at different steps. A pair's steps vary (p99 53, mean 13 at
//   262K round 1), so a warp that waited for its slowest pair ran half
//   idle. Each warp is persistent: every kSteps steps its lanes vote,
//   and once kRefill lanes are idle they take the next pairs of the
//   (treelet, octant)-sorted list from a global counter, until it runs
//   out. The grid is what the card holds at once.
// The pair list is sorted by (treelet, octant) in the render loop, so a
// warp's lanes tend to share a treelet and a traversal order and hit the
// same lines in L1/L2.
//
// Ablation variants (tools/ablate_kernel.py:147-174, ported as
// bvh_tpu_torch/tools/ablate_kernel.py): `kAblate` is a bitmask of code
// to leave out, for measuring what each part of a step costs: kNoQuad
// skips the 4 Möller–Trumbore tests of a quad step, kNoSort the
// `_sort8` network (children stay in slot order), kNoPush the pushes.
// The render's four instantiations have kAblate = 0, so every `if
// constexpr` below keeps its code; the variants are right only where
// the skipped code has no effect (the tool's chain table) and are
// launched by `bvh_wide_treelet_ablate`.
//
// Exactness: slab max/min propagate NaN as the reference's
// jnp.maximum/minimum do (:920-921, ROADMAP C6; fmaxf/fminf would
// swallow it and turn robust-mode 0*inf misses into hits); sums of
// three products run (x0 + x1) + x2; the normal is read from the
// table, never recomputed; a hit is accepted when tt <= tmax, so the
// later prim wins an exact tie; any-hit stops the quad column at its
// first hit; a push onto a full stack drops the bottom entry and sets
// a sticky flag. Unlike the reference, which encodes hwm + 1000*ovf in
// one row (ROADMAP C1), the overflow flag and the high-water mark are
// separate outputs.

#include "slab.cuh"

namespace {

constexpr int kStackMax = BVH_WIDE_STACK_MAX;  // set by kernels.py
constexpr int kRows = 64;
constexpr int kVec = kRows / 4;  // float4 loads a column
constexpr int kNoQuad = 1, kNoSort = 2, kNoPush = 4;
constexpr int kBlock = 128;
// CTAs an SM that the registers must allow (95 registers a thread)
constexpr int kMinBlocks = 5;
// a warp takes new pairs once this many of its lanes are idle
constexpr int kRefill = 16;
// steps a lane runs between two looks at its warp's idle lanes
constexpr int kSteps = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
    return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                     __fmul_rn(a2, b2));
}

__device__ __forceinline__ float cross_term(float a, float b, float c,
                                            float d) {
    return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

// jnp.maximum / jnp.minimum in one instruction each (sm_80's max.NaN,
// min.NaN: NaN in either operand yields NaN), where bvh::nan_max and
// nan_min take four. They may differ from those in the sign of a zero
// result only, and a zero's sign never reaches an output: entry
// distances are compared, never stored.
__device__ __forceinline__ float max_nan(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}
__device__ __forceinline__ float min_nan(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

// Row r of a column held as float4s; r is a constant once unrolled.
template <int N>
__device__ __forceinline__ float row(const float4 (&v)[N], int r) {
    const float4 x = v[r >> 2];
    switch (r & 3) {
        case 0: return x.x;
        case 1: return x.y;
        case 2: return x.z;
        default: return x.w;
    }
}

// Push a word onto the stack; a full stack drops its bottom entry and
// sets the sticky overflow flag.
__device__ __forceinline__ void push(int* stack, int& sp, int& ovf,
                                     int stack_depth, int w) {
    if (sp < stack_depth) {
        stack[sp++] = w;
    } else {
        for (int k = 0; k + 1 < stack_depth; ++k) stack[k] = stack[k + 1];
        stack[stack_depth - 1] = w;
        ovf = 1;
    }
}

// A pair's t and counts, written when it ends.
__device__ __forceinline__ void finish(int i, int L, float* out_f, int* out_i,
                                       float t, int asteps, int hwm, int ovf) {
    out_f[i] = t;
    out_i[L + i] = asteps;
    out_i[2 * L + i] = hwm;
    out_i[3 * L + i] = ovf;
}

template <bool kAnyHit, bool kRobust, int kAblate>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
wide_treelet_kernel(const float* __restrict__ cols, int P,
                    const int* __restrict__ tid, const float* __restrict__ rays,
                    int L, int stack_depth, float* __restrict__ out_f,
                    int* __restrict__ out_i, int* __restrict__ next) {
    const int lane = threadIdx.x & 31;
    const float inf = __int_as_float(0x7f800000);
    const float4* const tables = reinterpret_cast<const float4*>(cols);
    int stack[kStackMax];
    // The lane's pair i and its state, `active` while it has steps to
    // run. `leaf` is the quad leaf being drained, as its word: next
    // column << 4 | columns left. A hit's u, v and prim position go
    // straight to the outputs; t and the counts when the pair ends.
    int i = 0, sp = 0, top = 0, leaf = 0, asteps = 0, hwm = 0, ovf = 0;
    float o[3], d[3], tmin = 0.0f, tmax = 0.0f, best_t = inf;
    bvh::RayInv ray;
    const float4* tab = tables;
    bool active = false, more = true;

    for (;;) {
        // ---- refill: the warp's idle lanes take the next pairs in order
        unsigned idle = __ballot_sync(kFull, !active);
        if (more && __popc(idle) >= kRefill) {
            int first = 0;
            if (lane == 0) first = atomicAdd(next, __popc(idle));
            first = __shfl_sync(kFull, first, 0);
            more = first + __popc(idle) < L;
            if (!active) {
                i = first + __popc(idle & ((1u << lane) - 1u));
                if (i < L) {
#pragma unroll
                    for (int a = 0; a < 3; ++a) {
                        o[a] = rays[a * L + i];
                        d[a] = rays[(3 + a) * L + i];
                    }
                    tmin = rays[6 * L + i];
                    tmax = rays[7 * L + i];
                    ray = bvh::make_ray_inv(o, d, kRobust);
                    const int t = tid[i];
                    tab = tables + static_cast<size_t>(t < 0 ? 0 : t) * P * kVec;
                    sp = top = leaf = asteps = hwm = ovf = 0;
                    best_t = inf;
                    out_f[L + i] = 0.0f;
                    out_f[2 * L + i] = 0.0f;
                    out_i[i] = -1;
                    active = t >= 0 && tmin <= tmax;
                    if (!active) finish(i, L, out_f, out_i, best_t, 0, 0, 0);
                }
            }
            idle = __ballot_sync(kFull, !active);
        }
        if (idle == kFull) {
            if (more) continue;
            break;
        }
        // ---- up to kSteps steps of the pair (a step that enters a quad
        // leaf is run with the leaf's first)
        for (int k = 0; k < kSteps && active; ++k) {
            ++asteps;
            if ((leaf & 15) == 0 && (top & 15) != 0) {
                // enter a quad leaf: a step that only sets the cursor (no
                // pop, no push), run in the same pass as the leaf's first
                leaf = top;
                ++asteps;
            }
            bool done_by_hit = false, leaf_exhausted = false;
            bool do_node = false, descend = false;
            int new_top = 0;
            if ((leaf & 15) != 0) {
                // ---- quad leaf step: 4 sequential Möller–Trumbore tests
                if constexpr ((kAblate & kNoQuad) == 0) {
                    const float4* c = tab + static_cast<size_t>(leaf >> 4) * kVec;
                    float4 q[13];
#pragma unroll
                    for (int r = 0; r < 13; ++r) q[r] = __ldg(c + r);
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int gpos = static_cast<int>(row(q, j * 13 + 12));
                        const float cv0 = __fsub_rn(row(q, j * 13 + 0), o[0]);
                        const float cv1 = __fsub_rn(row(q, j * 13 + 1), o[1]);
                        const float cv2 = __fsub_rn(row(q, j * 13 + 2), o[2]);
                        const float r0 = cross_term(d[1], cv2, d[2], cv1);
                        const float r1 = cross_term(d[2], cv0, d[0], cv2);
                        const float r2 = cross_term(d[0], cv1, d[1], cv0);
                        const float n0 = row(q, j * 13 + 9);
                        const float n1 = row(q, j * 13 + 10);
                        const float n2 = row(q, j * 13 + 11);
                        // the correctly rounded reciprocal: 1.0f / x bit for bit
                        const float inv_det =
                            __frcp_rn(dot3(n0, n1, n2, d[0], d[1], d[2]));
                        const float uu = __fmul_rn(
                            dot3(r0, r1, r2, row(q, j * 13 + 6), row(q, j * 13 + 7),
                                 row(q, j * 13 + 8)),
                            inv_det);
                        const float vv = __fmul_rn(
                            dot3(r0, r1, r2, row(q, j * 13 + 3), row(q, j * 13 + 4),
                                 row(q, j * 13 + 5)),
                            inv_det);
                        const float ww = __fsub_rn(__fsub_rn(1.0f, uu), vv);
                        const float tt =
                            __fmul_rn(dot3(n0, n1, n2, cv0, cv1, cv2), inv_det);
                        const bool hit = uu >= -bvh::kEps && vv >= -bvh::kEps &&
                                         ww >= -bvh::kEps && tt >= tmin &&
                                         tt <= tmax && gpos >= 0 && !done_by_hit;
                        if (hit) {
                            best_t = tt;
                            if (kAnyHit)
                                done_by_hit = true;
                            else
                                tmax = tt;
                            out_f[L + i] = uu;
                            out_f[2 * L + i] = vv;
                            out_i[i] = gpos;
                        }
                    }
                }
                leaf += 16 - 1;  // the next column, one fewer left
                leaf_exhausted = (leaf & 15) == 0 && !done_by_hit;
            } else {
                // ---- wide inner step: 8 slab tests, sorted multi-push
                do_node = true;
                const float4* c = tab + static_cast<size_t>(top >> 4) * kVec;
                float4 v[14];
#pragma unroll
                for (int r = 0; r < 14; ++r) v[r] = __ldg(c + r);
                float key[8];
                int word[8];
                unsigned hits = 0;
#pragma unroll
                for (int ch = 0; ch < 8; ++ch) {
                    float t0 = tmin, t1 = tmax;
#pragma unroll
                    for (int a = 0; a < 3; ++a) {
                        float tn, tf;
                        bvh::slab_axis(ray, a, row(v, ch * 6 + 2 * a),
                                       row(v, ch * 6 + 2 * a + 1), kRobust, tn, tf);
                        t0 = max_nan(tn, t0);
                        t1 = min_nan(tf, t1);
                    }
                    const bool hit = t0 <= t1;
                    hits |= hit ? 1u << ch : 0u;
                    key[ch] = hit ? t0 : inf;
                    word[ch] = static_cast<int>(row(v, 48 + ch));
                }
                const int n_hits = __popc(hits);
                descend = n_hits > 0;
                if constexpr (kAnyHit) {
                    // keyed by slot, the network puts the hit slots first in
                    // slot order: the lowest is descended into, the others
                    // are pushed from the highest down
                    const int lowest = __ffs(hits) - 1;
#pragma unroll
                    for (int ch = 7; ch >= 0; --ch)
                        if ((hits >> ch) & 1u) new_top = word[ch];
                    if constexpr ((kAblate & kNoPush) == 0) {
#pragma unroll
                        for (int ch = 7; ch >= 1; --ch)
                            if (((hits >> ch) & 1u) && ch > lowest)
                                push(stack, sp, ovf, stack_depth, word[ch]);
                    }
                } else {
                    if constexpr ((kAblate & kNoSort) == 0) bvh::sort8(key, word);
                    new_top = word[0];
                    // push far to near, so the nearest remaining pops
                    // first: word[j] lands n_hits - 1 - j above sp, one
                    // store each where they all fit, else push by push
                    if constexpr ((kAblate & kNoPush) == 0) {
                        if (sp + n_hits - 1 <= stack_depth) {
#pragma unroll
                            for (int j = 1; j < 8; ++j)
                                if (j < n_hits) stack[sp + n_hits - 1 - j] = word[j];
                            if (n_hits > 1) sp += n_hits - 1;
                        } else {
#pragma unroll
                            for (int j = 7; j >= 1; --j)
                                if (j < n_hits)
                                    push(stack, sp, ovf, stack_depth, word[j]);
                        }
                    }
                }
            }
            const bool need_pop = (do_node && !descend) || leaf_exhausted;
            if (descend) {
                top = new_top;
            } else if (need_pop) {
                if (sp > 0)
                    top = stack[--sp];
                else
                    active = false;
            }
            if (done_by_hit) active = false;
            hwm = max(hwm, sp);
            if (!active) finish(i, L, out_f, out_i, best_t, asteps, hwm, ovf);
        }
    }
}

template <bool kAnyHit, bool kRobust, int kAblate = 0>
int launch(const float* cols, int P, const int* tid, const float* rays, int L,
           int stack_depth, float* out_f, int* out_i, int* next,
           cudaStream_t stream) {
    // enough warps to fill the current card, each taking pairs until none
    // is left
    int grid = 0;
    cudaError_t err = bvh::persistent_grid<
        wide_treelet_kernel<kAnyHit, kRobust, kAblate>>(kBlock, grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (L + kBlock - 1) / kBlock;
    err = cudaMemsetAsync(next, 0, sizeof(int), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    wide_treelet_kernel<kAnyHit, kRobust, kAblate>
        <<<blocks < grid ? blocks : grid, kBlock, 0, stream>>>(
            cols, P, tid, rays, L, stack_depth, out_f, out_i, next);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cols [T, P, 64] f32, 16-byte aligned; tid [L] i32 (-1 = no pair); rays
// [8, L] f32 (org, dir, tmin, tmax); outputs out_f [3, L] f32 (t, u, v)
// and out_i [4, L] i32 (prim position or -1, active steps, stack
// high-water mark, overflow flag); next: one int of scratch (the work
// counter, zeroed on the stream before the launch). Returns the first
// CUDA error of the launch, or cudaGetLastError() after it.
extern "C" int bvh_wide_treelet_traverse(const float* cols, int T, int P,
                                         const int* tid, const float* rays,
                                         int L, int any_hit, int robust,
                                         int stack_depth, float* out_f,
                                         int* out_i, int* next, void* stream) {
    (void)T;
    if (L <= 0) return static_cast<int>(cudaGetLastError());
    auto s = static_cast<cudaStream_t>(stream);
    if (any_hit && robust)
        return launch<true, true>(cols, P, tid, rays, L, stack_depth, out_f, out_i, next, s);
    if (any_hit)
        return launch<true, false>(cols, P, tid, rays, L, stack_depth, out_f, out_i, next, s);
    if (robust)
        return launch<false, true>(cols, P, tid, rays, L, stack_depth, out_f, out_i, next, s);
    return launch<false, false>(cols, P, tid, rays, L, stack_depth, out_f, out_i, next, s);
}

// The ablation variants of the closest-hit, fast-form kernel, as
// tools/ablate_kernel.py and tools/ablate_kernel2.py run them: `variant`
// is 0 (the full kernel), kNoQuad (1), kNoSort (2), kNoQuad | kNoSort (3)
// or kNoPush (4). Arguments and outputs as bvh_wide_treelet_traverse.
// Returns cudaErrorInvalidValue for another variant.
extern "C" int bvh_wide_treelet_ablate(const float* cols, int T, int P,
                                       const int* tid, const float* rays,
                                       int L, int variant, int stack_depth,
                                       float* out_f, int* out_i, int* next,
                                       void* stream) {
    (void)T;
    auto s = static_cast<cudaStream_t>(stream);
    if (variant < 0 || variant > kNoPush)
        return static_cast<int>(cudaErrorInvalidValue);
    if (L <= 0) return static_cast<int>(cudaGetLastError());
    switch (variant) {
        case 0: return launch<false, false, 0>(cols, P, tid, rays, L, stack_depth, out_f, out_i, next, s);
        case 1: return launch<false, false, 1>(cols, P, tid, rays, L, stack_depth, out_f, out_i, next, s);
        case 2: return launch<false, false, 2>(cols, P, tid, rays, L, stack_depth, out_f, out_i, next, s);
        case 3: return launch<false, false, 3>(cols, P, tid, rays, L, stack_depth, out_f, out_i, next, s);
        default: return launch<false, false, 4>(cols, P, tid, rays, L, stack_depth, out_f, out_i, next, s);
    }
}
