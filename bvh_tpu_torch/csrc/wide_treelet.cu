// Wide treelet traversal (kernel B1) for Hopper.
//
// Replaces the Pallas kernel `_traverse_core`
// (bvh_tpu/traverse/wide_treelet.py:741), launched per grid block by
// `_wide_kernel_dma` (:1042) from `_phase_b` (:1096). For each
// (ray, treelet) pair it walks the treelet's 8-wide BVH, stored as one
// [64, P] f32 table per treelet inside table[T, 64, P]:
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
// What bounds it on the card: dependent, uncoalesced loads. A step
// reads up to 56 floats of one table column, each P floats apart, so
// every value is its own 32-byte sector; neighbouring threads read
// neighbouring columns only when their pairs visit the same node. The
// design gives each pair one thread (no lockstep across a block, as
// the TPU's vector lanes had), sorts pairs by (treelet, octant) in the
// render loop so a warp's threads tend to share a treelet and a traversal
// order and hit the same lines in L1/L2, and keeps the stack in a
// per-thread local array. A transposed table layout, so that a column
// is contiguous, is left to a later change.
//
// Ablation variants (tools/ablate_kernel.py:147-174, ported as
// bvh_tpu_torch/tools/ablate_kernel.py): `kAblate` is a bitmask of code
// to leave out, for measuring what each part of a step costs: kNoQuad
// skips the 4 Möller–Trumbore tests of a quad step, kNoSort the
// `_sort8` network (children stay in slot order), kNoPush the pushes.
// The render's four instantiations have kAblate = 0, so every `if
// constexpr` below keeps its code and they compile as before; the
// variants are right only where the skipped code has no effect (the
// tool's chain table) and are launched by `bvh_wide_treelet_ablate`.
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
constexpr int kNoQuad = 1, kNoSort = 2, kNoPush = 4;

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
    return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                     __fmul_rn(a2, b2));
}

__device__ __forceinline__ float cross_term(float a, float b, float c,
                                            float d) {
    return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

template <bool kAnyHit, bool kRobust, int kAblate>
__global__ void wide_treelet_kernel(const float* __restrict__ table, int P,
                                    const int* __restrict__ tid,
                                    const float* __restrict__ rays, int L,
                                    int stack_depth, float* __restrict__ out_f,
                                    int* __restrict__ out_i) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= L) return;
    const float inf = __int_as_float(0x7f800000);
    float o[3], d[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        o[a] = rays[a * L + i];
        d[a] = rays[(3 + a) * L + i];
    }
    const float tmin = rays[6 * L + i];
    float tmax = rays[7 * L + i];
    const bvh::RayInv ray = bvh::make_ray_inv(o, d, kRobust);
    const int t = tid[i];
    const float* tab = table + static_cast<size_t>(t < 0 ? 0 : t) * kRows * P;

    int stack[kStackMax];
    int sp = 0, top = 0, leaf_cur = 0, leaf_rem = 0;
    int asteps = 0, hwm = 0, ovf = 0, best_pos = -1;
    float best_t = inf, best_u = 0.0f, best_v = 0.0f;
    bool active = t >= 0 && tmin <= tmax;

    while (active) {
        ++asteps;
        bool done_by_hit = false, leaf_exhausted = false;
        bool do_node = false, descend = false;
        int new_top = 0;
        if (leaf_rem > 0) {
            // ---- quad leaf step: 4 sequential Möller–Trumbore tests
            if constexpr ((kAblate & kNoQuad) == 0) {
                const float* c = tab + leaf_cur;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    float q[13];
#pragma unroll
                    for (int r = 0; r < 13; ++r)
                        q[r] = __ldg(c + (j * 13 + r) * P);
                    const int gpos = static_cast<int>(q[12]);
                    const float cv0 = __fsub_rn(q[0], o[0]);
                    const float cv1 = __fsub_rn(q[1], o[1]);
                    const float cv2 = __fsub_rn(q[2], o[2]);
                    const float r0 = cross_term(d[1], cv2, d[2], cv1);
                    const float r1 = cross_term(d[2], cv0, d[0], cv2);
                    const float r2 = cross_term(d[0], cv1, d[1], cv0);
                    const float inv_det = __fdiv_rn(
                        1.0f, dot3(q[9], q[10], q[11], d[0], d[1], d[2]));
                    const float uu =
                        __fmul_rn(dot3(r0, r1, r2, q[6], q[7], q[8]), inv_det);
                    const float vv =
                        __fmul_rn(dot3(r0, r1, r2, q[3], q[4], q[5]), inv_det);
                    const float ww = __fsub_rn(__fsub_rn(1.0f, uu), vv);
                    const float tt = __fmul_rn(
                        dot3(q[9], q[10], q[11], cv0, cv1, cv2), inv_det);
                    const bool hit = uu >= -bvh::kEps && vv >= -bvh::kEps &&
                                     ww >= -bvh::kEps && tt >= tmin &&
                                     tt <= tmax && gpos >= 0 && !done_by_hit;
                    if (hit) {
                        best_t = tt;
                        if (kAnyHit)
                            done_by_hit = true;
                        else
                            tmax = tt;
                        best_u = uu;
                        best_v = vv;
                        best_pos = gpos;
                    }
                }
            }
            ++leaf_cur;
            --leaf_rem;
            leaf_exhausted = leaf_rem == 0 && !done_by_hit;
        } else if ((top & 15) != 0) {
            // ---- enter a quad leaf: its columns are drained next steps
            leaf_cur = top >> 4;
            leaf_rem = top & 15;
        } else {
            // ---- wide inner step: 8 slab tests, sorted multi-push
            do_node = true;
            const float* c = tab + (top >> 4);
            float key[8];
            int word[8];
            int n_hits = 0;
#pragma unroll
            for (int ch = 0; ch < 8; ++ch) {
                float t0 = tmin, t1 = tmax;
#pragma unroll
                for (int a = 0; a < 3; ++a) {
                    float tn, tf;
                    bvh::slab_axis(ray, a, __ldg(c + (ch * 6 + 2 * a) * P),
                                   __ldg(c + (ch * 6 + 2 * a + 1) * P),
                                   kRobust, tn, tf);
                    t0 = bvh::nan_max(tn, t0);
                    t1 = bvh::nan_min(tf, t1);
                }
                const bool hit = t0 <= t1;
                n_hits += hit;
                key[ch] = hit ? (kAnyHit ? static_cast<float>(ch) : t0) : inf;
                word[ch] = static_cast<int>(__ldg(c + (48 + ch) * P));
            }
            if constexpr ((kAblate & kNoSort) == 0) bvh::sort8(key, word);
            descend = n_hits > 0;
            new_top = word[0];
            // push far to near, so the nearest remaining pops first
            if constexpr ((kAblate & kNoPush) == 0) {
                for (int j = n_hits - 1; j >= 1; --j) {
                    if (sp < stack_depth) {
                        stack[sp++] = word[j];
                    } else {
                        for (int k = 0; k + 1 < stack_depth; ++k)
                            stack[k] = stack[k + 1];
                        stack[stack_depth - 1] = word[j];
                        ovf = 1;
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
    }
    out_f[i] = best_t;
    out_f[L + i] = best_u;
    out_f[2 * L + i] = best_v;
    out_i[i] = best_pos;
    out_i[L + i] = asteps;
    out_i[2 * L + i] = hwm;
    out_i[3 * L + i] = ovf;
}

template <bool kAnyHit, bool kRobust, int kAblate = 0>
void launch(const float* table, int P, const int* tid, const float* rays,
            int L, int stack_depth, float* out_f, int* out_i,
            cudaStream_t stream) {
    const int block = 128;
    wide_treelet_kernel<kAnyHit, kRobust, kAblate>
        <<<(L + block - 1) / block, block, 0, stream>>>(
            table, P, tid, rays, L, stack_depth, out_f, out_i);
}

}  // namespace

// table [T, 64, P] f32; tid [L] i32 (-1 = no pair); rays [8, L] f32
// (org, dir, tmin, tmax); outputs out_f [3, L] f32 (t, u, v) and
// out_i [4, L] i32 (prim position or -1, active steps, stack high-water
// mark, overflow flag). Returns cudaGetLastError() after the launch.
extern "C" int bvh_wide_treelet_traverse(const float* table, int T, int P,
                                         const int* tid, const float* rays,
                                         int L, int any_hit, int robust,
                                         int stack_depth, float* out_f,
                                         int* out_i, void* stream) {
    (void)T;
    if (L > 0) {
        auto s = static_cast<cudaStream_t>(stream);
        if (any_hit && robust)
            launch<true, true>(table, P, tid, rays, L, stack_depth, out_f, out_i, s);
        else if (any_hit)
            launch<true, false>(table, P, tid, rays, L, stack_depth, out_f, out_i, s);
        else if (robust)
            launch<false, true>(table, P, tid, rays, L, stack_depth, out_f, out_i, s);
        else
            launch<false, false>(table, P, tid, rays, L, stack_depth, out_f, out_i, s);
    }
    return static_cast<int>(cudaGetLastError());
}

// The ablation variants of the closest-hit, fast-form kernel, as
// tools/ablate_kernel.py runs them: `variant` is kNoQuad (1), kNoSort
// (2) or kNoPush (4); arguments and outputs as
// bvh_wide_treelet_traverse. Returns cudaErrorInvalidValue for another
// variant, else cudaGetLastError() after the launch.
extern "C" int bvh_wide_treelet_ablate(const float* table, int T, int P,
                                       const int* tid, const float* rays,
                                       int L, int variant, int stack_depth,
                                       float* out_f, int* out_i,
                                       void* stream) {
    (void)T;
    auto s = static_cast<cudaStream_t>(stream);
    if (variant != kNoQuad && variant != kNoSort && variant != kNoPush)
        return static_cast<int>(cudaErrorInvalidValue);
    if (L > 0) {
        if (variant == kNoQuad)
            launch<false, false, kNoQuad>(table, P, tid, rays, L, stack_depth, out_f, out_i, s);
        else if (variant == kNoSort)
            launch<false, false, kNoSort>(table, P, tid, rays, L, stack_depth, out_f, out_i, s);
        else
            launch<false, false, kNoPush>(table, P, tid, rays, L, stack_depth, out_f, out_i, s);
    }
    return static_cast<int>(cudaGetLastError());
}
