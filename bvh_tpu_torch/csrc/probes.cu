// Hardware probes of the profiling tools, for Hopper: the wide-step probe
// (T5) and the column-fetch probe (T6).
//
// T5 replaces the Pallas kernel built by `make_kernel`
// (tools/probe_tpu.py:61-140, launched at :147): a synthetic wide-node
// step looped `iters` times. Each step of a chain fetches column `top` of
// a [64, C] f32 table, runs 8 slab tests against the ray (rows 0-47 the
// children's lo/hi per axis), converts rows 48-55 to int words, keys the
// hits by entry t (misses 1e30), optionally sorts the 8 keys with the
// reference's `_sort8`, stores words[0] at `sp` (when sp < stack_depth),
// moves sp (+1 on any hit, then -1, floored at 0), pops
// max(stack[sp], 0) (the one-hot pop takes a max over all stack rows,
// the others 0), and sets top = (popped + words[1] + it) floor-mod C and
// acc += keys[0]. `Chains` independent chains run interleaved in one
// thread, as the reference interleaves chains in one loop body; they
// share the step counter `it`, which every chain's own counter equals.
// The reference fetched the column with a one-hot matrix product; here
// it is 56 ordinary loads.
//
// T6 replaces the two Pallas kernels `kern_bf` and `kern_i8`
// (tools/probe_int8_fetch.py:35-59, launched at :65): out[r, b] =
// sum over i < iters of table[r, (idx[b] + i) mod P], in order of i, the
// table bf16 (summed in f32, one rounding an add) or int8 (summed in
// int32). The reference fetched with a one-hot product on the MXU; here
// one thread per (row, lane), lanes fastest, reads its element with a
// plain load.
//
// What bounds them on the card: T5 is a dependent chain (each step's
// column depends on the last step's pop), so at the tool's widths it is
// latency-bound: one thread per lane, and the 32 KB (C = 128) or 128 KB
// (C = 512) table stays in L1/L2. T6 reads a 400 KB (bf16) or 276 KB
// (int8) table that stays in L2; each lane's loads walk one row, so the
// loads of a warp hit 32 different columns of one row: neighbouring
// lanes read neighbouring addresses only where their idx are close.
//
// Exactness: every product and sum is rounded on its own (_rn
// intrinsics, -fmad=false); min/max propagate NaN as jnp.minimum and
// jnp.maximum; the float-to-int conversion truncates toward zero as
// astype(int32) does; `%` is made a floor modulo, as jnp's.

#include <cuda_bf16.h>
#include <stdint.h>

#include "slab.cuh"

namespace {

constexpr int kProbeStackMax = BVH_PROBE_STACK_MAX;  // set by kernels.py
constexpr float kMiss = 1e30f;

template <bool Sort8, int Chains>
__global__ void wide_step_probe_kernel(const float* __restrict__ table, int C,
                                       const float* __restrict__ rays, int B,
                                       int stack_depth, int iters,
                                       float* __restrict__ out) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    float inv[3], inv_org[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        inv[a] = __fdiv_rn(1.0f, rays[(3 + a) * B + b]);
        inv_org[a] = __fmul_rn(-inv[a], rays[a * B + b]);
    }
    int top[Chains], sp[Chains], stack[Chains][kProbeStackMax];
    float acc[Chains];
#pragma unroll
    for (int k = 0; k < Chains; ++k) {
        top[k] = 0;
        sp[k] = 0;
        acc[k] = 0.0f;
        for (int s = 0; s < stack_depth; ++s) stack[k][s] = 0;
    }
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int k = 0; k < Chains; ++k) {
            const float* col = table + top[k];
            float key[8];
            int word[8];
            bool any = false;
#pragma unroll
            for (int ch = 0; ch < 8; ++ch) {
                float t0 = 0.0f, t1 = kMiss;
#pragma unroll
                for (int a = 0; a < 3; ++a) {
                    const float lo = col[(ch * 6 + 2 * a) * C];
                    const float hi = col[(ch * 6 + 2 * a + 1) * C];
                    const float tn = __fadd_rn(__fmul_rn(lo, inv[a]), inv_org[a]);
                    const float tf = __fadd_rn(__fmul_rn(hi, inv[a]), inv_org[a]);
                    t0 = bvh::nan_max(t0, bvh::nan_min(tn, tf));
                    t1 = bvh::nan_min(t1, bvh::nan_max(tn, tf));
                }
                const bool hit = t0 <= t1;
                any |= hit;
                key[ch] = hit ? t0 : kMiss;
                word[ch] = static_cast<int>(col[(48 + ch) * C]);
            }
            if (Sort8) bvh::sort8(key, word);
            if (sp[k] < stack_depth) stack[k][sp[k]] = word[0];
            sp[k] = max(sp[k] + (any ? 1 : 0) - 1, 0);
            int popped = 0;
            if (sp[k] < stack_depth) {
                popped = stack[k][sp[k]];
                if (stack_depth > 1) popped = max(popped, 0);
            }
            const int m = (popped + word[1] + it) % C;
            top[k] = m < 0 ? m + C : m;
            acc[k] = __fadd_rn(acc[k], key[0]);
        }
    }
#pragma unroll
    for (int k = 0; k < Chains; ++k) out[k * B + b] = acc[k];
    for (int r = Chains; r < 8; ++r) out[r * B + b] = 0.0f;
}

template <bool Sort8, int Chains>
void launch_probe(const float* table, int C, const float* rays, int B,
                  int stack_depth, int iters, float* out,
                  cudaStream_t stream) {
    const int block = 128;
    wide_step_probe_kernel<Sort8, Chains>
        <<<(B + block - 1) / block, block, 0, stream>>>(
            table, C, rays, B, stack_depth, iters, out);
}

__device__ __forceinline__ float fetch_add(float acc, __nv_bfloat16 v) {
    return __fadd_rn(acc, __bfloat162float(v));
}
__device__ __forceinline__ int fetch_add(int acc, int8_t v) {
    return acc + static_cast<int>(v);
}

template <typename T, typename Acc>
__global__ void column_fetch_kernel(const T* __restrict__ table, int P,
                                    const int* __restrict__ idx, int B,
                                    int iters, Acc* __restrict__ out) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int r = blockIdx.y;
    const T* row = table + static_cast<size_t>(r) * P;
    int c = idx[b];
    Acc acc = 0;
    for (int i = 0; i < iters; ++i) {
        acc = fetch_add(acc, row[c]);
        c = c + 1 == P ? 0 : c + 1;
    }
    out[static_cast<size_t>(r) * B + b] = acc;
}

}  // namespace

// table [64, C] f32 (row-major); rays [8, B] f32 (rows 0-2 origin, 3-5
// direction); out [8, B] f32: rows 0..chains-1 each chain's sum of
// keys[0], the rest 0. chains is 1, 2 or 4; 1 <= stack_depth <=
// BVH_PROBE_STACK_MAX. Returns cudaErrorInvalidValue for other values,
// else cudaGetLastError() after the launch.
extern "C" int bvh_wide_step_probe(const float* table, int C,
                                   const float* rays, int B, int sort8,
                                   int chains, int stack_depth, int iters,
                                   float* out, void* stream) {
    if (stack_depth < 1 || stack_depth > kProbeStackMax ||
        (chains != 1 && chains != 2 && chains != 4))
        return static_cast<int>(cudaErrorInvalidValue);
    if (B > 0) {
        auto s = static_cast<cudaStream_t>(stream);
        if (sort8) {
            if (chains == 1) launch_probe<true, 1>(table, C, rays, B, stack_depth, iters, out, s);
            else if (chains == 2) launch_probe<true, 2>(table, C, rays, B, stack_depth, iters, out, s);
            else launch_probe<true, 4>(table, C, rays, B, stack_depth, iters, out, s);
        } else {
            if (chains == 1) launch_probe<false, 1>(table, C, rays, B, stack_depth, iters, out, s);
            else if (chains == 2) launch_probe<false, 2>(table, C, rays, B, stack_depth, iters, out, s);
            else launch_probe<false, 4>(table, C, rays, B, stack_depth, iters, out, s);
        }
    }
    return static_cast<int>(cudaGetLastError());
}

// table [rows, P], bf16 (int8 = 0) or int8 (int8 = 1); idx [B] i32 in
// [0, P); out [rows, B], f32 for bf16 and i32 for int8. Returns
// cudaGetLastError() after the launch.
extern "C" int bvh_column_fetch(const void* table, int int8, int rows, int P,
                                const int* idx, int B, int iters, void* out,
                                void* stream) {
    if (B > 0 && rows > 0) {
        const int block = 128;
        const dim3 grid((B + block - 1) / block, rows);
        auto s = static_cast<cudaStream_t>(stream);
        if (int8)
            column_fetch_kernel<int8_t, int><<<grid, block, 0, s>>>(
                static_cast<const int8_t*>(table), P, idx, B, iters,
                static_cast<int*>(out));
        else
            column_fetch_kernel<__nv_bfloat16, float><<<grid, block, 0, s>>>(
                static_cast<const __nv_bfloat16*>(table), P, idx, B, iters,
                static_cast<float*>(out));
    }
    return static_cast<int>(cudaGetLastError());
}
