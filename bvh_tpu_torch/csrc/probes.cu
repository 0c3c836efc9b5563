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
// each fetch is a plain load of a column, from a column-major copy of
// the table, cols[P, rows_pad] (`column_copy`, made once outside the
// timed call), its rows padded to the run.
//
// What bounds them on the card: T5 is a dependent chain (each step's
// column depends on the last step's pop), so at the tool's widths it is
// latency-bound: one thread per lane, and the 32 KB (C = 128) or 128 KB
// (C = 512) table stays in L1/L2. T6 reads a 400 KB (bf16) or 276 KB
// (int8) table that stays in L2. At the tool's B = 512 lanes and 200
// fetches a lane it is neither bytes nor operations but the instructions
// of a few thousand threads: with one thread per 16 bytes of a column
// there were under 3 warps an SM, about one a scheduler, and each waited
// out its own instructions' latency. The design: a thread owns an
// 8-byte run of one lane's column (4 bf16 or 8 int8) and fetches it
// with one vector load a fetch; neighbouring threads own neighbouring
// runs of the same lane, so a warp's load is a contiguous stretch of
// one column. The loads of kFetchDepth fetches
// are written before their adds (the compiler keeps about 6 in flight),
// and each row keeps its own accumulator, so every output still sums in
// order of i. The output goes out lane-major, [B, rows_pad], one
// contiguous store a thread. (On the [rows, P] table itself, one thread
// per (row, lane), a warp's 32 lanes read 32 unrelated columns of one
// row, up to 32 sectors a load.) Tried on the card and dropped: 16-byte
// runs (fewer warps: slower), 4-byte runs (no faster), asynchronous
// copies into shared memory (cp.async, 16-64 in flight: no faster, so
// the loads in flight were not the limit), 64-thread blocks.

// Exactness: every product and sum is rounded on its own (_rn
// intrinsics, -fmad=false); min/max propagate NaN as jnp.minimum and
// jnp.maximum; the float-to-int conversion truncates toward zero as
// astype(int32) does; `%` is made a floor modulo, as jnp's.

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

// Threads a block of the column fetch, and the fetches whose loads a
// thread issues before their adds. A thread's run of a column is 8
// bytes: 4 bf16 or 8 int8.
constexpr int kFetchBlock = 32;
constexpr int kFetchDepth = 32;

// Add one 8-byte run to its accumulators: 4 bf16 (exactly widened to
// f32, then one rounding an add) or 8 int8.
__device__ __forceinline__ void add_run(float (&acc)[4], uint2 v) {
    const unsigned w[2] = {v.x, v.y};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        acc[2 * k] = __fadd_rn(acc[2 * k], __uint_as_float(w[k] << 16));
        acc[2 * k + 1] =
            __fadd_rn(acc[2 * k + 1], __uint_as_float(w[k] & 0xffff0000u));
    }
}
__device__ __forceinline__ void add_run(int (&acc)[8], uint2 v) {
    const unsigned w[2] = {v.x, v.y};
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            acc[4 * k + j] += static_cast<int>(w[k] << (24 - 8 * j)) >> 24;
}

__device__ __forceinline__ unsigned word(float x) { return __float_as_uint(x); }
__device__ __forceinline__ unsigned word(int x) { return static_cast<unsigned>(x); }

// cols [P, G runs of 8 bytes]; out [B, G * Run] (Run = 8 bytes' rows).
// Thread t owns run g = t mod G of lane b = t / G.
template <typename Acc, int Run>
__global__ void __launch_bounds__(kFetchBlock)
column_fetch_kernel(const uint2* __restrict__ cols, int G, int P,
                    const int* __restrict__ idx, int B, int iters,
                    Acc* __restrict__ out) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= B * G) return;
    const int b = t / G;
    const uint2* run = cols + (t - b * G);  // column c's run: run[c * G]
    int c = idx[b] % P;                      // a floor modulo, as the
    if (c < 0) c += P;                       // plain version's
    Acc acc[Run];
#pragma unroll
    for (int k = 0; k < Run; ++k) acc[k] = 0;
    int i = 0;
    for (; i + kFetchDepth <= iters; i += kFetchDepth) {
        uint2 v[kFetchDepth];
#pragma unroll
        for (int u = 0; u < kFetchDepth; ++u) {
            v[u] = __ldg(run + static_cast<size_t>(c) * G);
            c = c + 1 == P ? 0 : c + 1;
        }
#pragma unroll
        for (int u = 0; u < kFetchDepth; ++u) add_run(acc, v[u]);
    }
    for (; i < iters; ++i) {
        add_run(acc, __ldg(run + static_cast<size_t>(c) * G));
        c = c + 1 == P ? 0 : c + 1;
    }
    Acc* o = out + static_cast<size_t>(t) * Run;
#pragma unroll
    for (int k = 0; k < Run; k += 4)
        *reinterpret_cast<uint4*>(o + k) =
            make_uint4(word(acc[k]), word(acc[k + 1]), word(acc[k + 2]),
                       word(acc[k + 3]));
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

// cols [P, width] (the table's columns, rows padded to 8 bytes: width
// a multiple of 4 bf16 or 8 int8), bf16 (int8 = 0) or int8 (int8 = 1),
// 8-byte aligned; idx [B] i32 (taken mod P); out [B, width], f32 for
// bf16 and i32 for int8, 16-byte aligned. Returns cudaGetLastError()
// after the launch.
extern "C" int bvh_column_fetch(const void* cols, int int8, int width, int P,
                                const int* idx, int B, int iters, void* out,
                                void* stream) {
    const int G = width / (int8 ? 8 : 4);  // 8-byte runs a column
    const long long threads = static_cast<long long>(B) * G;
    if (threads > 0 && P > 0) {
        const int grid = static_cast<int>((threads + kFetchBlock - 1) / kFetchBlock);
        auto s = static_cast<cudaStream_t>(stream);
        const uint2* c = static_cast<const uint2*>(cols);
        if (int8)
            column_fetch_kernel<int, 8><<<grid, kFetchBlock, 0, s>>>(
                c, G, P, idx, B, iters, static_cast<int*>(out));
        else
            column_fetch_kernel<float, 4><<<grid, kFetchBlock, 0, s>>>(
                c, G, P, idx, B, iters, static_cast<float*>(out));
    }
    return static_cast<int>(cudaGetLastError());
}
