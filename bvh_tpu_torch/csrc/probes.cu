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
// In the reference sp never leaves 0 (ROADMAP C18); the kernel keeps
// the push and the pop at the run-time sp all the same, since they are
// half of what the probe prices.
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
// What bounds T5 on the card: each step's column is the last step's pop,
// so a chain is a string of dependent steps and, at the tool's 512-8,192
// lanes, the probe measures one step's latency. One thread a lane,
// reading the row-major table, spent a step on 56 scalar loads whose 32
// lanes touched up to 32 cache lines each, and kept its stack in local
// memory. The design:
// - a (ray, chain) runs on a group of 8 lanes, lane c on child c: its own
//   slab test, with `any` a ballot over the group;
// - each block stages the table once in shared memory, a column a
//   272-byte row: child c's (lo0, hi0, lo1, hi1) at floats 4c..4c+3 and
//   its (lo2, hi2, word, 0) at 32 + 4c.., the word already truncated to
//   int. A lane's step reads two 16-byte chunks, and a group's 8 lanes
//   read two whole 128-byte runs: one shared-memory wavefront each. The
//   4 floats of padding (68 a column, not 64) put the staging's
//   transposed writes (a warp: 8 neighbouring columns x the 4 floats of
//   one chunk, read as 4 rows of 32 bytes) into 32 distinct banks;
// - `_sort8`: every lane gathers the group's 8 keys and words (16
//   shuffles, none waiting on another) and runs the 19 comparators in
//   registers, layer by layer from kernels.SORT8_LAYERS (compiled in as
//   BVH_SORT8_LAYER0-5: nibble c of a layer is lane c's partner), each
//   a strict k[a] > k[b] swap, as the reference's. So every lane holds
//   keys[0], words[0] and words[1]; unsorted, words[0] and words[1] come
//   from lanes 0 and 1 by shuffle and lane 0's key is keys[0];
// - every lane of the group runs the push and the pop on the chain's
//   stack in shared memory (the same address and value in all 8), so
//   `top` needs no further shuffle; lane 0 writes acc;
// - the slab's NaN-propagating min and max are min.NaN / max.NaN;
// - top takes x & (C - 1) where C is a power of two (the floor modulo
//   for negative x too), else % with the floor fix;
// - the chains' steps run stage by stage (fetch and slab, sort, stack),
//   so that their dependent strings interleave;
// - persistent blocks: as many as the card holds at the launch's shared
//   memory (the occupancy calculator), each staging the table once and
//   taking groups of rays by grid stride. Groups past B run the last
//   ray, so that every shuffle has its 32 lanes, and store nothing.
//   The block (`probe_launch`) is 128 threads (16 rays) unless the rays
//   fill every SM's blocks at 512 or 256: at the tool's widths a
//   128-thread block gives each SM one block, a warp a scheduler.
// Measured with tools/compare_checkouts.py (H100 80GB HBM3, 700 W; T5
// at B 2,048 / 262,144 lanes, C 128, sort8, 512 iterations, the
// device's own time): 0.110 / 5.56-5.60 ms against the one-thread-a-lane
// kernel's 0.448 / 4.50 in the same call. Tried on the card and dropped,
// each in one call beside an earlier form of this design (0.1381 /
// 5.624 ms; its pop a branch, its staging waiting on each load in
// turn): the sort as 6 layers of shuffle exchanges, both lanes of a pair
// deciding from the same comparison, 0.1823 / 6.071 (each layer waits
// out a shuffle's round trip); with it slab.cuh's compare-and-select
// min and max, 0.2097 / 8.171; the pop forwarded from the push where sp
// did not move, its load issued before the sort, 0.1336 / 5.800 (3%
// either way, and it takes the store-load pair off the priced string);
// 128-thread blocks at 262,144 lanes, 6.047; 256-thread blocks at 2,048
// lanes, 0.1560. That staging took 17 µs (C 128) and 66 µs (C 512) of a
// launch against the same kernel without it; 16 loads in flight a
// thread take 3-9. At 262,144 lanes a group of 8 lanes issues about 4
// times the instructions a ray of one thread a lane does: one thread a
// ray on this staged table took 2.665 ms there (and 0.313 at 2,048).
//
// What bounds T6: it reads a 400 KB (bf16) or 276 KB (int8) table that
// stays in L2. At the tool's B = 512 lanes and 200
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

#include <atomic>

#include "slab.cuh"

namespace {

constexpr int kProbeStackMax = BVH_PROBE_STACK_MAX;  // set by kernels.py
constexpr float kMiss = 1e30f;
constexpr int kGroup = 8;      // lanes a (ray, chain): one a child
constexpr int kColumn = 68;    // floats a staged column: 64 and 4 of pad
constexpr int kHalf = 32;      // floats from a chunk to its second half
// Layer l of the sorting network, set by kernels.py from SORT8_LAYERS:
// nibble c is lane c's partner.
__host__ __device__ constexpr unsigned sort_layer(int l) {
    return l == 0 ? BVH_SORT8_LAYER0 : l == 1 ? BVH_SORT8_LAYER1
         : l == 2 ? BVH_SORT8_LAYER2 : l == 3 ? BVH_SORT8_LAYER3
         : l == 4 ? BVH_SORT8_LAYER4 : BVH_SORT8_LAYER5;
}

// Copy the [64, C] table into cols [C][kColumn]: for child ch, chunk ch
// (rows 6ch..6ch+3) and chunk 8 + ch (rows 6ch+4, 6ch+5, the word of
// row 48 + ch truncated to int, 0). Item i is float j of every chunk in
// column col; a warp's 32 items are the 4 floats of the chunks in 8
// neighbouring columns. A thread issues the 16 loads of its item with no
// branch between them before it converts and stores any, so that they
// wait out one L2 round trip together.
__device__ __forceinline__ void stage_table(const float* __restrict__ table,
                                            int C, float* cols) {
    const int per_chunk = 4 * ((C + 7) & ~7);
    for (int i = threadIdx.x; i < per_chunk; i += blockDim.x) {
        const int j = (i >> 3) & 3;
        const int col = (i >> 5) * 8 + (i & 7);
        if (col >= C) continue;
        const float* src = table + col;
        float* dst = cols + col * kColumn + j;
        float v[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) {
            const int ch = q & 7;
            const int row = q < 8 ? 6 * ch + j
                          : j < 2 ? 6 * ch + 4 + j : 48 + ch;
            v[q] = q < 8 || j < 3 ? __ldg(src + row * C) : 0.0f;  // j 3: pad
        }
#pragma unroll
        for (int q = 0; q < 16; ++q)
            dst[(q >> 3) * kHalf + 4 * (q & 7)] =
                q >= 8 && j == 2 ? __int_as_float(static_cast<int>(v[q]))
                                 : v[q];
    }
}

// min and max that return NaN where either operand is NaN, as
// jnp.minimum and jnp.maximum: one instruction each on sm_80 and later,
// where slab.cuh's compare-and-select takes four. Of two zeros they may
// keep the other sign than the plain version, which the output cannot
// show: t0 and t1 meet only in comparisons, where -0 == +0, and in
// acc += keys[0], whose acc starts at +0, so never becomes -0, and
// x + (-0) == x + (+0) for every other x.
__device__ __forceinline__ float min_nan(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

__device__ __forceinline__ void slab(float lo, float hi, float inv,
                                     float inv_org, float& t0, float& t1) {
    const float tn = __fadd_rn(__fmul_rn(lo, inv), inv_org);
    const float tf = __fadd_rn(__fmul_rn(hi, inv), inv_org);
    t0 = max_nan(t0, min_nan(tn, tf));
    t1 = min_nan(t1, max_nan(tn, tf));
}

// The network of kernels.SORT8_LAYERS on 8 keys and words in registers:
// layer by layer, the pair (a, b), a < b, swaps where k[a] > k[b]
// (strict: not stable). Unrolled, the partners are constants and this
// is the 19 comparators in the reference's order.
__device__ __forceinline__ void sort8_layers(float (&k)[8], int (&w)[8]) {
#pragma unroll
    for (int l = 0; l < 6; ++l) {
#pragma unroll
        for (int a = 0; a < 8; ++a) {
            const int b = (sort_layer(l) >> (4 * a)) & 7;
            if (a < b) bvh::cmp_swap(k, w, a, b);
        }
    }
}

// Dynamic shared memory: the staged table, then the stacks,
// stack[s][slot] with slot = (ray in block) * Chains + chain.
template <bool Sort8, int Chains>
__global__ void wide_step_probe_kernel(const float* __restrict__ table, int C,
                                       const float* __restrict__ rays, int B,
                                       int stack_depth, int iters,
                                       float* __restrict__ out) {
    extern __shared__ float4 smem[];
    float* cols = reinterpret_cast<float*>(smem);
    const int group_rays = blockDim.x / kGroup;
    const int slots = group_rays * Chains;
    int* stacks = reinterpret_cast<int*>(cols + C * kColumn);
    stage_table(table, C, cols);
    __syncthreads();

    const int lane = threadIdx.x & (kGroup - 1);
    const int gi = threadIdx.x / kGroup;                 // ray in block
    const int gshift = threadIdx.x & (32 - kGroup);      // its ballot bits
    const bool pow2 = (C & (C - 1)) == 0;
    const float* my_col = cols + 4 * lane;
    int* my_stack = stacks + gi * Chains;

    for (int base = blockIdx.x * group_rays; base < B;
         base += gridDim.x * group_rays) {
        const int b = base + gi;
        const int rb = b < B ? b : B - 1;
        float inv[3], inv_org[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            inv[a] = __fdiv_rn(1.0f, rays[(3 + a) * B + rb]);
            inv_org[a] = __fmul_rn(-inv[a], rays[a * B + rb]);
        }
        int top[Chains], sp[Chains];
        float acc[Chains];
#pragma unroll
        for (int k = 0; k < Chains; ++k) {
            top[k] = 0;
            sp[k] = 0;
            acc[k] = 0.0f;
            for (int s = 0; s < stack_depth; ++s) my_stack[s * slots + k] = 0;
        }
        // A step of every chain, stage by stage, so that the chains'
        // dependent strings interleave.
        for (int it = 0; it < iters; ++it) {
            float key[Chains];
            int word[Chains];
            bool any[Chains];
#pragma unroll
            for (int k = 0; k < Chains; ++k) {
                const float* col = my_col + top[k] * kColumn;
                const float4 p = *reinterpret_cast<const float4*>(col);
                const float4 q = *reinterpret_cast<const float4*>(col + kHalf);
                float t0 = 0.0f, t1 = kMiss;
                slab(p.x, p.y, inv[0], inv_org[0], t0, t1);
                slab(p.z, p.w, inv[1], inv_org[1], t0, t1);
                slab(q.x, q.y, inv[2], inv_org[2], t0, t1);
                const bool hit = t0 <= t1;
                key[k] = hit ? t0 : kMiss;
                word[k] = __float_as_int(q.z);
                any[k] =
                    ((__ballot_sync(0xffffffffu, hit) >> gshift) & 0xffu) != 0;
            }
            // keys[0] (lane 0's key unsorted), words[0] and words[1] on
            // every lane: sorted, each lane gathers the group's 8 keys and
            // words and runs the network itself
            int w0[Chains], w1[Chains];
#pragma unroll
            for (int k = 0; k < Chains; ++k) {
                if (Sort8) {
                    float kk[8];
                    int ww[8];
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        kk[j] = __shfl_sync(0xffffffffu, key[k], j, kGroup);
                        ww[j] = __shfl_sync(0xffffffffu, word[k], j, kGroup);
                    }
                    sort8_layers(kk, ww);
                    key[k] = kk[0];
                    w0[k] = ww[0];
                    w1[k] = ww[1];
                } else {
                    w0[k] = __shfl_sync(0xffffffffu, word[k], 0, kGroup);
                    w1[k] = __shfl_sync(0xffffffffu, word[k], 1, kGroup);
                }
            }
#pragma unroll
            for (int k = 0; k < Chains; ++k) {
                int* st = my_stack + k;
                if (sp[k] < stack_depth) st[sp[k] * slots] = w0[k];
                sp[k] = max(sp[k] + (any[k] ? 1 : 0) - 1, 0);
                // the pop loads a slot in bounds whatever sp, so that it
                // is not a branch, and keeps it only where sp < stack_depth
                int popped = st[min(sp[k], stack_depth - 1) * slots];
                if (stack_depth > 1) popped = max(popped, 0);
                if (sp[k] >= stack_depth) popped = 0;
                // int32 sums wrap, as the plain version's
                const int x = static_cast<int>(static_cast<unsigned>(popped) +
                                               static_cast<unsigned>(w1[k]) +
                                               static_cast<unsigned>(it));
                if (pow2) {
                    top[k] = x & (C - 1);
                } else {
                    const int m = x % C;
                    top[k] = m < 0 ? m + C : m;
                }
                acc[k] = __fadd_rn(acc[k], key[k]);
            }
        }
        if (b < B) {
            if (lane == 0) {
#pragma unroll
                for (int k = 0; k < Chains; ++k) out[k * B + b] = acc[k];
            } else if (lane >= Chains) {
                out[lane * B + b] = 0.0f;
            }
        }
    }
}

// Threads a block of T5: 128 (16 rays), or 256 or 512 where the rays
// fill every SM's blocks at that size.
constexpr int kProbeBlocks[3] = {512, 256, 128};

size_t probe_smem(int C, int block, int chains, int stack_depth) {
    return static_cast<size_t>(C) * kColumn * sizeof(float) +
           static_cast<size_t>(block / kGroup) * chains * stack_depth *
               sizeof(int);
}

// The launch of T5 on this device: block, grid, dynamic shared memory
// and blocks an SM. The kernel's shared-memory limit is raised to the
// device's once per device.
template <bool Sort8, int Chains>
cudaError_t probe_launch(int C, int B, int stack_depth, int& block,
                         int& grid, size_t& smem, int& per_sm) {
    constexpr int kMaxDevices = 64;
    static std::atomic<int> optin[kMaxDevices];
    static std::atomic<int> sm_count[kMaxDevices];
    auto kernel = wide_step_probe_kernel<Sort8, Chains>;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (optin[dev].load(std::memory_order_relaxed) == 0) {
        int most = 0, sms = 0;
        err = cudaDeviceGetAttribute(
            &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(
                &sms, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
        if (err != cudaSuccess) return err;
        sm_count[dev].store(sms, std::memory_order_relaxed);
        optin[dev].store(most, std::memory_order_relaxed);
    }
    const size_t most = optin[dev].load(std::memory_order_relaxed);
    const int sms = sm_count[dev].load(std::memory_order_relaxed);
    for (int i = 0; i < 3; ++i) {
        block = kProbeBlocks[i];
        smem = probe_smem(C, block, Chains, stack_depth);
        per_sm = 0;
        if (smem <= most) {
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, block, smem);
            if (err != cudaSuccess) return err;
        }
        const long long groups = (B + block / kGroup - 1) / (block / kGroup);
        if (per_sm > 0 && (groups >= static_cast<long long>(sms) * per_sm ||
                           i == 2)) {
            grid = static_cast<int>(
                groups < static_cast<long long>(sms) * per_sm
                    ? groups : static_cast<long long>(sms) * per_sm);
            return cudaSuccess;
        }
    }
    return cudaErrorInvalidValue;  // the table does not fit a block
}

template <bool Sort8, int Chains>
cudaError_t launch_probe(const float* table, int C, const float* rays, int B,
                         int stack_depth, int iters, float* out,
                         cudaStream_t stream) {
    int block = 0, grid = 0, per_sm = 0;
    size_t smem = 0;
    cudaError_t err =
        probe_launch<Sort8, Chains>(C, B, stack_depth, block, grid, smem, per_sm);
    if (err != cudaSuccess) return err;
    wide_step_probe_kernel<Sort8, Chains><<<grid, block, smem, stream>>>(
        table, C, rays, B, stack_depth, iters, out);
    return cudaGetLastError();
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
// BVH_PROBE_STACK_MAX; C >= 1, and the staged table (272 bytes a
// column) with the stacks must fit a block's shared memory (C up to
// about 800 on an H100). Returns cudaErrorInvalidValue for other values,
// else cudaGetLastError() after the launch.
extern "C" int bvh_wide_step_probe(const float* table, int C,
                                   const float* rays, int B, int sort8,
                                   int chains, int stack_depth, int iters,
                                   float* out, void* stream) {
    if (stack_depth < 1 || stack_depth > kProbeStackMax || C < 1 ||
        (chains != 1 && chains != 2 && chains != 4))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSuccess;
    if (B > 0) {
        auto s = static_cast<cudaStream_t>(stream);
        if (sort8) {
            if (chains == 1) err = launch_probe<true, 1>(table, C, rays, B, stack_depth, iters, out, s);
            else if (chains == 2) err = launch_probe<true, 2>(table, C, rays, B, stack_depth, iters, out, s);
            else err = launch_probe<true, 4>(table, C, rays, B, stack_depth, iters, out, s);
        } else {
            if (chains == 1) err = launch_probe<false, 1>(table, C, rays, B, stack_depth, iters, out, s);
            else if (chains == 2) err = launch_probe<false, 2>(table, C, rays, B, stack_depth, iters, out, s);
            else err = launch_probe<false, 4>(table, C, rays, B, stack_depth, iters, out, s);
        }
    }
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The launch that bvh_wide_step_probe makes for these arguments:
// out = {threads a block, blocks, dynamic shared memory bytes, blocks an
// SM}. Returns as bvh_wide_step_probe would, without launching.
extern "C" int bvh_wide_step_probe_launch(int C, int B, int sort8, int chains,
                                          int stack_depth, int* out) {
    if (stack_depth < 1 || stack_depth > kProbeStackMax || C < 1 || B < 1 ||
        (chains != 1 && chains != 2 && chains != 4))
        return static_cast<int>(cudaErrorInvalidValue);
    size_t smem = 0;
    cudaError_t err;
    if (sort8) {
        if (chains == 1) err = probe_launch<true, 1>(C, B, stack_depth, out[0], out[1], smem, out[3]);
        else if (chains == 2) err = probe_launch<true, 2>(C, B, stack_depth, out[0], out[1], smem, out[3]);
        else err = probe_launch<true, 4>(C, B, stack_depth, out[0], out[1], smem, out[3]);
    } else {
        if (chains == 1) err = probe_launch<false, 1>(C, B, stack_depth, out[0], out[1], smem, out[3]);
        else if (chains == 2) err = probe_launch<false, 2>(C, B, stack_depth, out[0], out[1], smem, out[3]);
        else err = probe_launch<false, 4>(C, B, stack_depth, out[0], out[1], smem, out[3]);
    }
    out[2] = static_cast<int>(smem);
    return static_cast<int>(err);
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
