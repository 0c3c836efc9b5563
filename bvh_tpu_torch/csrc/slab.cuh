// Ray-box slab arithmetic shared by the portal-collect, traversal and
// probe kernels, rounded exactly as the reference kernels round it
// (bvh_tpu/traverse/collect.py:44-56, wide_treelet.py:757-769), and the
// 8-way sorting network of the wide-node step; and the grid of the
// persistent kernels, whose warps take work until none is left.
//
// Every product and sum goes through the _rn intrinsics, which nvcc
// never contracts into an FMA, so the kernels agree with their plain
// PyTorch versions op for op whatever the contraction flags; the build
// also passes -fmad=false for the code written with plain operators.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace bvh {

constexpr float kEps = 1.1920928955078125e-07f;   // FLT_EPSILON
constexpr float kBig = 3.4028234663852886e+38f;   // FLT_MAX

// A ray of `Dim` axes with its precomputed inverses.
template <int Dim>
struct RayInvN {
    float org[Dim], dir[Dim];
    float inv[Dim];      // 1/dir (robust) or the clamped safe inverse (fast)
    float inv_org[Dim];  // -inv * org, for the fast form
    float inv_pad[Dim];  // inv padded by 2 ulps where finite (robust form)
    bool neg[Dim];       // sign bit of dir
};
using RayInv = RayInvN<3>;

template <int Dim>
__device__ __forceinline__ RayInvN<Dim> make_ray_inv(const float (&o)[Dim],
                                                     const float (&d)[Dim],
                                                     bool robust) {
    RayInvN<Dim> r;
#pragma unroll
    for (int i = 0; i < Dim; ++i) {
        r.org[i] = o[i];
        r.dir[i] = d[i];
        float inv = __fdiv_rn(1.0f, d[i]);
        if (!robust && fabsf(d[i]) <= kEps)
            inv = signbit(d[i]) ? -kBig : kBig;
        r.inv[i] = inv;
        r.inv_org[i] = __fmul_rn(-inv, o[i]);
        r.inv_pad[i] = isfinite(inv)
            ? __int_as_float(__float_as_int(inv) + 2) : inv;
        r.neg[i] = signbit(d[i]);
    }
    return r;
}

// Near and far plane distances of one box axis.
template <int Dim>
__device__ __forceinline__ void slab_axis(const RayInvN<Dim>& r, int i,
                                          float lo, float hi, bool robust,
                                          float& tn, float& tf) {
    const float nb = r.neg[i] ? hi : lo;
    const float fb = r.neg[i] ? lo : hi;
    if (robust) {
        tn = __fmul_rn(__fsub_rn(nb, r.org[i]), r.inv[i]);
        tf = __fmul_rn(__fsub_rn(fb, r.org[i]), r.inv_pad[i]);
    } else {
        tn = __fadd_rn(__fmul_rn(nb, r.inv[i]), r.inv_org[i]);
        tf = __fadd_rn(__fmul_rn(fb, r.inv[i]), r.inv_org[i]);
    }
}

// robust_max / robust_min of bvh_tpu.core.utils: NaN in `a` yields `b`.
__device__ __forceinline__ float robust_max(float a, float b) {
    return a > b ? a : b;
}
__device__ __forceinline__ float robust_min(float a, float b) {
    return a < b ? a : b;
}

// jnp.maximum / jnp.minimum: NaN in either operand yields NaN.
// fmaxf/fminf would swallow it.
__device__ __forceinline__ float nan_max(float a, float b) {
    return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a > b ? a : b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
    return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a < b ? a : b);
}

// The 19-comparator Batcher odd-even merge network of the reference's
// `_sort8` (bvh_tpu/traverse/wide_treelet.py:713-731), strict >: sorts
// 8 keys ascending and carries their words. Not stable.
__device__ __forceinline__ void cmp_swap(float* k, int* w, int a, int b) {
    if (k[a] > k[b]) {
        const float kt = k[a];
        k[a] = k[b];
        k[b] = kt;
        const int wt = w[a];
        w[a] = w[b];
        w[b] = wt;
    }
}

__device__ __forceinline__ void sort8(float* k, int* w) {
    cmp_swap(k, w, 0, 1); cmp_swap(k, w, 2, 3);
    cmp_swap(k, w, 4, 5); cmp_swap(k, w, 6, 7);
    cmp_swap(k, w, 0, 2); cmp_swap(k, w, 1, 3);
    cmp_swap(k, w, 4, 6); cmp_swap(k, w, 5, 7);
    cmp_swap(k, w, 1, 2); cmp_swap(k, w, 5, 6);
    cmp_swap(k, w, 0, 4); cmp_swap(k, w, 1, 5);
    cmp_swap(k, w, 2, 6); cmp_swap(k, w, 3, 7);
    cmp_swap(k, w, 2, 4); cmp_swap(k, w, 3, 5);
    cmp_swap(k, w, 1, 2); cmp_swap(k, w, 3, 4); cmp_swap(k, w, 5, 6);
}

// The CTAs of `block` threads of `Kernel` that the current card holds
// at once (its SMs times the occupancy calculator's CTAs an SM), the
// grid of a persistent kernel; worked out once per device and kept.
template <auto Kernel>
cudaError_t persistent_grid(int block, int& grid) {
    constexpr int kMaxDevices = 64;
    static std::atomic<int> grids[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    grid = dev < kMaxDevices ? grids[dev].load(std::memory_order_relaxed) : 0;
    if (grid != 0) return cudaSuccess;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel,
                                                            block, 0);
    if (err != cudaSuccess) return err;
    grid = sms * per_sm;
    if (dev < kMaxDevices) grids[dev].store(grid, std::memory_order_relaxed);
    return cudaSuccess;
}

}  // namespace bvh

extern "C" const char* bvh_cuda_error_string(int err);
