// The order of a portal list's entry distances, shared by the portal
// ordering (csrc/portal_sort.cu) and phase A2 in one launch
// (csrc/super_walk.cu): the order torch.sort(stable=True) gives on the
// card, whose segmented sort is cub's radix sort.
#pragma once

#include <cuda_runtime.h>

namespace bvh {

constexpr unsigned kInfKey = 0xff800000u;     // key of +inf
constexpr unsigned kNegInfKey = 0x007fffffu;  // key of -inf

// The float's bits as cub's radix sort orders them: the sign bit set
// for a positive float, every bit flipped for a negative one; -0.0 takes
// +0.0's key. So -NaN sorts first and +NaN last.
__device__ __forceinline__ unsigned radix_key(float t) {
    const unsigned b = __float_as_uint(t);
    const unsigned k = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
    return k == 0x7fffffffu ? 0x80000000u : k;
}

__device__ __forceinline__ bool finite_key(unsigned k) {
    return k > kNegInfKey && k < kInfKey;
}

__device__ __forceinline__ float pos_inf() {
    return __int_as_float(0x7f800000);
}

}  // namespace bvh
