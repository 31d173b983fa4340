// Shared device helpers of the port's attention kernels: dtype codes,
// f32 conversion (f32, bf16 and f16), warp reductions, and the finite
// mask constant.
//
// NEG_INF is the JAX package's finite -1e30 (flash_attention.py:69),
// not -inf: a fully masked row (a left-pad query) then gets finite,
// uniform weights instead of exp(-inf - -inf) = NaN, and its finite
// output cannot poison the next layer's real rows.  The 1e-30 clamp on
// the softmax denominator (flash_attention.py:237) is kept for the same
// reason.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PT_NEG_INF (-1e30f)
#define PT_L_MIN (1e-30f)
#define PT_FULL_MASK 0xffffffffu

enum PtDtype { PT_F32 = 0, PT_BF16 = 1, PT_F16 = 2 };

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(PT_FULL_MASK, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(PT_FULL_MASK, x, o));
  return x;
}

// Lanes per head_dim chunk: a thread owns elements d = lane + 32 * j,
// j < NJ.  The launchers round ceil(D / 32) up to 1, 2, 4 or 8.
static inline int pt_nj(int d) {
  int nj = (d + 31) / 32;
  return nj <= 1 ? 1 : nj <= 2 ? 2 : nj <= 4 ? 4 : 8;
}

// The 16-byte alignment that vector copies and stores need (a row of a
// multiple of 16 bytes keeps every row aligned when the base is); checked
// by the host launchers.  A null pointer passes: an absent operand.
static inline bool tc_aligned(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// Packed (varlen) batches: cu [n + 1] holds cumulative lengths, and
// position t of a packed axis belongs to segment
// searchsorted(cu, t, side="right") - 1, in -1 .. n (JAX
// varlen_attention.py:40-45), so repeated entries (empty sequences) are
// skipped.  Binary search over the n + 1 entries.
__device__ __forceinline__ int pt_segment(const int* __restrict__ cu, int n,
                                          int t) {
  int lo = 0, hi = n + 1;  // the first index with cu[i] > t
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cu[mid] <= t) lo = mid + 1;
    else hi = mid;
  }
  return lo - 1;
}

// Start of segment i (-1 .. n + 1) of a packed axis of length T: the
// positions of segment i are [pt_bound(i), pt_bound(i + 1)).  Segment -1
// holds positions before cu[0], segment n those from cu[n] on.
__device__ __forceinline__ int pt_bound(const int* __restrict__ cu, int n,
                                        int T, int i) {
  return i < 0 ? 0 : i > n ? T : cu[i];
}
