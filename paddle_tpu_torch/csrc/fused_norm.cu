// Fused (bias + residual +) RMS / LayerNorm forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/fused_norm.py `_norm_kernel` (:58),
// launched by `_pallas_norm_fwd` (:93) under `fused_norm_pallas` (:223),
// which `incubate.nn.functional.fused_rms_norm` / `fused_layer_norm`
// call in every layer of the incubate fused transformer blocks.
//
// What it computes, in the JAX kernel's order: z = x (+ bias) (+
// residual) in x's dtype (bias first, each add rounded to x's dtype), the
// statistics of z in f32 (RMS: mean of squares; LayerNorm: the mean, then
// the mean of squares of z - mean, not E[z^2] - mean^2), y = norm(z) * w
// + b in f32 with one rounding to x's dtype at the end.  z is written too
// when bias or residual is given (the residual stream of the next layer).
//
// Bound on this card: device-memory bytes.  Each element is read once
// from x (and residual) and written once to y (and z); a few flops per
// element, far below the ~295 flops per byte where the H100 stops being
// bandwidth bound.
//
// Design: one block of FN_THREADS threads per row.  The first pass reads
// the row once, forms z, writes it when wanted, keeps it as f32 in
// dynamic shared memory ([d] floats per block) and sums it; the centred
// second moment (LayerNorm) and the output pass read shared memory only,
// so device memory sees one read of (x, residual) and one write of (y,
// z), as the TPU kernel's one VMEM pass.  Block sums are warp shuffles,
// then one shared slot per warp.  Any d >= 1 (the TPU kernel's d % 128
// gate is a VMEM layout rule) up to what shared memory holds; any row
// count.  w and b are f32 or x's dtype.  Multiplies and adds are
// __fmul_rn / __fadd_rn in the plain version's order, so no FMA
// contraction parts the two.
#include "common.cuh"

#define FN_THREADS 256
#define FN_WARPS (FN_THREADS / 32)

// Sum over the block; every thread gets the result.  `red` holds
// FN_WARPS floats; the call ends with the block synchronised.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // `red` may still be read from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < FN_WARPS; ++w) s += red[w];
  return s;
}

template <typename T, typename W, bool RMS>
__global__ void __launch_bounds__(FN_THREADS) fused_norm_kernel(
    const T* __restrict__ x, const W* __restrict__ w, const W* __restrict__ b,
    const T* __restrict__ bias, const T* __restrict__ res, T* __restrict__ y,
    T* __restrict__ z, int d, float eps) {
  extern __shared__ float zs[];  // [d] f32 (the rounded z)
  __shared__ float red[FN_WARPS];
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  const T* rr = res ? res + row * d : nullptr;
  T* zr = z ? z + row * d : nullptr;
  T* yr = y + row * d;

  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += FN_THREADS) {
    T zi = xr[i];
    if (bias) zi = from_f<T>(__fadd_rn(to_f(zi), to_f(bias[i])));
    if (rr) zi = from_f<T>(__fadd_rn(to_f(zi), to_f(rr[i])));
    if (zr) zr[i] = zi;
    const float zf = to_f(zi);
    zs[i] = zf;
    s += RMS ? __fmul_rn(zf, zf) : zf;
  }
  const float inv_d = 1.f / (float)d;
  const float m1 = block_sum(s, red) * inv_d;
  float mu = 0.f, var = m1;
  if (!RMS) {
    mu = m1;
    float c = 0.f;
    for (int i = threadIdx.x; i < d; i += FN_THREADS) {
      const float t = __fadd_rn(zs[i], -mu);
      c += __fmul_rn(t, t);
    }
    var = block_sum(c, red) * inv_d;
  }
  const float inv = rsqrtf(var + eps);
  for (int i = threadIdx.x; i < d; i += FN_THREADS) {
    float t = __fmul_rn(RMS ? zs[i] : __fadd_rn(zs[i], -mu), inv);
    if (w) t = __fmul_rn(t, to_f(w[i]));
    if (b) t = __fadd_rn(t, to_f(b[i]));
    yr[i] = from_f<T>(t);
  }
}

template <typename T, typename W, bool RMS>
static int launch(const void* x, const void* w, const void* b,
                  const void* bias, const void* res, void* y, void* z,
                  long long rows, int d, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)d;
  auto kern = fused_norm_kernel<T, W, RMS>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  kern<<<(unsigned)rows, FN_THREADS, smem, stream>>>(
      (const T*)x, (const W*)w, (const W*)b, (const T*)bias, (const T*)res,
      (T*)y, (T*)z, d, eps);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
static int dispatch(const void* x, const void* w, const void* b,
                    const void* bias, const void* res, void* y, void* z,
                    long long rows, int d, float eps, int rms,
                    cudaStream_t s) {
  if (rms)
    return launch<T, W, true>(x, w, b, bias, res, y, z, rows, d, eps, s);
  return launch<T, W, false>(x, w, b, bias, res, y, z, rows, d, eps, s);
}

// x / residual / y / z [rows, d] in `dtype`; bias [d] in `dtype`; w / b
// [d] in `wdtype`; w, b, bias, residual and z may be null (z is written
// when given).  rms = 1: RMSNorm, 0: LayerNorm.
extern "C" int fused_norm(const void* x, const void* w, const void* b,
                          const void* bias, const void* res, void* y, void* z,
                          long long rows, int d, float eps, int rms,
                          int dtype, int wdtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == PT_BF16) {
    if (wdtype == PT_BF16)
      return dispatch<__nv_bfloat16, __nv_bfloat16>(x, w, b, bias, res, y, z,
                                                    rows, d, eps, rms, s);
    return dispatch<__nv_bfloat16, float>(x, w, b, bias, res, y, z, rows, d,
                                          eps, rms, s);
  }
  if (wdtype == PT_BF16)
    return dispatch<float, __nv_bfloat16>(x, w, b, bias, res, y, z, rows, d,
                                          eps, rms, s);
  return dispatch<float, float>(x, w, b, bias, res, y, z, rows, d, eps, rms,
                                s);
}
