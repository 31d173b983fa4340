// Rotary position embedding (rope) for Hopper (sm_90a), forward and
// adjoint.
//
// Replaces: paddle_tpu/ops/pallas/rope.py `_rope_kernel` (:40), launched
// by `_rope_call` (:56, pallas_call :67) for the forward of `rope_pallas`
// and, with the adjoint rotation, for its custom-VJP backward
// `_rope_bwd` (:90) — the neox rotation of q and k on the LLaMA path
// (nn/functional/attention.py:255-258).
//
// Bound on this card: device-memory bytes.  Every element of x is read
// once and written once with three flops; the phases add 2 * D elements
// per (b, s) row.
//
// Design: one block per (b, s) row.  The row's cos and sin (D values
// each) are read once into shared memory as f32 and serve every head of
// the row, as the TPU kernel keeps the phases per row block.  Neox style:
// a work item is VEC pairs (d, d + D/2) of one head, so every element is
// read and written once; VEC = 16 / sizeof(T) (16-byte loads) when the
// wrapper finds the pointer, the strides and D/2 aligned to it, else 1.
// Interleaved style (off the main path): a work item is one pair
// (2i, 2i + 1).  Math in f32 with one rounding to the output type, as
// `_rope_kernel` :41-53; the products and the sum are rounded one by one
// (`__fmul_rn` / `__fadd_rn`, which nvcc never contracts into an FMA) in
// the plain version's order, so the kernel equals it bit for bit and a
// bf16 output cannot land one ulp away.  x is read through its batch,
// token and head strides, so the q and k views of the fused qkv
// projection need no copy; the output is contiguous [B, S, H, D].
//
// Adjoint: neox uses the JAX formula, rot = concat(x2, -x1) times the
// same-index sin (:50-52), the exact VJP when both halves of sin are
// equal (the neox phases concat(freqs, freqs)).  The interleaved adjoint
// is the exact VJP of x*cos + rot(x)*sin, which the JAX package gets by
// differentiating its jnp path: g*cos + rot^T(g*sin).
#include "common.cuh"

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// The row's phases into shared memory: cos at [0, D), sin at [D, 2D).
template <typename T>
__device__ __forceinline__ void load_phases(float* ph, const T* cs,
                                            const T* sn, long long off,
                                            int D) {
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    ph[i] = to_f(cs[off + i]);
    ph[D + i] = to_f(sn[off + i]);
  }
  __syncthreads();
}

template <typename T, int VEC>
__global__ void rope_neox_kernel(const T* __restrict__ x,
                                 const T* __restrict__ cs,
                                 const T* __restrict__ sn,
                                 T* __restrict__ out, int S, int H, int D,
                                 long long sxb, long long sxs, long long sxh,
                                 long long spb, int adjoint) {
  extern __shared__ float ph[];
  const int row = blockIdx.x;
  const int b = row / S, s = row - b * S;
  load_phases(ph, cs, sn, (long long)b * spb + (long long)s * D, D);
  const float* c = ph;
  const float* sv = ph + D;
  const int half = D / 2, P = half / VEC;
  const T* xr = x + (long long)b * sxb + (long long)s * sxs;
  T* orow = out + (long long)row * H * D;
  for (int w = threadIdx.x; w < H * P; w += blockDim.x) {
    const int h = w / P, d0 = (w - h * P) * VEC;
    const T* xp = xr + (long long)h * sxh + d0;
    const Pack<T, VEC> a = *reinterpret_cast<const Pack<T, VEC>*>(xp);
    const Pack<T, VEC> e = *reinterpret_cast<const Pack<T, VEC>*>(xp + half);
    Pack<T, VEC> o1, o2;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int d = d0 + j;
      const float x1 = to_f(a.v[j]), x2 = to_f(e.v[j]);
      const float c1 = __fmul_rn(x1, c[d]), s1 = __fmul_rn(x2, sv[d]);
      const float c2 = __fmul_rn(x2, c[d + half]);
      const float s2 = __fmul_rn(x1, sv[d + half]);
      // forward rot = (-x2, x1); adjoint rot = (x2, -x1)
      o1.v[j] = from_f<T>(adjoint ? __fadd_rn(c1, s1) : __fsub_rn(c1, s1));
      o2.v[j] = from_f<T>(adjoint ? __fsub_rn(c2, s2) : __fadd_rn(c2, s2));
    }
    T* op = orow + (long long)h * D + d0;
    *reinterpret_cast<Pack<T, VEC>*>(op) = o1;
    *reinterpret_cast<Pack<T, VEC>*>(op + half) = o2;
  }
}

template <typename T>
__global__ void rope_interleaved_kernel(const T* __restrict__ x,
                                        const T* __restrict__ cs,
                                        const T* __restrict__ sn,
                                        T* __restrict__ out, int S, int H,
                                        int D, long long sxb, long long sxs,
                                        long long sxh, long long spb,
                                        int adjoint) {
  extern __shared__ float ph[];
  const int row = blockIdx.x;
  const int b = row / S, s = row - b * S;
  load_phases(ph, cs, sn, (long long)b * spb + (long long)s * D, D);
  const float* c = ph;
  const float* sv = ph + D;
  const int half = D / 2;
  const T* xr = x + (long long)b * sxb + (long long)s * sxs;
  T* orow = out + (long long)row * H * D;
  for (int w = threadIdx.x; w < H * half; w += blockDim.x) {
    const int h = w / half, d = 2 * (w - h * half);
    const T* xp = xr + (long long)h * sxh + d;
    const float x1 = to_f(xp[0]), x2 = to_f(xp[1]);
    const float c1 = __fmul_rn(x1, c[d]), c2 = __fmul_rn(x2, c[d + 1]);
    float o1, o2;
    if (!adjoint) {   // rot = (-x2, x1) per pair
      o1 = __fsub_rn(c1, __fmul_rn(x2, sv[d]));
      o2 = __fadd_rn(c2, __fmul_rn(x1, sv[d + 1]));
    } else {          // g*cos + rot^T(g*sin)
      o1 = __fadd_rn(c1, __fmul_rn(x2, sv[d + 1]));
      o2 = __fsub_rn(c2, __fmul_rn(x1, sv[d]));
    }
    T* op = orow + (long long)h * D + d;
    op[0] = from_f<T>(o1);
    op[1] = from_f<T>(o2);
  }
}

template <typename T>
static int launch(const void* x, const void* cs, const void* sn, void* out,
                  int B, int S, int H, int D, long long sxb, long long sxs,
                  long long sxh, long long spb, int adjoint, int interleaved,
                  int vec, cudaStream_t stream) {
  const int items = interleaved ? H * (D / 2) : H * (D / 2 / vec);
  int threads = ((items + 31) / 32) * 32;
  threads = threads < 32 ? 32 : threads > 256 ? 256 : threads;
  const size_t smem = 2 * (size_t)D * sizeof(float);
  const dim3 grid(B * S);
  const T* xp = (const T*)x;
  const T* cp = (const T*)cs;
  const T* sp = (const T*)sn;
  T* op = (T*)out;
  constexpr int V = 16 / sizeof(T);
  if (interleaved)
    rope_interleaved_kernel<T><<<grid, threads, smem, stream>>>(
        xp, cp, sp, op, S, H, D, sxb, sxs, sxh, spb, adjoint);
  else if (vec == V)
    rope_neox_kernel<T, V><<<grid, threads, smem, stream>>>(
        xp, cp, sp, op, S, H, D, sxb, sxs, sxh, spb, adjoint);
  else
    rope_neox_kernel<T, 1><<<grid, threads, smem, stream>>>(
        xp, cp, sp, op, S, H, D, sxb, sxs, sxh, spb, adjoint);
  return (int)cudaGetLastError();
}

// x [B, S, H, D] read through element strides (sxb, sxs, sxh; unit last
// stride); cos / sin [B or 1, S, D] contiguous in x's dtype, batch stride
// spb (0 when broadcast); out [B, S, H, D] contiguous.  vec: 1, or
// 16 / sizeof(T) for 16-byte loads (neox only).
extern "C" int rope(const void* x, const void* cs, const void* sn, void* out,
                    int B, int S, int H, int D, long long sxb, long long sxs,
                    long long sxh, long long spb, int adjoint,
                    int interleaved, int vec, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == PT_BF16)
    return launch<__nv_bfloat16>(x, cs, sn, out, B, S, H, D, sxb, sxs, sxh,
                                 spb, adjoint, interleaved, vec, s);
  return launch<float>(x, cs, sn, out, B, S, H, D, sxb, sxs, sxh, spb,
                       adjoint, interleaved, vec, s);
}
