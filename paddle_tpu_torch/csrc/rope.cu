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
// Design: one launch rotates the queries and the keys of a layer (x1
// [B, S, H1, D] and x2 [B, S, H2, D], the two views of the fused qkv
// projection, under the same phases; or x1 alone with H2 = 0), since
// both share the row's phases and a decode step's launch is pure fixed
// cost.  A block serves one (b, s) row and a run of the row's H1 + H2
// heads: the row's cos and sin (D values each) are read once into shared
// memory as f32 and serve every head of the run, as the TPU kernel keeps
// the phases per row block.  When the rows alone give the card fewer
// than ROPE_MIN_BLOCKS blocks (a decode step's B rows), each row's heads
// are split across blocks, down to ROPE_MIN_ITEMS work items a block.
// Neox style: a work item is VEC pairs (d, d + D/2) of one head, so
// every element is read and written once; VEC = 16 / sizeof(T) (16-byte
// loads) when the wrapper finds the pointers, the strides and D/2
// aligned to it, else 1.  Interleaved style (off the main path): a work
// item is one pair (2i, 2i + 1).  Math in f32 with one rounding to the
// output type, as `_rope_kernel` :41-53; the products and the sum are
// rounded one by one (`__fmul_rn` / `__fadd_rn`, which nvcc never
// contracts into an FMA) in the plain version's order, so the kernel
// equals it bit for bit, whichever block computes an element, and a
// bf16 or f16 output cannot land one ulp away.  f32, bf16 and f16
// elements (f16: the bf16 code on __half, 8 values a 16-byte load; the
// same f32 math and one rounding to f16).  x1 and x2 are read through
// their batch, token and head strides, so the q and k views of the
// fused qkv projection need no copy; the outputs are contiguous [B, S,
// H1, D] and [B, S, H2, D].
//
// Adjoint: neox uses the JAX formula, rot = concat(x2, -x1) times the
// same-index sin (:50-52), the exact VJP when both halves of sin are
// equal (the neox phases concat(freqs, freqs)).  The interleaved adjoint
// is the exact VJP of x*cos + rot(x)*sin, which the JAX package gets by
// differentiating its jnp path: g*cos + rot^T(g*sin).
#include "common.cuh"

constexpr int ROPE_MIN_BLOCKS = 264;   // two blocks an SM of the H100
constexpr int ROPE_MIN_ITEMS = 128;    // work items a block, at least

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

// One of the two tensors of a launch: its base, strides and head count.
template <typename T>
struct RopeIn {
  const T* x;
  T* out;
  long long sb, ss, sh;
  int H;
};

// Neox pairs (d, d + D/2) of VEC elements, or (INTER) one interleaved
// pair (2i, 2i + 1), of heads h0 .. h0 + hpb - 1 of the row's H1 + H2.
template <typename T, int VEC, bool INTER>
__global__ void rope_kernel(RopeIn<T> a, RopeIn<T> k, const T* __restrict__ cs,
                            const T* __restrict__ sn, int S, int D,
                            long long spb, int hpb, int adjoint) {
  extern __shared__ float ph[];
  const int row = blockIdx.x;
  const int b = row / S, s = row - b * S;
  load_phases(ph, cs, sn, (long long)b * spb + (long long)s * D, D);
  const float* c = ph;
  const float* sv = ph + D;
  const int half = D / 2, P = INTER ? half : half / VEC;  // items a head
  const int h0 = blockIdx.y * hpb;
  const int nh = min(hpb, a.H + k.H - h0);
  for (int w = threadIdx.x; w < nh * P; w += blockDim.x) {
    const int hw = w / P, h = h0 + hw;
    // the head's tensor, field by field (no copy of the parameters)
    const bool first = h < a.H;
    const int ht = first ? h : h - a.H;
    const T* xh = (first ? a.x : k.x) +
                  (long long)b * (first ? a.sb : k.sb) +
                  (long long)s * (first ? a.ss : k.ss) +
                  (long long)ht * (first ? a.sh : k.sh);
    T* oh = (first ? a.out : k.out) +
            ((long long)row * (first ? a.H : k.H) + ht) * D;
    if constexpr (INTER) {
      const int d = 2 * (w - hw * P);
      const float x1 = to_f(xh[d]), x2 = to_f(xh[d + 1]);
      const float c1 = __fmul_rn(x1, c[d]), c2 = __fmul_rn(x2, c[d + 1]);
      float o1, o2;
      if (!adjoint) {   // rot = (-x2, x1) per pair
        o1 = __fsub_rn(c1, __fmul_rn(x2, sv[d]));
        o2 = __fadd_rn(c2, __fmul_rn(x1, sv[d + 1]));
      } else {          // g*cos + rot^T(g*sin)
        o1 = __fadd_rn(c1, __fmul_rn(x2, sv[d + 1]));
        o2 = __fsub_rn(c2, __fmul_rn(x1, sv[d]));
      }
      oh[d] = from_f<T>(o1);
      oh[d + 1] = from_f<T>(o2);
    } else {
      const int d0 = (w - hw * P) * VEC;
      const Pack<T, VEC> e1 = *reinterpret_cast<const Pack<T, VEC>*>(xh + d0);
      const Pack<T, VEC> e2 =
          *reinterpret_cast<const Pack<T, VEC>*>(xh + d0 + half);
      Pack<T, VEC> o1, o2;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int d = d0 + j;
        const float x1 = to_f(e1.v[j]), x2 = to_f(e2.v[j]);
        const float c1 = __fmul_rn(x1, c[d]), s1 = __fmul_rn(x2, sv[d]);
        const float c2 = __fmul_rn(x2, c[d + half]);
        const float s2 = __fmul_rn(x1, sv[d + half]);
        // forward rot = (-x2, x1); adjoint rot = (x2, -x1)
        o1.v[j] = from_f<T>(adjoint ? __fadd_rn(c1, s1) : __fsub_rn(c1, s1));
        o2.v[j] = from_f<T>(adjoint ? __fsub_rn(c2, s2) : __fadd_rn(c2, s2));
      }
      *reinterpret_cast<Pack<T, VEC>*>(oh + d0) = o1;
      *reinterpret_cast<Pack<T, VEC>*>(oh + d0 + half) = o2;
    }
  }
}

template <typename T>
static int launch(RopeIn<T> a, RopeIn<T> k, const void* cs, const void* sn,
                  int B, int S, int D, long long spb, int adjoint,
                  int interleaved, int vec, cudaStream_t stream) {
  const int H = a.H + k.H, rows = B * S;
  const int per_head = interleaved ? D / 2 : D / 2 / vec;
  // heads a block: all of the row's, or a run of them when the rows give
  // fewer than ROPE_MIN_BLOCKS blocks, down to ROPE_MIN_ITEMS items
  int split = (ROPE_MIN_BLOCKS + rows - 1) / rows;
  const int most = H * per_head / ROPE_MIN_ITEMS;
  split = split < most ? split : most;
  split = split < 1 ? 1 : split > H ? H : split;
  const int hpb = (H + split - 1) / split;
  const dim3 grid(rows, (H + hpb - 1) / hpb);
  int threads = ((hpb * per_head + 31) / 32) * 32;
  threads = threads > 256 ? 256 : threads;
  const size_t smem = 2 * (size_t)D * sizeof(float);
  const T* cp = (const T*)cs;
  const T* sp = (const T*)sn;
  constexpr int V = 16 / sizeof(T);
  if (interleaved)
    rope_kernel<T, 1, true><<<grid, threads, smem, stream>>>(
        a, k, cp, sp, S, D, spb, hpb, adjoint);
  else if (vec == V)
    rope_kernel<T, V, false><<<grid, threads, smem, stream>>>(
        a, k, cp, sp, S, D, spb, hpb, adjoint);
  else
    rope_kernel<T, 1, false><<<grid, threads, smem, stream>>>(
        a, k, cp, sp, S, D, spb, hpb, adjoint);
  return (int)cudaGetLastError();
}

// x1 [B, S, H1, D] and, when H2 > 0, x2 [B, S, H2, D], each read through
// its element strides (batch, token, head; unit last stride); cos / sin
// [B or 1, S, D] contiguous in their dtype (f32, bf16 or f16, x's), batch stride spb (0 when
// broadcast); out1 [B, S, H1, D] and out2 [B, S, H2, D] contiguous.  vec:
// 1, or 16 / sizeof(T) for 16-byte loads (neox only), for both tensors.
extern "C" int rope(const void* x1, const void* x2, const void* cs,
                    const void* sn, void* out1, void* out2, int B, int S,
                    int H1, int H2, int D, long long s1b, long long s1s,
                    long long s1h, long long s2b, long long s2s,
                    long long s2h, long long spb, int adjoint,
                    int interleaved, int vec, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == PT_BF16) {
    using T = __nv_bfloat16;
    return launch<T>({(const T*)x1, (T*)out1, s1b, s1s, s1h, H1},
                     {(const T*)x2, (T*)out2, s2b, s2s, s2h, H2}, cs, sn, B,
                     S, D, spb, adjoint, interleaved, vec, st);
  }
  if (dtype == PT_F16) {
    using T = __half;
    return launch<T>({(const T*)x1, (T*)out1, s1b, s1s, s1h, H1},
                     {(const T*)x2, (T*)out2, s2b, s2s, s2h, H2}, cs, sn, B,
                     S, D, spb, adjoint, interleaved, vec, st);
  }
  if (dtype != PT_F32) return (int)cudaErrorInvalidValue;
  return launch<float>({(const float*)x1, (float*)out1, s1b, s1s, s1h, H1},
                       {(const float*)x2, (float*)out2, s2b, s2s, s2h, H2},
                       cs, sn, B, S, D, spb, adjoint, interleaved, vec, st);
}
