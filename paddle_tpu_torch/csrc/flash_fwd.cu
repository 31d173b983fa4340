// Flash-attention forward (causal / full, optional additive bias) for
// Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_fwd_kernel`
// (:241) and its layout variants `_fwd_kernel_mh` (:354) and the kv/flat
// cores, launched by `_fwd_t` (:291), `_fwd_mh` (:384), `_fwd_kv` (:913)
// and `_fwd_flat` (:1239); and `_fwd_kernel_bias` (:256), launched by
// `_fwd_tb` (:1503).  One kernel serves all of them: it reads Q/K/V in
// the native [B, S, H, D] layout (so no layout tiers and no relayouts),
// GQA grouped as kv head = h / (Hq / Hkv), and an optional f32 bias
// through strides (stride 0 on broadcast batch / head dims).
//
// Bound on this card: operations at the prefill shapes (4 * Sq * Sk * D
// flops per head against 2 * (Sq + 2 * Sk) * D bytes); this first
// version runs them on the f32 CUDA cores, so its ceiling is the 67
// TFLOP/s f32 peak, not the 989 TFLOP/s bf16 tensor-core peak.
//
// Design: one block of 8 warps per (32-query tile, head, batch).  The
// block walks 32-key tiles of K and V staged through shared memory as
// f32 (rows padded by one float, so the lanes' strided K reads hit
// distinct banks); lane c owns key c of the tile for the scores, each
// warp owns 4 query rows, so the row max / sum of the online softmax are
// warp shuffles and the probabilities reach the P.V product by shuffle,
// never through memory.  Causal blocks past the diagonal are not visited
// (bottom-right aligned: off = Sk - Sq, flash_attention.py:178).  Ragged
// Sq / Sk tails are masked in the kernel: any Sq, Sk.  Masked scores get
// the finite NEG_INF and the denominator is clamped at 1e-30, as in the
// JAX kernel, so a fully masked (left-pad) row stays finite.  Later
// work: mma.sync / wgmma on bf16 tiles with TMA staging.
#include "common.cuh"

#define FA_BQ 32
#define FA_BK 32
#define FA_WARPS 8
#define FA_RPW (FA_BQ / FA_WARPS)

template <typename T, int NJ>
__global__ void __launch_bounds__(FA_WARPS * 32) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ o, float* __restrict__ lse,
    int Sq, int Sk, int Hq, int Hkv, int D, long long bsb, long long bsh,
    long long bsq, int causal, float scale) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* Qs = smem;              // [FA_BQ][DP]
  float* Ks = Qs + FA_BQ * DP;   // [FA_BK][DP]
  float* Vs = Ks + FA_BK * DP;   // [FA_BK][D]

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * FA_BQ;
  const int off = Sk - Sq;

  for (int i = tid; i < FA_BQ * D; i += blockDim.x) {
    const int r = i / D, d = i % D, qi = q0 + r;
    Qs[r * DP + d] =
        qi < Sq ? to_f(q[(((long long)b * Sq + qi) * Hq + h) * D + d]) : 0.f;
  }
  int kend = Sk;
  if (causal) {
    const int qmax = min(q0 + FA_BQ, Sq) - 1;
    kend = max(0, min(Sk, qmax + off + 1));
  }
  const float* brow = bias ? bias + b * bsb + h * bsh : nullptr;

  float m[FA_RPW], l[FA_RPW], acc[FA_RPW][NJ];
#pragma unroll
  for (int r = 0; r < FA_RPW; ++r) {
    m[r] = PT_NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += FA_BK) {
    __syncthreads();  // the previous tile is consumed; Q is staged
    for (int i = tid; i < FA_BK * D; i += blockDim.x) {
      const int c = i / D, d = i % D, kj = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (kj < Sk) {
        const long long idx = (((long long)b * Sk + kj) * Hkv + hk) * D + d;
        kv = to_f(k[idx]);
        vv = to_f(v[idx]);
      }
      Ks[c * DP + d] = kv;
      Vs[c * D + d] = vv;
    }
    __syncthreads();

    float s[FA_RPW];
#pragma unroll
    for (int r = 0; r < FA_RPW; ++r) s[r] = 0.f;
    const float* kr = Ks + lane * DP;
    const float* qr = Qs + warp * FA_RPW * DP;
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < FA_RPW; ++r) s[r] += qr[r * DP + d] * kd;
    }

    const int kj = k0 + lane;
    float p[FA_RPW];
#pragma unroll
    for (int r = 0; r < FA_RPW; ++r) {
      const int qi = q0 + warp * FA_RPW + r;
      float sv = s[r] * scale;
      if (brow && kj < Sk && qi < Sq) sv += brow[qi * bsq + kj];
      const bool valid = !causal || qi + off >= kj;
      sv = valid ? sv : PT_NEG_INF;
      // keys past Sk are not keys at all: weight exactly 0
      if (kj >= Sk) sv = __int_as_float(0xff800000);  // -inf
      const float m_new = fmaxf(m[r], warp_max(sv));
      p[r] = expf(sv - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p[r]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[r][j] *= alpha;
      m[r] = m_new;
    }
    for (int c = 0; c < FA_BK; ++c) {
      float pc[FA_RPW];
#pragma unroll
      for (int r = 0; r < FA_RPW; ++r)
        pc[r] = __shfl_sync(PT_FULL_MASK, p[r], c);
      const float* vr = Vs + c * D;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = lane + 32 * j;
        const float vd = d < D ? vr[d] : 0.f;
#pragma unroll
        for (int r = 0; r < FA_RPW; ++r) acc[r][j] += pc[r] * vd;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < FA_RPW; ++r) {
    const int qi = q0 + warp * FA_RPW + r;
    if (qi >= Sq) continue;
    const float ls = fmaxf(l[r], PT_L_MIN);
    T* orow = o + (((long long)b * Sq + qi) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + 32 * j;
      if (d < D) orow[d] = from_f<T>(acc[r][j] / ls);
    }
    if (lane == 0) lse[((long long)b * Hq + h) * Sq + qi] = m[r] + logf(ls);
  }
}

template <typename T, int NJ>
static int launch(const void* q, const void* k, const void* v,
                  const float* bias, void* o, float* lse, int B, int Sq,
                  int Sk, int Hq, int Hkv, int D, long long bsb, long long bsh,
                  long long bsq, int causal, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(FA_BQ + FA_BK) * (D + 1) + (size_t)FA_BK * D);
  auto kern = flash_fwd_kernel<T, NJ>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  dim3 grid((Sq + FA_BQ - 1) / FA_BQ, Hq, B);
  kern<<<grid, FA_WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, (T*)o, lse, Sq, Sk, Hq, Hkv,
      D, bsb, bsh, bsq, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const void* q, const void* k, const void* v,
                    const float* bias, void* o, float* lse, int B, int Sq,
                    int Sk, int Hq, int Hkv, int D, long long bsb,
                    long long bsh, long long bsq, int causal, float scale,
                    cudaStream_t s) {
  switch (pt_nj(D)) {
    case 1: return launch<T, 1>(q, k, v, bias, o, lse, B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq, causal, scale, s);
    case 2: return launch<T, 2>(q, k, v, bias, o, lse, B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq, causal, scale, s);
    case 4: return launch<T, 4>(q, k, v, bias, o, lse, B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq, causal, scale, s);
    default: return launch<T, 8>(q, k, v, bias, o, lse, B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq, causal, scale, s);
  }
}

// q [B, Sq, Hq, D]; k/v [B, Sk, Hkv, D]; bias f32 or null, element
// (b, h, i, j) at b * bsb + h * bsh + i * bsq + j; o [B, Sq, Hq, D];
// lse [B, Hq, Sq] f32.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* bias, void* o, void* lse, int B, int Sq,
                         int Sk, int Hq, int Hkv, int D, long long bsb,
                         long long bsh, long long bsq, int causal, float scale,
                         int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == PT_BF16)
    return dispatch<__nv_bfloat16>(q, k, v, (const float*)bias, o,
                                   (float*)lse, B, Sq, Sk, Hq, Hkv, D, bsb,
                                   bsh, bsq, causal, scale, s);
  return dispatch<float>(q, k, v, (const float*)bias, o, (float*)lse, B, Sq,
                         Sk, Hq, Hkv, D, bsb, bsh, bsq, causal, scale, s);
}
