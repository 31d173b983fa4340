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
//
// Packed (varlen) mode, the same kernel with PACKED = true.  Replaces:
// paddle_tpu/ops/pallas/varlen_attention.py `_vl_fwd_kernel` (:56),
// launched by `_vl_fwd` (:105), which runs the same online softmax with
// per-position segment ids in its block masks.  q [Tq, H, D] and k / v
// [Tk, H, D] are one packed batch (B = 1, no GQA: the JAX kernel indexes
// K/V by the query head); cu_seqlens_q / _k [n + 1] stay on the device.
// Each 32-query tile finds its rows' segments by binary search in
// cu_seqlens_q and visits only the keys of those segments in cu_seqlens_k
// (from the first row's segment start to the last row's segment end), so
// no [T, T] mask or segment-id array exists and the launch needs no host
// sync.  A tile that straddles a boundary masks per row: row i sees keys
// [cu_k[s], cu_k[s + 1]) of its segment s (and, causal, keys j <= i + Tk
// - Tq: JAX's one global diagonal).  Masked keys get exactly zero weight
// (-inf, against a running max that starts at the finite -1e30), so a
// row with no visible key (an empty k segment) writes zeros and a finite
// LSE, where the JAX kernel averages its block's padded values.  Bound
// on this card: operations, 4 * D flops per visible (query, key) pair
// (only the segments' pairs: the work this packing needs).
//
// Head-major mode (the `kv` layout tier), the same kernel with HM = true:
// Q and O are [B, Hq, Sq, D] instead of [B, Sq, Hq, D]; K, V and the LSE
// keep their layouts.  Replaces the Q/O addressing of `_fwd_kv` (:913,
// pallas_call :924) under `_flash_core_kv` (:1070), which reads the
// head-major Q that `_to_hm` makes and writes the head-major O that
// `_from_hm` undoes.  Only the row offsets differ, so its numbers are
// the native kernel's bit for bit; the dense instantiations (HM = false)
// are unchanged.
#include "common.cuh"

#define FA_BQ 32
#define FA_BK 32
#define FA_WARPS 8
#define FA_RPW (FA_BQ / FA_WARPS)

// Element offset of row (b, i, h) of a [B, S, H, D] tensor, or of a
// [B, H, S, D] one in head-major mode.
template <bool HM>
__device__ __forceinline__ long long fa_row(int b, int i, int h, int S,
                                            int H, int D) {
  if constexpr (HM) return (((long long)b * H + h) * S + i) * D;
  return (((long long)b * S + i) * H + h) * D;
}

template <typename T, int NJ, bool PACKED, bool HM>
__global__ void __launch_bounds__(FA_WARPS * 32) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ o, float* __restrict__ lse,
    int Sq, int Sk, int Hq, int Hkv, int D, long long bsb, long long bsh,
    long long bsq, int causal, float scale, const int* __restrict__ cu_q,
    const int* __restrict__ cu_k, int nseg) {
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
        qi < Sq ? to_f(q[fa_row<HM>(b, qi, h, Sq, Hq, D) + d]) : 0.f;
  }
  int kbeg = 0, kend = Sk;
  // packed: row r of this warp sees keys [klo[r], khi[r])
  int klo[FA_RPW], khi[FA_RPW];
  if constexpr (PACKED) {
    const int qmax = min(q0 + FA_BQ, Sq) - 1;
    kbeg = pt_bound(cu_k, nseg, Sk, pt_segment(cu_q, nseg, q0));
    kend = pt_bound(cu_k, nseg, Sk, pt_segment(cu_q, nseg, qmax) + 1);
    if (causal) kend = min(kend, qmax + off + 1);
#pragma unroll
    for (int r = 0; r < FA_RPW; ++r) {
      const int s = pt_segment(cu_q, nseg,
                               min(q0 + warp * FA_RPW + r, Sq - 1));
      klo[r] = pt_bound(cu_k, nseg, Sk, s);
      khi[r] = pt_bound(cu_k, nseg, Sk, s + 1);
    }
  } else if (causal) {
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

  for (int k0 = kbeg; k0 < kend; k0 += FA_BK) {
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
      if constexpr (PACKED) {
        // another segment's key, or past the diagonal: weight exactly 0
        if (kj < klo[r] || kj >= khi[r] || (causal && qi + off < kj))
          sv = __int_as_float(0xff800000);  // -inf
      } else {
        if (brow && kj < Sk && qi < Sq) sv += brow[qi * bsq + kj];
        const bool valid = !causal || qi + off >= kj;
        sv = valid ? sv : PT_NEG_INF;
        // keys past Sk are not keys at all: weight exactly 0
        if (kj >= Sk) sv = __int_as_float(0xff800000);  // -inf
      }
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
    T* orow = o + fa_row<HM>(b, qi, h, Sq, Hq, D);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + 32 * j;
      if (d < D) orow[d] = from_f<T>(acc[r][j] / ls);
    }
    if (lane == 0) lse[((long long)b * Hq + h) * Sq + qi] = m[r] + logf(ls);
  }
}

template <typename T, int NJ, bool PACKED, bool HM>
static int launch(const void* q, const void* k, const void* v,
                  const float* bias, void* o, float* lse, int B, int Sq,
                  int Sk, int Hq, int Hkv, int D, long long bsb, long long bsh,
                  long long bsq, int causal, float scale, const int* cu_q,
                  const int* cu_k, int nseg, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(FA_BQ + FA_BK) * (D + 1) + (size_t)FA_BK * D);
  auto kern = flash_fwd_kernel<T, NJ, PACKED, HM>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  dim3 grid((Sq + FA_BQ - 1) / FA_BQ, Hq, B);
  kern<<<grid, FA_WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, (T*)o, lse, Sq, Sk, Hq, Hkv,
      D, bsb, bsh, bsq, causal, scale, cu_q, cu_k, nseg);
  return (int)cudaGetLastError();
}

template <typename T, bool PACKED, bool HM = false>
static int dispatch(const void* q, const void* k, const void* v,
                    const float* bias, void* o, float* lse, int B, int Sq,
                    int Sk, int Hq, int Hkv, int D, long long bsb,
                    long long bsh, long long bsq, int causal, float scale,
                    const int* cu_q, const int* cu_k, int nseg,
                    cudaStream_t s) {
  switch (pt_nj(D)) {
    case 1: return launch<T, 1, PACKED, HM>(q, k, v, bias, o, lse, B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq, causal, scale, cu_q, cu_k, nseg, s);
    case 2: return launch<T, 2, PACKED, HM>(q, k, v, bias, o, lse, B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq, causal, scale, cu_q, cu_k, nseg, s);
    case 4: return launch<T, 4, PACKED, HM>(q, k, v, bias, o, lse, B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq, causal, scale, cu_q, cu_k, nseg, s);
    default: return launch<T, 8, PACKED, HM>(q, k, v, bias, o, lse, B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq, causal, scale, cu_q, cu_k, nseg, s);
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
    return dispatch<__nv_bfloat16, false>(q, k, v, (const float*)bias, o,
                                          (float*)lse, B, Sq, Sk, Hq, Hkv, D,
                                          bsb, bsh, bsq, causal, scale,
                                          nullptr, nullptr, 0, s);
  return dispatch<float, false>(q, k, v, (const float*)bias, o, (float*)lse,
                                B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq, causal,
                                scale, nullptr, nullptr, 0, s);
}

// Packed mode: q [Tq, H, D]; k / v [Tk, H, D]; cu_q / cu_k [nseg + 1]
// int32 on the device; o [Tq, H, D]; lse [H, Tq] f32.
extern "C" int varlen_fwd(const void* q, const void* k, const void* v,
                          const void* cu_q, const void* cu_k, void* o,
                          void* lse, int nseg, int Tq, int Tk, int H, int D,
                          int causal, float scale, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* cq = (const int*)cu_q;
  const int* ck = (const int*)cu_k;
  if (dtype == PT_BF16)
    return dispatch<__nv_bfloat16, true>(q, k, v, nullptr, o, (float*)lse, 1,
                                         Tq, Tk, H, H, D, 0, 0, 0, causal,
                                         scale, cq, ck, nseg, s);
  return dispatch<float, true>(q, k, v, nullptr, o, (float*)lse, 1, Tq, Tk,
                               H, H, D, 0, 0, 0, causal, scale, cq, ck, nseg,
                               s);
}

// Head-major mode: q / o [B, Hq, Sq, D]; k / v [B, Sk, Hkv, D]; lse
// [B, Hq, Sq] f32; no bias.
extern "C" int flash_fwd_hm(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int Sq, int Sk,
                            int Hq, int Hkv, int D, int causal, float scale,
                            int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == PT_BF16)
    return dispatch<__nv_bfloat16, false, true>(
        q, k, v, nullptr, o, (float*)lse, B, Sq, Sk, Hq, Hkv, D, 0, 0, 0,
        causal, scale, nullptr, nullptr, 0, s);
  return dispatch<float, false, true>(q, k, v, nullptr, o, (float*)lse, B,
                                      Sq, Sk, Hq, Hkv, D, 0, 0, 0, causal,
                                      scale, nullptr, nullptr, 0, s);
}
