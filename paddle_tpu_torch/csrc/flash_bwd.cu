// Flash-attention backward (causal / full, optional additive bias, GQA)
// for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_bwd_flat` (:1329,
// the default tier: `_bwd_dq_kernel_flat` :1277 and
// `_bwd_dkv_kernel_flat` :1299), the same math in its layout variants
// `_bwd_t` (:720), `_bwd_mh` (:672) and `_bwd_kv` (:1020), and the biased
// `_bwd_tb` (:1541: `_bwd_dq_kernel_bias` :498, `_bwd_dkv_kernel_bias`
// :605).  All of them run the shared recurrences `_dq_loop` (:421) and
// `_dkv_loop` (:536): P is recomputed from the saved row logsumexp,
// p = exp(scale * q.k [+ bias] - lse), delta = rowsum(dO * O),
// ds = p * (dO.v - delta) * scale, dQ = ds K, dK = ds^T Q, dV = p^T dO,
// with dK / dV summed over each GQA group.  One source serves every tier:
// Q/K/V/O/dO are read in the native [B, S, H, D] layout, the kv head of
// query head h is h / (Hq / Hkv), and the optional f32 bias is read
// through strides (stride 0 on broadcast dims), as flash_fwd.cu reads it.
// The bias gets no gradient (the JAX core returns a zero cotangent).
//
// Bound on this card: operations at the training shape (B8 S1024 H12
// D64, causal): 10 * D flops per visible (query, key) pair against
// 4 * S * D bytes per head of inputs and 3 * S * D of outputs.  This
// first version runs on the f32 CUDA cores, so its ceiling is the 67
// TFLOP/s f32 peak, not the 989 TFLOP/s bf16 tensor-core peak, and it
// recomputes the scores and dO.v in both passes (14 * D flops per pair).
//
// Design, three launches on the caller's stream:
//   (a) delta[b, h, i] = sum_d dO * O in f32, one warp per query row;
//   (b) dQ: one block of 8 warps per (32-query tile, query head, batch).
//       It walks 32-key tiles up to the diagonal (bottom-right aligned,
//       off = Sk - Sq); lane c owns key c of the tile, each warp owns 4
//       query rows, and ds reaches the ds.K product by warp shuffle;
//   (c) dK/dV: one block per (32-key tile, kv head, batch).  It walks the
//       GQA group's query heads and, for each, the query tiles from the
//       diagonal down, so the group sum stays in registers: no atomics.
//       Lane c owns query c of the tile, each warp owns 4 keys.
// Tiles are staged through shared memory as f32 with rows padded by one
// float (the lanes' strided row reads hit distinct banks).  Everything
// accumulates in f32; p and ds stay f32 (the JAX loops round them to the
// input dtype before their dots, :459/:572/:578).  Masked scores get the
// finite NEG_INF, as in the forward, so a fully masked (left-pad) row has
// finite gradients, zero when its dO is zero; keys past Sk and queries
// past Sq get p = 0 exactly.  Both passes visit the same (query tile, key
// tile) pairs, so even a fully masked row's dQ and dK/dV agree with each
// other.  Later work: mma.sync / wgmma on bf16 tiles with TMA staging.
//
// Packed (varlen) mode, the same kernels with PACKED = true.  Replaces:
// paddle_tpu/ops/pallas/varlen_attention.py `_vl_bwd` (:139): its dQ
// pass (`_vl_dq_kernel` :71, pallas_call :158) and dK/dV pass
// (`_vl_dkv_kernel` :87, pallas_call :171), the same recurrences with
// per-position segment ids in the block masks.  One packed batch (B = 1,
// Hq == Hkv), cu_seqlens on the device: a dQ tile visits the keys of its
// rows' segments only, a dK/dV tile the queries of its keys' segments
// only (binary search in cu_seqlens, as in flash_fwd.cu), and every pair
// outside a segment, or past the global causal diagonal, gets p = 0
// exactly.  A row with no visible key (an empty k segment) gets zero dQ
// and gives nothing to dK/dV.  Bound on this card: operations, 10 * D
// flops per visible (query, key) pair of the segments.
//
// Head-major mode (the `kv` layout tier), the same kernels with HM = true:
// Q, O, dO and dQ are [B, Hq, Sq, D]; K, V, dK, dV and the LSE keep their
// layouts.  Replaces the Q/O/dO/dQ addressing of `_bwd_kv` (:1020,
// pallas_call :1036 dQ, :1053 dK/dV) under `_flash_core_kv_bwd` (:1084).
// Only the row offsets differ (the delta pass then walks [B, Hq, Sq] in
// memory order), so its numbers are the native kernels' bit for bit; the
// dense instantiations (HM = false) are unchanged.
#include "common.cuh"

#define FB_BQ 32
#define FB_BK 32
#define FB_WARPS 8
#define FB_RPW (FB_BQ / FB_WARPS)

// (a) delta[b, h, i] over rows of [B, Sq, Hq] in memory order ([B, Hq,
// Sq], delta's own order, in head-major mode).
template <typename T, bool HM>
__global__ void __launch_bounds__(FB_WARPS * 32) flash_bwd_delta_kernel(
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ delta, long long rows, int Sq, int Hq, int D) {
  const long long row = (long long)blockIdx.x * FB_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const T* orow = o + row * D;
  const T* drow = dout + row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += to_f(orow[d]) * to_f(drow[d]);
  s = warp_sum(s);
  if constexpr (HM) {
    if (lane == 0) delta[row] = s;
    return;
  }
  if (lane == 0) {
    const int h = (int)(row % Hq);
    const long long bi = row / Hq;
    const int i = (int)(bi % Sq);
    const long long b = bi / Sq;
    delta[(b * Hq + h) * Sq + i] = s;
  }
}

// Element offset of row (b, i, h) of a [B, S, H, D] tensor, or of a
// [B, H, S, D] one in head-major mode.
template <bool HM>
__device__ __forceinline__ long long fb_row(int b, int i, int h, int S,
                                            int H, int D) {
  if constexpr (HM) return (((long long)b * H + h) * S + i) * D;
  return (((long long)b * S + i) * H + h) * D;
}

// Stage rows [r0, r0 + 32) of head `h` of a [B, S, H, D] tensor ([B, H, S,
// D] with HM) into a [32][D + 1] f32 tile; rows past S read as 0.
template <bool HM, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ src,
                                           int b, int r0, int S, int H, int h,
                                           int D) {
  const int DP = D + 1;
  for (int i = threadIdx.x; i < 32 * D; i += blockDim.x) {
    const int r = i / D, d = i % D, ri = r0 + r;
    dst[r * DP + d] =
        ri < S ? to_f(src[fb_row<HM>(b, ri, h, S, H, D) + d]) : 0.f;
  }
}

// (b) dQ for one (32-query tile, query head, batch).
template <typename T, int NJ, bool PACKED, bool HM>
__global__ void __launch_bounds__(FB_WARPS * 32) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ lse,
    const float* __restrict__ delta, const T* __restrict__ dout,
    T* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv, int D,
    long long bsb, long long bsh, long long bsq, int causal, float scale,
    const int* __restrict__ cu_q, const int* __restrict__ cu_k, int nseg) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* Qs = smem;              // [FB_BQ][DP]
  float* dOs = Qs + FB_BQ * DP;  // [FB_BQ][DP]
  float* Ks = dOs + FB_BQ * DP;  // [FB_BK][DP]
  float* Vs = Ks + FB_BK * DP;   // [FB_BK][DP]

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * FB_BQ;
  const int off = Sk - Sq;

  stage_rows<HM>(Qs, q, b, q0, Sq, Hq, h, D);
  stage_rows<HM>(dOs, dout, b, q0, Sq, Hq, h, D);
  float L[FB_RPW], Dl[FB_RPW], acc[FB_RPW][NJ];
#pragma unroll
  for (int r = 0; r < FB_RPW; ++r) {
    const int qi = q0 + warp * FB_RPW + r;
    const long long at = ((long long)b * Hq + h) * Sq + qi;
    L[r] = qi < Sq ? lse[at] : 0.f;
    Dl[r] = qi < Sq ? delta[at] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.f;
  }
  int kbeg = 0, kend = Sk;
  // packed: row r of this warp sees keys [klo[r], khi[r])
  int klo[FB_RPW], khi[FB_RPW];
  if constexpr (PACKED) {
    const int qmax = min(q0 + FB_BQ, Sq) - 1;
    kbeg = pt_bound(cu_k, nseg, Sk, pt_segment(cu_q, nseg, q0));
    kend = pt_bound(cu_k, nseg, Sk, pt_segment(cu_q, nseg, qmax) + 1);
    if (causal) kend = min(kend, qmax + off + 1);
#pragma unroll
    for (int r = 0; r < FB_RPW; ++r) {
      const int s = pt_segment(cu_q, nseg,
                               min(q0 + warp * FB_RPW + r, Sq - 1));
      klo[r] = pt_bound(cu_k, nseg, Sk, s);
      khi[r] = pt_bound(cu_k, nseg, Sk, s + 1);
    }
  } else if (causal) {
    const int qmax = min(q0 + FB_BQ, Sq) - 1;
    kend = max(0, min(Sk, qmax + off + 1));
  }
  const float* brow = bias ? bias + b * bsb + h * bsh : nullptr;

  for (int k0 = kbeg; k0 < kend; k0 += FB_BK) {
    __syncthreads();  // the previous tile is consumed; Q / dO are staged
    stage_rows<false>(Ks, k, b, k0, Sk, Hkv, hk, D);
    stage_rows<false>(Vs, v, b, k0, Sk, Hkv, hk, D);
    __syncthreads();

    float s[FB_RPW], dp[FB_RPW];
#pragma unroll
    for (int r = 0; r < FB_RPW; ++r) s[r] = dp[r] = 0.f;
    const float* kr = Ks + lane * DP;
    const float* vr = Vs + lane * DP;
    const float* qr = Qs + warp * FB_RPW * DP;
    const float* dr = dOs + warp * FB_RPW * DP;
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d], vd = vr[d];
#pragma unroll
      for (int r = 0; r < FB_RPW; ++r) {
        s[r] += qr[r * DP + d] * kd;
        dp[r] += dr[r * DP + d] * vd;
      }
    }

    const int kj = k0 + lane;
    float ds[FB_RPW];
#pragma unroll
    for (int r = 0; r < FB_RPW; ++r) {
      const int qi = q0 + warp * FB_RPW + r;
      float sv = s[r] * scale;
      float p;
      if constexpr (PACKED) {
        const bool valid = kj >= klo[r] && kj < khi[r] && qi < Sq &&
                           (!causal || qi + off >= kj);
        p = valid ? expf(sv - L[r]) : 0.f;
      } else {
        if (brow && kj < Sk && qi < Sq) sv += brow[qi * bsq + kj];
        sv = (!causal || qi + off >= kj) ? sv : PT_NEG_INF;
        p = (kj < Sk && qi < Sq) ? expf(sv - L[r]) : 0.f;
      }
      ds[r] = p * (dp[r] - Dl[r]) * scale;
    }
    for (int c = 0; c < FB_BK; ++c) {
      float dsc[FB_RPW];
#pragma unroll
      for (int r = 0; r < FB_RPW; ++r)
        dsc[r] = __shfl_sync(PT_FULL_MASK, ds[r], c);
      const float* krow = Ks + c * DP;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = lane + 32 * j;
        const float kd = d < D ? krow[d] : 0.f;
#pragma unroll
        for (int r = 0; r < FB_RPW; ++r) acc[r][j] += dsc[r] * kd;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < FB_RPW; ++r) {
    const int qi = q0 + warp * FB_RPW + r;
    if (qi >= Sq) continue;
    T* row = dq + fb_row<HM>(b, qi, h, Sq, Hq, D);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + 32 * j;
      if (d < D) row[d] = from_f<T>(acc[r][j]);
    }
  }
}

// (c) dK and dV for one (32-key tile, kv head, batch), summed over the
// kv head's group of query heads.
template <typename T, int NJ, bool PACKED, bool HM>
__global__ void __launch_bounds__(FB_WARPS * 32) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ lse,
    const float* __restrict__ delta, const T* __restrict__ dout,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv,
    int D, long long bsb, long long bsh, long long bsq, int causal,
    float scale, const int* __restrict__ cu_q, const int* __restrict__ cu_k,
    int nseg) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* Ks = smem;              // [FB_BK][DP]
  float* Vs = Ks + FB_BK * DP;   // [FB_BK][DP]
  float* Qs = Vs + FB_BK * DP;   // [FB_BQ][DP]
  float* dOs = Qs + FB_BQ * DP;  // [FB_BQ][DP]
  float* Ls = dOs + FB_BQ * DP;  // [FB_BQ]
  float* Ds = Ls + FB_BQ;        // [FB_BQ]

  const int hk = blockIdx.y, b = blockIdx.z;
  const int rep = Hq / Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * FB_BK;
  const int off = Sk - Sq;

  stage_rows<false>(Ks, k, b, k0, Sk, Hkv, hk, D);
  stage_rows<false>(Vs, v, b, k0, Sk, Hkv, hk, D);
  float acck[FB_RPW][NJ], accv[FB_RPW][NJ];
#pragma unroll
  for (int r = 0; r < FB_RPW; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acck[r][j] = accv[r][j] = 0.f;
  // causal: key k0 is first seen by query k0 - off; start at its tile
  int qstart = causal ? max(0, k0 - off) / FB_BQ * FB_BQ : 0, qend = Sq;
  // packed: key r of this warp is seen by queries [qlo[r], qhi[r])
  int qlo[FB_RPW], qhi[FB_RPW];
  if constexpr (PACKED) {
    const int kmax = min(k0 + FB_BK, Sk) - 1;
    qstart = pt_bound(cu_q, nseg, Sq, pt_segment(cu_k, nseg, k0));
    qend = pt_bound(cu_q, nseg, Sq, pt_segment(cu_k, nseg, kmax) + 1);
    if (causal) qstart = max(qstart, k0 - off);
#pragma unroll
    for (int r = 0; r < FB_RPW; ++r) {
      const int s = pt_segment(cu_k, nseg,
                               min(k0 + warp * FB_RPW + r, Sk - 1));
      qlo[r] = pt_bound(cu_q, nseg, Sq, s);
      qhi[r] = pt_bound(cu_q, nseg, Sq, s + 1);
    }
  }

  for (int g = 0; g < rep; ++g) {
    const int h = hk * rep + g;
    const float* brow = bias ? bias + b * bsb + h * bsh : nullptr;
    for (int q0 = qstart; q0 < qend; q0 += FB_BQ) {
      __syncthreads();  // the previous query tile is consumed
      stage_rows<HM>(Qs, q, b, q0, Sq, Hq, h, D);
      stage_rows<HM>(dOs, dout, b, q0, Sq, Hq, h, D);
      if (threadIdx.x < FB_BQ) {
        const int qi = q0 + threadIdx.x;
        const long long at = ((long long)b * Hq + h) * Sq + qi;
        Ls[threadIdx.x] = qi < Sq ? lse[at] : 0.f;
        Ds[threadIdx.x] = qi < Sq ? delta[at] : 0.f;
      }
      __syncthreads();

      float s[FB_RPW], dp[FB_RPW];
#pragma unroll
      for (int r = 0; r < FB_RPW; ++r) s[r] = dp[r] = 0.f;
      const float* qr = Qs + lane * DP;
      const float* dr = dOs + lane * DP;
      const float* kr = Ks + warp * FB_RPW * DP;
      const float* vr = Vs + warp * FB_RPW * DP;
      for (int d = 0; d < D; ++d) {
        const float qd = qr[d], dd = dr[d];
#pragma unroll
        for (int r = 0; r < FB_RPW; ++r) {
          s[r] += kr[r * DP + d] * qd;
          dp[r] += vr[r * DP + d] * dd;
        }
      }

      const int qi = q0 + lane;
      const float L = Ls[lane], Dl = Ds[lane];
      float p[FB_RPW], ds[FB_RPW];
#pragma unroll
      for (int r = 0; r < FB_RPW; ++r) {
        const int kj = k0 + warp * FB_RPW + r;
        float sv = s[r] * scale;
        if constexpr (PACKED) {
          const bool valid = qi >= qlo[r] && qi < qhi[r] && kj < Sk &&
                             (!causal || qi + off >= kj);
          p[r] = valid ? expf(sv - L) : 0.f;
        } else {
          if (brow && kj < Sk && qi < Sq) sv += brow[qi * bsq + kj];
          sv = (!causal || qi + off >= kj) ? sv : PT_NEG_INF;
          p[r] = (kj < Sk && qi < Sq) ? expf(sv - L) : 0.f;
        }
        ds[r] = p[r] * (dp[r] - Dl) * scale;
      }
      for (int c = 0; c < FB_BQ; ++c) {
        float pc[FB_RPW], dsc[FB_RPW];
#pragma unroll
        for (int r = 0; r < FB_RPW; ++r) {
          pc[r] = __shfl_sync(PT_FULL_MASK, p[r], c);
          dsc[r] = __shfl_sync(PT_FULL_MASK, ds[r], c);
        }
        const float* qrow = Qs + c * DP;
        const float* drow = dOs + c * DP;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = lane + 32 * j;
          const float qd = d < D ? qrow[d] : 0.f;
          const float dd = d < D ? drow[d] : 0.f;
#pragma unroll
          for (int r = 0; r < FB_RPW; ++r) {
            accv[r][j] += pc[r] * dd;
            acck[r][j] += dsc[r] * qd;
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < FB_RPW; ++r) {
    const int kj = k0 + warp * FB_RPW + r;
    if (kj >= Sk) continue;
    const long long at = (((long long)b * Sk + kj) * Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + 32 * j;
      if (d < D) {
        dk[at + d] = from_f<T>(acck[r][j]);
        dv[at + d] = from_f<T>(accv[r][j]);
      }
    }
  }
}

template <typename K>
static void allow_smem(K kern, size_t smem) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
}

template <typename T, int NJ, bool PACKED, bool HM>
static int launch(const void* q, const void* k, const void* v,
                  const float* bias, const void* o, const float* lse,
                  const void* dout, float* delta, void* dq, void* dk,
                  void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                  long long bsb, long long bsh, long long bsq, int causal,
                  float scale, const int* cu_q, const int* cu_k, int nseg,
                  cudaStream_t stream) {
  const long long rows = (long long)B * Sq * Hq;
  flash_bwd_delta_kernel<T, HM>
      <<<(unsigned)((rows + FB_WARPS - 1) / FB_WARPS), FB_WARPS * 32, 0,
         stream>>>((const T*)o, (const T*)dout, delta, rows, Sq, Hq, D);
  int err = (int)cudaGetLastError();
  if (err) return err;

  const size_t tile = sizeof(float) * (size_t)32 * (D + 1);
  const size_t smem_dq = 4 * tile;
  auto dq_kern = flash_bwd_dq_kernel<T, NJ, PACKED, HM>;
  allow_smem(dq_kern, smem_dq);
  dq_kern<<<dim3((Sq + FB_BQ - 1) / FB_BQ, Hq, B), FB_WARPS * 32, smem_dq,
            stream>>>((const T*)q, (const T*)k, (const T*)v, bias, lse, delta,
                      (const T*)dout, (T*)dq, Sq, Sk, Hq, Hkv, D, bsb, bsh,
                      bsq, causal, scale, cu_q, cu_k, nseg);
  err = (int)cudaGetLastError();
  if (err) return err;

  const size_t smem_dkv = 4 * tile + sizeof(float) * 2 * FB_BQ;
  auto dkv_kern = flash_bwd_dkv_kernel<T, NJ, PACKED, HM>;
  allow_smem(dkv_kern, smem_dkv);
  dkv_kern<<<dim3((Sk + FB_BK - 1) / FB_BK, Hkv, B), FB_WARPS * 32, smem_dkv,
             stream>>>((const T*)q, (const T*)k, (const T*)v, bias, lse,
                       delta, (const T*)dout, (T*)dk, (T*)dv, Sq, Sk, Hq,
                       Hkv, D, bsb, bsh, bsq, causal, scale, cu_q, cu_k,
                       nseg);
  return (int)cudaGetLastError();
}

template <typename T, bool PACKED, bool HM = false>
static int dispatch(const void* q, const void* k, const void* v,
                    const float* bias, const void* o, const float* lse,
                    const void* dout, float* delta, void* dq, void* dk,
                    void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                    long long bsb, long long bsh, long long bsq, int causal,
                    float scale, const int* cu_q, const int* cu_k, int nseg,
                    cudaStream_t s) {
  switch (pt_nj(D)) {
    case 1: return launch<T, 1, PACKED, HM>(q, k, v, bias, o, lse, dout, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq, causal, scale, cu_q, cu_k, nseg, s);
    case 2: return launch<T, 2, PACKED, HM>(q, k, v, bias, o, lse, dout, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq, causal, scale, cu_q, cu_k, nseg, s);
    case 4: return launch<T, 4, PACKED, HM>(q, k, v, bias, o, lse, dout, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq, causal, scale, cu_q, cu_k, nseg, s);
    default: return launch<T, 8, PACKED, HM>(q, k, v, bias, o, lse, dout, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq, causal, scale, cu_q, cu_k, nseg, s);
  }
}

// q / o / dout / dq [B, Sq, Hq, D]; k / v / dk / dv [B, Sk, Hkv, D];
// bias f32 or null, element (b, h, i, j) at b * bsb + h * bsh + i * bsq
// + j; lse and delta (scratch) [B, Hq, Sq] f32.  Returns the first
// launch error, 0 when all three launches were accepted.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* bias, const void* o, const void* lse,
                         const void* dout, void* delta, void* dq, void* dk,
                         void* dv, int B, int Sq, int Sk, int Hq, int Hkv,
                         int D, long long bsb, long long bsh, long long bsq,
                         int causal, float scale, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == PT_BF16)
    return dispatch<__nv_bfloat16, false>(
        q, k, v, (const float*)bias, o, (const float*)lse, dout,
        (float*)delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq,
        causal, scale, nullptr, nullptr, 0, s);
  return dispatch<float, false>(q, k, v, (const float*)bias, o,
                                (const float*)lse, dout, (float*)delta, dq,
                                dk, dv, B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq,
                                causal, scale, nullptr, nullptr, 0, s);
}

// Packed mode: q / o / dout / dq [Tq, H, D]; k / v / dk / dv [Tk, H, D];
// cu_q / cu_k [nseg + 1] int32 on the device; lse and delta (scratch)
// [H, Tq] f32.  Returns the first launch error, 0 when all three
// launches were accepted.
extern "C" int varlen_bwd(const void* q, const void* k, const void* v,
                          const void* o, const void* lse, const void* dout,
                          const void* cu_q, const void* cu_k, void* delta,
                          void* dq, void* dk, void* dv, int nseg, int Tq,
                          int Tk, int H, int D, int causal, float scale,
                          int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* cq = (const int*)cu_q;
  const int* ck = (const int*)cu_k;
  if (dtype == PT_BF16)
    return dispatch<__nv_bfloat16, true>(
        q, k, v, nullptr, o, (const float*)lse, dout, (float*)delta, dq, dk,
        dv, 1, Tq, Tk, H, H, D, 0, 0, 0, causal, scale, cq, ck, nseg, s);
  return dispatch<float, true>(q, k, v, nullptr, o, (const float*)lse, dout,
                               (float*)delta, dq, dk, dv, 1, Tq, Tk, H, H, D,
                               0, 0, 0, causal, scale, cq, ck, nseg, s);
}

// Head-major mode: q / o / dout / dq [B, Hq, Sq, D]; k / v / dk / dv [B,
// Sk, Hkv, D]; lse and delta (scratch) [B, Hq, Sq] f32; no bias.
extern "C" int flash_bwd_hm(const void* q, const void* k, const void* v,
                            const void* o, const void* lse, const void* dout,
                            void* delta, void* dq, void* dk, void* dv, int B,
                            int Sq, int Sk, int Hq, int Hkv, int D,
                            int causal, float scale, int dtype,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == PT_BF16)
    return dispatch<__nv_bfloat16, false, true>(
        q, k, v, nullptr, o, (const float*)lse, dout, (float*)delta, dq, dk,
        dv, B, Sq, Sk, Hq, Hkv, D, 0, 0, 0, causal, scale, nullptr, nullptr,
        0, s);
  return dispatch<float, false, true>(
      q, k, v, nullptr, o, (const float*)lse, dout, (float*)delta, dq, dk,
      dv, B, Sq, Sk, Hq, Hkv, D, 0, 0, 0, causal, scale, nullptr, nullptr, 0,
      s);
}
