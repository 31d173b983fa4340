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
// The JAX core returns the bias a zero cotangent (its trainable masks
// take `_sdpa_ref`); here the dBias mode (`flash_bwd` given a dbias
// pointer, DBIAS = true, launched only for a mask that requires grad)
// also gives dBias = p (dP - delta), the gradient of the scale-then-bias
// scores, from the dK/dV pass, accumulated in f32 in the mask's own
// shape (its broadcast axes summed); the other modes' instantiations do
// not change.
// Packed mode (below) replaces paddle_tpu/ops/pallas/varlen_attention.py
// `_vl_bwd` (:139), and head-major mode the Q/O addressing of `_bwd_kv`.
//
// Bound on this card: operations at the training shape (B8 S1024 H12
// D64, causal): 10 * D flops per visible (query, key) pair, 32.3 GFLOP,
// 0.0326 ms at the 989 TFLOP/s bf16 tensor-core peak, against 4 * S * D
// bytes per head of inputs and 3 * S * D of outputs.  Both passes below
// recompute the scores and dO.v, so the kernels run 14 * D flops a pair.
//
// Design, three launches on the caller's stream:
//   (a) delta[b, h, i] = sum_d dO * O in f32, one warp per query row
//       (both dtypes);
//   (b) dQ, bf16 (`flash_bwd_dq_tc`): one block of 4 warps per (64-query
//       tile, query head, batch), 16 query rows a warp.  Q and dO stay
//       resident in XOR-swizzled shared memory (and, at head dims up to
//       64, in registers); K and V tiles (64 keys, 32 above head dim 128)
//       stream through a 2-stage cp.async ring up to the diagonal
//       (bottom-right aligned, off = Sk - Sq).  S = Q K^T and dP = dO V^T
//       by mma.sync m16n8k16 (bf16 operands, f32 accumulators); p =
//       exp(S scale [+ bias] - L) and dS = p (dP - delta) scale in
//       registers, dS rounded to bf16 into the A fragments of dQ += dS K
//       (JAX rounds it there, :459), K read by ldmatrix.trans;
//   (c) dK/dV, bf16 (`flash_bwd_dkv_tc`): one block per (64-key tile, 32
//       above head dim 128, kv head, batch), 16 keys a warp (two warps
//       share them, each with half the columns, above 128).  K and V stay
//       resident; Q, dO, L and delta stream through the ring, over the GQA
//       group's query heads inside the block, so the group sum stays in
//       registers.  S^T = K Q^T and dP^T = V dO^T by mma; P^T and dS^T
//       rounded to bf16 in registers (:572, :578) feed dV += P^T dO and
//       dK += dS^T Q, dO and Q read by ldmatrix.trans.
//   Only tiles that cross the diagonal, a sequence end or a segment edge
//   run the masked body.  No atomics: SDPA's backward adds dQ with
//   atomics from the dK/dV pass (10 * D flops a pair); keeping the two
//   passes costs 14 * D, and in return a rerun is bit-identical, which
//   the int8 tier's and the kv tier's tests rely on.  Next step (not
//   taken here): wgmma on 64-row warpgroup tiles fed by TMA from a
//   producer warp (warp specialisation).
//
// f32 keeps the first version's CUDA-core passes (b) and (c)
// (`flash_bwd_dq_kernel`, `flash_bwd_dkv_kernel`), the port's oracle path
// (TF32 tensor cores would keep ~3 digits): one block of 8 warps per
// 32-query (32-key) tile, lane c owning query (key) c of the tile, each
// warp 4 rows, ds and p reaching their products by warp shuffle; tiles
// staged as f32 with rows padded by one float; p and ds stay f32.  Its
// ceiling is the 67 TFLOP/s f32 peak.
//
// Both cores: everything accumulates in f32.  Masked scores get the
// finite NEG_INF, as in the forward, so a fully masked (left-pad) row has
// finite gradients, zero when its dO is zero; keys past Sk and queries
// past Sq get p = 0 exactly.  Where the two passes' tiles are equal (f32;
// bf16 at head dims up to 64) they visit the same (query tile, key tile)
// pairs, so even a fully masked row's dQ and dK/dV agree with each other.
//
// Packed (varlen) mode, PACKED = true.  Replaces:
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
// Head-major mode (the `kv` layout tier), HM = true: Q, O, dO and dQ are
// [B, Hq, Sq, D]; K, V, dK, dV and the LSE keep their layouts.  Replaces
// the Q/O/dO/dQ addressing of `_bwd_kv` (:1020, pallas_call :1036 dQ,
// :1053 dK/dV) under `_flash_core_kv_bwd` (:1084).  Only the row offsets
// differ (the delta pass then walks [B, Hq, Sq] in memory order), so its
// numbers are the native mode's bit for bit, in both cores.
#include "common.cuh"
#include "flash_tc.cuh"

#define FB_BQ 32
#define FB_BK 32
#define FB_WARPS 8
#define FB_RPW (FB_BQ / FB_WARPS)

// dBias mode: the f32 gradient of the additive bias, element (b, h, i, j)
// at b * sb + h * sh + i * sq + j (stride 0 on the mask's broadcast axes,
// zeroed by the caller).  `unique`: no two (b, h, i, j) share an element,
// so the dK/dV pass stores it; otherwise it adds it atomically.
struct DBias {
  float* p;
  long long sb, sh, sq;
  int unique;
};

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
// With DBIAS, also dBias = p (dP - delta) (the gradient of the scores
// after the scale, where the bias is added): a mask broadcast over the
// queries (sq == 0) sums its keys' column in registers, over the query
// tiles and, when it is broadcast over heads too, over the GQA group,
// and adds the sum once; any other mask gets each element.
template <typename T, int NJ, bool PACKED, bool HM, bool DBIAS = false>
__global__ void __launch_bounds__(FB_WARPS * 32) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ lse,
    const float* __restrict__ delta, const T* __restrict__ dout,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv,
    int D, long long bsb, long long bsh, long long bsq, int causal,
    float scale, const int* __restrict__ cu_q, const int* __restrict__ cu_k,
    int nseg, DBias db = DBias{}) {
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

  float dbacc[FB_RPW];  // DBIAS, sq == 0: the keys' column sums
#pragma unroll
  for (int r = 0; r < FB_RPW; ++r) dbacc[r] = 0.f;
  for (int g = 0; g < rep; ++g) {
    const int h = hk * rep + g;
    const float* brow = bias ? bias + b * bsb + h * bsh : nullptr;
    float* dbrow = DBIAS ? db.p + b * db.sb + h * db.sh : nullptr;
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
        if constexpr (DBIAS) {
          const float dx = p[r] * (dp[r] - Dl);
          if (kj < Sk && qi < Sq) {
            if (db.sq == 0) {
              dbacc[r] += dx;
            } else if (db.unique) {
              dbrow[qi * db.sq + kj] = dx;
            } else {
              atomicAdd(dbrow + qi * db.sq + kj, dx);
            }
          }
        }
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
    if constexpr (DBIAS) {
      // a column sum ends with its head, or with the group when the mask
      // is broadcast over heads
      if (db.sq == 0 && (db.sh != 0 || g == rep - 1)) {
#pragma unroll
        for (int r = 0; r < FB_RPW; ++r) {
          const float sum = warp_sum(dbacc[r]);
          const int kj = k0 + warp * FB_RPW + r;
          if (lane == 0 && kj < Sk) atomicAdd(dbrow + kj, sum);
          dbacc[r] = 0.f;
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

template <typename T, int NJ, bool PACKED, bool HM, bool DBIAS>
static int launch(const void* q, const void* k, const void* v,
                  const float* bias, const void* o, const float* lse,
                  const void* dout, float* delta, void* dq, void* dk,
                  void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                  long long bsb, long long bsh, long long bsq, int causal,
                  float scale, const int* cu_q, const int* cu_k, int nseg,
                  cudaStream_t stream, DBias db) {
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
  auto dkv_kern = flash_bwd_dkv_kernel<T, NJ, PACKED, HM, DBIAS>;
  allow_smem(dkv_kern, smem_dkv);
  dkv_kern<<<dim3((Sk + FB_BK - 1) / FB_BK, Hkv, B), FB_WARPS * 32, smem_dkv,
             stream>>>((const T*)q, (const T*)k, (const T*)v, bias, lse,
                       delta, (const T*)dout, (T*)dk, (T*)dv, Sq, Sk, Hq,
                       Hkv, D, bsb, bsh, bsq, causal, scale, cu_q, cu_k,
                       nseg, db);
  return (int)cudaGetLastError();
}

template <typename T, bool PACKED, bool HM = false, bool DBIAS = false>
static int dispatch(const void* q, const void* k, const void* v,
                    const float* bias, const void* o, const float* lse,
                    const void* dout, float* delta, void* dq, void* dk,
                    void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                    long long bsb, long long bsh, long long bsq, int causal,
                    float scale, const int* cu_q, const int* cu_k, int nseg,
                    cudaStream_t s, DBias db = DBias{}) {
  switch (pt_nj(D)) {
    case 1: return launch<T, 1, PACKED, HM, DBIAS>(q, k, v, bias, o, lse, dout, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq, causal, scale, cu_q, cu_k, nseg, s, db);
    case 2: return launch<T, 2, PACKED, HM, DBIAS>(q, k, v, bias, o, lse, dout, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq, causal, scale, cu_q, cu_k, nseg, s, db);
    case 4: return launch<T, 4, PACKED, HM, DBIAS>(q, k, v, bias, o, lse, dout, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq, causal, scale, cu_q, cu_k, nseg, s, db);
    default: return launch<T, 8, PACKED, HM, DBIAS>(q, k, v, bias, o, lse, dout, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq, causal, scale, cu_q, cu_k, nseg, s, db);
  }
}

// ------------------------------------------------------------ bf16, f16
// The tensor-core passes (b) and (c): every bf16 and every f16 mode
// (dense causal / full, biased, packed, head-major) runs here, on 16-bit
// elements E: the f16 passes round P and dS to f16 where the bf16 ones
// round them to bf16.

#define TC_BQ 64     // dQ pass: query rows per block, 16 per warp

template <int DT>
struct BwdTile {
  static constexpr int BK = DT <= 128 ? 64 : 32;  // dQ: keys per tile
  static constexpr bool QREG = DT <= 64;          // dQ: Q, dO in registers
  static constexpr int NS = DT <= 128 ? 1 : 2;    // dK/dV: warps per 16 keys
  static constexpr int KT = 64 / NS;              // dK/dV: keys per block
  static constexpr int QT = DT <= 64 ? 64 : 32;   // dK/dV: queries per tile
  // Q, dO, then the K and V rings of 2 stages
  static constexpr size_t smem_dq =
      sizeof(bf16) * (size_t)(2 * TC_BQ + 4 * BK) * DT;
  // K, V, the Q and dO rings, then the L and delta rings
  static constexpr size_t smem_dkv =
      sizeof(bf16) * (size_t)(2 * KT + 4 * QT) * DT + sizeof(float) * 4 * QT;
};

// (b) dQ for one (64-query tile, query head, batch).
template <typename E, int DT, bool BIAS, bool PACKED, bool HM>
__global__ void __launch_bounds__(TC_THREADS) flash_bwd_dq_tc(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const float* __restrict__ bias,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const E* __restrict__ dout, E* __restrict__ dq, int Sq, int Sk,
    int Hq, int Hkv, int D, long long bsb, long long bsh, long long bsq,
    int causal, float scale, const int* __restrict__ cu_q,
    const int* __restrict__ cu_k, int nseg) {
  constexpr int BK = BwdTile<DT>::BK, NT = BK / 8, KS = DT / 16, ND = DT / 8;
  constexpr bool QREG = BwdTile<DT>::QREG;
  extern __shared__ __align__(128) unsigned char dq_smem[];
  E* Qs = reinterpret_cast<E*>(dq_smem);  // [TC_BQ][DT]
  E* dOs = Qs + TC_BQ * DT;                  // [TC_BQ][DT]
  E* Ks = dOs + TC_BQ * DT;                  // [2][BK][DT]
  E* Vs = Ks + 2 * BK * DT;                  // [2][BK][DT]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC_BQ;  // longest first
  const int qmax = min(q0 + TC_BQ, Sq) - 1;
  const int off = Sk - Sq;
  const int wr = warp * 16;
  const int nk = (D + 15) >> 4, nd = 2 * nk;

  int kbeg = 0, kend = Sk, kin_lo = 0, kin_hi = Sk;
  int klo[2] = {0, 0}, khi[2] = {Sk, Sk};  // packed: rows g, g + 8
  if constexpr (PACKED) {
    const int s0 = pt_segment(cu_q, nseg, q0);
    const int s1 = pt_segment(cu_q, nseg, qmax);
    kbeg = pt_bound(cu_k, nseg, Sk, s0);
    kend = pt_bound(cu_k, nseg, Sk, s1 + 1);
    kin_lo = pt_bound(cu_k, nseg, Sk, s1);
    kin_hi = pt_bound(cu_k, nseg, Sk, s0 + 1);
    if (causal) kend = min(kend, qmax + off + 1);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = pt_segment(cu_q, nseg, min(q0 + wr + g + 8 * r, Sq - 1));
      klo[r] = pt_bound(cu_k, nseg, Sk, s);
      khi[r] = pt_bound(cu_k, nseg, Sk, s + 1);
    }
  } else if (causal) {
    kend = max(0, min(Sk, qmax + off + 1));
  }
  const int ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  // row i of this (head, batch): q + qh + i * qs (dO, dQ alike); of its
  // kv head: k + kh + i * ks (v alike)
  const long long qh = fb_row<HM>(b, 0, h, Sq, Hq, D);
  const long long qs = HM ? D : (long long)Hq * D;
  const long long kh = ((long long)b * Sk * Hkv + hk) * D;
  const long long ks = (long long)Hkv * D;
  tc_zero_pad<DT>(Qs, 2 * TC_BQ + 4 * BK, D);
  tc_load_rows<TC_BQ, DT>(Qs, q + qh, qs, q0, Sq, D);
  tc_load_rows<TC_BQ, DT>(dOs, dout + qh, qs, q0, Sq, D);
  if (ntiles > 0) {
    tc_load_rows<BK, DT>(Ks, k + kh, ks, kbeg, Sk, D);
    tc_load_rows<BK, DT>(Vs, v + kh, ks, kbeg, Sk, D);
  }
  tc_commit();
  float L[2], Dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + wr + g + 8 * r;
    const long long at = ((long long)b * Hq + h) * Sq + qi;
    L[r] = qi < Sq ? lse[at] : 0.f;
    Dl[r] = qi < Sq ? delta[at] : 0.f;
  }
  const float* brow = nullptr;
  if constexpr (BIAS) brow = bias + b * bsb + h * bsh;

  uint32_t qf[QREG ? KS : 1][4], of[QREG ? KS : 1][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = kbeg + it * BK;
    const E* Kt = Ks + (it & 1) * BK * DT;
    const E* Vt = Vs + (it & 1) * BK * DT;
    if (it + 1 < ntiles) {
      const int nx = ((it + 1) & 1) * BK * DT;
      tc_load_rows<BK, DT>(Ks + nx, k + kh, ks, k0 + BK, Sk, D);
      tc_load_rows<BK, DT>(Vs + nx, v + kh, ks, k0 + BK, Sk, D);
      tc_commit();
      tc_wait<1>();
    } else {
      tc_wait<0>();
    }
    __syncthreads();
    if constexpr (QREG) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          if (kk < nk) {
            tc_frag_a<DT>(Qs, wr, kk, lane, qf[kk]);
            tc_frag_a<DT>(dOs, wr, kk, lane, of[kk]);
          }
      }
    }

    // S = Q K^T, dP = dO V^T
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk >= nk) break;
      uint32_t a[4], ao[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a[e] = qf[kk][e];
          ao[e] = of[kk][e];
        }
      } else {
        tc_frag_a<DT>(Qs, wr, kk, lane, a);
        tc_frag_a<DT>(dOs, wr, kk, lane, ao);
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bb[4];
        tc_frag_b<DT>(Kt, j, kk, lane, bb);
        tc_mma<E>(s[j], a, bb[0], bb[1]);
        tc_mma<E>(s[j + 1], a, bb[2], bb[3]);
        tc_frag_b<DT>(Vt, j, kk, lane, bb);
        tc_mma<E>(dp[j], ao, bb[0], bb[1]);
        tc_mma<E>(dp[j + 1], ao, bb[2], bb[3]);
      }
    }

    // p from the saved LSE, dS = p (dP - delta) scale; dS overwrites s
    const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > q0 + off) ||
                        (PACKED && (k0 < kin_lo || k0 + BK > kin_hi));
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int qi = q0 + wr + g + 8 * r;
        const int kj = k0 + 8 * j + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if constexpr (BIAS) {
          if (kj < Sk && qi < Sq) x += brow[qi * bsq + kj];
        }
        bool valid = true;
        if (masked) {
          if constexpr (PACKED) {
            valid = kj >= klo[r] && kj < khi[r] && !(causal && qi + off < kj);
          } else {
            if (causal && qi + off < kj) x = PT_NEG_INF;
            valid = kj < Sk;
          }
        }
        const float p = valid ? tc_exp2((x - L[r]) * TC_LOG2E) : 0.f;
        s[j][e] = p * (dp[j][e] - Dl[r]) * scale;
      }

    // dQ += dS K, dS rounded to E in registers
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      tc_acc_to_a<E>(s[2 * kk], s[2 * kk + 1], a);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        if (n >= nd) break;
        uint32_t bb[4];
        tc_frag_bt<DT>(Kt, n, kk, lane, bb);
        tc_mma<E>(acc[n], a, bb[0], bb[1]);
        tc_mma<E>(acc[n + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();  // this stage is consumed before its next copy
  }

  tc_wait<0>();
  __syncthreads();
  const float one[2] = {1.f, 1.f};
  // the warp's own Q rows (no other warp reads them) stage its dQ rows
  tc_acc_to_tile<DT, ND>(Qs, wr, 0, nd, acc, one, lane);
  __syncwarp();
  tc_store_rows<DT, 16, 32>(dq + qh, qs, Qs + wr * DT, q0 + wr, Sq, D,
                            lane);
}

// (c) dK and dV for one (key tile, kv head, batch), summed over the kv
// head's group of query heads.  With DBIAS also dBias, as in the f32
// kernel: each thread sums its two keys' columns in registers for a mask
// broadcast over the queries (the four lanes of a key row then meet by
// shuffle), else it stores or adds each element; with two warps on the
// same keys (head dims above 128) only the first contributes.
template <typename E, int DT, bool BIAS, bool PACKED, bool HM,
          bool DBIAS = false>
__global__ void __launch_bounds__(TC_THREADS) flash_bwd_dkv_tc(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const float* __restrict__ bias,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const E* __restrict__ dout, E* __restrict__ dk,
    E* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv, int D,
    long long bsb, long long bsh, long long bsq, int causal, float scale,
    const int* __restrict__ cu_q, const int* __restrict__ cu_k, int nseg,
    DBias db = DBias{}) {
  constexpr int NS = BwdTile<DT>::NS, KT = BwdTile<DT>::KT;
  constexpr int QT = BwdTile<DT>::QT, NQ = QT / 8, KS = DT / 16;
  constexpr int NC = DT / 8 / NS;  // dK / dV n-tiles per warp
  extern __shared__ __align__(128) unsigned char dkv_smem[];
  E* Ks = reinterpret_cast<E*>(dkv_smem);  // [KT][DT]
  E* Vs = Ks + KT * DT;                       // [KT][DT]
  E* Qs = Vs + KT * DT;                       // [2][QT][DT]
  E* dOs = Qs + 2 * QT * DT;                  // [2][QT][DT]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * QT * DT);  // [2][QT]
  float* Ds = Ls + 2 * QT;                                  // [2][QT]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int hk = blockIdx.y, b = blockIdx.z, rep = Hq / Hkv;
  const int k0 = blockIdx.x * KT;
  const int kmax = min(k0 + KT, Sk) - 1;
  const int off = Sk - Sq;
  const int wr = (warp / NS) * 16;     // the warp's first key row
  const int n0 = (warp % NS) * NC;     // its first dK / dV n-tile
  const int nk = (D + 15) >> 4, nd = 2 * nk;

  // causal: key k0 is first seen by query k0 - off; start at its tile
  int qstart = causal ? max(0, k0 - off) / QT * QT : 0, qend = Sq;
  int qin_lo = 0, qin_hi = Sq;  // queries every key of the tile may see
  int qlo[2] = {0, 0}, qhi[2] = {Sq, Sq};  // packed: keys g, g + 8
  if constexpr (PACKED) {
    const int s0 = pt_segment(cu_k, nseg, k0);
    const int s1 = pt_segment(cu_k, nseg, kmax);
    qstart = pt_bound(cu_q, nseg, Sq, s0);
    qend = pt_bound(cu_q, nseg, Sq, s1 + 1);
    qin_lo = pt_bound(cu_q, nseg, Sq, s1);
    qin_hi = pt_bound(cu_q, nseg, Sq, s0 + 1);
    if (causal) qstart = max(qstart, k0 - off);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = pt_segment(cu_k, nseg, min(k0 + wr + g + 8 * r, Sk - 1));
      qlo[r] = pt_bound(cu_q, nseg, Sq, s);
      qhi[r] = pt_bound(cu_q, nseg, Sq, s + 1);
    }
  }
  const int nqt = qend > qstart ? (qend - qstart + QT - 1) / QT : 0;
  const int ntiles = rep * nqt;  // (query head of the group, query tile)

  // row i of the kv head: k + kh + i * ks (v, dK, dV alike); of query
  // head h: q + fb_row(b, 0, h) + i * qs (dO alike)
  const long long kh = ((long long)b * Sk * Hkv + hk) * D;
  const long long ks = (long long)Hkv * D;
  const long long qs = HM ? D : (long long)Hq * D;
  // Q, dO, L and delta of tile `it` into ring stage `st` (L and delta by
  // plain loads: 2 * QT floats)
  auto load_q = [&](int it, int st) {
    const int h = hk * rep + it / nqt, q0 = qstart + (it % nqt) * QT;
    const long long qh = fb_row<HM>(b, 0, h, Sq, Hq, D);
    tc_load_rows<QT, DT>(Qs + st * QT * DT, q + qh, qs, q0, Sq, D);
    tc_load_rows<QT, DT>(dOs + st * QT * DT, dout + qh, qs, q0, Sq, D);
    for (int i = threadIdx.x; i < QT; i += TC_THREADS) {
      const int qi = q0 + i;
      const long long at = ((long long)b * Hq + h) * Sq + qi;
      Ls[st * QT + i] = qi < Sq ? lse[at] : 0.f;
      Ds[st * QT + i] = qi < Sq ? delta[at] : 0.f;
    }
  };
  tc_zero_pad<DT>(Ks, 2 * KT + 4 * QT, D);
  tc_load_rows<KT, DT>(Ks, k + kh, ks, k0, Sk, D);
  tc_load_rows<KT, DT>(Vs, v + kh, ks, k0, Sk, D);
  if (ntiles > 0) load_q(0, 0);
  tc_commit();

  float adk[NC][4], adv[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  float dbacc[2] = {0.f, 0.f};  // DBIAS, sq == 0: keys g, g + 8
  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    const int h = hk * rep + it / nqt, q0 = qstart + (it % nqt) * QT;
    if (it + 1 < ntiles) {
      load_q(it + 1, st ^ 1);
      tc_commit();
      tc_wait<1>();
    } else {
      tc_wait<0>();
    }
    __syncthreads();
    const E* Qt = Qs + st * QT * DT;
    const E* dOt = dOs + st * QT * DT;
    const float* Lt = Ls + st * QT;
    const float* Dt = Ds + st * QT;

    // S^T = K Q^T, dP^T = V dO^T (rows: the warp's 16 keys)
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk >= nk) break;
      uint32_t ak[4], av[4];
      tc_frag_a<DT>(Ks, wr, kk, lane, ak);
      tc_frag_a<DT>(Vs, wr, kk, lane, av);
#pragma unroll
      for (int j = 0; j < NQ; j += 2) {
        uint32_t bb[4];
        tc_frag_b<DT>(Qt, j, kk, lane, bb);
        tc_mma<E>(s[j], ak, bb[0], bb[1]);
        tc_mma<E>(s[j + 1], ak, bb[2], bb[3]);
        tc_frag_b<DT>(dOt, j, kk, lane, bb);
        tc_mma<E>(dp[j], av, bb[0], bb[1]);
        tc_mma<E>(dp[j + 1], av, bb[2], bb[3]);
      }
    }

    // P^T overwrites s, dS^T overwrites dp
    const bool masked = q0 + QT > Sq || (causal && q0 + off < k0 + KT - 1) ||
                        (PACKED && (q0 < qin_lo || q0 + QT > qin_hi));
    const float* brow = nullptr;
    if constexpr (BIAS) brow = bias + b * bsb + h * bsh;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float2 lq = *reinterpret_cast<const float2*>(Lt + 8 * j + 2 * t);
      const float2 dq2 = *reinterpret_cast<const float2*>(Dt + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = e & 1;
        const int kj = k0 + wr + g + 8 * r;
        const int qi = q0 + 8 * j + 2 * t + c;
        float x = s[j][e] * scale;
        if constexpr (BIAS) {
          if (kj < Sk && qi < Sq) x += brow[qi * bsq + kj];
        }
        bool valid = true;
        if (masked) {
          if constexpr (PACKED) {
            valid = qi >= qlo[r] && qi < qhi[r] && qi < Sq &&
                    !(causal && qi + off < kj);
          } else {
            if (causal && qi + off < kj) x = PT_NEG_INF;
            valid = qi < Sq;
          }
        }
        const float p =
            valid ? tc_exp2((x - (c ? lq.y : lq.x)) * TC_LOG2E) : 0.f;
        if constexpr (DBIAS) {
          const float dx = p * (dp[j][e] - (c ? dq2.y : dq2.x));
          if (n0 == 0 && kj < Sk && qi < Sq) {
            if (db.sq == 0) {
              dbacc[r] += dx;
            } else {
              float* dbat = db.p + b * db.sb + h * db.sh + qi * db.sq + kj;
              if (db.unique) {
                *dbat = dx;
              } else {
                atomicAdd(dbat, dx);
              }
            }
          }
        }
        dp[j][e] = p * (dp[j][e] - (c ? dq2.y : dq2.x)) * scale;
        s[j][e] = p;
      }
    }
    if constexpr (DBIAS) {
      // a column sum ends with its head's last query tile, or with the
      // group's when the mask is broadcast over heads
      const bool flush = db.sq == 0 && n0 == 0 &&
                         (db.sh != 0 ? it % nqt == nqt - 1
                                     : it == ntiles - 1);
      if (flush) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float sum = dbacc[r];
          sum += __shfl_xor_sync(PT_FULL_MASK, sum, 1);
          sum += __shfl_xor_sync(PT_FULL_MASK, sum, 2);
          const int kj = k0 + wr + g + 8 * r;
          if (t == 0 && kj < Sk)
            atomicAdd(db.p + b * db.sb + h * db.sh + kj, sum);
          dbacc[r] = 0.f;
        }
      }
    }

    // dV += P^T dO, dK += dS^T Q, P^T and dS^T rounded to E
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      uint32_t ap[4], ad[4];
      tc_acc_to_a<E>(s[2 * kk], s[2 * kk + 1], ap);
      tc_acc_to_a<E>(dp[2 * kk], dp[2 * kk + 1], ad);
#pragma unroll
      for (int n = 0; n < NC; n += 2) {
        if (n0 + n >= nd) break;
        uint32_t bb[4];
        tc_frag_bt<DT>(dOt, n0 + n, kk, lane, bb);
        tc_mma<E>(adv[n], ap, bb[0], bb[1]);
        tc_mma<E>(adv[n + 1], ap, bb[2], bb[3]);
        tc_frag_bt<DT>(Qt, n0 + n, kk, lane, bb);
        tc_mma<E>(adk[n], ad, bb[0], bb[1]);
        tc_mma<E>(adk[n + 1], ad, bb[2], bb[3]);
      }
    }
    __syncthreads();  // this stage is consumed before its next copy
  }

  tc_wait<0>();
  __syncthreads();  // every warp is done with K and V: they stage dK, dV
  const float one[2] = {1.f, 1.f};
  tc_acc_to_tile<DT, NC>(Ks, wr, n0, nd, adk, one, lane);
  tc_acc_to_tile<DT, NC>(Vs, wr, n0, nd, adv, one, lane);
  __syncthreads();
  tc_store_rows<DT, KT, TC_THREADS>(dk + kh, ks, Ks, k0, Sk, D,
                                    threadIdx.x);
  tc_store_rows<DT, KT, TC_THREADS>(dv + kh, ks, Vs, k0, Sk, D,
                                    threadIdx.x);
}

template <typename E, int DT, bool BIAS, bool PACKED, bool HM, bool DBIAS>
static int launch_tc(const void* q, const void* k, const void* v,
                     const float* bias, const void* o, const float* lse,
                     const void* dout, float* delta, void* dq, void* dk,
                     void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                     long long bsb, long long bsh, long long bsq, int causal,
                     float scale, const int* cu_q, const int* cu_k, int nseg,
                     cudaStream_t stream, DBias db) {
  const long long rows = (long long)B * Sq * Hq;
  flash_bwd_delta_kernel<E, HM>
      <<<(unsigned)((rows + FB_WARPS - 1) / FB_WARPS), FB_WARPS * 32, 0,
         stream>>>((const E*)o, (const E*)dout, delta, rows, Sq, Hq,
                   D);
  int err = (int)cudaGetLastError();
  if (err) return err;

  auto dq_kern = flash_bwd_dq_tc<E, DT, BIAS, PACKED, HM>;
  allow_smem(dq_kern, BwdTile<DT>::smem_dq);
  dq_kern<<<dim3((Sq + TC_BQ - 1) / TC_BQ, Hq, B), TC_THREADS,
            BwdTile<DT>::smem_dq, stream>>>(
      (const E*)q, (const E*)k, (const E*)v, bias, lse, delta,
      (const E*)dout, (E*)dq, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq, causal,
      scale, cu_q, cu_k, nseg);
  err = (int)cudaGetLastError();
  if (err) return err;

  constexpr int KT = BwdTile<DT>::KT;
  auto dkv_kern = flash_bwd_dkv_tc<E, DT, BIAS, PACKED, HM, DBIAS>;
  allow_smem(dkv_kern, BwdTile<DT>::smem_dkv);
  dkv_kern<<<dim3((Sk + KT - 1) / KT, Hkv, B), TC_THREADS,
             BwdTile<DT>::smem_dkv, stream>>>(
      (const E*)q, (const E*)k, (const E*)v, bias, lse, delta,
      (const E*)dout, (E*)dk, (E*)dv, Sq, Sk, Hq, Hkv, D, bsb, bsh,
      bsq, causal, scale, cu_q, cu_k, nseg, db);
  return (int)cudaGetLastError();
}

// bf16 or f16 (any mode), E: the tile width DT is the
// head dim rounded up to 64, 128 or 256.
template <typename E, bool BIAS, bool PACKED, bool HM = false,
          bool DBIAS = false>
static int dispatch_tc(const void* q, const void* k, const void* v,
                       const float* bias, const void* o, const float* lse,
                       const void* dout, float* delta, void* dq, void* dk,
                       void* dv, int B, int Sq, int Sk, int Hq, int Hkv,
                       int D, long long bsb, long long bsh, long long bsq,
                       int causal, float scale, const int* cu_q,
                       const int* cu_k, int nseg, cudaStream_t s,
                       DBias db = DBias{}) {
  if (!tc_aligned(q) || !tc_aligned(k) || !tc_aligned(v) ||
      !tc_aligned(dout) || !tc_aligned(dq) || !tc_aligned(dk) ||
      !tc_aligned(dv))
    return (int)cudaErrorMisalignedAddress;
  if (D <= 64)
    return launch_tc<E, 64, BIAS, PACKED, HM, DBIAS>(q, k, v, bias, o, lse, dout, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq, causal, scale, cu_q, cu_k, nseg, s, db);
  if (D <= 128)
    return launch_tc<E, 128, BIAS, PACKED, HM, DBIAS>(q, k, v, bias, o, lse, dout, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq, causal, scale, cu_q, cu_k, nseg, s, db);
  return launch_tc<E, 256, BIAS, PACKED, HM, DBIAS>(q, k, v, bias, o, lse, dout, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq, causal, scale, cu_q, cu_k, nseg, s, db);
}

// q / o / dout / dq [B, Sq, Hq, D]; k / v / dk / dv [B, Sk, Hkv, D];
// bias f32 or null, element (b, h, i, j) at b * bsb + h * bsh + i * bsq
// + j; lse and delta (scratch) [B, Hq, Sq] f32; dtype PT_F32, PT_BF16
// or PT_F16.  dbias null, or the dBias mode (a bias is then required):
// the bias's gradient is written to dbias (f32, zeroed by the caller),
// element (b, h, i, j) at b * dsb + h * dsh + i * dsq + j (stride 0 on
// the mask's broadcast axes); `unique` when no element is shared (every
// stride non-zero, or its axis of size 1).  The dQ pass is the biased
// mode's own.  Returns the first launch error, 0 when all three
// launches were accepted.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* bias, const void* o, const void* lse,
                         const void* dout, void* delta, void* dq, void* dk,
                         void* dv, void* dbias, int B, int Sq, int Sk,
                         int Hq, int Hkv, int D, long long bsb,
                         long long bsh, long long bsq, long long dsb,
                         long long dsh, long long dsq, int unique,
                         int causal, float scale, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dbias) {
    if (!bias) return (int)cudaErrorInvalidValue;
    const DBias db{(float*)dbias, dsb, dsh, dsq, unique};
    if (dtype == PT_BF16)
      return dispatch_tc<bf16, true, false, false, true>(
          q, k, v, (const float*)bias, o, (const float*)lse, dout,
          (float*)delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq,
          causal, scale, nullptr, nullptr, 0, s, db);
    if (dtype == PT_F16)
      return dispatch_tc<f16, true, false, false, true>(
          q, k, v, (const float*)bias, o, (const float*)lse, dout,
          (float*)delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq,
          causal, scale, nullptr, nullptr, 0, s, db);
    if (dtype != PT_F32) return (int)cudaErrorInvalidValue;
    return dispatch<float, false, false, true>(
        q, k, v, (const float*)bias, o, (const float*)lse, dout,
        (float*)delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq,
        causal, scale, nullptr, nullptr, 0, s, db);
  }
  if (dtype == PT_BF16)
    return bias ? dispatch_tc<bf16, true, false>(
                      q, k, v, (const float*)bias, o, (const float*)lse,
                      dout, (float*)delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D,
                      bsb, bsh, bsq, causal, scale, nullptr, nullptr, 0, s)
                : dispatch_tc<bf16, false, false>(
                      q, k, v, nullptr, o, (const float*)lse, dout,
                      (float*)delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D, 0, 0,
                      0, causal, scale, nullptr, nullptr, 0, s);
  if (dtype == PT_F16)
    return bias ? dispatch_tc<f16, true, false>(
                      q, k, v, (const float*)bias, o, (const float*)lse,
                      dout, (float*)delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D,
                      bsb, bsh, bsq, causal, scale, nullptr, nullptr, 0, s)
                : dispatch_tc<f16, false, false>(
                      q, k, v, nullptr, o, (const float*)lse, dout,
                      (float*)delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D, 0, 0,
                      0, causal, scale, nullptr, nullptr, 0, s);
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
    return dispatch_tc<bf16, false, true>(
        q, k, v, nullptr, o, (const float*)lse, dout, (float*)delta, dq, dk,
        dv, 1, Tq, Tk, H, H, D, 0, 0, 0, causal, scale, cq, ck, nseg, s);
  if (dtype == PT_F16)
    return dispatch_tc<f16, false, true>(
        q, k, v, nullptr, o, (const float*)lse, dout, (float*)delta, dq, dk,
        dv, 1, Tq, Tk, H, H, D, 0, 0, 0, causal, scale, cq, ck, nseg, s);
  if (dtype != PT_F32) return (int)cudaErrorInvalidValue;
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
    return dispatch_tc<bf16, false, false, true>(
        q, k, v, nullptr, o, (const float*)lse, dout, (float*)delta, dq, dk,
        dv, B, Sq, Sk, Hq, Hkv, D, 0, 0, 0, causal, scale, nullptr, nullptr,
        0, s);
  if (dtype == PT_F16)
    return dispatch_tc<f16, false, false, true>(
        q, k, v, nullptr, o, (const float*)lse, dout, (float*)delta, dq, dk,
        dv, B, Sq, Sk, Hq, Hkv, D, 0, 0, 0, causal, scale, nullptr, nullptr,
        0, s);
  if (dtype != PT_F32) return (int)cudaErrorInvalidValue;
  return dispatch<float, false, true>(
      q, k, v, nullptr, o, (const float*)lse, dout, (float*)delta, dq, dk,
      dv, B, Sq, Sk, Hq, Hkv, D, 0, 0, 0, causal, scale, nullptr, nullptr, 0,
      s);
}
