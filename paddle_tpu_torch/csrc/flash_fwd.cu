// Flash-attention forward (causal / full, optional additive bias) for
// Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_fwd_kernel`
// (:241) and its layout variants `_fwd_kernel_mh` (:354) and the kv/flat
// cores, launched by `_fwd_t` (:291), `_fwd_mh` (:384), `_fwd_kv` (:913)
// and `_fwd_flat` (:1239); and `_fwd_kernel_bias` (:256), launched by
// `_fwd_tb` (:1503).  One source serves all of them: it reads Q/K/V in
// the native [B, S, H, D] layout (so no layout tiers and no relayouts),
// GQA grouped as kv head = h / (Hq / Hkv), and an optional f32 bias
// through strides (stride 0 on broadcast batch / head dims).  Packed
// mode (below) replaces paddle_tpu/ops/pallas/varlen_attention.py
// `_vl_fwd` (:105), and head-major mode the Q/O addressing of `_fwd_kv`.
//
// Bound on this card: operations at the prefill and train shapes, 4 * D
// flops per visible (query, key) pair against 2 * (Sq + 2 * Sk) * D
// bytes per head: at the GPT-125M train shape (causal B8 S1024 H12 D64)
// 12.9 GFLOP, 0.0131 ms at the 989 TFLOP/s bf16 tensor-core peak.
//
// Design, bf16 (every mode below): a FlashAttention-2 core on the tensor
// cores (`flash_fwd_tc`, building blocks in flash_tc.cuh).  One block of
// 4 warps per (query tile, head, batch), the query tiles with the most
// key tiles launched first; each warp owns 16 query rows (32 at head
// dims 65-128 in the dense and head-major modes, so that each K / V
// fragment feeds two products).  Q, K and V stay bf16 in XOR-swizzled
// shared memory; K/V tiles of 64 keys (32 at head dims above 128) come
// in by 16-byte cp.async copies into a 2-stage ring, the next tile's
// copy issued before the current tile is computed.  With 16 rows a warp
// (head dims up to 128) Q goes into registers once, by ldmatrix;
// otherwise each warp re-reads its rows by ldmatrix.  S = Q K^T by mma.sync
// m16n8k16 (bf16 operands, f32 accumulators); scale, bias and masks are
// applied in registers at each accumulator element's (row, key); the
// online softmax's row max and sum reduce over a row's 4 lanes by
// shuffles, and the sum adds the unrounded f32 p, as JAX does.  P is
// rounded to bf16 in registers into the A fragments of P V (JAX rounds
// it there too, flash_attention.py:209), V read by ldmatrix.trans.  O
// accumulates in f32 registers; the epilogue divides by l, stages the
// bf16 rows through shared memory for 16-byte stores and writes the f32
// LSE.  Only key tiles that cross the diagonal, Sk or a segment edge run
// the masked body.  A head dim that is not a multiple of 16 is
// zero-padded to one in shared memory.  Next step (not taken here):
// wgmma on 64-row warpgroup tiles fed by TMA from a producer warp (warp
// specialisation), which mma.sync cannot reach.
//
// f16, in every mode (dense causal / full, biased, packed, head-major):
// the same tensor-core core instantiated on f16 elements (`E`): mma.sync
// m16n8k16 on f16 operands with f32 accumulators, P rounded to f16 where
// the bf16 kernel rounds it to bf16, the f32 LSE kept.
//
// f32 keeps the first version's CUDA-core kernel (`flash_fwd_kernel`),
// the port's oracle path (TF32 tensor cores would keep ~3 digits): one
// block of 8 warps per (32-query tile, head, batch) walks 32-key tiles
// staged through shared memory as f32; lane c owns key c of the tile,
// each warp owns 4 query rows, and the probabilities reach the P.V
// product by shuffle.  Its ceiling is the 67 TFLOP/s f32 peak.
//
// Both cores: causal blocks past the diagonal are not visited (bottom-
// right aligned: off = Sk - Sq, flash_attention.py:178).  Ragged Sq / Sk
// tails are masked in the kernel: any Sq, Sk.  Masked scores get the
// finite NEG_INF and the denominator is clamped at 1e-30, as in the JAX
// kernel, so a fully masked (left-pad) row stays finite.
//
// Packed (varlen) mode, PACKED = true.  Replaces:
// paddle_tpu/ops/pallas/varlen_attention.py `_vl_fwd_kernel` (:56),
// launched by `_vl_fwd` (:105), which runs the same online softmax with
// per-position segment ids in its block masks.  q [Tq, H, D] and k / v
// [Tk, H, D] are one packed batch (B = 1, no GQA: the JAX kernel indexes
// K/V by the query head); cu_seqlens_q / _k [n + 1] stay on the device.
// Each query tile finds its rows' segments by binary search in
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
// Head-major mode (the `kv` layout tier), HM = true: Q and O are [B, Hq,
// Sq, D] instead of [B, Sq, Hq, D]; K, V and the LSE keep their layouts.
// Replaces the Q/O addressing of `_fwd_kv` (:913, pallas_call :924)
// under `_flash_core_kv` (:1070), which reads the head-major Q that
// `_to_hm` makes and writes the head-major O that `_from_hm` undoes.
// Only the row offsets differ, so its numbers are the native mode's bit
// for bit, in both cores.
#include "common.cuh"
#include "flash_tc.cuh"

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

// ------------------------------------------------------------ bf16, f16
// The tensor-core core: every bf16 and every f16 mode runs here.

// MASKS: the mode reads a bias or segment bounds per element.
template <int DT, bool MASKS>
struct FwdTile {
  // 16-row m-tiles per warp: two at DT 128, where each K / V fragment
  // then feeds two products (on an H100, 0.30 against 0.43 ms at B8
  // S1024 H16 D128, tools/flash_ab.py), except where the bias or segment
  // bounds need the registers; one at DT 64, where two did not pay
  // (their registers halve the blocks per SM), and at DT 256, where
  // they do not fit
  static constexpr int MT = DT == 128 && !MASKS ? 2 : 1;
  static constexpr int BQ = 16 * MT * TC_WARPS;   // query rows per block
  static constexpr int BK = DT <= 128 ? 64 : 32;  // keys per tile
  // Q fragments in registers, where they fit beside the accumulators
  static constexpr bool QREG = MT == 1 && DT <= 128;
  // Q, then the K and V rings of 2 stages
  static constexpr size_t smem = sizeof(bf16) * (size_t)(BQ + 4 * BK) * DT;
};

template <typename E, int DT, bool BIAS, bool PACKED, bool HM>
__global__ void __launch_bounds__(TC_THREADS) flash_fwd_tc(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const float* __restrict__ bias,
    E* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int Hq,
    int Hkv, int D, long long bsb, long long bsh, long long bsq, int causal,
    float scale, const int* __restrict__ cu_q, const int* __restrict__ cu_k,
    int nseg) {
  using Tile = FwdTile<DT, BIAS || PACKED>;
  constexpr int MT = Tile::MT, BQ = Tile::BQ;
  constexpr int BK = Tile::BK, NT = BK / 8, KS = DT / 16, ND = DT / 8;
  constexpr bool QREG = Tile::QREG;
  extern __shared__ __align__(128) unsigned char fwd_smem[];
  E* Qs = reinterpret_cast<E*>(fwd_smem);  // [BQ][DT]
  E* Ks = Qs + BQ * DT;                    // [2][BK][DT]
  E* Vs = Ks + 2 * BK * DT;                // [2][BK][DT]
  const float ninf = __int_as_float(0xff800000);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest first
  const int qmax = min(q0 + BQ, Sq) - 1;
  const int off = Sk - Sq;
  const int wr = warp * 16 * MT;    // the warp's first row of the tile
  const int nk = (D + 15) >> 4;     // k-steps over d
  const int nd = 2 * nk;            // n-tiles over d (the pad reads 0)

  // keys visited, and [kin_lo, kin_hi): the keys every row may see
  int kbeg = 0, kend = Sk, kin_lo = 0, kin_hi = Sk;
  int klo[MT][2], khi[MT][2];  // packed: rows g, g + 8 of each m-tile
  if constexpr (PACKED) {
    const int s0 = pt_segment(cu_q, nseg, q0);
    const int s1 = pt_segment(cu_q, nseg, qmax);
    kbeg = pt_bound(cu_k, nseg, Sk, s0);
    kend = pt_bound(cu_k, nseg, Sk, s1 + 1);
    kin_lo = pt_bound(cu_k, nseg, Sk, s1);
    kin_hi = pt_bound(cu_k, nseg, Sk, s0 + 1);
    if (causal) kend = min(kend, qmax + off + 1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int s = pt_segment(
            cu_q, nseg, min(q0 + wr + 16 * mt + g + 8 * r, Sq - 1));
        klo[mt][r] = pt_bound(cu_k, nseg, Sk, s);
        khi[mt][r] = pt_bound(cu_k, nseg, Sk, s + 1);
      }
  } else if (causal) {
    kend = max(0, min(Sk, qmax + off + 1));
  }
  const int ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  // row i of this (head, batch): q + qh + i * qs (o alike); of its kv
  // head: k + kh + i * ks (v alike)
  const long long qh = fa_row<HM>(b, 0, h, Sq, Hq, D);
  const long long qs = HM ? D : (long long)Hq * D;
  const long long kh = ((long long)b * Sk * Hkv + hk) * D;
  const long long ks = (long long)Hkv * D;
  tc_zero_pad<DT>(Qs, BQ + 4 * BK, D);
  tc_load_rows<BQ, DT>(Qs, q + qh, qs, q0, Sq, D);
  if (ntiles > 0) {
    tc_load_rows<BK, DT>(Ks, k + kh, ks, kbeg, Sk, D);
    tc_load_rows<BK, DT>(Vs, v + kh, ks, kbeg, Sk, D);
  }
  tc_commit();
  const float* brow = nullptr;
  if constexpr (BIAS) brow = bias + b * bsb + h * bsh;

  uint32_t qf[MT][QREG ? KS : 1][4];
  float acc[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = PT_NEG_INF;
      l[mt][r] = 0.f;
    }

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = kbeg + it * BK;
    const E* Kt = Ks + (it & 1) * BK * DT;
    const E* Vt = Vs + (it & 1) * BK * DT;
    if (it + 1 < ntiles) {  // the next tile's copy overlaps this tile
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
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
            if (kk < nk) tc_frag_a<DT>(Qs, wr + 16 * mt, kk, lane, qf[mt][kk]);
      }
    }

    // S = Q K^T: each K fragment feeds the warp's MT m-tiles
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk >= nk) break;
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[mt][e] = qf[mt][kk][e];
        } else {
          tc_frag_a<DT>(Qs, wr + 16 * mt, kk, lane, a[mt]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bb[4];
        tc_frag_b<DT>(Kt, j, kk, lane, bb);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          tc_mma<E>(s[mt][j], a[mt], bb[0], bb[1]);
          tc_mma<E>(s[mt][j + 1], a[mt], bb[2], bb[3]);
        }
      }
    }

    // scale, bias, masks at each element's (row, key)
    const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > q0 + off) ||
                        (PACKED && (k0 < kin_lo || k0 + BK > kin_hi));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (BIAS || masked) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const int qi = q0 + wr + 16 * mt + g + 8 * r;
            const int kj = k0 + 8 * j + 2 * t + (e & 1);
            float x = s[mt][j][e] * scale;
            if constexpr (BIAS) {
              if (kj < Sk && qi < Sq) x += brow[qi * bsq + kj];
            }
            if (masked) {
              if constexpr (PACKED) {
                // another segment's key, or past the diagonal: weight 0
                if (kj < klo[mt][r] || kj >= khi[mt][r] ||
                    (causal && qi + off < kj))
                  x = ninf;
              } else {
                if (causal && qi + off < kj) x = PT_NEG_INF;
                if (kj >= Sk) x = ninf;  // not a key at all: weight 0
              }
            }
            s[mt][j][e] = x;
          }
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] *= scale;
      }

      // online softmax over the tile; p overwrites s
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[mt][r];
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mx = fmaxf(mx, fmaxf(s[mt][j][2 * r], s[mt][j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(PT_FULL_MASK, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(PT_FULL_MASK, mx, 2));
        const float alpha = tc_exp2((m[mt][r] - mx) * TC_LOG2E);
        m[mt][r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = tc_exp2((s[mt][j][2 * r + c] - mx) * TC_LOG2E);
            s[mt][j][2 * r + c] = p;
            sum += p;
          }
        l[mt][r] = l[mt][r] * alpha + sum;  // this lane's share of the sum
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          acc[mt][n][2 * r] *= alpha;
          acc[mt][n][2 * r + 1] *= alpha;
        }
      }
    }

    // O += P V, P rounded to E (bf16 or f16) in registers; each V fragment feeds
    // the warp's MT m-tiles
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        tc_acc_to_a<E>(s[mt][2 * kk], s[mt][2 * kk + 1], a[mt]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        if (n >= nd) break;
        uint32_t bb[4];
        tc_frag_bt<DT>(Vt, n, kk, lane, bb);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          tc_mma<E>(acc[mt][n], a[mt], bb[0], bb[1]);
          tc_mma<E>(acc[mt][n + 1], a[mt], bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before its next copy
  }

  tc_wait<0>();
  __syncthreads();
  // the warp's own Q rows (no other warp reads them) stage its O rows
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float ls = l[mt][r];
      ls += __shfl_xor_sync(PT_FULL_MASK, ls, 1);
      ls += __shfl_xor_sync(PT_FULL_MASK, ls, 2);
      ls = fmaxf(ls, PT_L_MIN);
      inv[r] = 1.f / ls;
      const int qi = q0 + wr + 16 * mt + g + 8 * r;
      if (t == 0 && qi < Sq)
        lse[((long long)b * Hq + h) * Sq + qi] = m[mt][r] + logf(ls);
    }
    tc_acc_to_tile<DT, ND>(Qs, wr + 16 * mt, 0, nd, acc[mt], inv, lane);
  }
  __syncwarp();
  tc_store_rows<DT, 16 * MT, 32>(o + qh, qs, Qs + wr * DT, q0 + wr, Sq, D,
                                 lane);
}

template <typename E, int DT, bool BIAS, bool PACKED, bool HM>
static int launch_tc(const void* q, const void* k, const void* v,
                     const float* bias, void* o, float* lse, int B, int Sq,
                     int Sk, int Hq, int Hkv, int D, long long bsb,
                     long long bsh, long long bsq, int causal, float scale,
                     const int* cu_q, const int* cu_k, int nseg,
                     cudaStream_t stream) {
  using Tile = FwdTile<DT, BIAS || PACKED>;
  const size_t smem = Tile::smem;
  auto kern = flash_fwd_tc<E, DT, BIAS, PACKED, HM>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  dim3 grid((Sq + Tile::BQ - 1) / Tile::BQ, Hq, B);
  kern<<<grid, TC_THREADS, smem, stream>>>(
      (const E*)q, (const E*)k, (const E*)v, bias, (E*)o, lse, Sq,
      Sk, Hq, Hkv, D, bsb, bsh, bsq, causal, scale, cu_q, cu_k, nseg);
  return (int)cudaGetLastError();
}

// bf16 or f16 (any mode), E: the tile width DT is the
// head dim rounded up to 64, 128 or 256.
template <typename E, bool BIAS, bool PACKED, bool HM = false>
static int dispatch_tc(const void* q, const void* k, const void* v,
                       const float* bias, void* o, float* lse, int B, int Sq,
                       int Sk, int Hq, int Hkv, int D, long long bsb,
                       long long bsh, long long bsq, int causal, float scale,
                       const int* cu_q, const int* cu_k, int nseg,
                       cudaStream_t s) {
  if (!tc_aligned(q) || !tc_aligned(k) || !tc_aligned(v) || !tc_aligned(o))
    return (int)cudaErrorMisalignedAddress;
  if (D <= 64)
    return launch_tc<E, 64, BIAS, PACKED, HM>(q, k, v, bias, o, lse, B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq, causal, scale, cu_q, cu_k, nseg, s);
  if (D <= 128)
    return launch_tc<E, 128, BIAS, PACKED, HM>(q, k, v, bias, o, lse, B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq, causal, scale, cu_q, cu_k, nseg, s);
  return launch_tc<E, 256, BIAS, PACKED, HM>(q, k, v, bias, o, lse, B, Sq, Sk, Hq, Hkv, D, bsb, bsh, bsq, causal, scale, cu_q, cu_k, nseg, s);
}

// q [B, Sq, Hq, D]; k/v [B, Sk, Hkv, D]; bias f32 or null, element
// (b, h, i, j) at b * bsb + h * bsh + i * bsq + j; o [B, Sq, Hq, D];
// lse [B, Hq, Sq] f32.  dtype PT_F32, PT_BF16 or PT_F16 (the last two on
// the tensor cores).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* bias, void* o, void* lse, int B, int Sq,
                         int Sk, int Hq, int Hkv, int D, long long bsb,
                         long long bsh, long long bsq, int causal, float scale,
                         int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == PT_BF16)
    return bias ? dispatch_tc<bf16, true, false>(
                      q, k, v, (const float*)bias, o, (float*)lse, B, Sq, Sk,
                      Hq, Hkv, D, bsb, bsh, bsq, causal, scale, nullptr,
                      nullptr, 0, s)
                : dispatch_tc<bf16, false, false>(
                      q, k, v, nullptr, o, (float*)lse, B, Sq, Sk, Hq, Hkv, D,
                      0, 0, 0, causal, scale, nullptr, nullptr, 0, s);
  if (dtype == PT_F16)
    return bias ? dispatch_tc<f16, true, false>(
                      q, k, v, (const float*)bias, o, (float*)lse, B, Sq, Sk,
                      Hq, Hkv, D, bsb, bsh, bsq, causal, scale, nullptr,
                      nullptr, 0, s)
                : dispatch_tc<f16, false, false>(
                      q, k, v, nullptr, o, (float*)lse, B, Sq, Sk, Hq, Hkv, D,
                      0, 0, 0, causal, scale, nullptr, nullptr, 0, s);
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
    return dispatch_tc<bf16, false, true>(q, k, v, nullptr, o, (float*)lse,
                                          1, Tq, Tk, H, H, D, 0, 0, 0, causal,
                                          scale, cq, ck, nseg, s);
  if (dtype == PT_F16)
    return dispatch_tc<f16, false, true>(q, k, v, nullptr, o, (float*)lse,
                                         1, Tq, Tk, H, H, D, 0, 0, 0, causal,
                                         scale, cq, ck, nseg, s);
  if (dtype != PT_F32) return (int)cudaErrorInvalidValue;
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
    return dispatch_tc<bf16, false, false, true>(
        q, k, v, nullptr, o, (float*)lse, B, Sq, Sk, Hq, Hkv, D, 0, 0, 0,
        causal, scale, nullptr, nullptr, 0, s);
  if (dtype == PT_F16)
    return dispatch_tc<f16, false, false, true>(
        q, k, v, nullptr, o, (float*)lse, B, Sq, Sk, Hq, Hkv, D, 0, 0, 0,
        causal, scale, nullptr, nullptr, 0, s);
  if (dtype != PT_F32) return (int)cudaErrorInvalidValue;
  return dispatch<float, false, true>(q, k, v, nullptr, o, (float*)lse, B,
                                      Sq, Sk, Hq, Hkv, D, 0, 0, 0, causal,
                                      scale, nullptr, nullptr, 0, s);
}
