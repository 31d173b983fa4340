// Fused Swin window attention, backward, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/window_attention.py `_bwd_kernel`
// (:201), launched by `_bwd_pallas` (:290, pallas_call :309) — the
// gradient of every Swin block's attention in training: for each window
// and head it replays the forward's scores, and emits dqkv in image
// layout and the head's dbias summed over the windows of one batch
// (the caller sums the [B, heads, P, P] partials over B, as :334 does).
// The shift mask is stop-gradient by contract and gets no cotangent.
//
// Bound on this card: device-memory bytes at Swin-T's shapes.  qkv and
// the output cotangent g are read once and dqkv written once; a window
// of P = ws * ws = 49 tokens and head_dim 32 does 10 * P * P * hd =
// 768k flops per head (five P x P x hd products) against 7 * P * hd
// elements moved, about 35 flops per bf16 byte, under the tensor
// cores' 295 per byte.
//
// Design: one block per (batch, head), 256 threads, walking all of the
// batch's windows in turn.  The block keeps the head's [P][P] f32 dbias
// partial in shared memory across its windows and writes it once at
// the end: blocks run in parallel in no order, and a per-(batch, head)
// partial needs no atomics, so the result is the same on every run.
// (Stage 1 of Swin-T at batch 128: 384 blocks of 64 windows each.)
// The shift moves no data, as in the forward (csrc/window_attention.cu):
// the token at rolled position (R, C) of window (wi, wj) is read from,
// and its gradient written to, image position ((R + shift) mod H,
// (C + shift) mod W); the mask is indexed in rolled window order.
// Per window the block stages the head's q (unscaled), k, v and g as
// f32 [P][hd + 1] tiles (padded against bank conflicts), then
//   A. forms the scores s = (q * hd**-0.5) . k + bias[h] (+ mask[w]),
//      as the forward forms them, and dP = g . v^T;
//   B. one warp per row: the max-subtracted softmax P (lanes past P
//      stay out of the max, the sum and the rowsum), then
//      dS = P * (dP - rowsum(dP * P)), added into the dbias partial;
//   C. dV = P^T g, dQ = dS k * scale and dK = dS^T q * scale (q
//      unscaled, as `_bwd_kernel` :236-243), written at the tokens'
//      image positions in qkv's channel order [dq | dk | dv], each
//      [heads, hd], in qkv's dtype.
// This kernel does all its math in f32 on CUDA cores and serves f32
// inputs only: the port's oracle path.  Shared memory is 4 P (hd + 1) +
// 3 P^2 floats (55 KB at P = 49, hd = 32), over the 48 KB static limit,
// so the launcher raises the block's dynamic limit.
//
// bf16: `window_attention_bwd_tc`, one window per tensor-core tile.  P
// (<= 64) is padded to 64 rows and columns, so a window is one 64 x 64
// score tile and each of 4 warps owns 16 query rows.  Per window:
//   1. q, k, v and g of the head arrive as swizzled [64][DT] bf16 tiles
//      (DT = hd rounded up to 16, 32 or 64) by 16-byte cp.async, each
//      token's head slice from its image position, and the window's
//      mask by 4-byte cp.async, double-buffered: the next window's
//      copies fly while this one is computed;
//   2. S = q k^T and dP = g v^T by mma.sync m16n8k16 (f32 accumulators);
//      the scale multiplies the f32 S (q * scale is not a bf16 value),
//      then the bias (staged once in shared memory for the block's
//      windows) and the window's mask are added; P and dS = P (dP -
//      rowsum(dP P)) in registers, each row's max and sums over the 4
//      lanes that hold it;
//   3. the f32 dS is added into the block's f32 dbias partial in shared
//      memory (each element by the one thread that holds it), and dQ =
//      dS k comes straight from the dS fragments (rounded to bf16) with
//      k read by ldmatrix.trans;
//   4. P and dS go to shared memory as bf16; each warp then forms dV =
//      P^T g and dK = dS^T q for 16 keys (P^T and dS^T by ldmatrix.trans
//      of the query-major tiles);
//   5. dq, dk, dv (scaled) are staged as bf16 tiles where P and dS were
//      and written as 16-byte chunks to the tokens' image positions.
//   Bias and dbias live in shared memory rather than in registers, so
//   that 3 blocks fit an SM at DT <= 32 without a mask (68 KB a block).
// What was in the way, and how each is handled:
//   - padded rows and columns: columns >= P take -inf before the max, so
//     their P is 0; rows >= P (zero q, k, v, g) get P = 0 and dS = 0 and
//     add nothing to dK, dV or dbias.  Bias and mask reads stay inside
//     [P, P] (the bias fragment past P is 0 and never read);
//   - the swizzle: a 32-value row has 4 chunks, so tiles of hd 32 use
//     the 2-bit swizzle of flash_tc.cuh (and 16-value rows the 1-bit
//     one), conflict-free for ldmatrix;
//   - head dims 8, 24 and 64: zero-filled to DT (the pad chunks are
//     zeroed once and never copied); the wrapper raises for a shape the
//     tile cannot take (P > 64, hd > 64, hd % 8 != 0);
//   - occupancy: a block walks a group of a (batch, head)'s windows
//     (`wb_groups`: about 8 blocks per SM, at least 4 windows a block),
//     each group writing its own dbias partial [B * groups, heads, P,
//     P], which the wrapper sums: no atomics, the same bits every run;
//   - precision: P and dS are rounded to bf16 for the products (JAX
//     keeps them f32); dbias sums the f32 dS;
//   - registers: capped for 3 blocks an SM at DT <= 32 (<= 170), 2 at 64,
//     with no spill; chip_smoke.py's [build] gate fails on a spill.
// f16 runs the same tile on f16 operands (`window_attention_bwd_tc<DT,
// f16>`), with the bf16 gate (P <= 64, hd <= 64, hd % 8 == 0) and the
// bf16 window groups and dbias partials: P and dS are rounded to f16
// where bf16 rounds them to bf16; dbias still sums the f32 dS.
#include "flash_tc.cuh"

#define WB_THREADS 256
#define WB_MAX_JT 8      // ceil(P / 32) <= 8: P <= 256
#define WB_NEG_INF (__int_as_float((int)0xff800000u))

template <typename T>
__global__ void __launch_bounds__(WB_THREADS)
window_attention_bwd_kernel(const T* __restrict__ qkv,
                            const float* __restrict__ bias,
                            const float* __restrict__ mask,
                            const T* __restrict__ g, T* __restrict__ dqkv,
                            float* __restrict__ dbias, int H, int W, int C,
                            int heads, int hd, int ws, int shift,
                            float scale) {
  extern __shared__ float sm[];
  const int P = ws * ws;
  const int ld = hd + 1;
  float* q = sm;                 // [P][hd + 1], unscaled
  float* k = q + P * ld;
  float* v = k + P * ld;
  float* go = v + P * ld;        // the output's cotangent
  float* pr = go + P * ld;       // [P][P]: scores, then probabilities
  float* ds = pr + P * P;        // [P][P]: dP, then dS
  float* db = ds + P * P;        // [P][P]: this head's dbias partial
  const int h = blockIdx.x, b = blockIdx.y;
  const int nwc = W / ws, nwin = (H / ws) * nwc;
  const long long row3 = 3LL * C;
  const long long img = (long long)b * H * W;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* bh = bias + (long long)h * P * P;

  for (int idx = tid; idx < P * P; idx += WB_THREADS) db[idx] = 0.f;

  for (int win = 0; win < nwin; ++win) {
    const int wi = win / nwc, wj = win - wi * nwc;
    __syncthreads();     // the last window's pass C is done with the tiles
    for (int idx = tid; idx < P * hd; idx += WB_THREADS) {
      const int t = idx / hd, d = idx - t * hd;
      const int r = t / ws, c = t - r * ws;
      const int y = (wi * ws + r + shift) % H, xx = (wj * ws + c + shift) % W;
      const long long pix = img + (long long)y * W + xx;
      const T* src = qkv + pix * row3 + h * hd + d;
      q[t * ld + d] = to_f(src[0]);
      k[t * ld + d] = to_f(src[C]);
      v[t * ld + d] = to_f(src[2 * C]);
      go[t * ld + d] = to_f(g[pix * C + h * hd + d]);
    }
    __syncthreads();

    // A: the scores, as the forward forms them, and dP = g v^T
    const float* mw = mask ? mask + (long long)win * P * P : nullptr;
    for (int idx = tid; idx < P * P; idx += WB_THREADS) {
      const int i = idx / P, j = idx - i * P;
      const float* qi = q + i * ld;
      const float* kj = k + j * ld;
      const float* gi = go + i * ld;
      const float* vj = v + j * ld;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < hd; ++d) {
        s = fmaf(qi[d] * scale, kj[d], s);
        dp = fmaf(gi[d], vj[d], dp);
      }
      s = s + bh[idx];
      if (mw) s = s + mw[idx];
      pr[idx] = s;
      ds[idx] = dp;
    }
    __syncthreads();

    // B: one warp per row: softmax, dS = P (dP - rowsum(dP P)), dbias
    for (int i = warp; i < P; i += WB_THREADS / 32) {
      float* pi = pr + i * P;
      float* di = ds + i * P;
      float* dbi = db + i * P;
      float pv[WB_MAX_JT], dv[WB_MAX_JT];
      float m = WB_NEG_INF;
#pragma unroll
      for (int t = 0; t < WB_MAX_JT; ++t) {
        const int j = lane + 32 * t;
        pv[t] = j < P ? pi[j] : WB_NEG_INF;
        dv[t] = j < P ? di[j] : 0.f;
        m = fmaxf(m, pv[t]);
      }
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < WB_MAX_JT; ++t) {
        const int j = lane + 32 * t;
        pv[t] = j < P ? expf(pv[t] - m) : 0.f;
        sum += pv[t];
      }
      sum = warp_sum(sum);
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < WB_MAX_JT; ++t) {
        pv[t] = pv[t] / sum;          // 0 past P
        dot = fmaf(dv[t], pv[t], dot);
      }
      dot = warp_sum(dot);
#pragma unroll
      for (int t = 0; t < WB_MAX_JT; ++t) {
        const int j = lane + 32 * t;
        if (j < P) {
          const float dsv = pv[t] * (dv[t] - dot);
          pi[j] = pv[t];
          di[j] = dsv;
          dbi[j] += dsv;
        }
      }
    }
    __syncthreads();

    // C: dQ, dK, dV at the tokens' image positions, [dq | dk | dv]
    for (int idx = tid; idx < 3 * P * hd; idx += WB_THREADS) {
      const int part = idx / (P * hd);
      const int rem = idx - part * P * hd;
      const int t = rem / hd, d = rem - t * hd;
      float acc = 0.f;
      if (part == 0) {                       // dQ[t] = scale dS[t, :] k
        const float* dst = ds + t * P;
        for (int j = 0; j < P; ++j) acc = fmaf(dst[j], k[j * ld + d], acc);
        acc = acc * scale;
      } else if (part == 1) {                // dK[t] = scale dS[:, t] q
        for (int i = 0; i < P; ++i)
          acc = fmaf(ds[i * P + t], q[i * ld + d], acc);
        acc = acc * scale;
      } else {                               // dV[t] = P[:, t] g
        for (int i = 0; i < P; ++i)
          acc = fmaf(pr[i * P + t], go[i * ld + d], acc);
      }
      const int r = t / ws, c = t - r * ws;
      const int y = (wi * ws + r + shift) % H, xx = (wj * ws + c + shift) % W;
      const long long pix = img + (long long)y * W + xx;
      dqkv[pix * row3 + (long long)part * C + h * hd + d] = from_f<T>(acc);
    }
  }
  __syncthreads();
  float* out = dbias + ((long long)b * heads + h) * P * P;
  for (int idx = tid; idx < P * P; idx += WB_THREADS) out[idx] = db[idx];
}

template <typename T>
static int launch(const void* qkv, const void* bias, const void* mask,
                  const void* g, void* dqkv, void* dbias, int B, int H,
                  int W, int C, int heads, int ws, int shift, float scale,
                  cudaStream_t stream) {
  const int hd = C / heads, P = ws * ws;
  const size_t smem =
      (4 * (size_t)P * (hd + 1) + 3 * (size_t)P * P) * sizeof(float);
  auto kern = window_attention_bwd_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(heads, B);
  kern<<<grid, WB_THREADS, smem, stream>>>(
      (const T*)qkv, (const float*)bias, (const float*)mask, (const T*)g,
      (T*)dqkv, (float*)dbias, H, W, C, heads, hd, ws, shift, scale);
  return (int)cudaGetLastError();
}

#define WB_T 64     // the padded window: 64 query rows, 64 key columns
// bf16 elements of the region that holds P and dS, then the outputs
#define WB_PS(DT) (3 * WB_T * (DT) > 2 * WB_T * WB_T ? 3 * WB_T * (DT) \
                                                     : 2 * WB_T * WB_T)

// bf16 window backward on the tensor cores (see the note at the top).
// grid (heads * groups, B); windows [grp * wpb, min(nwin, (grp + 1) *
// wpb)) of batch b for head h.
template <int DT, typename E>
__global__ void __launch_bounds__(TC_THREADS, DT <= 32 ? 3 : 2)
window_attention_bwd_tc(const E* __restrict__ qkv,
                        const float* __restrict__ bias,
                        const float* __restrict__ mask,
                        const E* __restrict__ g, E* __restrict__ dqkv,
                        float* __restrict__ dbias, int H, int W, int C,
                        int heads, int hd, int ws, int shift, float scale,
                        int groups, int wpb) {
  constexpr int NC = DT / 8, KS = DT / 16, ND = DT / 8, TILE = WB_T * DT;
  extern __shared__ __align__(128) unsigned char wb_smem[];
  E* in = reinterpret_cast<E*>(wb_smem);  // [2][q, k, v, g][64][DT]
  E* Ps = in + 8 * TILE;                  // [64][64]: P
  E* dSs = Ps + WB_T * WB_T;              // [64][64]: dS
  E* outs = Ps;       // [dq, dk, dv][64][DT], once P and dS are read
  float* Bsm = reinterpret_cast<float*>(Ps + WB_PS(DT));  // [P][P] bias
  float* DBs = Bsm + ws * ws * ws * ws;         // [P][P] dbias partial
  float* Ms = DBs + ws * ws * ws * ws;          // [2][P][P] masks
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int h = blockIdx.x % heads, grp = blockIdx.x / heads;
  const int b = blockIdx.y;
  const int P = ws * ws, nwc = W / ws, nwin = (H / ws) * nwc;
  const int w0 = grp * wpb, nw = min(nwin, w0 + wpb) - w0;
  const long long row3 = 3LL * C, img = (long long)b * H * W;
  const int hc = hd >> 3;  // 16-byte chunks of a head slice

  // the pad chunks (hd < DT) of the input tiles stay zero: never copied
  for (int i = tid; i < 8 * WB_T; i += TC_THREADS)
    for (int c = hc; c < NC; ++c)
      *reinterpret_cast<uint4*>(in + tc_swz<DT>(i, c)) =
          make_uint4(0, 0, 0, 0);
  // the head's bias, and the block's dbias partial from 0
  const float* bh = bias + (long long)h * P * P;
  for (int i = tid; i < P * P; i += TC_THREADS) {
    Bsm[i] = bh[i];
    DBs[i] = 0.f;
  }

  // image position of token r of window `win`
  auto pixel = [&](int win, int r) -> long long {
    const int wi = win / nwc, wj = win - wi * nwc;
    const int rr = r / ws, cc = r - rr * ws;
    const int y = (wi * ws + rr + shift) % H, x = (wj * ws + cc + shift) % W;
    return img + (long long)y * W + x;
  };
  auto load_win = [&](int win, int st) {
    E* base = in + st * 4 * TILE;
    const int c = tid % NC;
    if (c >= hc) return;
    for (int r = tid / NC; r < WB_T; r += TC_THREADS / NC) {
      const bool ok = r < P;
      const long long pix = ok ? pixel(win, r) : 0;
      const E* src = qkv + pix * row3 + h * hd + c * 8;
      const int at = tc_swz<DT>(r, c);
      tc_cp16(tc_smem(base + at), ok ? src : qkv, ok);
      tc_cp16(tc_smem(base + TILE + at), ok ? src + C : qkv, ok);
      tc_cp16(tc_smem(base + 2 * TILE + at), ok ? src + 2 * C : qkv, ok);
      tc_cp16(tc_smem(base + 3 * TILE + at),
              ok ? g + pix * C + h * hd + c * 8 : g, ok);
    }
  };
  // the window's mask [P][P] by 4-byte copies (its rows are not 16-byte
  // aligned), with the window's tiles
  auto load_mask = [&](int win, int st) {
    const float* src = mask + (long long)win * P * P;
    for (int i = tid; i < P * P; i += TC_THREADS)
      tc_cp4(tc_smem(Ms + st * P * P + i), src + i);
  };

  if (nw > 0) {
    load_win(w0, 0);
    if (mask) load_mask(w0, 0);
  }
  tc_commit();
  const float one[2] = {1.f, 1.f}, scl[2] = {scale, scale};
  for (int it = 0; it < nw; ++it) {
    const int st = it & 1, win = w0 + it;
    if (it + 1 < nw) {
      load_win(win + 1, st ^ 1);
      if (mask) load_mask(win + 1, st ^ 1);
      tc_commit();
      tc_wait<1>();
    } else {
      tc_wait<0>();
    }
    __syncthreads();
    const E* Qs = in + st * 4 * TILE;
    const E* Ks = Qs + TILE;
    const E* Vs = Ks + TILE;
    const E* Gs = Vs + TILE;

    // 2. S = q k^T, dP = g v^T for the warp's 16 rows
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t aq[4], ag[4];
      tc_frag_a<DT>(Qs, 16 * warp, kk, lane, aq);
      tc_frag_a<DT>(Gs, 16 * warp, kk, lane, ag);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t bb[4];
        tc_frag_b<DT>(Ks, j, kk, lane, bb);
        tc_mma<E>(s[j], aq, bb[0], bb[1]);
        tc_mma<E>(s[j + 1], aq, bb[2], bb[3]);
        tc_frag_b<DT>(Vs, j, kk, lane, bb);
        tc_mma<E>(dp[j], ag, bb[0], bb[1]);
        tc_mma<E>(dp[j + 1], ag, bb[2], bb[3]);
      }
    }

    // P and dS in registers (s becomes P, dp becomes dS); dbias += dS
    const float* mw = mask ? Ms + st * P * P : nullptr;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = 16 * warp + gq + 8 * r;
      const bool row = i < P;
      float m = WB_NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;
          float x = s[j][2 * r + e] * scale;
          if (row && c < P) {
            x += Bsm[i * P + c];
            if (mw) x += mw[i * P + c];
          }
          if (c >= P) x = WB_NEG_INF;
          s[j][2 * r + e] = x;
          m = fmaxf(m, x);
        }
      m = fmaxf(m, __shfl_xor_sync(PT_FULL_MASK, m, 1));
      m = fmaxf(m, __shfl_xor_sync(PT_FULL_MASK, m, 2));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = __expf(s[j][2 * r + e] - m);
          s[j][2 * r + e] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(PT_FULL_MASK, sum, 1);
      sum += __shfl_xor_sync(PT_FULL_MASK, sum, 2);
      const float inv = row ? 1.f / sum : 0.f;   // rows past P: P = 0
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = s[j][2 * r + e] * inv;
          s[j][2 * r + e] = p;
          dot = fmaf(dp[j][2 * r + e], p, dot);
        }
      dot += __shfl_xor_sync(PT_FULL_MASK, dot, 1);
      dot += __shfl_xor_sync(PT_FULL_MASK, dot, 2);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = s[j][2 * r + e] * (dp[j][2 * r + e] - dot);
          dp[j][2 * r + e] = d;
          const int c = 8 * j + 2 * t + e;
          if (row && c < P) DBs[i * P + c] += d;   // this thread's own
        }
    }

    // 3. dQ = dS k (dS rounded to bf16), k by ldmatrix.trans
    float dq[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < WB_T / 16; ++kk) {
      uint32_t a[4];
      tc_acc_to_a<E>(dp[2 * kk], dp[2 * kk + 1], a);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t bb[4];
        tc_frag_bt<DT>(Ks, n, kk, lane, bb);
        tc_mma<E>(dq[n], a, bb[0], bb[1]);
        tc_mma<E>(dq[n + 1], a, bb[2], bb[3]);
      }
    }
    // 4. P and dS to shared memory (dq stays in registers)
    tc_acc_to_tile<WB_T, 8>(Ps, 16 * warp, 0, 8, s, one, lane);
    tc_acc_to_tile<WB_T, 8>(dSs, 16 * warp, 0, 8, dp, one, lane);
    __syncthreads();

    // dV = P^T g and dK = dS^T q for keys 16 warp .. 16 warp + 15
    float dk[ND][4], dv[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < WB_T / 16; ++kk) {
      uint32_t ap[4], ad[4];
      tc_frag_at<WB_T>(Ps, warp, kk, lane, ap);
      tc_frag_at<WB_T>(dSs, warp, kk, lane, ad);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t bb[4];
        tc_frag_bt<DT>(Gs, n, kk, lane, bb);
        tc_mma<E>(dv[n], ap, bb[0], bb[1]);
        tc_mma<E>(dv[n + 1], ap, bb[2], bb[3]);
        tc_frag_bt<DT>(Qs, n, kk, lane, bb);
        tc_mma<E>(dk[n], ad, bb[0], bb[1]);
        tc_mma<E>(dk[n + 1], ad, bb[2], bb[3]);
      }
    }
    __syncthreads();   // P and dS are read: their space stages the outputs
    tc_acc_to_tile<DT, ND>(outs, 16 * warp, 0, ND, dq, scl, lane);
    tc_acc_to_tile<DT, ND>(outs + TILE, 16 * warp, 0, ND, dk, scl, lane);
    tc_acc_to_tile<DT, ND>(outs + 2 * TILE, 16 * warp, 0, ND, dv, one, lane);
    __syncthreads();

    // 5. [dq | dk | dv] rows at the tokens' image positions
    for (int idx = tid; idx < 3 * WB_T * NC; idx += TC_THREADS) {
      const int part = idx / (WB_T * NC), rem = idx - part * WB_T * NC;
      const int r = rem / NC, c = rem - r * NC;
      if (r >= P || c >= hc) continue;
      const long long pix = pixel(win, r);
      *reinterpret_cast<uint4*>(dqkv + pix * row3 + part * C + h * hd +
                                c * 8) =
          *reinterpret_cast<const uint4*>(outs + part * TILE +
                                          tc_swz<DT>(r, c));
    }
  }

  __syncthreads();
  float* out = dbias + (((long long)b * groups + grp) * heads + h) * P * P;
  for (int i = tid; i < P * P; i += TC_THREADS) out[i] = DBs[i];
}

// Window groups per (batch, head) of the bf16 / f16 kernel: about 8
// blocks per SM (132 SMs), at least 4 windows a block; 1 for f32.
static int wb_groups(int B, int H, int W, int heads, int ws, int dtype) {
  const int nwin = (H / ws) * (W / ws);
  if (dtype == PT_F32 || nwin <= 4) return 1;
  const long long pairs = (long long)B * heads;
  const long long want = (8 * 132 + pairs - 1) / pairs;
  const int groups = (int)(want < nwin ? want : nwin);
  int wpb = (nwin + groups - 1) / groups;
  if (wpb < 4) wpb = 4;
  return (nwin + wpb - 1) / wpb;
}

template <int DT, typename E>
static int launch_tc(const void* qkv, const void* bias, const void* mask,
                     const void* g, void* dqkv, void* dbias, int B, int H,
                     int W, int C, int heads, int ws, int shift, float scale,
                     cudaStream_t stream) {
  const int nwin = (H / ws) * (W / ws);
  const int groups = wb_groups(B, H, W, heads, ws,
                               tc_is_f16<E>::value ? PT_F16 : PT_BF16);
  const int wpb = (nwin + groups - 1) / groups;
  const size_t smem = (size_t)(8 * WB_T * DT + WB_PS(DT)) * sizeof(E) +
                      (mask ? 4 : 2) * (size_t)ws * ws * ws * ws *
                          sizeof(float);
  auto kern = window_attention_bwd_tc<DT, E>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(heads * groups, B);
  kern<<<grid, TC_THREADS, smem, stream>>>(
      (const E*)qkv, (const float*)bias, (const float*)mask, (const E*)g,
      (E*)dqkv, (float*)dbias, H, W, C, heads, C / heads,
      ws, shift, scale, groups, wpb);
  return (int)cudaGetLastError();
}

// The partials `window_attention_bwd` writes into dbias: [B * groups,
// heads, P, P], groups from this function (1 for f32).
extern "C" int window_attention_bwd_groups(int B, int H, int W, int heads,
                                           int ws, int dtype) {
  return wb_groups(B, H, W, heads, ws, dtype);
}

// bf16 or f16 elements (E) on the tensor-core tile, which takes P <= 64,
// hd <= 64 with hd % 8 == 0, and 16-byte aligned qkv, g and dqkv.
template <typename E>
static int dispatch16(const void* qkv, const void* bias, const void* mask,
                      const void* g, void* dqkv, void* dbias, int B, int H,
                      int W, int C, int heads, int ws, int shift, float scale,
                      cudaStream_t s) {
  const int hd = C / heads;
  if (ws * ws > WB_T || hd > 64 || hd % 8 || !tc_aligned(qkv) ||
      !tc_aligned(g) || !tc_aligned(dqkv))
    return (int)cudaErrorInvalidValue;
  const int dt = hd <= 16 ? 16 : hd <= 32 ? 32 : 64;
#define WB_TC(D) launch_tc<D, E>(qkv, bias, mask, g, dqkv, dbias, B, H, W, \
                                 C, heads, ws, shift, scale, s)
  return dt == 16 ? WB_TC(16) : dt == 32 ? WB_TC(32) : WB_TC(64);
#undef WB_TC
}

// qkv [B, H, W, 3C] contiguous (channels [q | k | v], each [heads, hd]);
// bias [heads, P, P] f32; mask [nW, P, P] f32 or null; g [B, H, W, C]
// in qkv's dtype; dqkv [B, H, W, 3C] in qkv's dtype; dbias [B * groups,
// heads, P, P] f32, the partials (groups: window_attention_bwd_groups).
// H and W are multiples of ws; shift >= 0.  bf16 and f16 run on the
// tensor cores (`dispatch16`); f32 takes P <= 256.
extern "C" int window_attention_bwd(const void* qkv, const void* bias,
                                    const void* mask, const void* g,
                                    void* dqkv, void* dbias, int B, int H,
                                    int W, int C, int heads, int ws,
                                    int shift, float scale, int dtype,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == PT_BF16)
    return dispatch16<bf16>(qkv, bias, mask, g, dqkv, dbias, B, H, W, C,
                            heads, ws, shift, scale, s);
  if (dtype == PT_F16)
    return dispatch16<f16>(qkv, bias, mask, g, dqkv, dbias, B, H, W, C,
                           heads, ws, shift, scale, s);
  if (dtype != PT_F32) return (int)cudaErrorInvalidValue;
  return launch<float>(qkv, bias, mask, g, dqkv, dbias, B, H, W, C, heads,
                       ws, shift, scale, s);
}
