// Fused Swin window attention, forward, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/window_attention.py `_fwd_kernel`
// (:173), launched by `_fwd_pallas` (:260, pallas_call :277) — the
// attention of every Swin block (vision/models/swin.py:123-135): cyclic
// shift, window partition, per-head attention with the dense relative
// position bias and the shift mask, softmax, window reverse.
//
// Bound on this card: device-memory bytes at Swin-T's shapes.  Every
// qkv element is read once and every output written once; a window of
// P = ws * ws = 49 tokens and head_dim 32 does 4 * P * P * hd = 307k
// flops per head against 3 * P * hd reads and P * hd writes, about 25
// flops per bf16 byte, under the tensor cores' 295 per byte.
//
// Design (f32, and bf16 shapes beyond the tensor-core tile):
// `window_attention_kernel`, one block per (batch, window, head), 128
// threads.  The shift moves no data: roll -> partition -> attention ->
// reverse -> unroll sends every token back to its own image position,
// and only the grouping into windows is in rolled coordinates.  So the
// token at rolled position (R, C) of window (wi, wj) is read from image
// position ((R + shift) mod H, (C + shift) mod W), and its output is
// written to the same position; the mask index is wi * nWc + wj (rolled
// window order, the JAX `_fwd_kernel`'s).  q, k and v are channel slices
// of one qkv row laid out [3, heads, hd]: the block stages its head's q
// (times hd**-0.5, before the product, as `_heads_attention` :88-93), k
// and v in shared memory as f32 ([P][hd + 1], padded against bank
// conflicts), forms the P x P f32 scores with bias[h] and, when there is
// a mask, mask[window] added, takes a max-subtracted softmax with one
// warp per row (lanes past P stay out of the max and the sum), and
// writes P.V at the tokens' image positions in qkv's dtype.  f32 CUDA
// cores; up to 256 keys per row (8 per lane), any head_dim whose tiles
// fit in shared memory.  It serves f32 (the port's oracle path) and the
// bf16 windows the tile below cannot take (P > 64, hd > 64 or hd % 8 !=
// 0, or a qkv that starts off 16-byte alignment).
//
// bf16: `window_attention_tc`, one window per tensor-core tile, the
// forward half of csrc/window_attention_bwd.cu's `window_attention_bwd_tc`
// (the same tile, swizzle and copies, flash_tc.cuh).  P (<= 64) is padded
// to 64 rows and columns, so a window is one 64 x 64 score tile and each
// of 4 warps owns 16 query rows.  A block takes a group of a (batch,
// head)'s windows (`wf_groups`: about WF_BLOCKS_PER_SM blocks per SM, at
// least 4 windows a block), with the head's f32 bias staged once in
// shared memory.  Per window:
//   1. q, k and v of the head arrive as swizzled [64][DT] bf16 tiles (DT
//      = hd rounded up to 16, 32 or 64) by 16-byte cp.async, each token's
//      head slice from its image position, and the window's mask by
//      4-byte cp.async, double-buffered: the next window's copies fly
//      while this one is computed;
//   2. S = q k^T by mma.sync m16n8k16 with f32 accumulators; the scale
//      multiplies the f32 S (q * scale is not a bf16 value), then the bias
//      and the mask are added; columns >= P take -inf before the max; the
//      row max and sum are taken over the 4 lanes that hold a row;
//   3. the exponentials, rounded to bf16 in registers (`tc_acc_to_a`),
//      are the A operand of O = P V by mma.sync, v read by
//      ldmatrix.trans; O is divided by the f32 row sum at the end;
//   4. each warp stages its 16 rows of O as bf16 in its own rows of the q
//      tile (no other warp reads them) and writes them as 16-byte chunks
//      to the tokens' image positions; rows >= P are never written.
// Padded rows get zero q, k, v (cp.async zero fill) and pad chunks (hd <
// DT) are zeroed once and never copied, so nothing padded reaches a
// written row.  No atomics: every output element has one writer, and
// reruns are bit-identical.  Precision: P is rounded to bf16 before P V
// (the JAX kernel keeps it f32), as in the flash kernels and the window
// backward: the output moves by up to ~2^-9 of its size before its own
// rounding to bf16.
//
// f16 takes the same two kernels at the same gate: the tile on f16
// operands (`window_attention_tc<DT, f16>`: tc_mma<f16>, P and the
// output rounded to f16 where bf16 rounds to bf16; f16 keeps 11 bits, so
// P's rounding moves the output by up to ~2^-12 of its size), and the
// CUDA-core kernel for the windows the tile cannot take.
#include "flash_tc.cuh"

#define WA_THREADS 128
#define WA_MAX_JT 8      // ceil(P / 32) <= 8: P <= 256
#define WA_NEG_INF (__int_as_float((int)0xff800000u))

template <typename T>
__global__ void __launch_bounds__(WA_THREADS)
window_attention_kernel(const T* __restrict__ qkv,
                        const float* __restrict__ bias,
                        const float* __restrict__ mask, T* __restrict__ out,
                        int H, int W, int C, int heads, int hd, int ws,
                        int shift, float scale) {
  extern __shared__ float sm[];
  const int P = ws * ws;
  const int ld = hd + 1;
  float* q = sm;                 // [P][hd + 1]
  float* k = q + P * ld;
  float* v = k + P * ld;
  float* s = v + P * ld;         // [P][P]
  const int nwc = W / ws;
  const int win = blockIdx.x / heads, h = blockIdx.x - win * heads;
  const int b = blockIdx.y;
  const int wi = win / nwc, wj = win - wi * nwc;
  const long long row3 = 3LL * C;
  const int tid = threadIdx.x;

  for (int idx = tid; idx < P * hd; idx += WA_THREADS) {
    const int t = idx / hd, d = idx - t * hd;
    const int r = t / ws, c = t - r * ws;
    const int y = (wi * ws + r + shift) % H, xx = (wj * ws + c + shift) % W;
    const T* src = qkv + ((long long)b * H * W + (long long)y * W + xx) * row3
                   + h * hd + d;
    q[t * ld + d] = to_f(src[0]) * scale;
    k[t * ld + d] = to_f(src[C]);
    v[t * ld + d] = to_f(src[2 * C]);
  }
  __syncthreads();

  const float* bh = bias + (long long)h * P * P;
  const float* mw = mask ? mask + (long long)win * P * P : nullptr;
  for (int idx = tid; idx < P * P; idx += WA_THREADS) {
    const int i = idx / P, j = idx - i * P;
    const float* qi = q + i * ld;
    const float* kj = k + j * ld;
    float acc = 0.f;
    for (int d = 0; d < hd; ++d) acc = fmaf(qi[d], kj[d], acc);
    acc = acc + bh[idx];
    if (mw) acc = acc + mw[idx];
    s[idx] = acc;
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  for (int i = warp; i < P; i += WA_THREADS / 32) {
    float* si = s + i * P;
    float vals[WA_MAX_JT];
    float m = WA_NEG_INF;
#pragma unroll
    for (int t = 0; t < WA_MAX_JT; ++t) {
      const int j = lane + 32 * t;
      vals[t] = j < P ? si[j] : WA_NEG_INF;
      m = fmaxf(m, vals[t]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < WA_MAX_JT; ++t) {
      const int j = lane + 32 * t;
      vals[t] = j < P ? expf(vals[t] - m) : 0.f;
      sum += vals[t];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int t = 0; t < WA_MAX_JT; ++t) {
      const int j = lane + 32 * t;
      if (j < P) si[j] = vals[t] / sum;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < P * hd; idx += WA_THREADS) {
    const int i = idx / hd, d = idx - i * hd;
    const float* pi = s + i * P;
    float acc = 0.f;
    for (int j = 0; j < P; ++j) acc = fmaf(pi[j], v[j * ld + d], acc);
    const int r = i / ws, c = i - r * ws;
    const int y = (wi * ws + r + shift) % H, xx = (wj * ws + c + shift) % W;
    out[((long long)b * H * W + (long long)y * W + xx) * C + h * hd + d] =
        from_f<T>(acc);
  }
}

template <typename T>
static int launch(const void* qkv, const void* bias, const void* mask,
                  void* out, int B, int H, int W, int C, int heads, int ws,
                  int shift, float scale, cudaStream_t stream) {
  const int hd = C / heads, P = ws * ws;
  const size_t smem = (3 * (size_t)P * (hd + 1) + (size_t)P * P) * sizeof(float);
  auto kern = window_attention_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((H / ws) * (W / ws) * heads, B);
  kern<<<grid, WA_THREADS, smem, stream>>>(
      (const T*)qkv, (const float*)bias, (const float*)mask, (T*)out, H, W,
      C, heads, hd, ws, shift, scale);
  return (int)cudaGetLastError();
}

#define WF_T 64     // the padded window: 64 query rows, 64 key columns
#define WF_BLOCKS_PER_SM 16   // the grid wf_groups aims for, per SM
#define WF_MIN_WINDOWS 4      // windows a block walks, at least

// bf16 window forward on the tensor cores (see the note at the top).
// grid (heads * groups, B); windows [grp * wpb, min(nwin, (grp + 1) *
// wpb)) of batch b for head h.
template <int DT, typename E>
__global__ void __launch_bounds__(TC_THREADS, DT <= 32 ? 4 : 3)
window_attention_tc(const E* __restrict__ qkv,
                    const float* __restrict__ bias,
                    const float* __restrict__ mask, E* __restrict__ out,
                    int H, int W, int C, int heads, int hd, int ws,
                    int shift, float scale, int wpb) {
  constexpr int NC = DT / 8, KS = DT / 16, ND = DT / 8, TILE = WF_T * DT;
  extern __shared__ __align__(128) unsigned char wf_smem[];
  E* in = reinterpret_cast<E*>(wf_smem);  // [2][q, k, v][64][DT]
  float* Bsm = reinterpret_cast<float*>(in + 6 * TILE);  // [P][P] bias
  float* Ms = Bsm + ws * ws * ws * ws;                   // [2][P][P] masks
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int h = blockIdx.x % heads, grp = blockIdx.x / heads;
  const int b = blockIdx.y;
  const int P = ws * ws, nwc = W / ws, nwin = (H / ws) * nwc;
  const int w0 = grp * wpb, nw = min(nwin, w0 + wpb) - w0;
  const long long row3 = 3LL * C, img = (long long)b * H * W;
  const int hc = hd >> 3;  // 16-byte chunks of a head slice

  // the pad chunks (hd < DT) of the input tiles stay zero: never copied
  for (int i = tid; i < 6 * WF_T; i += TC_THREADS)
    for (int c = hc; c < NC; ++c)
      *reinterpret_cast<uint4*>(in + tc_swz<DT>(i, c)) =
          make_uint4(0, 0, 0, 0);
  const float* bh = bias + (long long)h * P * P;
  for (int i = tid; i < P * P; i += TC_THREADS) Bsm[i] = bh[i];

  // image position of token r of window `win`
  auto pixel = [&](int win, int r) -> long long {
    const int wi = win / nwc, wj = win - wi * nwc;
    const int rr = r / ws, cc = r - rr * ws;
    const int y = (wi * ws + rr + shift) % H, x = (wj * ws + cc + shift) % W;
    return img + (long long)y * W + x;
  };
  auto load_win = [&](int win, int st) {
    E* base = in + st * 3 * TILE;
    const int c = tid % NC;
    if (c >= hc) return;
    for (int r = tid / NC; r < WF_T; r += TC_THREADS / NC) {
      const bool ok = r < P;
      const long long pix = ok ? pixel(win, r) : 0;
      const E* src = qkv + pix * row3 + h * hd + c * 8;
      const int at = tc_swz<DT>(r, c);
      tc_cp16(tc_smem(base + at), ok ? src : qkv, ok);
      tc_cp16(tc_smem(base + TILE + at), ok ? src + C : qkv, ok);
      tc_cp16(tc_smem(base + 2 * TILE + at), ok ? src + 2 * C : qkv, ok);
    }
  };
  // the window's mask [P][P] by 4-byte copies (its rows are not 16-byte
  // aligned)
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
    E* Qs = in + st * 3 * TILE;
    const E* Ks = Qs + TILE;
    const E* Vs = Ks + TILE;

    // 2. S = q k^T for the warp's 16 rows
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t aq[4];
      tc_frag_a<DT>(Qs, 16 * warp, kk, lane, aq);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t bb[4];
        tc_frag_b<DT>(Ks, j, kk, lane, bb);
        tc_mma<E>(s[j], aq, bb[0], bb[1]);
        tc_mma<E>(s[j + 1], aq, bb[2], bb[3]);
      }
    }

    // the exponentials in registers, and each row's 1 / sum
    const float* mw = mask ? Ms + st * P * P : nullptr;
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = 16 * warp + gq + 8 * r;
      const bool row = i < P;
      float m = WA_NEG_INF;
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
          if (c >= P) x = WA_NEG_INF;
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
      inv[r] = 1.f / sum;       // >= 1 term of exp(0): finite
    }

    // 3. O = P V, P rounded to bf16 as the A fragments, v by
    // ldmatrix.trans
    float o[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < WF_T / 16; ++kk) {
      uint32_t a[4];
      tc_acc_to_a<E>(s[2 * kk], s[2 * kk + 1], a);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t bb[4];
        tc_frag_bt<DT>(Vs, n, kk, lane, bb);
        tc_mma<E>(o[n], a, bb[0], bb[1]);
        tc_mma<E>(o[n + 1], a, bb[2], bb[3]);
      }
    }

    // 4. O / sum as bf16 into the warp's own q rows, then its rows out
    tc_acc_to_tile<DT, ND>(Qs, 16 * warp, 0, hc, o, inv, lane);
    __syncwarp();
    for (int idx = lane; idx < 16 * NC; idx += 32) {
      const int r = 16 * warp + idx / NC, c = idx % NC;
      if (r >= P || c >= hc) continue;
      *reinterpret_cast<uint4*>(out + pixel(win, r) * C + h * hd + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + tc_swz<DT>(r, c));
    }
    __syncthreads();   // every warp is done with this stage's tiles
  }
}

// Window groups per (batch, head) of the bf16 kernel: about
// WF_BLOCKS_PER_SM blocks per SM (132 SMs), at least WF_MIN_WINDOWS
// windows a block.
static int wf_groups(int B, int H, int W, int heads, int ws) {
  const int nwin = (H / ws) * (W / ws);
  if (nwin <= WF_MIN_WINDOWS) return 1;
  const long long pairs = (long long)B * heads;
  const long long want = (WF_BLOCKS_PER_SM * 132 + pairs - 1) / pairs;
  const int groups = (int)(want < nwin ? want : nwin);
  int wpb = (nwin + groups - 1) / groups;
  if (wpb < WF_MIN_WINDOWS) wpb = WF_MIN_WINDOWS;
  return (nwin + wpb - 1) / wpb;
}

template <int DT, typename E>
static int launch_tc(const void* qkv, const void* bias, const void* mask,
                     void* out, int B, int H, int W, int C, int heads,
                     int ws, int shift, float scale, cudaStream_t stream) {
  const int nwin = (H / ws) * (W / ws);
  const int groups = wf_groups(B, H, W, heads, ws);
  const int wpb = (nwin + groups - 1) / groups;
  const size_t smem = (size_t)6 * WF_T * DT * sizeof(E) +
                      (mask ? 3 : 1) * (size_t)ws * ws * ws * ws *
                          sizeof(float);
  auto kern = window_attention_tc<DT, E>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(heads * groups, B);
  kern<<<grid, TC_THREADS, smem, stream>>>(
      (const E*)qkv, (const float*)bias, (const float*)mask, (E*)out, H, W,
      C, heads, C / heads, ws, shift, scale, wpb);
  return (int)cudaGetLastError();
}

// bf16 or f16 elements (E): windows of P <= 64 tokens at hd <= 64, hd % 8
// == 0, with 16-byte-aligned qkv and out, on the tensor-core tile; other
// shapes on the CUDA-core kernel.
template <typename E>
static int dispatch16(const void* qkv, const void* bias, const void* mask,
                      void* out, int B, int H, int W, int C, int heads,
                      int ws, int shift, float scale, cudaStream_t s) {
  const int hd = C / heads;
  if (ws * ws <= WF_T && hd <= 64 && hd % 8 == 0 && tc_aligned(qkv) &&
      tc_aligned(out)) {
    const int dt = hd <= 16 ? 16 : hd <= 32 ? 32 : 64;
#define WF_TC(D) launch_tc<D, E>(qkv, bias, mask, out, B, H, W, C, heads, \
                                 ws, shift, scale, s)
    return dt == 16 ? WF_TC(16) : dt == 32 ? WF_TC(32) : WF_TC(64);
#undef WF_TC
  }
  return launch<E>(qkv, bias, mask, out, B, H, W, C, heads, ws, shift, scale,
                   s);
}

// qkv [B, H, W, 3C] contiguous (channels [q | k | v], each [heads, hd]);
// bias [heads, P, P] f32; mask [nW, P, P] f32 or null; out [B, H, W, C]
// in qkv's dtype.  H and W are multiples of ws; shift >= 0.  bf16 and
// f16 take `dispatch16`; f32 the CUDA-core kernel (P <= 256).
extern "C" int window_attention(const void* qkv, const void* bias,
                                const void* mask, void* out, int B, int H,
                                int W, int C, int heads, int ws, int shift,
                                float scale, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == PT_BF16)
    return dispatch16<bf16>(qkv, bias, mask, out, B, H, W, C, heads, ws,
                            shift, scale, s);
  if (dtype == PT_F16)
    return dispatch16<f16>(qkv, bias, mask, out, B, H, W, C, heads, ws,
                           shift, scale, s);
  if (dtype != PT_F32) return (int)cudaErrorInvalidValue;
  return launch<float>(qkv, bias, mask, out, B, H, W, C, heads, ws, shift,
                       scale, s);
}
