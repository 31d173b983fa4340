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
// All math in f32 on CUDA cores.  Shared memory is 4 P (hd + 1) + 3 P^2
// floats (55 KB at P = 49, hd = 32), over the 48 KB static limit, so
// the launcher raises the block's dynamic limit.
#include "common.cuh"

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

// qkv [B, H, W, 3C] contiguous (channels [q | k | v], each [heads, hd]);
// bias [heads, P, P] f32; mask [nW, P, P] f32 or null; g [B, H, W, C]
// in qkv's dtype; dqkv [B, H, W, 3C] in qkv's dtype; dbias [B, heads,
// P, P] f32, the per-batch partials.  H and W are multiples of ws;
// shift >= 0.
extern "C" int window_attention_bwd(const void* qkv, const void* bias,
                                    const void* mask, const void* g,
                                    void* dqkv, void* dbias, int B, int H,
                                    int W, int C, int heads, int ws,
                                    int shift, float scale, int dtype,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == PT_BF16)
    return launch<__nv_bfloat16>(qkv, bias, mask, g, dqkv, dbias, B, H, W,
                                 C, heads, ws, shift, scale, s);
  return launch<float>(qkv, bias, mask, g, dqkv, dbias, B, H, W, C, heads,
                       ws, shift, scale, s);
}
