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
// Design: one block per (batch, window, head), 128 threads.  The shift
// moves no data: roll -> partition -> attention -> reverse -> unroll
// sends every token back to its own image position, and only the
// grouping into windows is in rolled coordinates.  So the token at
// rolled position (R, C) of window (wi, wj) is read from image position
// ((R + shift) mod H, (C + shift) mod W), and its output is written to
// the same position; the mask index is wi * nWc + wj (rolled window
// order, the JAX `_fwd_kernel`'s).  q, k and v are channel slices of one
// qkv row laid out [3, heads, hd]: the block stages its head's q (times
// hd**-0.5, before the product, as `_heads_attention` :88-93), k and v
// in shared memory as f32 ([P][hd + 1], padded against bank
// conflicts), forms the P x P f32 scores with bias[h] and, when there
// is a mask, mask[window] added, takes a max-subtracted softmax with
// one warp per row (lanes past P stay out of the max and the sum), and
// writes P.V at the tokens' image positions in qkv's dtype.  f32 CUDA
// cores; up to 256 keys per row (8 per lane), any head_dim whose tiles
// fit in shared memory.
#include "common.cuh"

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

// qkv [B, H, W, 3C] contiguous (channels [q | k | v], each [heads, hd]);
// bias [heads, P, P] f32; mask [nW, P, P] f32 or null; out [B, H, W, C]
// in qkv's dtype.  H and W are multiples of ws; shift >= 0.
extern "C" int window_attention(const void* qkv, const void* bias,
                                const void* mask, void* out, int B, int H,
                                int W, int C, int heads, int ws, int shift,
                                float scale, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == PT_BF16)
    return launch<__nv_bfloat16>(qkv, bias, mask, out, B, H, W, C, heads, ws,
                                 shift, scale, s);
  return launch<float>(qkv, bias, mask, out, B, H, W, C, heads, ws, shift,
                       scale, s);
}
