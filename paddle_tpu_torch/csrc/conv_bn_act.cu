// Fused conv + folded batch-norm affine + activation for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/conv_norm.py `_conv_kernel` (:82),
// launched by `_conv_pallas` (:255, pallas_call :265) — every eval-mode
// `conv_bn_act` of ResNet and MobileNetV2 (vision/models/_fused.py:59).
//
// Bound on this card: operations for the dense convs at the served
// batch (2 * B * Cout * Hout * Wout * Cin * kh * kw flops against x, w
// and the output read or written once: 50-700 flops per byte on
// ResNet-50's layers), device-memory bytes for the depthwise convs
// (18 flops per output of a 3x3).
//
// Design.  Dense weights (w [Cout, Cin, kh, kw]): an implicit-GEMM
// direct conv, M = Cout, N = B * Hout * Wout (the batch folded into the
// pixels, so layer4's 7x7 maps fill whole tiles), K = Cin * kh * kw in
// the weight's own OIHW order, so a weight row is contiguous.  A block
// computes a 64 x 64 tile of (channel, pixel) in f32; each K step
// stages a 64 x 16 weight tile and a 16 x 64 input tile in shared
// memory as f32 (bf16 is widened on load), and each of 256 threads
// accumulates a 4 x 4 sub-tile with FMAs.  The input tile is gathered
// straight from NCHW: a thread owns one output pixel for the whole
// loop, splits k into (ci, dy, dx) (divisions by the compile-time
// kh * kw and kw for the 1x1, 3x3 and 7x7 instantiations), and reads
// x[b, ci, ho*s - p + dy, wo*s - p + dx], zero outside the image: the
// padding is bounds math, with no padded copy of x (the JAX caller's
// `jnp.pad`, :262).  Neighbouring threads own neighbouring pixels, so
// the gathers of a stride-1 conv are coalesced; for a 1x1 stride-1
// conv the gather is a plain [Cin, pixels] GEMM operand.  The
// epilogue applies acc * scale[c] + shift[c] (rounded one by one, the
// plain version's order), then relu / relu6 / none, casts to x's dtype
// and writes NCHW.  Depthwise weights (w [C, 1, kh, kw]): one thread
// per output element sums its kh * kw taps in f32; no GEMM.
// CUDA cores in f32 for both dtypes: a first kernel that is right.
// Tensor-core tiles (mma.sync / wgmma on bf16 operands) are the next
// step for speed.
#include "common.cuh"

#define CB_BM 64
#define CB_BN 64
#define CB_BK 16
#define CB_THREADS 256

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_RELU6 = 2 };

__device__ __forceinline__ float epilogue(float acc, float sc, float sh,
                                          int act) {
  float y = __fadd_rn(__fmul_rn(acc, sc), sh);
  if (act == ACT_RELU) y = fmaxf(y, 0.f);
  else if (act == ACT_RELU6) y = fminf(fmaxf(y, 0.f), 6.f);
  return y;
}

// KH_ / KW_ > 0: compile-time kernel size; 0: read kh / kw at run time.
template <typename T, int KH_, int KW_>
__global__ void __launch_bounds__(CB_THREADS)
conv_dense_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift, T* __restrict__ out,
                  int B, int Cin, int H, int W, int Cout, int kh, int kw,
                  int SH, int SW, int PH, int PW, int Hout, int Wout,
                  int act) {
  const int KH = KH_ > 0 ? KH_ : kh;
  const int KW = KW_ > 0 ? KW_ : kw;
  const int KHW = KH * KW;
  const int K = Cin * KHW;
  const int P = Hout * Wout;
  const int N = B * P;
  __shared__ __align__(16) float As[CB_BK][CB_BM + 4];  // weights, k-major
  __shared__ __align__(16) float Bs[CB_BK][CB_BN + 4];  // input columns
  const int tid = threadIdx.x;
  const int co0 = blockIdx.y * CB_BM;
  const int n0 = blockIdx.x * CB_BN;

  // the input column (output pixel) this thread gathers for every K step
  const int bn = tid % CB_BN;
  const int bk0 = tid / CB_BN;              // rows bk0 + 4 * j, j < 4
  const int n = n0 + bn;
  const bool nvalid = n < N;
  int hi0 = 0, wi0 = 0;
  const T* xb = x;
  if (nvalid) {
    const int b = n / P, p = n - b * P;
    const int ho = p / Wout, wo = p - ho * Wout;
    hi0 = ho * SH - PH;
    wi0 = wo * SW - PW;
    xb = x + (long long)b * Cin * H * W;
  }
  // the weight row and k offsets this thread stages for every K step
  const int am = tid / 4, ak0 = (tid % 4) * 4;
  const bool avalid = co0 + am < Cout;
  const T* wr = w + (long long)(avalid ? co0 + am : 0) * K;

  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += CB_BK) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + ak0 + j;
      As[ak0 + j][am] = (avalid && k < K) ? to_f(wr[k]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = bk0 + 4 * j;
      const int k = k0 + kk;
      float v = 0.f;
      if (nvalid && k < K) {
        const int ci = k / KHW;
        const int tap = k - ci * KHW;
        const int dy = tap / KW, dx = tap - dy * KW;
        const int hi = hi0 + dy, wi = wi0 + dx;
        if (hi >= 0 && hi < H && wi >= 0 && wi < W)
          v = to_f(xb[((long long)ci * H + hi) * W + wi]);
      }
      Bs[kk][bn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < CB_BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = co0 + ty * 4 + i;
    if (co >= Cout) continue;
    const float sc = scale[co], sh = shift[co];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = n0 + tx * 4 + j;
      if (nn >= N) continue;
      const int b = nn / P, p = nn - b * P;
      out[((long long)b * Cout + co) * P + p] =
          from_f<T>(epilogue(acc[i][j], sc, sh, act));
    }
  }
}

template <typename T, int KH_, int KW_>
__global__ void __launch_bounds__(256)
conv_depthwise_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift, T* __restrict__ out,
                      int B, int C, int H, int W, int kh, int kw, int SH,
                      int SW, int PH, int PW, int Hout, int Wout, int act) {
  const int KH = KH_ > 0 ? KH_ : kh;
  const int KW = KW_ > 0 ? KW_ : kw;
  const long long total = (long long)B * C * Hout * Wout;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int wo = (int)(idx % Wout);
    long long t = idx / Wout;
    const int ho = (int)(t % Hout);
    t /= Hout;
    const int c = (int)(t % C);                 // t = b * C + c
    const T* xp = x + t * H * W;
    const T* wp = w + (long long)c * KH * KW;
    const int hi0 = ho * SH - PH, wi0 = wo * SW - PW;
    float acc = 0.f;
    for (int dy = 0; dy < KH; ++dy) {
      const int hi = hi0 + dy;
      if (hi < 0 || hi >= H) continue;
      for (int dx = 0; dx < KW; ++dx) {
        const int wi = wi0 + dx;
        if (wi < 0 || wi >= W) continue;
        acc = fmaf(to_f(wp[dy * KW + dx]), to_f(xp[hi * W + wi]), acc);
      }
    }
    out[idx] = from_f<T>(epilogue(acc, scale[c], shift[c], act));
  }
}

template <typename T, int KH_, int KW_>
static void launch_one(const T* x, const T* w, const float* sc,
                       const float* sh, T* out, int B, int Cin, int H, int W,
                       int Cout, int kh, int kw, int SH, int SW, int PH,
                       int PW, int Hout, int Wout, int act, int depthwise,
                       cudaStream_t stream) {
  if (depthwise) {
    const long long total = (long long)B * Cout * Hout * Wout;
    long long blocks = (total + 255) / 256;
    if (blocks > 132 * 64) blocks = 132 * 64;     // grid-stride beyond
    conv_depthwise_kernel<T, KH_, KW_><<<(int)blocks, 256, 0, stream>>>(
        x, w, sc, sh, out, B, Cout, H, W, kh, kw, SH, SW, PH, PW, Hout,
        Wout, act);
    return;
  }
  const int N = B * Hout * Wout;
  const dim3 grid((N + CB_BN - 1) / CB_BN, (Cout + CB_BM - 1) / CB_BM);
  conv_dense_kernel<T, KH_, KW_><<<grid, CB_THREADS, 0, stream>>>(
      x, w, sc, sh, out, B, Cin, H, W, Cout, kh, kw, SH, SW, PH, PW, Hout,
      Wout, act);
}

template <typename T>
static int launch(const void* x, const void* w, const void* sc,
                  const void* sh, void* out, int B, int Cin, int H, int W,
                  int Cout, int kh, int kw, int SH, int SW, int PH, int PW,
                  int Hout, int Wout, int act, int depthwise,
                  cudaStream_t stream) {
  const T* xp = (const T*)x;
  const T* wp = (const T*)w;
  const float* scp = (const float*)sc;
  const float* shp = (const float*)sh;
  T* op = (T*)out;
#define CB_ARGS xp, wp, scp, shp, op, B, Cin, H, W, Cout, kh, kw, SH, SW, \
                PH, PW, Hout, Wout, act, depthwise, stream
  if (kh == 1 && kw == 1) launch_one<T, 1, 1>(CB_ARGS);
  else if (kh == 3 && kw == 3) launch_one<T, 3, 3>(CB_ARGS);
  else if (kh == 7 && kw == 7) launch_one<T, 7, 7>(CB_ARGS);
  else launch_one<T, 0, 0>(CB_ARGS);
#undef CB_ARGS
  return (int)cudaGetLastError();
}

// x [B, Cin, H, W], out [B, Cout, Hout, Wout] contiguous in one dtype;
// w [Cout, Cin, kh, kw] (dense) or [Cout == Cin, 1, kh, kw] (depthwise)
// in that dtype; scale / shift [Cout] f32.  act: 0 none, 1 relu,
// 2 relu6.  Symmetric padding (PH, PW).
extern "C" int conv_bn_act(const void* x, const void* w, const void* scale,
                           const void* shift, void* out, int B, int Cin,
                           int H, int W, int Cout, int kh, int kw, int SH,
                           int SW, int PH, int PW, int Hout, int Wout,
                           int act, int depthwise, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == PT_BF16)
    return launch<__nv_bfloat16>(x, w, scale, shift, out, B, Cin, H, W,
                                 Cout, kh, kw, SH, SW, PH, PW, Hout, Wout,
                                 act, depthwise, s);
  return launch<float>(x, w, scale, shift, out, B, Cin, H, W, Cout, kh, kw,
                       SH, SW, PH, PW, Hout, Wout, act, depthwise, s);
}
