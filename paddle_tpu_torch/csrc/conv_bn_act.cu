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
// memory as f32, and each of 256 threads
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
// The dense kernel above runs on CUDA cores in f32 and serves f32
// inputs only: the port's oracle path.  Depthwise convs run the loop
// above in every dtype.
//
// bf16 dense convs: the same implicit GEMM on the tensor cores
// (`conv_dense_tc`, mma.sync m16n8k16, bf16 operands, f32
// accumulators).  bf16 products are exact in f32, so this is the same
// sum as `_conv_kernel`'s widened f32 dot (:97-106) in another order;
// the epilogue is the one above (`epilogue`), then one rounding to bf16.
// f16 dense convs run the same tile on f16 operands (`conv_dense_tc<f16,
// ...>`: tc_mma<f16>, f16 products are exact in f32 too), rounding the
// epilogue once to f16; f16 depthwise convs take the loop above.
// A block computes a BM x BN tile of (channel, pixel) in K steps of BK
// = 32 or 64: 128 x 128, 128 x 64, 128 x 32 or 64 x 64, chosen by the
// grid (`launch_tc`).  Both operands sit in shared memory as rows of BK k
// values (16-byte chunks, XOR-swizzled as flash_tc.cuh does: 2 bits for
// the 4 chunks of a 32-value row), two stages deep: A = the weight tile
// [BM][BK] (k contiguous), read by ldmatrix; B = the im2col tile stored
// pixel-major [BN][BK], read by plain ldmatrix as the k x n operand.
// Tile choices and register caps were timed against each other with
// tools/vision_ab.py (PERF.md, PR 9).
// What was in the way, and how each is handled:
//  - NCHW gathers are not 16-byte aligned: for one (ci, dy, dx) the
//    pixels of a row are contiguous only along wo, shifted by dx - pad,
//    strided at stride 2, and 196- or 49-pixel maps do not start rows
//    on 16-byte boundaries.  So B is gathered through registers: a
//    thread owns one pixel (its (b, hi0, wi0) computed once) and 16 k
//    values of every K step, loads 2 bytes each (neighbouring lanes
//    own neighbouring pixels, so each load of a warp reads 64 contiguous
//    bytes at stride 1), packs them and stores 16-byte chunks.  The
//    loads of step t + 1 are issued before the products of step t and
//    stored after them (one step ahead: a second register set costs
//    more occupancy than it hides).  The thread steps (ci, dy, dx) and
//    the element offset incrementally (no division inside a step); for
//    3x3 kernels it instead keeps its pixel's 9 bounds tests as bits
//    (repeated every 9 bits, so a run of k values starting at any tap is
//    one shift) and reads each element's offset from a shared table, 5
//    instructions an element instead of ~14.  The K order stays OIHW, so
//    the weight rows stay contiguous.  x is never transposed or padded:
//    the padding is bounds math, as in the f32 kernel.
//  - K tails (the stem's K = 147, MobileNetV2's 27, a 5x5's 100): k >= K
//    is zero in both A and B.  Weight rows are copied by 16-byte
//    cp.async (zero-filled past K or Cout) when K % 8 == 0 and w is
//    16-byte aligned; otherwise (a row not 16-byte aligned) they go
//    through registers like B.
//  - The epilogue's pixel pairs: an accumulator pair is 2 consecutive
//    pixels of one channel.  With an even Hout * Wout the pair lies in
//    one image at an even offset and is stored as one bf16x2; with an
//    odd one (7x7 maps) each pixel is stored alone.
//  - Small grids (layer4: N = 64 * 49, M = 512): a tile is taken only
//    when its grid gives at least 2 blocks per SM (264), down to 128 x
//    32 (392 blocks at layer4), or 64 x 64 when Cout < 128.  No split-K,
//    so no cross-block sum: two runs give the same bits.
//  - Registers: every tensor-core instantiation builds without a spill
//    under its cap (`launch_tc`); chip_smoke.py's [build] gate fails on
//    a spill of any of them.
//  - Blocks are numbered channel tile fastest, so the blocks that share
//    an input tile run together and x is read from memory about once.
#include "flash_tc.cuh"

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

// bf16 or f16 (E) dense conv on the tensor cores (see the note at the
// top).  A
// block of (BM / WM) x (BN / WN) warps computes a BM x BN tile, each
// warp a WM x WN one.  Each K step a thread gathers BSEG k values of
// one pixel column, and stages ACP 16-byte weight copies (or, through
// registers when not A16, ASEG weights of one row), for K steps of BK.
// MINB: the blocks an SM must hold (the register cap).
template <typename E, int BM, int BN, int WM, int WN, int KH_, int KW_,
          int BK, bool A16, int MINB>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32, MINB)
conv_dense_tc(const E* __restrict__ x, const E* __restrict__ w,
              const float* __restrict__ scale,
              const float* __restrict__ shift, E* __restrict__ out,
              int B, int Cin, int H, int W, int Cout, int kh, int kw,
              int SH, int SW, int PH, int PW, int Hout, int Wout, int act) {
  constexpr int WARPS_M = BM / WM, THREADS = WARPS_M * (BN / WN) * 32;
  constexpr int MT = WM / 16, NT = WN / 8;
  constexpr int BSEG = BK * BN / THREADS, ASEG = BK * BM / THREADS;
  constexpr int ACP = BM * (BK / 8) / THREADS;
  static_assert(BSEG % 8 == 0 && ASEG % 8 == 0 && ACP >= 1, "tile split");
  static_assert(BSEG <= 16, "the 3x3 gather's bounds bits fit 16 k");
  static_assert(NT % 2 == 0, "B fragments come in pairs of n-tiles");
  __shared__ __align__(128) E As[2][BM * BK];
  __shared__ __align__(128) E Bs[2][BN * BK];
  const int KH = KH_ > 0 ? KH_ : kh;
  const int KW = KW_ > 0 ? KW_ : kw;
  const int KHW = KH * KW, K = Cin * KHW, HW = H * W;
  const int P = Hout * Wout, N = B * P;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mtiles = (Cout + BM - 1) / BM;
  const int m0 = (blockIdx.x % mtiles) * BM;
  const int n0 = (blockIdx.x / mtiles) * BN;
  const int nkt = (K + BK - 1) / BK;

  // B: this thread's pixel column and k segment of each K step
  const int bn = tid % BN, bq = tid / BN;
  const int n = n0 + bn;
  const bool nvalid = n < N;
  int hi0 = 0, wi0 = 0;
  const unsigned short* xb = reinterpret_cast<const unsigned short*>(x);
  if (nvalid) {
    const int b = n / P, p = n - b * P;
    const int ho = p / Wout, wo = p - ho * Wout;
    hi0 = ho * SH - PH;
    wi0 = wo * SW - PW;
    xb += (long long)b * Cin * HW;
  }
  const int pix = hi0 * W + wi0;
  uint32_t breg[BSEG / 2];
  // 3x3: the offset of element u of a run that starts at tap 0 of a
  // channel, (u / 9) * HW + dy * W + dx for u = 9 (u / 9) + 3 dy + dx,
  // and this pixel's 9 tap bounds tests as bits, repeated every 9 bits
  __shared__ int offt[9 + BSEG];
  uint64_t vrep = 0;
  if constexpr (KH_ == 3 && KW_ == 3) {
    for (int u = tid; u < 9 + BSEG; u += THREADS)
      offt[u] = (u / 9) * HW + (u % 9 / 3) * W + u % 3;
    uint64_t v = 0;
#pragma unroll
    for (int tp = 0; tp < 9; ++tp)
      if (nvalid && (unsigned)(hi0 + tp / 3) < (unsigned)H &&
          (unsigned)(wi0 + tp % 3) < (unsigned)W)
        v |= 1ull << tp;
    vrep = v | v << 9 | v << 18 | v << 27 | v << 36;
    __syncthreads();
  }
  auto gather = [&](int kt) {
    const int kb = kt * BK + bq * BSEG;
    if constexpr (KH_ == 3 && KW_ == 3) {  // bounds from bits, offsets
      const int ci = kb / 9, t0 = kb - ci * 9;  // from the table
      uint32_t m = (uint32_t)(vrep >> t0) & ((1u << BSEG) - 1);
      if (kb + BSEG > K) m &= kb < K ? (1u << (K - kb)) - 1 : 0u;
      const int base = ci * HW + pix;
#pragma unroll
      for (int j = 0; j < BSEG; ++j) {
        const uint32_t v = (m >> j) & 1 ? __ldg(xb + base + offt[t0 + j])
                                        : 0u;
        if (j & 1) breg[j >> 1] |= v << 16;
        else breg[j >> 1] = v;
      }
    } else {               // (ci, dy, dx) stepped along k
      const int ci = kb / KHW, tap = kb - ci * KHW;
      int dy = tap / KW, dx = tap - dy * KW;
      int off = ci * HW + dy * W + dx + pix;
#pragma unroll
      for (int j = 0; j < BSEG; ++j) {
        const int hi = hi0 + dy, wi = wi0 + dx;
        uint32_t v = 0;
        if (nvalid && kb + j < K && (unsigned)hi < (unsigned)H &&
            (unsigned)wi < (unsigned)W)
          v = __ldg(xb + off);
        if (j & 1) breg[j >> 1] |= v << 16;
        else breg[j >> 1] = v;
        ++dx;
        ++off;
        if (dx == KW) {
          dx = 0;
          off += W - KW;
          if (++dy == KH) {
            dy = 0;
            off += HW - KH * W;
          }
        }
      }
    }
  };
  auto store_b = [&](int st) {
#pragma unroll
    for (int c = 0; c < BSEG / 8; ++c)
      *reinterpret_cast<uint4*>(Bs[st] +
                                tc_swz<BK>(bn, bq * (BSEG / 8) + c)) =
          make_uint4(breg[4 * c], breg[4 * c + 1], breg[4 * c + 2],
                     breg[4 * c + 3]);
  };

  // A: 16-byte cp.async copies (A16), else this thread's weight row
  // segment of each K step through registers
  auto load_a_async = [&](int kt, int st) {
#pragma unroll
    for (int u = 0; u < ACP; ++u) {
      const int idx = tid + u * THREADS;
      const int r = idx / (BK / 8), c = idx % (BK / 8);
      const int k = kt * BK + c * 8;
      const bool ok = m0 + r < Cout && k < K;
      tc_cp16(tc_smem(As[st] + tc_swz<BK>(r, c)),
              ok ? w + (long long)(m0 + r) * K + k : w, ok);
    }
  };
  constexpr int APT = BK / ASEG;  // threads per weight row
  const int am = tid / APT, aq = tid % APT;
  const bool mvalid = m0 + am < Cout;
  const unsigned short* wr = reinterpret_cast<const unsigned short*>(w) +
                             (long long)(mvalid ? m0 + am : 0) * K;
  uint32_t areg[ASEG / 2];
  auto load_a_regs = [&](int kt) {
    const int kb = kt * BK + aq * ASEG;
#pragma unroll
    for (int j = 0; j < ASEG; j += 2) {
      const uint32_t lo = mvalid && kb + j < K ? __ldg(wr + kb + j) : 0u;
      const uint32_t hi =
          mvalid && kb + j + 1 < K ? __ldg(wr + kb + j + 1) : 0u;
      areg[j >> 1] = lo | (hi << 16);
    }
  };
  auto store_a = [&](int st) {
#pragma unroll
    for (int c = 0; c < ASEG / 8; ++c)
      *reinterpret_cast<uint4*>(As[st] +
                                tc_swz<BK>(am, aq * (ASEG / 8) + c)) =
          make_uint4(areg[4 * c], areg[4 * c + 1], areg[4 * c + 2],
                     areg[4 * c + 3]);
  };

  // step 0 staged; then each step loads step kt + 1 (weights by
  // cp.async or registers, the B gathers into registers) before the
  // products of step kt and stores the registers after them
  if constexpr (A16) load_a_async(0, 0);
  else load_a_regs(0);
  tc_commit();
  gather(0);
  if constexpr (!A16) store_a(0);
  store_b(0);

  const int wm = (warp % WARPS_M) * WM, wn = (warp / WARPS_M) * WN;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    const int st = kt & 1;
    const bool more = kt + 1 < nkt;
    if (more) {
      if constexpr (A16) load_a_async(kt + 1, st ^ 1);
      else load_a_regs(kt + 1);
      tc_commit();
      gather(kt + 1);
      tc_wait<1>();
    } else {
      tc_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        tc_frag_a<BK>(As[st], wm + 16 * i, kk, lane, af[i]);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bb[4];
        tc_frag_b<BK>(Bs[st] + wn * BK, j, kk, lane, bb);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          tc_mma<E>(acc[i][j], af[i], bb[0], bb[1]);
          tc_mma<E>(acc[i][j + 1], af[i], bb[2], bb[3]);
        }
      }
    }
    if (more) {        // step kt + 1's registers into the other stage
      if constexpr (!A16) store_a(st ^ 1);
      store_b(st ^ 1);
    }
    __syncthreads();
  }

  // epilogue: the f32 kernel's, then NCHW stores (pairs when P is even)
  const int g = lane >> 2, t = lane & 3;
  int col[NT];       // element offset of pixel n (channel 0), -1 past N
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int nn = n0 + wn + 8 * j + 2 * t;
    const int b = nn / P, p = nn - b * P;
    col[j] = nn < N ? b * Cout * P + p : -1;
  }
  const bool pairs = (P & 1) == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int co = m0 + wm + 16 * i + g + 8 * r;
      if (co >= Cout) continue;
      const float sc = scale[co], sh = shift[co];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (col[j] < 0) continue;
        const float y0 = epilogue(acc[i][j][2 * r], sc, sh, act);
        const float y1 = epilogue(acc[i][j][2 * r + 1], sc, sh, act);
        if (pairs) {
          *reinterpret_cast<uint32_t*>(out + col[j] + co * P) =
              tc_pack<E>(y0, y1);
        } else {
          out[col[j] + co * P] = from_f<E>(y0);
          const int nn = n0 + wn + 8 * j + 2 * t + 1;
          if (nn < N) {
            const int b = nn / P, p = nn - b * P;
            out[b * Cout * P + p + co * P] = from_f<E>(y1);
          }
        }
      }
    }
  }
}

// The tile for a dense bf16 conv, by the grid: Cout < 128 takes 64 x 64
// (4 warps of 32 x 32); Cout >= 128 takes the widest of 128 x 128 (8
// warps of 64 x 32), 128 x 64 (4 warps of 64 x 32) and 128 x 32 (4 warps
// of 32 x 32 stacked along the channels) whose grid has at least 2
// blocks per SM (264): 128 x 32 is left for the 7x7 maps of layer4.
// Wider pixel tiles read each weight tile for more pixels.  Weights
// whose rows are not 16-byte aligned (K % 8 != 0: stems, odd test
// shapes) go through registers on the 64 x 64 tile.  K steps of 32, 64
// on 128 x 32.  The register caps keep enough blocks on an SM to hide
// the gathers' latency: 64 x 64 holds 4 (<= 128 registers), 128 x 64
// and 128 x 32 hold 3 (<= 170), 128 x 128 holds 2 (<= 128), with no
// spill.
template <int KH_, int KW_, typename E>
static void launch_tc(const E* x, const E* w, const float* sc,
                      const float* sh, E* out, int B, int Cin, int H,
                      int W, int Cout, int kh, int kw, int SH, int SW,
                      int PH, int PW, int Hout, int Wout, int act,
                      cudaStream_t stream) {
  const long long N = (long long)B * Hout * Wout;
  const bool a16 = (Cin * kh * kw) % 8 == 0 && tc_aligned(w);
  auto blocks = [&](int bm, int bn) {
    return (unsigned)(((N + bn - 1) / bn) * ((Cout + bm - 1) / bm));
  };
#define CT_ARGS x, w, sc, sh, out, B, Cin, H, W, Cout, kh, kw, SH, SW, PH, \
                PW, Hout, Wout, act
  if (!a16)
    conv_dense_tc<E, 64, 64, 32, 32, KH_, KW_, 32, false, 4>
        <<<blocks(64, 64), 128, 0, stream>>>(CT_ARGS);
  else if (Cout < 128)
    conv_dense_tc<E, 64, 64, 32, 32, KH_, KW_, 32, true, 4>
        <<<blocks(64, 64), 128, 0, stream>>>(CT_ARGS);
  else if (blocks(128, 128) >= 2 * 132)
    conv_dense_tc<E, 128, 128, 64, 32, KH_, KW_, 32, true, 2>
        <<<blocks(128, 128), 256, 0, stream>>>(CT_ARGS);
  else if (blocks(128, 64) >= 2 * 132)
    conv_dense_tc<E, 128, 64, 64, 32, KH_, KW_, 32, true, 3>
        <<<blocks(128, 64), 128, 0, stream>>>(CT_ARGS);
  else
    conv_dense_tc<E, 128, 32, 32, 32, KH_, KW_, 64, true, 3>
        <<<blocks(128, 32), 128, 0, stream>>>(CT_ARGS);
#undef CT_ARGS
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
  if constexpr (sizeof(T) == 2) {      // bf16 or f16: the tensor cores
    launch_tc<KH_, KW_>(x, w, sc, sh, out, B, Cin, H, W, Cout, kh, kw, SH,
                        SW, PH, PW, Hout, Wout, act, stream);
  } else {                             // f32: the CUDA-core oracle
    const int N = B * Hout * Wout;
    const dim3 grid((N + CB_BN - 1) / CB_BN, (Cout + CB_BM - 1) / CB_BM);
    conv_dense_kernel<T, KH_, KW_><<<grid, CB_THREADS, 0, stream>>>(
        x, w, sc, sh, out, B, Cin, H, W, Cout, kh, kw, SH, SW, PH, PW, Hout,
        Wout, act);
  }
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
// in that dtype (f32, bf16 or f16); scale / shift [Cout] f32.  act: 0
// none, 1 relu, 2 relu6.  Symmetric padding (PH, PW).
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
  if (dtype == PT_F16)
    return launch<__half>(x, w, scale, shift, out, B, Cin, H, W, Cout, kh,
                          kw, SH, SW, PH, PW, Hout, Wout, act, depthwise, s);
  if (dtype != PT_F32) return (int)cudaErrorInvalidValue;
  return launch<float>(x, w, scale, shift, out, B, Cin, H, W, Cout, kh, kw,
                       SH, SW, PH, PW, Hout, Wout, act, depthwise, s);
}
