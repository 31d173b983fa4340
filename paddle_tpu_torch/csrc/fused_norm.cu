// Fused (bias + residual +) RMS / LayerNorm forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/fused_norm.py `_norm_kernel` (:58),
// launched by `_pallas_norm_fwd` (:93) under `fused_norm_pallas` (:223),
// which `incubate.nn.functional.fused_rms_norm` / `fused_layer_norm`
// call in every layer of the incubate fused transformer blocks.
//
// What it computes, in the JAX kernel's order: z = x (+ bias) (+
// residual) in x's dtype (bias first, each add rounded to x's dtype), the
// statistics of z in f32 (RMS: mean of squares; LayerNorm: the mean, then
// the mean of squares of z - mean, not E[z^2] - mean^2), y = norm(z) * w
// + b in f32 with one rounding to x's dtype at the end.  z is written too
// when bias or residual is given (the residual stream of the next layer).
//
// Bound on this card: device-memory bytes.  Each element is read once
// from x (and residual) and written once to y (and z); a few flops per
// element, far below the ~295 flops per byte where the H100 stops being
// bandwidth bound.
//
// Two kernels, chosen by the launcher from d and the pointers:
//
// `fused_norm_rows` (the vector path), for rows of 16-byte multiples
// (d * sizeof(T) % 16 == 0) at 16-byte-aligned pointers and up to
// FV_WARPS_MAX * 32 * FV_NV 16-byte vectors a row (bf16 d <= 8192, f32
// d <= 4096).  A row is held in registers: a group of `wpr` warps takes
// it, each thread up to FV_NV vectors (vector v = lane-in-row
// + j * 32 wpr, so consecutive threads read consecutive 16 bytes), read
// once with 16-byte loads, z and y written once with 16-byte stores; z
// stays in registers in x's dtype (the rounded sum is what the
// statistics and the output read), so there is no shared-memory copy of
// the row.  Sums are warp shuffles, plus one shared exchange per
// reduction when a row spans warps (wpr > 1).  wpr is the least power of
// two that keeps a thread at FV_NV vectors or fewer (768 bf16: one
// warp a row, 3 vectors a lane; 1000: one warp, 4; 2048: 2 warps; 8192:
// 8).  Blocks of FV_BLOCK = 128 threads take 4 / wpr rows at a time (8
// warps a row: one row of 256 threads); the grid is what the card holds
// at once, and each block walks its rows.  w, b and bias are read once a
// block into shared memory: held in registers across rows they took a
// thread to 171 registers at 4 vectors, 8 warps an SM, too few to keep
// the loads in flight.
//
// `fused_norm_kernel` (the scalar path), for every other shape: any d >=
// 1 up to what shared memory holds (the TPU kernel's d % 128 gate is a
// VMEM layout rule), e.g. d = 20000 past the register cap, d = 3 in bf16
// (6-byte rows), or a slice of a tensor that starts off 16-byte
// alignment.  One block of FN_THREADS threads per row, 2-byte or 4-byte
// accesses; the first pass keeps the rounded z as f32 in dynamic shared
// memory ([d] floats per block) for the centred moment and the output.
//
// Both: any row count; x is f32, bf16 or f16 (f16 moves as bf16 does:
// 8 values a 16-byte vector, f32 sums, one rounding of each add and of
// y to f16); w and b are f32 or x's dtype.  Multiplies and adds
// are __fmul_rn / __fadd_rn in the plain version's order, so no FMA
// contraction parts the kernels from it; only the order of the row sums
// differs.
#include "common.cuh"

#define FN_THREADS 256
#define FN_WARPS (FN_THREADS / 32)

// Sum over the block; every thread gets the result.  `red` holds
// FN_WARPS floats; the call ends with the block synchronised.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // `red` may still be read from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < FN_WARPS; ++w) s += red[w];
  return s;
}

template <typename T, typename W, bool RMS>
__global__ void __launch_bounds__(FN_THREADS) fused_norm_kernel(
    const T* __restrict__ x, const W* __restrict__ w, const W* __restrict__ b,
    const T* __restrict__ bias, const T* __restrict__ res, T* __restrict__ y,
    T* __restrict__ z, int d, float eps) {
  extern __shared__ float zs[];  // [d] f32 (the rounded z)
  __shared__ float red[FN_WARPS];
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  const T* rr = res ? res + row * d : nullptr;
  T* zr = z ? z + row * d : nullptr;
  T* yr = y + row * d;

  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += FN_THREADS) {
    T zi = xr[i];
    if (bias) zi = from_f<T>(__fadd_rn(to_f(zi), to_f(bias[i])));
    if (rr) zi = from_f<T>(__fadd_rn(to_f(zi), to_f(rr[i])));
    if (zr) zr[i] = zi;
    const float zf = to_f(zi);
    zs[i] = zf;
    s += RMS ? __fmul_rn(zf, zf) : zf;
  }
  const float inv_d = 1.f / (float)d;
  const float m1 = block_sum(s, red) * inv_d;
  float mu = 0.f, var = m1;
  if (!RMS) {
    mu = m1;
    float c = 0.f;
    for (int i = threadIdx.x; i < d; i += FN_THREADS) {
      const float t = __fadd_rn(zs[i], -mu);
      c += __fmul_rn(t, t);
    }
    var = block_sum(c, red) * inv_d;
  }
  const float inv = rsqrtf(var + eps);
  for (int i = threadIdx.x; i < d; i += FN_THREADS) {
    float t = __fmul_rn(RMS ? zs[i] : __fadd_rn(zs[i], -mu), inv);
    if (w) t = __fmul_rn(t, to_f(w[i]));
    if (b) t = __fadd_rn(t, to_f(b[i]));
    yr[i] = from_f<T>(t);
  }
}

template <typename T, typename W, bool RMS>
static int launch(const void* x, const void* w, const void* b,
                  const void* bias, const void* res, void* y, void* z,
                  long long rows, int d, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)d;
  auto kern = fused_norm_kernel<T, W, RMS>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  kern<<<(unsigned)rows, FN_THREADS, smem, stream>>>(
      (const T*)x, (const W*)w, (const W*)b, (const T*)bias, (const T*)res,
      (T*)y, (T*)z, d, eps);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ vector path
#define FV_NV 4           // 16-byte vectors of a row a thread holds, at most
#define FV_BLOCK 128      // threads of a block that takes several rows
#define FV_WARPS_MAX 8    // warps a row at most: one row of 256 threads

// A vector is held as 32-bit words: 4 for 16 bytes of x's dtype, and
// 2, 4 or 8 for the w / b values beside them (8, 16 or 32 bytes, the 32
// as two 16-byte loads).  Value i of a word array of E (f32: one a word;
// bf16 or f16: two, value 2k in the low half of word k):
template <typename E>
__device__ __forceinline__ float fv_get(const uint32_t* u, int i);
template <>
__device__ __forceinline__ float fv_get<float>(const uint32_t* u, int i) {
  return __uint_as_float(u[i]);
}
template <>
__device__ __forceinline__ float fv_get<__nv_bfloat16>(const uint32_t* u,
                                                       int i) {
  const uint32_t w = u[i >> 1];
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}
template <>
__device__ __forceinline__ float fv_get<__half>(const uint32_t* u, int i) {
  const uint32_t w = u[i >> 1];
  return __half2float(__ushort_as_half(
      (unsigned short)((i & 1) ? (w >> 16) : (w & 0xffffu))));
}
// ... and set to f rounded to E (as from_f<E>)
template <typename E>
__device__ __forceinline__ void fv_set(uint32_t* u, int i, float f);
template <>
__device__ __forceinline__ void fv_set<float>(uint32_t* u, int i, float f) {
  u[i] = __float_as_uint(f);
}
template <>
__device__ __forceinline__ void fv_set<__nv_bfloat16>(uint32_t* u, int i,
                                                      float f) {
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16(f));
  uint32_t& w = u[i >> 1];
  w = (i & 1) ? ((w & 0xffffu) | (h << 16)) : ((w & 0xffff0000u) | h);
}
template <>
__device__ __forceinline__ void fv_set<__half>(uint32_t* u, int i, float f) {
  const uint32_t h = __half_as_ushort(__float2half(f));
  uint32_t& w = u[i >> 1];
  w = (i & 1) ? ((w & 0xffffu) | (h << 16)) : ((w & 0xffff0000u) | h);
}

template <int WORDS>
__device__ __forceinline__ void fv_load(uint32_t (&u)[WORDS],
                                        const void* src) {
  if constexpr (WORDS == 2) {
    const uint2 q = *reinterpret_cast<const uint2*>(src);
    u[0] = q.x;
    u[1] = q.y;
  } else {
#pragma unroll
    for (int k = 0; k < WORDS / 4; ++k) {
      const uint4 q = reinterpret_cast<const uint4*>(src)[k];
      u[4 * k] = q.x;
      u[4 * k + 1] = q.y;
      u[4 * k + 2] = q.z;
      u[4 * k + 3] = q.w;
    }
  }
}
__device__ __forceinline__ void fv_store(void* dst, const uint32_t (&u)[4]) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
}

// Byte offsets of the row-invariant operands staged in shared memory:
// w and b ([d] of W) and bias ([d] of T), each section 16-byte aligned,
// absent operands taking no room.
struct fv_smem {
  int w, b, bias, bytes;
};
template <typename T, typename W>
static fv_smem fv_layout(int d, bool w, bool b, bool bias) {
  const int ws = (d * (int)sizeof(W) + 15) & ~15;
  const int ts = (d * (int)sizeof(T) + 15) & ~15;
  fv_smem m;
  m.w = 0;
  m.b = m.w + (w ? ws : 0);
  m.bias = m.b + (b ? ws : 0);
  m.bytes = m.bias + (bias ? ts : 0);
  return m;
}

template <typename T, typename W, bool RMS, int NV>
__global__ void __launch_bounds__(FV_WARPS_MAX * 32) fused_norm_rows(const T* __restrict__ x, const W* __restrict__ w,
                const W* __restrict__ b, const T* __restrict__ bias,
                const T* __restrict__ res, T* __restrict__ y,
                T* __restrict__ z, long long rows, int d, int wpr,
                fv_smem lay, float eps) {
  constexpr int EPV = 16 / sizeof(T);          // values of a 16-byte vector
  constexpr int WW = EPV * sizeof(W) / 4;      // words of their w / b values
  extern __shared__ __align__(16) unsigned char fv_sm[];
  // a warp's partial sum per row, two sets used in turn: a set is
  // written again only after the next reduction's barrier, which every
  // thread passes after reading it
  __shared__ float red[2][FV_WARPS_MAX];
  const int tpr = 32 * wpr;                     // threads a row
  const int rpb = blockDim.x / tpr;             // rows a block at a time
  const int slot = threadIdx.x / tpr, li = threadIdx.x - slot * tpr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = d / EPV;
  const W* ws = reinterpret_cast<const W*>(fv_sm + lay.w);
  const W* bs = reinterpret_cast<const W*>(fv_sm + lay.b);
  const T* bis = reinterpret_cast<const T*>(fv_sm + lay.bias);

  // w, b and bias, read once a block into shared memory (8-byte units:
  // every section is a multiple of 8 bytes)
  {
    auto stage = [&](void* dst, const void* src, int bytes) {
      for (int i = threadIdx.x; i < bytes / 8; i += blockDim.x)
        reinterpret_cast<uint2*>(dst)[i] =
            reinterpret_cast<const uint2*>(src)[i];
    };
    if (w) stage(fv_sm + lay.w, w, d * (int)sizeof(W));
    if (b) stage(fv_sm + lay.b, b, d * (int)sizeof(W));
    if (bias) stage(fv_sm + lay.bias, bias, d * (int)sizeof(T));
    __syncthreads();
  }
  const float inv_d = 1.f / (float)d;
  int turn = 0;
  // the row's sum of v over its threads (every thread of the row gets it)
  auto row_sum = [&](float v) -> float {
    v = warp_sum(v);
    if (wpr == 1) return v;                     // the same in the block
    float* r = red[turn & 1];
    ++turn;
    if (lane == 0) r[warp] = v;
    __syncthreads();
    float s = 0.f;
    for (int i = 0; i < wpr; ++i) s += r[slot * wpr + i];
    return s;
  };

  for (long long r0 = (long long)blockIdx.x * rpb; r0 < rows;
       r0 += (long long)gridDim.x * rpb) {
    const long long row = r0 + slot;
    const bool live = row < rows;               // the last rows of a block
    const long long base = row * d;
    // this thread's vectors: v = li + j * tpr
    uint32_t zr[NV][4];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = li + j * tpr;
      if (live && v < nvec) fv_load(zr[j], x + base + v * EPV);
    }
    float s = 0.f;
    if (res || bias) {
      uint32_t rr[NV][4];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int v = li + j * tpr;
        if (res && live && v < nvec) fv_load(rr[j], res + base + v * EPV);
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int v = li + j * tpr;
        if (!(live && v < nvec)) continue;
        uint32_t bw[4];
        if (bias) fv_load(bw, bis + v * EPV);
#pragma unroll
        for (int i = 0; i < EPV; ++i) {
          float zf = fv_get<T>(zr[j], i);
          if (bias) zf = to_f(from_f<T>(__fadd_rn(zf, fv_get<T>(bw, i))));
          if (res) zf = to_f(from_f<T>(__fadd_rn(zf, fv_get<T>(rr[j], i))));
          fv_set<T>(zr[j], i, zf);              // exact: zf is a T value
        }
      }
    }
    if (z)
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int v = li + j * tpr;
        if (live && v < nvec) fv_store(z + base + v * EPV, zr[j]);
      }
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (live && li + j * tpr < nvec)
#pragma unroll
        for (int i = 0; i < EPV; ++i) {
          const float zf = fv_get<T>(zr[j], i);
          s += RMS ? __fmul_rn(zf, zf) : zf;
        }
    const float m1 = row_sum(s) * inv_d;
    float mu = 0.f, var = m1;
    if (!RMS) {
      mu = m1;
      float c = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j)
        if (live && li + j * tpr < nvec)
#pragma unroll
          for (int i = 0; i < EPV; ++i) {
            const float t = __fadd_rn(fv_get<T>(zr[j], i), -mu);
            c += __fmul_rn(t, t);
          }
      var = row_sum(c) * inv_d;
    }
    const float inv = rsqrtf(var + eps);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = li + j * tpr;
      if (!(live && v < nvec)) continue;
      uint32_t wv[WW], bv[WW], o[4];
      if (w) fv_load(wv, ws + v * EPV);
      if (b) fv_load(bv, bs + v * EPV);
#pragma unroll
      for (int i = 0; i < EPV; ++i) {
        const float zf = fv_get<T>(zr[j], i);
        float t = __fmul_rn(RMS ? zf : __fadd_rn(zf, -mu), inv);
        if (w) t = __fmul_rn(t, fv_get<W>(wv, i));
        if (b) t = __fadd_rn(t, fv_get<W>(bv, i));
        fv_set<T>(o, i, t);
      }
      fv_store(y + base + v * EPV, o);
    }
  }
}

// Streaming multiprocessors of the current device (read once).
static int fv_sms() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms < 1) sms = 1;
  }
  return sms;
}

template <typename T, typename W, bool RMS, int NV>
static int launch_rows(const void* x, const void* w, const void* b,
                       const void* bias, const void* res, void* y, void* z,
                       long long rows, int d, int wpr, float eps,
                       cudaStream_t stream) {
  auto kern = fused_norm_rows<T, W, RMS, NV>;
  const int threads = 32 * wpr > FV_BLOCK ? 32 * wpr : FV_BLOCK;
  const int rpb = threads / (32 * wpr);
  const fv_smem lay = fv_layout<T, W>(d, w, b, bias);
  // blocks an SM holds at this block size and shared memory, read again
  // only when they change (a model's norms share one width)
  static int seen_threads = 0, seen_bytes = -1, held = 1, limit = 48 * 1024;
  if (lay.bytes > limit) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
    if (e != cudaSuccess) return (int)e;
    limit = lay.bytes;
  }
  if (threads != seen_threads || lay.bytes != seen_bytes) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&held, kern, threads,
                                                  lay.bytes);
    if (held < 1) held = 1;
    seen_threads = threads;
    seen_bytes = lay.bytes;
  }
  const long long need = (rows + rpb - 1) / rpb;
  const long long most = (long long)fv_sms() * held;
  const unsigned grid = (unsigned)(need < most ? need : most);
  kern<<<grid, threads, lay.bytes, stream>>>(
      (const T*)x, (const W*)w, (const W*)b, (const T*)bias, (const T*)res,
      (T*)y, (T*)z, rows, d, wpr, lay, eps);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
static int dispatch(const void* x, const void* w, const void* b,
                    const void* bias, const void* res, void* y, void* z,
                    long long rows, int d, float eps, int rms,
                    cudaStream_t s) {
  constexpr int EPV = 16 / sizeof(T);
  const bool vec = d % EPV == 0 && tc_aligned(x) && tc_aligned(w) &&
                   tc_aligned(b) && tc_aligned(bias) && tc_aligned(res) &&
                   tc_aligned(y) && tc_aligned(z);
  if (vec) {
    const int nvec = d / EPV;
    int wpr = 1;
    while (wpr < FV_WARPS_MAX && nvec > 32 * wpr * FV_NV) wpr *= 2;
    const int nv = (nvec + 32 * wpr - 1) / (32 * wpr);
    if (nv <= FV_NV) {
#define FV_GO(R, N)                                                          \
  return launch_rows<T, W, R, N>(x, w, b, bias, res, y, z, rows, d, wpr, eps, \
                                 s)
#define FV_SWITCH(R)                 \
  switch (nv) {                      \
    case 1: FV_GO(R, 1);             \
    case 2: FV_GO(R, 2);             \
    case 3: FV_GO(R, 3);             \
    default: FV_GO(R, FV_NV);        \
  }
      if (rms) FV_SWITCH(true) else FV_SWITCH(false)
#undef FV_SWITCH
#undef FV_GO
    }
  }
  if (rms)
    return launch<T, W, true>(x, w, b, bias, res, y, z, rows, d, eps, s);
  return launch<T, W, false>(x, w, b, bias, res, y, z, rows, d, eps, s);
}

// x / residual / y / z [rows, d] in `dtype`; bias [d] in `dtype`; w / b
// [d] in `wdtype`; w, b, bias, residual and z may be null (z is written
// when given).  rms = 1: RMSNorm, 0: LayerNorm.
extern "C" int fused_norm(const void* x, const void* w, const void* b,
                          const void* bias, const void* res, void* y, void* z,
                          long long rows, int d, float eps, int rms,
                          int dtype, int wdtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == PT_F16) {
    if (wdtype == PT_F16)
      return dispatch<__half, __half>(x, w, b, bias, res, y, z, rows, d, eps,
                                      rms, s);
    if (wdtype != PT_F32) return (int)cudaErrorInvalidValue;
    return dispatch<__half, float>(x, w, b, bias, res, y, z, rows, d, eps,
                                   rms, s);
  }
  if (dtype == PT_BF16) {
    if (wdtype == PT_BF16)
      return dispatch<__nv_bfloat16, __nv_bfloat16>(x, w, b, bias, res, y, z,
                                                    rows, d, eps, rms, s);
    return dispatch<__nv_bfloat16, float>(x, w, b, bias, res, y, z, rows, d,
                                          eps, rms, s);
  }
  if (wdtype == PT_BF16)
    return dispatch<float, __nv_bfloat16>(x, w, b, bias, res, y, z, rows, d,
                                          eps, rms, s);
  return dispatch<float, float>(x, w, b, bias, res, y, z, rows, d, eps, rms,
                                s);
}
