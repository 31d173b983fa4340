// One-query-token attention over a KV sequence, shared by the paged
// (paged_attention.cu) and dense (decode_attention.cu) decode kernels.
//
// Exact tier (bf16 / f32 K and V), `decode_split`.  Bound by device
// memory: 4 flops per element read.  So the design moves bytes and keeps
// many of them in flight:
//
// * Keys split across a thread-block cluster.  Each (sequence, kv head,
//   chunk of <= DEC_MAXG query heads of the GQA group) is one cluster of
//   DEC_SPLIT CTAs (`cudaLaunchKernelEx` with the cluster attribute).
//   CTA r takes keys [r * share, (r + 1) * share) of the sequence,
//   counted from its first valid key, with share = ceil(n / DEC_SPLIT)
//   rounded up to whole tiles: the boundaries depend on the sequence's
//   own key count n and on compile-time constants only, never on the
//   batch, the cache capacity or the page-table width.  So a sequence's
//   output does not depend on the rest of the batch, and the paged and
//   the dense kernel give the same bits for the same keys.
// * Each CTA streams its keys' K and V rows through a ring of
//   DEC_STAGES shared-memory tiles with 16-byte `cp.async` copies (a
//   pool page is PS rows of one kv head, contiguous; a dense cache's rows
//   are contiguous), DEC_STAGES - 1 tiles in flight while one is used.
//   Per-row copies, not bulk copies: a tile's rows may come from several
//   pages, and a row is a multiple of 16 bytes for every head dim.
// * A lane reads 16 bytes of a staged row: LPR = D * sizeof(T) / 16
//   lanes (rounded up to a power of two, at most 32; a lane takes two
//   chunks at f32 head dims above 128) cover a row, so one warp load
//   brings 32 / LPR keys; the q.k dot reduces over the row's lanes only.
//   q sits pre-scaled in f32 in shared memory.
// * Softmax per tile: a warp scores its keys of the tile, takes one max
//   (all lane groups of a warp share it), rescales its accumulators once
//   and takes one exponential per key (`ex2.approx` on log2-scaled
//   scores, as the flash kernels do).  f32 statistics, the finite -1e30
//   start and mask, the 1e-30 clamp on l (JAX paged_attention.py:131,
//   decode_attention.py:79).
// * Merge inside the launch: the warps' (m, l, acc) merge through shared
//   memory into the CTA's partial; after a cluster barrier, rank 0 reads
//   its peers' partials through distributed shared memory (`mapa`,
//   `ld.shared::cluster`), merges them in rank order and writes out; a
//   second barrier keeps every peer alive until it has been read.  No workspace, no atomics, no second pass:
//   reruns are bit-identical.  An empty split (fewer keys than CTAs)
//   keeps m = -1e30, l = 0 and merges with weight 2^(-1e30 - mx) = 0.
#pragma once

#include "common.cuh"

#define DEC_WARPS 8   // warps of an int8-tier block
#define DEC_MAXG 8    // query heads a block or cluster serves at most

constexpr int DEC_SPLIT = 8;        // CTAs a cluster: the key split
constexpr int DEC_STAGES = 3;       // shared-memory tiles of the ring
constexpr int DEC_THREADS = 128;    // 4 warps a CTA
constexpr int DEC_W = DEC_THREADS / 32;
constexpr int DEC_STAGE_BYTES = 8192;   // K and V rows of one tile

// Tile geometry of the exact tier for element type T and CHP 16-byte
// chunks a row (D * sizeof(T) / 16 rounded up to a power of two).
template <typename T, int CHP>
struct DecTile {
  static constexpr int EPC = 16 / (int)sizeof(T);   // elements a chunk
  static constexpr int LPR = CHP < 32 ? CHP : 32;   // lanes a row
  static constexpr int NCH = CHP / LPR;             // chunks a lane
  static constexpr int RPW = 32 / LPR;              // rows a warp load
  static constexpr int TK0 = DEC_STAGE_BYTES / (2 * 16 * CHP) < 64
                                 ? DEC_STAGE_BYTES / (2 * 16 * CHP) : 64;
  static constexpr int TK = TK0 > DEC_W * RPW ? TK0 : DEC_W * RPW;  // keys
  static constexpr int KPW = TK / DEC_W;            // keys a warp a tile
  static constexpr int U = KPW / RPW;               // keys a lane group
  static constexpr int RPP = DEC_THREADS / CHP;     // rows a copy pass
  static constexpr int NP = TK / RPP;               // copy passes a tile
  static constexpr int ROWB = CHP * 16;             // bytes a staged row
  static constexpr int STAGE = 2 * TK * ROWB;       // K rows, then V rows
};

// Bytes of the ring, which the warps' partials reuse after the last tile.
template <typename T, int CHP>
__host__ __device__ inline int dec_ring_bytes(int G, int D) {
  const int ring = DEC_STAGES * DecTile<T, CHP>::STAGE;
  const int parts = (int)sizeof(float) * DEC_W * G * (D + 2);
  return ring > parts ? ring : parts;
}

// Keys of a CTA's share: ceil(n / DEC_SPLIT) rounded up to whole tiles.
__host__ __device__ inline int dec_share(int n, int tk) {
  return ((n + DEC_SPLIT - 1) / DEC_SPLIT + tk - 1) / tk * tk;
}

// Dynamic shared memory of one CTA: ring, q [G][D], the CTA's partial
// (m [G], l [G], acc [G][D]) and `tbl` staged pages (their offsets).
template <typename T, int CHP>
static inline size_t decode_split_smem(int G, int D, int tbl) {
  return (size_t)dec_ring_bytes<T, CHP>(G, D) +
         sizeof(float) * ((size_t)G * D + (size_t)G * (D + 2)) +
         sizeof(long long) * (size_t)tbl;
}

__device__ __forceinline__ void dec_cp16(uint32_t dst, const void* src,
                                         bool full) {
  // src-size 0 reads nothing and fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0));
}

// 2^x with the SFU's one-instruction approximation (relative error ~2^-22;
// 2^-1e30 = 0).  Scores are kept in log2 units (q pre-scaled by log2 e),
// so exp(s - m) = 2^(s' - m') and the merges need no other change.
#define DEC_LOG2E 1.4426950408889634f

__device__ __forceinline__ float dec_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void dec_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void dec_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The 16 bytes of a staged row at p as f32: 8 bf16 or 4 f32 values.
__device__ __forceinline__ void dec_unpack(const unsigned char* p,
                                           float* f, __nv_bfloat16) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void dec_unpack(const unsigned char* p,
                                           float* f, float) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  f[0] = w.x;
  f[1] = w.y;
  f[2] = w.z;
  f[3] = w.w;
}

// Thread-block cluster primitives (PTX): this CTA's rank, a barrier of
// every thread of the cluster (release / acquire, so shared-memory writes
// before it are visible to every CTA after it), and a load from the
// shared memory of the CTA of rank r (distributed shared memory).
__device__ __forceinline__ int dec_cluster_rank() {
  unsigned int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ void dec_cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float dec_ld_rank(const float* p, int r) {
  uint32_t a;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"((uint32_t)__cvta_generic_to_shared(p)), "r"(r));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(a)
               : "memory");
  return v;
}

// Rows of one (row, kv head) of a dense cache [B, Hkv, S, D]: key i of
// the sequence, counted from its first valid key `start`, is cache row
// start + i.
struct DecDenseRows {
  long long base;   // element offset of the (row, kv head)'s row 0
  int start, D;
  struct Cursor {
    long long off;
  };
  __device__ void stage(int, int, long long*, int) {}
  __device__ Cursor at(int i) const {
    return {base + (long long)(start + i) * D};
  }
  __device__ void step(Cursor& c, int n) const { c.off += (long long)n * D; }
  __device__ long long offset(const Cursor& c) const { return c.off; }
};

// Rows of one (sequence, kv head) of a page pool [num_pages, Hkv, PS, D]:
// key i sits in slot i % PS of page table[i / PS].  `stage` resolves the
// pages of keys [lo, hi) once, into shared memory as the element offsets
// of their kv head's rows; a cursor then walks pages and slots by a
// fixed step with no division and no global load in front of a row's
// copy.
struct DecPagedRows {
  const int* row;         // the sequence's page-table row
  long long page_elems;   // Hkv * PS * D
  long long head_off;     // hk * PS * D
  int PS, D;
  const long long* tbl;   // offsets of pages pg0 ..
  int pg0, sq, sr;        // first staged page; a step in pages and slots
  struct Cursor {
    int pg, slot;
  };
  __device__ void stage(int lo, int hi, long long* sm, int step) {
    pg0 = lo / PS;
    sq = step / PS;
    sr = step % PS;
    const int np = hi > lo ? (hi - 1) / PS - pg0 + 1 : 0;
    for (int i = threadIdx.x; i < np; i += blockDim.x)
      sm[i] = (long long)row[pg0 + i] * page_elems + head_off;
    tbl = sm;
  }
  __device__ Cursor at(int i) const { return {i / PS, i % PS}; }
  __device__ void step(Cursor& c, int) const {
    c.pg += sq;
    c.slot += sr;
    if (c.slot >= PS) {
      c.slot -= PS;
      ++c.pg;
    }
  }
  __device__ long long offset(const Cursor& c) const {
    return tbl[c.pg - pg0] + (long long)c.slot * D;
  }
};

// The CTA's share of keys 0..n-1 of one (sequence, kv head, chunk): q
// [G, D] and out [G, D] at the chunk's rows, K / V rows through `rows`.
// Runs in every CTA of the cluster; rank 0 writes out.
template <typename T, int CHP, int GM, typename Rows>
__device__ __forceinline__ void decode_split(
    const T* __restrict__ q, const T* __restrict__ kb,
    const T* __restrict__ vb, Rows rows, int n, int G, int D, float scale,
    T* __restrict__ out) {
  using L = DecTile<T, CHP>;
  constexpr int E = L::NCH * L::EPC;    // elements a lane holds a row
  const int rank = dec_cluster_rank();
  extern __shared__ __align__(16) unsigned char dec_smem[];
  unsigned char* ring = dec_smem;
  float* q_s = reinterpret_cast<float*>(dec_smem +
                                        dec_ring_bytes<T, CHP>(G, D));
  float* part = q_s + G * D;            // m [G], l [G], acc [G][D]
  long long* tbl_s = reinterpret_cast<long long*>(part + G * (D + 2));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int CH = D * (int)sizeof(T) / 16;

  const float qscale = scale * DEC_LOG2E;          // scores in log2 units
  for (int i = tid; i < G * D; i += DEC_THREADS)   // ahead of n's use
    q_s[i] = to_f(q[i]) * qscale;
  const int share = dec_share(n, L::TK);
  const int lo = min(n, rank * share), hi = min(n, lo + share);
  const int nt = (hi - lo + L::TK - 1) / L::TK;
  rows.stage(lo, hi, tbl_s, L::TK);

  // copier: chunk column cc of rows rr + p * RPP of each tile
  const int cc = tid % CHP, rr = tid / CHP;
  typename Rows::Cursor cur[L::NP];
#pragma unroll
  for (int p = 0; p < L::NP; ++p) cur[p] = rows.at(lo + rr + p * L::RPP);
  const uint32_t ring_a = (uint32_t)__cvta_generic_to_shared(ring);
  __syncthreads();                      // the staged table and q
  auto load = [&](int j) {              // tile j, in order of j
    const uint32_t st = ring_a + (j % DEC_STAGES) * L::STAGE;
#pragma unroll
    for (int p = 0; p < L::NP; ++p) {
      const int row = rr + p * L::RPP;
      const bool ok = lo + j * L::TK + row < hi;
      if (cc < CH) {
        const long long off = ok ? rows.offset(cur[p]) + cc * L::EPC : 0;
        const uint32_t dst = st + row * L::ROWB + cc * 16;
        dec_cp16(dst, kb + off, ok);
        dec_cp16(dst + L::TK * L::ROWB, vb + off, ok);
      }
      rows.step(cur[p], L::TK);
    }
  };

  const int r = lane / L::LPR, c = lane % L::LPR;
  float m[GM], l[GM], acc[GM][E];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = PT_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < DEC_STAGES - 1; ++s) {
    if (s < nt) load(s);
    dec_commit();
  }
  for (int j = 0; j < nt; ++j) {
    dec_wait<DEC_STAGES - 2>();         // this thread's copies of tile j
    __syncthreads();                    // everyone's; tile j - 1 is done
    if (j + DEC_STAGES - 1 < nt) load(j + DEC_STAGES - 1);
    dec_commit();
    const unsigned char* kt = ring + (j % DEC_STAGES) * L::STAGE;
    const unsigned char* vt = kt + L::TK * L::ROWB;
    const int k0 = lo + j * L::TK + warp * L::KPW + r;  // key of u = 0

    float s[L::U][GM];
#pragma unroll
    for (int u = 0; u < L::U; ++u) {
      const int row = warp * L::KPW + u * L::RPW + r;
      float kf[E];
#pragma unroll
      for (int h = 0; h < L::NCH; ++h) {
        const int ch = c + h * L::LPR;
        if (ch < CH) {
          dec_unpack(kt + row * L::ROWB + ch * 16, kf + h * L::EPC, T());
        } else {
#pragma unroll
          for (int e = 0; e < L::EPC; ++e) kf[h * L::EPC + e] = 0.f;
        }
      }
      const bool valid = k0 + u * L::RPW < hi;
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
        float dot = 0.f;
#pragma unroll
        for (int h = 0; h < L::NCH; ++h) {
          const int ch = c + h * L::LPR;
          if (ch < CH) {
            const float4* qv =
                reinterpret_cast<const float4*>(q_s + g * D + ch * L::EPC);
#pragma unroll
            for (int e4 = 0; e4 < L::EPC / 4; ++e4) {
              const float4 x = qv[e4];
              const float* kk = kf + h * L::EPC + 4 * e4;
              dot += x.x * kk[0] + x.y * kk[1] + x.z * kk[2] + x.w * kk[3];
            }
          }
        }
#pragma unroll
        for (int o = L::LPR / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(PT_FULL_MASK, dot, o);
        s[u][g] = valid ? dot : PT_NEG_INF;
      }
    }
    // one max and one rescale per tile for each query row
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      float mt = s[0][g];
#pragma unroll
      for (int u = 1; u < L::U; ++u) mt = fmaxf(mt, s[u][g]);
#pragma unroll
      for (int o = L::LPR; o < 32; o <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(PT_FULL_MASK, mt, o));
      const float mn = fmaxf(m[g], mt);
      const float alpha = dec_exp2(m[g] - mn);
      m[g] = mn;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < L::U; ++u) {
      const int row = warp * L::KPW + u * L::RPW + r;
      const bool valid = k0 + u * L::RPW < hi;
      float vf[E];
#pragma unroll
      for (int h = 0; h < L::NCH; ++h) {
        const int ch = c + h * L::LPR;
        if (ch < CH) {
          dec_unpack(vt + row * L::ROWB + ch * 16, vf + h * L::EPC, T());
        } else {
#pragma unroll
          for (int e = 0; e < L::EPC; ++e) vf[h * L::EPC + e] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
        const float p = valid ? dec_exp2(s[u][g] - m[g]) : 0.f;
        l[g] += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] += p * vf[e];
      }
    }
  }
  dec_wait<0>();
  __syncthreads();                      // the ring is free: warp partials

  // the warp's lane groups share m: their l and acc add up
  float* wm = reinterpret_cast<float*>(ring);   // [DEC_W][G]
  float* wl = wm + DEC_W * G;                   // [DEC_W][G]
  float* wacc = wl + DEC_W * G;                 // [DEC_W][G][D]
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int o = L::LPR; o < 32; o <<= 1) {
      l[g] += __shfl_xor_sync(PT_FULL_MASK, l[g], o);
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[g][e] += __shfl_xor_sync(PT_FULL_MASK, acc[g][e], o);
    }
    if (lane == 0) {
      wm[warp * G + g] = m[g];
      wl[warp * G + g] = l[g];
    }
    if (r == 0) {
#pragma unroll
      for (int h = 0; h < L::NCH; ++h) {
        const int ch = c + h * L::LPR;
        if (ch < CH) {
#pragma unroll
          for (int e = 0; e < L::EPC; ++e)
            wacc[(warp * G + g) * D + ch * L::EPC + e] =
                acc[g][h * L::EPC + e];
        }
      }
    }
  }
  __syncthreads();
  // the CTA's partial: its warps merged in order
  for (int i = tid; i < G * D; i += DEC_THREADS) {
    const int g = i / D, d = i - g * D;
    float mx = PT_NEG_INF;
    for (int w = 0; w < DEC_W; ++w) mx = fmaxf(mx, wm[w * G + g]);
    float ls = 0.f, a = 0.f;
    for (int w = 0; w < DEC_W; ++w) {
      const float cw = dec_exp2(wm[w * G + g] - mx);
      ls += wl[w * G + g] * cw;
      a += wacc[(w * G + g) * D + d] * cw;
    }
    part[2 * G + i] = a;
    if (d == 0) {
      part[g] = mx;
      part[G + g] = ls;
    }
  }
  dec_cluster_sync();                   // every partial is written
  if (rank == 0) {
    for (int i = tid; i < G * D; i += DEC_THREADS) {
      const int g = i / D;
      float mk[DEC_SPLIT], lk[DEC_SPLIT], ak[DEC_SPLIT];
#pragma unroll
      for (int k = 0; k < DEC_SPLIT; ++k) {   // every load in flight at once
        mk[k] = dec_ld_rank(part + g, k);
        lk[k] = dec_ld_rank(part + G + g, k);
        ak[k] = dec_ld_rank(part + 2 * G + i, k);
      }
      float mx = PT_NEG_INF;
#pragma unroll
      for (int k = 0; k < DEC_SPLIT; ++k) mx = fmaxf(mx, mk[k]);
      float ls = 0.f, a = 0.f;
#pragma unroll
      for (int k = 0; k < DEC_SPLIT; ++k) {
        const float ck = dec_exp2(mk[k] - mx);
        ls += lk[k] * ck;
        a += ak[k] * ck;
      }
      out[i] = from_f<T>(a / fmaxf(ls, PT_L_MIN));
    }
  }
  dec_cluster_sync();                   // peers stay until rank 0 has read
}

// Launch `kern` on clusters of DEC_SPLIT CTAs along x (grid.x a multiple
// of DEC_SPLIT); returns the launch's error code.
template <typename... P, typename... A>
static int decode_cluster_launch(void (*kern)(P...), dim3 grid, size_t smem,
                                 cudaStream_t stream, A... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(DEC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = DEC_SPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// 16-byte chunks a row, rounded up to a power of two (the kernels'
// CHP): 1 .. 32 for bf16, 2 .. 64 for f32 at head dims 8 .. 256.
static inline int decode_chunks_pow2(int D, int elem) {
  const int ch = D * elem / 16;
  int p = 1;
  while (p < ch) p <<= 1;
  return p;
}

// Query heads of the chunk a block serves (the grid's z index picks the
// chunk of the group): the group's heads g0 .. g0 + rows - 1.
static inline int decode_chunks(int group) {
  return (group + DEC_MAXG - 1) / DEC_MAXG;
}

__device__ __forceinline__ int decode_chunk_rows(int group, int g0) {
  return min(DEC_MAXG, group - g0);
}

// ---------------------------------------------------------------------
// int8 pools (the quantized KV tier): key / value rows of int8 codes with
// one f32 scale per row (per token and kv head).  A lane owns 16
// consecutive codes of a row and reads them with one 16-byte load, so
// LPR lanes cover a row (LPR = D / 16 rounded up to 4, 8 or 16; lanes
// past D idle) and a warp reads 32 / LPR rows per load instruction, each
// lane group its own key.  Each code is dequantized in registers as
// code * scale, the f32 multiply of the JAX kernel (paged_attention.py
// :104-106), before the q.k dot and the p.v update.  The chunk's G <= GM
// query rows (pre-scaled, f32) sit in shared memory, the accumulators in
// registers.  Each lane group keeps its own online-softmax state; the
// groups of a warp merge by shuffles, the warps through shared memory.
// Masking, the -1e30 start and the 1e-30 clamp are the exact tier's.
#define DEC_Q8_UNROLL 2

// Sign-extend the 16 int8 codes of w and scale them: f[e] = code_e * s.
__device__ __forceinline__ void dec_unpack16(uint4 w, float s, float* f) {
  const unsigned int word[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = (float)(((int)(word[i] << (24 - 8 * j))) >> 24) * s;
}

// row(t) -> index of key t's row: its codes sit at row(t) * D in the K
// and V arrays and its scales at row(t) in the scale tables.
template <typename T, int LPR, int GM, typename Row>
__device__ __forceinline__ void decode_rows_q8(
    const T* __restrict__ q, const int8_t* __restrict__ kbase,
    const int8_t* __restrict__ vbase, const float* __restrict__ kscale,
    const float* __restrict__ vscale, Row row, int t0, int t1, int G, int D,
    float scale, T* __restrict__ out) {
  constexpr int RPW = 32 / LPR;                 // rows per warp load
  constexpr int STEP = RPW * DEC_Q8_UNROLL;     // keys per warp iteration
  extern __shared__ float dsm[];
  float* sm_m = dsm;                            // [DEC_WARPS][G]
  float* sm_l = sm_m + DEC_WARPS * G;           // [DEC_WARPS][G]
  float* sm_acc = sm_l + DEC_WARPS * G;         // [DEC_WARPS][G][D]
  float* sm_q = sm_acc + DEC_WARPS * G * D;     // [G][D], times scale
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = lane / LPR, c = lane % LPR;
  const bool active = 16 * c < D;

  for (int i = threadIdx.x; i < G * D; i += blockDim.x)
    sm_q[i] = to_f(q[i]) * scale;
  __syncthreads();

  float acc[GM][16], m[GM], l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = PT_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[g][e] = 0.f;
  }

  for (int base = t0 + warp * STEP; base <= t1; base += DEC_WARPS * STEP) {
    uint4 kr[DEC_Q8_UNROLL], vr[DEC_Q8_UNROLL];
    float ks[DEC_Q8_UNROLL], vs[DEC_Q8_UNROLL];
#pragma unroll
    for (int u = 0; u < DEC_Q8_UNROLL; ++u) {
      const int t = base + u * RPW + r;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      ks[u] = vs[u] = 0.f;
      if (t <= t1 && active) {
        const long long i = row(t);
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kbase + i * D + 16 * c));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vbase + i * D + 16 * c));
        ks[u] = kscale[i];
        vs[u] = vscale[i];
      }
    }
#pragma unroll
    for (int u = 0; u < DEC_Q8_UNROLL; ++u) {
      const bool valid = base + u * RPW + r <= t1;
      float kf[16], vf[16];
      dec_unpack16(kr[u], ks[u], kf);
      dec_unpack16(vr[u], vs[u], vf);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;                      // G is the block's own
        float s = 0.f;
        if (active) {
          const float4* qg =
              reinterpret_cast<const float4*>(sm_q + g * D + 16 * c);
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4) {
            const float4 qv = qg[e4];
            s += qv.x * kf[4 * e4] + qv.y * kf[4 * e4 + 1] +
                 qv.z * kf[4 * e4 + 2] + qv.w * kf[4 * e4 + 3];
          }
        }
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          s += __shfl_xor_sync(PT_FULL_MASK, s, o);
        if (valid) {
          const float m_new = fmaxf(m[g], s);
          const float alpha = expf(m[g] - m_new);
          const float p = expf(s - m_new);
          l[g] = alpha * l[g] + p;
#pragma unroll
          for (int e = 0; e < 16; ++e)
            acc[g][e] = acc[g][e] * alpha + p * vf[e];
          m[g] = m_new;
        }
      }
    }
  }

  // merge the warp's lane groups (lanes c, c + LPR, ... hold one slice)
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) {
      const float m2 = __shfl_xor_sync(PT_FULL_MASK, m[g], o);
      const float l2 = __shfl_xor_sync(PT_FULL_MASK, l[g], o);
      const float mx = fmaxf(m[g], m2);
      const float a1 = expf(m[g] - mx), a2 = expf(m2 - mx);
      l[g] = l[g] * a1 + l2 * a2;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float a = __shfl_xor_sync(PT_FULL_MASK, acc[g][e], o);
        acc[g][e] = acc[g][e] * a1 + a * a2;
      }
      m[g] = mx;
    }
    if (r == 0) {
      if (c == 0) {
        sm_m[warp * G + g] = m[g];
        sm_l[warp * G + g] = l[g];
      }
      if (active) {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          sm_acc[(warp * G + g) * D + 16 * c + e] = acc[g][e];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    float mx = PT_NEG_INF;
    for (int w = 0; w < DEC_WARPS; ++w) mx = fmaxf(mx, sm_m[w * G + g]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float cw = expf(sm_m[w * G + g] - mx);
      lsum += sm_l[w * G + g] * cw;
      a += sm_acc[(w * G + g) * D + d] * cw;
    }
    out[g * D + d] = from_f<T>(a / fmaxf(lsum, PT_L_MIN));
  }
}

// Lanes per row of the int8 rows: D / 16 rounded up to 4, 8 or 16.
static inline int decode_q8_lanes(int D) {
  return D <= 64 ? 4 : D <= 128 ? 8 : 16;
}

static inline size_t decode_q8_smem_bytes(int group, int D) {
  const int G = group < DEC_MAXG ? group : DEC_MAXG;
  return sizeof(float) * ((size_t)DEC_WARPS * G * (2 + D) + (size_t)G * D);
}
