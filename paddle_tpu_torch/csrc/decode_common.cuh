// One-query-token attention over a KV sequence, shared by the paged
// (paged_attention.cu) and dense (decode_attention.cu) decode kernels,
// for both KV tiers: bf16 / f16 / f32 rows (the exact tier) and int8
// codes with one f32 scale per row (the quantized tier, paged only; its
// query and output bf16, f16 or f32).
//
// `decode_split` is bound by device memory: 4 flops per element read.
// So the design moves bytes and keeps many of them in flight:
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
//   pages, and a row is a multiple of 16 bytes for every head dim.  The
//   int8 tier's rows are D bytes of codes; the tile's K and V scales
//   ride the same stage behind them, four rows in one 16-byte copy where
//   four consecutive keys share a page (PS % 4 == 0, aligned tables),
//   else one 4-byte copy a row.
// * A lane reads 16 bytes of a staged row (8 bytes of int8 codes, so
//   that it holds as many f32 accumulators as in the exact tier): LPR =
//   D * sizeof(KV) / 16 (or / 8) lanes, rounded up to a power of two, at
//   most 32 (a lane takes two chunks at f32 head dims above 128), cover a
//   row, so one warp load brings 32 / LPR keys; the q.k dot reduces over
//   the row's lanes only.  q sits pre-scaled in f32 in shared memory.
//   int8 codes turn into f32 in registers exactly (a byte permute and an
//   add, not the slower integer conversion), and each key's f32
//   scale multiplies its score and its softmax weight once: the JAX
//   kernel's code * scale (paged_attention.py:104-106) summed over the
//   row, within f32 rounding.
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

#define DEC_MAXG 8    // query heads a block or cluster serves at most

constexpr int DEC_SPLIT = 8;        // CTAs a cluster: the key split
constexpr int DEC_STAGES = 3;       // shared-memory tiles of the ring
constexpr int DEC_THREADS = 128;    // 4 warps a CTA
constexpr int DEC_W = DEC_THREADS / 32;
constexpr int DEC_STAGE_BYTES = 8192;   // K and V rows of one tile
constexpr int DEC_Q8_STAGE_BYTES = 4096;  // int8 codes of K and V a tile
constexpr int DEC_Q8_MIN_CTAS = 9;      // int8, one query row: CTAs an SM

// Tile geometry for K / V elements of type T (bf16, f16, f32, or int8
// codes)
// and CHP 16-byte chunks a row (D * sizeof(T) / 16 rounded up to a power
// of two), which the copies move.  A lane reads RB bytes of a staged row
// at once: 16 (8 bf16 or f16, or 4 f32 values), or 8 int8 codes, so that an int8
// row's lane keeps as many f32 accumulators as an exact row's (16 codes
// a lane would double them and halve the CTAs an SM holds).  A tile
// holds DEC_STAGE_BYTES of K and V rows, or DEC_Q8_STAGE_BYTES of int8
// codes: as many keys as a bf16 tile of the same head dim, so that a warp
// takes as many lane-group steps a tile (U = 2) and as many registers (a
// tile of 8 KB of codes, U = 4, took 91 registers a thread and ran
// slower).
template <typename T, int CHP>
struct DecTile {
  static constexpr int CPE = 16 / (int)sizeof(T);   // elements a copy
  static constexpr int RB = sizeof(T) == 1 ? 8 : 16;  // bytes a lane read
  static constexpr int RCHP = CHP * 16 / RB;        // read chunks a row
  static constexpr int EPC = RB / (int)sizeof(T);   // elements a chunk
  static constexpr int LPR = RCHP < 32 ? RCHP : 32; // lanes a row
  static constexpr int NCH = RCHP / LPR;            // chunks a lane
  static constexpr int RPW = 32 / LPR;              // rows a warp load
  static constexpr int SB =                          // row bytes a tile
      sizeof(T) == 1 ? DEC_Q8_STAGE_BYTES : DEC_STAGE_BYTES;
  static constexpr int TK0 = SB / (2 * 16 * CHP) < 64 ? SB / (2 * 16 * CHP)
                                                       : 64;
  static constexpr int TK1 = TK0 > DEC_W * RPW ? TK0 : DEC_W * RPW;
  // keys a tile: at least a warp load a warp and a copy pass
  static constexpr int TK = TK1 > DEC_THREADS / CHP ? TK1 : DEC_THREADS / CHP;
  static constexpr int KPW = TK / DEC_W;            // keys a warp a tile
  static constexpr int U = KPW / RPW;               // keys a lane group
  static constexpr int RPP = DEC_THREADS / CHP;     // rows a copy pass
  static constexpr int NP = TK / RPP;               // copy passes a tile
  static constexpr int ROWB = CHP * 16;             // bytes a staged row
  // int8 codes: the tile's K scales, then its V scales, f32, after the rows
  static constexpr int SCB = sizeof(T) == 1 ? 2 * TK * 4 : 0;
  static constexpr int STAGE = 2 * TK * ROWB + SCB; // K rows, then V rows
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

// The 4-byte copy of one f32 scale (int8 rows whose four scales do not
// share a page or a 16-byte boundary); src-size 0 writes a zero.
__device__ __forceinline__ void dec_cp4(uint32_t dst, const void* src,
                                        bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0));
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

// The 16 bytes of a staged row at p as f32: 8 bf16, 8 f16 or 4 f32
// values (each exact in f32).
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
                                           float* f, __half) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __half22float2(h[i]);
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

// The 8 int8 codes at p as f32, exactly: each code c, biased to c + 128
// (its sign bit flipped), becomes the low byte of the f32 2^23 + c + 128
// (one byte permute) and 2^23 + 128 is subtracted (one add), in place of
// a sign extension and an integer-to-float conversion, which the SM
// issues at a fraction of the rate of an add.
__device__ __forceinline__ void dec_codes8(const unsigned char* p,
                                          float* f) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const unsigned int word[2] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = __uint_as_float(__byte_perm(word[i], 0x4B000000u,
                                                 0x7650 + j)) -
                     8388736.f;
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
// key i sits in slot i % PS of page table[i / PS], row (page * Hkv + hk)
// * PS + slot of the pool, its elements at row * D.  `stage` resolves the
// pages of keys [lo, hi) once, into shared memory: the element offsets
// of their kv head's slot 0 (page_unit = Hkv * PS * D, head_unit = hk *
// PS * D), or, BY_ROW (the int8 tier, whose scales sit at the row index
// of the scale tables), the rows of slot 0 (page_unit = Hkv * PS,
// head_unit = hk * PS).  A cursor then walks pages and slots by a fixed
// step with no division and no global load in front of a row's copy.
template <bool BY_ROW>
struct DecPagedRows {
  const int* pages;       // the sequence's page-table row
  long long page_unit;    // a page's offset unit: elements, or rows
  long long head_unit;    // the kv head's, likewise
  int PS, D;
  const long long* tbl;   // slot 0 of pages pg0 .., in those units
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
      sm[i] = (long long)pages[pg0 + i] * page_unit + head_unit;
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
  __device__ long long row(const Cursor& c) const {   // BY_ROW only
    return tbl[c.pg - pg0] + c.slot;
  }
  __device__ long long offset(const Cursor& c) const {
    if constexpr (BY_ROW) return row(c) * D;
    return tbl[c.pg - pg0] + (long long)c.slot * D;
  }
};

// The CTA's share of keys 0..n-1 of one (sequence, kv head, chunk): q
// [G, D] and out [G, D] at the chunk's rows, K / V rows of type KV
// through `rows`.  KV = T: the exact tier (ks, vs unused).  KV = int8_t:
// codes with f32 scale tables ks / vs at the rows' indices (`rows.row`),
// their four-row 16-byte copies taken when `scales16`.  Runs in every CTA
// of the cluster; rank 0 writes out.
template <typename T, typename KV, int CHP, int GM, typename Rows>
__device__ __forceinline__ void decode_split(
    const T* __restrict__ q, const KV* __restrict__ kb,
    const KV* __restrict__ vb, const float* __restrict__ ks,
    const float* __restrict__ vs, bool scales16, Rows rows, int n, int G,
    int D, float scale, T* __restrict__ out) {
  using L = DecTile<KV, CHP>;
  constexpr bool Q8 = sizeof(KV) == 1;  // int8 codes and scales
  constexpr int E = L::NCH * L::EPC;    // elements a lane holds a row
  const int rank = dec_cluster_rank();
  extern __shared__ __align__(16) unsigned char dec_smem[];
  unsigned char* ring = dec_smem;
  float* q_s = reinterpret_cast<float*>(dec_smem +
                                        dec_ring_bytes<KV, CHP>(G, D));
  float* part = q_s + G * D;            // m [G], l [G], acc [G][D]
  long long* tbl_s = reinterpret_cast<long long*>(part + G * (D + 2));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int CH = D * (int)sizeof(KV) / 16;      // 16-byte copies a row
  const int RCH = D * (int)sizeof(KV) / L::RB;  // lane reads a row

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
        const long long off = ok ? rows.offset(cur[p]) + cc * L::CPE : 0;
        const uint32_t dst = st + row * L::ROWB + cc * 16;
        dec_cp16(dst, kb + off, ok);
        dec_cp16(dst + L::TK * L::ROWB, vb + off, ok);
      }
      if constexpr (Q8) {
        // the row's K and V scales behind the tile's rows: rows 4i ..
        // 4i + 3 in one 16-byte copy (one page: the tile starts on a
        // multiple of 4 keys and PS % 4 == 0), else a 4-byte copy a row
        if (cc == 0 && (!scales16 || row % 4 == 0)) {
          const long long ri = ok ? rows.row(cur[p]) : 0;
          const uint32_t dst = st + 2 * L::TK * L::ROWB + row * 4;
          if (scales16) {
            dec_cp16(dst, ks + ri, ok);
            dec_cp16(dst + L::TK * 4, vs + ri, ok);
          } else {
            dec_cp4(dst, ks + ri, ok);
            dec_cp4(dst + L::TK * 4, vs + ri, ok);
          }
        }
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
    // int8 tier: the tile's scales.  A key's K scale multiplies its
    // score and its V scale its weight, once each: code * scale summed
    // over the row, as the dequantized row's dot (within f32 rounding).
    // A masked row's scales are not read (its slot may hold anything):
    // its score is the mask and its weight 0.
    const float* kst = reinterpret_cast<const float*>(vt + L::TK * L::ROWB);
    const float* vst = kst + L::TK;
    const int k0 = lo + j * L::TK + warp * L::KPW + r;  // key of u = 0

    float s[L::U][GM];
#pragma unroll
    for (int u = 0; u < L::U; ++u) {
      const int row = warp * L::KPW + u * L::RPW + r;
      const bool valid = k0 + u * L::RPW < hi;
      float kf[E];
#pragma unroll
      for (int h = 0; h < L::NCH; ++h) {
        const int ch = c + h * L::LPR;
        if (ch < RCH) {
          const unsigned char* src = kt + row * L::ROWB + ch * L::RB;
          if constexpr (Q8)
            dec_codes8(src, kf + h * L::EPC);
          else
            dec_unpack(src, kf + h * L::EPC, KV());
        } else {
#pragma unroll
          for (int e = 0; e < L::EPC; ++e) kf[h * L::EPC + e] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
        float dot = 0.f;
#pragma unroll
        for (int h = 0; h < L::NCH; ++h) {
          const int ch = c + h * L::LPR;
          if (ch < RCH) {
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
        if constexpr (Q8) dot *= kst[row];
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
        if (ch < RCH) {
          const unsigned char* src = vt + row * L::ROWB + ch * L::RB;
          if constexpr (Q8)
            dec_codes8(src, vf + h * L::EPC);
          else
            dec_unpack(src, vf + h * L::EPC, KV());
        } else {
#pragma unroll
          for (int e = 0; e < L::EPC; ++e) vf[h * L::EPC + e] = 0.f;
        }
      }
      const float vsc = Q8 && valid ? vst[row] : 1.f;   // int8: V scale
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
        const float p = valid ? dec_exp2(s[u][g] - m[g]) : 0.f;
        l[g] += p;
        const float pv = Q8 ? p * vsc : p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] += pv * vf[e];
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
        if (ch < RCH) {
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
// CHP): 1 .. 32 for bf16 and f16, 2 .. 64 for f32 at head dims 8 .. 256, 1 .. 16
// for int8 codes at head dims 16 .. 256.
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
