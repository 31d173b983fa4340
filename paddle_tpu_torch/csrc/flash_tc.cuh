// Tensor-core building blocks of the 16-bit kernels (flash_fwd.cu,
// flash_bwd.cu, conv_bn_act.cu, window_attention_bwd.cu): inline PTX for
// `mma.sync` m16n8k16 on bf16 or f16 fragments with f32 accumulators,
// `ldmatrix` (plain and transposed) and 16-byte `cp.async` copies into
// XOR-swizzled shared-memory tiles.  The helpers take the 16-bit element
// type E (bf16, the default, or f16): the tile code only moves 16-bit
// words, so E matters to `tc_mma` (the mma's operand type) and
// `tc_pack` (the rounding of f32 accumulators), and to the helpers that
// call them.
//
// Tiles hold rows of DT 16-bit values (DT = 16, 32, 64, 128 or 256: a head
// dim rounded up, or a conv's K step of 32), as 16-byte chunks of 8
// values.  With 8 or more chunks a row, chunk c of row r lives at chunk
// c ^ (r & 7) of that row; with NC = 2 or 4 chunks, at c ^ ((r / (8 /
// NC)) & (NC - 1)), so that 8 consecutive rows still cover the 8 bank
// groups of 128 bytes.  Either way the 8 rows an `ldmatrix` reads for
// one 8x8 matrix (the same logical chunk of 8 consecutive rows) fall on
// 8 different bank groups.  Tiles are stacked in multiples of 8 rows, so
// a row's swizzle is the same whether it is counted from its tile or
// from the start of shared memory.
//
// Fragment layouts of m16n8k16 (lane = 4 * g + t): A (16x16, row-major)
// a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..), a3 = (g+8,
// 2t+8..); B (16x8, k x n) b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g);
// C (16x8 f32) c0, c1 = (g, 2t), (g, 2t+1); c2, c3 = (g+8, 2t), (g+8,
// 2t+1).  So an accumulator pair of n-tiles 2i, 2i+1 is, rounded to
// E, the A fragment of k-step i of the next product: P and dS go from
// one mma to the next in registers.
#pragma once

#include "common.cuh"

#define TC_LOG2E 1.4426950408889634f
#define TC_WARPS 4  // every tensor-core flash kernel runs 4 warps a block
#define TC_THREADS (TC_WARPS * 32)

typedef __nv_bfloat16 bf16;
typedef __half f16;

// Whether the element type is f16 (no <type_traits>: toolkit headers
// only).
template <typename E>
struct tc_is_f16 {
  static constexpr bool value = false;
};
template <>
struct tc_is_f16<f16> {
  static constexpr bool value = true;
};

__device__ __forceinline__ uint32_t tc_smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Element offset of chunk c of row r in a swizzled tile of DT-wide rows.
template <int DT>
__device__ __forceinline__ int tc_swz(int r, int c) {
  constexpr int NC = DT / 8;
  static_assert(NC == 2 || NC == 4 || NC % 8 == 0, "DT: 16, 32 or 64k");
  if constexpr (NC >= 8) return r * DT + ((c ^ (r & 7)) << 3);
  else return r * DT + ((c ^ ((r / (8 / NC)) & (NC - 1))) << 3);
}

// 16-byte global -> shared copy; `full` false fills the 16 bytes with
// zeros and reads nothing.
__device__ __forceinline__ void tc_cp16(uint32_t dst, const void* src,
                                        bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0));
}
// 4-byte global -> shared copy (an f32 element at any 4-byte address).
__device__ __forceinline__ void tc_cp4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void tc_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void tc_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void tc_ldsm(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void tc_ldsm_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a . b on the tensor cores (E operands, f32 accumulators).
template <typename E = bf16>
__device__ __forceinline__ void tc_mma(float (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  if constexpr (tc_is_f16<E>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// Two f32 values rounded to nearest E, `lo` in the low half.
template <typename E = bf16>
__device__ __forceinline__ uint32_t tc_pack(float lo, float hi) {
  if constexpr (tc_is_f16<E>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

__device__ __forceinline__ float tc_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The A fragment of k-step kk from rows r0 .. r0 + 15 of a swizzled
// tile (row-major operand: Q, dO, K or V rows).
template <int DT, typename E>
__device__ __forceinline__ void tc_frag_a(const E* tile, int r0, int kk,
                                          int lane, uint32_t (&a)[4]) {
  tc_ldsm(tc_smem(tile + tc_swz<DT>(r0 + (lane & 15), 2 * kk + (lane >> 4))),
          a);
}

// B fragments of n-tiles j, j + 1 (rows 8j .. 8j + 15 of the tile are
// the n index) at k-step kk, for a product contracting the tile's
// columns (S = Q K^T: K rows are keys).  b = {b0(j), b1(j), b0(j+1),
// b1(j+1)}.
template <int DT, typename E>
__device__ __forceinline__ void tc_frag_b(const E* tile, int j, int kk,
                                          int lane, uint32_t (&b)[4]) {
  tc_ldsm(tc_smem(tile + tc_swz<DT>(8 * j + (lane & 7) + ((lane >> 4) << 3),
                                    2 * kk + ((lane >> 3) & 1))),
          b);
}

// B fragments of n-tiles n, n + 1 (columns 8n .. 8n + 15) at k-step kk
// (rows 16kk .. 16kk + 15), for a product contracting the tile's rows
// (O = P V: V rows are keys), through ldmatrix.trans.
template <int DT, typename E>
__device__ __forceinline__ void tc_frag_bt(const E* tile, int n, int kk,
                                           int lane, uint32_t (&b)[4]) {
  tc_ldsm_t(tc_smem(tile + tc_swz<DT>(16 * kk + (lane & 7) +
                                          (((lane >> 3) & 1) << 3),
                                      n + (lane >> 4))),
            b);
}

// The A fragment of k-step kk of a product whose A is a swizzled tile
// transposed: rows 16kk .. 16kk + 15 of the tile are the k index and its
// columns 16m .. 16m + 15 the rows of A, through ldmatrix.trans
// (window_attention_bwd.cu: dV = P^T G from the query-major P tile).
template <int DT, typename E>
__device__ __forceinline__ void tc_frag_at(const E* tile, int m, int kk,
                                           int lane, uint32_t (&a)[4]) {
  tc_ldsm_t(tc_smem(tile + tc_swz<DT>(16 * kk + (lane & 7) +
                                          ((lane >> 4) << 3),
                                      2 * m + ((lane >> 3) & 1))),
            a);
}

// The A fragment of k-step i from the f32 values of n-tiles 2i, 2i+1 of
// an accumulator, each rounded to E.
template <typename E = bf16>
__device__ __forceinline__ void tc_acc_to_a(const float (&c0)[4],
                                            const float (&c1)[4],
                                            uint32_t (&a)[4]) {
  a[0] = tc_pack<E>(c0[0], c0[1]);
  a[1] = tc_pack<E>(c0[2], c0[3]);
  a[2] = tc_pack<E>(c1[0], c1[1]);
  a[3] = tc_pack<E>(c1[2], c1[3]);
}

// cp.async rows [r0, r0 + ROWS) of a row set (row i at src + i * stride,
// D values, D % 8 == 0) into a swizzled tile, by the block's TC_THREADS
// threads; rows at or past `nrows` are zero-filled.  Chunks at or past
// D / 8 are not written (tc_zero_pad keeps them zero).  A tile row has
// DT / 8 chunks, a power of two that divides TC_THREADS, so each thread
// keeps one chunk column and steps down the rows: one pointer add a copy.
template <int ROWS, int DT, typename E>
__device__ __forceinline__ void tc_load_rows(E* tile, const E* src,
                                             long long stride, int r0,
                                             int nrows, int D) {
  constexpr int NC = DT / 8, RS = TC_THREADS / NC;  // rows per pass
  const int c = threadIdx.x % NC, r = threadIdx.x / NC;
  if (c >= D >> 3) return;
  const E* g = src + (r0 + r) * stride + c * 8;
#pragma unroll
  for (int u = 0; u < ROWS / RS; ++u) {
    const bool ok = r0 + r + u * RS < nrows;
    tc_cp16(tc_smem(tile + tc_swz<DT>(r + u * RS, c)),
            ok ? g + u * RS * stride : src, ok);
  }
}

// Zero the pad chunk of every row of `rows` stacked tile rows when D is
// not a multiple of 16 (the k-steps read D rounded up to 16).
template <int DT, typename E>
__device__ __forceinline__ void tc_zero_pad(E* tiles, int rows, int D) {
  if (D & 8)
    for (int r = threadIdx.x; r < rows; r += TC_THREADS)
      *reinterpret_cast<uint4*>(tiles + tc_swz<DT>(r, D >> 3)) =
          make_uint4(0, 0, 0, 0);
}

// Write a warp's 16 x (8 * NT) f32 accumulator block, times the row's
// factor (mul[0] rows g, mul[1] rows g + 8), as E into rows r0 ..
// r0 + 15 of a swizzled tile; n-tiles n0 .. n0 + NT - 1 at or past nd
// are skipped.
template <int DT, int NT, typename E>
__device__ __forceinline__ void tc_acc_to_tile(E* tile, int r0, int n0,
                                               int nd, const float (&c)[NT][4],
                                               const float (&mul)[2],
                                               int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n0 + n >= nd) break;
    *reinterpret_cast<uint32_t*>(tile + tc_swz<DT>(r0 + g, n0 + n) + 2 * t) =
        tc_pack<E>(c[n][0] * mul[0], c[n][1] * mul[0]);
    *reinterpret_cast<uint32_t*>(tile + tc_swz<DT>(r0 + g + 8, n0 + n) +
                                 2 * t) =
        tc_pack<E>(c[n][2] * mul[1], c[n][3] * mul[1]);
  }
}

// 16-byte stores of tile rows [0, ROWS) to row r0 + r of a row set (row
// i at dst + i * stride) by NTHR threads (tid 0 .. NTHR - 1), rows at or
// past `nrows` skipped; as tc_load_rows, each thread keeps one chunk
// column (coalesced: consecutive threads, consecutive chunks of a row).
template <int DT, int ROWS, int NTHR, typename E>
__device__ __forceinline__ void tc_store_rows(E* dst, long long stride,
                                              const E* tile, int r0,
                                              int nrows, int D, int tid) {
  constexpr int NC = DT / 8, RS = NTHR / NC;
  const int c = tid % NC, r = tid / NC;
  if (c >= D >> 3) return;
  E* g = dst + (r0 + r) * stride + c * 8;
#pragma unroll
  for (int u = 0; u < ROWS / RS; ++u)
    if (r0 + r + u * RS < nrows)
      *reinterpret_cast<uint4*>(g + u * RS * stride) =
          *reinterpret_cast<const uint4*>(tile + tc_swz<DT>(r + u * RS, c));
}
