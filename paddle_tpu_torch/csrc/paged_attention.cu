// Ragged paged-attention decode for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py `_paged_kernel`
// (:68), launched by `paged_attention` (:134).
//
// Bound on this card: device-memory bytes.  Each decode step reads every
// live sequence's K and V pages once (2 * (pos+1) * head_dim elements
// per kv head) and does 4 flops per element read, far below the ~295
// flops/byte at which the H100 stops being bandwidth bound.
//
// Design (decode_common.cuh, `decode_split`): one cluster of DEC_SPLIT
// CTAs per (sequence, kv head, chunk of <= 8 heads of the GQA group), the
// sequence's keys 0..pos split evenly among the cluster's CTAs and
// merged by rank 0 through distributed shared memory, so cost is
// O(tokens in the cache), not O(pool), and a batch of a few sequences
// still fills the card.  The TPU grid's scalar-prefetched index map
// becomes an in-kernel table read: each CTA stages its share's slice of
// the table row in shared memory and resolves a page once per PS keys.
// A page of one kv head is PS contiguous rows; each CTA streams its rows
// with 16-byte `cp.async` copies through a 3-stage ring; f32 online
// softmax, one rescale per tile.  The pools must be 16-byte aligned (the
// wrapper checks).  Free engine slots point at scratch page 0 with pos =
// 0 and compute one row of garbage that the host discards.
//
// int8 pools (the quantized KV tier), `paged_attention_int8`.  Replaces
// the same kernel's int8 branch (`quantized=True`: the scale rows of each
// page ride the page gather, :189-193, and dequantize inside the online
// softmax, :104-106).  Pools hold int8 codes [num_pages, Hkv, PS, D] and
// f32 scale tables [num_pages, Hkv, PS], one scale per token and kv
// head.  Bound on this card: bytes, (pos + 1) * Hkv * (2 * D + 2 * 4)
// per sequence (codes and scales of K and V), about half the bf16
// pools' at D = 128.  Design: the exact tier's `decode_split` over int8
// rows (KV = int8_t): the same cluster of DEC_SPLIT CTAs, split, staged
// page table, ring and merge; a row is D bytes of codes, copied 16 bytes
// a lane, and its K and V scales ride the same ring stage (the scales of
// a page's kv head are PS contiguous f32, so four keys of one page come
// in one 16-byte copy when PS % 4 == 0 and the tables are 16-byte
// aligned, else one 4-byte copy a row).  A lane reads 8 codes of a
// staged row and turns them into f32 exactly in registers; a key's
// scales multiply its score and its weight.  No page-size gate (the
// Mosaic kernel needs pages of 32 for the int8 sublane tile): any PS
// serves.
#include "decode_common.cuh"

// min blocks 1: ptxas keeps every register the kernel asks for (its
// default register-usage heuristics trade a few for small spills)
template <typename T, int CHP, int GM>
__global__ void __launch_bounds__(DEC_THREADS, 1) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ table,
    const int* __restrict__ pos, T* __restrict__ out, int Hq, int Hkv,
    int PS, int P, int D, float scale) {
  // cluster rank = blockIdx.x % DEC_SPLIT (clusters run along x)
  const int hk = blockIdx.x / DEC_SPLIT, b = blockIdx.y;
  const int group = Hq / Hkv, g0 = blockIdx.z * DEC_MAXG;
  DecPagedRows<false> rows{table + (long long)b * P, (long long)Hkv * PS * D,
                           (long long)hk * PS * D, PS, D, nullptr, 0, 0, 0};
  const long long qo = ((long long)b * Hq + (long long)hk * group + g0) * D;
  // keys 0..pos[b]; the table row holds P * PS of them
  const int n = min(pos[b] + 1, P * PS);
  decode_split<T, T, CHP, GM>(q + qo, kp, vp, nullptr, nullptr, false, rows,
                              n, decode_chunk_rows(group, g0), D, scale,
                              out + qo);
}

template <typename T, int CHP, int GM>
static int launch(const void* q, const void* kp, const void* vp,
                  const int* table, const int* pos, void* out, int B,
                  int Hq, int Hkv, int PS, int P, int D, float scale,
                  cudaStream_t stream) {
  const int group = Hq / Hkv, G = group < DEC_MAXG ? group : DEC_MAXG;
  // the table entries one CTA stages: its share's pages, one more where
  // the share straddles a page
  const int tbl = dec_share(P * PS, DecTile<T, CHP>::TK) / PS + 2;
  return decode_cluster_launch(
      paged_attention_kernel<T, CHP, GM>,
      dim3(Hkv * DEC_SPLIT, B, decode_chunks(group)),
      decode_split_smem<T, CHP>(G, D, tbl), stream, (const T*)q,
      (const T*)kp, (const T*)vp, table, pos, (T*)out, Hq, Hkv, PS, P, D,
      scale);
}

// GM: the chunk's query rows rounded up to 1, 2, 4 or 8.
template <typename T, int CHP>
static int dispatch_rows(const void* q, const void* kp, const void* vp,
                         const int* table, const int* pos, void* out, int B,
                         int Hq, int Hkv, int PS, int P, int D, float scale,
                         cudaStream_t s) {
  const int g = Hq / Hkv;
  if (g == 1) return launch<T, CHP, 1>(q, kp, vp, table, pos, out, B, Hq, Hkv, PS, P, D, scale, s);
  if (g == 2) return launch<T, CHP, 2>(q, kp, vp, table, pos, out, B, Hq, Hkv, PS, P, D, scale, s);
  if (g <= 4) return launch<T, CHP, 4>(q, kp, vp, table, pos, out, B, Hq, Hkv, PS, P, D, scale, s);
  return launch<T, CHP, 8>(q, kp, vp, table, pos, out, B, Hq, Hkv, PS, P, D, scale, s);
}

// CHP: 16-byte chunks a row rounded up to a power of two; bf16 and f16
// rows hold 1 .. 32 chunks, f32 rows 2 .. 64, at head dims 8 .. 256.
template <typename T>
static int dispatch(const void* q, const void* kp, const void* vp,
                    const int* table, const int* pos, void* out, int B,
                    int Hq, int Hkv, int PS, int P, int D, float scale,
                    cudaStream_t s) {
  switch (decode_chunks_pow2(D, (int)sizeof(T))) {
    case 1: return dispatch_rows<T, 1>(q, kp, vp, table, pos, out, B, Hq, Hkv, PS, P, D, scale, s);
    case 2: return dispatch_rows<T, 2>(q, kp, vp, table, pos, out, B, Hq, Hkv, PS, P, D, scale, s);
    case 4: return dispatch_rows<T, 4>(q, kp, vp, table, pos, out, B, Hq, Hkv, PS, P, D, scale, s);
    case 8: return dispatch_rows<T, 8>(q, kp, vp, table, pos, out, B, Hq, Hkv, PS, P, D, scale, s);
    case 16: return dispatch_rows<T, 16>(q, kp, vp, table, pos, out, B, Hq, Hkv, PS, P, D, scale, s);
    case 32: return dispatch_rows<T, 32>(q, kp, vp, table, pos, out, B, Hq, Hkv, PS, P, D, scale, s);
    default: return dispatch_rows<T, 64>(q, kp, vp, table, pos, out, B, Hq, Hkv, PS, P, D, scale, s);
  }
}

// q [B, Hq, D]; k_pages/v_pages [num_pages, Hkv, PS, D], 16-byte
// aligned; table [B, P] int32; pos [B] int32 (valid keys 0..pos[b]); out
// [B, Hq, D]; q, pools and out of one dtype, f32, bf16 or f16.
extern "C" int paged_attention(const void* q, const void* kp, const void* vp,
                               const void* table, const void* pos, void* out,
                               int B, int Hq, int Hkv, int PS, int P, int D,
                               float scale, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!tc_aligned(kp) || !tc_aligned(vp)) return (int)cudaErrorInvalidValue;
  if (dtype == PT_BF16)
    return dispatch<__nv_bfloat16>(q, kp, vp, (const int*)table,
                                   (const int*)pos, out, B, Hq, Hkv, PS, P, D,
                                   scale, s);
  if (dtype == PT_F16)
    return dispatch<__half>(q, kp, vp, (const int*)table, (const int*)pos,
                            out, B, Hq, Hkv, PS, P, D, scale, s);
  if (dtype != PT_F32) return (int)cudaErrorInvalidValue;
  return dispatch<float>(q, kp, vp, (const int*)table, (const int*)pos, out,
                         B, Hq, Hkv, PS, P, D, scale, s);
}

// ----------------------------------------------------------- int8 pools
// The exact kernel over int8 codes: the same grid and core, the scale
// tables beside the pools.  One query row a chunk (no GQA: llama_7b)
// asks ptxas for DEC_Q8_MIN_CTAS CTAs an SM, 56 registers a thread with
// no spill, which took 2% off the profiled engine step's launch.
template <typename T, int CHP, int GM>
__global__ void __launch_bounds__(DEC_THREADS, GM == 1 ? DEC_Q8_MIN_CTAS : 1)
    paged_attention_int8_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ kp,
    const int8_t* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ table,
    const int* __restrict__ pos, T* __restrict__ out, int Hq, int Hkv,
    int PS, int P, int D, float scale, int scales16) {
  // cluster rank = blockIdx.x % DEC_SPLIT (clusters run along x)
  const int hk = blockIdx.x / DEC_SPLIT, b = blockIdx.y;
  const int group = Hq / Hkv, g0 = blockIdx.z * DEC_MAXG;
  DecPagedRows<true> rows{table + (long long)b * P, (long long)Hkv * PS,
                          (long long)hk * PS, PS, D, nullptr, 0, 0, 0};
  const long long qo = ((long long)b * Hq + (long long)hk * group + g0) * D;
  const int n = min(pos[b] + 1, P * PS);
  decode_split<T, int8_t, CHP, GM>(q + qo, kp, vp, ks, vs, scales16 != 0,
                                   rows, n, decode_chunk_rows(group, g0), D,
                                   scale, out + qo);
}

template <typename T, int CHP, int GM>
static int launch_int8(const void* q, const void* kp, const void* vp,
                       const float* ks, const float* vs, const int* table,
                       const int* pos, void* out, int B, int Hq, int Hkv,
                       int PS, int P, int D, float scale, int scales16,
                       cudaStream_t stream) {
  const int group = Hq / Hkv, G = group < DEC_MAXG ? group : DEC_MAXG;
  const int tbl = dec_share(P * PS, DecTile<int8_t, CHP>::TK) / PS + 2;
  return decode_cluster_launch(
      paged_attention_int8_kernel<T, CHP, GM>,
      dim3(Hkv * DEC_SPLIT, B, decode_chunks(group)),
      decode_split_smem<int8_t, CHP>(G, D, tbl), stream, (const T*)q,
      (const int8_t*)kp, (const int8_t*)vp, ks, vs, table, pos, (T*)out, Hq,
      Hkv, PS, P, D, scale, scales16);
}

// GM: the chunk's query rows rounded up to 1, 2, 4 or 8.
template <typename T, int CHP>
static int dispatch_int8_rows(const void* q, const void* kp, const void* vp,
                              const float* ks, const float* vs,
                              const int* table, const int* pos, void* out,
                              int B, int Hq, int Hkv, int PS, int P, int D,
                              float scale, int v16, cudaStream_t s) {
  const int g = Hq / Hkv;
  if (g == 1) return launch_int8<T, CHP, 1>(q, kp, vp, ks, vs, table, pos, out, B, Hq, Hkv, PS, P, D, scale, v16, s);
  if (g == 2) return launch_int8<T, CHP, 2>(q, kp, vp, ks, vs, table, pos, out, B, Hq, Hkv, PS, P, D, scale, v16, s);
  if (g <= 4) return launch_int8<T, CHP, 4>(q, kp, vp, ks, vs, table, pos, out, B, Hq, Hkv, PS, P, D, scale, v16, s);
  return launch_int8<T, CHP, 8>(q, kp, vp, ks, vs, table, pos, out, B, Hq, Hkv, PS, P, D, scale, v16, s);
}

// CHP: a row's D bytes of codes in 16-byte chunks, rounded up to a power
// of two (1 .. 16 at head dims 16 .. 256).
template <typename T>
static int dispatch_int8(const void* q, const void* kp, const void* vp,
                         const float* ks, const float* vs, const int* table,
                         const int* pos, void* out, int B, int Hq, int Hkv,
                         int PS, int P, int D, float scale, int v16,
                         cudaStream_t s) {
  switch (decode_chunks_pow2(D, 1)) {
    case 1: return dispatch_int8_rows<T, 1>(q, kp, vp, ks, vs, table, pos, out, B, Hq, Hkv, PS, P, D, scale, v16, s);
    case 2: return dispatch_int8_rows<T, 2>(q, kp, vp, ks, vs, table, pos, out, B, Hq, Hkv, PS, P, D, scale, v16, s);
    case 4: return dispatch_int8_rows<T, 4>(q, kp, vp, ks, vs, table, pos, out, B, Hq, Hkv, PS, P, D, scale, v16, s);
    case 8: return dispatch_int8_rows<T, 8>(q, kp, vp, ks, vs, table, pos, out, B, Hq, Hkv, PS, P, D, scale, v16, s);
    default: return dispatch_int8_rows<T, 16>(q, kp, vp, ks, vs, table, pos, out, B, Hq, Hkv, PS, P, D, scale, v16, s);
  }
}

// q [B, Hq, D] (f32, bf16 or f16); k_pages / v_pages int8 [num_pages, Hkv, PS,
// D], D % 16 == 0 and <= 256, 16-byte aligned; k_scales / v_scales f32
// [num_pages, Hkv, PS]; table [B, P] int32; pos [B] int32; out [B, Hq, D]
// in q's dtype.  The scales move four rows a 16-byte copy when four
// consecutive keys share a page and the tables are 16-byte aligned.
extern "C" int paged_attention_int8(const void* q, const void* kp,
                                    const void* vp, const void* ks,
                                    const void* vs, const void* table,
                                    const void* pos, void* out, int B, int Hq,
                                    int Hkv, int PS, int P, int D, float scale,
                                    int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!tc_aligned(kp) || !tc_aligned(vp) || D % 16)
    return (int)cudaErrorInvalidValue;
  const int v16 = PS % 4 == 0 && tc_aligned(ks) && tc_aligned(vs);
  if (dtype == PT_BF16)
    return dispatch_int8<__nv_bfloat16>(q, kp, vp, (const float*)ks,
                                        (const float*)vs, (const int*)table,
                                        (const int*)pos, out, B, Hq, Hkv, PS,
                                        P, D, scale, v16, s);
  if (dtype == PT_F16)
    return dispatch_int8<__half>(q, kp, vp, (const float*)ks,
                                 (const float*)vs, (const int*)table,
                                 (const int*)pos, out, B, Hq, Hkv, PS, P, D,
                                 scale, v16, s);
  if (dtype != PT_F32) return (int)cudaErrorInvalidValue;
  return dispatch_int8<float>(q, kp, vp, (const float*)ks, (const float*)vs,
                              (const int*)table, (const int*)pos, out, B, Hq,
                              Hkv, PS, P, D, scale, v16, s);
}
