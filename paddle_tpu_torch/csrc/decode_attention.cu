// Dense KV-cache decode attention for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/decode_attention.py `_decode_kernel`
// (:42), launched by `decode_attention` (:82) — the decode step of
// greedy `generate()` over the fixed-capacity dense caches.
//
// Bound on this card: device-memory bytes.  A step reads each row's K
// and V from `start` to `pos` once and does 4 flops per element read.
//
// Design (decode_common.cuh, `decode_split`): one cluster of DEC_SPLIT
// CTAs per (row, kv head, chunk of <= 8 heads of the GQA group); the
// row's keys start..pos (left-pad slots and the unwritten cache tail are
// never read, so a step costs O(tokens in the cache), not O(capacity))
// are split evenly among the cluster's CTAs, counted from `start`, and
// merged by rank 0 through distributed shared memory.  The rows are
// contiguous; each CTA streams its share with 16-byte `cp.async` copies
// through a 3-stage ring; f32 online softmax, one rescale per tile.  The
// split and every step after the copy are the paged kernel's, so the two
// give the same bits for the same keys.  The caches must be 16-byte
// aligned (the wrapper checks).
#include "decode_common.cuh"

// min blocks 1: ptxas keeps every register the kernel asks for (its
// default register-usage heuristics trade a few for small spills)
template <typename T, int CHP, int GM>
__global__ void __launch_bounds__(DEC_THREADS, 1) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, const int* __restrict__ pos,
    const int* __restrict__ start, T* __restrict__ out, int Hq, int Hkv,
    int S, int D, float scale) {
  // cluster rank = blockIdx.x % DEC_SPLIT (clusters run along x)
  const int hk = blockIdx.x / DEC_SPLIT, b = blockIdx.y;
  const int group = Hq / Hkv, g0 = blockIdx.z * DEC_MAXG;
  const int t0 = start ? start[b] : 0, t1 = min(pos[b], S - 1);
  const DecDenseRows rows{((long long)b * Hkv + hk) * S * D, t0, D};
  const long long qo = ((long long)b * Hq + (long long)hk * group + g0) * D;
  decode_split<T, T, CHP, GM>(q + qo, kc, vc, nullptr, nullptr, false, rows,
                              t1 - t0 + 1, decode_chunk_rows(group, g0), D,
                              scale, out + qo);
}

template <typename T, int CHP, int GM>
static int launch(const void* q, const void* kc, const void* vc,
                  const int* pos, const int* start, void* out, int B, int Hq,
                  int Hkv, int S, int D, float scale, cudaStream_t stream) {
  const int group = Hq / Hkv, G = group < DEC_MAXG ? group : DEC_MAXG;
  return decode_cluster_launch(
      decode_attention_kernel<T, CHP, GM>,
      dim3(Hkv * DEC_SPLIT, B, decode_chunks(group)),
      decode_split_smem<T, CHP>(G, D, 0), stream, (const T*)q,
      (const T*)kc, (const T*)vc, pos, start, (T*)out, Hq, Hkv, S, D,
      scale);
}

// GM: the chunk's query rows rounded up to 1, 2, 4 or 8.
template <typename T, int CHP>
static int dispatch_rows(const void* q, const void* kc, const void* vc,
                         const int* pos, const int* start, void* out, int B,
                         int Hq, int Hkv, int S, int D, float scale,
                         cudaStream_t s) {
  const int g = Hq / Hkv;
  if (g == 1) return launch<T, CHP, 1>(q, kc, vc, pos, start, out, B, Hq, Hkv, S, D, scale, s);
  if (g == 2) return launch<T, CHP, 2>(q, kc, vc, pos, start, out, B, Hq, Hkv, S, D, scale, s);
  if (g <= 4) return launch<T, CHP, 4>(q, kc, vc, pos, start, out, B, Hq, Hkv, S, D, scale, s);
  return launch<T, CHP, 8>(q, kc, vc, pos, start, out, B, Hq, Hkv, S, D, scale, s);
}

// CHP: 16-byte chunks a row rounded up to a power of two; bf16 and f16
// rows hold 1 .. 32 chunks, f32 rows 2 .. 64, at head dims 8 .. 256.
template <typename T>
static int dispatch(const void* q, const void* kc, const void* vc,
                    const int* pos, const int* start, void* out, int B,
                    int Hq, int Hkv, int S, int D, float scale,
                    cudaStream_t s) {
  switch (decode_chunks_pow2(D, (int)sizeof(T))) {
    case 1: return dispatch_rows<T, 1>(q, kc, vc, pos, start, out, B, Hq, Hkv, S, D, scale, s);
    case 2: return dispatch_rows<T, 2>(q, kc, vc, pos, start, out, B, Hq, Hkv, S, D, scale, s);
    case 4: return dispatch_rows<T, 4>(q, kc, vc, pos, start, out, B, Hq, Hkv, S, D, scale, s);
    case 8: return dispatch_rows<T, 8>(q, kc, vc, pos, start, out, B, Hq, Hkv, S, D, scale, s);
    case 16: return dispatch_rows<T, 16>(q, kc, vc, pos, start, out, B, Hq, Hkv, S, D, scale, s);
    case 32: return dispatch_rows<T, 32>(q, kc, vc, pos, start, out, B, Hq, Hkv, S, D, scale, s);
    default: return dispatch_rows<T, 64>(q, kc, vc, pos, start, out, B, Hq, Hkv, S, D, scale, s);
  }
}

// q [B, Hq, D]; kcache/vcache [B, Hkv, S, D], 16-byte aligned; pos [B]
// int32; start [B] int32 or null (valid keys start[b]..pos[b]); out [B,
// Hq, D]; all of one dtype, f32, bf16 or f16.
extern "C" int decode_attention(const void* q, const void* kc, const void* vc,
                                const void* pos, const void* start, void* out,
                                int B, int Hq, int Hkv, int S, int D,
                                float scale, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!tc_aligned(kc) || !tc_aligned(vc)) return (int)cudaErrorInvalidValue;
  if (dtype == PT_BF16)
    return dispatch<__nv_bfloat16>(q, kc, vc, (const int*)pos,
                                   (const int*)start, out, B, Hq, Hkv, S, D,
                                   scale, s);
  if (dtype == PT_F16)
    return dispatch<__half>(q, kc, vc, (const int*)pos, (const int*)start,
                            out, B, Hq, Hkv, S, D, scale, s);
  if (dtype != PT_F32) return (int)cudaErrorInvalidValue;
  return dispatch<float>(q, kc, vc, (const int*)pos, (const int*)start, out,
                         B, Hq, Hkv, S, D, scale, s);
}
