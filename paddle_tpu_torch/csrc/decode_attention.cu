// Dense KV-cache decode attention for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/decode_attention.py `_decode_kernel`
// (:42), launched by `decode_attention` (:82) — the decode step of
// greedy `generate()` over the fixed-capacity dense caches.
//
// Bound on this card: device-memory bytes.  A step reads each row's K
// and V from `start` to `pos` once and does 4 flops per element read.
//
// Design: one block per (row, kv head, chunk of <= 8 heads of the GQA
// group; decode_common.cuh) carrying the chunk's query rows; the block
// walks only keys start..pos (left-pad slots and the unwritten cache
// tail are never read), so a step costs O(tokens in the cache), not
// O(capacity).  Eight warps split the keys with several loads in flight
// each and merge their f32 online-softmax states through shared memory
// (decode_common.cuh).  Later work: split long key ranges over more
// blocks when batch x kv heads is small.
#include "decode_common.cuh"

// Element offset of key t of one (row, kv head) cache.
struct DenseAddr {
  long long base;
  int D;
  __device__ __forceinline__ long long operator()(int t) const {
    return base + (long long)t * D;
  }
};

template <typename T, int NJ>
__global__ void __launch_bounds__(DEC_WARPS * 32) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, const int* __restrict__ pos,
    const int* __restrict__ start, T* __restrict__ out, int Hq, int Hkv,
    int S, int D, float scale) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const int group = Hq / Hkv, g0 = blockIdx.z * DEC_MAXG;
  const long long base = ((long long)b * Hkv + hk) * S * D;
  const DenseAddr addr{base, D};
  const int t0 = start ? start[b] : 0;
  const long long qo = ((long long)b * Hq + (long long)hk * group + g0) * D;
  decode_rows<T, NJ>(q + qo, kc, vc, addr, t0, pos[b],
                     decode_chunk_rows(group, g0), D, scale, out + qo);
}

template <typename T, int NJ>
static int launch(const void* q, const void* kc, const void* vc,
                  const int* pos, const int* start, void* out, int B, int Hq,
                  int Hkv, int S, int D, float scale, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes(Hq / Hkv, D);
  auto kern = decode_attention_kernel<T, NJ>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  kern<<<dim3(Hkv, B, decode_chunks(Hq / Hkv)), DEC_WARPS * 32, smem,
         stream>>>(
      (const T*)q, (const T*)kc, (const T*)vc, pos, start, (T*)out, Hq, Hkv,
      S, D, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const void* q, const void* kc, const void* vc,
                    const int* pos, const int* start, void* out, int B,
                    int Hq, int Hkv, int S, int D, float scale,
                    cudaStream_t s) {
  switch (pt_nj(D)) {
    case 1: return launch<T, 1>(q, kc, vc, pos, start, out, B, Hq, Hkv, S, D, scale, s);
    case 2: return launch<T, 2>(q, kc, vc, pos, start, out, B, Hq, Hkv, S, D, scale, s);
    case 4: return launch<T, 4>(q, kc, vc, pos, start, out, B, Hq, Hkv, S, D, scale, s);
    default: return launch<T, 8>(q, kc, vc, pos, start, out, B, Hq, Hkv, S, D, scale, s);
  }
}

// q [B, Hq, D]; kcache/vcache [B, Hkv, S, D]; pos [B] int32; start [B]
// int32 or null (valid keys start[b]..pos[b]); out [B, Hq, D].
extern "C" int decode_attention(const void* q, const void* kc, const void* vc,
                                const void* pos, const void* start, void* out,
                                int B, int Hq, int Hkv, int S, int D,
                                float scale, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == PT_BF16)
    return dispatch<__nv_bfloat16>(q, kc, vc, (const int*)pos,
                                   (const int*)start, out, B, Hq, Hkv, S, D,
                                   scale, s);
  return dispatch<float>(q, kc, vc, (const int*)pos, (const int*)start, out,
                         B, Hq, Hkv, S, D, scale, s);
}
