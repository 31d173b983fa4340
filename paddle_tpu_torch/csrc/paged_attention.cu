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
// Design: one block per (sequence, kv head, chunk of <= 8 heads of the GQA
// group; decode_common.cuh) carrying the chunk's query rows; the
// block walks keys 0..pos through the page table itself (the TPU grid's
// scalar-prefetched index map becomes an in-kernel table read), so cost
// is O(tokens in the cache), not O(pool).  Eight warps split the keys
// and keep several rows' loads in flight (decode_common.cuh), which is
// what a latency-bound gather of 2-byte rows needs; f32 online softmax.
// Free engine slots point at scratch page 0 with pos = 0 and compute one
// row of garbage that the host discards.  Later work: split the key
// range over more blocks (few sequences x kv heads do not fill 132 SMs),
// and the int8 pool tier.
#include "decode_common.cuh"

// Element offset of key t of one sequence's kv head: the table names the
// page, t % PS the slot in it.
struct PagedAddr {
  const int* row;
  long long page_elems;
  int hk, PS, D;
  __device__ __forceinline__ long long operator()(int t) const {
    return (long long)row[t / PS] * page_elems +
           ((long long)hk * PS + t % PS) * D;
  }
};

template <typename T, int NJ>
__global__ void __launch_bounds__(DEC_WARPS * 32) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ table,
    const int* __restrict__ pos, T* __restrict__ out, int Hq, int Hkv,
    int PS, int P, int D, float scale) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const int group = Hq / Hkv, g0 = blockIdx.z * DEC_MAXG;
  const int* row = table + (long long)b * P;
  const long long page_elems = (long long)Hkv * PS * D;
  const PagedAddr addr{row, page_elems, hk, PS, D};
  const long long qo = ((long long)b * Hq + (long long)hk * group + g0) * D;
  decode_rows<T, NJ>(q + qo, kp, vp, addr, 0, pos[b],
                     decode_chunk_rows(group, g0), D, scale, out + qo);
}

template <typename T, int NJ>
static int launch(const void* q, const void* kp, const void* vp,
                  const int* table, const int* pos, void* out, int B,
                  int Hq, int Hkv, int PS, int P, int D, float scale,
                  cudaStream_t stream) {
  const size_t smem = decode_smem_bytes(Hq / Hkv, D);
  auto kern = paged_attention_kernel<T, NJ>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  kern<<<dim3(Hkv, B, decode_chunks(Hq / Hkv)), DEC_WARPS * 32, smem,
         stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, table, pos, (T*)out, Hq, Hkv,
      PS, P, D, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const void* q, const void* kp, const void* vp,
                    const int* table, const int* pos, void* out, int B,
                    int Hq, int Hkv, int PS, int P, int D, float scale,
                    cudaStream_t s) {
  switch (pt_nj(D)) {
    case 1: return launch<T, 1>(q, kp, vp, table, pos, out, B, Hq, Hkv, PS, P, D, scale, s);
    case 2: return launch<T, 2>(q, kp, vp, table, pos, out, B, Hq, Hkv, PS, P, D, scale, s);
    case 4: return launch<T, 4>(q, kp, vp, table, pos, out, B, Hq, Hkv, PS, P, D, scale, s);
    default: return launch<T, 8>(q, kp, vp, table, pos, out, B, Hq, Hkv, PS, P, D, scale, s);
  }
}

// q [B, Hq, D]; k_pages/v_pages [num_pages, Hkv, PS, D]; table [B, P]
// int32; pos [B] int32 (valid keys 0..pos[b]); out [B, Hq, D].
extern "C" int paged_attention(const void* q, const void* kp, const void* vp,
                               const void* table, const void* pos, void* out,
                               int B, int Hq, int Hkv, int PS, int P, int D,
                               float scale, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == PT_BF16)
    return dispatch<__nv_bfloat16>(q, kp, vp, (const int*)table,
                                   (const int*)pos, out, B, Hq, Hkv, PS, P, D,
                                   scale, s);
  return dispatch<float>(q, kp, vp, (const int*)table, (const int*)pos, out,
                         B, Hq, Hkv, PS, P, D, scale, s);
}
