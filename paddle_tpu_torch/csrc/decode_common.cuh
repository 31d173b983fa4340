// One-query-token attention over a KV sequence, shared by the paged
// (paged_attention.cu) and dense (decode_attention.cu) decode kernels.
//
// One block serves one (sequence, kv head, chunk of at most DEC_MAXG query
// heads of the head's GQA group) and carries the chunk's G query rows, so
// each K/V row is read from device memory once per chunk: once per group
// for groups of up to DEC_MAXG, ceil(group / DEC_MAXG) times for larger
// ones (a first version; sharing one read among all chunks would need the
// group's rows in registers or shared memory).  DEC_WARPS warps split the
// keys: warp w takes chunks of
// DEC_UNROLL consecutive keys, loads all of a chunk's K and V rows before
// using any (DEC_UNROLL loads in flight per warp), and keeps its own f32
// online-softmax state (m, l, acc) per query row.  The warps' states are
// merged through shared memory at the end.  A lane owns head_dim
// elements d = lane + 32 * j; a q.k dot is a register FMA chain and one
// warp reduction.
#pragma once

#include "common.cuh"

#define DEC_WARPS 8
#define DEC_UNROLL 4
#define DEC_MAXG 8

// addr(t) -> element offset of key/value row t in the K and V arrays.
template <typename T, int NJ, typename Addr>
__device__ __forceinline__ void decode_rows(
    const T* __restrict__ q, const T* __restrict__ kbase,
    const T* __restrict__ vbase, Addr addr, int t0, int t1, int G, int D,
    float scale, T* __restrict__ out) {
  extern __shared__ float dsm[];
  float* sm_m = dsm;                          // [DEC_WARPS][G]
  float* sm_l = sm_m + DEC_WARPS * G;         // [DEC_WARPS][G]
  float* sm_acc = sm_l + DEC_WARPS * G;       // [DEC_WARPS][G][D]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float qr[DEC_MAXG][NJ], acc[DEC_MAXG][NJ], m[DEC_MAXG], l[DEC_MAXG];
#pragma unroll
  for (int g = 0; g < DEC_MAXG; ++g) {
    m[g] = PT_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + 32 * j;
      qr[g][j] = (g < G && d < D) ? to_f(q[g * D + d]) * scale : 0.f;
      acc[g][j] = 0.f;
    }
  }

  for (int base = t0 + warp * DEC_UNROLL; base <= t1;
       base += DEC_WARPS * DEC_UNROLL) {
    float kr[DEC_UNROLL][NJ], vr[DEC_UNROLL][NJ];
#pragma unroll
    for (int u = 0; u < DEC_UNROLL; ++u) {
      const bool ok = base + u <= t1;
      const long long off = ok ? addr(base + u) : 0;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = lane + 32 * j;
        kr[u][j] = (ok && d < D) ? to_f(kbase[off + d]) : 0.f;
        vr[u][j] = (ok && d < D) ? to_f(vbase[off + d]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < DEC_UNROLL; ++u) {
      if (base + u > t1) break;
#pragma unroll
      for (int g = 0; g < DEC_MAXG; ++g) {
        if (g >= G) break;
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) s += qr[g][j] * kr[u][j];
        s = warp_sum(s);
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = alpha * l[g] + p;
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[g][j] = acc[g][j] * alpha + p * vr[u][j];
        m[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < DEC_MAXG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      sm_m[warp * G + g] = m[g];
      sm_l[warp * G + g] = l[g];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + 32 * j;
      if (d < D) sm_acc[(warp * G + g) * D + d] = acc[g][j];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    float mx = PT_NEG_INF;
    for (int w = 0; w < DEC_WARPS; ++w) mx = fmaxf(mx, sm_m[w * G + g]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float c = expf(sm_m[w * G + g] - mx);
      lsum += sm_l[w * G + g] * c;
      a += sm_acc[(w * G + g) * D + d] * c;
    }
    out[g * D + d] = from_f<T>(a / fmaxf(lsum, PT_L_MIN));
  }
}

// Query heads of the chunk a block serves (the grid's z index picks the
// chunk of the group): the group's heads g0 .. g0 + rows - 1.
static inline int decode_chunks(int group) {
  return (group + DEC_MAXG - 1) / DEC_MAXG;
}

__device__ __forceinline__ int decode_chunk_rows(int group, int g0) {
  return min(DEC_MAXG, group - g0);
}

static inline size_t decode_smem_bytes(int group, int D) {
  const int G = group < DEC_MAXG ? group : DEC_MAXG;
  return sizeof(float) * (size_t)DEC_WARPS * G * (2 + D);
}
