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
// Masking, the -1e30 start and the 1e-30 clamp are decode_rows' own.
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
