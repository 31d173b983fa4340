// Relayout between the native [B, S, H, D] and the head-major [B, H, S, D]
// layouts, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_to_hm` (:1141,
// pallas_call :1148, kernel `_relayout_kernel_to_hm` :1110) and
// `_from_hm` (:1161, pallas_call :1167, kernel `_relayout_kernel_from_hm`
// :1123), each the other's adjoint (custom VJPs :1179-1196).  The `kv`
// flash layout tier (`_flash_core_kv` :1070) moves Q and dO to head-major
// through the first and O and dQ back through the second.
//
// Bound on this card: bytes.  Each element is read once and written once
// (2 * B * S * H * D * itemsize bytes) and no arithmetic is done.
//
// Design: each D-row is contiguous on both sides, so the relayout is a
// copy of whole rows, not a transpose of elements: one thread per 16-byte
// vector of a row (4- or 2-byte units when a row or a pointer is not
// 16-byte aligned), neighbouring threads on neighbouring vectors of a row
// and then on the next row of the same head, so loads and stores are both
// coalesced and no shared-memory tile is needed.  The grid's y index is
// the (batch, head) pair, its x index walks that head's S * (row vectors).
// The copy does not look at the values, so one kernel per unit width
// serves f32, bf16 and f16 alike (a 16-bit row moves as a bf16 row does,
// with no conversion).  CUDA rather than Triton: this is a strided
// copy that Triton would serve as well, but the port builds every kernel
// through the one nvcc -> C interface -> ctypes route.
#include <cuda_runtime.h>
#include <stdint.h>

// V is the copy unit (uint4, uint32_t or uint16_t); nv units per row.
template <typename V, bool TO_HM>
__global__ void __launch_bounds__(256) relayout_kernel(
    const V* __restrict__ x, V* __restrict__ y, int S, int H, int nv,
    int BH) {
  const long long n = (long long)S * nv;
  for (int bh = blockIdx.y; bh < BH; bh += gridDim.y) {
    const int b = bh / H, h = bh % H;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += (long long)gridDim.x * blockDim.x) {
      const long long s = i / nv, v = i % nv;
      const long long hm = ((long long)bh * S + s) * nv + v;
      const long long nat = (((long long)b * S + s) * H + h) * nv + v;
      if (TO_HM)
        y[hm] = __ldg(x + nat);
      else
        y[nat] = __ldg(x + hm);
    }
  }
}

template <typename V, bool TO_HM>
static int launch(const void* x, void* y, int B, int S, int H,
                  long long row_bytes, cudaStream_t stream) {
  const int nv = (int)(row_bytes / (long long)sizeof(V));
  const long long n = (long long)S * nv;
  const int threads = 256;
  long long bx = (n + threads - 1) / threads;
  if (bx > 4096) bx = 4096;
  const int BH = B * H;
  const int by = BH < 65535 ? BH : 65535;
  relayout_kernel<V, TO_HM><<<dim3((unsigned)bx, (unsigned)by), threads, 0,
                              stream>>>((const V*)x, (V*)y, S, H, nv, BH);
  return (int)cudaGetLastError();
}

template <bool TO_HM>
static int relayout(const void* x, void* y, int B, int S, int H,
                    int row_bytes, cudaStream_t s) {
  if (B == 0 || S == 0 || H == 0 || row_bytes == 0) return 0;
  const uintptr_t a = (uintptr_t)x | (uintptr_t)y | (uintptr_t)row_bytes;
  if (a % 16 == 0) return launch<uint4, TO_HM>(x, y, B, S, H, row_bytes, s);
  if (a % 4 == 0) return launch<uint32_t, TO_HM>(x, y, B, S, H, row_bytes, s);
  return launch<uint16_t, TO_HM>(x, y, B, S, H, row_bytes, s);
}

// x [B, S, H, D] -> y [B, H, S, D]; row_bytes = D * itemsize (even).
extern "C" int relayout_to_hm(const void* x, void* y, int B, int S, int H,
                              int row_bytes, void* stream) {
  return relayout<true>(x, y, B, S, H, row_bytes, (cudaStream_t)stream);
}

// x [B, H, S, D] -> y [B, S, H, D].
extern "C" int relayout_from_hm(const void* x, void* y, int B, int S, int H,
                                int row_bytes, void* stream) {
  return relayout<false>(x, y, B, S, H, row_bytes, (cudaStream_t)stream);
}
