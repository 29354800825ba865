// CSR sparse x dense matrix product, for Hopper (sm_90a).
//
//   Y[i, :] = sum_{p in [indptr[i], indptr[i+1])} data[p] * B[indices[p], :]
//
// Replaces spartan_tpu/backend/kernels/spmm_pallas.py:windowed_spmm_traced
// (K5a), the Pallas SpMM kernel.  On the TPU it needs a host-built pack
// (128-entry strips sharing one (128-row block, 1024-column window) pair),
// window DMAs of B transposed, and a one-hot matrix product through the MXU
// with f32 products split into bf16 hi/lo halves, all because Mosaic gathers
// only along 128 lanes and the TPU has no fast scatter.  A GPU warp reads any
// row of B directly and keeps its output row in registers, so the port reads
// the plain device CSR form (SparseArray.to_csr) and computes in f32
// throughout: no pack, no windows, no hi/lo split.  The TPU kernel's k <= 128
// launch limit (and the wrapper's 128-column strips) is Mosaic's too: one
// launch here takes any k up to 512.
//
// What bounds it: the bytes.  2*k flops per nonzero against 8 bytes of
// indices/data, plus indptr (8 bytes a row), B (m*k*4) read once and Y
// (n*k*4) written once: nnz*8 + 8*(n+1) + 4*k*(m+n) bytes at 3.35 TB/s
// (H100 SXM).  The rows of B gathered per nonzero (nnz*k*4 bytes) come from
// L2 when B fits in its 50 MB, as both ALS products' B do.
//
// Design:
//  * One warp owns one output row, 8 warps a block.  It walks its row 32
//    nonzeros at a time: each lane loads one (indices, data) pair, so the
//    loads are coalesced, and __shfl_sync broadcasts the pairs one by one.
//  * Lane l accumulates columns l + 32*j for j < J = ceil(k/32) rounded up to
//    a power of two (1..16, a template parameter, so acc[] is a register
//    array after unrolling), and its reads of a row of B are coalesced.
//  * Rounded f32 products (__fmul_rn) summed in a fixed order per column, no
//    atomics: the same input gives the same bits every run.  Offsets int64.
//  * A very long row stays on its one warp (load imbalance on skewed
//    matrices); splitting long rows is left for a faster version.
//
// The wrapper (backend/kernels/spmm.py) casts B to contiguous f32, allocates
// Y, launches on PyTorch's current stream and raises on a non-zero return.

#include <cuda_runtime.h>
#include <stdint.h>

#define SP_WARPS 8
#define SP_THREADS (32 * SP_WARPS)
#define SP_FULL 0xffffffffu

template <int J>
__global__ void __launch_bounds__(SP_THREADS)
spmm_csr_kernel(const int64_t* __restrict__ indptr,
                const int32_t* __restrict__ indices,
                const float* __restrict__ data, const float* __restrict__ B,
                float* __restrict__ Y, int64_t n, int k) {
  const int64_t row = (int64_t)blockIdx.x * SP_WARPS + (threadIdx.x >> 5);
  const int lane = (int)(threadIdx.x & 31);
  if (row >= n) return;  // row is the same on every lane of the warp
  float acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = 0.0f;
  const int64_t start = indptr[row];
  const int64_t end = indptr[row + 1];
  for (int64_t base = start; base < end; base += 32) {
    const int64_t p = base + lane;
    int col = 0;
    float a = 0.0f;
    if (p < end) {
      col = indices[p];
      a = data[p];
    }
    const int cnt = (int)(end - base < 32 ? end - base : 32);
    // unrolled so that several rows of B are in flight at once: on a long
    // row one warp otherwise waits out each gather in turn
#pragma unroll 4
    for (int t = 0; t < cnt; ++t) {
      const int c = __shfl_sync(SP_FULL, col, t);
      const float v = __shfl_sync(SP_FULL, a, t);
      const float* __restrict__ b = B + (int64_t)c * k;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int cc = lane + 32 * j;
        if (cc < k) acc[j] = __fadd_rn(acc[j], __fmul_rn(v, __ldg(b + cc)));
      }
    }
  }
  float* __restrict__ y = Y + row * (int64_t)k;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int cc = lane + 32 * j;
    if (cc < k) y[cc] = acc[j];
  }
}

template <int J>
static int launch(const void* indptr, const void* indices, const void* data,
                  const void* B, void* Y, int64_t n, int k,
                  cudaStream_t stream) {
  const int64_t blocks = (n + SP_WARPS - 1) / SP_WARPS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  spmm_csr_kernel<J><<<(unsigned)blocks, SP_THREADS, 0, stream>>>(
      static_cast<const int64_t*>(indptr), static_cast<const int32_t*>(indices),
      static_cast<const float*>(data), static_cast<const float*>(B),
      static_cast<float*>(Y), n, k);
  return (int)cudaGetLastError();
}

extern "C" {

// indptr int64 (n+1,), indices int32 (nnz,), data float32 (nnz,), B float32
// (m, k) row-major, Y float32 (n, k) row-major, all contiguous on one device;
// 1 <= k <= 512.  Returns cudaGetLastError() of the launch (0 on success).
int spartan_spmm_csr(const void* indptr, const void* indices, const void* data,
                     const void* B, void* Y, int64_t n, int k, void* stream) {
  if (n < 1 || k < 1 || k > 512) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (k + 31) / 32;
  if (words <= 1) return launch<1>(indptr, indices, data, B, Y, n, k, s);
  if (words <= 2) return launch<2>(indptr, indices, data, B, Y, n, k, s);
  if (words <= 4) return launch<4>(indptr, indices, data, B, Y, n, k, s);
  if (words <= 8) return launch<8>(indptr, indices, data, B, Y, n, k, s);
  return launch<16>(indptr, indices, data, B, Y, n, k, s);
}

const char* spartan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
