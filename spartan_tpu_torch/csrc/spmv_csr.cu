// CSR sparse matrix-vector product, for Hopper (sm_90a).
//
//   y[i] = sum_{p in [indptr[i], indptr[i+1])} data[p] * x[indices[p]]
//
// Replaces spartan_tpu/backend/kernels/spmv_pallas.py:windowed_spmv_traced
// (K3b), the Pallas kernel for matrices past the one-hot kernel's reach.
// On the TPU it needs a host-built pack (8x128 strips sharing 1024-element
// windows of x, scalar-prefetched window ids) because Mosaic cannot gather
// from all of x; a GPU thread can, so the port reads plain CSR instead.
// CSR and not the ELL kernel again: past that size graphs are large and
// their row lengths skewed, and padded ELL reads every row at the longest
// row's width (about 2.5x the bytes on a uniform degree-16 graph, far more
// on a power-law one).
//
// What bounds it: the bytes.  One multiply-add per nonzero for 8 bytes of
// indices/data, plus indptr (8 bytes a row), x and y; x (16.8 MB at 2^22
// float32 entries) fits in the 50 MB L2, so the gathers can stay near that
// floor: nnz*8 + 8*(n+1) + 4*(m + n) bytes at 3.35 TB/s (H100 SXM).
//
// Design:
//  * A group of G lanes (a power of two up to a warp, chosen by the wrapper
//    from nnz/n) owns one row; the lanes stride the row together, so their
//    loads of indices and data are consecutive.  A row longer than G is
//    looped over by the same group: correct at any length, slow only for
//    very long rows.
//  * Rounded f32 products (__fmul_rn) summed per lane, then a
//    __shfl_down_sync tree inside the group; one store per row, no atomics,
//    so the result is the same on every run.
//
// The wrapper (backend/kernels/spmv.py) allocates y, launches on PyTorch's
// current stream and raises on a non-zero return.

#include <cuda_runtime.h>
#include <stdint.h>

#define SP_THREADS 256

template <int G>
__global__ void __launch_bounds__(SP_THREADS)
spmv_csr_kernel(const int64_t* __restrict__ indptr,
                const int32_t* __restrict__ indices,
                const float* __restrict__ data, const float* __restrict__ x,
                float* __restrict__ y, int64_t n) {
  const int64_t t = (int64_t)blockIdx.x * SP_THREADS + threadIdx.x;
  const int64_t row = t / G;
  const int lane = (int)(threadIdx.x & (G - 1));
  float acc = 0.0f;
  if (row < n) {
    const int64_t end = indptr[row + 1];
    for (int64_t p = indptr[row] + lane; p < end; p += G) {
      acc = __fadd_rn(acc, __fmul_rn(data[p], __ldg(x + indices[p])));
    }
  }
  // every lane of the warp reaches the shuffles (rows past n carry 0)
  for (int o = G / 2; o > 0; o >>= 1) {
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, o, G));
  }
  if (lane == 0 && row < n) y[row] = acc;
}

template <int G>
static int launch(const void* indptr, const void* indices, const void* data,
                  const void* x, void* y, int64_t n, cudaStream_t stream) {
  const int64_t threads = n * G;
  const int64_t blocks = (threads + SP_THREADS - 1) / SP_THREADS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  spmv_csr_kernel<G><<<(unsigned)blocks, SP_THREADS, 0, stream>>>(
      static_cast<const int64_t*>(indptr), static_cast<const int32_t*>(indices),
      static_cast<const float*>(data), static_cast<const float*>(x),
      static_cast<float*>(y), n);
  return (int)cudaGetLastError();
}

extern "C" {

// indptr int64 (n+1,), indices int32 (nnz,), data float32 (nnz,), x float32
// (m,), y float32 (n,), all contiguous on one device; group is the lanes
// per row (1..32, a power of two).  Returns cudaGetLastError() of the
// launch (0 on success).
int spartan_spmv_csr(const void* indptr, const void* indices,
                     const void* data, const void* x, void* y, int64_t n,
                     int group, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 1: return launch<1>(indptr, indices, data, x, y, n, s);
    case 2: return launch<2>(indptr, indices, data, x, y, n, s);
    case 4: return launch<4>(indptr, indices, data, x, y, n, s);
    case 8: return launch<8>(indptr, indices, data, x, y, n, s);
    case 16: return launch<16>(indptr, indices, data, x, y, n, s);
    case 32: return launch<32>(indptr, indices, data, x, y, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* spartan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
