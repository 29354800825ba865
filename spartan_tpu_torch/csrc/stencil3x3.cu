// 'SAME' zero-boundary 3x3 correlation of an (n, m) array, for Hopper
// (sm_90a).
//
// Replaces spartan_tpu/backend/kernels/stencil_pallas.py:stencil3x3 (K4).
// On the TPU it pads x by (1, 7) rows and (1, 127) columns in a separate
// pass, so that Mosaic's DMA slabs land on its (8, 128) tile grid, and
// double-buffers slab DMAs into VMEM; shapes off that grid take an XLA
// fallback.  Here a block reads its tile's halo straight from x, treating
// cells outside the array as zero, so no pad pass, any n >= 1 and m >= 1,
// and no fallback.  Device code, rounding, bound and design: stencil3x3.cuh.
//
// The wrapper (backend/kernels/stencil.py) makes x contiguous, allocates
// out, launches on PyTorch's current stream and raises on a non-zero return.

#include "stencil3x3.cuh"

template <typename T>
static int run(const void* x, void* out, int64_t n, int64_t m,
               const StencilCoeffs& c, cudaStream_t s) {
  return st_launch<T, false>(static_cast<const T*>(x), m, 0, n, 0, m,
                             nullptr, static_cast<T*>(out), m, n, m, c, s);
}

extern "C" {

// x and out: contiguous (n, m) arrays of one dtype on one device (dtype 0
// float32, 1 bfloat16, 2 float16); coeffs: nine host floats, row-major;
// applied: bit k set if tap k is applied.  Returns cudaGetLastError() of
// the launch (0 on success).
int spartan_stencil3x3(const void* x, void* out, int64_t n, int64_t m,
                       int dtype, const float* coeffs, int applied,
                       void* stream) {
  if (n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const StencilCoeffs c = st_coeffs(coeffs, applied);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return run<float>(x, out, n, m, c, s);
    case 1: return run<__nv_bfloat16>(x, out, n, m, c, s);
    case 2: return run<__half>(x, out, n, m, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* spartan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
