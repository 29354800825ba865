// Padded-ELL sparse matrix-vector product, for Hopper (sm_90a).
//
//   y[i] = sum_j vals[i, j] * x[cols[i, j]]      cols/vals (n, k), x (m,)
//
// Replaces spartan_tpu/backend/kernels/spmv_pallas.py:spmv (K3a), the
// Pallas kernel that reads x through the MXU as an on-the-fly one-hot
// matrix because the TPU has no fast unstructured gather.  A GPU thread
// can gather x[c] directly, so none of that carries over.
//
// What bounds it: the bytes.  Each entry is one multiply-add for 8 bytes of
// cols/vals read once, plus the gathers of x; at the main path's widths x
// (at most 32768 floats when SpMVExpr picks this kernel) lives in L2, so the
// floor is n*k*8 + 4*(m + n) bytes at 3.35 TB/s (H100 SXM).
//
// Design:
//  * A group of G = min(32, next_pow2(k)) consecutive lanes owns one row;
//    lane l reads entries l, l+G, ... of the row, so a group's loads of
//    cols and vals are consecutive addresses and coalesce.
//  * Products are rounded f32 multiplies (__fmul_rn, never contracted into
//    an FMA), summed in registers per lane, then a __shfl_down_sync tree
//    inside the group.  One store per row, no atomics: the order of every
//    sum is fixed, so each run gives the same bits.
//  * Pad entries (col 0, val 0) are multiplied like any other, as the
//    reference does (0 * x[0]): a non-finite x[0] gives NaN on both sides.
//
// The wrapper (backend/kernels/spmv.py) casts bf16/f16 operands to f32,
// allocates y, launches on PyTorch's current stream and raises on a
// non-zero return.

#include <cuda_runtime.h>
#include <stdint.h>

#define SP_THREADS 256

template <int G>
__global__ void __launch_bounds__(SP_THREADS)
spmv_ell_kernel(const int32_t* __restrict__ cols,
                const float* __restrict__ vals,
                const float* __restrict__ x, float* __restrict__ y,
                int64_t n, int64_t k) {
  const int64_t t = (int64_t)blockIdx.x * SP_THREADS + threadIdx.x;
  const int64_t row = t / G;
  const int lane = (int)(threadIdx.x & (G - 1));
  float acc = 0.0f;
  if (row < n) {
    const int64_t base = row * k;
    for (int64_t j = lane; j < k; j += G) {
      acc = __fadd_rn(acc, __fmul_rn(vals[base + j], __ldg(x + cols[base + j])));
    }
  }
  // every lane of the warp reaches the shuffles (rows past n carry 0)
  for (int o = G / 2; o > 0; o >>= 1) {
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, o, G));
  }
  if (lane == 0 && row < n) y[row] = acc;
}

template <int G>
static int launch(const void* cols, const void* vals, const void* x, void* y,
                  int64_t n, int64_t k, cudaStream_t stream) {
  const int64_t threads = n * G;
  const int64_t blocks = (threads + SP_THREADS - 1) / SP_THREADS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  spmv_ell_kernel<G><<<(unsigned)blocks, SP_THREADS, 0, stream>>>(
      static_cast<const int32_t*>(cols), static_cast<const float*>(vals),
      static_cast<const float*>(x), static_cast<float*>(y), n, k);
  return (int)cudaGetLastError();
}

extern "C" {

// cols int32 (n, k), vals float32 (n, k), x float32 (m,), y float32 (n,),
// all contiguous on one device; group is the lanes per row (1..32, a power
// of two).  Returns cudaGetLastError() of the launch (0 on success).
int spartan_spmv_ell(const void* cols, const void* vals, const void* x,
                     void* y, int64_t n, int64_t k, int group, void* stream) {
  if (n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 1: return launch<1>(cols, vals, x, y, n, k, s);
    case 2: return launch<2>(cols, vals, x, y, n, k, s);
    case 4: return launch<4>(cols, vals, x, y, n, k, s);
    case 8: return launch<8>(cols, vals, x, y, n, k, s);
    case 16: return launch<16>(cols, vals, x, y, n, k, s);
    case 32: return launch<32>(cols, vals, x, y, n, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* spartan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
