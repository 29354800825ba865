// Fused elementwise chain + full sum, for Hopper (sm_90a).
//
// Replaces spartan_tpu/backend/kernels/fused_reduce.py:fused_sum, the
// Pallas kernel that computes sum(f(x, *scalars)) in one read of x.
//
// What bounds it: the bytes of one read of x.  The chain is a handful of
// flops per element, far below the card's ~20 flops/byte balance point, so
// the kernel must read x exactly once and never write an intermediate.
//
// Design:
//  * The fused chain arrives as a flat op program (Program in
//    op_program.cuh, shared with matmul.cu's epilogue), made by the Python
//    translator in backend/kernels/fused_reduce.py.  Every thread
//    interprets the same program on its own element, so no warp diverges;
//    each instruction rounds to its own dtype, so the program computes
//    exactly what the plain torch evaluation of the chain computes.
//  * Pass 1: a grid-stride loop of at most 8 blocks per SM; each thread
//    accumulates in the accumulator dtype, each block reduces in shared
//    memory and writes one partial sum.  The ragged tail is handled by the
//    loop bound, so any length works.
//  * Pass 2: one block sums the partials in a fixed order.  Two passes and
//    no atomics make the result independent of launch timing (the TPU
//    kernel's single revisited accumulator relies on a sequential grid,
//    which the GPU does not have).
//
// The wrapper allocates the partials and the output, launches on PyTorch's
// current stream, and raises if the launch reports an error.

#include "op_program.cuh"

#define SP_THREADS 256

__device__ __forceinline__ double load_elem(const float* x, int64_t i) {
  return (double)x[i];
}
__device__ __forceinline__ double load_elem(const __nv_bfloat16* x, int64_t i) {
  return (double)__bfloat162float(x[i]);
}
__device__ __forceinline__ double load_elem(const __half* x, int64_t i) {
  return (double)__half2float(x[i]);
}

// Sum over the block; the result is valid in thread 0.
template <typename Acc>
__device__ __forceinline__ Acc block_sum(Acc v) {
  __shared__ Acc warp_sums[SP_THREADS / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = (lane < (int)(blockDim.x >> 5)) ? warp_sums[lane] : (Acc)0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

template <typename T, typename Acc>
__global__ void __launch_bounds__(SP_THREADS)
fused_sum_partials(const T* __restrict__ x, int64_t n, const Program prog,
                   const double* __restrict__ dscal,
                   Acc* __restrict__ partials) {
  Acc acc = (Acc)0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    acc += (Acc)run_program(prog, load_elem(x, i), dscal);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

template <typename Acc>
__global__ void __launch_bounds__(SP_THREADS)
sum_partials(const Acc* __restrict__ partials, int64_t m,
             Acc* __restrict__ out) {
  Acc acc = (Acc)0;
  for (int64_t i = threadIdx.x; i < m; i += blockDim.x) acc += partials[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) *out = acc;
}

template <typename T, typename Acc>
static int launch(const void* x, int64_t n, const Program& prog,
                  const void* dscal, void* partials, int64_t blocks,
                  void* out, cudaStream_t stream) {
  fused_sum_partials<T, Acc><<<(unsigned)blocks, SP_THREADS, 0, stream>>>(
      static_cast<const T*>(x), n, prog, static_cast<const double*>(dscal),
      static_cast<Acc*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<Acc><<<1, SP_THREADS, 0, stream>>>(
      static_cast<const Acc*>(partials), blocks, static_cast<Acc*>(out));
  return (int)cudaGetLastError();
}

extern "C" {

// in_dtype: 1 float32, 2 bfloat16, 3 float16; acc_dtype: 0 float64,
// 1 float32.  Returns cudaGetLastError() of the launches (0 on success).
int spartan_fused_sum(const void* x, int in_dtype, int64_t n,
                      const void* program, const void* dscal,
                      void* partials, int64_t blocks, void* out,
                      int acc_dtype, void* stream) {
  const Program& prog = *static_cast<const Program*>(program);
  if (prog.n < 1 || prog.n > SP_MAX_INSTR || blocks < 1 ||
      blocks > 0x7fffffff || n < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (acc_dtype == DT_F64) {
    if (in_dtype == DT_F32)
      return launch<float, double>(x, n, prog, dscal, partials, blocks, out, s);
    if (in_dtype == DT_BF16)
      return launch<__nv_bfloat16, double>(x, n, prog, dscal, partials, blocks, out, s);
    if (in_dtype == DT_F16)
      return launch<__half, double>(x, n, prog, dscal, partials, blocks, out, s);
  } else if (acc_dtype == DT_F32) {
    if (in_dtype == DT_F32)
      return launch<float, float>(x, n, prog, dscal, partials, blocks, out, s);
    if (in_dtype == DT_BF16)
      return launch<__nv_bfloat16, float>(x, n, prog, dscal, partials, blocks, out, s);
    if (in_dtype == DT_F16)
      return launch<__half, float>(x, n, prog, dscal, partials, blocks, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* spartan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
