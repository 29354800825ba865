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
//  * The fused chain arrives as a flat op program (see Program below), made
//    by the Python translator in backend/kernels/fused_reduce.py.  Every
//    thread interprets the same program on its own element, so no warp
//    diverges.  Registers hold doubles; each instruction rounds its
//    operands and result to its own dtype (f64, f32, bf16, f16), so the
//    program computes exactly what the plain torch evaluation of the chain
//    computes, op by op.  Arithmetic uses the _rn intrinsics, which are
//    never contracted into an FMA, and the build does not use fast math,
//    so add/sub/mul/div/sqrt stay IEEE-rounded.
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

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define SP_MAX_INSTR 64
#define SP_MAX_IMM 16
#define SP_THREADS 256

enum Op {
  OP_LOADX = 0,   // r[dst] = x[i]
  OP_LOADS = 1,   // r[dst] = device scalar a
  OP_LOADI = 2,   // r[dst] = immediate a
  OP_ADD = 3,
  OP_SUB = 4,
  OP_MUL = 5,
  OP_DIV = 6,
  OP_NEG = 7,
  OP_ABS = 8,
  OP_SQUARE = 9,
  OP_SQRT = 10,
  OP_EXP = 11,
  OP_LOG = 12,
  OP_MAX = 13,
  OP_MIN = 14,
};

enum DType { DT_F64 = 0, DT_F32 = 1, DT_BF16 = 2, DT_F16 = 3 };

// Layout shared with the ctypes Structure in fused_reduce.py.
struct Program {
  int32_t n;                 // instruction count
  int32_t out;               // register holding the chain's value
  int8_t op[SP_MAX_INSTR];
  int8_t dt[SP_MAX_INSTR];   // dtype the instruction computes in
  int8_t dst[SP_MAX_INSTR];
  int8_t a[SP_MAX_INSTR];    // source register, or scalar/immediate slot
  int8_t b[SP_MAX_INSTR];
  double imm[SP_MAX_IMM];
};
static_assert(sizeof(Program) == 456, "Program layout changed");
static_assert(offsetof(Program, imm) == 328, "Program layout changed");

__device__ __forceinline__ double apply_f64(int op, double x, double y) {
  switch (op) {
    case OP_ADD: return __dadd_rn(x, y);
    case OP_SUB: return __dsub_rn(x, y);
    case OP_MUL: return __dmul_rn(x, y);
    case OP_DIV: return __ddiv_rn(x, y);
    case OP_NEG: return -x;
    case OP_ABS: return fabs(x);
    case OP_SQUARE: return __dmul_rn(x, x);
    case OP_SQRT: return __dsqrt_rn(x);
    case OP_EXP: return exp(x);
    case OP_LOG: return log(x);
    case OP_MAX: return (isnan(x) || isnan(y)) ? x + y : fmax(x, y);
    case OP_MIN: return (isnan(x) || isnan(y)) ? x + y : fmin(x, y);
    default: return 0.0;
  }
}

__device__ __forceinline__ float apply_f32(int op, float x, float y) {
  switch (op) {
    case OP_ADD: return __fadd_rn(x, y);
    case OP_SUB: return __fsub_rn(x, y);
    case OP_MUL: return __fmul_rn(x, y);
    case OP_DIV: return __fdiv_rn(x, y);
    case OP_NEG: return -x;
    case OP_ABS: return fabsf(x);
    case OP_SQUARE: return __fmul_rn(x, x);
    case OP_SQRT: return __fsqrt_rn(x);
    case OP_EXP: return expf(x);
    case OP_LOG: return logf(x);
    case OP_MAX: return (isnan(x) || isnan(y)) ? x + y : fmaxf(x, y);
    case OP_MIN: return (isnan(x) || isnan(y)) ? x + y : fminf(x, y);
    default: return 0.0f;
  }
}

__device__ __forceinline__ float round_half_type(int dt, float v) {
  if (dt == DT_BF16) return __bfloat162float(__float2bfloat16_rn(v));
  if (dt == DT_F16) return __half2float(__float2half_rn(v));
  return v;
}

// One instruction in its own dtype: 16-bit types compute in float and
// round the result back, as torch's elementwise ops on them do.
__device__ __forceinline__ double run_op(int op, int dt, double x, double y) {
  if (dt == DT_F64) return apply_f64(op, x, y);
  float fx = round_half_type(dt, (float)x);
  float fy = round_half_type(dt, (float)y);
  return (double)round_half_type(dt, apply_f32(op, fx, fy));
}

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
  double r[SP_MAX_INSTR];
  Acc acc = (Acc)0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const double xi = load_elem(x, i);
    for (int k = 0; k < prog.n; ++k) {
      const int op = prog.op[k];
      double v;
      if (op == OP_LOADX) {
        v = xi;
      } else if (op == OP_LOADS) {
        v = dscal[prog.a[k]];
      } else if (op == OP_LOADI) {
        v = prog.imm[prog.a[k]];
      } else {
        v = run_op(op, prog.dt[k], r[prog.a[k]], r[prog.b[k]]);
      }
      r[prog.dst[k]] = v;
    }
    acc += (Acc)r[prog.out];
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
