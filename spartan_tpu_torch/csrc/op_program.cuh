// The op-program interpreter shared by the fused elementwise+sum kernel
// (fused_reduce.cu, K1) and the matrix product's epilogue (matmul.cu, K2).
//
// A program is a flat list of instructions made by the Python translators
// (backend/kernels/fused_reduce.py: plan for K1, backend/kernels/matmul.py:
// plan_epilogue for K2).  Registers hold doubles; each instruction rounds
// its operands and result to its own dtype (f64, f32, bf16, f16), so the
// program computes exactly what the plain torch evaluation of the chain
// computes, op by op.  Arithmetic uses the _rn intrinsics, which are never
// contracted into an FMA, and the build does not use fast math, so
// add/sub/mul/div/sqrt stay IEEE-rounded.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define SP_MAX_INSTR 64
#define SP_MAX_IMM 16

enum Op {
  OP_LOADX = 0,   // r[dst] = the element (K1: x[i]; K2: the f32 accumulator)
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

// The program's value for one element ``xi``; ``dscal`` holds the device
// scalars that LOADS reads (unused by programs without LOADS).
__device__ __forceinline__ double run_program(const Program& prog, double xi,
                                              const double* __restrict__ dscal) {
  double r[SP_MAX_INSTR];
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
  return r[prog.out];
}
