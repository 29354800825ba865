// The op-program interpreter shared by the fused elementwise+sum kernel
// (fused_reduce.cu, K1) and the matrix product's epilogue (matmul.cu, K2).
//
// A program is a flat list of instructions made by the Python translators
// (backend/kernels/fused_reduce.py: plan for K1, backend/kernels/matmul.py:
// plan_epilogue for K2), with its registers already allocated by liveness
// (fused_reduce.allocate) onto SP_NREG registers.  Each instruction rounds
// its operands and result to its own dtype (f64, f32, bf16, f16), so the
// program computes exactly what the plain torch evaluation of the chain
// computes, op by op.  Arithmetic uses the _rn intrinsics, which are never
// contracted into an FMA, and the build does not use fast math, so
// add/sub/mul/div/sqrt stay IEEE-rounded.
//
// What bounds an interpreter on this card: not the arithmetic but what
// surrounds it.  A register file indexed at run time lives in local memory
// (a load and a store of device memory a use), and decoding an instruction
// costs several instructions of its own.  The design answers both:
//  * The register file is F x V values held in machine registers, F = 1,
//    2, 4 or 8 (SP_NREG), the fewest that hold the program's registers, a
//    template parameter picked before the launch: every access is an
//    unrolled select over the F registers with constant indices, so
//    nothing is indexed at run time (the kernels report a 0-byte stack
//    frame), and an access costs F - 1 selects a value.  Immediates and
//    device scalars take no register: the planner folds them into the
//    instructions that read them, which read one value for all elements.
//  * Each decoded instruction runs over a vector of V elements (the switch
//    on the opcode sits outside the loop over them), so its decoding is paid
//    once for V elements.
//  * A program without a float64 instruction runs in float registers (R =
//    float, chosen by the planner as a template parameter): immediates and
//    device scalars are rounded to float once, at their load, which gives
//    the bits of double registers, since every value such a program
//    computes is a float.  A program with a float64 instruction keeps double
//    registers and converts an operand at each use, as torch does.
// The kernels unpack the program into shared memory once a block (one word
// an instruction, the immediates in R), so each decode is one read there at
// the same address in every thread.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define SP_MAX_INSTR 64
#define SP_MAX_IMM 16
#define SP_MAX_DSCAL 16   // fused_reduce.MAX_DEV_SCALARS
#define SP_NREG 8         // fused_reduce.N_REGS
#define SP_SCAL (SP_MAX_IMM + SP_MAX_DSCAL)

// A compute instruction's operand a or b is a register (0 .. SP_NREG - 1)
// or, when negative, a scalar folded into it (fused_reduce.fold_scalars):
// -1 - k is immediate k, -1 - SP_MAX_IMM - k device scalar k.
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
  OP_FLOORDIV = 15,  // torch.floor_divide (NumPy's npy_divmod)
  OP_MOD = 16,       // torch.remainder: the sign of the divisor
  OP_POW = 17,
  OP_LAST = OP_POW,
};

enum DType { DT_F64 = 0, DT_F32 = 1, DT_BF16 = 2, DT_F16 = 3 };

// Layout shared with the ctypes Structure in fused_reduce.py.
struct Program {
  int32_t n;                 // instruction count
  int32_t out;               // register holding the chain's value
  int8_t op[SP_MAX_INSTR];
  int8_t dt[SP_MAX_INSTR];   // dtype the instruction computes in
  int8_t dst[SP_MAX_INSTR];
  int8_t a[SP_MAX_INSTR];    // source register or scalar, or a load's slot
  int8_t b[SP_MAX_INSTR];
  double imm[SP_MAX_IMM];
};
static_assert(sizeof(Program) == 456, "Program layout changed");
static_assert(offsetof(Program, imm) == 328, "Program layout changed");

inline bool operand_fits(int code) {
  return code >= -SP_SCAL && code < SP_NREG;
}

// True when every register is below SP_NREG, every slot and scalar in its
// table and the program in bounds; a program that fails it is refused
// before the launch.
inline bool program_fits(const Program& p) {
  if (p.n < 0 || p.n > SP_MAX_INSTR || (p.n > 0 && (p.out < 0 ||
                                                    p.out >= SP_NREG)))
    return false;
  for (int k = 0; k < p.n; ++k) {
    if (p.op[k] < OP_LOADX || p.op[k] > OP_LAST || p.dst[k] < 0 ||
        p.dst[k] >= SP_NREG || p.dt[k] < DT_F64 || p.dt[k] > DT_F16)
      return false;
    if ((p.op[k] == OP_LOADI && (p.a[k] < 0 || p.a[k] >= SP_MAX_IMM)) ||
        (p.op[k] == OP_LOADS && (p.a[k] < 0 || p.a[k] >= SP_MAX_DSCAL)))
      return false;
    if (p.op[k] >= OP_ADD && (!operand_fits(p.a[k]) || !operand_fits(p.b[k])))
      return false;
  }
  return true;
}

// The device scalars ``p`` reads (one more than the highest slot).
inline int program_dev_scalars(const Program& p) {
  int n = 0;
  for (int k = 0; k < p.n; ++k) {
    int slot = -1;
    if (p.op[k] == OP_LOADS) slot = p.a[k];
    if (p.op[k] >= OP_ADD) {
      if (p.a[k] < -SP_MAX_IMM) slot = -1 - SP_MAX_IMM - p.a[k];
      if (p.b[k] < -SP_MAX_IMM && -1 - SP_MAX_IMM - p.b[k] > slot)
        slot = -1 - SP_MAX_IMM - p.b[k];
    }
    if (slot + 1 > n) n = slot + 1;
  }
  return n;
}

// True when no instruction computes in float64: the program may run in
// float registers.
inline bool program_is_float(const Program& p) {
  for (int k = 0; k < p.n; ++k)
    if (p.op[k] >= OP_ADD && p.dt[k] == DT_F64) return false;
  return true;
}

// True when the program holds floor division, remainder or power: it runs
// in the kernels instantiated with Rare = true.
inline bool program_has_rare(const Program& p) {
  for (int k = 0; k < p.n; ++k)
    if (p.op[k] >= OP_FLOORDIV && p.op[k] <= OP_LAST) return true;
  return false;
}

namespace sp_prog {

// Every opcode from OP_MAX on is binary (program_fits bounds them).
__device__ __forceinline__ bool is_binary(int op) {
  return op <= OP_DIV || op >= OP_MAX;
}

// A program as the kernels read it from shared memory: each instruction
// packed into one word (op | dt << 6 | dst << 8 | b << 16 | a << 24: six
// bits of opcode, two of dtype, a and b as signed bytes;
// fused_reduce.pack_instruction mirrors it), the scalars (immediates, then
// device scalars) already rounded to the register type R.
template <typename R>
struct Decoded {
  uint32_t code[SP_MAX_INSTR];
  R scal[SP_SCAL];
  int32_t n, out;
};

// Fills ``dst`` (shared) from the __grid_constant__ kernel parameter
// ``src`` and the first ``n_dscal`` device scalars with the block's
// threads, then a barrier.
template <typename R>
__device__ __forceinline__ void decode(const Program& src,
                                       const double* __restrict__ dscal,
                                       int n_dscal, Decoded<R>& dst) {
  for (int k = threadIdx.x; k < src.n; k += blockDim.x)
    dst.code[k] = (uint32_t)src.op[k] | ((uint32_t)src.dt[k] << 6) |
                  ((uint32_t)src.dst[k] << 8) |
                  ((uint32_t)(uint8_t)src.b[k] << 16) |
                  ((uint32_t)(uint8_t)src.a[k] << 24);
  for (int k = threadIdx.x; k < SP_MAX_IMM; k += blockDim.x)
    dst.scal[k] = (R)src.imm[k];
  for (int k = threadIdx.x; k < n_dscal; k += blockDim.x)
    dst.scal[SP_MAX_IMM + k] = (R)dscal[k];
  if (threadIdx.x == 0) {
    dst.n = src.n;
    dst.out = src.out;
  }
  __syncthreads();
}

// torch's floor_divide and remainder of floating values (c10's
// div_floor_floating, NumPy's npy_divmod): fmod, the sign fix, floor, the
// 0.5 correction and copysign for a zero quotient; x / 0 is the IEEE
// quotient.  Each step is IEEE-rounded, as torch's build computes it.
// These and powf are the "rare" ops: only the kernels instantiated with
// Rare = true compile them (program_has_rare), in float registers only
// (the planner refuses a rare op in a program with a float64
// instruction), so a program without them runs the code it ran before
// they existed, with its registers and time.
__device__ __forceinline__ float floordiv_f(float a, float b) {
  if (b == 0.0f) return __fdiv_rn(a, b);
  const float mod = fmodf(a, b);
  float div = __fdiv_rn(__fsub_rn(a, mod), b);
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) div = __fsub_rn(div, 1.0f);
  if (div == 0.0f) return copysignf(0.0f, __fdiv_rn(a, b));
  float q = floorf(div);
  if (__fsub_rn(div, q) > 0.5f) q = __fadd_rn(q, 1.0f);
  return q;
}

__device__ __forceinline__ float mod_f(float a, float b) {
  const float mod = fmodf(a, b);
  return (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) ? __fadd_rn(mod, b)
                                                       : mod;
}

// One opcode over V elements; the switch is outside the element loop.
#define SP_EACH1(expr)                                    \
  _Pragma("unroll") for (int v = 0; v < V; ++v) {         \
    const auto p = x[v];                                  \
    t[v] = (expr);                                        \
  }                                                       \
  break;
#define SP_EACH2(expr)                                    \
  _Pragma("unroll") for (int v = 0; v < V; ++v) {         \
    const auto p = x[v];                                  \
    const auto q = y[v];                                  \
    t[v] = (expr);                                        \
  }                                                       \
  break;

template <int V>
__device__ __forceinline__ void apply_rare(int op, const float (&x)[V],
                                           const float (&y)[V],
                                           float (&t)[V]) {
  switch (op) {
    case OP_FLOORDIV: SP_EACH2(floordiv_f(p, q))
    case OP_MOD: SP_EACH2(mod_f(p, q))
    case OP_POW: SP_EACH2(powf(p, q))
    default: SP_EACH1(0.0f)
  }
}

template <int V, bool Rare>
__device__ __forceinline__ void apply_vec(int op, const float (&x)[V],
                                          const float (&y)[V], float (&t)[V]) {
  switch (op) {
    case OP_ADD: SP_EACH2(__fadd_rn(p, q))
    case OP_SUB: SP_EACH2(__fsub_rn(p, q))
    case OP_MUL: SP_EACH2(__fmul_rn(p, q))
    case OP_DIV: SP_EACH2(__fdiv_rn(p, q))
    case OP_NEG: SP_EACH1(-p)
    case OP_ABS: SP_EACH1(fabsf(p))
    case OP_SQUARE: SP_EACH1(__fmul_rn(p, p))
    case OP_SQRT: SP_EACH1(__fsqrt_rn(p))
    case OP_EXP: SP_EACH1(expf(p))
    case OP_LOG: SP_EACH1(logf(p))
    case OP_MAX: SP_EACH2((isnan(p) || isnan(q)) ? p + q : fmaxf(p, q))
    case OP_MIN: SP_EACH2((isnan(p) || isnan(q)) ? p + q : fminf(p, q))
    default:
      if (Rare) {
        apply_rare<V>(op, x, y, t);
        break;
      }
      SP_EACH1(0.0f)
  }
}

// Double registers take no rare op: the planner refuses one there.
template <int V, bool Rare>
__device__ __forceinline__ void apply_vec(int op, const double (&x)[V],
                                          const double (&y)[V],
                                          double (&t)[V]) {
  switch (op) {
    case OP_ADD: SP_EACH2(__dadd_rn(p, q))
    case OP_SUB: SP_EACH2(__dsub_rn(p, q))
    case OP_MUL: SP_EACH2(__dmul_rn(p, q))
    case OP_DIV: SP_EACH2(__ddiv_rn(p, q))
    case OP_NEG: SP_EACH1(-p)
    case OP_ABS: SP_EACH1(fabs(p))
    case OP_SQUARE: SP_EACH1(__dmul_rn(p, p))
    case OP_SQRT: SP_EACH1(__dsqrt_rn(p))
    case OP_EXP: SP_EACH1(exp(p))
    case OP_LOG: SP_EACH1(log(p))
    case OP_MAX: SP_EACH2((isnan(p) || isnan(q)) ? p + q : fmax(p, q))
    case OP_MIN: SP_EACH2((isnan(p) || isnan(q)) ? p + q : fmin(p, q))
    default: SP_EACH1(0.0)
  }
}

#undef SP_EACH1
#undef SP_EACH2

// Round V floats to a 16-bit dtype and back (no-op for f32).
template <int V>
__device__ __forceinline__ void round_vec(int dt, float (&t)[V]) {
  if (dt == DT_BF16) {
#pragma unroll
    for (int v = 0; v < V; ++v) t[v] = __bfloat162float(__float2bfloat16_rn(t[v]));
  } else if (dt == DT_F16) {
#pragma unroll
    for (int v = 0; v < V; ++v) t[v] = __half2float(__float2half_rn(t[v]));
  }
}

// One instruction in its own dtype.  16-bit types compute in float and
// round the result back, as torch's elementwise ops on them do; their
// operands are rounded to the type first.
template <int V, bool Rare>
__device__ __forceinline__ void run_op(int op, int dt, bool binary,
                                       const float (&x)[V],
                                       const float (&y)[V], float (&t)[V]) {
  if (dt == DT_F32) {
    apply_vec<V, Rare>(op, x, y, t);
    return;
  }
  float xr[V], yr[V];
#pragma unroll
  for (int v = 0; v < V; ++v) xr[v] = x[v];
  round_vec<V>(dt, xr);
  if (binary) {
#pragma unroll
    for (int v = 0; v < V; ++v) yr[v] = y[v];
    round_vec<V>(dt, yr);
  }
  apply_vec<V, Rare>(op, xr, yr, t);
  round_vec<V>(dt, t);
}

template <int V, bool Rare>
__device__ __forceinline__ void run_op(int op, int dt, bool binary,
                                       const double (&x)[V],
                                       const double (&y)[V], double (&t)[V]) {
  if (dt == DT_F64) {
    apply_vec<V, Rare>(op, x, y, t);
    return;
  }
  float xf[V], yf[V], tf[V];
#pragma unroll
  for (int v = 0; v < V; ++v) xf[v] = (float)x[v];
  round_vec<V>(dt, xf);
  if (binary) {
#pragma unroll
    for (int v = 0; v < V; ++v) yf[v] = (float)y[v];
    round_vec<V>(dt, yf);
  }
  apply_vec<V, Rare>(op, xf, yf, tf);
  round_vec<V>(dt, tf);
#pragma unroll
  for (int v = 0; v < V; ++v) t[v] = (double)tf[v];
}

// F registers of V values each, in machine registers: every access is an
// unrolled select over the F registers with constant indices (F = 1, 2, 4
// or 8, the fewest that hold the program's registers: a select costs F - 1
// a value, and with one register none is left).
template <typename R, int V, int F>
struct RegFile {
  R r[F][V];

  __device__ __forceinline__ void get(int i, R (&o)[V]) const {
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = r[F - 1][v];
#pragma unroll
    for (int k = 0; k < F - 1; ++k)
      if (i == k) {
#pragma unroll
        for (int v = 0; v < V; ++v) o[v] = r[k][v];
      }
  }

  __device__ __forceinline__ void set(int i, const R (&t)[V]) {
#pragma unroll
    for (int k = 0; k < F; ++k)
      if (F == 1 || i == k) {
#pragma unroll
        for (int v = 0; v < V; ++v) r[k][v] = t[v];
      }
  }
};

// Operand ``code``: a register, or a scalar the same for every element.
template <typename R, int V, int F>
__device__ __forceinline__ void operand(int code, const RegFile<R, V, F>& f,
                                        const Decoded<R>& prog, R (&o)[V]) {
  if (code >= 0) {
    f.get(code, o);
  } else {
    const R s = prog.scal[-1 - code];
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = s;
  }
}

// The program's values for V elements ``x`` (widened to float) in F
// registers of type R.  ``prog`` is in shared memory.
template <typename R, int V, int F, bool Rare>
__device__ __forceinline__ void run_program(const Decoded<R>& prog,
                                            const float (&x)[V], R (&out)[V]) {
  RegFile<R, V, F> f;
#pragma unroll 1
  for (int k = 0; k < prog.n; ++k) {
    const uint32_t code = prog.code[k];
    const int op = code & 63, dt = (code >> 6) & 3, dst = (code >> 8) & 255;
    const int b = (int8_t)(code >> 16), a = (int8_t)(code >> 24);
    R t[V];
    if (op == OP_LOADX) {
#pragma unroll
      for (int v = 0; v < V; ++v) t[v] = (R)x[v];
    } else if (op < OP_ADD) {  // LOADS or LOADI: a scalar rounded to R once
      const R s = prog.scal[op == OP_LOADS ? SP_MAX_IMM + a : a];
#pragma unroll
      for (int v = 0; v < V; ++v) t[v] = s;
    } else {
      const bool binary = is_binary(op);
      R ra[V], rb[V];
      operand<R, V, F>(a, f, prog, ra);
      if (binary) operand<R, V, F>(b, f, prog, rb);
      run_op<V, Rare>(op, dt, binary, ra, rb, t);
    }
    f.set(dst, t);
  }
  f.get(prog.out, out);
}

// The fewest registers, of 1, 2, 4 and 8, that hold every register ``p``
// names (p is checked by program_fits).
inline int program_file(const Program& p) {
  int used = p.out + 1;
  for (int k = 0; k < p.n; ++k) used = used > p.dst[k] + 1 ? used : p.dst[k] + 1;
  return used <= 1 ? 1 : used <= 2 ? 2 : used <= 4 ? 4 : 8;
}

}  // namespace sp_prog
