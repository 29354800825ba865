// K1 (fused elementwise chain + full sum) for the programs that hold a
// rare op (op_program.cuh's is_rare_op: the trig, hyperbolic, rounding and
// log/exp ops, cbrt, erf, erfc, floor division, remainder, power, atan2,
// hypot, copysign, fmax, fmin, logaddexp, logaddexp2), in float registers
// only (the planner refuses a rare op beside a float64 instruction): the
// kernels of fused_reduce.cuh, instantiated with the rare ops' code.
//
// This source: the programs of one register (a single rare op on the
// element: sum(sin(b)), b // c, b % c …), with the costly rare ops
// unrolled over the 8 elements an instruction takes (op_program.cuh's
// RareForm).  fused_reduce_rare.cu holds the programs of more registers;
// nvcc builds the two, and fused_reduce.cu, side by side.

#include "fused_reduce.cuh"

namespace {

struct OneRegister {
  template <typename T, typename Acc>
  static int run(const void* x, int64_t n, const Program& prog,
                 const void* dscal, void* partials, int64_t room, void* out,
                 cudaStream_t s) {
    if (!program_is_float(prog) || !program_has_rare(prog) ||
        sp_prog::program_file(prog) != 1)
      return (int)cudaErrorInvalidValue;
    return sp_k1::launch<T, Acc, float, 1, sp_prog::kRareUnrolled>(
        x, n, prog, dscal, partials, room, out, s);
  }
};

}  // namespace

extern "C" {

// spartan_fused_sum's arguments (sp_k1::entry) for a program of one
// register with a rare op.
int spartan_fused_sum_rare1(const void* x, int in_dtype, int64_t n,
                            const void* program, const void* dscal,
                            void* partials, int64_t room, void* out,
                            int acc_dtype, void* stream) {
  return sp_k1::entry<OneRegister>(x, in_dtype, n, program, dscal, partials,
                                   room, out, acc_dtype, stream);
}

const char* spartan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
