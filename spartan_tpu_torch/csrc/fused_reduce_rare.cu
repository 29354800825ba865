// K1 (fused elementwise chain + full sum) for the programs that hold a
// rare op (op_program.cuh's is_rare_op: the trig, hyperbolic, rounding and
// log/exp ops, cbrt, erf, erfc, floor division, remainder, power, atan2,
// hypot, copysign, fmax, fmin, logaddexp, logaddexp2), in float registers
// only (the planner refuses a rare op beside a float64 instruction): the
// kernels of fused_reduce.cuh, instantiated with the rare ops' code.
//
// This source: the programs of more than one register, with the costly
// rare ops looped, one element at a time, inlined once a variant
// (op_program.cuh's RareForm): unrolled in every variant, K1's rare
// variants took 472 s to build.  fused_reduce_rare1.cu holds the
// programs of one register.

#include "fused_reduce.cuh"

namespace {

struct Registers {
  template <typename T, typename Acc>
  static int run(const void* x, int64_t n, const Program& prog,
                 const void* dscal, void* partials, int64_t room, void* out,
                 cudaStream_t s) {
    constexpr int kLooped = sp_prog::kRareLooped;
    if (!program_is_float(prog) || !program_has_rare(prog))
      return (int)cudaErrorInvalidValue;
    switch (sp_prog::program_file(prog)) {
      case 2:
        return sp_k1::launch<T, Acc, float, 2, kLooped>(
            x, n, prog, dscal, partials, room, out, s);
      case 4:
        return sp_k1::launch<T, Acc, float, 4, kLooped>(
            x, n, prog, dscal, partials, room, out, s);
      case 8:
        return sp_k1::launch<T, Acc, float, 8, kLooped>(
            x, n, prog, dscal, partials, room, out, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
};

}  // namespace

extern "C" {

// spartan_fused_sum's arguments (sp_k1::entry) for a program of more than
// one register with a rare op.
int spartan_fused_sum_rare(const void* x, int in_dtype, int64_t n,
                           const void* program, const void* dscal,
                           void* partials, int64_t room, void* out,
                           int acc_dtype, void* stream) {
  return sp_k1::entry<Registers>(x, in_dtype, n, program, dscal, partials,
                                 room, out, acc_dtype, stream);
}

const char* spartan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
