// Fused elementwise chain + full sum, for Hopper (sm_90a).
//
// Replaces spartan_tpu/backend/kernels/fused_reduce.py:fused_sum, the
// Pallas kernel that computes sum(f(x, *scalars)) in one read of x.
//
// What bounds it: the bytes of one read of x (0.32 ms for 16384^2 float32
// at 3.35 TB/s).  The chain is a handful of flops an element, far below the
// card's balance point, so the kernel must read x exactly once, write no
// intermediate, and spend few enough instructions an element that the
// interpreter keeps up with the memory: at 3.35 TB/s the card reads about
// 0.84 float32 elements a ns, and its SMs issue about 30 thread
// instructions an element in that time.
//
// Design:
//  * The fused chain arrives as a flat op program (Program in
//    op_program.cuh, shared with matmul.cu's epilogue), made by the Python
//    translator in backend/kernels/fused_reduce.py with its registers
//    allocated onto SP_NREG.  Every thread interprets the same program, so
//    no warp diverges; the register file is in machine registers, sized to
//    the program (a template parameter), each instruction is decoded once
//    for a vector of 8 elements (4 with a file of 8 registers, 2 with
//    double registers), and a program without a float64 instruction runs
//    in float registers (op_program.cuh says how each keeps the same bits).
//    The program is read from shared memory.
//  * Loads are 16 bytes a thread (4 float32 or 8 bfloat16/float16), two in
//    flight, and the next step's pair is requested before this step's
//    elements are interpreted.  The body starts at the first 16-byte
//    aligned element; the elements before it (an unaligned view) and the
//    tail after the last whole step go through the same program one at a
//    time.
//  * Pass 1: a grid-stride loop over twice the blocks that fit an SM (at
//    most one block for 2048 elements), picked by the C entry point with
//    the kernel's variant; each thread accumulates in the accumulator dtype in a
//    fixed order, each block reduces in shared memory and writes one
//    partial sum.
//  * Pass 2: one block sums the partials in a fixed order.  Two passes and
//    no atomics make the result independent of launch timing, bit-equal on
//    repeat (the TPU kernel's single revisited accumulator relies on a
//    sequential grid, which the GPU does not have).
//
// The wrapper allocates the partials and the output, launches on PyTorch's
// current stream, and raises if the launch reports an error.  The kernels
// live in fused_reduce.cuh; this source instantiates them for programs
// without a rare op, fused_reduce_rare1.cu and fused_reduce_rare.cu for
// programs with one.

#include "fused_reduce.cuh"

namespace {

using sp_k1::launch;

// The variants of this source: a program without a rare op, in double
// registers where it has a float64 instruction, else in float registers
// in the smallest file that holds it; a program with a rare op is refused
// (fused_reduce_rare.cu and fused_reduce_rare1.cu run it).
struct Common {
  template <typename T, typename Acc>
  static int run(const void* x, int64_t n, const Program& prog,
                 const void* dscal, void* partials, int64_t room, void* out,
                 cudaStream_t s) {
    constexpr int kNo = sp_prog::kNoRare;
    if (program_has_rare(prog)) return (int)cudaErrorInvalidValue;
    if (!program_is_float(prog))
      return launch<T, Acc, double, 8, kNo>(x, n, prog, dscal, partials,
                                            room, out, s);
    switch (sp_prog::program_file(prog)) {
      case 1:
        return launch<T, Acc, float, 1, kNo>(x, n, prog, dscal, partials,
                                             room, out, s);
      case 2:
        return launch<T, Acc, float, 2, kNo>(x, n, prog, dscal, partials,
                                             room, out, s);
      case 4:
        return launch<T, Acc, float, 4, kNo>(x, n, prog, dscal, partials,
                                             room, out, s);
      default:
        return launch<T, Acc, float, 8, kNo>(x, n, prog, dscal, partials,
                                             room, out, s);
    }
  }
};

}  // namespace

extern "C" {

// sp_k1::entry (fused_reduce.cuh) gives the arguments.
int spartan_fused_sum(const void* x, int in_dtype, int64_t n,
                      const void* program, const void* dscal,
                      void* partials, int64_t room, void* out,
                      int acc_dtype, void* stream) {
  return sp_k1::entry<Common>(x, in_dtype, n, program, dscal, partials, room,
                              out, acc_dtype, stream);
}

const char* spartan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
