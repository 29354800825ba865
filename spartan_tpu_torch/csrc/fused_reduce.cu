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
// current stream, and raises if the launch reports an error.

#include "op_program.cuh"

#define SP_THREADS 256

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

// The elements of one 16-byte load, widened to float.
__device__ __forceinline__ void unpack(const uint4& raw, const float*,
                                       float (&o)[4]) {
  o[0] = __uint_as_float(raw.x);
  o[1] = __uint_as_float(raw.y);
  o[2] = __uint_as_float(raw.z);
  o[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, const __nv_bfloat16*,
                                       float (&o)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& raw, const __half*,
                                       float (&o)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __half2float(__ushort_as_half((unsigned short)(w[i] & 0xffffu)));
    o[2 * i + 1] = __half2float(__ushort_as_half((unsigned short)(w[i] >> 16)));
  }
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

// The blocks an SM that the launch bounds of the variant with register type
// R and a file of F registers ask for: three where the program holds one
// float register (it then fits 80 registers without a spill), two
// otherwise.  The grid is twice that.
template <typename R, int F>
struct Occupancy {
  static constexpr int kMinBlocks = sizeof(R) == 4 && F == 1 ? 3 : 2;
};

// x[head:] is 16-byte aligned; R is the program's register type, F the
// size of its register file; Rare: the program holds floor division,
// remainder or power (program_has_rare), whose code only these variants
// carry.
template <typename T, typename Acc, typename R, int F, bool Rare>
__global__ void __launch_bounds__(SP_THREADS, (Occupancy<R, F>::kMinBlocks))
fused_sum_partials(const T* __restrict__ x, int64_t n, int64_t head,
                   const __grid_constant__ Program prog,
                   const double* __restrict__ dscal, int n_dscal,
                   Acc* __restrict__ partials) {
  __shared__ sp_prog::Decoded<R> sprog;
  sp_prog::decode(prog, dscal, n_dscal, sprog);
  constexpr int kPer = 16 / (int)sizeof(T);  // elements in one 16-byte load
  constexpr int kStep = 2 * kPer;            // elements a thread takes a step
  // elements an instruction runs on: 8, or fewer where the file would crowd
  // the register budget of two blocks an SM
  constexpr int V = sizeof(R) == 8 ? 2 : F <= 4 ? 8 : 4;
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  const int64_t nvec = (n - head) / kStep;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  Acc acc = (Acc)0;
  uint4 r0 = make_uint4(0, 0, 0, 0), r1 = r0;
  if (first < nvec) {
    r0 = __ldg(xv + 2 * first);
    r1 = __ldg(xv + 2 * first + 1);
  }
  for (int64_t i = first; i < nvec; i += stride) {
    float e[kStep];
    {
      float h0[kPer], h1[kPer];
      unpack(r0, x, h0);
      unpack(r1, x, h1);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        e[j] = h0[j];
        e[kPer + j] = h1[j];
      }
    }
    if (i + stride < nvec) {  // the next step's loads, in flight meanwhile
      r0 = __ldg(xv + 2 * (i + stride));
      r1 = __ldg(xv + 2 * (i + stride) + 1);
    }
#pragma unroll
    for (int p = 0; p < kStep / V; ++p) {
      float in[V];
      R out[V];
#pragma unroll
      for (int j = 0; j < V; ++j) in[j] = e[p * V + j];
      sp_prog::run_program<R, V, F, Rare>(sprog, in, out);
#pragma unroll
      for (int j = 0; j < V; ++j) acc += (Acc)out[j];
    }
  }
  // the elements before the aligned body and after its last whole step
  const int64_t tail0 = head + nvec * kStep;
  const int64_t nscalar = head + (n - tail0);
  for (int64_t j = first; j < nscalar; j += stride) {
    const int64_t at = j < head ? j : tail0 + (j - head);
    float in[1] = {widen(x[at])};
    R out[1];
    sp_prog::run_program<R, 1, F, Rare>(sprog, in, out);
    acc += (Acc)out[0];
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

// ``room``: the partial sums ``partials`` holds, a bound on the grid.
template <typename T, typename Acc, typename R, int F, bool Rare>
int launch(const void* x, int64_t n, const Program& prog, const void* dscal,
           void* partials, int64_t room, void* out, cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  if (addr % sizeof(T) != 0) return (int)cudaErrorMisalignedAddress;
  int64_t head = (int64_t)(((16 - (addr & 15)) & 15) / sizeof(T));
  if (head > n) head = n;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int64_t blocks = (int64_t)sms * 2 * Occupancy<R, F>::kMinBlocks;
  const int64_t work = (n + SP_THREADS * 8 - 1) / (SP_THREADS * 8);
  if (work < blocks) blocks = work;
  if (room < blocks) blocks = room;
  if (blocks < 1) blocks = 1;
  fused_sum_partials<T, Acc, R, F, Rare>
      <<<(unsigned)blocks, SP_THREADS, 0, stream>>>(
      static_cast<const T*>(x), n, head, prog,
      static_cast<const double*>(dscal), program_dev_scalars(prog),
      static_cast<Acc*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<Acc><<<1, SP_THREADS, 0, stream>>>(
      static_cast<const Acc*>(partials), blocks, static_cast<Acc*>(out));
  return (int)cudaGetLastError();
}

// Float registers in the smallest file that holds the program, with or
// without the rare ops' code.
template <typename T, typename Acc, bool Rare>
int launch_file(const void* x, int64_t n, const Program& prog,
                const void* dscal, void* partials, int64_t room, void* out,
                cudaStream_t s) {
  switch (sp_prog::program_file(prog)) {
    case 1:
      return launch<T, Acc, float, 1, Rare>(x, n, prog, dscal, partials, room,
                                            out, s);
    case 2:
      return launch<T, Acc, float, 2, Rare>(x, n, prog, dscal, partials, room,
                                            out, s);
    case 4:
      return launch<T, Acc, float, 4, Rare>(x, n, prog, dscal, partials, room,
                                            out, s);
    default:
      return launch<T, Acc, float, 8, Rare>(x, n, prog, dscal, partials, room,
                                            out, s);
  }
}

// Double registers for a program with a float64 instruction (never with a
// rare op), else float registers.
template <typename T, typename Acc>
int launch_regs(const void* x, int64_t n, const Program& prog,
                const void* dscal, void* partials, int64_t room, void* out,
                cudaStream_t s) {
  if (!program_is_float(prog)) {
    if (program_has_rare(prog)) return (int)cudaErrorInvalidValue;
    return launch<T, Acc, double, 8, false>(x, n, prog, dscal, partials, room,
                                            out, s);
  }
  if (program_has_rare(prog))
    return launch_file<T, Acc, true>(x, n, prog, dscal, partials, room, out,
                                     s);
  return launch_file<T, Acc, false>(x, n, prog, dscal, partials, room, out,
                                    s);
}

template <typename Acc>
int launch_input(const void* x, int in_dtype, int64_t n, const Program& prog,
                 const void* dscal, void* partials, int64_t room, void* out,
                 cudaStream_t s) {
  if (in_dtype == DT_F32)
    return launch_regs<float, Acc>(x, n, prog, dscal, partials, room, out,
                                   s);
  if (in_dtype == DT_BF16)
    return launch_regs<__nv_bfloat16, Acc>(x, n, prog, dscal, partials,
                                           room, out, s);
  if (in_dtype == DT_F16)
    return launch_regs<__half, Acc>(x, n, prog, dscal, partials, room, out,
                                    s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// in_dtype: 1 float32, 2 bfloat16, 3 float16; acc_dtype: 0 float64,
// 1 float32; partials: room for ``room`` partial sums of acc_dtype, which
// bounds the grid.  Returns cudaGetLastError() of the launches (0 on
// success).
int spartan_fused_sum(const void* x, int in_dtype, int64_t n,
                      const void* program, const void* dscal,
                      void* partials, int64_t room, void* out,
                      int acc_dtype, void* stream) {
  const Program& prog = *static_cast<const Program*>(program);
  if (prog.n < 1 || !program_fits(prog) || room < 1 || room > 0x7fffffff ||
      n < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (acc_dtype == DT_F64)
    return launch_input<double>(x, in_dtype, n, prog, dscal, partials, room,
                                out, s);
  if (acc_dtype == DT_F32)
    return launch_input<float>(x, in_dtype, n, prog, dscal, partials, room,
                               out, s);
  return (int)cudaErrorInvalidValue;
}

const char* spartan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
