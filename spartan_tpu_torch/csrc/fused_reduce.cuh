// The kernels of K1 (fused elementwise chain + full sum), shared by its
// three sources, which nvcc builds side by side: fused_reduce.cu (the
// programs without a rare op), fused_reduce_rare1.cu (those with one in a
// single register) and fused_reduce_rare.cu (those with one in more
// registers); the rare ops are the trig, hyperbolic, rounding and log/exp
// ops, floor division, remainder, power and the binary ops past OP_MIN.
// fused_reduce.cu says how the kernel is designed.

#pragma once

#include <type_traits>

#include "op_program.cuh"

#define SP_THREADS 256

namespace sp_k1 {

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

// The blocks an SM that the launch bounds of the variant with input type
// T, register type R, a file of F registers and the rare ops in form Rare
// ask for: three where the program holds one float register (it then fits
// 80 registers without a spill; not with the costly rare ops unrolled over
// float16 input, which spills there), two otherwise.  The grid is twice
// that.
template <typename T, typename R, int F, int Rare>
struct Occupancy {
  static constexpr bool kHalfUnrolled =
      Rare == sp_prog::kRareUnrolled && std::is_same<T, __half>::value;
  static constexpr int kMinBlocks =
      sizeof(R) == 4 && F == 1 && !kHalfUnrolled ? 3 : 2;
};

// x[head:] is 16-byte aligned; R is the program's register type, F the
// size of its register file; Rare: whether and how the variant carries
// the rare ops (sp_prog::RareForm; program_has_rare: the trig, hyperbolic,
// rounding and log/exp ops, floor division, remainder, power and the other
// binary ops past OP_MIN).
template <typename T, typename Acc, typename R, int F, int Rare>
__global__ void __launch_bounds__(SP_THREADS,
                                  (Occupancy<T, R, F, Rare>::kMinBlocks))
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
template <typename T, typename Acc, typename R, int F, int Rare>
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
  int64_t blocks = (int64_t)sms * 2 * Occupancy<T, R, F, Rare>::kMinBlocks;
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

// The body of the C entry points (spartan_fused_sum and its rare forms):
// checks the arguments and picks the input and accumulator types; the
// source's Variant::run<T, Acc> picks the kernel variant for the program
// (or refuses one outside the source's set).  in_dtype: 1 float32, 2
// bfloat16, 3 float16; acc_dtype: 0 float64, 1 float32; partials: room
// for ``room`` partial sums of acc_dtype, which bounds the grid.  Returns
// cudaGetLastError() of the launches (0 on success).
template <typename Variant, typename Acc>
int entry_input(const void* x, int in_dtype, int64_t n, const Program& prog,
                const void* dscal, void* partials, int64_t room, void* out,
                cudaStream_t s) {
  if (in_dtype == DT_F32)
    return Variant::template run<float, Acc>(x, n, prog, dscal, partials,
                                             room, out, s);
  if (in_dtype == DT_BF16)
    return Variant::template run<__nv_bfloat16, Acc>(x, n, prog, dscal,
                                                     partials, room, out, s);
  if (in_dtype == DT_F16)
    return Variant::template run<__half, Acc>(x, n, prog, dscal, partials,
                                              room, out, s);
  return (int)cudaErrorInvalidValue;
}

template <typename Variant>
int entry(const void* x, int in_dtype, int64_t n, const void* program,
          const void* dscal, void* partials, int64_t room, void* out,
          int acc_dtype, void* stream) {
  const Program& prog = *static_cast<const Program*>(program);
  if (prog.n < 1 || !program_fits(prog) || room < 1 || room > 0x7fffffff ||
      n < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (acc_dtype == DT_F64)
    return entry_input<Variant, double>(x, in_dtype, n, prog, dscal,
                                        partials, room, out, s);
  if (acc_dtype == DT_F32)
    return entry_input<Variant, float>(x, in_dtype, n, prog, dscal,
                                       partials, room, out, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace sp_k1
