// Dense matrix product with a fused epilogue, for Hopper (sm_90a).
//
//   out = epilogue(x @ y),  x (M, K), y (K, N) row-major, float32
//   accumulator, epilogue on the float32 result, out in x's dtype (or in
//   float32 when the wrapper runs the epilogue itself)
//
// Replaces spartan_tpu/backend/kernels/matmul.py:matmul (K2), the Pallas
// MXU kernel: a (M/bm, N/bn, K/bk) grid with a VMEM float32 accumulator
// carried across the K steps, the epilogue traced into the last K step.
//
// What bounds it: the operations.  2MNK flops against (MK + KN + MN)
// elements: at 8192^2 bf16, 1.1 TFLOP for 0.4 GB, far above the card's
// balance point, so the product is compute-bound (989 TFLOP/s bf16/f16 on
// the tensor cores, 67 TFLOP/s float32 outside them; no TF32: float32 stays
// full float32, as the port's initialize() sets for torch.matmul).
//
// Design (a simple design that is right, for any M, N >= 1 and K >= 0):
//  * A block computes a 128x128 output tile with 256 threads; the grid has
//    one block a tile and nothing is carried between blocks, so there is no
//    split-K and no atomic: the result is the same on every run.  The K
//    loop walks tiles of K staged in shared memory, double-buffered (the
//    next tile is loaded into registers while the current one is used).
//    Every load is predicated on the matrix's edge (zeros outside), so any
//    shape runs; 16-byte loads are used where a row's length and the base
//    address allow them.  The TPU kernel's block sizes bm/bn/bk fit its
//    VMEM and (8, 128) tiling and are not read here.
//  * float32: 8-deep K tiles; each thread keeps an 8x8 register tile of
//    outputs (two 4x4 quadrants 64 rows/columns apart, read from shared
//    memory as float4) and accumulates with FFMA.
//  * bfloat16/float16: 32-deep K tiles; each of the 8 warps owns a 64x32
//    sub-tile and issues tensor-core mma.sync.m16n8k16 with float32
//    accumulators (row-major A fragments read as 32-bit pairs, B fragments
//    assembled from two 16-bit reads; the shared rows are padded so the
//    fragment reads hit distinct banks).
//  * Epilogue: the op program (op_program.cuh, the interpreter K1 uses)
//    runs on each float32 accumulator in registers before the cast and the
//    store, one interpreted pass per output element.
//
// wgmma, TMA and warp specialisation are later work.  The wrapper
// (backend/kernels/matmul.py) allocates out, launches on PyTorch's current
// stream and raises on a non-zero return.

#include "op_program.cuh"

namespace {

constexpr int kThreads = 256;

// The epilogue's value for one accumulator, out of line: it runs once per
// output element, after the K loop.
__device__ __noinline__ float epilogue_value(const Program& prog, float v) {
  return (float)run_program(prog, (double)v, nullptr);
}

// The store of one output: float32, or the 16-bit input type (kBf16 picks
// bfloat16 or float16) as raw bits.
template <typename OutT, bool kBf16>
__device__ __forceinline__ void store_out(OutT* __restrict__ C, int64_t r,
                                          int64_t c, int64_t M, int64_t N,
                                          float v, const Program& prog) {
  if (r >= M || c >= N) return;
  if (prog.n > 0) v = epilogue_value(prog, v);
  if constexpr (sizeof(OutT) == 4) {
    C[r * N + c] = v;
  } else if constexpr (kBf16) {
    C[r * N + c] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  } else {
    C[r * N + c] = __half_as_ushort(__float2half_rn(v));
  }
}

// ---------------------------------------------------------------- float32

constexpr int F_BM = 128, F_BN = 128, F_BK = 8;

__global__ void __launch_bounds__(kThreads)
sgemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
             float* __restrict__ C, int64_t M, int64_t N, int64_t K,
             int vec_a, int vec_b, const Program prog) {
  __shared__ __align__(16) float As[2][F_BK][F_BM];  // A tile, transposed
  __shared__ __align__(16) float Bs[2][F_BK][F_BN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int64_t row0 = (int64_t)blockIdx.y * F_BM;
  const int64_t col0 = (int64_t)blockIdx.x * F_BN;
  // each thread loads 4 consecutive elements of A (one row) and of B
  const int a_r = tid >> 1, a_c = (tid & 1) * 4;
  const int b_r = tid >> 5, b_c = (tid & 31) * 4;
  float a_ld[4], b_ld[4];
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  auto load_tiles = [&](int64_t k0) {
    const int64_t ar = row0 + a_r, ak = k0 + a_c;
    if (vec_a && ar < M && ak + 3 < K) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(A + ar * K + ak));
      a_ld[0] = v.x; a_ld[1] = v.y; a_ld[2] = v.z; a_ld[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a_ld[i] = (ar < M && ak + i < K) ? A[ar * K + ak + i] : 0.0f;
    }
    const int64_t bk = k0 + b_r, bc = col0 + b_c;
    if (vec_b && bk < K && bc + 3 < N) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(B + bk * N + bc));
      b_ld[0] = v.x; b_ld[1] = v.y; b_ld[2] = v.z; b_ld[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        b_ld[i] = (bk < K && bc + i < N) ? B[bk * N + bc + i] : 0.0f;
    }
  };
  auto store_tiles = [&](int s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[s][a_c + i][a_r] = a_ld[i];
    *reinterpret_cast<float4*>(&Bs[s][b_r][b_c]) =
        make_float4(b_ld[0], b_ld[1], b_ld[2], b_ld[3]);
  };

  const int64_t ntiles = (K + F_BK - 1) / F_BK;
  load_tiles(0);
  store_tiles(0);
  __syncthreads();
  for (int64_t t = 0; t < ntiles; ++t) {
    const int s = (int)(t & 1);
    if (t + 1 < ntiles) load_tiles((t + 1) * F_BK);
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[s][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[s][kk][ty * 4 + 64]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[s][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[s][kk][tx * 4 + 64]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // buffer s^1 was last read before the previous barrier
    if (t + 1 < ntiles) store_tiles(s ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t c = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      store_out<float, false>(C, r, c, M, N, acc[i][j], prog);
    }
  }
}

// ---------------------------------------------------- bfloat16 / float16

constexpr int H_BM = 128, H_BN = 128, H_BK = 32;
constexpr int A_LD = H_BK + 8;  // padded rows: fragment reads hit 32 banks
constexpr int B_LD = H_BN + 8;

template <bool kBf16>
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  if constexpr (kBf16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

__device__ __forceinline__ uint4 pack8(const uint16_t* t) {
  uint4 v;
  v.x = (uint32_t)t[0] | ((uint32_t)t[1] << 16);
  v.y = (uint32_t)t[2] | ((uint32_t)t[3] << 16);
  v.z = (uint32_t)t[4] | ((uint32_t)t[5] << 16);
  v.w = (uint32_t)t[6] | ((uint32_t)t[7] << 16);
  return v;
}

// 16-bit operands are handled as raw bits; only the mma instruction reads
// them as bfloat16 or float16.
template <bool kBf16, typename OutT>
__global__ void __launch_bounds__(kThreads)
hgemm_kernel(const uint16_t* __restrict__ A, const uint16_t* __restrict__ B,
             OutT* __restrict__ C, int64_t M, int64_t N, int64_t K,
             int vec_a, int vec_b, const Program prog) {
  __shared__ __align__(16) uint16_t As[2][H_BM][A_LD];
  __shared__ __align__(16) uint16_t Bs[2][H_BK][B_LD];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int64_t row0 = (int64_t)blockIdx.y * H_BM;
  const int64_t col0 = (int64_t)blockIdx.x * H_BN;
  uint4 a_ld[2], b_ld[2];
  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  // A tile 128x32 and B tile 32x128: 512 runs of 8 elements each, 2 a
  // thread
  auto load_tiles = [&](int64_t k0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = tid + kThreads * h;
      const int64_t ar = row0 + (q >> 2), ak = k0 + (q & 3) * 8;
      if (vec_a && ar < M && ak + 7 < K) {
        a_ld[h] = __ldg(reinterpret_cast<const uint4*>(A + ar * K + ak));
      } else {
        uint16_t t[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          t[e] = (ar < M && ak + e < K) ? A[ar * K + ak + e] : (uint16_t)0;
        a_ld[h] = pack8(t);
      }
      const int64_t bk = k0 + (q >> 4), bc = col0 + (q & 15) * 8;
      if (vec_b && bk < K && bc + 7 < N) {
        b_ld[h] = __ldg(reinterpret_cast<const uint4*>(B + bk * N + bc));
      } else {
        uint16_t t[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          t[e] = (bk < K && bc + e < N) ? B[bk * N + bc + e] : (uint16_t)0;
        b_ld[h] = pack8(t);
      }
    }
  };
  auto store_tiles = [&](int s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = tid + kThreads * h;
      *reinterpret_cast<uint4*>(&As[s][q >> 2][(q & 3) * 8]) = a_ld[h];
      *reinterpret_cast<uint4*>(&Bs[s][q >> 4][(q & 15) * 8]) = b_ld[h];
    }
  };

  const int64_t ntiles = (K + H_BK - 1) / H_BK;
  load_tiles(0);
  store_tiles(0);
  __syncthreads();
  for (int64_t t = 0; t < ntiles; ++t) {
    const int s = (int)(t & 1);
    if (t + 1 < ntiles) load_tiles((t + 1) * H_BK);
#pragma unroll
    for (int kk = 0; kk < H_BK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm + mi * 16 + g;
        const int k = kk + tig * 2;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(&As[s][r][k]);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(&As[s][r + 8][k]);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(&As[s][r][k + 8]);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(&As[s][r + 8][k + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn + ni * 8 + g;
        const int k = kk + tig * 2;
        bf[ni][0] = (uint32_t)Bs[s][k][c] | ((uint32_t)Bs[s][k + 1][c] << 16);
        bf[ni][1] =
            (uint32_t)Bs[s][k + 8][c] | ((uint32_t)Bs[s][k + 9][c] << 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma16816<kBf16>(acc[mi][ni], af[mi], bf[ni]);
    }
    if (t + 1 < ntiles) store_tiles(s ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t r = row0 + wm + mi * 16 + g + (e >= 2 ? 8 : 0);
        const int64_t c = col0 + wn + ni * 8 + tig * 2 + (e & 1);
        store_out<OutT, kBf16>(C, r, c, M, N, acc[mi][ni][e], prog);
      }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// x (M, K) and y (K, N) contiguous, of one dtype (in_dtype: 1 float32,
// 2 bfloat16, 3 float16); out (M, N) of out_dtype (float32, or the input
// dtype); program a Program (op_program.cuh) or NULL for no epilogue.
// Returns cudaGetLastError() of the launch (0 on success).
int spartan_matmul(const void* x, const void* y, void* out, int64_t M,
                   int64_t N, int64_t K, int in_dtype, int out_dtype,
                   const void* program, void* stream) {
  Program prog;
  if (program != nullptr) {
    prog = *static_cast<const Program*>(program);
  } else {
    prog.n = 0;
    prog.out = 0;
  }
  if (M < 1 || N < 1 || K < 0 || prog.n < 0 || prog.n > SP_MAX_INSTR ||
      (out_dtype != DT_F32 && out_dtype != in_dtype))
    return (int)cudaErrorInvalidValue;
  const int64_t gx = (N + 127) / 128, gy = (M + 127) / 128;
  if (gx > 0x7fffffff || gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per16 = in_dtype == DT_F32 ? 4 : 8;  // elements in 16 bytes
  const int vec_a = aligned16(x) && K % per16 == 0;
  const int vec_b = aligned16(y) && N % per16 == 0;
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const uint16_t* xh = static_cast<const uint16_t*>(x);
  const uint16_t* yh = static_cast<const uint16_t*>(y);
  if (in_dtype == DT_F32) {
    sgemm_kernel<<<grid, kThreads, 0, s>>>(xf, yf, static_cast<float*>(out),
                                           M, N, K, vec_a, vec_b, prog);
  } else if (in_dtype == DT_BF16 && out_dtype == DT_F32) {
    hgemm_kernel<true, float><<<grid, kThreads, 0, s>>>(
        xh, yh, static_cast<float*>(out), M, N, K, vec_a, vec_b, prog);
  } else if (in_dtype == DT_BF16) {
    hgemm_kernel<true, uint16_t><<<grid, kThreads, 0, s>>>(
        xh, yh, static_cast<uint16_t*>(out), M, N, K, vec_a, vec_b, prog);
  } else if (in_dtype == DT_F16 && out_dtype == DT_F32) {
    hgemm_kernel<false, float><<<grid, kThreads, 0, s>>>(
        xh, yh, static_cast<float*>(out), M, N, K, vec_a, vec_b, prog);
  } else if (in_dtype == DT_F16) {
    hgemm_kernel<false, uint16_t><<<grid, kThreads, 0, s>>>(
        xh, yh, static_cast<uint16_t*>(out), M, N, K, vec_a, vec_b, prog);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* spartan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
