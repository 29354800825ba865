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
// full float32, as the port's initialize() sets for torch.matmul).  Only
// wgmma reaches the tensor cores' full rate, and only if its operands
// arrive in shared memory without the threads spending instructions on
// them and the tensor cores never wait for a tile.
//
// bfloat16/float16 (hopper_gemm), designed for that:
//  * A persistent block on each SM (at most one a tile) walks the output
//    tiles of 128 x 256 in a grouped order (8 tile rows a group), so that
//    the blocks running at once share rows of x and columns of y in L2.
//    (128 x 128 tiles with a 6-stage ring ran 35-40 % slower at 8192^2.)
//  * One producer thread issues TMA loads (cp.async.bulk.tensor, 128-byte
//    swizzle) of 64-deep K stages into a ring in dynamic shared memory (4
//    stages of 16 KB of x and 32 KB of y), with a full and an empty
//    mbarrier a stage.  TMA fills with zeros
//    outside the matrix, so the ragged edges of M, N and K need no
//    predicate on the load side.  The tensor maps are built on the host
//    (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, no -lcuda)
//    and passed as __grid_constant__ parameters.
//  * Two consumer warpgroups issue wgmma.mma_async m64n256k16 on their
//    64-row halves, four a stage, with one stage's group left in flight
//    while the next is issued; a stage goes back to the producer once its
//    products are done.  x's tile is K-major; y's is read as it lies, (K,
//    N) row-major, by the descriptor's MN-major (transposed) form: y is
//    never copied.  setmaxnreg gives the consumers 232 registers and the
//    producer 40.
//  * The producer runs ahead across tiles, so a tile's epilogue overlaps
//    the next tile's first loads.  Each output tile is summed by one block
//    in a fixed K order: no split-K and no atomics, the same bits every run.
//  * An operand TMA cannot describe (a row stride that is not a multiple of
//    16 bytes, a base that is not 16-byte aligned) is copied by the wrapper
//    into a zero-padded, aligned buffer first (counted there).
//
// float32 (sgemm_tma), FFMA outside the tensor cores (no TF32: the
// product stays full float32), so that the K loop issues little besides
// FFMA and no FFMA waits on a barrier of the whole block:
//  * 128 x 256 output tiles, 8 x 16 outputs a thread (two 4-row slabs 64
//    apart by four 4-column slabs 64 apart), 256 consumer threads in warps
//    of 4 x 8.  Each thread reads 8 + 16 floats from shared memory a k step
//    for 128 FFMA.  Shared memory delivers 128 bytes a clock an SM, 32
//    floats, against 128 FFMA lanes: 8 x 8 (16 floats for 64 FFMA) would
//    need all of it, 8 x 16 needs three quarters.
//  * 32-deep K stages in a ring of 3 in dynamic shared memory, both tiles
//    TMA boxes in their own layouts (x's [BM][BK], y's [BK][BN]; no
//    transpose, no workspace), with a full and an empty mbarrier a stage.
//    A producer warpgroup (thread 0 issues the loads) runs ahead across
//    tiles; a consumer warp waits only for the stage it reads and frees it
//    once read, so no barrier spans the block.  A thread reads 4 k of one
//    of its rows of x with one LDS.128, then runs those 4 k steps.  TMA
//    fills with zeros outside the matrix, so the edges of M, N and K need
//    no predicate; an operand TMA cannot describe is padded first by the
//    wrapper, as in 16-bit.  A 16-deep stage's loop holds 152
//    instructions besides its 2048 FFMA; with 4-byte cp.async copies of x
//    landing transposed it held 310.
//  * A persistent block on each SM walks the tiles in the 16-bit path's
//    grouped order (8 tile rows a group), so that the blocks running at
//    once share panels of x and y in L2; any M up to 2^31 - 1.
//  * One block sums each output tile in a fixed K order (each output a
//    chain of FFMA over k = 0, 1, ...): no split-K and no atomics, the same
//    bits every run, whatever the tile shape.  A separate instantiation
//    carries the epilogue program, so the product without one keeps its K
//    loop's registers.
//
// Epilogue (both): stores are predicated on M and N.  With an op program
// (op_program.cuh, the interpreter K1 uses, read from shared memory), each
// thread runs it on its accumulators four at a time, picked out of the
// register tile by a chain of compares with constant indices, before the
// cast and the store.
//
// The wrapper (backend/kernels/matmul.py) allocates out, launches on
// PyTorch's current stream and raises on a non-zero return.

#include <cuda.h>  // CUtensorMap and the encoder's types only
#include <string.h>

#include "op_program.cuh"

namespace {

template <int C>
struct IC {
  static constexpr int value = C;
};

// v = the chunk ``c`` of NC that ``get`` names at compile time: an if-chain
// whose every branch indexes the register tile with constants.
template <int C, int NC, typename Get>
__device__ __forceinline__ void pick(int c, float (&v)[4], const Get& get) {
  if constexpr (C < NC) {
    if (c == C) {
      get(IC<C>{}, v);
    } else {
      pick<C + 1, NC>(c, v, get);
    }
  }
}

// The store of one output: float32, or the 16-bit input type (kBf16 picks
// bfloat16 or float16) as raw bits.
template <typename OutT, bool kBf16>
__device__ __forceinline__ void store_one(OutT* __restrict__ C, int64_t r,
                                          int64_t c, int64_t M, int64_t N,
                                          float v) {
  if (r >= M || c >= N) return;
  if constexpr (sizeof(OutT) == 4) {
    C[r * N + c] = v;
  } else if constexpr (kBf16) {
    C[r * N + c] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  } else {
    C[r * N + c] = __half_as_ushort(__float2half_rn(v));
  }
}

// Two neighbours of one row (c even): one 8- or 4-byte store when N is
// even and both are inside.
template <typename OutT, bool kBf16>
__device__ __forceinline__ void store_pair(OutT* __restrict__ C, int64_t r,
                                           int64_t c, int64_t M, int64_t N,
                                           float v0, float v1) {
  if (r >= M) return;
  if ((N & 1) == 0 && c + 1 < N) {
    if constexpr (sizeof(OutT) == 4) {
      *reinterpret_cast<float2*>(C + r * N + c) = make_float2(v0, v1);
    } else if constexpr (kBf16) {
      *reinterpret_cast<uint32_t*>(C + r * N + c) =
          (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v0)) |
          ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v1)) << 16);
    } else {
      *reinterpret_cast<uint32_t*>(C + r * N + c) =
          (uint32_t)__half_as_ushort(__float2half_rn(v0)) |
          ((uint32_t)__half_as_ushort(__float2half_rn(v1)) << 16);
    }
  } else {
    store_one<OutT, kBf16>(C, r, c, M, N, v0);
    store_one<OutT, kBf16>(C, r, c + 1, M, N, v1);
  }
}

// Four neighbours of one float32 row (c a multiple of 4): one 16-byte
// store when N is a multiple of 4 (then all four are inside or none),
// else one store each.
__device__ __forceinline__ void store_four(float* __restrict__ C, int64_t r,
                                           int64_t c, int64_t M, int64_t N,
                                           float v0, float v1, float v2,
                                           float v3) {
  if (r >= M || c >= N) return;
  if ((N & 3) == 0) {
    *reinterpret_cast<float4*>(C + r * N + c) = make_float4(v0, v1, v2, v3);
  } else {
    store_one<float, false>(C, r, c, M, N, v0);
    store_one<float, false>(C, r, c + 1, M, N, v1);
    store_one<float, false>(C, r, c + 2, M, N, v2);
    store_one<float, false>(C, r, c + 3, M, N, v3);
  }
}

// ---------------------------------------------------------------- float32

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// One 2-D TMA box into shared memory, completing on ``bar``; c0 is the
// inner (contiguous) coordinate.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Output tile t of the grouped walk: ``group`` tile rows a group, down the
// rows of a group first, so that the blocks running at once share columns
// of y and rows of x in L2.
__device__ __forceinline__ void tile_at(int64_t t, int64_t tiles_m,
                                        int64_t tiles_n, int group,
                                        int64_t& tm, int64_t& tn) {
  const int64_t per_group = (int64_t)group * tiles_n;
  const int64_t first = t / per_group * group;
  const int64_t rows =
      tiles_m - first < group ? tiles_m - first : (int64_t)group;
  const int64_t r = t % per_group;
  tm = first + r % rows;
  tn = r / rows;
}

// The float32 kernel's shape (matmul.py's SGEMM_TILE_M, SGEMM_TILE_N,
// SGEMM_TILE_K and SGEMM_STAGES are F_BM, F_BN, F_BK and F_STAGES).
constexpr int F_BM = 128;     // output rows a tile
constexpr int F_BN = 256;     // output columns a tile
constexpr int F_BK = 32;      // K depth of a stage
constexpr int F_TM = 8;       // output rows a thread
constexpr int F_TN = 16;      // output columns a thread
constexpr int F_STAGES = 3;   // stages of the ring
constexpr int F_GROUP_M = 8;  // tile rows a group of the walk
constexpr int F_TY = F_BM / F_TM, F_TX = F_BN / F_TN;  // threads along M, N
constexpr int F_THREADS = F_TY * F_TX;                // consumer threads
constexpr int F_WN = F_TX / 8;             // warps (4 x 8 threads) along N
constexpr int F_A = F_BM * F_BK;           // floats of x's box, [BM][BK]
constexpr int F_B = F_BK * F_BN;           // floats of y's box, [BK][BN]
constexpr int F_STAGE = F_A + F_B;
constexpr int F_SMEM = F_STAGES * F_STAGE * 4 + 1024 + 16 * F_STAGES;
static_assert(F_TM % 4 == 0 && F_TN % 4 == 0 && F_TY % 4 == 0 &&
                  F_TX % 8 == 0 && F_BK % 4 == 0 && F_THREADS % 128 == 0 &&
                  (F_A * 4) % 1024 == 0 && (F_STAGE * 4) % 1024 == 0 &&
                  F_BM <= 256 && F_BN <= 256 && F_STAGES >= 2,
              "float32 tile shape");
static_assert(F_SMEM <= 232448 - (int)sizeof(sp_prog::Decoded<float>),
              "float32 ring too large");

// A producer warpgroup (thread 0 issues the loads; 40 registers a thread)
// and the F_THREADS consumer threads (232 registers a thread).
constexpr int T_THREADS = 128 + F_THREADS;
static_assert(128 * 40 + F_THREADS * 232 <= 65536 - 1024,
              "float32 register split");

template <bool kProgram>
__global__ void __launch_bounds__(T_THREADS, 1)
sgemm_tma(const __grid_constant__ CUtensorMap map_x,
          const __grid_constant__ CUtensorMap map_y, float* __restrict__ C,
          int64_t M, int64_t N, int K, const __grid_constant__ Program prog) {
  constexpr int S = F_STAGES;
  extern __shared__ uint8_t tsmem[];
  __shared__ sp_prog::Decoded<float> sprog;
  // an offset from tsmem, not an integer cast, so that the fragment loads
  // stay shared-memory loads (LDS) and do not become generic ones
  float* ring = reinterpret_cast<float*>(
      tsmem + ((1024 - (smem_u32(tsmem) & 1023)) & 1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * F_STAGE);
  uint64_t* empty = full + S;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], F_THREADS / 32);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (kProgram) {
    sp_prog::decode(prog, nullptr, 0, sprog);  // and the barrier
  } else {
    __syncthreads();
  }
  const int64_t tiles_m = (M + F_BM - 1) / F_BM;
  const int64_t tiles_n = (N + F_BN - 1) / F_BN;
  const int64_t tiles = tiles_m * tiles_n;
  const int nk = (K + F_BK - 1) / F_BK;

  if (threadIdx.x < 128) {
    // ---- producer: keeps the ring full, across tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
        int64_t tm, tn;
        tile_at(t, tiles_m, tiles_n, F_GROUP_M, tm, tn);
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % S;
          mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          float* a = ring + s * F_STAGE;
          mbar_expect_tx(&full[s], F_STAGE * 4);
          tma_load(a, &map_x, &full[s], kb * F_BK, (int)(tm * F_BM));
          tma_load(a + F_A, &map_y, &full[s], (int)(tn * F_BN), kb * F_BK);
        }
      }
    }
    return;
  }
  // ---- consumers: the F_TY x F_TX threads, warps of 4 x 8
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = threadIdx.x - 128, lane = c & 31, warp = c >> 5;
  const int ty = (warp / F_WN) * 4 + lane / 8;
  const int tx = (warp % F_WN) * 8 + lane % 8;
  constexpr int SM = F_BM * 4 / F_TM, SN = F_BN * 4 / F_TN;
  float acc[F_TM][F_TN];
  int it = 0;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    int64_t tm, tn;
    tile_at(t, tiles_m, tiles_n, F_GROUP_M, tm, tn);
#pragma unroll
    for (int i = 0; i < F_TM; ++i)
#pragma unroll
      for (int j = 0; j < F_TN; ++j) acc[i][j] = 0.0f;
    for (int kb = 0; kb < nk; ++kb, ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      const float* As = ring + s * F_STAGE;
      const float* Bs = As + F_A;
#pragma unroll
      for (int kq = 0; kq < F_BK; kq += 4) {
        float4 a4[F_TM];
#pragma unroll
        for (int i = 0; i < F_TM; ++i)
          a4[i] = *reinterpret_cast<const float4*>(
              As + ((i / 4) * SM + ty * 4 + i % 4) * F_BK + kq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float b[F_TN];
#pragma unroll
          for (int j = 0; j < F_TN / 4; ++j) {
            const float4 v = *reinterpret_cast<const float4*>(
                Bs + (kq + e) * F_BN + j * SN + tx * 4);
            b[4 * j] = v.x; b[4 * j + 1] = v.y; b[4 * j + 2] = v.z;
            b[4 * j + 3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < F_TM; ++i) {
            const float a = e == 0 ? a4[i].x : e == 1 ? a4[i].y
                          : e == 2 ? a4[i].z : a4[i].w;
#pragma unroll
            for (int j = 0; j < F_TN; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
          }
        }
      }
      // every lane of the warp has read the stage: free it
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    const int64_t row0 = tm * F_BM, col0 = tn * F_BN;
    auto row_of = [&](int i) { return row0 + (i / 4) * SM + ty * 4 + i % 4; };
    auto col_of = [&](int j) { return col0 + (j / 4) * SN + tx * 4 + j % 4; };
    if constexpr (!kProgram) {
#pragma unroll
      for (int i = 0; i < F_TM; ++i)
#pragma unroll
        for (int j = 0; j < F_TN; j += 4)
          store_four(C, row_of(i), col_of(j), M, N, acc[i][j], acc[i][j + 1],
                     acc[i][j + 2], acc[i][j + 3]);
    } else {
      constexpr int QN = F_TN / 4;
#pragma unroll 1
      for (int q = 0; q < F_TM * QN; ++q) {
        float v[4], o[4];
        pick<0, F_TM * QN>(q, v, [&](auto cq, float (&w)[4]) {
          constexpr int Q = decltype(cq)::value;
#pragma unroll
          for (int e = 0; e < 4; ++e) w[e] = acc[Q / QN][(Q % QN) * 4 + e];
        });
        sp_prog::run_program<float, 4, SP_NREG, true>(sprog, v, o);
        store_four(C, row_of(q / QN), col_of((q % QN) * 4), M, N, o[0], o[1],
                   o[2], o[3]);
      }
    }
  }
}

// ---------------------------------------------------- bfloat16 / float16

constexpr int H_BM = 128;           // output rows a tile (two 64-row halves)
constexpr int H_BN = 256;           // output columns a tile
constexpr int H_BK = 64;            // K depth of a stage: one 128-byte row
constexpr int kStages = 4;          // stages of the ring
constexpr int kConsumers = 2;       // consumer warpgroups
constexpr int kHThreads = 128 * (1 + kConsumers);
constexpr int kGroupM = 8;          // tile rows a group of the walk
constexpr int kBoxN = 64;           // columns of y one TMA box holds
constexpr int kBoxBytes = H_BK * kBoxN * 2;  // one 64 x 64 box of y: 8 KB

constexpr int kABytes = H_BM * H_BK * 2;
constexpr int kBBytes = H_BK * H_BN * 2;
constexpr int kStageBytes = kABytes + kBBytes;
// the ring, 1024 bytes to align it for the swizzle, two barriers a stage
constexpr int kSmem = kStages * kStageBytes + 1024 + 16 * kStages;
// a block's shared memory on Hopper, less the static program copy
static_assert(kSmem <= 232448 - (int)sizeof(sp_prog::Decoded<float>),
              "ring too large");

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from touching the accumulators across the async mma.
template <int NR>
__device__ __forceinline__ void fence_acc(float (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma.mma_async m64nNk16, float32 accumulators d += A(desc da) B(desc db);
// A K-major, B MN-major (the transpose flag), d's registers listed out.
#define SP_WGMMA_N256(TY)                                            \
  asm volatile(                                                     \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                   \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"  \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                          \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                    \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                  \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                  \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                  \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                  \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                  \
      "%56, %57, %58, %59, %60, %61, %62, %63, "                  \
      "%64, %65, %66, %67, %68, %69, %70, %71, "                  \
      "%72, %73, %74, %75, %76, %77, %78, %79, "                  \
      "%80, %81, %82, %83, %84, %85, %86, %87, "                  \
      "%88, %89, %90, %91, %92, %93, %94, %95, "                  \
      "%96, %97, %98, %99, %100, %101, %102, %103, "              \
      "%104, %105, %106, %107, %108, %109, %110, %111, "          \
      "%112, %113, %114, %115, %116, %117, %118, %119, "          \
      "%120, %121, %122, %123, %124, %125, %126, %127"            \
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),           \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),           \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),         \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),       \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),       \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),       \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),       \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),       \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),       \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),       \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),       \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),       \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),       \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),       \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),       \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),       \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),       \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),       \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),       \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),       \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),       \
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),       \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),       \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),   \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),   \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),   \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),   \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),   \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),   \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])    \
      : "l"(da), "l"(db), "r"(1))

template <bool kBf16>
__device__ __forceinline__ void wgmma(float (&d)[H_BN / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (kBf16) {
    SP_WGMMA_N256("bf16");
  } else {
    SP_WGMMA_N256("f16");
  }
}

// 16-bit operands are handled as raw bits; only wgmma reads them as
// bfloat16 or float16.  Threads 0-127: the producer warpgroup (thread 0
// issues the loads); 128-383: the two consumer warpgroups.
template <bool kBf16, typename OutT>
__global__ void __launch_bounds__(kHThreads, 1)
hopper_gemm(const __grid_constant__ CUtensorMap map_x,
            const __grid_constant__ CUtensorMap map_y, OutT* __restrict__ C,
            int M, int N, int K, const __grid_constant__ Program prog) {
  constexpr int S = kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ sp_prog::Decoded<float> sprog;
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * kStageBytes);
  uint64_t* empty = full + S;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  sp_prog::decode(prog, nullptr, 0, sprog);  // and the barrier before the roles
  const int64_t tiles_m = (M + H_BM - 1) / H_BM;
  const int64_t tiles_n = (N + H_BN - 1) / H_BN;
  const int64_t tiles = tiles_m * tiles_n;
  const int nk = (K + H_BK - 1) / H_BK;

  if (threadIdx.x < 128) {
    // ---- producer: keeps the ring full, across tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
        int64_t tm, tn;
        tile_at(t, tiles_m, tiles_n, kGroupM, tm, tn);
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % S;
          mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          uint8_t* a = ring + s * kStageBytes;
          uint8_t* b = a + kABytes;
          mbar_expect_tx(&full[s], kStageBytes);
          tma_load(a, &map_x, &full[s], kb * H_BK, (int)(tm * H_BM));
#pragma unroll
          for (int j = 0; j < H_BN / kBoxN; ++j)
            tma_load(b + j * kBoxBytes, &map_y, &full[s],
                     (int)(tn * H_BN + j * kBoxN), kb * H_BK);
        }
      }
    }
  } else {
    // ---- consumers: 64 rows of the tile each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int half = threadIdx.x / 128 - 1;
    const int w = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    float acc[H_BN / 2];
    int it = 0;
    for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
      int64_t tm, tn;
      tile_at(t, tiles_m, tiles_n, kGroupM, tm, tn);
#pragma unroll
      for (int i = 0; i < H_BN / 2; ++i) acc[i] = 0.0f;
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int s = it % S;
        mbar_wait(&full[s], (it / S) & 1);
        const uint8_t* a = ring + s * kStageBytes;
        // x: K-major, 8-row groups 1024 bytes apart; y: MN-major, 64-column
        // boxes kBoxBytes apart, 8-row K groups 1024 bytes apart
        const uint64_t da = smem_desc(a + half * 64 * 128, 16, 1024);
        const uint64_t db = smem_desc(a + kABytes, kBoxBytes, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < H_BK / 16; ++kk)  // 16 deep: 32 bytes of a row
          wgmma<kBf16>(acc, da + (kk * 32 >> 4),  // of x, 16 rows of y
                           db + (kk * 16 * 128 >> 4));
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        fence_acc(acc);
        if (kb > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % S]);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (nk > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % S]);

      // epilogue: accumulator i holds row r0 + 8 * ((i / 2) % 2), column
      // c0 + 8 * (i / 4) + i % 2
      const int64_t r0 = tm * H_BM + half * 64 + w * 16 + lane / 4;
      const int64_t c0 = tn * H_BN + (lane % 4) * 2;
      if (sprog.n == 0) {
#pragma unroll
        for (int j = 0; j < H_BN / 8; ++j) {
          store_pair<OutT, kBf16>(C, r0, c0 + 8 * j, M, N, acc[4 * j],
                                  acc[4 * j + 1]);
          store_pair<OutT, kBf16>(C, r0 + 8, c0 + 8 * j, M, N,
                                  acc[4 * j + 2], acc[4 * j + 3]);
        }
      } else {
#pragma unroll 1
        for (int j = 0; j < H_BN / 8; ++j) {
          float v[4], o[4];
          pick<0, H_BN / 8>(j, v, [&](auto cj, float (&u)[4]) {
            constexpr int J = decltype(cj)::value;
#pragma unroll
            for (int e = 0; e < 4; ++e) u[e] = acc[4 * J + e];
          });
          sp_prog::run_program<float, 4, SP_NREG, true>(sprog, v, o);
          store_pair<OutT, kBf16>(C, r0, c0 + 8 * j, M, N, o[0], o[1]);
          store_pair<OutT, kBf16>(C, r0 + 8, c0 + 8 * j, M, N, o[2], o[3]);
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map of a row-major (rows, cols) matrix of ``type`` (``elem``
// bytes an element) with row stride ``ld`` elements, boxes of (box_rows,
// box_cols), zeros outside.
bool encode(CUtensorMap* map, const void* base, CUtensorMapDataType type,
            int elem, int64_t rows, int64_t cols, int64_t ld,
            uint32_t box_rows, uint32_t box_cols,
            CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * elem};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estride[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box,
            estride, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kBf16, typename OutT>
int launch_hopper(const void* x, int64_t ldx, const void* y, int64_t ldy,
                  void* out, int64_t M, int64_t N, int64_t K,
                  const Program& prog, cudaStream_t s) {
  CUtensorMap map_x, map_y;
  memset(&map_x, 0, sizeof(map_x));  // K == 0: no load is issued
  memset(&map_y, 0, sizeof(map_y));
  if (K > 0) {
    if (!aligned16(x) || !aligned16(y) || ldx % 8 != 0 || ldy % 8 != 0 ||
        ldx < K || ldy < N)
      return (int)cudaErrorMisalignedAddress;
    const CUtensorMapDataType type = kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
    if (!encode(&map_x, x, type, 2, M, K, ldx, H_BM, H_BK,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
        !encode(&map_y, y, type, 2, K, N, ldy, H_BK, kBoxN,
                CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
  }
  auto kernel = hopper_gemm<kBf16, OutT>;
  static bool attr_set = false;  // once a process for each instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = ((M + H_BM - 1) / H_BM) * ((N + H_BN - 1) / H_BN);
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  kernel<<<grid, kHThreads, kSmem, s>>>(
      map_x, map_y, static_cast<OutT*>(out), (int)M, (int)N, (int)K, prog);
  return (int)cudaGetLastError();
}

template <bool kProgram>
int launch_sgemm_tma(const void* x, int64_t ldx, const void* y, int64_t ldy,
                     void* out, int64_t M, int64_t N, int64_t K,
                     const Program& prog, cudaStream_t s) {
  CUtensorMap map_x, map_y;
  memset(&map_x, 0, sizeof(map_x));  // K == 0: no load is issued
  memset(&map_y, 0, sizeof(map_y));
  if (K > 0) {
    if (!aligned16(x) || !aligned16(y) || ldx % 4 != 0 || ldy % 4 != 0 ||
        ldx < K || ldy < N)
      return (int)cudaErrorMisalignedAddress;
    if (!encode(&map_x, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, M, K, ldx,
                F_BM, F_BK, CU_TENSOR_MAP_SWIZZLE_NONE) ||
        !encode(&map_y, y, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, K, N, ldy,
                F_BK, F_BN, CU_TENSOR_MAP_SWIZZLE_NONE))
      return (int)cudaErrorInvalidValue;
  }
  auto kernel = sgemm_tma<kProgram>;
  static bool attr_set = false;  // once a process for each instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = ((M + F_BM - 1) / F_BM) * ((N + F_BN - 1) / F_BN);
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  kernel<<<grid, T_THREADS, F_SMEM, s>>>(map_x, map_y,
                                         static_cast<float*>(out), M, N,
                                         (int)K, prog);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (M, K) with row stride ldx and y (K, N) with row stride ldy (elements),
// of one dtype (in_dtype: 1 float32, 2 bfloat16, 3 float16); out (M, N)
// contiguous, of out_dtype (float32, or the input dtype); program a
// Program (op_program.cuh) without a float64 instruction, or NULL for no
// epilogue.  When K > 0, a float32 x and y need 16-byte aligned bases and
// row strides of a multiple of 4 with ldx >= K and ldy >= N (columns past
// K or N are never read); a 16-bit operand needs a 16-byte aligned base
// and a row stride of a multiple of 8.  Returns cudaGetLastError() of
// the launch (0 on success).
int spartan_matmul(const void* x, int64_t ldx, const void* y, int64_t ldy,
                   void* out, int64_t M, int64_t N, int64_t K, int in_dtype,
                   int out_dtype, const void* program, void* stream) {
  Program prog;
  memset(&prog, 0, sizeof(prog));
  if (program != nullptr) prog = *static_cast<const Program*>(program);
  if (M < 1 || N < 1 || K < 0 || M > 0x7fffffff || N > 0x7fffffff ||
      K > 0x7fffffff || !program_fits(prog) || !program_is_float(prog) ||
      (out_dtype != DT_F32 && out_dtype != in_dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == DT_F32 && prog.n > 0)
    return launch_sgemm_tma<true>(x, ldx, y, ldy, out, M, N, K, prog, s);
  if (in_dtype == DT_F32)
    return launch_sgemm_tma<false>(x, ldx, y, ldy, out, M, N, K, prog, s);
  if (in_dtype == DT_BF16 && out_dtype == DT_F32)
    return launch_hopper<true, float>(x, ldx, y, ldy, out, M, N, K, prog, s);
  if (in_dtype == DT_BF16)
    return launch_hopper<true, uint16_t>(x, ldx, y, ldy, out, M, N, K, prog, s);
  if (in_dtype == DT_F16 && out_dtype == DT_F32)
    return launch_hopper<false, float>(x, ldx, y, ldy, out, M, N, K, prog, s);
  if (in_dtype == DT_F16)
    return launch_hopper<false, uint16_t>(x, ldx, y, ldy, out, M, N, K, prog, s);
  return (int)cudaErrorInvalidValue;
}

const char* spartan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
