// 3x3 zero-boundary stencil over a 2-D tile, shared by stencil3x3.cu (K4,
// unpadded storage) and stencil3x3_padded.cu (K6a, padded storage, and K6b,
// the same with halo rows from the neighbouring shards), for Hopper
// (sm_90a).
//
//   out[i, j] = (add[i, j] or 0) + sum_{k : tap k applied} c[k] * x[i + di - 1, j + dj - 1]
//
// with k = 3 * di + dj, taps in row-major (di, dj) order, starting from the
// add field (or zero), exactly as the TPU kernels' `acc = acc + c * slab`
// loop (spartan_tpu/backend/kernels/stencil_pallas.py:55-60, 203-211).
// Taps the caller marks as zero are skipped, as the TPU kernels skip them.
//
// Rounding: every multiply and add is its own IEEE-rounded op
// (__fmul_rn/__fadd_rn: nvcc never contracts them into an FMA), rounded to T
// after each op.  That is what torch does for `acc = acc + c * x` on a T
// tensor with a Python-float c (c cast to float32, opmath float32, result
// rounded to T), so the kernel equals its plain version bit for bit.
//
// What bounds it: the bytes.  Each output reads one x (plus the add field)
// and writes one value: 8 bytes a float32 cell (12 with add) against at most
// 18 flops, far below the card's 67 TFLOP/s float32 rate.
//
// Design (a simple first version): one block of 32 x 8 threads owns a
// 32-column x (8 * ST_RPT)-row output tile.  Each thread first loads its
// share of the tile plus a one-cell halo into registers (each warp reading
// rows of x coalesced, all of a thread's loads, and its add values, issued
// before any is used, so that enough bytes are in flight to cover the
// memory's latency), stores them to shared memory as float32, and after
// one barrier sums the nine taps of its ST_RPT outputs, which lie 8 rows
// apart so that each warp writes whole 32-wide rows.  Loads outside
// [lo_r, hi_r) x [lo_c, hi_c) read as zero: K4 passes the array's own
// bounds (the zero boundary), K6a the padded array's (its zero ring is the
// boundary).
//
// Halo rows (HAS_HALO, K6b, the row-band sharded form of K6a): row -1 of
// the interior is read from `top` and row n from `bot`, one row each of
// the padded width, instead of the ring.  They are the neighbouring
// shards' edge rows (zero at the global edge), so a band's taps are the
// same values in the same order as the whole field's under K6a, and the
// sharded sweep equals the unsharded one bit for bit.  The reference
// carries (8, C) halo blocks (stencil_pallas.py:281-293) because 8 rows
// is the TPU's sublane tile; one row is all a 3x3 stencil reads.  The
// reference adds the halo taps after the other taps (:219-233); here they
// enter the sum at their place in the tap order.  HAS_HALO = false is
// K4's and K6a's code, unchanged.  Outputs past the n x m interior are not written, so K6a
// leaves its output's ring untouched.  ST_RPT = 8 gives a 32 x 64 tile:
// with one output a thread (a 32 x 8 tile, as first written) too few loads
// were in flight and the kernel ran at 30 % of its byte bound on an NVIDIA
// H100 80GB HBM3 at 700 W, at 64-84 % with eight (PERF.md).  No cp.async
// or TMA yet.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define ST_TX 32
#define ST_TY 8
#define ST_RPT 8  // output rows a thread
#define ST_H (ST_TY * ST_RPT)                       // output rows a tile
#define ST_LOAD_ROWS ((ST_H + 2 + ST_TY - 1) / ST_TY)  // halo rows a thread

struct StencilCoeffs {
  float c[9];
  int applied;  // bit k set: tap k = 3 * di + dj is applied
};

__device__ __forceinline__ float st_to_float(float v) { return v; }
__device__ __forceinline__ float st_to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float st_to_float(__half v) {
  return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T st_from_float(float v);
template <>
__device__ __forceinline__ float st_from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 st_from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half st_from_float<__half>(float v) {
  return __float2half_rn(v);
}

// x: origin of the (logical) interior, row stride x_stride; loads outside
// [lo_r, hi_r) x [lo_c, hi_c) read as zero.  out and add: origin of the
// n x m interior, row stride out_stride.  One block per 32 x ST_H tile,
// tiles_x tiles across.
template <typename T, bool HAS_ADD, bool HAS_HALO>
__global__ void __launch_bounds__(ST_TX * ST_TY)
stencil3x3_tile_kernel(const T* __restrict__ x, int64_t x_stride,
                       int64_t lo_r, int64_t hi_r, int64_t lo_c, int64_t hi_c,
                       const T* __restrict__ add, T* __restrict__ out,
                       int64_t out_stride, int64_t n, int64_t m,
                       int64_t tiles_x, StencilCoeffs c,
                       const T* __restrict__ top, const T* __restrict__ bot) {
  __shared__ float tile[ST_H + 2][ST_TX + 2];
  const int64_t i0 = ((int64_t)blockIdx.x / tiles_x) * ST_H;
  const int64_t j0 = ((int64_t)blockIdx.x % tiles_x) * ST_TX;
  const int tx = (int)threadIdx.x, ty = (int)threadIdx.y;
  const int64_t j = j0 + tx;

  // every load first: the halo tile's rows ty, ty + 8, ... and columns tx,
  // tx + 32, then the add values of this thread's outputs
  float v[ST_LOAD_ROWS][2];
#pragma unroll
  for (int s = 0; s < ST_LOAD_ROWS; ++s) {
    const int r = ty + s * ST_TY;
    const int64_t gi = i0 - 1 + r;
    const bool row_in = r < ST_H + 2 && gi >= lo_r && gi < hi_r;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int q = tx + t * ST_TX;
      const int64_t gj = j0 - 1 + q;
      if constexpr (HAS_HALO) {
        const T* row = gi == -1 ? top : (gi == n ? bot : x + gi * x_stride);
        v[s][t] = (row_in && q < ST_TX + 2 && gj >= lo_c && gj < hi_c)
                      ? st_to_float(row[gj])
                      : 0.0f;
      } else {
        v[s][t] = (row_in && q < ST_TX + 2 && gj >= lo_c && gj < hi_c)
                      ? st_to_float(x[gi * x_stride + gj])
                      : 0.0f;
      }
    }
  }
  T acc[ST_RPT];
#pragma unroll
  for (int rr = 0; rr < ST_RPT; ++rr) {
    const int64_t i = i0 + ty + rr * ST_TY;
    acc[rr] = st_from_float<T>(0.0f);
    if constexpr (HAS_ADD) {
      if (i < n && j < m) acc[rr] = add[i * out_stride + j];
    }
  }
#pragma unroll
  for (int s = 0; s < ST_LOAD_ROWS; ++s) {
    const int r = ty + s * ST_TY;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int q = tx + t * ST_TX;
      if (r < ST_H + 2 && q < ST_TX + 2) tile[r][q] = v[s][t];
    }
  }
  __syncthreads();

#pragma unroll
  for (int rr = 0; rr < ST_RPT; ++rr) {
    const int64_t i = i0 + ty + rr * ST_TY;
    if (i >= n || j >= m) continue;
    const int r = ty + rr * ST_TY;
    T a = acc[rr];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      if (c.applied & (1 << k)) {
        const T prod = st_from_float<T>(
            __fmul_rn(c.c[k], tile[r + k / 3][tx + k % 3]));
        a = st_from_float<T>(__fadd_rn(st_to_float(a), st_to_float(prod)));
      }
    }
    out[i * out_stride + j] = a;
  }
}

// top and bot: the halo rows' column origins (HAS_HALO only, else unread).
template <typename T, bool HAS_ADD, bool HAS_HALO = false>
static int st_launch(const T* x, int64_t x_stride, int64_t lo_r, int64_t hi_r,
                     int64_t lo_c, int64_t hi_c, const T* add, T* out,
                     int64_t out_stride, int64_t n, int64_t m,
                     const StencilCoeffs& c, cudaStream_t stream,
                     const T* top = nullptr, const T* bot = nullptr) {
  const int64_t tiles_x = (m + ST_TX - 1) / ST_TX;
  const int64_t tiles = tiles_x * ((n + ST_H - 1) / ST_H);
  if (tiles < 1 || tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  stencil3x3_tile_kernel<T, HAS_ADD, HAS_HALO>
      <<<(unsigned)tiles, dim3(ST_TX, ST_TY), 0, stream>>>(
          x, x_stride, lo_r, hi_r, lo_c, hi_c, add, out, out_stride, n, m,
          tiles_x, c, top, bot);
  return (int)cudaGetLastError();
}

// coeffs: nine host floats, row-major; applied: the taps' bit mask.
static inline StencilCoeffs st_coeffs(const float* coeffs, int applied) {
  StencilCoeffs c;
  for (int k = 0; k < 9; ++k) c.c[k] = coeffs[k];
  c.applied = applied;
  return c;
}
