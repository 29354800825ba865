// Padded-ELL sparse matrix-vector product, for Hopper (sm_90a).
//
//   y[i] = sum_j vals[i, j] * x[cols[i, j]]      cols/vals (n, k), x (m,)
//
// Replaces spartan_tpu/backend/kernels/spmv_pallas.py:spmv (K3a), the
// Pallas kernel that reads x through the MXU as an on-the-fly one-hot
// matrix because the TPU has no fast unstructured gather.  A GPU thread
// can gather x[c] directly, so none of that carries over.
//
// What bounds it: the bytes.  Each entry is one multiply-add for 8 bytes of
// cols/vals read once, plus the gathers of x; at the main path's widths x
// (at most 32768 floats when SpMVExpr picks this kernel) lives in L2, so the
// floor is n*k*8 + 4*(m + n) bytes at 3.35 TB/s (H100 SXM).
//
// Design:
//  * A group of G = min(32, next_pow2(k)) consecutive lanes owns one row;
//    lane l reads entries l, l+G, ... of the row, so a group's loads of
//    cols and vals are consecutive addresses and coalesce.
//  * Products are rounded f32 multiplies (__fmul_rn, never contracted into
//    an FMA), summed in registers per lane, then a __shfl_down_sync tree
//    inside the group.  One store per row, no atomics: the order of every
//    sum is fixed, so each run gives the same bits.
//  * Pad entries (col 0, val 0) are multiplied like any other, as the
//    reference does (0 * x[0]): a non-finite x[0] gives NaN on both sides.
//  * One entry point, one launch over a table of up to SP_MAX_BANDS row
//    bands, each with its own cols, vals and y pointers and row count:
//    blockIdx.y picks the band and blockIdx.x the block within it; the
//    grid's x covers the longest band and blocks past a shorter band's
//    rows exit.  spmv.spmv_ell launches one band, the whole matrix.  The
//    row-sharded form (spmv.sharded_onehot_spmv, replacing
//    spmv_pallas.py:sharded_onehot_spmv, K3a sharded) launches its shards'
//    bands at once: a band of a few thousand rows is a few hundred blocks,
//    too few to fill 132 SMs, so one launch a band paid its ramp and its
//    tail p times.  Every row runs the same body whatever its band, so
//    each row's sum is the unsharded one bit for bit, and a shard with
//    its own storage needs no other kernel.
//
// The wrapper (backend/kernels/spmv.py) casts bf16/f16 operands to f32,
// allocates y, launches on PyTorch's current stream and raises on a
// non-zero return.

#include <cuda_runtime.h>
#include <stdint.h>

#define SP_THREADS 256
#define SP_MAX_BANDS 64  // spmv.MAX_BANDS

// One band of the table: its rows of cols/vals (n, k) and of y (n,).
struct Band {
  const int32_t* cols;
  const float* vals;
  float* y;
  int64_t n;
};

struct Bands {
  Band band[SP_MAX_BANDS];
  const float* x;
  int64_t k;
};

// Rows [blockIdx.x * SP_THREADS / G, (blockIdx.x + 1) * SP_THREADS / G) of
// band blockIdx.y: lane l of a row's group sums entries l, l + G, ... in
// order, then the group adds its lanes by a shuffle tree.  Every lane of
// the warp reaches the shuffles (rows past n carry 0).
template <int G>
__global__ void __launch_bounds__(SP_THREADS)
spmv_ell_kernel(const __grid_constant__ Bands t) {
  const Band& b = t.band[blockIdx.y];
  // a whole block past its band's rows leaves before any shuffle
  if ((int64_t)blockIdx.x * (SP_THREADS / G) >= b.n) return;
  const int64_t row = ((int64_t)blockIdx.x * SP_THREADS + threadIdx.x) / G;
  const int lane = (int)(threadIdx.x & (G - 1));
  const int64_t k = t.k;
  float acc = 0.0f;
  if (row < b.n) {
    const int64_t base = row * k;
    for (int64_t j = lane; j < k; j += G) {
      acc = __fadd_rn(acc, __fmul_rn(b.vals[base + j],
                                     __ldg(t.x + b.cols[base + j])));
    }
  }
  for (int o = G / 2; o > 0; o >>= 1) {
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, o, G));
  }
  if (lane == 0 && row < b.n) b.y[row] = acc;
}

template <int G>
static int launch(const Bands& t, int count, int64_t longest,
                  cudaStream_t stream) {
  const int64_t blocks = (longest * G + SP_THREADS - 1) / SP_THREADS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  spmv_ell_kernel<G><<<dim3((unsigned)blocks, (unsigned)count), SP_THREADS,
                       0, stream>>>(t);
  return (int)cudaGetLastError();
}

extern "C" {

// One launch over ``count`` (1..SP_MAX_BANDS) bands: ``table`` holds four
// int64 a band, the addresses of its cols int32 (n, k), vals float32
// (n, k) and y float32 (n,), then n >= 1; all bands read one x float32
// (m,) with k entries a row and ``group`` lanes a row.  Returns
// cudaGetLastError() of the launch (0 on success).
int spartan_spmv_ell(const void* table, int count, const void* x,
                     int64_t k, int group, void* stream) {
  if (count < 1 || count > SP_MAX_BANDS || k < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t* row = static_cast<const int64_t*>(table);
  Bands t = {};
  int64_t longest = 0;
  for (int b = 0; b < count; ++b, row += 4) {
    if (row[3] < 1) return (int)cudaErrorInvalidValue;
    t.band[b] = {reinterpret_cast<const int32_t*>(row[0]),
                 reinterpret_cast<const float*>(row[1]),
                 reinterpret_cast<float*>(row[2]), row[3]};
    if (row[3] > longest) longest = row[3];
  }
  t.x = static_cast<const float*>(x);
  t.k = k;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 1: return launch<1>(t, count, longest, s);
    case 2: return launch<2>(t, count, longest, s);
    case 4: return launch<4>(t, count, longest, s);
    case 8: return launch<8>(t, count, longest, s);
    case 16: return launch<16>(t, count, longest, s);
    case 32: return launch<32>(t, count, longest, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* spartan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
