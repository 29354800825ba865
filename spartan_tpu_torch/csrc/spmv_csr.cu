// CSR sparse matrix-vector product over a table of row bands, for Hopper
// (sm_90a).
//
//   y[i] = sum_{p in [indptr[i], indptr[i+1])} data[p] * x[indices[p]]
//
// Replaces spartan_tpu/backend/kernels/spmv_pallas.py:windowed_spmv_traced
// (K3b), the Pallas kernel for matrices past the one-hot kernel's reach,
// and sharded_windowed_spmv_traced (K3d), K3b over p row bands.  On the
// TPU K3b needs a host-built pack (8x128 strips sharing 1024-element
// windows of x, scalar-prefetched window ids) because Mosaic cannot gather
// from all of x; a GPU thread can, so the port reads plain CSR instead.
// CSR and not the ELL kernel again: past that size graphs are large and
// their row lengths skewed, and padded ELL reads every row at the longest
// row's width (about 2.5x the bytes on a uniform degree-16 graph, far more
// on a power-law one).
//
// What bounds it: the bytes.  One multiply-add per nonzero for 8 bytes of
// indices/data, plus indptr (8 bytes a row), x and y: nnz*8 + 8*(n+1) +
// 4*(m + n) bytes at 3.35 TB/s (H100 SXM).  x (16.8 MB at 2^22 float32
// entries) fits in the 50 MB L2, but each 4-byte gather of it moves a
// 32-byte L2 sector, so on a graph with random columns the gathers, not
// the HBM stream, are the larger traffic (2.15 GB of sectors at 2^22).
//
// Design:
//  * A group of G lanes (a power of two up to a warp, chosen by the wrapper
//    from the whole matrix's nnz/n) owns a row; lane l sums entries
//    start + l, start + l + G, ... of it in order, then the group adds its
//    lanes by a __shfl_down_sync tree.  One store a row, no atomics: the
//    same bits on every run, and a row of any length is correct (the group
//    loops over it).
//  * Each lane loads its row's indptr pair (the G lanes of a group read
//    one pair, a broadcast in L1) and walks the row, kUnroll entries at a
//    time on a long row (all their loads, then all their gathers, then the
//    adds in order), so that a row of thousands of entries is not one
//    chain of dependent loads.  Forms with more loads in flight on short
//    rows (a warp's indptr loaded once into shared memory, 2-8 rows a
//    group issued together, fewer lanes a row, an evict-first hint on the
//    stream and an evict-last one on x) each measured slower on the urand
//    2^22 graph, and rows walked together made a warp wait on its longest
//    row at every round (PERF.md): there the kernel is bound by the L2's
//    sectors (67.1 M gathers of 32 bytes besides the stream), not by the
//    latency of one lane's chain.
//  * One entry point, one launch over a table of up to SP_MAX_BANDS row
//    bands, each with its own indptr (rebased to its first row), indices,
//    data and y and row count: blockIdx.y picks the band and blockIdx.x the
//    block within it; the grid's x covers the longest band and blocks past
//    a shorter band's rows exit.  spmv.spmv_csr launches one band, the
//    whole matrix (K3b); spmv.sharded_windowed_spmv_traced launches its
//    shards' bands at once (K3d), so a call pays one ramp and one tail,
//    not p.  Every row runs the same body with the whole matrix's G
//    whatever its band, so K3d's rows are K3b's bit for bit.
//
// The wrapper (backend/kernels/spmv.py) allocates y, launches on PyTorch's
// current stream and raises on a non-zero return.

#include <cuda_runtime.h>
#include <stdint.h>

#define SP_THREADS 256
#define SP_MAX_BANDS 64  // spmv.MAX_BANDS

namespace {

// entries a lane of a long row loads before it adds them
// (tools/torch_spmv_time.py builds other values for its ablations)
constexpr int kUnroll = 8;

// One band of the table: its rows' indptr (rebased: indptr[0] is the
// offset of its first nonzero in indices/data) and its y.
struct Band {
  const int64_t* indptr;
  const int32_t* indices;
  const float* data;
  float* y;
  int64_t n;
};

struct Bands {
  Band band[SP_MAX_BANDS];
  const float* x;
};

// Row ``row`` of a CSR band: lane l of the row's group of G sums entries
// start + l, start + l + G, ... in order (0 for a row past n).  A long row
// is walked kUnroll entries a lane at a time, their loads and then their
// gathers all issued before the first add, in the same order.
template <int G>
__device__ __forceinline__ float row_part(const int64_t* __restrict__ indptr,
                                          const int32_t* __restrict__ indices,
                                          const float* __restrict__ data,
                                          const float* __restrict__ x,
                                          int64_t row, int64_t n, int lane) {
  float acc = 0.0f;
  if (row >= n) return acc;
  const int64_t end = indptr[row + 1];
  int64_t p = indptr[row] + lane;
  for (; p + (kUnroll - 1) * G < end; p += kUnroll * G) {
    float d[kUnroll], v[kUnroll];
    int32_t c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      d[u] = data[p + u * G];
      c[u] = indices[p + u * G];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(x + c[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      acc = __fadd_rn(acc, __fmul_rn(d[u], v[u]));
  }
  for (; p < end; p += G)
    acc = __fadd_rn(acc, __fmul_rn(data[p], __ldg(x + indices[p])));
  return acc;
}

// Rows [blockIdx.x * SP_THREADS / G, (blockIdx.x + 1) * SP_THREADS / G) of
// band blockIdx.y, each group's lanes added by a shuffle tree.  Every lane
// of the warp reaches the shuffles (rows past n carry 0).
template <int G>
__global__ void __launch_bounds__(SP_THREADS)
spmv_csr_kernel(const __grid_constant__ Bands t) {
  // the band by value: its fields read once into registers
  const Band b = t.band[blockIdx.y];
  // a whole block past its band's rows leaves before any shuffle
  if ((int64_t)blockIdx.x * (SP_THREADS / G) >= b.n) return;
  const int64_t row = ((int64_t)blockIdx.x * SP_THREADS + threadIdx.x) / G;
  const int lane = (int)(threadIdx.x & (G - 1));
  float acc = row_part<G>(b.indptr, b.indices, b.data, t.x, row, b.n, lane);
  for (int o = G / 2; o > 0; o >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, o, G));
  if (lane == 0 && row < b.n) b.y[row] = acc;
}

template <int G>
int launch(const Bands& t, int count, int64_t longest, cudaStream_t stream) {
  const int64_t blocks = (longest * G + SP_THREADS - 1) / SP_THREADS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  spmv_csr_kernel<G><<<dim3((unsigned)blocks, (unsigned)count), SP_THREADS,
                       0, stream>>>(t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch over ``count`` (1..SP_MAX_BANDS) bands: ``table`` holds five
// int64 a band, the addresses of its indptr int64 (n+1,) (rebased, or not:
// it indexes the band's indices/data as given), indices int32, data
// float32 and y float32 (n,), then n >= 1; all bands read one x float32
// (m,) with ``group`` lanes a row (1..32, a power of two).  Returns
// cudaGetLastError() of the launch (0 on success).
int spartan_spmv_csr(const void* table, int count, const void* x, int group,
                     void* stream) {
  if (count < 1 || count > SP_MAX_BANDS) return (int)cudaErrorInvalidValue;
  const int64_t* row = static_cast<const int64_t*>(table);
  Bands t = {};
  int64_t longest = 0;
  for (int b = 0; b < count; ++b, row += 5) {
    if (row[4] < 1) return (int)cudaErrorInvalidValue;
    t.band[b] = {reinterpret_cast<const int64_t*>(row[0]),
                 reinterpret_cast<const int32_t*>(row[1]),
                 reinterpret_cast<const float*>(row[2]),
                 reinterpret_cast<float*>(row[3]), row[4]};
    if (row[4] > longest) longest = row[4];
  }
  t.x = static_cast<const float*>(x);
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
