// CSR sparse x dense matrix product balanced by nonzeros, for Hopper
// (sm_90a).
//
//   Y[i, :] = sum_{p in [indptr[i], indptr[i+1])} data[p] * B[indices[p], :]
//
// Replaces spartan_tpu/backend/kernels/spmm_pallas.py:windowed_spmm_traced
// (K5a), the Pallas SpMM kernel, and, launched once a row band, its
// sharded form sharded_windowed_spmm_traced (K5b).  On the TPU it needs a
// host-built pack (128-entry strips sharing one (128-row block, 1024-column
// window) pair), window DMAs of B transposed, and a one-hot matrix product
// through the MXU with f32 products split into bf16 hi/lo halves, all
// because Mosaic gathers only along 128 lanes and the TPU has no fast
// scatter.  A GPU warp reads any row of B directly, so the port reads the
// plain device CSR form (SparseArray.to_csr) and computes in f32
// throughout: no pack, no windows, no hi/lo split.  One launch takes any k
// up to 512 (the TPU kernel's 128-column strips are a Mosaic limit).
//
// What bounds it.  From device memory, the bytes: 8 a nonzero (indices,
// data), indptr, B (m*k*4) read once and Y (n*k*4) written once, at 3.35
// TB/s (H100 SXM).  In practice, the gathers: every nonzero reads one row
// of B (nnz*k*4 bytes, 5.1 GB for one ALS product at MovieLens-20M's shape
// and k = 64), from the 50 MB L2 when B fits there, as both ALS products'
// B do.  So the time follows the nonzeros, provided that the work is
// spread evenly over the warps and each warp keeps several rows of B in
// flight.
//
// Design:
//  * The unit of work is a segment: kSeg consecutive nonzeros of one row,
//    counted from the row's own start.  A row of at most kSeg nonzeros,
//    an empty one included, is one segment.  The work table seg_ptr
//    (n+1,) is the running sum of max(1, ceil(len/kSeg)) over the rows,
//    built on the device in each call (a row band's is kept with the
//    sharded pack), with no host sync; the grid is sized by the host-known
//    bound n + nnz/kSeg segments, and surplus warps exit at once.
//  * kSeg = 256 (tools/torch_spmm_seg_sweep.py on an H100): 128 and 256
//    time within the spread between runs, 512 is 4-17 % slower; 256 needs
//    half the scratch of 128 and half the partial rows read by pass 2.
//  * Pass 1, one warp a segment, 8 warps a block.  The warp finds its row
//    by a 32-ary search of seg_ptr (each lane probes one point, a ballot
//    narrows the range 32-fold; 4 steps for 2^17 rows).  It stages 32
//    (indices, data) pairs at a time with coalesced loads and broadcasts
//    them by __shfl_sync.  The warp is cut into groups of G lanes, G the
//    power of two that covers a row of B in V-float pieces (V = 4, 16-byte
//    loads, when k % 4 == 0, B, Y and P then 16-byte aligned; else V =
//    1): at k = 64 two half warps each gather their own row of B.  Up to
//    8 steps of a batch are staged together, their gathers issued before
//    their sums, so that a warp keeps up to 16 rows of B in flight.
//    Group g sums the nonzeros g, g + 32/G, ... of each batch in turn;
//    a butterfly of __shfl_xor_sync then adds the groups (a + b == b + a,
//    so every lane holds the same bits).
//  * Segment 0 of a row writes Y's row; segment j >= 1 of a row writes
//    partial row seg_ptr[r] - r + j - 1 of the scratch P.  Those slots are
//    distinct over the rows and fewer than nnz/kSeg.  Pass 2, one warp a
//    row, adds a split row's partials up in a fixed order (groups of
//    lanes over strided partials, then the butterfly) and that total to
//    its Y row.
//  * Fixed order everywhere, rounded f32 products (__fmul_rn) and sums
//    (__fadd_rn), no atomics: the same input gives the same bits on every
//    run.  Since segments and batches are counted from each row's start,
//    a row's order does not depend on where the matrix (or a row band of
//    it) begins: a band's table is the whole table sliced and rebased, and
//    the sharded product (one launch a band) equals the unsharded one bit
//    for bit.  Offsets int64.
//
// The wrapper (backend/kernels/spmm.py) casts B to contiguous, aligned f32,
// builds seg_ptr, allocates Y and P, launches on PyTorch's current stream
// and raises on a non-zero return.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSeg = 256;  // nonzeros a segment; the wrapper's SEG
constexpr unsigned kFull = 0xffffffffu;

template <int V>
__device__ __forceinline__ void load(const float* __restrict__ p,
                                     float (&x)[V]);

template <>
__device__ __forceinline__ void load<1>(const float* __restrict__ p,
                                        float (&x)[1]) {
  x[0] = __ldg(p);
}

template <>
__device__ __forceinline__ void load<4>(const float* __restrict__ p,
                                        float (&x)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = q.x;
  x[1] = q.y;
  x[2] = q.z;
  x[3] = q.w;
}

template <int V>
__device__ __forceinline__ void store(float* __restrict__ p,
                                      const float (&x)[V]);

template <>
__device__ __forceinline__ void store<1>(float* __restrict__ p,
                                         const float (&x)[1]) {
  p[0] = x[0];
}

template <>
__device__ __forceinline__ void store<4>(float* __restrict__ p,
                                         const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

// Pass 1: one warp a segment (see the note above).
template <int V, int G, int J>
__global__ void __launch_bounds__(kThreads)
segment_pass(const int64_t* __restrict__ indptr,
             const int32_t* __restrict__ indices,
             const float* __restrict__ data, const float* __restrict__ B,
             float* __restrict__ Y, const int64_t* __restrict__ seg_ptr,
             float* __restrict__ P, int64_t n, int k) {
  constexpr int NG = 32 / G;  // groups a warp: pairs taken a step
  // steps staged together: at most 32 floats of B a lane, at most a batch
  constexpr int kU = 32 / (J * V) < G ? 32 / (J * V) : G;
  const int64_t w = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = (int)(threadIdx.x & 31);
  if (w >= seg_ptr[n]) return;  // w is the same on every lane of the warp
  // the row r with seg_ptr[r] <= w < seg_ptr[r + 1] (seg_ptr rises
  // strictly: every row has a segment)
  int64_t lo = 0, hi = n - 1;
  while (lo < hi) {
    const int64_t stride = (hi - lo + 32) / 32;
    const int64_t q = lo + lane * stride;
    const unsigned le = __ballot_sync(kFull, q <= hi && seg_ptr[q] <= w);
    lo += (31 - __clz(le)) * stride;  // lane 0 probes lo, always true
    hi = hi < lo + stride - 1 ? hi : lo + stride - 1;
  }
  const int64_t r = lo;
  const int64_t j = w - seg_ptr[r];
  const int64_t start = indptr[r] + j * kSeg;
  const int64_t row_end = indptr[r + 1];
  const int64_t end = start + kSeg < row_end ? start + kSeg : row_end;
  const int group = lane / G, lig = lane % G;
  float acc[J][V];
#pragma unroll
  for (int jj = 0; jj < J; ++jj)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[jj][e] = 0.0f;
  for (int64_t base = start; base < end; base += 32) {
    const int64_t p = base + lane;
    int col = 0;
    float a = 0.0f;
    if (p < end) {
      col = __ldg(indices + p);
      a = __ldg(data + p);
    }
    // kU steps of NG pairs at a time: the gathers of all kU steps are
    // issued before their sums, so each lane has kU pieces of B in flight
    const int cnt = (int)(end - base < 32 ? end - base : 32);
    for (int t0 = 0; t0 < cnt; t0 += kU * NG) {
      float v[kU];
      float x[kU][J][V];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int src = t0 + u * NG + group;  // < 32: kU * NG divides 32
        const int c = __shfl_sync(kFull, col, src);
        v[u] = __shfl_sync(kFull, a, src);
        const float* __restrict__ b = B + (int64_t)c * k;
#pragma unroll
        for (int jj = 0; jj < J; ++jj) {
          const int cc = (lig + G * jj) * V;
          if (src < cnt && cc < k) load<V>(b + cc, x[u][jj]);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (t0 + u * NG + group >= cnt) continue;
#pragma unroll
        for (int jj = 0; jj < J; ++jj) {
          if ((lig + G * jj) * V >= k) continue;
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[jj][e] = __fadd_rn(acc[jj][e], __fmul_rn(v[u], x[u][jj][e]));
        }
      }
    }
  }
  // add the groups: lanes l and l ^ off each form the same sum
#pragma unroll
  for (int off = G; off < 32; off <<= 1)
#pragma unroll
    for (int jj = 0; jj < J; ++jj)
#pragma unroll
      for (int e = 0; e < V; ++e)
        acc[jj][e] = __fadd_rn(acc[jj][e],
                               __shfl_xor_sync(kFull, acc[jj][e], off));
  if (group != 0) return;
  float* __restrict__ dst =
      (j == 0 ? Y + r * (int64_t)k : P + (seg_ptr[r] - r + j - 1) * (int64_t)k);
#pragma unroll
  for (int jj = 0; jj < J; ++jj) {
    const int col = (lig + G * jj) * V;
    if (col < k) store<V>(dst + col, acc[jj]);
  }
}

// Pass 2: one warp a row.  A row of c > 1 segments adds its c - 1 partial
// rows to its Y row: group g of G lanes sums the partials g, g + 32/G, ...
// in turn, with the loads of up to 16 of them in flight a lane, the
// butterfly adds the groups, and the total is added to Y's row (segment
// 0's sum).  A fixed order, as in pass 1.
template <int V, int G, int J>
__global__ void __launch_bounds__(kThreads)
combine_pass(const int64_t* __restrict__ seg_ptr,
             const float* __restrict__ P, float* __restrict__ Y, int64_t n,
             int k) {
  constexpr int NG = 32 / G;
  constexpr int kU = 64 / (J * V) < 16 ? 64 / (J * V) : 16;
  const int64_t r = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = (int)(threadIdx.x & 31);
  if (r >= n) return;
  const int64_t parts = seg_ptr[r + 1] - seg_ptr[r] - 1;
  if (parts <= 0) return;  // the same on every lane of the warp
  const float* __restrict__ part = P + (seg_ptr[r] - r) * (int64_t)k;
  const int group = lane / G, lig = lane % G;
  float acc[J][V];
#pragma unroll
  for (int jj = 0; jj < J; ++jj)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[jj][e] = 0.0f;
  for (int64_t q0 = 0; q0 < parts; q0 += kU * NG) {
    float x[kU][J][V];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t q = q0 + u * NG + group;
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        const int cc = (lig + G * jj) * V;
        if (q < parts && cc < k) load<V>(part + q * k + cc, x[u][jj]);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (q0 + u * NG + group >= parts) continue;
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        if ((lig + G * jj) * V >= k) continue;
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc[jj][e] = __fadd_rn(acc[jj][e], x[u][jj][e]);
      }
    }
  }
#pragma unroll
  for (int off = G; off < 32; off <<= 1)
#pragma unroll
    for (int jj = 0; jj < J; ++jj)
#pragma unroll
      for (int e = 0; e < V; ++e)
        acc[jj][e] = __fadd_rn(acc[jj][e],
                               __shfl_xor_sync(kFull, acc[jj][e], off));
  if (group != 0) return;
  float* __restrict__ y = Y + r * (int64_t)k;
#pragma unroll
  for (int jj = 0; jj < J; ++jj) {
    const int cc = (lig + G * jj) * V;
    if (cc >= k) continue;
    float sum[V];
    load<V>(y + cc, sum);
#pragma unroll
    for (int e = 0; e < V; ++e) sum[e] = __fadd_rn(sum[e], acc[jj][e]);
    store<V>(y + cc, sum);
  }
}

struct Args {
  const int64_t* indptr;
  const int32_t* indices;
  const float* data;
  const float* B;
  float* Y;
  const int64_t* seg_ptr;
  float* P;
  int64_t n;
  int k;
};

// Pass 1 over `blocks` blocks and, when a row can be split, pass 2.
template <int V, int G, int J>
int launch(const Args& a, int64_t blocks, bool split, cudaStream_t s) {
  segment_pass<V, G, J><<<(unsigned)blocks, kThreads, 0, s>>>(
      a.indptr, a.indices, a.data, a.B, a.Y, a.seg_ptr, a.P, a.n, a.k);
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || !split) return rc;
  combine_pass<V, G, J><<<(unsigned)((a.n + kWarps - 1) / kWarps), kThreads,
                          0, s>>>(a.seg_ptr, a.P, a.Y, a.n, a.k);
  return (int)cudaGetLastError();
}

// Pieces of V floats a row of B: G lanes a group (a power of two, at most
// 32) and J pieces a lane (a power of two).
template <int V>
int dispatch(const Args& a, int64_t blocks, bool split, cudaStream_t s) {
  const int pieces = (a.k + V - 1) / V;
  if (pieces <= 1) return launch<V, 1, 1>(a, blocks, split, s);
  if (pieces <= 2) return launch<V, 2, 1>(a, blocks, split, s);
  if (pieces <= 4) return launch<V, 4, 1>(a, blocks, split, s);
  if (pieces <= 8) return launch<V, 8, 1>(a, blocks, split, s);
  if (pieces <= 16) return launch<V, 16, 1>(a, blocks, split, s);
  if (pieces <= 32) return launch<V, 32, 1>(a, blocks, split, s);
  if (pieces <= 64) return launch<V, 32, 2>(a, blocks, split, s);
  if (pieces <= 128) return launch<V, 32, 4>(a, blocks, split, s);
  if (V == 1 && pieces <= 256) return launch<1, 32, 8>(a, blocks, split, s);
  return launch<1, 32, 16>(a, blocks, split, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// indptr int64 (n+1,), indices int32 (nnz,), data float32 (nnz,), B float32
// (m, k) row-major, Y float32 (n, k) row-major, seg_ptr int64 (n+1,) the
// work table for `seg` nonzeros a segment, P float32 (nnz/seg, k) scratch
// (may be null when nnz < seg), all contiguous on one device and 16-byte
// aligned when k % 4 == 0; 1 <= k <= 512 and seg equal to kSeg.  Launches
// pass 1 and, when a row can be split, pass 2.  Returns cudaGetLastError()
// of the launches (0 on success).
int spartan_spmm_csr(const void* indptr, const void* indices, const void* data,
                     const void* B, void* Y, const void* seg_ptr, void* P,
                     int64_t n, int64_t nnz, int k, int seg, void* stream) {
  if (n < 1 || nnz < 0 || k < 1 || k > 512 || seg != kSeg)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const int64_t*>(indptr),
               static_cast<const int32_t*>(indices),
               static_cast<const float*>(data), static_cast<const float*>(B),
               static_cast<float*>(Y), static_cast<const int64_t*>(seg_ptr),
               static_cast<float*>(P), n, k};
  const int64_t warps = n + nnz / kSeg;
  const int64_t blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // the pieces, and so the order of the sums, follow k alone
  const bool vec = k % 4 == 0;
  if (vec && !(aligned16(B) && aligned16(Y) && aligned16(P)))
    return (int)cudaErrorMisalignedAddress;
  const bool split = nnz / kSeg > 0;  // else no row is longer than kSeg
  return vec ? dispatch<4>(a, blocks, split, s)
             : dispatch<1>(a, blocks, split, s);
}

const char* spartan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
