// CSR sparse matrix-vector product balanced by nonzeros, exact float32,
// for Hopper (sm_90a).
//
//   y[i] = sum_{p in [indptr[i], indptr[i+1])} data[p] * x[indices[p]]
//
// Replaces spartan_tpu/backend/kernels/spmv_pallas.py:
// windowed_unique_spmv_traced (K3c), the all-VPU Pallas kernel over the
// unique-rows pack.  That pack cuts the nonzeros into fixed grid steps of
// 8x128 slots whatever the row lengths, keeps each destination row once a
// strip so the scatter is a permutation and the sum stays float32 with no
// MXU dots, and reads x through windows of 1024 entries (_WIN).  What
// carries over: the work is cut by nonzeros, not by rows, the sum is
// float32 throughout, and where x is narrow the nonzeros are regrouped by
// window of x.
//
// What bounds it: the bytes, 8 a nonzero plus indptr, x and y, at 3.35 TB/s
// (H100 SXM).  A 4-byte gather of x from L2 moves a 32-byte sector, so a
// kernel that gathers from L2 moves four times the stream's bytes through
// it (20.0 M gathers, 640 MB, on ML-20M's R.T against a 160 MB stream).
//
// Two forms, chosen by the pack (spmv.pack_windowed_unique) and launched
// through one entry point and one kernel, a block of kThreads threads a
// chunk of kChunk nonzeros:
//
//  * Windowed, where x spans at most kMaxWindows windows of kWindow floats.
//    The pack holds a window-major copy of the CSR: for each window s, the
//    nonzeros of each row whose columns lie in [s*kWindow, (s+1)*kWindow),
//    rows in order, with window-local columns, as that window's own CSR
//    (indptr (S, n+1) into one storage, each window's nonzeros from a
//    16-byte boundary), cut into chunks counted from the window's start,
//    with each chunk's first row (and, after a window's chunks, the row of
//    its last nonzero).  The chunks run in window order, so the blocks
//    resident on an SM at any time read one window of x (128 KB): the
//    gathers hit in L1, and the L2 sees the stream, not a sector a
//    nonzero.  Each window's rows go to its own row of a partial scratch
//    (S, n); a last pass adds the S partials of each row in window order.
//    (A persistent form, one block an SM holding its window in shared
//    memory and walking chunks through a cp.async ring, ran slower with
//    2 or 3 walkers a block than these 8 blocks an SM: PERF.md.)
//  * Unwindowed, for wide x (the unique pack of a 2^22-node graph): the
//    CSR as it is, one window over all of it, x gathered from L2.
//
// In both, a thread's loads of the stream and its gathers of x are issued
// before the chunk's row marks (which wait on indptr), and the stream
// (indices, data) is read with an evict-first hint (__ldcs), so that x's
// lines stay in L1 and L2.
//
// Common to both, on one chunk: chunk_row[c] is the row holding the chunk's
// first nonzero.  The chunk marks in shared memory where each later row
// starts inside it (an atomic max keeps the last of several empty rows
// starting at one position; a max is order-free), and a max-scan gives
// every position its row.  The float32 products (__fmul_rn) then go
// through a chunk-wide segmented inclusive scan (thread, warp shuffles,
// warps in order), so the last position of each row's run holds the run's
// sum.  A row that lies wholly inside the chunk is stored; the run of a row
// that began in an earlier chunk goes to head[c]; the run of a row that
// began here and goes on past the chunk goes to tail[c] with its row in
// tail_row[c] (-1 if none).  A carry pass, one thread a chunk with a tail
// row, adds tail[c] and head[c'] of each later chunk of the window the row
// reaches, in chunk order.  Rows of zero length read 0 (the output is
// zeroed first).  No float atomics and a fixed summation order: the same
// bits on every run.
//
// The wrapper (backend/kernels/spmv.py: spmv_chunked) allocates y and the
// scratch, launches on PyTorch's current stream and raises on a non-zero
// return.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// threads a chunk and nonzeros a thread (a multiple of 4, for its 16-byte
// loads)
constexpr int kThreads = 256;
constexpr int kPer = 4;
constexpr int kChunk = kThreads * kPer;  // nonzeros a chunk; spmv.CHUNK
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// floats of x a window of the windowed form (spmv.WINDOW), windows at most
// (spmv.MAX_WINDOWS)
constexpr int kWindow = 32768;
constexpr int kMaxWindows = 8;
// the thread's loads of the stream and x before the row marks
// (tools/torch_spmv_time.py builds the other order, and the stream read
// without its evict-first hint, for its ablations)
constexpr bool kLoadsFirst = true;

// One window of the windowed form (one window over the whole CSR for the
// unwindowed form).
struct Window {
  int64_t base;     // offset of its first nonzero in indices/data
  int64_t end;      // one past its last nonzero
  int64_t chunk0;   // its first chunk's index in head/tail/tail_row
  int64_t nchunks;  // its chunks of kChunk from base
  int64_t rows;     // offset of its chunks' first rows in chunk_row
};

struct Windows {
  Window w[kMaxWindows];
  int count;
  bool windowed;           // chunk_row holds each window's last row too
  int vec;                 // indices and data are 16-byte aligned
  int64_t n;               // rows
  const int64_t* indptr;   // (count, n + 1)
  const int32_t* indices;  // window-local columns
  const float* data;
  const int64_t* chunk_row;
  const float* x;
  float* out;              // (count, n): each window's rows
  float* head;
  float* tail;
  int64_t* tail_row;
};

// The scan's shared state of one chunk.
struct ScanSmem {
  int rel[kChunk];  // each position's row, less the chunk's first row
  int warp_max[kWarps];
  int warp_flag[kWarps];
  float warp_sum[kWarps];
};

// Max-scan the row marks in sm.rel (rel[p] = k where row r_first + k
// starts at position p, else 0), segmented-scan the products v of this
// thread's kPer positions, and store each run: to out[row] for a row inside
// the chunk, to *head for the run of a row that began before the chunk, to
// *tail (its row to *tail_row) for one that goes on past it.  first_before:
// row r_first began before the chunk; row_end(k): one past row
// r_first + k's last nonzero, read for the chunk's last run only.
template <class RowEnd>
__device__ __forceinline__ void scan_store(ScanSmem& sm, int tid,
                                           const float (&v)[kPer], int len,
                                           int64_t r_first, bool first_before,
                                           int64_t s, RowEnd row_end,
                                           float* out, float* head,
                                           float* tail, int64_t* tail_row) {
  const int lane = tid & 31, warp = tid >> 5;
  const int p0 = tid * kPer;
  // block-wide inclusive max-scan: every position gets its row
  int rr[kPer];
  int run = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    run = max(run, sm.rel[p0 + j]);
    rr[j] = run;
  }
  int incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl = max(incl, up);
  }
  if (lane == 31) sm.warp_max[warp] = incl;
  int excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0;
  __syncthreads();
  for (int w = 0; w < warp; ++w) excl = max(excl, sm.warp_max[w]);
  // publish the rows: the segment flags below read the neighbours'
#pragma unroll
  for (int j = 0; j < kPer; ++j) sm.rel[p0 + j] = max(rr[j], excl);
  __syncthreads();

  // segmented inclusive scan: a row's run restarts at its first position
  bool start[kPer];
  float sv[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int p = p0 + j;
    start[j] = (p == 0) || (sm.rel[p] != sm.rel[p - 1]);
  }
  sv[0] = v[0];
#pragma unroll
  for (int j = 1; j < kPer; ++j)
    sv[j] = start[j] ? v[j] : __fadd_rn(sv[j - 1], v[j]);
  // (flag, sum) pairs combine as (f1 | f2, f2 ? s2 : s1 + s2)
  int flag = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) flag |= start[j];
  float sum = sv[kPer - 1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float s_up = __shfl_up_sync(kFull, sum, o);
    const int f_up = __shfl_up_sync(kFull, flag, o);
    if (lane >= o) {
      if (!flag) sum = __fadd_rn(s_up, sum);
      flag |= f_up;
    }
  }
  if (lane == 31) {
    sm.warp_flag[warp] = flag;
    sm.warp_sum[warp] = sum;
  }
  const float lane_sum = __shfl_up_sync(kFull, sum, 1);
  const int lane_flag = __shfl_up_sync(kFull, flag, 1);
  __syncthreads();
  float pre_sum = 0.0f;
  for (int w = 0; w < warp; ++w)
    pre_sum = sm.warp_flag[w] ? sm.warp_sum[w]
                              : __fadd_rn(pre_sum, sm.warp_sum[w]);
  // what runs into this thread's first position from the positions before
  // (thread 0's first position starts a run, so it never takes a carry)
  const float carry = lane == 0 ? pre_sum
                      : lane_flag ? lane_sum
                                  : __fadd_rn(pre_sum, lane_sum);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (start[j]) break;
    sv[j] = __fadd_rn(carry, sv[j]);
  }

  // the last position of each run stores it
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int p = p0 + j;
    if (p >= len) break;
    const bool last = p == len - 1;
    if (!last && sm.rel[p + 1] == sm.rel[p]) continue;
    const int k = sm.rel[p];
    const bool before = k == 0 && first_before;
    const bool after = last && row_end(k) > s + len;
    if (before) {
      *head = sv[j];
    } else if (after) {
      *tail = sv[j];
    } else {
      out[r_first + k] = sv[j];
    }
    if (last) *tail_row = (!before && after) ? r_first + k : -1;
  }
}

// -- the chunk pass ---------------------------------------------------------------

// The float32 products of positions p0 .. p0 + kPer - 1 of the chunk at s
// (0 past len).
__device__ __forceinline__ void products(const int32_t* __restrict__ indices,
                                         const float* __restrict__ data,
                                         const float* __restrict__ x,
                                         int64_t s, int p0, int len, int vec,
                                         float (&v)[kPer]) {
  const int64_t i0 = s + p0;
  if (vec && p0 + kPer <= len) {
#pragma unroll
    for (int q = 0; q < kPer; q += 4) {
      const float4 d = __ldcs(reinterpret_cast<const float4*>(data + i0 + q));
      const int4 ix = __ldcs(reinterpret_cast<const int4*>(indices + i0 + q));
      v[q] = __fmul_rn(d.x, __ldg(x + ix.x));
      v[q + 1] = __fmul_rn(d.y, __ldg(x + ix.y));
      v[q + 2] = __fmul_rn(d.z, __ldg(x + ix.z));
      v[q + 3] = __fmul_rn(d.w, __ldg(x + ix.w));
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      v[j] = (p0 + j < len) ? __fmul_rn(__ldcs(data + i0 + j),
                                        __ldg(x + __ldcs(indices + i0 + j)))
                            : 0.0f;
  }
}

// Chunk blockIdx.x of the windows' chunks (in window order).
__global__ void __launch_bounds__(kThreads)
chunk_pass(const __grid_constant__ Windows t) {
  __shared__ ScanSmem sm;
  const int tid = threadIdx.x;
  const int64_t chunk = blockIdx.x;
  int ws = 0;
  while (chunk >= t.w[ws].chunk0 + t.w[ws].nchunks) ++ws;
  const int64_t c = chunk - t.w[ws].chunk0;
  const int64_t s = t.w[ws].base + c * kChunk;
  const int64_t end = t.w[ws].end;
  const int len = (int)min((int64_t)kChunk, end - s);
  const int64_t* __restrict__ indptr = t.indptr + ws * (t.n + 1);
  const int64_t* __restrict__ rows = t.chunk_row + t.w[ws].rows;
  const float* __restrict__ x = t.x + (int64_t)ws * kWindow;
  const int64_t r_first = rows[c];
  // the last row that can start inside the chunk: the row holding the
  // next chunk's first nonzero, or for the last chunk the row holding the
  // last nonzero (the windowed table holds it; else found by bisection, so
  // trailing empty rows cost nothing)
  int64_t r_hi;
  if (c + 1 < t.w[ws].nchunks || t.windowed) {
    r_hi = rows[c + 1];
  } else {
    int64_t lo = r_first;
    r_hi = t.n - 1;
    while (lo < r_hi) {
      const int64_t mid = lo + (r_hi - lo + 1) / 2;
      if (indptr[mid] <= end - 1) lo = mid; else r_hi = mid - 1;
    }
  }
  const bool first_before = indptr[r_first] < s;
  const int p0 = tid * kPer;
#pragma unroll
  for (int q = 0; q < kPer; q += 4)
    *reinterpret_cast<int4*>(&sm.rel[p0 + q]) = make_int4(0, 0, 0, 0);
  float v[kPer];
  if constexpr (kLoadsFirst)
    products(t.indices, t.data, x, s, p0, len, t.vec, v);
  __syncthreads();
  // rows after r_first start strictly after s (r_first is the last row
  // starting at or before s)
  for (int64_t r = r_first + 1 + tid; r <= r_hi; r += kThreads) {
    const int64_t p = indptr[r] - s;
    if (p < len) atomicMax(&sm.rel[p], (int)(r - r_first));
  }
  if constexpr (!kLoadsFirst)
    products(t.indices, t.data, x, s, p0, len, t.vec, v);
  __syncthreads();
  scan_store(sm, tid, v, len, r_first, first_before, s,
             [=](int k) { return indptr[r_first + k + 1]; },
             t.out + ws * t.n, t.head + chunk, t.tail + chunk,
             t.tail_row + chunk);
}

// -- the carry pass and the window sum ---------------------------------------------

// One thread a chunk with a tail row: tail[c] plus head[c'] of each later
// chunk of its window that the row reaches, in chunk order.
__global__ void __launch_bounds__(kThreads)
carry_pass(const __grid_constant__ Windows t, int64_t nchunks) {
  const int64_t c = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (c >= nchunks) return;
  const int64_t r = t.tail_row[c];
  if (r < 0) return;
  int ws = 0;
  while (c >= t.w[ws].chunk0 + t.w[ws].nchunks) ++ws;
  const Window& w = t.w[ws];
  const int64_t end = t.indptr[ws * (t.n + 1) + r + 1];
  const int64_t last = w.chunk0 + w.nchunks;
  float sum = t.tail[c];
  for (int64_t c2 = c + 1;
       c2 < last && w.base + (c2 - w.chunk0) * kChunk < end; ++c2)
    sum = __fadd_rn(sum, t.head[c2]);
  t.out[ws * t.n + r] = sum;
}

// y[i] = the windows' partials of row i, added in window order.
__global__ void __launch_bounds__(kThreads)
window_sum(const float* __restrict__ partial, float* __restrict__ y,
           int64_t n, int count) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float sum = partial[i];
  for (int s = 1; s < count; ++s) sum = __fadd_rn(sum, partial[s * n + i]);
  y[i] = sum;
}

}  // namespace

extern "C" {

// y = A x for A (n x m) in CSR, y float32 (n,), x float32 (m,), scratch
// float32 (2 * nchunks + (count > 1 ? count * n : 0),) and tail_row int64
// (nchunks,), all contiguous on one device.
//
// Unwindowed (windows null, count 0): indptr int64 (n+1,), indices int32
// and data float32 (nnz,) as they are, chunk_row int64 (nchunks,) the row
// of nonzero c*1024, nchunks = ceil(nnz/1024).
//
// Windowed (count 1..8, m <= count*32768): indptr int64 (count, n+1) into
// the window-major storage indices int32 (window-local columns) and data
// float32, each window from a 16-byte boundary; windows holds four int64 a
// window: its first nonzero, one past its last, its chunks, and the offset
// in chunk_row of its chunks' first rows (its chunks + 1 entries, the last
// the row of the window's last nonzero); nchunks is the windows' chunks in
// all.
//
// Returns the first CUDA error of the launches (0 on success).
int spartan_spmv_chunked(const void* indptr, const void* indices,
                         const void* data, const void* chunk_row,
                         const void* x, void* y, void* scratch,
                         void* tail_row, int64_t n, int64_t m, int64_t nnz,
                         int64_t nchunks, const void* windows, int count,
                         void* stream) {
  if (n < 1 || n > 0x7fffffff || nnz < 1 || nchunks < 1 ||
      nchunks > 0x7fffffff || count < 0 || count > kMaxWindows ||
      (count == 0) != (windows == nullptr) ||
      (count > 0 && m > (int64_t)count * kWindow))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* carry = static_cast<float*>(scratch);
  Windows t = {};
  t.n = n;
  t.indptr = static_cast<const int64_t*>(indptr);
  t.indices = static_cast<const int32_t*>(indices);
  t.data = static_cast<const float*>(data);
  t.chunk_row = static_cast<const int64_t*>(chunk_row);
  t.x = static_cast<const float*>(x);
  t.head = carry;
  t.tail = carry + nchunks;
  t.tail_row = static_cast<int64_t*>(tail_row);
  t.vec = (reinterpret_cast<uintptr_t>(indices) & 15) == 0 &&
          (reinterpret_cast<uintptr_t>(data) & 15) == 0;
  t.windowed = count > 0;
  t.count = count > 0 ? count : 1;
  if (count == 0) {
    t.w[0] = {0, nnz, 0, nchunks, 0};
  } else {
    const int64_t* row = static_cast<const int64_t*>(windows);
    int64_t chunk0 = 0;
    for (int s = 0; s < count; ++s, row += 4) {
      t.w[s] = {row[0], row[1], chunk0, row[2], row[3]};
      chunk0 += row[2];
    }
    if (chunk0 != nchunks) return (int)cudaErrorInvalidValue;
  }
  // one window writes y itself; more write their partials, added below
  t.out = t.count == 1 ? static_cast<float*>(y) : carry + 2 * nchunks;
  cudaError_t err =
      cudaMemsetAsync(t.out, 0, (size_t)t.count * n * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  chunk_pass<<<(unsigned)nchunks, kThreads, 0, st>>>(t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  carry_pass<<<(unsigned)((nchunks + kThreads - 1) / kThreads), kThreads, 0,
               st>>>(t, nchunks);
  err = cudaGetLastError();
  if (err != cudaSuccess || t.count == 1) return (int)err;
  window_sum<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      t.out, static_cast<float*>(y), n, t.count);
  return (int)cudaGetLastError();
}

const char* spartan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
