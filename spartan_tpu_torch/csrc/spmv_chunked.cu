// CSR sparse matrix-vector product balanced by nonzeros, exact float32,
// for Hopper (sm_90a).
//
//   y[i] = sum_{p in [indptr[i], indptr[i+1])} data[p] * x[indices[p]]
//
// Replaces spartan_tpu/backend/kernels/spmv_pallas.py:
// windowed_unique_spmv_traced (K3c), the all-VPU Pallas kernel over the
// unique-rows pack.  That pack cuts the nonzeros into fixed grid steps of
// 8x128 slots whatever the row lengths, and keeps each destination row
// once a strip so the scatter is a permutation and the sum stays float32
// with no MXU dots.  What carries over: the work is cut by nonzeros, not by
// rows, and the sum is float32 throughout.  The TPU layout (strips, x
// windows, int8 inverse maps) does not: a block reads its chunk of the
// device CSR form directly.
//
// What bounds it: the bytes, as for K3b (csrc/spmv_csr.cu): 8 bytes a
// nonzero plus indptr, x and y, at 3.35 TB/s (H100 SXM).  Where K3b gives
// each row a lane group sized by the mean row length, so that one long row
// is walked by one group, here no block's work depends on the longest row.
//
// Design:
//  * Pass 1, one block of 256 threads per chunk of 1024 consecutive
//    nonzeros (4 a thread, 16-byte loads of indices and data where
//    aligned).  chunk_row[c] (built once per matrix by the wrapper's pack)
//    is the row holding the chunk's first nonzero.  The block marks in
//    shared memory where each later row starts inside the chunk (an atomic
//    max keeps the last of several empty rows starting at one position; a
//    max is order-free), and a block-wide max-scan gives every position its
//    row.  The float32 products (__fmul_rn) then go through a block-wide
//    segmented inclusive scan (thread, warp shuffles, warps in order), so
//    the last position of each row's run holds the run's sum.  A row that
//    lies wholly inside the chunk is stored to y.  The run of a row that
//    began in an earlier chunk goes to head[c]; the run of a row that began
//    here and goes on past the chunk goes to tail[c] with its row in
//    tail_row[c] (-1 if none).
//  * Pass 2, one thread per chunk with a tail row: tail[c] plus head[c'] of
//    each later chunk the row reaches, in chunk order, stored to y.  A row
//    spanning many chunks costs one add per chunk here.
//  * y is zeroed first (cudaMemsetAsync), so rows of zero length read 0.
//  * No float atomics and a fixed summation order: the result is the same
//    bits on every run.
//
// The wrapper (backend/kernels/spmv.py: spmv_chunked) allocates y and the
// carries, launches on PyTorch's current stream and raises on a non-zero
// return.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;
constexpr int kChunk = kThreads * kPer;  // nonzeros a block; the wrapper's CHUNK
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
chunk_pass(const int64_t* __restrict__ indptr,
           const int32_t* __restrict__ indices,
           const float* __restrict__ data,
           const int64_t* __restrict__ chunk_row,
           const float* __restrict__ x, float* __restrict__ y,
           float* __restrict__ head, float* __restrict__ tail,
           int64_t* __restrict__ tail_row, int64_t n, int64_t nnz,
           int64_t nchunks, int vec) {
  __shared__ int rel[kChunk];  // each position's row, less r_first
  __shared__ int warp_max[kWarps];
  __shared__ int warp_flag[kWarps];
  __shared__ float warp_sum[kWarps];
  __shared__ int64_t r_hi_shared;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t c = blockIdx.x;
  const int64_t s = c * kChunk;
  const int len = (int)min((int64_t)kChunk, nnz - s);
  const int64_t r_first = chunk_row[c];

  if (tid == 0) {
    // the last row that can start inside the chunk: the row holding the
    // next chunk's first nonzero, or for the last chunk the row holding
    // the last nonzero (found by bisection, so trailing empty rows cost
    // nothing)
    int64_t hi;
    if (c + 1 < nchunks) {
      hi = chunk_row[c + 1];
    } else {
      int64_t lo = r_first;
      hi = n - 1;
      while (lo < hi) {
        const int64_t mid = lo + (hi - lo + 1) / 2;
        if (indptr[mid] <= nnz - 1) lo = mid; else hi = mid - 1;
      }
    }
    r_hi_shared = hi;
  }
  for (int p = tid; p < kChunk; p += kThreads) rel[p] = 0;
  __syncthreads();
  const int64_t r_hi = r_hi_shared;
  // rows after r_first start strictly after s (r_first is the last row
  // starting at or before s)
  for (int64_t r = r_first + 1 + tid; r <= r_hi; r += kThreads) {
    const int64_t p = indptr[r] - s;
    if (p < len) atomicMax(&rel[p], (int)(r - r_first));
  }
  __syncthreads();

  // block-wide inclusive max-scan: every position gets its row
  const int p0 = tid * kPer;
  int rr[kPer];
  int run = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    run = max(run, rel[p0 + j]);
    rr[j] = run;
  }
  int incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl = max(incl, up);
  }
  if (lane == 31) warp_max[warp] = incl;
  int excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0;
  __syncthreads();
  for (int w = 0; w < warp; ++w) excl = max(excl, warp_max[w]);
#pragma unroll
  for (int j = 0; j < kPer; ++j) rr[j] = max(rr[j], excl);
  // publish the rows: the segment flags below read the neighbours'
#pragma unroll
  for (int j = 0; j < kPer; ++j) rel[p0 + j] = rr[j];

  // the float32 products of this thread's nonzeros
  float v[kPer];
  const int64_t i0 = s + p0;
  if (vec && p0 + kPer <= len) {
    const float4 d = __ldg(reinterpret_cast<const float4*>(data + i0));
    const int4 ix = __ldg(reinterpret_cast<const int4*>(indices + i0));
    v[0] = __fmul_rn(d.x, __ldg(x + ix.x));
    v[1] = __fmul_rn(d.y, __ldg(x + ix.y));
    v[2] = __fmul_rn(d.z, __ldg(x + ix.z));
    v[3] = __fmul_rn(d.w, __ldg(x + ix.w));
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      v[j] = (p0 + j < len)
                 ? __fmul_rn(data[i0 + j], __ldg(x + indices[i0 + j]))
                 : 0.0f;
  }
  __syncthreads();

  // segmented inclusive scan: a row's run restarts at its first position
  bool start[kPer];
  float sv[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int p = p0 + j;
    start[j] = (p == 0) || (rel[p] != rel[p - 1]);
  }
  sv[0] = v[0];
#pragma unroll
  for (int j = 1; j < kPer; ++j) sv[j] = start[j] ? v[j] : __fadd_rn(sv[j - 1], v[j]);
  // (flag, sum) pairs combine as (f1 | f2, f2 ? s2 : s1 + s2)
  int flag = start[0] | start[1] | start[2] | start[3];
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
    warp_flag[warp] = flag;
    warp_sum[warp] = sum;
  }
  const float lane_sum = __shfl_up_sync(kFull, sum, 1);
  const int lane_flag = __shfl_up_sync(kFull, flag, 1);
  __syncthreads();
  float pre_sum = 0.0f;
  for (int w = 0; w < warp; ++w)
    pre_sum = warp_flag[w] ? warp_sum[w] : __fadd_rn(pre_sum, warp_sum[w]);
  // what runs into this thread's first position from the positions before
  float carry;
  if (lane == 0) {
    carry = pre_sum;
  } else {
    carry = lane_flag ? lane_sum : __fadd_rn(pre_sum, lane_sum);
  }
  // (thread 0's first position starts a run, so it never takes a carry)
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
    if (p + 1 < len && rel[p + 1] == rel[p]) continue;
    const int64_t r = r_first + rel[p];
    const bool before = indptr[r] < s;
    const bool after = indptr[r + 1] > s + len;
    if (before) {
      head[c] = sv[j];
    } else if (after) {
      tail[c] = sv[j];
    } else {
      y[r] = sv[j];
    }
    if (p == len - 1) tail_row[c] = (!before && after) ? r : -1;
  }
}

__global__ void __launch_bounds__(kThreads)
carry_pass(const int64_t* __restrict__ indptr, const float* __restrict__ head,
           const float* __restrict__ tail,
           const int64_t* __restrict__ tail_row, float* __restrict__ y,
           int64_t nchunks) {
  const int64_t c = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (c >= nchunks) return;
  const int64_t r = tail_row[c];
  if (r < 0) return;
  const int64_t end = indptr[r + 1];
  float sum = tail[c];
  for (int64_t c2 = c + 1; c2 < nchunks && c2 * kChunk < end; ++c2)
    sum = __fadd_rn(sum, head[c2]);
  y[r] = sum;
}

}  // namespace

extern "C" {

// indptr int64 (n+1,), indices int32 (nnz,), data float32 (nnz,),
// chunk_row int64 (nchunks,) the row of nonzero c*1024, x float32 (m,),
// y float32 (n,), carry float32 (2*nchunks,) and tail_row int64
// (nchunks,) scratch, all contiguous on one device; nchunks =
// ceil(nnz/1024); vec: indices and data are 16-byte aligned.  Returns
// cudaGetLastError() of the launches (0 on success).
int spartan_spmv_chunked(const void* indptr, const void* indices,
                         const void* data, const void* chunk_row,
                         const void* x, void* y, void* carry, void* tail_row,
                         int64_t n, int64_t nnz, int vec, void* stream) {
  if (n < 1 || n > 0x7fffffff || nnz < 1) return (int)cudaErrorInvalidValue;
  const int64_t nchunks = (nnz + kChunk - 1) / kChunk;
  if (nchunks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(y, 0, (size_t)n * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  float* head = static_cast<float*>(carry);
  float* tail = head + nchunks;
  chunk_pass<<<(unsigned)nchunks, kThreads, 0, s>>>(
      static_cast<const int64_t*>(indptr), static_cast<const int32_t*>(indices),
      static_cast<const float*>(data), static_cast<const int64_t*>(chunk_row),
      static_cast<const float*>(x), static_cast<float*>(y), head, tail,
      static_cast<int64_t*>(tail_row), n, nnz, nchunks, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  carry_pass<<<(unsigned)((nchunks + kThreads - 1) / kThreads), kThreads, 0,
               s>>>(static_cast<const int64_t*>(indptr), head, tail,
                    static_cast<const int64_t*>(tail_row),
                    static_cast<float*>(y), nchunks);
  return (int)cudaGetLastError();
}

const char* spartan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
