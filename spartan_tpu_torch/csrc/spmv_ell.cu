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
// cols/vals read once, plus x and y: n*k*8 + 4*(m + n) bytes at 3.35 TB/s
// (H100 SXM).  x is at most 32768 floats (128 KB) when SpMVExpr picks this
// kernel, but each SM's gathers of it through L1 pull nearly all of its
// 32-byte sectors (8,937 random gathers an SM over 4,096 sectors at
// n = 32768, k = 36), and 4-byte loads of a 144-byte row at 32 lanes leave
// 28 lanes idle in a row's second round.
//
// Design (on chip), where x fits in a block's shared memory (m <= kMaxX,
// spmv.ell_on_chip):
//  * One persistent block of kThreads an SM.  Each block copies all of x
//    into its shared memory with cp.async.bulk, signalled by an mbarrier
//    (expect_tx of x's whole 16-byte pieces; the last m % 4 floats by plain
//    loads), and meanwhile loads its first rows of cols/vals.  Gathers of
//    x[c] then read the block's own shared memory (ld.shared).  Both halves
//    are needed: x through L1 with the 16-byte loads below, or x on chip
//    with a row in two rounds of 32 lanes, each measured no faster than the
//    design before (PERF.md).  Clusters copying x by multicast measured
//    slower than each block's own copy (PERF.md).
//  * The rows of all bands are one sequence; block b owns an equal run of
//    it and walks it in passes of kRows rows a group slot, every load of a
//    pass issued before its first gather.
//  * A row's k entries are P = ceil(k / 4) pieces of 4 consecutive entries
//    (the last piece holds the k % 4 left over, if any).  Lane l of a row's
//    group of G = next_pow2(P) lanes (at most 32) takes pieces l, l + G,
//    ...  So at k = 36 a row takes one round of 9 of 16 lanes, not two of
//    32.  Where k % 4 == 0 and cols and vals start on 16 bytes (VEC = 4), a
//    piece is one 16-byte load of cols and one of vals; otherwise (VEC = 1)
//    it is up to four 4-byte loads of each.  The load width does not change
//    the sum.
//  * The sum of a row: lane l adds the products of its pieces' entries
//    (4l, 4l+1, 4l+2, 4l+3, then 4(l+G), ...) in that order to 0, each
//    product rounded (__fmul_rn, never contracted into an FMA); then the
//    group adds its lanes by a __shfl_down_sync tree (offset G/2 first).
//    One store a row, no atomics: the same bits on every run, whatever the
//    band or the alignment.  (The through-L1 form below sums entries l,
//    l + G, ... of lane l, G = next_pow2(k).)
//  * Pad entries (col 0, val 0) are multiplied like any other, as the
//    reference does (0 * x[0]): a non-finite x[0] gives NaN on both sides.
//
// Through L1 (the design before, for x past kMaxX floats, only under
// --sparse_force_onehot; counted by the wrapper): one block of 256 threads
// per 256/G rows of a band, G = next_pow2(k) lanes a row, 4-byte loads, x
// gathered through __ldg; blockIdx.y picks the band.
//
// One entry point, one launch over a table of up to SP_MAX_BANDS row
// bands, each with its own cols, vals and y pointers: spmv.spmv_ell
// launches one band, the whole matrix; the row-sharded form
// (spmv.sharded_onehot_spmv, replacing spmv_pallas.py:sharded_onehot_spmv,
// K3a sharded) launches its shards' bands at once.  Every row runs the same
// body whatever its band, so each row's sum is the unsharded one bit for
// bit, and a shard with its own storage needs no other kernel.
//
// The wrapper (backend/kernels/spmv.py) casts bf16/f16 operands to f32,
// allocates y, picks the form (spmv.ell_form), launches on PyTorch's
// current stream and raises on a non-zero return.

#include <cuda_runtime.h>
#include <stdint.h>

#define SP_MAX_BANDS 64  // spmv.MAX_BANDS

namespace {

// a block of the on-chip form, and the rows a group slot loads before it
// sums (tools/torch_spmv_time.py builds 1024 threads and 4 rows for its
// ablations)
constexpr int kThreads = 512;
constexpr int kRows = 8;
constexpr int kL2Threads = 256;  // a block of the through-L1 form
constexpr int kMaxX = 32768;     // floats of x the on-chip form holds

// One band of the table: its rows of cols/vals (n, k) and of y (n,), and
// the index of its first row in the sequence of all bands' rows.
struct Band {
  const int32_t* cols;
  const float* vals;
  float* y;
  int64_t start;
};

struct Bands {
  Band band[SP_MAX_BANDS];
  int64_t end;  // rows of all bands
  const float* x;
  int64_t k;
  int64_t m;
  int count;
  int64_t per;  // rows a block (on-chip form)
};

__device__ __forceinline__ int64_t band_rows(const Bands& t, int b) {
  return (b + 1 < t.count ? t.band[b + 1].start : t.end) - t.band[b].start;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The cols/vals of one piece of a row: entries at, at + 1, ... of which
// the first ``n`` (1..4; the row's entries left, at most 4) are the row's.
// VEC = 4 loads them as one 16-byte vector each (n is 4), VEC = 1 entry by
// entry.
template <int VEC>
struct Piece {
  int32_t c[4];
  float v[4];
  __device__ __forceinline__ void load(const int32_t* cols, const float* vals,
                                       int64_t at, int n) {
    if constexpr (VEC == 4) {
      const int4 c4 = __ldg(reinterpret_cast<const int4*>(cols + at));
      const float4 v4 = __ldg(reinterpret_cast<const float4*>(vals + at));
      c[0] = c4.x, c[1] = c4.y, c[2] = c4.z, c[3] = c4.w;
      v[0] = v4.x, v[1] = v4.y, v[2] = v4.z, v[3] = v4.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        c[e] = e < n ? __ldg(cols + at + e) : 0;
        v[e] = e < n ? __ldg(vals + at + e) : 0.0f;
      }
    }
  }
  __device__ __forceinline__ float add(float acc, const float* xs,
                                       int n) const {
    float g[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) g[e] = xs[c[e]];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (VEC == 4 || e < n) acc = __fadd_rn(acc, __fmul_rn(v[e], g[e]));
    return acc;
  }
};

// The entries of piece j of a row of k: 4, or the k % 4 left in the last.
__device__ __forceinline__ int piece_len(int64_t k, int j) {
  const int64_t left = k - 4 * (int64_t)j;
  return left < 4 ? (int)left : 4;
}

// A group slot's pass: rows base + r * kSlots + slot, r < kRows, of the
// sequence of all bands' rows below hi.  Each row's band (``band``, the
// thread's cursor, only grows along its walk), its index in that band (-1
// past hi), and its piece ``lane`` (lane < pieces).
template <int VEC, int kSlots>
__device__ __forceinline__ void load_pass(const Bands& t, int64_t base,
                                          int64_t hi, int slot, int lane,
                                          int pieces, int& band,
                                          Piece<VEC> (&p)[kRows],
                                          int (&row)[kRows],
                                          int (&row_band)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t at = base + (int64_t)r * kSlots + slot;
    row[r] = -1;
    if (at < hi) {
      while (band + 1 < t.count && at >= t.band[band + 1].start) ++band;
      row_band[r] = band;
      row[r] = (int)(at - t.band[band].start);
      if (lane < pieces)
        p[r].load(t.band[band].cols, t.band[band].vals,
                  (int64_t)row[r] * t.k + lane * 4, piece_len(t.k, lane));
    }
  }
}

// The on-chip form: see the note at the top.  G lanes a row, VEC entries a
// load.
template <int G, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
spmv_ell_onchip(const __grid_constant__ Bands t) {
  extern __shared__ __align__(16) float xs[];
  constexpr int kSlots = kThreads / G;
  const int m = (int)t.m;
  const int whole = m & ~3;  // floats in whole 16-byte pieces
  uint64_t* bar = reinterpret_cast<uint64_t*>(xs + ((m + 3) & ~3));
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barrier is set before the copy signals it
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"((uint32_t)whole * 4u)
                 : "memory");
    if (whole > 0)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n"
          :: "r"(smem_u32(xs)), "l"(t.x), "r"((uint32_t)whole * 4u),
             "r"(smem_u32(bar))
          : "memory");
  }
  if ((int)threadIdx.x < m - whole) xs[whole + threadIdx.x] =
      t.x[whole + threadIdx.x];

  const int lane = (int)(threadIdx.x & (G - 1));
  const int slot = (int)(threadIdx.x / G);
  const int pieces = (int)((t.k + 3) / 4);  // a row's pieces
  const int64_t lo = (int64_t)blockIdx.x * t.per;
  const int64_t hi = lo + t.per < t.end ? lo + t.per : t.end;
  int band = 0;
  while (band + 1 < t.count && lo >= t.band[band + 1].start) ++band;
  Piece<VEC> p[kRows];
  int row[kRows], row_band[kRows];
  load_pass<VEC, kSlots>(t, lo, hi, slot, lane, pieces, band, p, row,
                         row_band);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)) : "memory");
  }
  __syncthreads();  // the tail's plain stores
  for (int64_t base = lo; base < hi; base += (int64_t)kRows * kSlots) {
    if (base != lo)
      load_pass<VEC, kSlots>(t, base, hi, slot, lane, pieces, band, p, row,
                             row_band);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float acc = 0.0f;
      if (row[r] >= 0 && lane < pieces) {
        acc = p[r].add(acc, xs, piece_len(t.k, lane));
        const Band& bd = t.band[row_band[r]];
        for (int j = lane + G; j < pieces; j += G) {
          Piece<VEC> q;
          const int len = piece_len(t.k, j);
          q.load(bd.cols, bd.vals, (int64_t)row[r] * t.k + j * 4, len);
          acc = q.add(acc, xs, len);
        }
      }
      for (int o = G / 2; o > 0; o >>= 1)
        acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, o, G));
      if (lane == 0 && row[r] >= 0) t.band[row_band[r]].y[row[r]] = acc;
    }
  }
}

// The through-L1 form: rows [blockIdx.x * kL2Threads / G, ...) of band
// blockIdx.y, lane l of a row's group summing entries l, l + G, ... in
// order, then the shuffle tree.  Every lane of the warp reaches the
// shuffles (rows past n carry 0).
template <int G>
__global__ void __launch_bounds__(kL2Threads)
spmv_ell_l2(const __grid_constant__ Bands t) {
  const Band& b = t.band[blockIdx.y];
  const int64_t n = band_rows(t, blockIdx.y);
  // a whole block past its band's rows leaves before any shuffle
  if ((int64_t)blockIdx.x * (kL2Threads / G) >= n) return;
  const int64_t row = ((int64_t)blockIdx.x * kL2Threads + threadIdx.x) / G;
  const int lane = (int)(threadIdx.x & (G - 1));
  const int64_t k = t.k;
  float acc = 0.0f;
  if (row < n) {
    const int64_t base = row * k;
    for (int64_t j = lane; j < k; j += G) {
      acc = __fadd_rn(acc, __fmul_rn(b.vals[base + j],
                                     __ldg(t.x + b.cols[base + j])));
    }
  }
  for (int o = G / 2; o > 0; o >>= 1) {
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, o, G));
  }
  if (lane == 0 && row < n) b.y[row] = acc;
}

template <int G>
int launch_l2(const Bands& t, int64_t longest, cudaStream_t stream) {
  const int64_t blocks = (longest * G + kL2Threads - 1) / kL2Threads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  spmv_ell_l2<G><<<dim3((unsigned)blocks, (unsigned)t.count), kL2Threads, 0,
                   stream>>>(t);
  return (int)cudaGetLastError();
}

// Blocks of the on-chip form that run at once at the largest shared memory
// it takes (queried once a process).
template <int G, int VEC>
int resident_blocks(int* blocks) {
  static int cached = 0;
  if (cached > 0) {
    *blocks = cached;
    return 0;
  }
  auto kernel = spmv_ell_onchip<G, VEC>;
  const int smem = 4 * kMaxX + 16;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (sms * per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = cached = sms * per_sm;
  return 0;
}

template <int G, int VEC>
int launch_onchip(Bands& t, cudaStream_t stream) {
  int most = 0;
  int err = resident_blocks<G, VEC>(&most);
  if (err) return err;
  // as many blocks as run at once, fewer for a matrix of few rows
  const int64_t slots = kThreads / G;
  int64_t blocks = (t.end + slots - 1) / slots;
  if (blocks > most) blocks = most;
  t.per = (t.end + blocks - 1) / blocks;
  const size_t smem = (size_t)4 * ((t.m + 3) & ~int64_t(3)) + 16;
  spmv_ell_onchip<G, VEC><<<(unsigned)blocks, kThreads, smem, stream>>>(t);
  return (int)cudaGetLastError();
}

template <int VEC>
int by_group(Bands& t, int group, cudaStream_t s) {
  switch (group) {
    case 1: return launch_onchip<1, VEC>(t, s);
    case 2: return launch_onchip<2, VEC>(t, s);
    case 4: return launch_onchip<4, VEC>(t, s);
    case 8: return launch_onchip<8, VEC>(t, s);
    case 16: return launch_onchip<16, VEC>(t, s);
    case 32: return launch_onchip<32, VEC>(t, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One launch over ``count`` (1..SP_MAX_BANDS) bands: ``table`` holds four
// int64 a band, the addresses of its cols int32 (n, k), vals float32
// (n, k) and y float32 (n,), then n >= 1; all bands read one x float32
// (m,) with k entries a row and ``group`` lanes a row (1..32, a power of
// two).  ``on_chip`` 1 takes the on-chip form (x 16-byte aligned,
// m <= kMaxX, fewer than 2^31 rows; ``group`` covering ceil(k / 4) pieces;
// ``vec`` 4, 16-byte loads, where k % 4 == 0 and every band's cols and
// vals are 16-byte aligned, else 1), 0 the through-L1 form (``vec`` 1,
// ``group`` covering k).  Returns cudaGetLastError() of the launch (0 on
// success).
int spartan_spmv_ell(const void* table, int count, const void* x, int64_t m,
                     int64_t k, int group, int vec, int on_chip,
                     void* stream) {
  if (count < 1 || count > SP_MAX_BANDS || k < 1 || m < 1 ||
      (vec != 1 && vec != 4) || k % vec != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t* row = static_cast<const int64_t*>(table);
  Bands t = {};
  int64_t longest = 0, start = 0;
  for (int b = 0; b < count; ++b, row += 4) {
    if (row[3] < 1) return (int)cudaErrorInvalidValue;
    t.band[b] = {reinterpret_cast<const int32_t*>(row[0]),
                 reinterpret_cast<const float*>(row[1]),
                 reinterpret_cast<float*>(row[2]), start};
    start += row[3];
    if (row[3] > longest) longest = row[3];
  }
  t.end = start;
  t.x = static_cast<const float*>(x);
  t.k = k;
  t.m = m;
  t.count = count;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!on_chip) {
    if (vec != 1) return (int)cudaErrorInvalidValue;
    switch (group) {
      case 1: return launch_l2<1>(t, longest, s);
      case 2: return launch_l2<2>(t, longest, s);
      case 4: return launch_l2<4>(t, longest, s);
      case 8: return launch_l2<8>(t, longest, s);
      case 16: return launch_l2<16>(t, longest, s);
      case 32: return launch_l2<32>(t, longest, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (m > kMaxX || t.end >= (int64_t(1) << 31) ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  return vec == 4 ? by_group<4>(t, group, s) : by_group<1>(t, group, s);
}

const char* spartan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
