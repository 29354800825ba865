// Probe of the rate of random 4-byte gathers on Hopper (sm_90a), from the
// L2, from a block's own shared memory and from a thread-block cluster's
// distributed shared memory (DSMEM).  No package path calls it:
// tools/torch_dsmem_probe.py times it to decide whether the CSR SpMV
// (csrc/spmv_csr.cu, K3b and K3d) can gather x from a cluster's shared
// memory rather than from L2 sectors.
//
// Every thread of a block of kThreads draws kUnroll independent streams
// of uniform random indices (a 32-bit LCG each, the index its high bits
// scaled to the range by __umulhi, as urand's columns are uniform), loads
// the float at each and sums them; the loads of an iteration are all
// issued before its adds.  One store a thread keeps the loads alive.
//
//  * mode 0, L2: x is a float32 array of m floats in device memory,
//    gathered through the read-only path (__ldg), as K3b gathers x.
//  * mode 1, shared: each block fills ``window`` floats of dynamic shared
//    memory and gathers from them.
//  * mode 2, cluster: clusters of ``cluster`` blocks, each filling its
//    ``window`` floats; a gather's index in [0, cluster * window) names
//    the block (its rank) and the offset, and the load goes through
//    mapa.shared::cluster and ld.shared::cluster, so 1/cluster of them
//    land in the block's own shared memory.  The blocks meet at a cluster
//    barrier after the fill and before they exit (no block may leave while
//    another reads its shared memory).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 8;

__device__ __forceinline__ uint32_t mix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ void seed(uint32_t* s) {
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) s[u] = mix(t * kUnroll + u + 1);
}

__device__ __forceinline__ uint32_t next(uint32_t s) {
  return s * 1664525u + 1013904223u;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
gather_l2(const float* __restrict__ x, uint32_t m, int iters,
          float* __restrict__ out) {
  uint32_t s[kUnroll];
  seed(s);
  float acc = 0.0f;
  for (int i = 0; i < iters; ++i) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      s[u] = next(s[u]);
      v[u] = __ldg(x + __umulhi(s[u], m));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc += v[u];
  }
  out[blockIdx.x * kThreads + threadIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads)
gather_shared(uint32_t window, int iters, float* __restrict__ out) {
  extern __shared__ float win[];
  for (uint32_t i = threadIdx.x; i < window; i += kThreads)
    win[i] = (float)(i & 1023);
  __syncthreads();
  uint32_t s[kUnroll];
  seed(s);
  float acc = 0.0f;
  for (int i = 0; i < iters; ++i) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      s[u] = next(s[u]);
      v[u] = win[__umulhi(s[u], window)];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc += v[u];
  }
  out[blockIdx.x * kThreads + threadIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads)
gather_cluster(uint32_t window, uint32_t cluster, int iters,
               float* __restrict__ out) {
  extern __shared__ float win[];
  for (uint32_t i = threadIdx.x; i < window; i += kThreads)
    win[i] = (float)(i & 1023);
  cluster_sync();
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(win);
  const uint32_t span = window * cluster;
  uint32_t s[kUnroll];
  seed(s);
  float acc = 0.0f;
  for (int i = 0; i < iters; ++i) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      s[u] = next(s[u]);
      const uint32_t c = __umulhi(s[u], span);
      const uint32_t rank = c / window;
      uint32_t addr;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                   : "=r"(addr) : "r"(base + 4u * (c - rank * window)),
                     "r"(rank));
      asm volatile("ld.shared::cluster.f32 %0, [%1];"
                   : "=f"(v[u]) : "r"(addr) : "memory");
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc += v[u];
  }
  cluster_sync();
  out[blockIdx.x * kThreads + threadIdx.x] = acc;
}

cudaLaunchConfig_t cluster_config(int blocks, int cluster, size_t smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

int set_attributes(const void* kernel, size_t smem, int cluster) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return (int)e;
}

}  // namespace

extern "C" {

// The threads a block of every mode.
int spartan_dsmem_probe_threads() { return kThreads; }

// One launch of ``blocks`` blocks of mode 0 (x float32 (m,) in device
// memory), 1 (``window`` floats of shared memory a block) or 2 (clusters
// of ``cluster`` blocks of ``window`` floats; ``blocks`` a multiple of
// it), each thread making iters * kUnroll gathers and writing one float of
// ``out`` (blocks * kThreads,).  Returns cudaGetLastError() of the launch.
int spartan_dsmem_probe(int mode, int blocks, int cluster, int64_t window,
                        const void* x, int64_t m, int iters, void* out,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* y = static_cast<float*>(out);
  const size_t smem = (size_t)window * 4;
  if (mode == 0) {
    gather_l2<<<blocks, kThreads, 0, s>>>(static_cast<const float*>(x),
                                          (uint32_t)m, iters, y);
    return (int)cudaGetLastError();
  }
  if (mode == 1) {
    int e = set_attributes((const void*)gather_shared, smem, 1);
    if (e) return e;
    gather_shared<<<blocks, kThreads, smem, s>>>((uint32_t)window, iters, y);
    return (int)cudaGetLastError();
  }
  if (mode != 2 || cluster < 1 || blocks % cluster != 0)
    return (int)cudaErrorInvalidValue;
  int e = set_attributes((const void*)gather_cluster, smem, cluster);
  if (e) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(blocks, cluster, smem, s, attr);
  cudaError_t r = cudaLaunchKernelEx(&cfg, gather_cluster, (uint32_t)window,
                                     (uint32_t)cluster, iters, y);
  return r != cudaSuccess ? (int)r : (int)cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters of mode 2 at ``cluster`` blocks of
// ``window`` floats of shared memory, into *active.  Returns its error.
int spartan_dsmem_probe_clusters(int cluster, int64_t window, int* active) {
  const size_t smem = (size_t)window * 4;
  int e = set_attributes((const void*)gather_cluster, smem, cluster);
  if (e) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(cluster, cluster, smem, 0, attr);
  return (int)cudaOccupancyMaxActiveClusters(active, gather_cluster, &cfg);
}

const char* spartan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
