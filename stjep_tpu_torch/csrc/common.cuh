// Shared helpers for the stjep_tpu_torch kernels (sm_90a, f32 throughout).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define STJEP_PAD 0
#define STJEP_EOS 3

// Every C entry point ends with this: a refused launch (too many threads,
// too much shared memory) never runs and is reported only here.
#define STJEP_RETURN_LAUNCH_STATUS() return (int)cudaGetLastError()

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum / max; every thread gets the result. `red` holds >= 32
// floats of shared memory. Contains __syncthreads(): call from all threads.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < nw ? red[lane] : 0.f;
  return warp_sum(t);
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < nw ? red[lane] : -INFINITY;
  return warp_max(t);
}

// (value, index) arg-max where the LOWEST index wins ties — the order of
// jnp.argmax and jax.lax.top_k. `rv`/`ri` hold >= 32 entries each.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void block_argmax(float& v, int& i, float* rv, int* ri) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, o);
    int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
  __syncthreads();
  if (lane == 0) { rv[warp] = v; ri[warp] = i; }
  __syncthreads();
  v = lane < nw ? rv[lane] : -INFINITY;
  i = lane < nw ? ri[lane] : 0x7fffffff;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, o);
    int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

// One barrier across every thread of every block of the cluster, in two
// halves: writes a thread made before its arrive (to its block's own or to
// a peer's shared memory) are visible to every thread of the cluster after
// the wait. Every thread arrives, then waits, once per phase.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 4-byte asynchronous copy global -> shared (cp.async), and its group
// bookkeeping: wait_group<N> returns once at most N of this thread's
// committed groups are still in flight.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Launch `kern` on `grid` in clusters of `csize` blocks along x (grid.x a
// multiple of csize) with `smem` bytes of dynamic shared memory. A cluster
// the card cannot hold (cudaOccupancyMaxActiveClusters = 0) is refused
// before the launch; every refusal comes back as the error code. With
// `max_clusters` non-null nothing launches: it gets the number of such
// clusters the card can run at once.
template <typename... Params, typename... Args>
int launch_cluster(void (*kern)(Params...), dim3 grid, int threads, size_t smem,
                   int csize, cudaStream_t stream, int* max_clusters,
                   Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (max_clusters) {
    *max_clusters = n;
    return 0;
  }
  if (n == 0) return (int)cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The largest dynamic shared memory a block may opt in to on this device.
inline size_t smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (size_t)bytes;
}

// Let kern take as much dynamic shared memory as a block may opt in to,
// less the kernel's static shared memory, once per kernel; *bytes (if
// given) gets that amount. The attribute holds one value per kernel: were
// it set to each launch's own need, a launch that asks for more than an
// earlier, smaller one would be refused. A refusal is returned and cleared
// from cudaGetLastError, so the next launch does not report it.
inline cudaError_t smem_allow_max(const void* kern, int* bytes = nullptr) {
  static const void* done[64];
  static int most[64];
  static int n = 0;
  for (int i = 0; i < n; ++i)
    if (done[i] == kern) {
      if (bytes) *bytes = most[i];
      return cudaSuccess;
    }
  cudaFuncAttributes fa = {};
  cudaError_t e = cudaFuncGetAttributes(&fa, kern);
  const int m = (int)smem_optin() - (int)fa.sharedSizeBytes;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, m);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  if (n < 64) {
    done[n] = kern;
    most[n++] = m;
  }
  if (bytes) *bytes = m;
  return cudaSuccess;
}

// Blocks a multiprocessor keeps resident for kern at `threads` threads and
// smem bytes, and the SM count. The kernel may take up to the opt-in
// maximum of shared memory (`smem_allow_max`), so a launch at any smem the
// card holds is allowed; the answer is asked of the card once per (kernel,
// smem) and cached.
template <typename Kern>
int resident(Kern kern, int threads, int smem, int* per_sm, int* sms) {
  static const void* keys[32];
  static int smems[32], vals[32];
  static int n_sm = 0;
  cudaError_t e;
  if (!n_sm) {
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)e;
  }
  *sms = n_sm;
  for (int i = 0; i < 32; ++i)
    if (keys[i] == (const void*)kern && smems[i] == smem) {
      *per_sm = vals[i];
      return 0;
    }
  if ((e = smem_allow_max((const void*)kern)) != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, threads, smem);
  if (e != cudaSuccess) return (int)e;
  for (int i = 0; i < 32; ++i)
    if (!keys[i]) {
      keys[i] = (const void*)kern;
      smems[i] = smem;
      vals[i] = *per_sm;
      break;
    }
  return 0;
}

// Launch kern cooperatively (its one argument `args`, by value): `grid`
// blocks, or with grid 0 every block the card keeps resident. A grid the
// card cannot hold is an error, returned; nothing falls back.
template <typename Kern, typename Args>
int launch_coop(Kern kern, const Args& args, int threads, int smem, int grid,
                cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  int e = resident(kern, threads, smem, &per_sm, &sms);
  if (e) return e;
  const int most = per_sm * sms;
  if (grid == 0) grid = most;
  if (most == 0 || grid > most || grid < 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {(void*)&args};
  e = (int)cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(threads), params,
                                       (size_t)smem, stream);
  if (e) return e;
  return (int)cudaGetLastError();
}

// One LSTM cell backward from the saved gate activations (i, f, g, o), the
// previous cell c_prev and dh_t = dL/dh_t (external + recurrent): writes
// dL/dpre for the four gates to dp[0], dp[H], dp[2H], dp[3H] and returns the
// cell cotangent passed to step t-1 (dc_t * f). dc is the carried dL/dc_t.
// The order of operations is stjep_tpu's (lstm_pallas_bwd.py `_bwd_kernel`,
// las_tf_flash.py `lstm_bwd`).
__device__ __forceinline__ float lstm_cell_bwd(float gi, float gf, float gg,
                                               float go, float c_prev,
                                               float dh_t, float dc, float* dp,
                                               int H) {
  const float tanh_c = tanhf(gf * c_prev + gi * gg);
  const float d_o = dh_t * tanh_c;
  const float dc_t = dc + dh_t * go * (1.f - tanh_c * tanh_c);
  const float di = dc_t * gg;
  const float df = dc_t * c_prev;
  const float dg = dc_t * gi;
  dp[0] = di * gi * (1.f - gi);
  dp[H] = df * gf * (1.f - gf);
  dp[2 * H] = dg * (1.f - gg * gg);
  dp[3 * H] = d_o * go * (1.f - go);
  return dc_t * gf;
}
