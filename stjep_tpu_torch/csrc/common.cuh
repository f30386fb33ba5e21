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
