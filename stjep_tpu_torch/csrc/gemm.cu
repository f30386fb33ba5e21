// Tiled f32 GEMM and row LayerNorm: the shared building blocks of the
// decode and LAS kernels.
//
// Replaces the in-body matrix products of the Pallas kernels
// (stjep_tpu/ops/las_flash.py `_kernel`, stjep_tpu/ops/decode_flash.py
// `_self_core`/`_cross_core`/`_ffn_core`/`_head_topk`, and the input
// projection of stjep_tpu/ops/lstm_pallas.py `_bilstm_kernel`), which the
// TPU ran on its MXU inside each kernel.
//
// What bounds it on the H100: at decode shapes (M = B*K = 80 rows, K = 512)
// every weight is read once per launch, so the products are bound by the
// weight bytes and by launch latency, not by FLOPs; the large ones (the
// 512 x 30000 LAS head, the pyramid's input projections) by f32 CUDA-core
// throughput (67 TFLOP/s peak), since this kernel uses no tensor cores.
// Design: a plain shared-memory tiled SGEMM, 64 columns per block and
// 16 or 64 rows (TM = 1 or 4 rows per thread) so a 16-row product does not
// compute 48 wasted rows, with the next K tile prefetched into registers.
// Decode-sized products have too few output tiles to fill 132 SMs and are
// bound by load latency, so the wrapper splits K across blocks and a second
// kernel sums the partials in a fixed order (deterministic, no atomics).
// Bias, ReLU and residual are fused into the epilogue. wgmma/TMA tiles are
// later work.
//
// gemm_q8 is the same kernel with an int8 weight: it replaces the int8
// body of stjep_tpu/ops/decode_flash.py `_layer_kernel_q8` (:708) and
// `_chain_unpack`'s `quant=True` branch (:987-997), where the TPU
// dequantized each streamed matrix after its VMEM copy. Here the weight
// [K, N] stays int8 in device memory with one f32 scale per column, and each
// element is dequantized as its tile is loaded, float(q) * s[col]: one f32
// rounding, the value of JAX's `dq`, so the products and the summation order
// are those of gemm_f32 on the dequantized matrix. What bounds it: at decode
// rows (M = 5 .. 80) the weight bytes, now a quarter of f32's, and launch
// latency; the tile loop is the f32 one, so the kernel does not yet read
// int8 faster than it reads f32 (1-byte loads, 32 B per warp).

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int BN = 64;
constexpr int BK = 16;

// C[M,N] = act(A[M,K] @ B[K,N] + bias) + R over the K range of split
// blockIdx.z. 256 threads as 16x16; each thread owns TM rows (ty + 16*i) and
// 4 columns (tx + 16*j). The next K tile is loaded into registers while the
// current one is multiplied from shared memory. With one split the epilogue
// is applied here; with several, each split writes its raw partial tile to
// ws[z] and splitk_reduce_kernel sums them in a fixed order.
// Weight loaders: element (k, n) of the [K, N] weight, index k * ldb + n,
// through the read-only data cache.
struct F32Weight {
  const float* w;
  __device__ __forceinline__ float operator()(size_t idx, int k, int n) const {
    return __ldg(w + idx);
  }
};

struct Q8Weight {
  const int8_t* q;
  const float* s;  // [N] per-column scales
  __device__ __forceinline__ float operator()(size_t idx, int k, int n) const {
    return (float)__ldg(q + idx) * __ldg(s + n);
  }
};

template <int TM, typename Weight>
__global__ void __launch_bounds__(256) gemm_kernel(
    const float* __restrict__ A, const Weight Bm,
    const float* __restrict__ bias, const float* __restrict__ R,
    float* __restrict__ C, float* __restrict__ ws, int M, int N, int K,
    int lda, int ldb, int ldc, int ldr, int relu, int k_per_split) {
  constexpr int BM = 16 * TM;
  constexpr int AL = BM * BK / 256;  // A elements each thread loads per tile
  constexpr int BL = BK * BN / 256;  // B elements each thread loads per tile
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  float ra[AL], rb[BL];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < AL; ++q) {
      const int e = threadIdx.x + q * 256, m = e / BK, k = e % BK;
      const int gm = row0 + m, gk = k0 + k;
      ra[q] = (gm < M && gk < kend) ? A[(size_t)gm * lda + gk] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < BL; ++q) {
      const int e = threadIdx.x + q * 256, k = e / BN, n = e % BN;
      const int gk = k0 + k, gn = col0 + n;
      rb[q] = (gk < kend && gn < N) ? Bm((size_t)gk * ldb + gn, gk, gn) : 0.f;
    }
  };
  load(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
#pragma unroll
    for (int q = 0; q < AL; ++q) {
      const int e = threadIdx.x + q * 256;
      As[e % BK][e / BK] = ra[q];
    }
#pragma unroll
    for (int q = 0; q < BL; ++q) {
      const int e = threadIdx.x + q * 256;
      Bs[e / BN][e % BN] = rb[q];
    }
    __syncthreads();
    if (k0 + BK < kend) load(k0 + BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* P = ws ? ws + (size_t)blockIdx.z * M * N : nullptr;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= N) continue;
      if (P) {
        P[(size_t)r * N + c] = acc[i][j];
        continue;
      }
      float v = acc[i][j];
      if (bias) v += bias[c];
      if (relu) v = fmaxf(v, 0.f);
      if (R) v += R[(size_t)r * ldr + c];
      C[(size_t)r * ldc + c] = v;
    }
  }
}

// C = act(sum_z ws[z] + bias) + R, summing the splits in order z = 0, 1, ...
__global__ void splitk_reduce_kernel(const float* __restrict__ ws,
                                     const float* __restrict__ bias,
                                     const float* __restrict__ R,
                                     float* __restrict__ C, int M, int N,
                                     int splits, int ldc, int ldr, int relu) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)M * N) return;
  const int r = (int)(e / N), c = (int)(e % N);
  float v = 0.f;
  for (int z = 0; z < splits; ++z) v += ws[(size_t)z * M * N + e];
  if (bias) v += bias[c];
  if (relu) v = fmaxf(v, 0.f);
  if (R) v += R[(size_t)r * ldr + c];
  C[(size_t)r * ldc + c] = v;
}

// y = (x - mean) / sqrt(var + eps) * scale + bias, one block per row.
__global__ void layernorm_kernel(const float* __restrict__ X,
                                 const float* __restrict__ g,
                                 const float* __restrict__ b,
                                 float* __restrict__ Y, int N, float eps) {
  __shared__ float red[32];
  const float* x = X + (size_t)blockIdx.x * N;
  float* y = Y + (size_t)blockIdx.x * N;
  float s = 0.f;
  for (int c = threadIdx.x; c < N; c += blockDim.x) s += x[c];
  const float mean = block_sum(s, red) / (float)N;
  float v = 0.f;
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    const float d = x[c] - mean;
    v += d * d;
  }
  const float var = block_sum(v, red) / (float)N;
  const float inv = 1.f / sqrtf(var + eps);
  for (int c = threadIdx.x; c < N; c += blockDim.x)
    y[c] = (x[c] - mean) * inv * g[c] + b[c];
}

template <typename Weight>
int gemm_launch(const float* A, Weight B, const float* bias, const float* R,
                float* C, float* ws, int M, int N, int K, int lda, int ldb,
                int ldc, int ldr, int relu, int splits, cudaStream_t stream) {
  const int kps = ((K + splits - 1) / splits + BK - 1) / BK * BK;
  float* w = splits > 1 ? ws : nullptr;
  if (M <= 32) {
    dim3 grid((N + BN - 1) / BN, (M + 15) / 16, splits);
    gemm_kernel<1><<<grid, 256, 0, stream>>>(A, B, bias, R, C, w, M, N, K, lda,
                                             ldb, ldc, ldr, relu, kps);
  } else {
    dim3 grid((N + BN - 1) / BN, (M + 63) / 64, splits);
    gemm_kernel<4><<<grid, 256, 0, stream>>>(A, B, bias, R, C, w, M, N, K, lda,
                                             ldb, ldc, ldr, relu, kps);
  }
  if (splits > 1) {
    const size_t n = (size_t)M * N;
    splitk_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        ws, bias, R, C, M, N, splits, ldc, ldr, relu);
  }
  STJEP_RETURN_LAUNCH_STATUS();
}

}  // namespace

// splits > 1: ws holds splits * M * N floats of partial tiles; the wrapper
// picks the split count (stjep_tpu_torch/kernels.py `gemm`).
extern "C" int gemm_f32(const float* A, const float* B, const float* bias,
                        const float* R, float* C, float* ws, int M, int N,
                        int K, int lda, int ldb, int ldc, int ldr, int relu,
                        int splits, cudaStream_t stream) {
  return gemm_launch(A, F32Weight{B}, bias, R, C, ws, M, N, K, lda, ldb, ldc,
                     ldr, relu, splits, stream);
}

// B is the int8 weight [K, N] (row stride ldb) and scale its [N] f32 column
// scales; everything else as gemm_f32.
extern "C" int gemm_q8(const float* A, const int8_t* B, const float* scale,
                       const float* bias, const float* R, float* C, float* ws,
                       int M, int N, int K, int lda, int ldb, int ldc, int ldr,
                       int relu, int splits, cudaStream_t stream) {
  return gemm_launch(A, Q8Weight{B, scale}, bias, R, C, ws, M, N, K, lda, ldb,
                     ldc, ldr, relu, splits, stream);
}

extern "C" int layernorm_f32(const float* X, const float* g, const float* b,
                             float* Y, int M, int N, float eps,
                             cudaStream_t stream) {
  layernorm_kernel<<<M, 256, 0, stream>>>(X, g, b, Y, N, eps);
  STJEP_RETURN_LAUNCH_STATUS();
}
