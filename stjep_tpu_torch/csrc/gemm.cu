// Tiled f32 GEMM: the BiLSTM sweeps' input projections (K1,
// ops/lstm_pallas.py `input_projections`).
//
// Replaces the input projection of stjep_tpu/ops/lstm_pallas.py
// `_bilstm_kernel`, which the TPU ran on its MXU inside the kernel. The
// decode kernels' products are phases of their fused launches
// (decode_fused.cuh).
//
// What bounds it on the H100: the pyramid's input projections are large
// products, bound by f32 CUDA-core throughput (67 TFLOP/s peak), since this
// kernel uses no tensor cores.
// Design: a plain shared-memory tiled SGEMM, 64 columns per block and
// 16 or 64 rows (TM = 1 or 4 rows per thread) so a 16-row product does not
// compute 48 wasted rows, with the next K tile prefetched into registers.
// Decode-sized products have too few output tiles to fill 132 SMs and are
// bound by load latency, so the wrapper splits K across blocks and a second
// kernel sums the partials in a fixed order (deterministic, no atomics).
// Bias, ReLU and residual are fused into the epilogue. wgmma/TMA tiles are
// later work.

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
