// K8 backward: the reverse-time sweep of one bidirectional pyramid layer.
//
// Replaces stjep_tpu/ops/lstm_pallas_bwd.py `_tr_bwd` (body `_bwd_kernel`),
// which carried dh/dc in VMEM across a sequential grid and emitted the dPre
// streams. Per direction and step t (descending for the forward direction,
// ascending for the backward one):
//   dh_t   = g_out_t + dh                      (dh: the recurrent carry)
//   dPre_t = cell backward of the saved gates and c_{t-1} (common.cuh),
//            zero where t >= length
//   dh     = dPre_t @ W_hh^T,  dc = dc_t * f   (only where t < length: at a
//            padded step the carries keep their values and g_out_t is
//            dropped, exactly as the JAX kernel does)
// The dPre stream [dir][T][B][4H] goes back to the wrapper, which finishes
// dW_hh, dW_ih, db and dX as stream matmuls outside, as the JAX code does.
// The TPU kernel reads bf16 residual streams and W_hh in bf16; this one is
// the f32 variant, the JAX package's parity mode.
//
// What bounds it on the H100: as the forward, the serial chain. Each step
// does the BT x 4H x H product dPre @ W_hh^T in one block and reads
// W_hh^T (1 MB at H = 256) from L2. Design: K1's shape turned around: one
// block per (batch tile of BT rows, direction), 4H threads, the time loop
// inside. Threads j < H own column j of dh and dc (dc in registers, dh in
// shared memory) and compute the cell backward; then thread (q, k) sums a
// quarter of the contraction for output column k, reading W_hh^T
// ([4H, H], so a warp's reads are contiguous) and dPre from shared memory
// as broadcasts; the four quarter sums are added in a fixed order, so a
// run is deterministic.

#include "common.cuh"

namespace {

constexpr int BT = 8;  // batch rows per block

__global__ void __launch_bounds__(1024) bilstm_bwd_kernel(
    const float* __restrict__ gout, const float* __restrict__ cs,
    const float* __restrict__ gates, const float* __restrict__ whtf,
    const float* __restrict__ whtb, const int* __restrict__ lens,
    float* __restrict__ dxp, int B, int T, int H) {
  extern __shared__ float sm[];
  const int H4 = 4 * H;
  float* dh = sm;               // [BT][H] recurrent cotangent
  float* dp = sm + BT * H;      // [BT][4H] this step's dPre
  float* part = dp + BT * H4;   // [4][BT][H] quarter sums of dPre @ W_hh^T
  const int dir = blockIdx.y;
  const float* __restrict__ WT = dir ? whtb : whtf;
  const int b0 = blockIdx.x * BT;
  const int tid = threadIdx.x;  // blockDim == 4H
  const int q = tid / H, k = tid % H;

  for (int e = tid; e < BT * H; e += blockDim.x) dh[e] = 0.f;
  int len[BT];
  float dc[BT];
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    len[r] = (b0 + r < B) ? lens[b0 + r] : 0;
    dc[r] = 0.f;
  }
  __syncthreads();

  const float4* dp4 = reinterpret_cast<const float4*>(dp);
  for (int step = 0; step < T; ++step) {
    const int t = dir ? step : T - 1 - step;
    if (tid < H) {
      const int j = tid;
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const int b = b0 + r;
        float p[4] = {0.f, 0.f, 0.f, 0.f};
        if (b < B) {
          const size_t row = ((size_t)dir * T + t) * B + b;
          const float* g = gates + row * H4 + j;
          const float dh_t = gout[((size_t)b * T + t) * 2 * H + dir * H + j] +
                             dh[r * H + j];
          const float dcn = lstm_cell_bwd(g[0], g[H], g[2 * H], g[3 * H],
                                          cs[row * H + j], dh_t, dc[r], p, 1);
          if (t < len[r]) {
            dc[r] = dcn;
          } else {
            p[0] = p[1] = p[2] = p[3] = 0.f;
          }
          float* o = dxp + row * H4 + j;
          o[0] = p[0];
          o[H] = p[1];
          o[2 * H] = p[2];
          o[3 * H] = p[3];
        }
        dp[r * H4 + j] = p[0];
        dp[r * H4 + H + j] = p[1];
        dp[r * H4 + 2 * H + j] = p[2];
        dp[r * H4 + 3 * H + j] = p[3];
      }
    }
    __syncthreads();  // dPre complete
    float acc[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) acc[r] = 0.f;
#pragma unroll 2
    for (int jj = q * H; jj < (q + 1) * H; jj += 4) {
      const float* w = WT + (size_t)jj * H + k;
      const float w0 = w[0], w1 = w[H], w2 = w[2 * H], w3 = w[3 * H];
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float4 d = dp4[(r * H4 + jj) >> 2];
        acc[r] = fmaf(d.x, w0, acc[r]);
        acc[r] = fmaf(d.y, w1, acc[r]);
        acc[r] = fmaf(d.z, w2, acc[r]);
        acc[r] = fmaf(d.w, w3, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < BT; ++r) part[(q * BT + r) * H + k] = acc[r];
    __syncthreads();  // quarter sums complete, every read of dh and dp done
    if (tid < H) {
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        if (t >= len[r]) continue;  // padded (or absent) row: dh keeps its value
        dh[r * H + k] = ((part[r * H + k] + part[(BT + r) * H + k]) +
                         part[(2 * BT + r) * H + k]) +
                        part[(3 * BT + r) * H + k];
      }
    }
    __syncthreads();
  }
}

}  // namespace

// gout [B][T][2H] (the output's cotangent), cs [2][T][B][H] (c_{t-1}),
// gates [2][T][B][4H], whtf/whtb = W_hh^T [4H][H] per direction, lens [B];
// writes dxp [2][T][B][4H].
extern "C" int bilstm_bwd_recurrent(const float* gout, const float* cs,
                                    const float* gates, const float* whtf,
                                    const float* whtb, const int* lens,
                                    float* dxp, int B, int T, int H,
                                    cudaStream_t stream) {
  if (4 * H > 1024 || H % 4) return (int)cudaErrorInvalidValue;
  const int smem = BT * 9 * H * (int)sizeof(float);
  cudaFuncSetAttribute(bilstm_bwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid((B + BT - 1) / BT, 2);
  bilstm_bwd_kernel<<<grid, 4 * H, smem, stream>>>(gout, cs, gates, whtf, whtb,
                                                   lens, dxp, B, T, H);
  STJEP_RETURN_LAUNCH_STATUS();
}
