// K9: the teacher-forced LAS decoder scan, forward and backward.
//
// Replaces stjep_tpu/ops/las_tf_flash.py `las_tf_scan`: `_run_fwd` (body
// `_fwd_kernel`) and `_vjp_bwd` (body `_bwd_kernel`), which ran all S steps
// in one launch each with every weight, the key projections and the
// attention values resident in VMEM. That does not carry over: at the
// flagship (Hd = 512, S = 89) the three stacked LSTM weights alone are
// 16 MB. As K2 does, a host loop issues a short chain of launches per step
// and never synchronises (stjep_tpu_torch/ops/las_tf_flash.py).
//
// Forward, per step: for each of the 3 layers one GEMM (gemm.cu) of
// [x ; h] against [W_ih ; W_hh] (layer 0: the hoisted embedding-side
// pre-activation `pre0[t]` added in the epilogue; layers 1-2: the bias),
// then K2's `lstm_gates` saving the gates and writing the next cell state,
// the next step's h and the masked layer output (las_greedy.cu); K2's
// `bilinear_attend` (-1e12 fill past lens_k) saving the probabilities and
// applying the context mask; and the FFN GEMM, which writes the dynamic
// embedding straight into the next step's layer-0 input. The GEMM inputs
// [x ; h] are themselves the saved layer-input and carry streams.
//
// Backward, per step in reverse: one GEMM of dcell_t against W_ffn^T,
// sliced into dctx_m and dq; `attend_bwd` below; then for layers 2, 1, 0
// `lstm_cell_bwd` below and one GEMM of dPre against [W_ih ; W_hh]^T giving
// the input and recurrent cotangents (layer 0's GEMM adds the next step's
// head cotangent, so its output is the full dcell of the previous step).
// Every weight gradient, d_wk -> d_att_w and d_acous are finished outside
// by stream matmuls, as the JAX code does. The TPU kernels keep residual
// streams and weights in bf16; this port computes the f32 variant, the JAX
// package's parity mode (its interpret mode is f32 too).
//
// What bounds it on the H100: the serial chain of ~9 launches per step
// (~13 with split-K reduces), each small: the GEMMs at M = B = 16 read
// their weight (4 MB for a layer) once per step and are spread over the
// card by split-K. Launch latency and the weight reads set the step time,
// not FLOPs. CUDA graphs and a persistent kernel are later work.

#include "common.cuh"

namespace {

// One LSTM cell backward per element (one block per batch row):
// go = (ga + gb) * m (gb, m optional) is the cotangent of the layer output;
// go_out, when given, gets it. dh_t = go + dh (dh optional: the recurrent
// cotangent from step t+1); dc [B, H] is the carried cell cotangent,
// updated in place; dpre [B, 4H] gets the pre-activation cotangent.
__global__ void lstm_cell_bwd_kernel(const float* __restrict__ ga, int ld_ga,
                                     const float* __restrict__ gb, int ld_gb,
                                     const float* __restrict__ m,
                                     float* __restrict__ go_out,
                                     const float* __restrict__ gates,
                                     const float* __restrict__ c_prev,
                                     const float* __restrict__ dh, int ld_dh,
                                     float* __restrict__ dc,
                                     float* __restrict__ dpre, int H) {
  const int b = blockIdx.x;
  const float* g = gates + (size_t)b * 4 * H;
  for (int u = threadIdx.x; u < H; u += blockDim.x) {
    float go = ga[(size_t)b * ld_ga + u];
    if (gb) go += gb[(size_t)b * ld_gb + u];
    if (m) go *= m[(size_t)b * H + u];
    if (go_out) go_out[(size_t)b * H + u] = go;
    const float dh_t = dh ? go + dh[(size_t)b * ld_dh + u] : go;
    const size_t e = (size_t)b * H + u;
    dc[e] = lstm_cell_bwd(g[u], g[H + u], g[2 * H + u], g[3 * H + u],
                          c_prev[e], dh_t, dc[e], dpre + (size_t)b * 4 * H + u,
                          H);
  }
}

// Bilinear attention backward for one batch row per block, from the FFN
// input cotangent dff [B, Ha2 + Hd] = [dctx_m ; dq]:
//   dctx = dctx_m * mctx;  datt[t] = dctx . val[b, t];
//   dsc  = attn * (datt - sum_t attn * datt);  dq += sum_t dsc[t] wk[b, t]
// Writes dsc [B, Tk], dctx [B, Ha2] and dq_out [B, Hd].
__global__ void attend_bwd_kernel(const float* __restrict__ dff, int ld_dff,
                                  const float* __restrict__ mctx,
                                  const float* __restrict__ attn,
                                  const float* __restrict__ val,
                                  const float* __restrict__ wk,
                                  float* __restrict__ dsc,
                                  float* __restrict__ dctx_out,
                                  float* __restrict__ dq_out, int Tk, int Ha2,
                                  int Hd) {
  extern __shared__ float sm[];
  float* dctx = sm;       // [Ha2]
  float* s = sm + Ha2;    // [Tk]: datt, then dsc
  __shared__ float red[32];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const float* d = dff + (size_t)b * ld_dff;
  for (int c = threadIdx.x; c < Ha2; c += blockDim.x) {
    const float v = mctx ? d[c] * mctx[(size_t)b * Ha2 + c] : d[c];
    dctx[c] = v;
    dctx_out[(size_t)b * Ha2 + c] = v;
  }
  __syncthreads();
  for (int t = warp; t < Tk; t += nw) {
    const float* v = val + ((size_t)b * Tk + t) * Ha2;
    float part = 0.f;
    for (int c = lane; c < Ha2; c += 32) part = fmaf(dctx[c], v[c], part);
    part = warp_sum(part);
    if (lane == 0) s[t] = part;
  }
  __syncthreads();
  const float* a = attn + (size_t)b * Tk;
  float sum = 0.f;
  for (int t = threadIdx.x; t < Tk; t += blockDim.x) sum = fmaf(a[t], s[t], sum);
  sum = block_sum(sum, red);
  __syncthreads();
  for (int t = threadIdx.x; t < Tk; t += blockDim.x) {
    const float v = a[t] * (s[t] - sum);
    s[t] = v;
    dsc[(size_t)b * Tk + t] = v;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < Hd; c += blockDim.x) {
    const float* k = wk + (size_t)b * Tk * Hd + c;
    float acc = 0.f;
#pragma unroll 8
    for (int t = 0; t < Tk; ++t) acc = fmaf(s[t], k[(size_t)t * Hd], acc);
    dq_out[(size_t)b * Hd + c] = d[Ha2 + c] + acc;
  }
}

}  // namespace

extern "C" int lstm_cell_bwd(const float* ga, int ld_ga, const float* gb,
                             int ld_gb, const float* m, float* go_out,
                             const float* gates, const float* c_prev,
                             const float* dh, int ld_dh, float* dc, float* dpre,
                             int B, int H, cudaStream_t stream) {
  lstm_cell_bwd_kernel<<<B, 256, 0, stream>>>(ga, ld_ga, gb, ld_gb, m, go_out,
                                              gates, c_prev, dh, ld_dh, dc,
                                              dpre, H);
  STJEP_RETURN_LAUNCH_STATUS();
}

extern "C" int attend_bwd(const float* dff, int ld_dff, const float* mctx,
                          const float* attn, const float* val, const float* wk,
                          float* dsc, float* dctx, float* dq, int B, int Tk,
                          int Ha2, int Hd, cudaStream_t stream) {
  const size_t smem = (size_t)(Ha2 + Tk) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  attend_bwd_kernel<<<B, 512, smem, stream>>>(dff, ld_dff, mctx, attn, val, wk,
                                              dsc, dctx, dq, Tk, Ha2, Hd);
  STJEP_RETURN_LAUNCH_STATUS();
}
