// K2: the per-step kernels of the free-running LAS greedy decoder.
//
// Replaces stjep_tpu/ops/las_flash.py `las_greedy_flash` (body `_kernel`),
// which ran all L-1 steps in one launch with every weight resident in VMEM.
// A step here is a short chain of launches driven by a host loop that never
// synchronises (the emitted symbol stays on the card):
//   las_embed_concat  feedback embedding gather (PAD row reads 0) + the
//                     previous dynamic embedding -> layer-0 input
//   gemm + lstm_gates x3   the residual uni-LSTM stack, each layer one GEMM
//                     over [input ; h] against [W_ih ; W_hh]
//   bilinear_attend   scores against the precomputed key projections,
//                     -1e12 fill past lens_k, softmax, context
//   gemm              FFN [ctx ; q] -> dynamic embedding (no bias)
//   gemm + head_argmax     the [Hs, V] head, then max / logsumexp / argmax
//                     (lowest index on ties) / picked logp in one pass
//
// What bounds it on the H100: the 512 x 30000 f32 head (61 MB read and
// 0.5 GFLOP per step at B=16) and the launch latency of ~11 small launches
// per step. Design: the head's statistics are fused into one block-per-row
// kernel so the [B, V] logits are read once more, not four times; the
// rest stays simple. Keeping the head in bf16 and the loop in one
// persistent kernel or CUDA graph is later work.
//
// K9's forward (las_tf.cu) drives `lstm_gates` and `bilinear_attend` too,
// through optional pointers that K2 passes as null: a separate next cell
// state, a dropout mask on the layer output, and saves of the gates and of
// the attention probabilities.

#include "common.cuh"

namespace {

// xin[b, :E] = table[sym[b]] (0 for PAD); xin[b, E:E+Hs] = cell[b] (0 at
// the first step, cell == nullptr).
__global__ void embed_concat_kernel(const float* __restrict__ table,
                                    const int* __restrict__ sym,
                                    const float* __restrict__ cell,
                                    int ld_cell, float* __restrict__ xin,
                                    int ld_xin, int E, int Hs) {
  const int b = blockIdx.x;
  const int s = sym[b];
  const float keep = s != STJEP_PAD ? 1.f : 0.f;
  float* x = xin + (size_t)b * ld_xin;
  for (int c = threadIdx.x; c < E; c += blockDim.x)
    x[c] = table[(size_t)s * E + c] * keep;
  for (int c = threadIdx.x; c < Hs; c += blockDim.x)
    x[E + c] = cell ? cell[(size_t)b * ld_cell + c] : 0.f;
}

// One LSTM cell update from pre-activations pre[b, 4H] (gate order i,f,g,o).
// c is updated in place, or the new state goes to c_out when given; h goes
// to h_dst (the next step's recurrent input) and h (+ resid, the layer
// input, for the residual middle layers), times mask[b, :] when given, to
// out_dst (the next layer's input). g_save [B, 4H], when given, gets the
// gate activations.
__global__ void lstm_gates_kernel(const float* __restrict__ pre,
                                  float* __restrict__ c,
                                  float* __restrict__ c_out, float* h_dst,
                                  int ld_h, float* out_dst, int ld_out,
                                  const float* resid, int ld_resid,
                                  const float* __restrict__ mask,
                                  float* __restrict__ g_save, int H) {
  const int b = blockIdx.x;
  const float* p = pre + (size_t)b * 4 * H;
  for (int u = threadIdx.x; u < H; u += blockDim.x) {
    const float gi = sigmoidf_(p[u]);
    const float gf = sigmoidf_(p[H + u]);
    const float gg = tanhf(p[2 * H + u]);
    const float go = sigmoidf_(p[3 * H + u]);
    const float cn = gf * c[(size_t)b * H + u] + gi * gg;
    const float hn = go * tanhf(cn);
    (c_out ? c_out : c)[(size_t)b * H + u] = cn;
    h_dst[(size_t)b * ld_h + u] = hn;
    float y = resid ? hn + resid[(size_t)b * ld_resid + u] : hn;
    if (mask) y *= mask[(size_t)b * H + u];
    out_dst[(size_t)b * ld_out + u] = y;
    if (g_save) {
      float* g = g_save + (size_t)b * 4 * H + u;
      g[0] = gi;
      g[H] = gf;
      g[2 * H] = gg;
      g[3 * H] = go;
    }
  }
}

// Bilinear attention for one batch row per block: s[t] = q . wk[b, t]
// (-1e12 at t >= lens[b]), softmax over t, ctx = sum_t p[t] val[b, t],
// times ctx_mask[b, :] when given. attn_save [B, Tk], when given, gets p.
__global__ void bilinear_attend_kernel(const float* __restrict__ q, int ld_q,
                                       const float* __restrict__ wk,
                                       const float* __restrict__ val,
                                       const int* __restrict__ lens,
                                       float* __restrict__ ctx, int ld_ctx,
                                       float* __restrict__ attn_save,
                                       const float* __restrict__ ctx_mask,
                                       int Tk, int Hq, int Hv) {
  extern __shared__ float sm[];
  float* qs = sm;       // [Hq]
  float* s = sm + Hq;   // [Tk]
  __shared__ float red[32];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int c = threadIdx.x; c < Hq; c += blockDim.x) qs[c] = q[(size_t)b * ld_q + c];
  __syncthreads();
  const int len = lens[b];
  for (int t = warp; t < Tk; t += nw) {
    const float* k = wk + ((size_t)b * Tk + t) * Hq;
    float part = 0.f;
    for (int c = lane; c < Hq; c += 32) part = fmaf(qs[c], k[c], part);
    part = warp_sum(part);
    if (lane == 0) s[t] = t >= len ? -1e12f : part;
  }
  __syncthreads();
  float m = -INFINITY;
  for (int t = threadIdx.x; t < Tk; t += blockDim.x) m = fmaxf(m, s[t]);
  m = block_max(m, red);
  float z = 0.f;
  for (int t = threadIdx.x; t < Tk; t += blockDim.x) z += expf(s[t] - m);
  z = block_sum(z, red);
  __syncthreads();
  for (int t = threadIdx.x; t < Tk; t += blockDim.x) {
    s[t] = expf(s[t] - m) / z;
    if (attn_save) attn_save[(size_t)b * Tk + t] = s[t];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < Hv; c += blockDim.x) {
    const float* v = val + (size_t)b * Tk * Hv + c;
    float acc = 0.f;
#pragma unroll 8
    for (int t = 0; t < Tk; ++t) acc = fmaf(s[t], v[(size_t)t * Hv], acc);
    if (ctx_mask) acc *= ctx_mask[(size_t)b * Hv + c];
    ctx[(size_t)b * ld_ctx + c] = acc;
  }
}

// Head statistics for one row per block: argmax (lowest index on ties),
// logsumexp, and the log-softmax value at ref[b] (token 0 without refs).
// Writes the symbol (fed back next step) and the step's outputs.
__global__ void head_argmax_kernel(const float* __restrict__ logits,
                                   const int* __restrict__ ref, int ld_ref,
                                   int* __restrict__ sym, int* preds,
                                   int ld_preds, float* picked, int ld_picked,
                                   int V) {
  __shared__ float rv[32];
  __shared__ int ri[32];
  __shared__ float red[32];
  const int b = blockIdx.x;
  const float* x = logits + (size_t)b * V;
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int c = threadIdx.x; c < V; c += blockDim.x) {
    const float v = x[c];
    if (better(v, c, bv, bi)) { bv = v; bi = c; }
  }
  block_argmax(bv, bi, rv, ri);
  float z = 0.f;
  for (int c = threadIdx.x; c < V; c += blockDim.x) z += expf(x[c] - bv);
  z = block_sum(z, red);
  if (threadIdx.x == 0) {
    const float lse = bv + logf(z);
    const int g = ref ? ref[(size_t)b * ld_ref] : 0;
    sym[b] = bi;
    preds[(size_t)b * ld_preds] = bi;
    picked[(size_t)b * ld_picked] = x[g] - lse;
  }
}

}  // namespace

extern "C" int las_embed_concat(const float* table, const int* sym,
                                const float* cell, int ld_cell, float* xin,
                                int ld_xin, int B, int E, int Hs,
                                cudaStream_t stream) {
  embed_concat_kernel<<<B, 256, 0, stream>>>(table, sym, cell, ld_cell, xin,
                                             ld_xin, E, Hs);
  STJEP_RETURN_LAUNCH_STATUS();
}

extern "C" int lstm_gates(const float* pre, float* c, float* c_out,
                          float* h_dst, int ld_h, float* out_dst, int ld_out,
                          const float* resid, int ld_resid, const float* mask,
                          float* g_save, int B, int H, cudaStream_t stream) {
  lstm_gates_kernel<<<B, 256, 0, stream>>>(pre, c, c_out, h_dst, ld_h,
                                           out_dst, ld_out, resid, ld_resid,
                                           mask, g_save, H);
  STJEP_RETURN_LAUNCH_STATUS();
}

extern "C" int bilinear_attend(const float* q, int ld_q, const float* wk,
                               const float* val, const int* lens, float* ctx,
                               int ld_ctx, float* attn_save,
                               const float* ctx_mask, int B, int Tk, int Hq,
                               int Hv, cudaStream_t stream) {
  const size_t smem = (size_t)(Hq + Tk) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  bilinear_attend_kernel<<<B, 512, smem, stream>>>(
      q, ld_q, wk, val, lens, ctx, ld_ctx, attn_save, ctx_mask, Tk, Hq, Hv);
  STJEP_RETURN_LAUNCH_STATUS();
}

extern "C" int head_argmax(const float* logits, const int* ref, int ld_ref,
                           int* sym, int* preds, int ld_preds, float* picked,
                           int ld_picked, int B, int V, cudaStream_t stream) {
  head_argmax_kernel<<<B, 1024, 0, stream>>>(logits, ref, ld_ref, sym, preds,
                                             ld_preds, picked, ld_picked, V);
  STJEP_RETURN_LAUNCH_STATUS();
}
