// K1: the recurrent sweep of one bidirectional pyramid layer, and K8's
// forward (the same sweep, saving what the backward reads).
//
// K1 replaces stjep_tpu/ops/lstm_pallas.py `bilstm_pallas` (body
// `_bilstm_kernel`), which kept h/c in VMEM across a sequential grid over
// time. Here the input projections x @ W_ih + b for all steps are one GEMM
// per direction before this kernel (gemm.cu); this kernel runs the time
// loop inside the block: per step pre = xp[t] + h @ W_hh, the i,f,g,o gates
// (torch order), and packed-length masking — at t >= length h and c pass
// through and the output is 0; the reverse direction starts at T-1, so it
// effectively starts at the last valid frame.
//
// K8's forward replaces stjep_tpu/ops/lstm_pallas_bwd.py `_run_fwd_save`
// (body `_fwd_save_kernel`): the SAVE instantiation also writes, time-major
// [dir][T][B][.] as the JAX kernel lays them out, the carries before each
// step (h_{t-1}, c_{t-1}) and the gate activations (zero at invalid
// steps). The TPU kernel stores these streams in bf16; this one keeps f32,
// the JAX package's parity mode (its interpret mode is f32 too).
//
// What bounds it on the H100: the serial recurrence. Each step reads the
// whole W_hh (H x 4H f32 = 1 MB at H = 256) from L2 and does BT*H*4H FMAs
// in one block; both take about the same time on one SM, ~10 us, and the
// flagship pyramid has 2820 steps. K8's saves add 6H floats per row and
// step of coalesced stores, small beside the product. Design: one block
// per (batch tile of BT rows, direction), time loop inside; thread j owns
// gate column j (4H threads: coalesced W_hh reads, h read from shared
// memory four values at a time), then H of them apply the gates with c in
// registers. Splitting W_hh across a thread-block cluster so it stays in
// shared memory is later work.

#include "common.cuh"

namespace {

constexpr int BT = 8;  // batch rows per block

// SAVE: hsave/csave [2][T][B][H] get h_{t-1}/c_{t-1} at every step, gsave
// [2][T][B][4H] the gates (0 where t >= length). Without SAVE they are
// unused and the kernel is K1's.
template <bool SAVE>
__global__ void __launch_bounds__(1024) bilstm_kernel(
    const float* __restrict__ xpf, const float* __restrict__ xpb,
    const float* __restrict__ whf, const float* __restrict__ whb,
    const int* __restrict__ lens, float* __restrict__ out,
    float* __restrict__ hsave, float* __restrict__ csave,
    float* __restrict__ gsave, int B, int T, int H) {
  extern __shared__ float sm[];
  float* hs = sm;            // [BT][H] recurrent state
  float* pre = sm + BT * H;  // [BT][4H] h @ W_hh for this step
  const int dir = blockIdx.y;
  const float* __restrict__ xp = dir ? xpb : xpf;
  const float* __restrict__ W = dir ? whb : whf;
  const int b0 = blockIdx.x * BT;
  const int H4 = 4 * H;
  const int j = threadIdx.x;  // gate column; blockDim == 4H

  for (int e = j; e < BT * H; e += blockDim.x) hs[e] = 0.f;
  int len[BT];
  float c[BT];
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    len[r] = (b0 + r < B) ? lens[b0 + r] : 0;
    c[r] = 0.f;
  }
  __syncthreads();

  const float4* h4 = reinterpret_cast<const float4*>(hs);
  for (int step = 0; step < T; ++step) {
    const int t = dir ? T - 1 - step : step;
    float acc[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) acc[r] = 0.f;
#pragma unroll 2
    for (int k = 0; k < H; k += 4) {
      const float* w = W + (size_t)k * H4 + j;
      const float w0 = w[0], w1 = w[H4], w2 = w[2 * H4], w3 = w[3 * H4];
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float4 hv = h4[(r * H + k) >> 2];
        acc[r] = fmaf(hv.x, w0, acc[r]);
        acc[r] = fmaf(hv.y, w1, acc[r]);
        acc[r] = fmaf(hv.z, w2, acc[r]);
        acc[r] = fmaf(hv.w, w3, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < BT; ++r) pre[r * H4 + j] = acc[r];
    __syncthreads();  // pre complete, and every read of h done
    if (j < H) {
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const int b = b0 + r;
        if (b >= B) continue;
        const float* x = xp + ((size_t)b * T + t) * H4 + j;
        const float* p = pre + r * H4 + j;
        const float gi = sigmoidf_(x[0] + p[0]);
        const float gf = sigmoidf_(x[H] + p[H]);
        const float gg = tanhf(x[2 * H] + p[2 * H]);
        const float go = sigmoidf_(x[3 * H] + p[3 * H]);
        const float cn = gf * c[r] + gi * gg;
        const float hn = go * tanhf(cn);
        const bool valid = t < len[r];
        if (SAVE) {
          const size_t row = ((size_t)dir * T + t) * B + b;
          hsave[row * H + j] = hs[r * H + j];
          csave[row * H + j] = c[r];
          float* g = gsave + row * H4 + j;
          g[0] = valid ? gi : 0.f;
          g[H] = valid ? gf : 0.f;
          g[2 * H] = valid ? gg : 0.f;
          g[3 * H] = valid ? go : 0.f;
        }
        if (valid) {
          c[r] = cn;
          hs[r * H + j] = hn;
        }
        out[((size_t)b * T + t) * 2 * H + dir * H + j] = valid ? hn : 0.f;
      }
    }
    __syncthreads();
  }
}

template <bool SAVE>
int launch_bilstm(const float* xpf, const float* xpb, const float* whf,
                  const float* whb, const int* lens, float* out, float* hsave,
                  float* csave, float* gsave, int B, int T, int H,
                  cudaStream_t stream) {
  if (4 * H > 1024 || H % 4) return (int)cudaErrorInvalidValue;
  const int smem = BT * 5 * H * (int)sizeof(float);
  cudaFuncSetAttribute(bilstm_kernel<SAVE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid((B + BT - 1) / BT, 2);
  bilstm_kernel<SAVE><<<grid, 4 * H, smem, stream>>>(
      xpf, xpb, whf, whb, lens, out, hsave, csave, gsave, B, T, H);
  STJEP_RETURN_LAUNCH_STATUS();
}

}  // namespace

extern "C" int bilstm_recurrent(const float* xpf, const float* xpb,
                                const float* whf, const float* whb,
                                const int* lens, float* out, int B, int T,
                                int H, cudaStream_t stream) {
  return launch_bilstm<false>(xpf, xpb, whf, whb, lens, out, nullptr, nullptr,
                              nullptr, B, T, H, stream);
}

extern "C" int bilstm_fwd_save(const float* xpf, const float* xpb,
                               const float* whf, const float* whb,
                               const int* lens, float* out, float* hsave,
                               float* csave, float* gsave, int B, int T, int H,
                               cudaStream_t stream) {
  return launch_bilstm<true>(xpf, xpb, whf, whb, lens, out, hsave, csave,
                             gsave, B, T, H, stream);
}
