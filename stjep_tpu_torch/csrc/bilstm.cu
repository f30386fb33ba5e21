// K1: the recurrent sweep of one bidirectional pyramid layer, and K8's
// forward (the same sweep, saving what the backward reads).
//
// K1 replaces stjep_tpu/ops/lstm_pallas.py `bilstm_pallas` (body
// `_bilstm_kernel`), which kept h/c in VMEM across a sequential grid over
// time. Here the input projections x @ W_ih + b for all steps are one GEMM
// per direction before this kernel (gemm.cu); this kernel runs the time
// loop: per step pre = xp[t] + h @ W_hh, the i,f,g,o gates (torch order),
// and packed-length masking: at t >= length h and c pass through and the
// output is 0; the reverse direction starts at T-1, so it effectively
// starts at the last valid frame.
//
// K8's forward replaces stjep_tpu/ops/lstm_pallas_bwd.py `_run_fwd_save`
// (body `_fwd_save_kernel`): the SAVE instantiation also writes, time-major
// [dir][T][B][.] as the JAX kernel lays them out, the carries before each
// step (h_{t-1}, c_{t-1}) and the gate activations (zero at invalid
// steps). The TPU kernel stores these streams in bf16; this one keeps f32,
// the JAX package's parity mode (its interpret mode is f32 too).
//
// What bounds it on the H100: the serial recurrence, T steps one after the
// other. A step is BT x H x 4H FMAs over all of W_hh (H x 4H f32 = 1 MiB
// at H = 256), too much for one SM (this kernel's first design: 4 of 132
// SMs, the whole W_hh read from L2 every step, ~41 us a step). Design: one
// persistent thread-block cluster of C blocks per (batch tile of BT rows,
// direction). Block k of a cluster owns hidden units [k U, (k+1) U),
// U = ceil(H / C), and their four gate columns; it loads that W_hh column
// slice [H, 4U] into shared memory once per sweep (a variant for widths
// whose slice does not fit streams it from L2 every step instead: 1/C of
// the whole matrix per SM). Per step the block
//   1. forms its 4U pre-activation columns from h_{t-1} [H][BT], held in
//      its own shared memory: thread (s, row quad, unit) sums a 1/S share
//      of the contraction for 4 rows x 4 gates in registers, and the S
//      shares are added in order s = 0..S-1 (a run is bit-for-bit
//      repeatable);
//   2. applies the gates and the length mask; c and h of (row, unit) stay
//      in the registers of the thread that owns them;
//   3. writes its h slice into its own NEXT h buffer, then copies the
//      slice (contiguous there) into the NEXT buffer of every peer through
//      distributed shared memory, 16 bytes a store;
//   4. passes one cluster barrier, split in two: it arrives (release) as
//      soon as its slice is sent, then copies xp[t+1] of its columns into
//      shared memory with cp.async and stores this step's outputs, and
//      waits (acquire) last. No global load sits on the serial chain, and
//      the release does not wait for the global stores.
// (A variant that kept each thread's share of the slice in registers, at
// 254 registers a thread, and added the shares with warp shuffles was
// slower a step on the H100 and was not kept.)
//
// Why one barrier a step is enough: step t reads buffer t%2 and writes
// buffer (t+1)%2 in every peer. A block reaches step t+1, where it writes
// buffer t%2 of its peers, only after every peer has arrived at the barrier
// of step t, which each does after its last read of buffer t%2. A masked
// row writes its kept h, so the next step reads the carry. No block exits
// while a peer may still write into its shared memory: the last step ends
// with the same barrier, and after it no one writes.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// SAVE: hsave/csave [2][T][B][H] get h_{t-1}/c_{t-1} at every step, gsave
// [2][T][B][4H] the gates (0 where t >= length). Without SAVE they are
// unused and the kernel is K1's. RES: the W_hh slice lives in shared
// memory; otherwise it is read from global memory (L2) every step.
template <bool SAVE, bool RES>
__global__ void __launch_bounds__(256) bilstm_kernel(
    const float* __restrict__ xpf, const float* __restrict__ xpb,
    const float* __restrict__ whf, const float* __restrict__ whb,
    const int* __restrict__ lens, float* __restrict__ out,
    float* __restrict__ hsave, float* __restrict__ csave,
    float* __restrict__ gsave, int B, int T, int H, int BT) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int dir = blockIdx.y;
  const int b0 = (blockIdx.x / C) * BT;
  const float* __restrict__ xp = dir ? xpb : xpf;
  const float* __restrict__ W = dir ? whb : whf;
  const int H4 = 4 * H;
  const int U = (H + C - 1) / C;
  const int j0 = rank * U;  // this block's first unit
  const int nu = max(0, min(U, H - j0));
  const int NC = 4 * U;        // its gate columns, unit-major: 4 u + gate
  const int G = (BT / 4) * U;  // (row quad, unit) tiles
  const int S = blockDim.x / G;
  const int tid = threadIdx.x;
  const int s = tid / G, rem = tid % G, rq = rem / U, u = rem % U;
  const int j = j0 + u;

  extern __shared__ __align__(16) float sm[];
  float* hT = sm;                     // [2][H][BT] h_{t-1}, rows fastest
  float* red = hT + 2 * H * BT;       // [S][16][G] shares of h @ W
  float* xs = red + 16 * blockDim.x;  // [2][BT][NC] this step's xp columns
  float* Ws = xs + 2 * BT * NC;       // [H][NC] the W_hh slice (RES)

  for (int e = tid; e < H * BT; e += blockDim.x) hT[e] = 0.f;
  if (RES) {
    for (int e = tid; e < H * NC; e += blockDim.x) {
      const int k = e / NC, uu = (e % NC) >> 2, g = e & 3;
      Ws[e] = uu < nu ? W[(size_t)k * H4 + g * H + j0 + uu] : 0.f;
    }
  }
  int len[4];
  float c[4], h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + rq * 4 + i;
    len[i] = b < B ? lens[b] : 0;
    c[i] = h[i] = 0.f;
  }
  // the copy of xp[t]: thread tid moves unit tid % U of (row, gate) pairs
  // tid / U, tid / U + blockDim / U, ... (blockDim is a multiple of U)
  const int pu = tid % U, pstride = blockDim.x / U;
  auto prefetch = [&](int step, float* dst) {
    const int t = dir ? T - 1 - step : step;
    if (pu < nu) {
      for (int rg = tid / U; rg < 4 * BT; rg += pstride) {
        const int r = rg >> 2, g = rg & 3, b = b0 + r;
        if (b < B)
          cp_async4(dst + r * NC + 4 * pu + g,
                    xp + ((size_t)b * T + t) * H4 + g * H + j0 + pu);
      }
    }
    cp_async_commit();
  };
  prefetch(0, xs);
  cluster.sync();  // every peer runs, with its h buffer 0 zeroed

  const int kb = H * s / S, ke = H * (s + 1) / S;
  for (int step = 0; step < T; ++step) {
    const int cur = step & 1;
    const int t = dir ? T - 1 - step : step;
    const float* hc = hT + cur * H * BT;
    float* hnext = hT + (cur ^ 1) * H * BT;
    float acc[16];  // [row of the quad][gate]
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int k = kb; k < ke; ++k) {
      const float4 hv = *reinterpret_cast<const float4*>(hc + k * BT + rq * 4);
      float4 wv;
      if (RES) {
        wv = *reinterpret_cast<const float4*>(Ws + k * NC + 4 * u);
      } else if (u < nu) {
        const float* w = W + (size_t)k * H4 + j;
        wv = make_float4(__ldg(w), __ldg(w + H), __ldg(w + 2 * H), __ldg(w + 3 * H));
      } else {
        wv = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[4 * i] = fmaf(hr[i], wv.x, acc[4 * i]);
        acc[4 * i + 1] = fmaf(hr[i], wv.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(hr[i], wv.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(hr[i], wv.w, acc[4 * i + 3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) red[(s * 16 + i) * G + rem] = acc[i];
    cp_async_wait<0>();  // this step's xp copied
    __syncthreads();     // every share in red, every copy visible
    const float* x = xs + cur * BT * NC;
    // what goes to global memory waits in registers until the h slices are
    // sent, so the barrier's release does not wait for these stores
    float o[4], gs[4][4], hp[4], cp[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i % S != s || u >= nu) continue;
      const int r = rq * 4 + i;
      float a[4] = {0.f, 0.f, 0.f, 0.f}, p[4];
#pragma unroll 4
      for (int q = 0; q < S; ++q) {
#pragma unroll
        for (int g = 0; g < 4; ++g) a[g] += red[(q * 16 + 4 * i + g) * G + rem];
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) p[g] = x[r * NC + 4 * u + g] + a[g];
      const float gi = sigmoidf_(p[0]), gf = sigmoidf_(p[1]);
      const float gg = tanhf(p[2]), go = sigmoidf_(p[3]);
      const float cn = gf * c[i] + gi * gg;
      const float hn = go * tanhf(cn);
      const bool valid = t < len[i];
      hp[i] = h[i];
      cp[i] = c[i];
      gs[i][0] = valid ? gi : 0.f;
      gs[i][1] = valid ? gf : 0.f;
      gs[i][2] = valid ? gg : 0.f;
      gs[i][3] = valid ? go : 0.f;
      o[i] = valid ? hn : 0.f;
      if (valid) {
        c[i] = cn;
        h[i] = hn;
      }
      hnext[j * BT + r] = h[i];  // a masked row sends its kept h
    }
    __syncthreads();  // the block's slice [j0, j0 + nu) x BT is whole, contiguous
    {  // copy it into every peer, 16 bytes a store
      const int n4 = nu * BT / 4;
      const float4* src = reinterpret_cast<const float4*>(hnext + j0 * BT);
      for (int e = tid; e < n4 * (C - 1); e += blockDim.x) {
        const int q = e / n4, q2 = q < rank ? q : q + 1;  // every rank but this one
        cluster.map_shared_rank(const_cast<float4*>(src), q2)[e % n4] = src[e % n4];
      }
    }
    cluster_arrive();  // this block's h slice is in every peer
    if (step + 1 < T) prefetch(step + 1, xs + (cur ^ 1) * BT * NC);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = b0 + rq * 4 + i;
      if (i % S != s || u >= nu || b >= B) continue;
      if (SAVE) {
        const size_t row = ((size_t)dir * T + t) * B + b;
        hsave[row * H + j] = hp[i];
        csave[row * H + j] = cp[i];
#pragma unroll
        for (int g = 0; g < 4; ++g) gsave[row * H4 + g * H + j] = gs[i][g];
      }
      out[((size_t)b * T + t) * 2 * H + dir * H + j] = o[i];
    }
    cluster_wait();  // every peer's slice is here, and every peer has read h_{t-1}
  }
}

struct Plan {
  int threads;
  size_t smem;
  bool resident;
};

// Threads and shared memory of the forward sweep, from the shape alone;
// false for a shape it does not take.
bool fwd_plan(int H, int BT, int C, Plan& p) {
  if (H < 1 || (BT != 4 && BT != 8 && BT != 16) || C < 1 || C > 16) return false;
  const int U = (H + C - 1) / C;
  if (U > 64) return false;
  const int G = (BT / 4) * U;
  p.threads = max(1, 256 / G) * G;
  const size_t base = sizeof(float) * ((size_t)2 * H * BT + 16 * p.threads + 2 * BT * 4 * U);
  const size_t w = sizeof(float) * (size_t)H * 4 * U;
  p.resident = base + w <= smem_optin();
  p.smem = p.resident ? base + w : base;
  return p.smem <= smem_optin();
}

template <bool SAVE>
int launch_bilstm(const float* xpf, const float* xpb, const float* whf,
                  const float* whb, const int* lens, float* out, float* hsave,
                  float* csave, float* gsave, int B, int T, int H, int BT,
                  int C, cudaStream_t stream, int* max_clusters = nullptr) {
  Plan p;
  if (!fwd_plan(H, BT, C, p) || B < 0 || T < 0) return (int)cudaErrorInvalidValue;
  if (!max_clusters && (B == 0 || T == 0)) return 0;  // nothing to sweep
  const dim3 grid(C * ((B + BT - 1) / BT), 2);
  auto kern = p.resident ? bilstm_kernel<SAVE, true> : bilstm_kernel<SAVE, false>;
  return launch_cluster(kern, grid, p.threads, p.smem, C, stream, max_clusters,
                        xpf, xpb, whf, whb, lens, out, hsave, csave, gsave, B,
                        T, H, BT);
}

}  // namespace

// xpf/xpb [B][T][4H] (x @ W_ih + b per direction), whf/whb [H][4H], lens
// [B]; writes out [B][T][2H]. BT rows per batch tile, clusters of C blocks.
extern "C" int bilstm_recurrent(const float* xpf, const float* xpb,
                                const float* whf, const float* whb,
                                const int* lens, float* out, int B, int T,
                                int H, int BT, int C, cudaStream_t stream) {
  return launch_bilstm<false>(xpf, xpb, whf, whb, lens, out, nullptr, nullptr,
                              nullptr, B, T, H, BT, C, stream);
}

extern "C" int bilstm_fwd_save(const float* xpf, const float* xpb,
                               const float* whf, const float* whb,
                               const int* lens, float* out, float* hsave,
                               float* csave, float* gsave, int B, int T, int H,
                               int BT, int C, cudaStream_t stream) {
  return launch_bilstm<true>(xpf, xpb, whf, whb, lens, out, hsave, csave,
                             gsave, B, T, H, BT, C, stream);
}

// The forward sweep's plan at (B, H, BT, C), launching nothing: info gets
// threads a block, dynamic shared memory bytes, where W_hh's slice lives
// (1 shared memory, 2 streamed from L2), and how many of its clusters the
// card holds at once (0: the shape cannot be scheduled).
extern "C" int bilstm_fwd_plan(int B, int H, int BT, int C, int* info,
                               cudaStream_t stream) {
  Plan p;
  if (B < 1 || !fwd_plan(H, BT, C, p)) return (int)cudaErrorInvalidValue;
  info[0] = p.threads;
  info[1] = (int)p.smem;
  info[2] = p.resident ? 1 : 2;  // W_hh's slice in shared memory, or streamed
  return launch_bilstm<true>(nullptr, nullptr, nullptr, nullptr, nullptr,
                             nullptr, nullptr, nullptr, nullptr, B, 1, H, BT,
                             C, stream, &info[3]);
}
