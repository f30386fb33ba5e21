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
// What bounds it on the H100: as the forward, the serial chain of T steps,
// each a BT x 4H x H product dPre @ W_hh^T (the first design did it on
// 4 SMs, reading W_hh^T, transposed by the wrapper on every call, from L2
// every step). Design: the forward's cluster turned around (bilstm.cu).
// Block k of a cluster of C owns units [k U, (k+1) U) and their gate
// columns, and keeps W_hh's column slice, laid out [4U][H], in shared
// memory for the whole sweep (or streams it from L2 where it does not
// fit). Per step it
//   1. runs the cell backward for its own (row, unit) pairs, dh and dc in
//      the owning thread's registers, and writes its dPre columns;
//   2. forms the partial dh over its own columns, dPre_own [BT, 4U] @
//      W_hh[:, own]^T -> [BT, H], thread by (row quad, 4 units);
//   3. reduce-scatters it through distributed shared memory: each [BT, U]
//      piece goes to the piece's owner, into slot `rank` of its receive
//      buffer, 4 rows a 16-byte store (BT x H floats a block a step,
//      against 4x that for an all-gather of dPre);
//   4. passes one cluster barrier, split in two: it arrives (release) once
//      its pieces are sent, then copies the next step's saved streams into
//      shared memory with cp.async and stores its dPre columns to global
//      memory, and waits (acquire) last. At the next step each owner adds
//      its C pieces in rank order 0..C-1, so a run is bit-for-bit
//      repeatable. The receive buffer is double-buffered: a block
// writes slot set s%2 at step s only after every peer has passed the
// barrier of step s-1, by which each had read the set it wrote at s-2. No
// block exits while a peer may still write into it: the last step ends
// with the barrier, after which no one writes.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BWD_THREADS = 256;

template <bool RES>
__global__ void __launch_bounds__(BWD_THREADS) bilstm_bwd_kernel(
    const float* __restrict__ gout, const float* __restrict__ cs,
    const float* __restrict__ gates, const float* __restrict__ whf,
    const float* __restrict__ whb, const int* __restrict__ lens,
    float* __restrict__ dxp, int B, int T, int H, int BT) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int dir = blockIdx.y;
  const int b0 = (blockIdx.x / C) * BT;
  const float* __restrict__ W = dir ? whb : whf;
  const int H4 = 4 * H;
  const int U = (H + C - 1) / C;
  const int j0 = rank * U;
  const int nu = max(0, min(U, H - j0));
  const int NC = 4 * U;             // own gate columns, unit-major: 4 u + gate
  const int Hp = (H + 3) & ~3, KQ = Hp / 4;
  const int GT = (BT / 4) * KQ;     // (row quad, unit quad) tiles of the product
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) float sm[];
  float* WsT = sm;                            // [NC][Hp] W_hh slice (RES)
  float* dpT = sm + (RES ? NC * Hp : 0);      // [NC][BT] dPre, rows fastest
  float* recv = dpT + NC * BT;                // [2][C][U][BT] dh pieces
  float* pf = recv + 2 * C * BT * U;          // [2][BT][U][6] i f g o c g_out

  for (int e = tid; e < NC * BT; e += blockDim.x) dpT[e] = 0.f;
  if (RES) {
    for (int e = tid; e < NC * Hp; e += blockDim.x) {
      const int cc = e / Hp, k = e % Hp, uu = cc >> 2, g = cc & 3;
      WsT[e] = uu < nu && k < H ? W[(size_t)k * H4 + g * H + j0 + uu] : 0.f;
    }
  }
  // this thread's (row, unit) pairs: at most 4 (BT * U <= 4 * BWD_THREADS)
  int ir[4], iu[4], ilen[4];
  bool pvalid[4];
  float dh[4], dc[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int e = tid + m * blockDim.x;
    ir[m] = e / U;
    iu[m] = e % U;
    const bool mine = e < BT * U && iu[m] < nu && b0 + ir[m] < B;
    ilen[m] = mine ? lens[b0 + ir[m]] : -1;  // -1: not a pair of this block
    pvalid[m] = false;
    dh[m] = dc[m] = 0.f;
  }
  // the copy of step t's streams: thread tid moves unit tid % U of the
  // (row, stream) pairs tid / U, tid / U + pstride, ...
  const int pu = tid % U, pstride = blockDim.x / U;
  auto prefetch = [&](int step, float* dst) {
    const int t = dir ? step : T - 1 - step;
    for (int rv = tid / U; rv < BT * 6 && pu < nu && tid < pstride * U; rv += pstride) {
      const int r = rv / 6, v = rv % 6, b = b0 + r, uu = pu;
      if (b >= B) continue;
      const size_t row = ((size_t)dir * T + t) * B + b;
      const int jj = j0 + uu;
      const float* src = v < 4 ? gates + row * H4 + v * H + jj
                       : v == 4 ? cs + row * H + jj
                                : gout + ((size_t)b * T + t) * 2 * H + dir * H + jj;
      cp_async4(dst + (r * U + uu) * 6 + v, src);
    }
    cp_async_commit();
  };
  prefetch(0, pf);
  cluster.sync();  // every peer runs before anyone writes into it

  for (int step = 0; step < T; ++step) {
    const int cur = step & 1;
    const int t = dir ? step : T - 1 - step;
    if (step > 0) {  // the dh pieces of step - 1, added in rank order
      const float* rv = recv + (cur ^ 1) * C * BT * U;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (ilen[m] < 0) continue;
        float a = 0.f;
#pragma unroll 4
        for (int q = 0; q < C; ++q) a += rv[(q * U + iu[m]) * BT + ir[m]];
        if (pvalid[m]) dh[m] = a;
      }
    }
    cp_async_wait<0>();  // this step's streams copied
    __syncthreads();
    const float* f = pf + cur * BT * U * 6;
    float p[4][4];  // dPre of each pair; to global memory after the arrive
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (ilen[m] < 0) continue;
      const float* v = f + (ir[m] * U + iu[m]) * 6;
      const bool valid = t < ilen[m];
      const float dcn = lstm_cell_bwd(v[0], v[1], v[2], v[3], v[4], v[5] + dh[m],
                                      dc[m], p[m], 1);
      if (valid) {
        dc[m] = dcn;
      } else {
        p[m][0] = p[m][1] = p[m][2] = p[m][3] = 0.f;
      }
      pvalid[m] = valid;
#pragma unroll
      for (int g = 0; g < 4; ++g) dpT[(4 * iu[m] + g) * BT + ir[m]] = p[m][g];
    }
    __syncthreads();  // dPre complete
    float* mine = recv + cur * C * BT * U;  // this step's slot set, in every peer
    for (int tile = tid; tile < GT; tile += blockDim.x) {
      const int rq = tile / KQ, kq = tile % KQ;
      float acc[16];  // [row][unit of the quad]
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = 0.f;
#pragma unroll 4
      for (int cc = 0; cc < NC; ++cc) {
        const float4 dv = *reinterpret_cast<const float4*>(dpT + cc * BT + rq * 4);
        float4 wv;
        if (RES) {
          wv = *reinterpret_cast<const float4*>(WsT + cc * Hp + kq * 4);
        } else {
          float w4[4];
          const int uu = cc >> 2;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int k = kq * 4 + kk;
            w4[kk] = uu < nu && k < H
                         ? __ldg(W + (size_t)k * H4 + (cc & 3) * H + j0 + uu) : 0.f;
          }
          wv = make_float4(w4[0], w4[1], w4[2], w4[3]);
        }
        const float dr[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[4 * i] = fmaf(dr[i], wv.x, acc[4 * i]);
          acc[4 * i + 1] = fmaf(dr[i], wv.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(dr[i], wv.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(dr[i], wv.w, acc[4 * i + 3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = kq * 4 + kk;
        if (k >= H) break;
        const int q = k / U;  // the unit's owner; its 4 rows in one store
        float* dst = cluster.map_shared_rank(mine, q) + (rank * U + k - q * U) * BT + rq * 4;
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[kk], acc[4 + kk], acc[8 + kk], acc[12 + kk]);
      }
    }
    cluster_arrive();  // this block's pieces are with their owners
    if (step + 1 < T) prefetch(step + 1, pf + (cur ^ 1) * BT * U * 6);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (ilen[m] < 0) continue;
      float* o = dxp + (((size_t)dir * T + t) * B + b0 + ir[m]) * H4 + j0 + iu[m];
#pragma unroll
      for (int g = 0; g < 4; ++g) o[g * H] = p[m][g];
    }
    cluster_wait();  // every piece of this step is here; every peer has read dPre
  }
}

// Dynamic shared memory of the backward sweep, and whether the slice is
// resident; false for a shape it does not take.
bool bwd_plan(int H, int BT, int C, size_t& smem, bool& resident) {
  if (H < 1 || (BT != 4 && BT != 8 && BT != 16) || C < 1 || C > 16) return false;
  const int U = (H + C - 1) / C;
  if (U > 64) return false;
  const size_t NC = 4 * U, Hp = (H + 3) & ~3;
  const size_t base = sizeof(float) * (NC * BT + 2 * C * BT * U + 2 * BT * U * 6);
  resident = base + sizeof(float) * NC * Hp <= smem_optin();
  smem = resident ? base + sizeof(float) * NC * Hp : base;
  return smem <= smem_optin();
}

int launch_bwd(const float* gout, const float* cs, const float* gates,
               const float* whf, const float* whb, const int* lens, float* dxp,
               int B, int T, int H, int BT, int C, cudaStream_t stream,
               int* max_clusters = nullptr) {
  size_t smem;
  bool res;
  if (!bwd_plan(H, BT, C, smem, res) || B < 0 || T < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;  // nothing to sweep
  const dim3 grid(C * ((B + BT - 1) / BT), 2);
  auto kern = res ? bilstm_bwd_kernel<true> : bilstm_bwd_kernel<false>;
  return launch_cluster(kern, grid, BWD_THREADS, smem, C, stream, max_clusters,
                        gout, cs, gates, whf, whb, lens, dxp, B, T, H, BT);
}

}  // namespace

// gout [B][T][2H] (the output's cotangent), cs [2][T][B][H] (c_{t-1}),
// gates [2][T][B][4H], whf/whb = W_hh [H][4H] per direction, lens [B];
// writes dxp [2][T][B][4H]. BT rows per batch tile, clusters of C blocks.
extern "C" int bilstm_bwd_recurrent(const float* gout, const float* cs,
                                    const float* gates, const float* whf,
                                    const float* whb, const int* lens,
                                    float* dxp, int B, int T, int H, int BT,
                                    int C, cudaStream_t stream) {
  return launch_bwd(gout, cs, gates, whf, whb, lens, dxp, B, T, H, BT, C, stream);
}

// As bilstm_fwd_plan (bilstm.cu), for the backward sweep.
extern "C" int bilstm_bwd_plan(int B, int H, int BT, int C, int* info,
                               cudaStream_t stream) {
  size_t smem;
  bool res;
  if (B < 1 || !bwd_plan(H, BT, C, smem, res)) return (int)cudaErrorInvalidValue;
  info[0] = BWD_THREADS;
  info[1] = (int)smem;
  info[2] = res ? 1 : 2;  // W_hh's slice in shared memory, or streamed
  return launch_bwd(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                    nullptr, B, 1, H, BT, C, stream, &info[3]);
}
