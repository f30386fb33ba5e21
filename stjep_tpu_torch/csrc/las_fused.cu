// K2 and K9 as cooperative persistent kernels: one launch per free-running
// LAS decode (K2, `las_greedy_fused`) and one per teacher-forced scan
// direction (K9, `las_tf_fwd_fused`, `las_tf_bwd_fused`).
//
// They replace stjep_tpu/ops/las_flash.py `las_greedy_flash` :168 (body
// `_kernel` :75, one launch with grid=(n_steps,)) and
// stjep_tpu/ops/las_tf_flash.py `las_tf_scan` :332 (`_fwd_kernel` :263,
// launched at :309; `_bwd_kernel` :364, launched at :412). On the TPU each
// ran all steps in one launch with every weight resident in VMEM; the port
// had driven them as host loops of ~11 (K2) and ~9 (K9) small launches a
// step, and launch latency, not the work, set their time.
//
// Design. Every block of the grid stays resident for the whole call
// (cudaLaunchCooperativeKernel, every block the card keeps resident) and
// walks the phases of each step, separated by cooperative_groups' grid
// barrier. Each phase walks its run of the plan's item table (ops/
// las_flash.py `las_tiles`, passed in as `tiles`); item i goes to block
// i % gridDim.x.
//   K2, a step (nl + 3 barriers; 6 at the recipe's 3 layers):
//     lstm x nl  a layer: an item owns 2 hidden units of 16 rows and
//                computes their four gate columns over the whole input
//                [x ; h], then the cell update in the same phase;
//     att        bilinear attention split over (row, key chunk): each item
//                writes its chunk's (max, sum, context); the last chunk of a
//                row to finish (a ticket counter, no atomics on values)
//                merges the row's chunks in chunk order;
//     ffn        [ctx ; q] @ W_ffn, the dynamic embedding, fed back;
//     head       [16 rows x 128 ids] items of the [Hs, V] head, each
//                leaving (max, lowest argmax, sum-exp) per row. After the
//                barrier every block merges all of a row's partials in
//                partial order itself (the next symbol, with PAD reading
//                the zero row, and block 0 the outputs), so the symbol
//                needs no phase of its own.
//   K9 forward, a step: the same lstm x 3, att, ffn (5 barriers), saving
//     the streams las_tf_fwd_plain returns; layer 0 adds the hoisted
//     pre0[t].
//   K9 backward, a reverse step (5 barriers; 3 at t = 0, the last):
//     ffn_t      dcell_t @ W_ffn^T: dctx (masked) and the query's part;
//     att        attention backward per (row, key chunk); the last chunk of
//                a row merges (sum attn * datt, the query cotangent),
//                writes the row's score cotangents and runs layer 2's
//                cell backward for the row;
//     lstm_t x2  dPre_l @ [W_ih ; W_hh]^T for layers 2 and 1; each item's
//                input columns feed the next layer's cell backward for the
//                same units in the same phase;
//     l0_t       dPre_0 @ W_0^T + gc[t] (the next step's dcell, dh_0).
//
// Products. Two item shapes walk the contraction in chunks copied with
// cp.async as 16-byte copies into a ring of DEPTH stages, DEPTH chunks in
// flight: a narrow item (16 rows x 8 columns, NKC deep chunks, the eight
// warps splitting each chunk and summed in warp order) for the LSTM
// layers, the FFN and the backward products, and a wide item (16 x 128,
// WKC deep) for the head. The forward's LSTM weights come packed [K, 4Hd]
// with a unit's four gates adjacent (`pack_gates`), so a narrow item's
// slice of a weight row is one 32-byte sector. The backward reads [W_ih ;
// W_hh] as it is, row by row (the transposed product), against the gate
// cotangents in their own layout. No copy starts before a barrier: a
// block starting its next item's first chunks there (weights, and a
// layer's recurrent half h_{t-1}) reached the barrier later by more than
// the overlap saved (PERF.md section 6).
//
// What bounds it on the H100: K2's head streams 4 * Hs * V bytes a step
// (61 MB at the flagship: 18 us at 3.35 TB/s, 1.6 ms a call), read with an
// L2 evict-first policy so that it does not push the LSTM and FFN weights
// (29 MB) out of the 50 MB L2. The rest of a step is its phases' copy
// traffic: a grid barrier costs ~1.3 us, but every narrow item copies its
// rows' whole operand beside its weight slice, so a layer phase moves ~3x
// the layer's weights through L2 (PERF.md). All arithmetic is ~11 us a
// step at 67 TFLOP/s f32. No tensor cores: the port keeps f32 (ROADMAP
// "Reduced precision").
//
// Deterministic and independent of the grid: the item table follows from
// the shapes alone, every sum runs in a fixed order, and a ticket only
// decides which block merges, not what the merge computes. Nothing falls
// back: a grid the card cannot hold, too little shared memory or
// workspace, or a refused launch returns the CUDA error and the wrapper
// raises.

#include <cooperative_groups.h>

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BM = 16;        // rows of an item
constexpr int NJ = 8;         // columns of a narrow item
constexpr int UNITS = NJ / 4;  // hidden units of an LSTM item
constexpr int NKC = 256;      // contraction depth of a narrow chunk
constexpr int NLD = NKC + 4;  // a transposed narrow chunk's weight row in shared memory
constexpr int ALD = NKC + 4;  // a narrow chunk's operand row in shared memory
constexpr int WJ = 128;       // columns of a wide (head) item
constexpr int WKC = 32;       // contraction depth of a wide chunk
constexpr int WLD = WKC + 4;  // a wide chunk's operand row
constexpr int DEPTH = 4;      // chunks in flight: the ring of stages
constexpr int NW = NJ * NLD;  // floats of a narrow chunk's weights (either layout)
constexpr int STAGE = NW + BM * ALD;  // floats of a stage
constexpr int RED = WARPS * BM * NJ;  // the narrow item's per-warp partials
constexpr int TC = 16;                // keys of an attention chunk
constexpr float MASK_FILL = -1e12f;   // ops/attention.py MASK_FILL
static_assert(WKC * WJ + BM * WLD <= STAGE, "a wide chunk fits a stage");

// item kinds of the plan's table, in ops/las_flash.py LAS_KINDS order
enum { I_LSTM, I_ATT, I_FFN, I_HEAD, I_FFN_T, I_LSTM_T, I_L0_T, N_KINDS };
enum { K_GREEDY, K_TF_FWD, K_TF_BWD };

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Workspace offsets in floats (ops/las_flash.py `_ws_regions` mirrors
// them): K2's carried state (X0 = [cell ; h_0] and X_l = [in ; h_l], two
// of each by step parity; C the cell states; FF = [ctx ; q]) and head
// partials (HM, HI, HS per 128-id tile and row; REF the logit at the
// reference id); the attention partials of a (row, chunk) (AM, AZ, ACTX,
// SC the scores; backward AS, AP1, AP2, DATT); the backward's carried
// cotangents DH, DC (3 layers each), DY1, DFFQ; CNT a ticket per row.
struct Lay {
  size_t X0, XL, C, FF, AM, AZ, ACTX, SC, HM, HI, HS, REF, DH, DC, DY1, DFFQ, AS, AP1, AP2,
      DATT, CNT, total;
};

// Regions start at multiples of 4 floats (16-byte copies read them).
__host__ __device__ inline size_t take(size_t& o, size_t n) {
  const size_t at = o;
  o += (n + 3) / 4 * 4;
  return at;
}

__host__ __device__ inline Lay lay(int kind, int B, int Tk, int Hd, int Hs, int Ha2, int V,
                                   int nl, int nc) {
  Lay l = {};
  size_t o = 0;
  const size_t b = B, bc = (size_t)B * nc;
  if (kind == K_GREEDY) {
    const size_t P = cdiv(V, WJ);
    l.X0 = take(o, 2 * b * (Hs + Hd));
    l.XL = take(o, (size_t)(nl - 1) * 2 * b * 2 * Hd);
    l.C = take(o, (size_t)nl * b * Hd);
    l.FF = take(o, b * (Ha2 + Hd));
    l.HM = take(o, P * b);
    l.HI = take(o, P * b);
    l.HS = take(o, P * b);
    l.REF = take(o, b);
  }
  if (kind == K_TF_BWD) {
    l.DH = take(o, 3 * b * Hd);
    l.DC = take(o, 3 * b * Hd);
    l.DY1 = take(o, b * Hd);
    l.DFFQ = take(o, b * Hd);
    l.AS = take(o, bc);
    l.AP1 = take(o, bc * Hd);
    l.AP2 = take(o, bc * Hd);
    l.DATT = take(o, b * Tk);
  } else {
    l.AM = take(o, bc);
    l.AZ = take(o, bc);
    l.ACTX = take(o, bc * Ha2);
    l.SC = take(o, b * Tk);
  }
  l.CNT = take(o, b);
  l.total = o;
  return l;
}

// Dynamic shared memory (floats): the ring of DEPTH stages, the narrow
// partials and result; an attention item's rows (its query or dctx row,
// its chunk's keys and values, scores, the merge's chunk factors) share
// the stages.
__host__ __device__ inline int smem_floats(int kind, int Hd, int Ha2, int nc) {
  const int att = kind == K_TF_BWD ? Ha2 + TC * (Ha2 + Hd) + 2 * TC
                                   : Hd + TC * (Hd + Ha2) + TC + nc;
  return (att > DEPTH * STAGE ? att : DEPTH * STAGE) + RED + BM * NJ;
}

#ifdef STJEP_FUSED_STAMPS
// Built with -DSTJEP_FUSED_STAMPS (scripts/fused_phase_split.py): block 0
// records the global timer (ns) at a launch's start and after each grid
// barrier into the buffer `las_fused_stamps` set, at [1 + n] with n counted
// in [0]; the launch's first 4 barriers guard no work (`bare_barriers`).
// With a second buffer it also records (tag, time) pairs inside its items:
// 1 an item's start, 2 its first chunk in shared memory, 3 its last chunk
// multiplied (at [1 + 2n], n counted in [0]).
__device__ unsigned long long* g_stamps;
__device__ unsigned long long* g_items;
#endif
__device__ __forceinline__ void stamp() {
#ifdef STJEP_FUSED_STAMPS
  if (g_stamps && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[1 + g_stamps[0]++] = t;
  }
#endif
}
__device__ __forceinline__ void item_stamp(int tag) {
#ifdef STJEP_FUSED_STAMPS
  if (g_items && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    const unsigned long long n = g_items[0]++;
    g_items[1 + 2 * n] = tag;
    g_items[2 + 2 * n] = t;
  }
#endif
}
__device__ __forceinline__ void barrier(cg::grid_group& grid) {
  grid.sync();
  stamp();
}
// The stamped build opens each launch with BARE grid barriers that guard
// no work: their stamps give a barrier's own cost on the same grid.
__device__ __forceinline__ void bare_barriers(cg::grid_group& grid) {
#ifdef STJEP_FUSED_STAMPS
  for (int i = 0; i < 4; ++i) barrier(grid);
#endif
}

// cp.async copies; a copy with valid false writes zeros and reads nothing
// (src must still be a global address: callers pass the workspace).
__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// An operand row: through L1 (.ca), where the SM's other block reads the
// same rows in the same phase.
__device__ __forceinline__ void cp16a(float* dst, const float* src, const float* dummy) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src ? src : dummy), "r"(src ? 16 : 0)
               : "memory");
}
// The head's weights: L2 evict-first, so its stream does not push the
// LSTM and FFN weights out of L2.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
__device__ __forceinline__ void cp16_ef(float* dst, const float* src, bool valid, uint64_t pol) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0), "l"(pol)
               : "memory");
}
__device__ __forceinline__ void cp4_ef(float* dst, const float* src, bool valid, uint64_t pol) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2, %3;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0), "l"(pol)
               : "memory");
}

// An item's operand: rows of a [B, K] matrix made of up to three column
// segments. Column k < k1 reads p0 at row ids[m] (m the row within the
// item; a PAD id, or a null p0, reads 0), k1 <= k < k2 reads p1, k >= k2
// reads p2; a null segment reads 0, and so do rows past B. Segments start
// and rows stride at multiples of 4 floats, so 4 columns from a multiple
// of 4 are one 16-byte copy.
struct Operand {
  const int* ids;
  const float *p0, *p1, *p2;
  int ld0, ld1, ld2, k1, k2;
};

__device__ __forceinline__ const float* operand_at(const Operand& o, int m, int r, int k,
                                                   int B) {
  if (r >= B) return nullptr;
  if (k < o.k1) {
    const int id = o.ids[m];
    return o.p0 && id != STJEP_PAD ? o.p0 + (size_t)id * o.ld0 + k : nullptr;
  }
  if (k < o.k2) return o.p1 ? o.p1 + (size_t)r * o.ld1 + (k - o.k1) : nullptr;
  return o.p2 ? o.p2 + (size_t)r * o.ld2 + (k - o.k2) : nullptr;
}

// One narrow product: out[m, j] = sum_k A[m, k] * W[k, c0 + j] (W [K, ldw]),
// or with TRANS sum_k A[m, k] * W[c0 + j, k] (W rows of length K); outputs
// past nout are not computed.
struct Narrow {
  const float* W;
  int ldw, K, nout;
  Operand a;
};

// Start chunk c of the item (rows row0.., columns c0..) into stage st, all
// as 16-byte copies (K, ldw and the operand's segments multiples of 4):
// the weights as st[k * NJ + j] (TRANS: st[j * NLD + k]), the operand as
// st[NW + m * ALD + k]. The caller commits.
template <bool TRANS>
__device__ void narrow_copy(const Narrow& p, int row0, int c0, int c, float* st, int B,
                             const float* dummy) {
  const int kb = c * NKC, ke = min(p.K, kb + NKC);
  if (TRANS) {
    for (int e = threadIdx.x; e < NJ * (NKC / 4); e += THREADS) {
      const int j = e / (NKC / 4), k = (e % (NKC / 4)) * 4;
      const int gr = c0 + j, gk = kb + k;
      const bool ok = gr < p.nout && gk < ke;
      cp16(st + j * NLD + k, ok ? p.W + (size_t)gr * p.ldw + gk : dummy, ok);
    }
  } else {
    for (int e = threadIdx.x; e < NKC * (NJ / 4); e += THREADS) {
      const int k = e / (NJ / 4), j = (e % (NJ / 4)) * 4;
      const int gk = kb + k, gc = c0 + j;
      const bool ok = gk < ke && gc < p.nout;
      cp16(st + k * NJ + j, ok ? p.W + (size_t)gk * p.ldw + gc : dummy, ok);
    }
  }
  float* as = st + NW;
  for (int e = threadIdx.x; e < BM * (NKC / 4); e += THREADS) {
    const int m = e / (NKC / 4), k = (e % (NKC / 4)) * 4;
    const int gk = kb + k;
    cp16a(as + m * ALD + k, gk < ke ? operand_at(p.a, m, row0 + m, gk, B) : nullptr, dummy);
  }
}

// Multiply one chunk: warp w takes k in [w * NKC / WARPS, ...) in order;
// lane (j, rq) owns column j of rows rq, rq + 4, rq + 8, rq + 12.
template <bool TRANS>
__device__ __forceinline__ void narrow_mma(const float* st, float acc[4]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int j = lane & 7, rq = lane >> 3;
  const float* as = st + NW + rq * ALD;
  constexpr int KW = NKC / WARPS;
#pragma unroll 8
  for (int kk = 0; kk < KW; ++kk) {
    const int k = w * KW + kk;
    const float wv = TRANS ? st[j * NLD + k] : st[k * NJ + j];
    acc[0] = fmaf(as[k], wv, acc[0]);
    acc[1] = fmaf(as[4 * ALD + k], wv, acc[1]);
    acc[2] = fmaf(as[8 * ALD + k], wv, acc[2]);
    acc[3] = fmaf(as[12 * ALD + k], wv, acc[3]);
  }
}

// A narrow item over the ring of DEPTH stages: chunk c in stage c % DEPTH,
// DEPTH chunks in flight. The warps' sums are added in warp order into
// out[m * NJ + j] (shared), complete for every thread on return.
template <bool TRANS>
__device__ void narrow_item(const Narrow& p, int row0, int c0, int B, float* sm,
                            const float* dummy) {
  const int nch = cdiv(p.K, NKC);
  item_stamp(1);
  for (int c = 0; c < DEPTH; ++c) {
    if (c < nch) narrow_copy<TRANS>(p, row0, c0, c, sm + c * STAGE, B, dummy);
    cp_async_commit();
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<DEPTH - 1>();
    __syncthreads();
    if (c == 0) item_stamp(2);
    narrow_mma<TRANS>(sm + (c % DEPTH) * STAGE, acc);
    __syncthreads();
    if (c + DEPTH < nch)
      narrow_copy<TRANS>(p, row0, c0, c + DEPTH, sm + (c % DEPTH) * STAGE, B, dummy);
    cp_async_commit();
  }
  item_stamp(3);
  float* red = sm + DEPTH * STAGE;
  float* out = red + RED;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int j = lane & 7, rq = lane >> 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) red[w * BM * NJ + (rq + 4 * i) * NJ + j] = acc[i];
  __syncthreads();
  if (threadIdx.x < BM * NJ) {
    float v = 0.f;
    for (int q = 0; q < WARPS; ++q) v += red[q * BM * NJ + threadIdx.x];
    out[threadIdx.x] = v;
  }
  __syncthreads();
}

// The wide (head) item: rows row0.., ids c0 .. c0 + WJ of W [K, ldw];
// thread (ty, tx) accumulates rows ty, ty + 8 and ids 4tx .. 4tx + 3 over
// k in order, in acc. Chunk c (weights st[k * WJ + j], operand
// st[WKC * WJ + m * WLD + k]) in stage c % DEPTH.
__device__ void wide_copy(const float* W, int ldw, int K, int nout, const Operand& a,
                           int row0, int c0, int c, float* st, int B, const float* dummy,
                           uint64_t pol) {
  const int kb = c * WKC;
  if (ldw % 4 == 0) {
    for (int e = threadIdx.x; e < WKC * (WJ / 4); e += THREADS) {
      const int k = e / (WJ / 4), j = (e % (WJ / 4)) * 4;
      const int gk = kb + k, gc = c0 + j;
      const bool ok = gk < K && gc < nout;
      cp16_ef(st + k * WJ + j, ok ? W + (size_t)gk * ldw + gc : dummy, ok, pol);
    }
  } else {  // rows not 16-byte aligned (an odd vocabulary)
    for (int e = threadIdx.x; e < WKC * WJ; e += THREADS) {
      const int k = e / WJ, j = e % WJ;
      const int gk = kb + k, gc = c0 + j;
      const bool ok = gk < K && gc < nout;
      cp4_ef(st + k * WJ + j, ok ? W + (size_t)gk * ldw + gc : dummy, ok, pol);
    }
  }
  float* as = st + WKC * WJ;
  for (int e = threadIdx.x; e < BM * (WKC / 4); e += THREADS) {
    const int m = e / (WKC / 4), k = (e % (WKC / 4)) * 4;
    const int gk = kb + k;
    cp16a(as + m * WLD + k, gk < K ? operand_at(a, m, row0 + m, gk, B) : nullptr, dummy);
  }
}

__device__ void wide_item(const float* W, int ldw, int K, int nout, const Operand& a,
                          int row0, int c0, int B, float* sm, const float* dummy,
                          uint64_t pol, float acc[2][4]) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int nch = cdiv(K, WKC);
  for (int i = 0; i < 2; ++i)
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  item_stamp(1);
  for (int c = 0; c < DEPTH; ++c) {
    if (c < nch) wide_copy(W, ldw, K, nout, a, row0, c0, c, sm + c * STAGE, B, dummy, pol);
    cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<DEPTH - 1>();
    __syncthreads();
    if (c == 0) item_stamp(2);
    const float* st = sm + (c % DEPTH) * STAGE;
    const float4* w4 = reinterpret_cast<const float4*>(st);
    const float* a0p = st + WKC * WJ + ty * WLD;
    const float* a1p = a0p + 8 * WLD;
#pragma unroll 8
    for (int k = 0; k < WKC; ++k) {
      const float4 w = w4[k * (WJ / 4) + tx];
      const float a0 = a0p[k], a1 = a1p[k];
      acc[0][0] = fmaf(a0, w.x, acc[0][0]);
      acc[0][1] = fmaf(a0, w.y, acc[0][1]);
      acc[0][2] = fmaf(a0, w.z, acc[0][2]);
      acc[0][3] = fmaf(a0, w.w, acc[0][3]);
      acc[1][0] = fmaf(a1, w.x, acc[1][0]);
      acc[1][1] = fmaf(a1, w.y, acc[1][1]);
      acc[1][2] = fmaf(a1, w.z, acc[1][2]);
      acc[1][3] = fmaf(a1, w.w, acc[1][3]);
    }
    __syncthreads();
    if (c + DEPTH < nch)
      wide_copy(W, ldw, K, nout, a, row0, c0, c + DEPTH, sm + (c % DEPTH) * STAGE, B, dummy,
                 pol);
    cp_async_commit();
  }
  item_stamp(3);
}

// (value, index) arg-max across the warp, lowest index on ties.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// One warp merges row b's head partials (P tiles of 128 ids, [B, P]) in
// one pass: lane l takes tiles l, l + 32, ... in order (8 loads in flight),
// keeping the running arg-max (lowest index on ties) and the sum-exp
// relative to it; the lanes then combine in a fixed butterfly. Gives the
// arg-max and lane 0 the log-sum-exp.
__device__ void head_merge(const float* HM, const int* HI, const float* HS, int P, int B, int b,
                           int& best, float& lse) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY, s = 0.f;
  int i = INT_MAX;
  for (int p0 = lane; p0 < P; p0 += 32 * 8) {
    float v[8], z[8];
    int id[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int p = p0 + 32 * u;
      v[u] = p < P ? __ldcg(HM + (size_t)b * P + p) : -INFINITY;
      id[u] = p < P ? __ldcg(HI + (size_t)b * P + p) : INT_MAX;
      z[u] = p < P ? __ldcg(HS + (size_t)b * P + p) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (p0 + 32 * u >= P) continue;
      if (better(v[u], id[u], m, i)) {
        s = s * expf(m - v[u]) + z[u];
        m = v[u];
        i = id[u];
      } else {
        s += z[u] * expf(v[u] - m);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, o);
    const float os = __shfl_xor_sync(0xffffffffu, s, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(om, oi, m, i)) {
      s = s * expf(m - om) + os;
      m = om;
      i = oi;
    } else if (om != -INFINITY) {  // a lane with no tiles (P < 32) adds nothing
      s += os * expf(om - m);
    }
  }
  best = i;
  lse = m + logf(s);
}

// After a chunk item of row b wrote its partials: true in the block that
// finished the row's last chunk (it then merges, and resets the ticket).
__device__ bool last_of_row(int* cnt, int b, int nc) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(cnt + b, 1) == nc - 1;
    __threadfence();
  }
  __syncthreads();
  return last;
}

// Attention forward over one (row b, keys t0 .. t1) chunk c of at most TC
// keys: the query row, the chunk's keys and values copied into shared
// memory together; scores q . wk[b, t] (-1e12 at t >= lens[b]), the
// chunk's max, sum-exp and exp-weighted context. The row's last chunk
// merges them in chunk order into ctx (times mctx when given) and, with
// attn, the probabilities.
struct AttF {
  const float *q, *wk, *val, *mctx;
  const long long* lens;
  float *ctx, *attn;
  int ldq, ldctx;
};

__device__ void att_fwd_item(const AttF& a, int4 it, const Lay& L, float* ws, int Tk, int Hd,
                             int Ha2, int nc, float* sm, float* red32) {
  const int b = it.x, t0 = it.y, n = it.z - it.y, c = it.w;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* q = sm;
  float* kc = q + Hd;
  float* vc = kc + TC * Hd;
  float* e = vc + TC * Ha2;
  float* fac = e + TC;
  float* AM = ws + L.AM;
  float* AZ = ws + L.AZ;
  float* SC = ws + L.SC;
  for (int x = threadIdx.x; x < Hd / 4; x += THREADS)
    cp16(q + 4 * x, a.q + (size_t)b * a.ldq + 4 * x, true);
  for (int x = threadIdx.x; x < n * (Hd / 4); x += THREADS)
    cp16(kc + 4 * x, a.wk + ((size_t)b * Tk + t0) * Hd + 4 * x, true);
  for (int x = threadIdx.x; x < n * (Ha2 / 4); x += THREADS)
    cp16(vc + 4 * x, a.val + ((size_t)b * Tk + t0) * Ha2 + 4 * x, true);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const long long len = a.lens[b];
  for (int i = warp; i < n; i += WARPS) {
    const int t = t0 + i;
    float s = 0.f;
    for (int h = lane; h < Hd; h += 32) s = fmaf(q[h], kc[i * Hd + h], s);
    s = warp_sum(s);
    if (lane == 0) {
      s = t >= len ? MASK_FILL : s;
      e[i] = s;
      SC[(size_t)b * Tk + t] = s;
    }
  }
  __syncthreads();
  float m = -INFINITY;
  for (int i = threadIdx.x; i < n; i += THREADS) m = fmaxf(m, e[i]);
  m = block_max(m, red32);
  float z = 0.f;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const float x = expf(e[i] - m);
    e[i] = x;
    z += x;
  }
  z = block_sum(z, red32);
  float* part = ws + L.ACTX + ((size_t)b * nc + c) * Ha2;
  for (int d = threadIdx.x; d < Ha2; d += THREADS) {
    float acc = 0.f;
    for (int i = 0; i < n; ++i) acc = fmaf(e[i], vc[i * Ha2 + d], acc);
    part[d] = acc;
  }
  if (threadIdx.x == 0) {
    AM[(size_t)b * nc + c] = m;
    AZ[(size_t)b * nc + c] = z;
  }
  int* cnt = reinterpret_cast<int*>(ws + L.CNT);
  if (!last_of_row(cnt, b, nc)) return;
  float M = -INFINITY;
  for (int cc = threadIdx.x; cc < nc; cc += THREADS) M = fmaxf(M, __ldcg(AM + (size_t)b * nc + cc));
  M = block_max(M, red32);
  for (int cc = threadIdx.x; cc < nc; cc += THREADS)
    fac[cc] = expf(__ldcg(AM + (size_t)b * nc + cc) - M);
  __syncthreads();
  float Z = 0.f;
  for (int cc = 0; cc < nc; ++cc) Z += __ldcg(AZ + (size_t)b * nc + cc) * fac[cc];
  const float* parts = ws + L.ACTX + (size_t)b * nc * Ha2;
  for (int d = threadIdx.x; d < Ha2; d += THREADS) {
    float acc = 0.f;
#pragma unroll 8
    for (int cc = 0; cc < nc; ++cc) acc = fmaf(__ldcg(parts + (size_t)cc * Ha2 + d), fac[cc], acc);
    float v = acc / Z;
    if (a.mctx) v *= a.mctx[(size_t)b * Ha2 + d];
    a.ctx[(size_t)b * a.ldctx + d] = v;
  }
  if (a.attn)
    for (int t = threadIdx.x; t < Tk; t += THREADS)
      a.attn[(size_t)b * Tk + t] = expf(__ldcg(SC + (size_t)b * Tk + t) - M) / Z;
  if (threadIdx.x == 0) cnt[b] = 0;
  __syncthreads();
}

// The LSTM cell forward for unit u of row b from its four pre-activations:
// returns h, updates c.
__device__ __forceinline__ float cell_fwd(float pi, float pf, float pg, float po, float& c,
                                          float* gates) {
  const float gi = sigmoidf_(pi), gf = sigmoidf_(pf), gg = tanhf(pg), go = sigmoidf_(po);
  c = gf * c + gi * gg;
  if (gates) {
    gates[0] = gi;
    gates[1] = gf;
    gates[2] = gg;
    gates[3] = go;
  }
  return go * tanhf(c);
}

// ---------------------------------------------------------------------------
// K2: the free-running decode
// ---------------------------------------------------------------------------

struct GreedyArgs {
  const float *table, *w_lstm, *b_lstm, *w_ffn, *w_out, *b_out, *wk, *val;
  const long long *sym0, *lens;
  const int* refs;
  float *embs, *picked;
  long long* preds;
  float* ws;
  const int4* tiles;
  int B, Tk, E, Hd, Hs, Ha2, V, nl, n, nc;
};

// Layer l's product at step t: [emb(sym) ; cell ; h_0] or [in ; h_l]
// against the packed [W_ih ; W_hh].
__device__ Narrow greedy_layer(const GreedyArgs& a, const Lay& L, int l, int t,
                               const int* sym) {
  const int Hd = a.Hd, Hs = a.Hs, G = 4 * Hd, p = t & 1;
  const size_t K0 = (size_t)a.E + Hs + Hd;
  Narrow np = {};
  np.ldw = G;
  np.nout = G;
  if (l == 0) {
    const float* x = a.ws + L.X0 + (size_t)p * a.B * (Hs + Hd);
    np.W = a.w_lstm;
    np.K = (int)K0;
    np.a = {sym, a.table, t ? x : nullptr, t ? x + Hs : nullptr, a.E, Hs + Hd, Hs + Hd, a.E,
            a.E + Hs};
  } else {
    const float* x = a.ws + L.XL + ((size_t)(l - 1) * 2 + p) * a.B * 2 * Hd;
    np.W = a.w_lstm + K0 * G + (size_t)(l - 1) * 2 * Hd * G;
    np.K = 2 * Hd;
    np.a = {nullptr, nullptr, x, t ? x + Hd : nullptr, 0, 2 * Hd, 2 * Hd, 0, Hd};
  }
  return np;
}

__device__ void greedy_outputs(const GreedyArgs& a, const Lay& L, int t) {
  const int P = cdiv(a.V, WJ);
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x >> 5; b < a.B; b += WARPS) {
    int best;
    float lse;
    head_merge(a.ws + L.HM, reinterpret_cast<const int*>(a.ws + L.HI), a.ws + L.HS, P, a.B, b,
               best, lse);
    if (lane == 0) {
      a.preds[(size_t)b * a.n + t] = best;
      a.picked[(size_t)b * a.n + t] = __ldcg(a.ws + L.REF + b) - lse;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2) greedy_kernel(const GreedyArgs a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float red32[32];
  __shared__ int sym[BM];
  cg::grid_group grid = cg::this_grid();
  stamp();
  bare_barriers(grid);
  const Lay L = lay(K_GREEDY, a.B, a.Tk, a.Hd, a.Hs, a.Ha2, a.V, a.nl, a.nc);
  const int* off = reinterpret_cast<const int*>(a.tiles);
  const int4* tb = a.tiles + 2;
  const int B = a.B, Hd = a.Hd, Hs = a.Hs, Ha2 = a.Ha2, P = cdiv(a.V, WJ);
  const float* dummy = a.ws;
  float* FF = a.ws + L.FF;
  int* cnt = reinterpret_cast<int*>(a.ws + L.CNT);
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < B; i += gridDim.x * THREADS) cnt[i] = 0;
  const uint64_t pol = evict_first();
  const bool outputs = blockIdx.x == gridDim.x - 1;  // merges and writes each step's outputs
  const Narrow nf = {a.w_ffn, Hs, Ha2 + Hd, Hs,
                     {nullptr, nullptr, FF, nullptr, 0, Ha2 + Hd, 0, 0, Ha2 + Hd}};
  for (int t = 0; t < a.n; ++t) {
    const int p = t & 1, q = p ^ 1;
    for (int l = 0; l < a.nl; ++l) {
      const Narrow np = greedy_layer(a, L, l, t, sym);
      const float* bias = a.b_lstm + (size_t)l * 4 * Hd;
      float* C = a.ws + L.C + (size_t)l * B * Hd;
      const size_t xw = l ? 2 * Hd : Hs + Hd;  // the layer's [in ; h] row
      float* xin = l ? a.ws + L.XL + ((size_t)(l - 1) * 2 + p) * B * 2 * Hd : nullptr;
      float* hdst = l ? a.ws + L.XL + ((size_t)(l - 1) * 2 + q) * B * 2 * Hd + Hd
                      : a.ws + L.X0 + (size_t)q * B * (Hs + Hd) + Hs;
      float* out = l + 1 < a.nl ? a.ws + L.XL + ((size_t)l * 2 + p) * B * 2 * Hd : FF + Ha2;
      const size_t ldo = l + 1 < a.nl ? 2 * Hd : Ha2 + Hd;
      if (l == 0 && t > 0 && outputs) greedy_outputs(a, L, t - 1);
      for (int i = off[I_LSTM] + blockIdx.x; i < off[I_LSTM + 1]; i += gridDim.x) {
        const int4 it = tb[i];
        const int row0 = it.x, u0 = it.y;
        if (l == 0) {  // the fed-back symbols of the item's rows
          for (int m = threadIdx.x >> 5; m < BM; m += WARPS) {
            const int b = row0 + m;
            int best = STJEP_PAD;
            float lse;
            if (b < B && t > 0)
              head_merge(a.ws + L.HM, reinterpret_cast<const int*>(a.ws + L.HI), a.ws + L.HS,
                         P, B, b, best, lse);
            else if (b < B)
              best = (int)a.sym0[b];
            if ((threadIdx.x & 31) == 0) sym[m] = best;
          }
          __syncthreads();
        }
        narrow_item<false>(np, row0, 4 * u0, B, sm, dummy);
        const float* o = sm + DEPTH * STAGE + RED;
        if (threadIdx.x < BM * UNITS) {
          const int m = threadIdx.x / UNITS, u = u0 + threadIdx.x % UNITS, b = row0 + m;
          if (b < B && u < Hd) {
            const float* g = o + m * NJ + 4 * (threadIdx.x % UNITS);
            float c = t ? C[(size_t)b * Hd + u] : 0.f;
            const float h = cell_fwd(g[0] + bias[u], g[1] + bias[Hd + u], g[2] + bias[2 * Hd + u],
                                     g[3] + bias[3 * Hd + u], c, nullptr);
            C[(size_t)b * Hd + u] = c;
            hdst[(size_t)b * xw + u] = h;
            const bool resid = l > 0 && l + 1 < a.nl;
            out[(size_t)b * ldo + u] = resid ? h + xin[(size_t)b * xw + u] : h;
          }
        }
        __syncthreads();
      }
      barrier(grid);  // layer l's outputs complete
    }
    const AttF af = {FF + Ha2, a.wk, a.val, nullptr, a.lens, FF, nullptr, Ha2 + Hd, Ha2 + Hd};
    for (int i = off[I_ATT] + blockIdx.x; i < off[I_ATT + 1]; i += gridDim.x)
      att_fwd_item(af, tb[i], L, a.ws, a.Tk, Hd, Ha2, a.nc, sm, red32);
    barrier(grid);  // every row's context complete
    float* cell = a.ws + L.X0 + (size_t)q * B * (Hs + Hd);
    for (int i = off[I_FFN] + blockIdx.x; i < off[I_FFN + 1]; i += gridDim.x) {
      const int4 it = tb[i];
      narrow_item<false>(nf, it.x, it.y, B, sm, dummy);
      if (threadIdx.x < BM * NJ) {
        const int b = it.x + threadIdx.x / NJ, j = it.y + threadIdx.x % NJ;
        if (b < B && j < Hs) {
          const float v = sm[DEPTH * STAGE + RED + threadIdx.x];
          a.embs[((size_t)b * a.n + t) * Hs + j] = v;
          cell[(size_t)b * (Hs + Hd) + j] = v;
        }
      }
      __syncthreads();
    }
    barrier(grid);  // the dynamic embeddings complete
    const Operand oe = {nullptr, nullptr, a.embs + (size_t)t * Hs, nullptr, 0, a.n * Hs, 0, 0, Hs};
    for (int i = off[I_HEAD] + blockIdx.x; i < off[I_HEAD + 1]; i += gridDim.x) {
      const int4 it = tb[i];
      const int row0 = it.x, c0 = it.y;
      float acc[2][4];
      wide_item(a.w_out, a.V, Hs, a.V, oe, row0, c0, B, sm, dummy, pol, acc);
      const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
      for (int r = 0; r < 2; ++r) {
        const int b = row0 + ty + 8 * r;
        float v[4], bv = -INFINITY;
        int bi = INT_MAX;
        for (int k = 0; k < 4; ++k) {
          const int col = c0 + 4 * tx + k;
          v[k] = col < a.V ? acc[r][k] + a.b_out[col] : -INFINITY;
          if (col < a.V && better(v[k], col, bv, bi)) {
            bv = v[k];
            bi = col;
          }
        }
        warp_argmax(bv, bi);
        float s = 0.f;
        for (int k = 0; k < 4; ++k)
          if (c0 + 4 * tx + k < a.V) s += expf(v[k] - bv);
        s = warp_sum(s);
        if (b < B) {
          const int pi = c0 / WJ;
          if (tx == 0) {
            a.ws[L.HM + (size_t)b * P + pi] = bv;
            reinterpret_cast<int*>(a.ws + L.HI)[(size_t)b * P + pi] = bi;
            a.ws[L.HS + (size_t)b * P + pi] = s;
          }
          const int ref = a.refs ? a.refs[(size_t)b * a.n + t] : 0;
          for (int k = 0; k < 4; ++k)
            if (ref == c0 + 4 * tx + k) a.ws[L.REF + b] = v[k];
        }
      }
    }
    barrier(grid);  // every head partial complete
  }
  if (outputs) greedy_outputs(a, L, a.n - 1);
}

// ---------------------------------------------------------------------------
// K9 forward: the teacher-forced scan, saving its streams
// ---------------------------------------------------------------------------

struct TfFwdArgs {
  const float *w0, *w1, *w2, *b1, *b2, *w_ffn, *pre0, *wk, *val, *m_lstm, *m_ctx;
  const long long* lens;
  float *x0, *x1, *x2, *ff, *c, *g, *attn;
  float* ws;
  const int4* tiles;
  int S, B, Tk, Hd, Hs, Ha2, nc;
};

__device__ Narrow tf_layer(const TfFwdArgs& a, int l, int t) {
  const int Hd = a.Hd, kin = l ? Hd : a.Hs, xw = kin + Hd;
  const float* x = (l == 0 ? a.x0 : l == 1 ? a.x1 : a.x2) + (size_t)t * a.B * xw;
  Narrow np = {};
  np.W = l == 0 ? a.w0 : l == 1 ? a.w1 : a.w2;
  np.ldw = 4 * Hd;
  np.nout = 4 * Hd;
  np.K = xw;
  np.a = {nullptr, nullptr, (l == 0 && t == 0) ? nullptr : x, t ? x + kin : nullptr,
          0, xw, xw, 0, kin};
  return np;
}

__global__ void __launch_bounds__(THREADS, 2) tf_fwd_kernel(const TfFwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float red32[32];
  cg::grid_group grid = cg::this_grid();
  stamp();
  bare_barriers(grid);
  const Lay L = lay(K_TF_FWD, a.B, a.Tk, a.Hd, a.Hs, a.Ha2, 0, 3, a.nc);
  const int* off = reinterpret_cast<const int*>(a.tiles);
  const int4* tb = a.tiles + 2;
  const int B = a.B, S = a.S, Hd = a.Hd, Hs = a.Hs, Ha2 = a.Ha2;
  const size_t w0 = Hs + Hd, w1 = 2 * Hd, wf = Ha2 + Hd;
  const float* dummy = a.ws;
  // the state before the first step and the rows no step writes: zero
  {
    const int gt = blockIdx.x * THREADS + threadIdx.x, gn = gridDim.x * THREADS;
    int* cnt = reinterpret_cast<int*>(a.ws + L.CNT);
    for (int i = gt; i < B; i += gn) cnt[i] = 0;
    for (size_t i = gt; i < (size_t)B * w0; i += gn) a.x0[i] = 0.f;
    for (size_t i = gt; i < (size_t)B * Hd; i += gn) {
      const size_t b = i / Hd, u = i % Hd;
      a.x1[b * w1 + Hd + u] = 0.f;
      a.x2[b * w1 + Hd + u] = 0.f;
      a.x1[((size_t)S * B + b) * w1 + u] = 0.f;
      a.x2[((size_t)S * B + b) * w1 + u] = 0.f;
      for (int l = 0; l < 3; ++l) a.c[(size_t)l * (S + 1) * B * Hd + i] = 0.f;
    }
  }
  for (int t = 0; t < S; ++t) {
    for (int l = 0; l < 3; ++l) {
      const Narrow np = tf_layer(a, l, t);
      const size_t xw = l ? w1 : w0, kin = l ? Hd : Hs;
      float* x = (l == 0 ? a.x0 : l == 1 ? a.x1 : a.x2);
      float* xt = x + (size_t)t * B * xw;
      float* xn = x + (size_t)(t + 1) * B * xw;
      float* out = l == 0 ? a.x1 + (size_t)t * B * w1
                          : l == 1 ? a.x2 + (size_t)t * B * w1 : a.ff + (size_t)t * B * wf + Ha2;
      const size_t ldo = l < 2 ? w1 : wf;
      const float* cprev = a.c + ((size_t)l * (S + 1) + t) * B * Hd;
      float* cnext = a.c + ((size_t)l * (S + 1) + t + 1) * B * Hd;
      float* gsave = a.g + ((size_t)l * S + t) * B * 4 * Hd;
      const float* mask = a.m_lstm ? a.m_lstm + ((size_t)t * 3 + l) * B * Hd : nullptr;
      const float* bias = l == 1 ? a.b1 : a.b2;
      const float* pre0 = a.pre0 + (size_t)t * B * 4 * Hd;
      for (int i = off[I_LSTM] + blockIdx.x; i < off[I_LSTM + 1]; i += gridDim.x) {
        const int4 it = tb[i];
        const int row0 = it.x, u0 = it.y;
        narrow_item<false>(np, row0, 4 * u0, B, sm, dummy);
        const float* o = sm + DEPTH * STAGE + RED;
        if (threadIdx.x < BM * UNITS) {
          const int m = threadIdx.x / UNITS, u = u0 + threadIdx.x % UNITS, b = row0 + m;
          if (b < B && u < Hd) {
            const float* pg = o + m * NJ + 4 * (threadIdx.x % UNITS);
            float pre[4];
            for (int k = 0; k < 4; ++k)
              pre[k] = pg[k] + (l == 0 ? pre0[(size_t)b * 4 * Hd + k * Hd + u] : bias[k * Hd + u]);
            float c = t ? cprev[(size_t)b * Hd + u] : 0.f;
            float gs[4];
            const float h = cell_fwd(pre[0], pre[1], pre[2], pre[3], c, gs);
            for (int k = 0; k < 4; ++k) gsave[(size_t)b * 4 * Hd + k * Hd + u] = gs[k];
            cnext[(size_t)b * Hd + u] = c;
            xn[(size_t)b * xw + kin + u] = h;
            float y = l == 1 ? h + xt[(size_t)b * xw + u] : h;
            if (mask) y *= mask[(size_t)b * Hd + u];
            out[(size_t)b * ldo + u] = y;
          }
        }
        __syncthreads();
      }
      barrier(grid);  // layer l's outputs and saves complete
    }
    float* ff = a.ff + (size_t)t * B * wf;
    const AttF af = {ff + Ha2, a.wk, a.val, a.m_ctx ? a.m_ctx + (size_t)t * B * Ha2 : nullptr,
                     a.lens, ff, a.attn + (size_t)t * B * a.Tk, (int)wf, (int)wf};
    for (int i = off[I_ATT] + blockIdx.x; i < off[I_ATT + 1]; i += gridDim.x)
      att_fwd_item(af, tb[i], L, a.ws, a.Tk, Hd, Ha2, a.nc, sm, red32);
    const Narrow nf = {a.w_ffn, Hs, (int)wf, Hs,
                       {nullptr, nullptr, ff, nullptr, 0, (int)wf, 0, 0, (int)wf}};
    barrier(grid);  // ctx and the probabilities complete
    float* cell = a.x0 + (size_t)(t + 1) * B * w0;
    for (int i = off[I_FFN] + blockIdx.x; i < off[I_FFN + 1]; i += gridDim.x) {
      const int4 it = tb[i];
      narrow_item<false>(nf, it.x, it.y, B, sm, dummy);
      if (threadIdx.x < BM * NJ) {
        const int b = it.x + threadIdx.x / NJ, j = it.y + threadIdx.x % NJ;
        if (b < B && j < Hs) cell[(size_t)b * w0 + j] = sm[DEPTH * STAGE + RED + threadIdx.x];
      }
      __syncthreads();
    }
    if (t + 1 < S) barrier(grid);  // the dynamic embeddings complete
  }
}

// ---------------------------------------------------------------------------
// K9 backward: the reverse steps
// ---------------------------------------------------------------------------

struct TfBwdArgs {
  const float *w0, *w1, *w2, *w_ffn, *g, *c, *attn, *wk, *val, *m_lstm, *m_ctx, *g_cell;
  float *dpre, *dsc, *dctx, *dcell;
  float* ws;
  const int4* tiles;
  int S, B, Tk, Hd, Hs, Ha2, nc;
};

// The cell backward of layer l, unit u of row b at step t from the
// cotangent go of its (masked) output: dpre[l, t] and the carried dc.
__device__ __forceinline__ void tf_cell_bwd(const TfBwdArgs& a, const Lay& L, int l, int t,
                                            int b, int u, float go, bool first) {
  const int B = a.B, Hd = a.Hd, S = a.S;
  const size_t e = (size_t)b * Hd + u;
  float* DH = a.ws + L.DH + (size_t)l * B * Hd;
  float* DC = a.ws + L.DC + (size_t)l * B * Hd;
  const float* g = a.g + (((size_t)l * S + t) * B + b) * 4 * Hd + u;
  const float c_prev = a.c[((size_t)l * (S + 1) + t) * B * Hd + e];
  const float dh = go + (first ? 0.f : DH[e]);
  const float dc = first ? 0.f : DC[e];
  DC[e] = lstm_cell_bwd(g[0], g[Hd], g[2 * Hd], g[3 * Hd], c_prev, dh, dc,
                        a.dpre + (((size_t)l * S + t) * B + b) * 4 * Hd + u, Hd);
}

// Attention backward over one (row b, keys t0 .. t1) chunk c at step t:
// datt = dctx . val[b, t], and the chunk's sum attn * datt and its
// attn * datt- and attn-weighted key sums. The row's last chunk merges them
// in chunk order: S = sum attn * datt, dsc = attn * (datt - S), the query
// cotangent dq = dffq + sum (attn * datt - S * attn) wk, and runs layer
// 2's cell backward for the row.
__device__ void att_bwd_item(const TfBwdArgs& a, int4 it, const Lay& L, int t, bool first,
                             float* sm, float* red32) {
  const int b = it.x, t0 = it.y, n = it.z - it.y, c = it.w;
  const int B = a.B, Tk = a.Tk, Hd = a.Hd, Ha2 = a.Ha2, nc = a.nc;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* dctx = sm;
  float* vc = dctx + Ha2;
  float* kc = vc + TC * Ha2;
  float* da = kc + TC * Hd;
  float* at = da + TC;
  const float* attn = a.attn + ((size_t)t * B + b) * Tk;
  for (int x = threadIdx.x; x < Ha2 / 4; x += THREADS)
    cp16(dctx + 4 * x, a.dctx + ((size_t)t * B + b) * Ha2 + 4 * x, true);
  for (int x = threadIdx.x; x < n * (Ha2 / 4); x += THREADS)
    cp16(vc + 4 * x, a.val + ((size_t)b * Tk + t0) * Ha2 + 4 * x, true);
  for (int x = threadIdx.x; x < n * (Hd / 4); x += THREADS)
    cp16(kc + 4 * x, a.wk + ((size_t)b * Tk + t0) * Hd + 4 * x, true);
  cp_async_commit();
  for (int i = threadIdx.x; i < n; i += THREADS) at[i] = attn[t0 + i];
  cp_async_wait<0>();
  __syncthreads();
  float* DATT = a.ws + L.DATT + (size_t)b * Tk;
  for (int i = warp; i < n; i += WARPS) {
    float s = 0.f;
    for (int d = lane; d < Ha2; d += 32) s = fmaf(dctx[d], vc[i * Ha2 + d], s);
    s = warp_sum(s);
    if (lane == 0) {
      da[i] = s;
      DATT[t0 + i] = s;
    }
  }
  __syncthreads();
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += THREADS) s = fmaf(at[i], da[i], s);
  s = block_sum(s, red32);
  float* p1 = a.ws + L.AP1 + ((size_t)b * nc + c) * Hd;
  float* p2 = a.ws + L.AP2 + ((size_t)b * nc + c) * Hd;
  for (int h = threadIdx.x; h < Hd; h += THREADS) {
    float x1 = 0.f, x2 = 0.f;
    for (int i = 0; i < n; ++i) {
      const float w = kc[i * Hd + h];
      x1 = fmaf(at[i] * da[i], w, x1);
      x2 = fmaf(at[i], w, x2);
    }
    p1[h] = x1;
    p2[h] = x2;
  }
  if (threadIdx.x == 0) a.ws[L.AS + (size_t)b * nc + c] = s;
  int* cnt = reinterpret_cast<int*>(a.ws + L.CNT);
  if (!last_of_row(cnt, b, nc)) return;
  float S_ = 0.f;
  for (int cc = 0; cc < nc; ++cc) S_ += __ldcg(a.ws + L.AS + (size_t)b * nc + cc);
  float* dsc = a.dsc + ((size_t)t * B + b) * Tk;
  for (int tt = threadIdx.x; tt < Tk; tt += THREADS)
    dsc[tt] = attn[tt] * (__ldcg(DATT + tt) - S_);
  const float* P1 = a.ws + L.AP1 + (size_t)b * nc * Hd;
  const float* P2 = a.ws + L.AP2 + (size_t)b * nc * Hd;
  const float* m2 = a.m_lstm ? a.m_lstm + (((size_t)t * 3 + 2) * B + b) * Hd : nullptr;
  for (int u = threadIdx.x; u < Hd; u += THREADS) {
    float dq = 0.f;
#pragma unroll 8
    for (int cc = 0; cc < nc; ++cc)
      dq += __ldcg(P1 + (size_t)cc * Hd + u) - S_ * __ldcg(P2 + (size_t)cc * Hd + u);
    dq += __ldcg(a.ws + L.DFFQ + (size_t)b * Hd + u);
    tf_cell_bwd(a, L, 2, t, b, u, m2 ? dq * m2[u] : dq, first);
  }
  if (threadIdx.x == 0) cnt[b] = 0;
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 2) tf_bwd_kernel(const TfBwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float red32[32];
  cg::grid_group grid = cg::this_grid();
  stamp();
  bare_barriers(grid);
  const Lay L = lay(K_TF_BWD, a.B, a.Tk, a.Hd, a.Hs, a.Ha2, 0, 3, a.nc);
  const int* off = reinterpret_cast<const int*>(a.tiles);
  const int4* tb = a.tiles + 2;
  const int B = a.B, S = a.S, Hd = a.Hd, Hs = a.Hs, Ha2 = a.Ha2, G = 4 * Hd;
  const float* dummy = a.ws;
  {
    const int gt = blockIdx.x * THREADS + threadIdx.x, gn = gridDim.x * THREADS;
    int* cnt = reinterpret_cast<int*>(a.ws + L.CNT);
    for (int i = gt; i < B; i += gn) cnt[i] = 0;
    // the last step's dcell is its head cotangent alone
    const size_t last = (size_t)(S - 1) * B * Hs;
    for (size_t i = gt; i < (size_t)B * Hs; i += gn) a.dcell[last + i] = a.g_cell[last + i];
  }
  // the products of reverse step t: dcell_t @ W_ffn^T -> [dctx (masked) ; dffq], and
  // dPre_l @ W_l^T for layers 2, 1, 0
  const auto ffn_t = [&](int t) {
    const Narrow p = {a.w_ffn, Hs, Hs, Ha2 + Hd,
                      {nullptr, nullptr, (t == S - 1 ? a.g_cell : a.dcell) + (size_t)t * B * Hs,
                       nullptr, 0, Hs, 0, 0, Hs}};
    return p;
  };
  const auto lstm_t = [&](int l, int t) {
    const Narrow p = {l == 2 ? a.w2 : l == 1 ? a.w1 : a.w0, G, G, l ? 2 * Hd : Hs + Hd,
                      {nullptr, nullptr, a.dpre + ((size_t)l * S + t) * B * G, nullptr, 0, G, 0,
                       0, G}};
    return p;
  };
  for (int t = S - 1; t >= 0; --t) {
    const bool first = t == S - 1;
    const float* mask = a.m_lstm ? a.m_lstm + (size_t)t * 3 * B * Hd : nullptr;
    const Narrow n1 = ffn_t(t);
    for (int i = off[I_FFN_T] + blockIdx.x; i < off[I_FFN_T + 1]; i += gridDim.x) {
      const int4 it = tb[i];
      narrow_item<true>(n1, it.x, it.y, B, sm, dummy);
      if (threadIdx.x < BM * NJ) {
        const int b = it.x + threadIdx.x / NJ, k = it.y + threadIdx.x % NJ;
        const float v = sm[DEPTH * STAGE + RED + threadIdx.x];
        if (b < B && k < Ha2) {
          const size_t e = ((size_t)t * B + b) * Ha2 + k;
          a.dctx[e] = a.m_ctx ? v * a.m_ctx[e] : v;
        } else if (b < B && k < Ha2 + Hd) {
          a.ws[L.DFFQ + (size_t)b * Hd + k - Ha2] = v;
        }
      }
      __syncthreads();
    }
    barrier(grid);  // dctx and dffq complete
    for (int i = off[I_ATT] + blockIdx.x; i < off[I_ATT + 1]; i += gridDim.x)
      att_bwd_item(a, tb[i], L, t, first, sm, red32);
    barrier(grid);  // dsc, dpre[2, t] complete
    // layers 2 and 1: dPre_l @ W_l^T; its input columns feed layer l - 1's cell backward
    for (int l = 2; l >= 1; --l) {
      const Narrow nl = lstm_t(l, t);
      float* DY1 = a.ws + L.DY1;
      for (int i = off[I_LSTM_T] + blockIdx.x; i < off[I_LSTM_T + 1]; i += gridDim.x) {
        const int4 it = tb[i];
        narrow_item<true>(nl, it.x, it.y, B, sm, dummy);
        if (threadIdx.x < BM * NJ) {
          const int b = it.x + threadIdx.x / NJ, k = it.y + threadIdx.x % NJ;
          const float v = sm[DEPTH * STAGE + RED + threadIdx.x];
          if (b < B && k < Hd) {
            const size_t e = (size_t)b * Hd + k;
            if (l == 2) {  // layer 1's output cotangent, and its cell backward
              const float go = mask ? v * mask[(size_t)B * Hd + e] : v;
              DY1[e] = go;
              tf_cell_bwd(a, L, 1, t, b, k, go, first);
            } else {  // layer 0's: the residual's dy1 plus layer 1's input cotangent
              const float go = DY1[e] + v;
              tf_cell_bwd(a, L, 0, t, b, k, mask ? go * mask[e] : go, first);
            }
          } else if (b < B && k < 2 * Hd) {
            a.ws[L.DH + ((size_t)l * B + b) * Hd + k - Hd] = v;
          }
        }
        __syncthreads();
      }
      if (t > 0 || l == 2) barrier(grid);  // dpre[l - 1, t] and dh_l complete
    }
    if (t == 0) break;
    // layer 0: dPre_0 @ W_0^T + gc[t]: the cotangent of cell_{t-1}, and dh_0
    const Narrow n0 = lstm_t(0, t);
    for (int i = off[I_L0_T] + blockIdx.x; i < off[I_L0_T + 1]; i += gridDim.x) {
      const int4 it = tb[i];
      narrow_item<true>(n0, it.x, it.y, B, sm, dummy);
      if (threadIdx.x < BM * NJ) {
        const int b = it.x + threadIdx.x / NJ, k = it.y + threadIdx.x % NJ;
        const float v = sm[DEPTH * STAGE + RED + threadIdx.x];
        if (b < B && k < Hs) {
          const size_t e = ((size_t)(t - 1) * B + b) * Hs + k;
          a.dcell[e] = v + a.g_cell[e];
        } else if (b < B && k < Hs + Hd) {
          a.ws[L.DH + (size_t)b * Hd + k - Hs] = v;
        }
      }
      __syncthreads();
    }
    barrier(grid);  // dcell_{t-1} and dh_0 complete
  }
}

// The shapes the kernels take: widths of 16-byte weight rows and chunks,
// the attention's chunks within its bound, and the workspace and shared
// memory the plan gave.
bool shapes_ok(int kind, int B, int Tk, int Hd, int Hs, int Ha2, int E, int V, int nl, int nc,
               int tc, int ws_floats, int smem) {
  if (B < 1 || Tk < 1 || Hd < 4 || Hs < 8 || Ha2 < 4 || nl < 1 || V < (kind == K_GREEDY))
    return false;
  if (Hd % 4 || Hs % 8 || Ha2 % 4 || E % 4 || E < 0) return false;
  if (tc != TC || nc != cdiv(Tk, TC)) return false;
  if ((size_t)ws_floats < lay(kind, B, Tk, Hd, Hs, Ha2, V, nl, nc).total) return false;
  return smem >= smem_floats(kind, Hd, Ha2, nc) * (int)sizeof(float);
}

}  // namespace

// K2: the free-running decode of n steps (ops/las_flash.py
// las_greedy_flash). table [V_in, E]; sym0 [B] int64; refs [B, n] int32 or
// null; w_lstm the nl packed [W_ih ; W_hh] stacked ([E + Hs + Hd, 4Hd],
// then [2Hd, 4Hd] each), b_lstm [nl, 4Hd] (b_ih + b_hh); w_ffn [Ha2 + Hd,
// Hs]; w_out [Hs, V], b_out [V]; wk [B, Tk, Hd], val [B, Tk, Ha2]; lens
// [B] int64. Out: embs [B, n, Hs], preds [B, n] int64, picked [B, n].
// tiles, smem: the plan's item table (on the card) and shared bytes; nc,
// tc its key chunks a row and keys a chunk; grid: blocks (0: all the card
// keeps).
extern "C" int las_greedy_fused(const float* table, const long long* sym0, const int* refs,
                                const float* w_lstm, const float* b_lstm, const float* w_ffn,
                                const float* w_out, const float* b_out, const float* wk,
                                const float* val, const long long* lens, float* embs,
                                long long* preds, float* picked, float* ws, const int* tiles,
                                int ws_floats, int B, int Tk, int E, int Hd, int Hs, int Ha2,
                                int V, int nl, int n, int nc, int tc, int smem, int grid,
                                cudaStream_t stream) {
  if (n < 1 || !shapes_ok(K_GREEDY, B, Tk, Hd, Hs, Ha2, E, V, nl, nc, tc, ws_floats, smem))
    return (int)cudaErrorInvalidValue;
  const GreedyArgs a = {table, w_lstm, b_lstm, w_ffn, w_out, b_out, wk, val, sym0, lens, refs,
                        embs, picked, preds, ws, (const int4*)tiles, B, Tk, E, Hd, Hs, Ha2, V,
                        nl, n, nc};
  return launch_coop(greedy_kernel, a, THREADS, smem, grid, stream);
}

// K9 forward over S steps (ops/las_tf_flash.py las_tf_fwd): w0, w1, w2 the
// packed [x ; h] weights ([Hs + Hd, 4Hd], [2Hd, 4Hd]), b1, b2 [4Hd]; w_ffn
// [Ha2 + Hd, Hs]; pre0 [S, B, 4Hd]; wk, val, lens as K2's; m_lstm [S, 3,
// B, Hd] and m_ctx [S, B, Ha2], or null. Out: the streams x0 [S + 1, B, Hs
// + Hd], x1, x2 [S + 1, B, 2Hd], ff [S, B, Ha2 + Hd], c [3, S + 1, B, Hd],
// g [3, S, B, 4Hd], attn [S, B, Tk], every element written.
extern "C" int las_tf_fwd_fused(const float* w0, const float* w1, const float* w2,
                                const float* b1, const float* b2, const float* w_ffn,
                                const float* pre0, const float* wk, const float* val,
                                const long long* lens, const float* m_lstm, const float* m_ctx,
                                float* x0, float* x1, float* x2, float* ff, float* c, float* g,
                                float* attn, float* ws, const int* tiles, int ws_floats, int S,
                                int B, int Tk, int Hd, int Hs, int Ha2, int nc, int tc, int smem,
                                int grid, cudaStream_t stream) {
  if (S < 1 || !shapes_ok(K_TF_FWD, B, Tk, Hd, Hs, Ha2, 0, 0, 3, nc, tc, ws_floats, smem))
    return (int)cudaErrorInvalidValue;
  const TfFwdArgs a = {w0, w1, w2, b1, b2, w_ffn, pre0, wk, val, m_lstm, m_ctx, lens, x0, x1,
                       x2, ff, c, g, attn, ws, (const int4*)tiles, S, B, Tk, Hd, Hs, Ha2, nc};
  return launch_coop(tf_fwd_kernel, a, THREADS, smem, grid, stream);
}

// K9 backward (ops/las_tf_flash.py las_tf_bwd) from the head cotangent
// g_cell [S, B, Hs]: w0, w1, w2 the [x ; h] weights unpacked; the forward's
// saved g, c, attn; wk, val; the masks or null. Out: dpre [3, S, B, 4Hd],
// dsc [S, B, Tk], dctx [S, B, Ha2], dcell [S, B, Hs], every element
// written.
extern "C" int las_tf_bwd_fused(const float* w0, const float* w1, const float* w2,
                                const float* w_ffn, const float* g, const float* c,
                                const float* attn, const float* wk, const float* val,
                                const float* m_lstm, const float* m_ctx, const float* g_cell,
                                float* dpre, float* dsc, float* dctx, float* dcell, float* ws,
                                const int* tiles, int ws_floats, int S, int B, int Tk, int Hd,
                                int Hs, int Ha2, int nc, int tc, int smem, int grid,
                                cudaStream_t stream) {
  if (S < 1 || !shapes_ok(K_TF_BWD, B, Tk, Hd, Hs, Ha2, 0, 0, 3, nc, tc, ws_floats, smem))
    return (int)cudaErrorInvalidValue;
  const TfBwdArgs a = {w0, w1, w2, w_ffn, g, c, attn, wk, val, m_lstm, m_ctx, g_cell,
                       dpre, dsc, dctx, dcell, ws, (const int4*)tiles, S, B, Tk, Hd, Hs, Ha2,
                       nc};
  return launch_coop(tf_bwd_kernel, a, THREADS, smem, grid, stream);
}

// What a launch would be: out[0] the blocks an SM keeps resident, out[1]
// the SM count, for K2 (kind 0), K9 forward (1) or backward (2) at smem
// bytes.
extern "C" int las_fused_grid(int kind, int smem, int* out, cudaStream_t stream) {
  if (kind == K_GREEDY) return resident(greedy_kernel, THREADS, smem, out, out + 1);
  if (kind == K_TF_FWD) return resident(tf_fwd_kernel, THREADS, smem, out, out + 1);
  return resident(tf_bwd_kernel, THREADS, smem, out, out + 1);
}

// The timer buffers of a library built with -DSTJEP_FUSED_STAMPS (unsigned
// 64-bit, zeroed by the caller; null stops the reads): buf 2 + 4 +
// barriers entries, items (or null) 1 + 2 per item stamp of block 0.
// Without the define: cudaErrorNotSupported.
extern "C" int las_fused_stamps(unsigned long long* buf, unsigned long long* items,
                                cudaStream_t stream) {
#ifdef STJEP_FUSED_STAMPS
  const cudaError_t e = cudaMemcpyToSymbol(g_stamps, &buf, sizeof(buf));
  return (int)(e ? e : cudaMemcpyToSymbol(g_items, &items, sizeof(items)));
#else
  return (int)cudaErrorNotSupported;
#endif
}
