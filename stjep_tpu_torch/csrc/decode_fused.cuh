// The fused decode kernels' shared machinery: K5, K4, K3, K6a-c and K7c as
// cooperative persistent kernels, one launch per decoder layer and
// position (K5, `decoder_layer_fused`), one launch per beam position (K4,
// `decode_beam_fused`), one launch per decode position through every layer
// and the head (K3, `decode_chain_fused`), and one launch per shard call
// of the tensor-parallel self-attention, cross-attention and FFN steps (K6a
// `self_attn_step_fused`, K6b `cross_attn_step_fused`, K6c
// `ffn_step_fused`) and of a vocabulary shard of the head (K7c
// `head_partial_fused`). K5, K4 and K6a-c are in decode_fused.cu, K3 and
// K7c in decode_chain.cu: two translation units, each including this
// header, because in one unit the K3 and K7c kernels changed K4's compiled
// code (its static shared memory and register allocation) and cost it
// ~4.5 % on an H100 (PERF.md section 6).
//
// They replace stjep_tpu/ops/decode_flash.py `decoder_layer_step_flash` :759
// (bodies `_layer_kernel` :737 and `_layer_kernel_q8` :708: `_self_core`
// :144, `_cross_core` :431, `_ffn_core` :599), `decode_beam_step_flash`
// :1412 (body `_beam_step_kernel` :1238), `decode_chain_step_flash` :1078
// (its `pallas_call` :1168, body `_chain_kernel` :1024), `self_attn_step`
// :348 (:407, body `_self_core`), `cross_attn_step` :543 (:577,
// `_cross_core`), `ffn_step` :622 (:630, `_ffn_core`) and
// `decode_head_partial` :1666 (:1704, `_head_kernel`'s partial branch). On
// the TPU each was one launch; the port ran them as chains of ~21, ~145,
// ~10, 6, 4, 3 and 4 small launches (LayerNorms, split-K GEMMs and their
// reductions, the attention kernels, the head and the select), and launch
// and issue latency, not the work, set their time.
//
// Design. Every block of the grid stays resident for the whole call
// (cudaLaunchCooperativeKernel; as many blocks as the card keeps resident,
// asked once and cached; K6a-c as many as below) and walks through the
// phases of the step, which
// cooperative_groups' grid barrier separates. A layer is 11 phases:
//   QKV   one product phase of three jobs: Q from LN1(x), K and V from x;
//   self  self-attention per (row, head), a warp each, through the ancestry
//         map, the new K/V row written into the row's own slot at `pos`
//         (attend.cuh);
//   fc    the output projection;
//   row   x1 = fc + x, and LN2(x1);
//   cq    the cross query;   cross  cross-attention per (row, head), a warp each;
//   co    its projection;    row    x2 = co + x1, and LN3(x2);
//   w1    the FFN's first product;
//   w2    relu(w1 + b1) @ w2, the ReLU applied as the operand is loaded;
//   row   x3 = w2 + b2 + x2, and the next layer's LN1 (or the head's LN).
// K5 adds a first row phase (LN1 of its input) and ends on its last row
// phase: 11 barriers. K4 adds the embedding row phase (token embedding plus time signal,
// anc[pos] set in place), runs the stacked layers by layer stride (no host
// slicing), then the head's product, a phase of each row's log-softmax
// top-K and one of beam_select's k^2 -> k update per batch item
// (head_select.cuh): 3 + 11 * nl barriers. K3 is K4 without the embedding
// and the select: a row phase copies its input (embedded by the caller,
// which also sets anc[pos]) and takes LN1 of it, the stacked layers, the
// head's product, and a phase of each row's top-K (with the log-prob at a
// gather id for greedy dev eval): 2 + 11 * nl barriers.
//
// Shard width. Under tensor parallelism a shard of n holds Dq = D/n of the
// attention width (Q, K, V [D, Dq], fc [Dq, D], caches [K, B, Lpad, Dq],
// nh/n heads of the unsharded width d) and FF/n of the FFN's hidden width.
// `Ctx` carries Dq and the hidden width FF; K5 and K4 are the case Dq = D
// with the whole FF. K6a is a layer's phases from its LayerNorm to the fc
// product, then a row phase that sums the fc partials (plus x with
// `residual`): row, qkv, self, fc, row, 4 barriers. K6b likewise with the
// cross attention: row, cq, cross, co, row, 4 barriers. K6c is row
// (LayerNorm), w1, w2 (b_1 and the ReLU applied as w2 loads its operand),
// row (the partials, plus b_2 and x unless partial_tp): 3 barriers. K7c is
// row (LayerNorm, eps 1e-5), the head's product over the shard's [D, V/n],
// then a row phase of each row's raw top-K, row max and sum-exp: 2
// barriers. At a shard's width a phase has few items (80 tiles a product
// of K6c at n = 4 and B*K = 80; 40 tiles K7c's at V/n = 50), so these
// launch as many blocks as their largest phase has items, at most what the
// card keeps resident; a grid barrier costs ~1.3 us at 264 blocks and less
// at fewer.
//
// Products. Each product phase walks a fixed list of tiles, the plan's tile
// table (ops/decode_flash.py `fused_tiles`, passed in as `tiles`): 16 rows
// x 128 columns x KC (64) of the contraction, the weight tile copied into
// shared memory with cp.async (16 bytes a copy; f32 or int8) and the next
// tile's copy in flight while this one multiplies. A block issues its first
// tile's weight copy of the NEXT product phase before it waits at the
// barrier: the weights do not depend on the activations, so the wait hides
// the fetch. K6a and K6c do the same; K6b issues its copies right after
// the barrier, the faster placement for it on an H100 (PERF.md section 6:
// 33.6 against 38.4 us at a shard of 4). Each tile writes its
// partial sum over its KC slice; the consuming phase sums the partials in
// split order 0, 1, ... (`psum`), then adds bias and residual. No atomics
// on values, and the table follows from the shapes alone, so the result
// does not depend on the grid size. int8 weights are dequantized as read
// from shared memory, float(q) * s[col], the value of JAX's `dq`, in the
// f32 route's order: on weights that sit on the int8 grid the two routes
// give bit-identical outputs.
//
// What bounds it on the H100: at B*K = 80 rows a layer streams 2.6 M weight
// entries (10.5 MB f32, 2.6 MB int8) and does 2 * 80 * 2.6 M = 420 MFLOP of
// products, 6.3 us at the 67 TFLOP/s of the CUDA cores; its self-cache reads
// grow with the position. No tensor cores: the f32 route must match the
// f32 reference (TF32 keeps ~3 digits), and at M = 80 a product does ~40
// FLOP per weight byte, within ~2x of the byte bound on CUDA cores, so
// wgmma would buy at most that factor. The floor of a call is then its 11
// (K5), 69 (K4) or 68 (K3) grid barriers plus the bytes; K3's gather
// variant at dev eval's 16 rows moves the same weights for a fifth of the
// products. A shard step of 4 moves far less (scripts/tp_bounds.py, B*K =
// 80, position 75): K6a up to 7.7 MB, mostly cache rows, 2.3 us at HBM
// speed; K6c 1.4 MB and 42 MFLOP, 0.6 us; K7c 0.1 MB at V/n = 50; so their
// 2-4 barriers and the launch set their floor.
//
// Nothing falls back: a grid the card cannot hold, too little shared
// memory or workspace, or a refused launch returns the CUDA error, and the
// wrapper raises. A block stages one attention item a warp, 8 x (d + 3n)
// floats at n = max(Lpad, Lk): with d = 64 K5 and K4 take n up to ~2400
// within the 227 KB a block may opt in to. K6a runs its attention on as
// many of a block's 8 warps as the shared memory it is given stages
// (`aw`), so it takes caches up to ~19 000 rows at d = 64, and K6b memories
// as long.

#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "attend.cuh"
#include "head_select.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int BM = 16;   // rows of a product tile
constexpr int BN = 128;  // columns of a product tile
constexpr int KC = 64;   // contraction depth of a product tile: one split of Kd

// A layer's weights: the six LayerNorm vectors and the FFN biases, the
// eight streamed matrices [Kd, N] (f32 or int8) and their column scales
// (null for f32). Stacked K4 weights: layer 0's pointers, layer l at its
// stride (layer_at).
enum { LN1G, LN1B, LN2G, LN2B, LN3G, LN3B, B1, B2 };
enum { WQ, WK, WV, WO, WCQ, WCO, W1, W2 };
struct LayerW {
  const float* v[8];
  const void* w[8];
  const float* s[8];
};

__device__ LayerW layer_at(const LayerW& L, int l, int D, int FF, int wbytes) {
  LayerW o = L;
  for (int j = 0; j < 8; ++j) o.v[j] = L.v[j] + (size_t)l * (j == B1 ? FF : D);
  for (int j = 0; j < 8; ++j) {
    const size_t n = (j == W1 || j == W2) ? (size_t)D * FF : (size_t)D * D;
    o.w[j] = (const char*)L.w[j] + (size_t)l * n * wbytes;
    if (L.s[j]) o.s[j] = L.s[j] + (size_t)l * (j == W1 ? FF : D);
  }
  return o;
}

// The call's shapes and buffers. D is the model width, Dq the attention
// width (Q, K, V, the caches and memory K/V; D but on a head shard), FF the
// hidden width (FF / n on a hidden shard), nh the heads of width d over Dq,
// aw the warps a block runs attention items on. Workspace (f32): X0, X1,
// X2, XN (a row LayerNorm's output), ATT (an attention's context, [BK, Dq]),
// each [BK, D]; PA and PB hold product partials [splits, BK, N]; LG the
// head's logits [BK, V]; SCK, IDK its top-K [BK, K]. tiles: the plan's tile
// table (`phase`). Dq and aw come last: placed among the others, the
// compiler's register allocation left K4 ~0.7 % slower on an H100 (1211-
// 1214 against 1204-1206 us) and K6a 8 us faster; K4 runs every position
// of the standard beam, and K6a's device time hides behind its host cost.
struct Ctx {
  int BK, K, D, FF, nh, d, Lpad, Lk, pos, Dq, aw;
  float *X0, *X1, *X2, *XN, *ATT, *PA, *PB, *LG, *SCK;
  int* IDK;
  const int *anc, *maskk, *memmask;
  const int4* tiles;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Floats of PA (q/k/v, w1 or the head's partials) and PB (fc, cq, co or
// w2's partials) for a call.
__host__ __device__ inline size_t pa_floats(int BK, int D, int Dq, int FF, int V) {
  const size_t sd = cdiv(D, KC), bk = BK;
  size_t pa = 3 * sd * bk * Dq;
  if (sd * bk * FF > pa) pa = sd * bk * FF;
  if (sd * bk * V > pa) pa = sd * bk * V;
  return pa;
}
__host__ __device__ inline size_t pb_floats(int BK, int D, int Dq, int FF) {
  const size_t sq = cdiv(Dq, KC), sf = cdiv(FF, KC), cq = (size_t)cdiv(D, KC) * Dq;
  const size_t pb = (sq > sf ? sq : sf) * D;
  return (pb > cq ? pb : cq) * BK;
}

// Workspace floats for a call (decode_flash.py fused_plan mirrors it).
__host__ __device__ inline size_t ws_need(int BK, int K, int D, int Dq, int FF, int V) {
  const size_t bk = BK;
  return 5 * bk * D + pa_floats(BK, D, Dq, FF, V) + pb_floats(BK, D, Dq, FF) + bk * V +
         2 * bk * K;
}

// The context of a call: its shapes and its workspace's regions. The
// caller sets nh, d, aw, Lpad, Lk, pos, the index arrays and the tiles.
__host__ __device__ inline Ctx make_ctx(float* ws, int BK, int K, int D, int Dq, int FF,
                                        int V) {
  Ctx c = {};
  const size_t bk = BK;
  c.BK = BK;
  c.K = K;
  c.D = D;
  c.Dq = Dq;
  c.FF = FF;
  c.X0 = ws;
  c.X1 = c.X0 + bk * D;
  c.X2 = c.X1 + bk * D;
  c.XN = c.X2 + bk * D;
  c.ATT = c.XN + bk * D;
  c.PA = c.ATT + bk * D;
  c.PB = c.PA + pa_floats(BK, D, Dq, FF, V);
  c.LG = c.PB + pb_floats(BK, D, Dq, FF);
  c.SCK = c.LG + bk * V;
  c.IDK = (int*)(c.SCK + bk * K);
  return c;
}

// sum_s P[s, r, c] over the S splits of a [S, M, N] partial, in split
// order; eight loads in flight before their adds.
__device__ __forceinline__ float psum(const float* P, int S, int M, int N, int r, int c) {
  const size_t step = (size_t)M * N;
  const float* p = P + (size_t)r * N + c;
  float v = 0.f;
  for (int s0 = 0; s0 < S; s0 += 8) {
    float x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = s0 + j < S ? p[(s0 + j) * step] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) if (s0 + j < S) v += x[j];
  }
  return v;
}

#ifdef STJEP_FUSED_STAMPS
// Built with -DSTJEP_FUSED_STAMPS (scripts/fused_phase_split.py): block 0
// records the global timer (ns) at a launch's start and after each grid
// barrier into the buffer `decode_fused_stamps` set, at [1 + n] with n
// counted in [0].
__device__ unsigned long long* g_stamps;
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
__device__ __forceinline__ void barrier(cg::grid_group& grid) {
  grid.sync();
  stamp();
}

// One product: P[s] = A[:, KC-slice s] @ W[KC-slice s, :] for a [Kd, N]
// weight of type WT (f32, or int8 with column scales S). A is [M, Kd]; with
// SA > 0 it is a partial [SA, M, Kd] and the operand is relu(psum + abias).
struct Job {
  const float* A;
  const float* abias;
  int SA;
  const void* W;
  const float* S;
  float* P;
  int N, Kd;
};

// A product phase: its jobs and its run of the plan's tile table, each tile
// an int4 (job, split, first row, first column). Tile i goes to block
// i % gridDim.x. The table starts with N_KINDS + 1 int offsets (two int4s):
// the first tile of each product kind, in this order, and the end.
enum { P_QKV, P_FC, P_CQ, P_CO, P_W1, P_W2, P_HEAD, N_KINDS };
struct Phase {
  const Job* js;
  const int4* t;
  int n;
};
__device__ __forceinline__ Phase phase(const Ctx& c, int kind, const Job* js) {
  const int* off = (const int*)c.tiles;
  return {js, c.tiles + 2 + off[kind], off[kind + 1] - off[kind]};
}

__device__ __forceinline__ int stage_bytes(int wbytes) {
  return KC * BN * wbytes + KC * BM * (int)sizeof(float);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4z(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// Start the copy of tile tl's weight slice [KC, BN] into stage buffer wb,
// zero past the weight's edges. 16-byte copies where the rows allow them
// (N % 4 == 0 for f32, N % 16 == 0 for int8, which the host requires).
template <typename WT>
__device__ void issue_w(const Job& j, int4 tl, WT* wb) {
  const int k0 = tl.y * KC, c0 = tl.w;
  const WT* W = (const WT*)j.W;
  constexpr int PER = 16 / sizeof(WT);  // elements a 16-byte copy moves
  if (j.N % PER == 0) {
    for (int e = threadIdx.x; e < KC * (BN / PER); e += THREADS) {
      const int k = e / (BN / PER), c = (e % (BN / PER)) * PER;
      const int gk = k0 + k, gc = c0 + c;
      const bool ok = gk < j.Kd && gc < j.N;
      cp_async16(wb + k * BN + c, ok ? W + (size_t)gk * j.N + gc : W, ok);
    }
  } else if constexpr (sizeof(WT) == 4) {  // f32 rows not 16-byte aligned (a head of odd width)
    for (int e = threadIdx.x; e < KC * BN; e += THREADS) {
      const int k = e / BN, c = e % BN;
      const int gk = k0 + k, gc = c0 + c;
      const bool ok = gk < j.Kd && gc < j.N;
      cp_async4z(wb + k * BN + c, ok ? W + (size_t)gk * j.N + gc : W, ok);
    }
  }
}

// The operand tile [BM, KC] of tile tl, transposed into as[k * BM + m].
__device__ void load_a(const Job& j, int4 tl, int M, float* as) {
  const int k0 = tl.y * KC;
  for (int e = threadIdx.x; e < BM * KC; e += THREADS) {
    const int k = e % KC, m = e / KC;
    const int gm = tl.z + m, gk = k0 + k;
    float v = 0.f;
    if (gm < M && gk < j.Kd) {
      if (j.SA) {
        v = psum(j.A, j.SA, M, j.Kd, gm, gk) + j.abias[gk];
        v = fmaxf(v, 0.f);
      } else {
        v = j.A[(size_t)gm * j.Kd + gk];
      }
    }
    as[k * BM + m] = v;
  }
}

// Four weights of the thread's columns at row k of the stage buffer, as f32.
__device__ __forceinline__ float4 wrow(const float* wb, int k, int tx, const float4&) {
  return reinterpret_cast<const float4*>(wb)[k * (BN / 4) + tx];
}
__device__ __forceinline__ float4 wrow(const int8_t* wb, int k, int tx, const float4& s) {
  const char4 q = reinterpret_cast<const char4*>(wb)[k * (BN / 4) + tx];
  return make_float4((float)q.x * s.x, (float)q.y * s.y, (float)q.z * s.z, (float)q.w * s.w);
}

// Multiply tile tl from the stage buffers and store its partial: thread
// (ty, tx) owns rows ty and ty + 8 and columns 4tx .. 4tx + 3, summing over
// k in order.
template <typename WT>
__device__ void mma_tile(const Job& j, int4 tl, int M, const WT* wb, const float* as) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = tl.w + 4 * tx;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (j.S) {
    s.x = c < j.N ? j.S[c] : 0.f;
    s.y = c + 1 < j.N ? j.S[c + 1] : 0.f;
    s.z = c + 2 < j.N ? j.S[c + 2] : 0.f;
    s.w = c + 3 < j.N ? j.S[c + 3] : 0.f;
  }
  float acc[2][4] = {};
#pragma unroll 4
  for (int k = 0; k < KC; ++k) {
    const float4 w = wrow(wb, k, tx, s);
    const float a0 = as[k * BM + ty], a1 = as[k * BM + ty + 8];
    acc[0][0] = fmaf(a0, w.x, acc[0][0]);
    acc[0][1] = fmaf(a0, w.y, acc[0][1]);
    acc[0][2] = fmaf(a0, w.z, acc[0][2]);
    acc[0][3] = fmaf(a0, w.w, acc[0][3]);
    acc[1][0] = fmaf(a1, w.x, acc[1][0]);
    acc[1][1] = fmaf(a1, w.y, acc[1][1]);
    acc[1][2] = fmaf(a1, w.z, acc[1][2]);
    acc[1][3] = fmaf(a1, w.w, acc[1][3]);
  }
  for (int i = 0; i < 2; ++i) {
    const int r = tl.z + ty + 8 * i;
    if (r >= M) continue;
    float* p = j.P + ((size_t)tl.y * M + r) * j.N;
    for (int q = 0; q < 4; ++q)
      if (c + q < j.N) p[c + q] = acc[i][q];
  }
}

template <typename WT>
__device__ void issue_tile(const Phase& p, int t, char* smem, int buf) {
  const int4 tl = p.t[t];
  issue_w<WT>(p.js[tl.x], tl, (WT*)(smem + buf * stage_bytes(sizeof(WT))));
  cp_async_commit();
}

// Before the barrier that opens a product phase: this block's first tile's
// weight copy, into stage buffer 0.
template <typename WT>
__device__ void prefetch(const Phase& p, char* smem) {
  if ((int)blockIdx.x < p.n) issue_tile<WT>(p, blockIdx.x, smem, 0);
}

// A product phase whose first weight copy `prefetch` has issued: tiles
// blockIdx.x, + gridDim.x, ...; tile i's copy lands in buffer i % 2 while
// tile i - 1 multiplies.
template <typename WT>
__device__ void product_phase(const Phase& p, int M, char* smem) {
  const int sb = stage_bytes(sizeof(WT));
  int it = 0;
  for (int t = blockIdx.x; t < p.n; t += gridDim.x, ++it) {
    const int buf = it & 1;
    const bool more = t + (int)gridDim.x < p.n;
    if (more) issue_tile<WT>(p, t + gridDim.x, smem, buf ^ 1);
    const int4 tl = p.t[t];
    const Job& j = p.js[tl.x];
    float* as = (float*)(smem + buf * sb + KC * BN * sizeof(WT));
    load_a(j, tl, M, as);
    if (more)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    mma_tile<WT>(j, tl, M, (const WT*)(smem + buf * sb), as);
    __syncthreads();
  }
}

// Row phase, one block per row: x = psum(P) + bias + res (res alone with
// S = 0; bias where given; res always with ALWAYS_RES, else where given:
// K5 and K4 always add it, and a test of res in this loop slowed K5 by ~4
// %), stored to xout where given; then LayerNorm(x) (g, b, eps) to XN
// where g is given, as ops/transformer.py layer_norm computes it. A thread
// keeps its columns of x in registers (D <= ROW_COLS * THREADS).
constexpr int ROW_COLS = 4;
template <bool ALWAYS_RES = true>
__device__ void row_phase(const Ctx& c, const float* P, int S, const float* bias,
                          const float* res, float* xout, const float* g,
                          const float* b, float eps, float* red) {
  const int D = c.D;
  for (int r = blockIdx.x; r < c.BK; r += gridDim.x) {
    float x[ROW_COLS];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < ROW_COLS; ++j) {
      const int k = threadIdx.x + j * THREADS;
      x[j] = 0.f;
      if (k >= D) continue;
      float v = S ? psum(P, S, c.BK, D, r, k) : 0.f;
      if (bias) v += bias[k];
      if (ALWAYS_RES || res) v += res[(size_t)r * D + k];
      if (xout) xout[(size_t)r * D + k] = v;
      x[j] = v;
      sum += v;
    }
    if (!g) continue;
    const float mean = block_sum(sum, red) / (float)D;
    float var = 0.f;
#pragma unroll
    for (int j = 0; j < ROW_COLS; ++j)
      if (threadIdx.x + j * THREADS < D) var += (x[j] - mean) * (x[j] - mean);
    const float inv = 1.f / sqrtf(block_sum(var, red) / (float)D + eps);
#pragma unroll
    for (int j = 0; j < ROW_COLS; ++j) {
      const int k = threadIdx.x + j * THREADS;
      if (k < D) c.XN[(size_t)r * D + k] = (x[j] - mean) * inv * g[k] + b[k];
    }
  }
}

// The phases' jobs for layer L with input xin.
struct LayerJobs {
  Job qkv[3], fc, cq, co, w1, w2;
};
__device__ LayerJobs layer_jobs(const Ctx& c, const LayerW& L, const float* xin) {
  const int D = c.D, Dq = c.Dq, FF = c.FF;
  const size_t part = (size_t)cdiv(D, KC) * c.BK * Dq;
  LayerJobs J;
  J.qkv[0] = {c.XN, nullptr, 0, L.w[WQ], L.s[WQ], c.PA, Dq, D};
  J.qkv[1] = {xin, nullptr, 0, L.w[WK], L.s[WK], c.PA + part, Dq, D};
  J.qkv[2] = {xin, nullptr, 0, L.w[WV], L.s[WV], c.PA + 2 * part, Dq, D};
  J.fc = {c.ATT, nullptr, 0, L.w[WO], L.s[WO], c.PB, D, Dq};
  J.cq = {c.XN, nullptr, 0, L.w[WCQ], L.s[WCQ], c.PB, Dq, D};
  J.co = {c.ATT, nullptr, 0, L.w[WCO], L.s[WCO], c.PB, D, Dq};
  J.w1 = {c.XN, nullptr, 0, L.w[W1], L.s[W1], c.PA, FF, D};
  J.w2 = {c.PA, L.v[B1], cdiv(D, KC), L.w[W2], L.s[W2], c.PB, D, FF};
  return J;
}

// A warp's attention staging in the dynamic shared memory.
__device__ __forceinline__ float* warp_staging(const Ctx& c, char* smem) {
  return (float*)smem + (threadIdx.x >> 5) * attend_smem_floats(c.d, c.Lpad > c.Lk ? c.Lpad : c.Lk);
}

// The self-attention phase: item (row r, head h) on warp it % aw of block
// it / aw (mod the grid), from the q, k, v partials; the context into ATT
// [BK, Dq], the new K/V rows into the caches [K, B, Lpad, Dq] at c.pos.
template <typename CT>
__device__ void self_phase(const Ctx& c, const LayerJobs& J, CT* ck, CT* cv, char* smem) {
  const int M = c.BK, Dq = c.Dq, nh = c.nh, d = c.d, SD = cdiv(c.D, KC);
  const int warp = threadIdx.x >> 5;
  const float *Pq = J.qkv[0].P, *Pk = J.qkv[1].P, *Pv = J.qkv[2].P;
  if (warp < c.aw) {
    float* wsm = warp_staging(c, smem);
    for (int it = blockIdx.x * c.aw + warp; it < M * nh; it += gridDim.x * c.aw) {
      const int r = it / nh, h = it % nh;
      const int o = h * d;
      self_attend<CT>([&](int t) { return psum(Pq, SD, M, Dq, r, o + t); },
                      [&](int t) { return psum(Pk, SD, M, Dq, r, o + t); },
                      [&](int t) { return psum(Pv, SD, M, Dq, r, o + t); }, ck, cv, c.anc,
                      c.maskk, c.ATT, c.pos, M, c.K, c.Lpad, Dq, d, r, h, wsm);
    }
  }
  __syncthreads();
}

// The cross-attention phase: item (row r, head h) as in self_phase, from
// the cross query's partials, over the memory K/V [B, Lk, Dq] of row r's
// batch entry; the context into ATT [BK, Dq].
template <typename CT>
__device__ void cross_phase(const Ctx& c, const LayerJobs& J, const CT* mk, const CT* mv,
                            char* smem) {
  const int M = c.BK, Dq = c.Dq, nh = c.nh, d = c.d, SD = cdiv(c.D, KC);
  const int warp = threadIdx.x >> 5;
  if (warp < c.aw) {
    float* wsm = warp_staging(c, smem);
    for (int it = blockIdx.x * c.aw + warp; it < M * nh; it += gridDim.x * c.aw) {
      const int r = it / nh, h = it % nh;
      const int o = h * d;
      cross_attend<CT>([&](int t) { return psum(J.cq.P, SD, M, Dq, r, o + t); }, mk, mv,
                       c.memmask, c.ATT, M, c.K, c.Lk, Dq, d, r, h, wsm);
    }
  }
  __syncthreads();
}

// One decoder layer at c.pos from xin (its LN1 already in XN, the QKV
// weight copy already issued) to xout. With g_next, the last row phase
// also writes LayerNorm(xout) to XN, and `next` (if any) is the product
// phase whose weight copy to issue before the closing barrier (f32 weights
// with next_f32); without g_next the layer ends on its last row phase,
// with no barrier.
template <typename WT, typename CT>
__device__ void layer_body(const Ctx& c, const LayerW& L, const float* xin, float* xout,
                           CT* ck, CT* cv, const CT* mk, const CT* mv, const float* g_next,
                           const float* b_next, float eps_next, const Phase* next,
                           bool next_f32, char* smem, float* red) {
  cg::grid_group grid = cg::this_grid();
  const int M = c.BK, SQ = cdiv(c.Dq, KC);
  const LayerJobs J = layer_jobs(c, L, xin);
  const Phase qkv = phase(c, P_QKV, J.qkv), fc = phase(c, P_FC, &J.fc),
              cq = phase(c, P_CQ, &J.cq), co = phase(c, P_CO, &J.co),
              w1 = phase(c, P_W1, &J.w1), w2 = phase(c, P_W2, &J.w2);
  product_phase<WT>(qkv, M, smem);
  barrier(grid);  // q, k, v partials complete
  self_phase<CT>(c, J, ck, cv, smem);
  prefetch<WT>(fc, smem);
  barrier(grid);  // self-attention context complete
  product_phase<WT>(fc, M, smem);
  barrier(grid);  // fc partials complete
  prefetch<WT>(cq, smem);
  row_phase(c, J.fc.P, SQ, nullptr, xin, c.X1, L.v[LN2G], L.v[LN2B], 1e-6f, red);
  barrier(grid);  // x1 and LN2(x1) complete
  product_phase<WT>(cq, M, smem);
  barrier(grid);  // cross query partials complete
  cross_phase<CT>(c, J, mk, mv, smem);
  prefetch<WT>(co, smem);
  barrier(grid);  // cross-attention context complete
  product_phase<WT>(co, M, smem);
  barrier(grid);  // co partials complete
  prefetch<WT>(w1, smem);
  row_phase(c, J.co.P, SQ, nullptr, c.X1, c.X2, L.v[LN3G], L.v[LN3B], 1e-6f, red);
  barrier(grid);  // x2 and LN3(x2) complete
  product_phase<WT>(w1, M, smem);
  prefetch<WT>(w2, smem);
  barrier(grid);  // w1 partials complete
  product_phase<WT>(w2, M, smem);
  barrier(grid);  // w2 partials complete
  if (next) {
    if (next_f32)
      prefetch<float>(*next, smem);
    else
      prefetch<WT>(*next, smem);
  }
  row_phase(c, J.w2.P, cdiv(c.FF, KC), L.v[B2], c.X2, xout, g_next, b_next, eps_next, red);
  if (g_next) barrier(grid);  // the layer's output and the next LayerNorm complete
}

// Two product stages' shared bytes (weights of wbytes bytes).
int prod_smem(int wbytes) { return 2 * (KC * BN * wbytes + KC * BM * (int)sizeof(float)); }

// Dynamic shared memory a K5 or K4 call needs: two product stages (f32
// weights where any product is f32) or an attention item a warp, whichever
// is larger.
int smem_need(int wbytes, int d, int Lpad, int Lk) {
  const int prod = prod_smem(wbytes);
  const int n = Lpad > Lk ? Lpad : Lk;
  const int att = THREADS / 32 * attend_smem_floats(d, n) * (int)sizeof(float);
  return prod > att ? prod : att;
}

// The 24 pointers of a layer, in decode_flash.py `_fused_pointers` order:
// the eight vectors, the eight matrices, their eight scales (null for f32).
LayerW read_layer(const void* const* w) {
  LayerW L;
  for (int j = 0; j < 8; ++j) {
    L.v[j] = (const float*)w[j];
    L.w[j] = w[8 + j];
    L.s[j] = (const float*)w[16 + j];
  }
  return L;
}

// The shapes the kernels take: whole heads, D within a row phase's
// registers, 16-byte weight rows. Any head width: attend.cuh loads a cache
// row 16 bytes at a time where d % 8 == 0, an entry at a time otherwise.
bool shapes_ok(int quant, int D, int FF, int nh) {
  if (nh < 1 || D % nh) return false;
  const int align = quant ? 16 : 4;
  return D <= ROW_COLS * THREADS && D % align == 0 && FF % align == 0;
}

// K6a-c and K7c: `grid` blocks (> 0), at most what the card keeps resident.
template <typename Kern, typename Args>
int step_launch(Kern kern, const Args& a, int smem, int grid, cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  const int e = resident(kern, THREADS, smem, &per_sm, &sms);
  if (e) return e;
  if (grid < 1) return (int)cudaErrorInvalidValue;
  return launch_coop(kern, a, THREADS, smem, grid < per_sm * sms ? grid : per_sm * sms, stream);
}

// K5 and K4's context beyond make_ctx: full-width heads, 8 attention warps.
void set_layer_ctx(Ctx& c, int nh, int Lpad, int Lk, int pos, const int* anc, const int* maskk,
                   const int* memmask, const int* tiles) {
  c.nh = nh;
  c.d = c.Dq / nh;
  c.aw = THREADS / 32;
  c.Lpad = Lpad;
  c.Lk = Lk;
  c.pos = pos;
  c.anc = anc;
  c.maskk = maskk;
  c.memmask = memmask;
  c.tiles = (const int4*)tiles;
}

}  // namespace
