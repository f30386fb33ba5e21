// K3, K7c and K7a/K7b: a decode position through every stacked layer and
// the head (K3, `decode_chain_fused`), a vocabulary shard of the decode
// head (K7c, `head_partial_fused`) and the decode head over the whole
// vocabulary (K7a/K7b, `head_fused`), as cooperative persistent kernels on
// the phases of decode_fused.cuh, whose comment holds their design. They
// replace stjep_tpu/ops/decode_flash.py `decode_chain_step_flash` :1078 (its
// `pallas_call` :1168, body `_chain_kernel` :1024), `decode_head_partial`
// :1666 (:1704, `_head_kernel`'s partial branch), `decode_head` :1595
// (:1610) and `decode_head_gather` :1628 (:1646, `_head_kernel`), which the
// port ran as chains of ~10 (six K5 launches and the head's LayerNorm,
// split-K GEMM, reduction and top-K), 4 and 4 launches, with the stacked
// weights and caches sliced on the host every position.
//
// K3 is K4 less the embedding and the select: a row phase copies x (token
// embedding plus time signal, added by the caller, which also sets
// anc[pos]) into X0 and takes LN1 of layer 0; the stacked layers by layer
// stride (layer_at, no host slicing), the last ending on the final
// LayerNorm (eps 1e-5); the head's product (f32 weights in every variant);
// a phase of each row's top-K (`topk_rows`): 2 + 11 nl barriers. K7c is a
// shard step like K6c: a row phase (LayerNorm, eps 1e-5), the head's
// product over the shard's [D, V/n], and the same top-K phase, raw: 2
// barriers. K7a/K7b is K7c's first two phases over the whole [D, V], then
// a top-K phase by column slices of 2048 ids, a (row, slice) an item, the
// slice's logits held in registers: at V <= 2048 (the model's 200) one
// slice is the row and the phase writes the log-probs, 2 barriers; above
// it each slice writes its raw top-K, max and sum-exp, and a last phase
// merges each row's slices in slice order, 3 barriers. One block a row
// scanning a 30 000-id row K + 1 times from L2 would leave most of the
// grid idle; the slices spread the row over as many blocks as it has
// slices and never stores the logits. Bounds: K3 at B*K = 80 is K4's work
// less the select (~0.04 ms on an H100, operations) and 68 barriers; its
// gather variant at dev eval's 16 rows moves the same weights for a fifth
// of the products; K7c at V/n = 50 moves 0.1 MB and K7a at V = 200 0.6 MB,
// so their launch and 2 barriers set their floor. At V = 30 000 K7a's
// product, 2.5 GFLOP at 80 rows (37 us at the CUDA cores' 67 TFLOP/s),
// takes most of its ~250 us on an H100: a thread's 2 x 4 outputs cost 3
// shared-memory loads a k-step, the tile shape K4 and K5 use, and its 8
// split partials a logit go through memory (PERF.md section 6).

#include "decode_fused.cuh"

namespace {

// K3's and K7c's last phase, one row a block: the row's logits [V] summed
// from the head's split partials in split order into LG, then its top-K
// (head_topk_row): log-probs, with gid the log-prob there into glp (K3);
// or, with mx and se, a vocabulary shard's raw top-K, row max, sum-exp and
// raw logit at gid into glp (K7c).
__device__ void topk_rows(const Ctx& c, int V, int topk, const int* gid, float* sc, int* ids,
                          float* glp, float* mx, float* se) {
  const int SD = cdiv(c.D, KC);
  for (int r = blockIdx.x; r < c.BK; r += gridDim.x) {
    for (int v = threadIdx.x; v < V; v += THREADS)
      c.LG[(size_t)r * V + v] = psum(c.PA, SD, c.BK, V, r, v);
    __syncthreads();
    head_topk_row(c.LG, gid, sc, ids, glp, mx, se, V, topk, r);
    __syncthreads();
  }
}

struct ChainArgs {
  LayerW L;  // layer 0 of the stacked weights
  int nl, V, topk;
  const float *x, *norm_g, *norm_b, *out_w;
  const int* gid;
  void *ck, *cv;
  const void *mk, *mv;
  float *sc, *glp;
  int* ids;
  Ctx c;
};

// K3: x into X0 and LN1 of layer 0; the nl layers as K4 runs them; the
// head's product; each row's log-softmax top-K (and the log-prob at gid).
template <typename WT, typename CT>
__global__ void __launch_bounds__(THREADS) chain_kernel(const ChainArgs a) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float red[32];
  cg::grid_group grid = cg::this_grid();
  const Ctx& c = a.c;
  stamp();
  const int D = c.D, wbytes = sizeof(WT);
  const size_t cache_layer = (size_t)c.BK * c.Lpad * D;  // [K, B, Lpad, D] a layer
  const size_t mem_layer = (size_t)(c.BK / c.K) * c.Lk * D;  // [B, Lk, D] a layer
  const Job head = {c.XN, nullptr, 0, a.out_w, nullptr, c.PA, a.V, D};
  const Phase ph_head = phase(c, P_HEAD, &head);
  {
    const LayerJobs J = layer_jobs(c, a.L, c.X0);
    prefetch<WT>(phase(c, P_QKV, J.qkv), smem);
  }
  row_phase(c, nullptr, 0, nullptr, a.x, c.X0, a.L.v[LN1G], a.L.v[LN1B], 1e-6f, red);
  barrier(grid);  // x in X0 and its LN1 complete
  for (int l = 0; l < a.nl; ++l) {
    const LayerW L = layer_at(a.L, l, D, c.FF, wbytes);
    const bool last = l + 1 == a.nl;
    const LayerW N = layer_at(a.L, last ? l : l + 1, D, c.FF, wbytes);
    const LayerJobs JN = layer_jobs(c, N, c.X0);
    const Phase next = last ? ph_head : phase(c, P_QKV, JN.qkv);
    layer_body<WT, CT>(c, L, c.X0, c.X0, (CT*)a.ck + l * cache_layer, (CT*)a.cv + l * cache_layer,
                       (const CT*)a.mk + l * mem_layer, (const CT*)a.mv + l * mem_layer,
                       last ? a.norm_g : N.v[LN1G], last ? a.norm_b : N.v[LN1B],
                       last ? 1e-5f : 1e-6f, &next, last, smem, red);
  }
  product_phase<float>(ph_head, c.BK, smem);
  barrier(grid);  // the head's partials complete
  topk_rows(c, a.V, a.topk, a.gid, a.sc, a.ids, a.glp, nullptr, nullptr);
}

struct HeadArgs {
  const float *x, *norm_g, *norm_b, *out_w;
  const int* gid;
  float *sc, *glog, *mx, *se;
  int* ids;
  int V, topk;
  Ctx c;
};

// K7c: LN(x) (eps 1e-5); the shard's head product x_n @ out_w [D, V]; each
// row's raw top-K with its row max, sum-exp and raw logit at gid.
__global__ void __launch_bounds__(THREADS) head_step_kernel(const HeadArgs a) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float red[32];
  cg::grid_group grid = cg::this_grid();
  const Ctx& c = a.c;
  stamp();
  const Job head = {c.XN, nullptr, 0, a.out_w, nullptr, c.PA, a.V, c.D};
  const Phase ph = phase(c, P_HEAD, &head);
  prefetch<float>(ph, smem);
  row_phase(c, nullptr, 0, nullptr, a.x, nullptr, a.norm_g, a.norm_b, 1e-5f, red);
  barrier(grid);  // LN(x) complete
  product_phase<float>(ph, c.BK, smem);
  barrier(grid);  // the shard's head partials complete
  topk_rows(c, a.V, a.topk, a.gid, a.sc, a.ids, a.glog, a.mx, a.se);
}

// K7a and K7b's top-K phase takes a row's logits in column slices of SLICE
// ids, a slice an item, each thread holding SLICE_COLS of them in
// registers (column s * SLICE + j * THREADS + t in thread t's v[j]). A
// slice's record for the merge (rec, in LG: the head never stores its
// logits): its raw top-K values and ids (ids as float bits), its max and
// sum-exp, CAND floats at a stride of MAX_BEAM, so that nS * CAND <= V
// wherever V > SLICE. The merge's taken ids fit a 32-bit mask a thread:
// nS * topk <= 32 * THREADS. K7 takes K7c's HeadArgs with mx = se = null
// and glog its glp, the log-prob at gid.
constexpr int SLICE_COLS = 8;
constexpr int SLICE = SLICE_COLS * THREADS;
constexpr int CAND = 2 * MAX_BEAM + 2;
constexpr int MAX_SLICES = 32 * THREADS / MAX_BEAM;

// The logit at gid (0 for an id outside [0, V), as the TPU kernel's masked
// sum gives), summed from the head's partials in split order.
__device__ float gathered(const HeadArgs& a, int r) {
  const Ctx& c = a.c;
  const int g = a.gid[r];
  return g >= 0 && g < a.V ? psum(c.PA, cdiv(c.D, KC), c.BK, a.V, r, g) : 0.f;
}

// Item (row r, slice s) of K7a/K7b's top-K phase: the slice's logits from
// the head's partials (psum, split order), its max mx and sum-exp se (at
// mx), then topk arg-max passes
// over the registers, the lowest id winning ties, each pass's winner
// struck from its owner's live mask. With one
// slice (V <= SLICE) the row is done here: log-probs v - lse, ids, and
// glp; else the slice's raw record goes to rec for the merge.
__device__ void head_slice(const HeadArgs& a, int nS, int r, int s, float* rec, float* red,
                           float* rv, int* ri) {
  const Ctx& c = a.c;
  const int SD = cdiv(c.D, KC), c0 = s * SLICE;
  float v[SLICE_COLS];
  unsigned live = 0;
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < SLICE_COLS; ++j) {
    const int col = c0 + j * THREADS + threadIdx.x;
    v[j] = col < a.V ? psum(c.PA, SD, c.BK, a.V, r, col) : 0.f;
    if (col < a.V) {
      live |= 1u << j;
      m = fmaxf(m, v[j]);
    }
  }
  const float mx = block_max(m, red);
  float z = 0.f;
#pragma unroll
  for (int j = 0; j < SLICE_COLS; ++j)
    if (live >> j & 1) z += expf(v[j] - mx);
  const float se = block_sum(z, red);
  const float lse = nS == 1 ? mx + logf(se) : 0.f;
  float* out = rec + ((size_t)r * nS + s) * CAND;
  for (int k = 0; k < a.topk; ++k) {
    float bv = -INFINITY;
    int bi = 0x7fffffff, bj = -1;
#pragma unroll
    for (int j = 0; j < SLICE_COLS; ++j) {
      const int col = c0 + j * THREADS + threadIdx.x;
      if ((live >> j & 1) && better(v[j], col, bv, bi)) {
        bv = v[j];
        bi = col;
        bj = j;
      }
    }
    const int mine = bi;
    block_argmax(bv, bi, rv, ri);
    if (bj >= 0 && mine == bi) live &= ~(1u << bj);
    if (threadIdx.x == 0) {
      if (nS == 1) {
        a.sc[(size_t)r * a.topk + k] = bv - lse;
        a.ids[(size_t)r * a.topk + k] = bi;
      } else {
        out[k] = bv;
        out[MAX_BEAM + k] = __int_as_float(bi);
      }
    }
  }
  if (threadIdx.x == 0) {
    if (nS == 1 && a.glog) a.glog[r] = gathered(a, r) - lse;
    if (nS > 1) {
      out[2 * MAX_BEAM] = mx;
      out[2 * MAX_BEAM + 1] = se;
    }
  }
}

// Row r of K7a/K7b's merge (V > SLICE): lse from the slices' max and
// sum-exp in slice order (mx the largest, se = sum se_s exp(mx_s - mx), as
// ops/decode_flash_tp.py decode_head_tp joins vocabulary shards), then
// topk arg-max passes over the slices' nS * topk candidates (candidate e =
// slice e / topk's k = e % topk, thread e % THREADS), the lowest id
// winning ties; log-probs v - lse, and glp.
__device__ void head_merge(const HeadArgs& a, int nS, int r, const float* rec, float* red,
                           float* rv, int* ri) {
  const float* row = rec + (size_t)r * nS * CAND;
  if (threadIdx.x == 0) {
    float mx = -INFINITY, se = 0.f;
    for (int s = 0; s < nS; ++s) mx = fmaxf(mx, row[s * CAND + 2 * MAX_BEAM]);
    for (int s = 0; s < nS; ++s)
      se += row[s * CAND + 2 * MAX_BEAM + 1] * expf(row[s * CAND + 2 * MAX_BEAM] - mx);
    red[0] = mx + logf(se);
  }
  __syncthreads();
  const float lse = red[0];
  __syncthreads();  // red is the reductions' scratch again
  const int n = nS * a.topk;
  unsigned taken = 0;
  for (int k = 0; k < a.topk; ++k) {
    float bv = -INFINITY;
    int bi = 0x7fffffff, bq = -1;
    for (int e = threadIdx.x, q = 0; e < n; e += THREADS, ++q) {
      const float* p = row + (e / a.topk) * CAND + e % a.topk;
      const float cv = p[0];
      const int ci = __float_as_int(p[MAX_BEAM]);
      if (!(taken >> q & 1) && better(cv, ci, bv, bi)) {
        bv = cv;
        bi = ci;
        bq = q;
      }
    }
    const int mine = bi;
    block_argmax(bv, bi, rv, ri);
    if (bq >= 0 && mine == bi) taken |= 1u << bq;
    if (threadIdx.x == 0) {
      a.sc[(size_t)r * a.topk + k] = bv - lse;
      a.ids[(size_t)r * a.topk + k] = bi;
    }
  }
  if (threadIdx.x == 0 && a.glog) a.glog[r] = gathered(a, r) - lse;
}

// K7a and K7b: LN(x) (eps 1e-5); the head's product x_n @ out_w [D, V];
// each row's log-softmax top-K (and the log-prob at gid) by column slices,
// merged in slice order where a row has more than one: 2 barriers at V <=
// SLICE, 3 above.
__global__ void __launch_bounds__(THREADS) head_full_kernel(const HeadArgs a) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float red[32], rv[32];
  __shared__ int ri[32];
  cg::grid_group grid = cg::this_grid();
  const Ctx& c = a.c;
  stamp();
  const Job head = {c.XN, nullptr, 0, a.out_w, nullptr, c.PA, a.V, c.D};
  const Phase ph = phase(c, P_HEAD, &head);
  prefetch<float>(ph, smem);
  row_phase(c, nullptr, 0, nullptr, a.x, nullptr, a.norm_g, a.norm_b, 1e-5f, red);
  barrier(grid);  // LN(x) complete
  product_phase<float>(ph, c.BK, smem);
  barrier(grid);  // the head's partials complete
  const int nS = cdiv(a.V, SLICE);
  for (int it = blockIdx.x; it < c.BK * nS; it += gridDim.x) {
    head_slice(a, nS, it / nS, it % nS, c.LG, red, rv, ri);
    __syncthreads();
  }
  if (nS == 1) return;
  barrier(grid);  // every slice's record complete
  for (int r = blockIdx.x; r < c.BK; r += gridDim.x) {
    head_merge(a, nS, r, c.LG, red, rv, ri);
    __syncthreads();
  }
}

template <typename WT, typename CT>
int chain_launch(const ChainArgs& a, int smem, int grid, cudaStream_t stream) {
  return launch_coop(chain_kernel<WT, CT>, a, THREADS, smem, grid, stream);
}

}  // namespace

// K3: one decode position through every stacked layer and the head
// (decode_flash.py decode_chain_step_flash). w, quant, bf16, the caches,
// memory, masks, ws, tiles, smem and grid as K4's; norm_g, norm_b and
// out_w [D, V] the head; x [BK, D] the position's input (token embedding
// plus time signal); anc[pos] must hold each row's own slot (the caller
// sets it). Out: sc, ids [BK, topk], the top-K log-probs and their ids;
// with gid [BK], glp [BK], the log-prob at gid (gid and glp both null
// without).
extern "C" int decode_chain_fused(const void* const* w, int quant, int bf16, const float* norm_g,
                                  const float* norm_b, const float* out_w, const float* x,
                                  const int* gid, const int* anc, const int* maskk,
                                  const int* memmask, void* ck, void* cv, const void* mk,
                                  const void* mv, float* sc, int* ids, float* glp, float* ws,
                                  const int* tiles, int ws_floats, int pos, int BK, int K,
                                  int Lpad, int Lk, int D, int FF, int nh, int nl, int V,
                                  int topk, int smem, int grid, cudaStream_t stream) {
  if (!shapes_ok(quant, D, FF, nh) || K < 1 || BK % K || nl < 1 || topk < 1 ||
      topk > MAX_BEAM || topk > V || pos < 0 || pos >= Lpad || !gid != !glp ||
      (size_t)ws_floats < ws_need(BK, K, D, D, FF, V) || smem < smem_need(4, D / nh, Lpad, Lk))
    return (int)cudaErrorInvalidValue;
  ChainArgs a;
  a.L = read_layer(w);
  a.nl = nl;
  a.V = V;
  a.topk = topk;
  a.x = x;
  a.norm_g = norm_g;
  a.norm_b = norm_b;
  a.out_w = out_w;
  a.gid = gid;
  a.ck = ck;
  a.cv = cv;
  a.mk = mk;
  a.mv = mv;
  a.sc = sc;
  a.glp = glp;
  a.ids = ids;
  a.c = make_ctx(ws, BK, K, D, D, FF, V);
  set_layer_ctx(a.c, nh, Lpad, Lk, pos, anc, maskk, memmask, tiles);
  if (quant)
    return bf16 ? chain_launch<int8_t, __nv_bfloat16>(a, smem, grid, stream)
                : chain_launch<int8_t, float>(a, smem, grid, stream);
  return bf16 ? chain_launch<float, __nv_bfloat16>(a, smem, grid, stream)
              : chain_launch<float, float>(a, smem, grid, stream);
}

// K7c: one vocabulary shard of the decode head (decode_flash.py
// decode_head_partial). norm_g, norm_b [D]; out_w [D, V] the shard's
// columns (f32); x [BK, D]. Out: sc, ids [BK, topk], the raw top-K logits
// and their shard-local ids (-1e30 at id 0 past V where V < topk); mx, se
// [BK], the row max and sum exp(logit - mx); with gid [BK] (shard-local),
// glog [BK], the raw logit there, 0 for an id outside [0, V) (gid and glog
// both null without). ws, tiles, smem, grid as K6c's.
extern "C" int head_partial_fused(const float* norm_g, const float* norm_b, const float* out_w,
                                  const float* x, const int* gid, float* sc, int* ids,
                                  float* mx, float* se, float* glog, float* ws,
                                  const int* tiles, int ws_floats, int BK, int D, int V,
                                  int topk, int smem, int grid, cudaStream_t stream) {
  if (V < 1 || topk < 1 || topk > MAX_BEAM || D % 4 || D > ROW_COLS * THREADS || BK < 1 ||
      !gid != !glog || (size_t)ws_floats < ws_need(BK, 1, D, 0, 0, V) || smem < prod_smem(4))
    return (int)cudaErrorInvalidValue;
  HeadArgs a = {};
  a.x = x;
  a.norm_g = norm_g;
  a.norm_b = norm_b;
  a.out_w = out_w;
  a.gid = gid;
  a.sc = sc;
  a.glog = glog;
  a.mx = mx;
  a.se = se;
  a.ids = ids;
  a.V = V;
  a.topk = topk;
  a.c = make_ctx(ws, BK, 1, D, 0, 0, V);
  a.c.tiles = (const int4*)tiles;
  return step_launch(head_step_kernel, a, smem, grid, stream);
}

// K7a and K7b: the decode head over the whole vocabulary (decode_flash.py
// decode_head, decode_head_gather). norm_g, norm_b [D]; out_w [D, V] (f32);
// x [BK, D]. Out: sc, ids [BK, topk], the top-K log-probs and their ids,
// the lowest id first among ties; with gid [BK], glp [BK], the log-prob at
// gid, 0 - lse for an id outside [0, V) (gid and glp both null without).
// ws, tiles, smem, grid as K7c's; V up to MAX_SLICES column slices.
extern "C" int head_fused(const float* norm_g, const float* norm_b, const float* out_w,
                          const float* x, const int* gid, float* sc, int* ids, float* glp,
                          float* ws, const int* tiles, int ws_floats, int BK, int D, int V,
                          int topk, int smem, int grid, cudaStream_t stream) {
  if (V < 1 || cdiv(V, SLICE) > MAX_SLICES || topk < 1 || topk > MAX_BEAM || topk > V ||
      D % 4 || D > ROW_COLS * THREADS || BK < 1 || !gid != !glp ||
      (size_t)ws_floats < ws_need(BK, 1, D, 0, 0, V) || smem < prod_smem(4))
    return (int)cudaErrorInvalidValue;
  HeadArgs a = {};  // mx, se null
  a.x = x;
  a.norm_g = norm_g;
  a.norm_b = norm_b;
  a.out_w = out_w;
  a.gid = gid;
  a.sc = sc;
  a.glog = glp;
  a.ids = ids;
  a.V = V;
  a.topk = topk;
  a.c = make_ctx(ws, BK, 1, D, 0, 0, V);
  a.c.tiles = (const int4*)tiles;
  return step_launch(head_full_kernel, a, smem, grid, stream);
}

// Built with -DSTJEP_FUSED_STAMPS (scripts/fused_phase_split.py): this
// unit's launches record the global timer into buf as decode_fused.cu's
// `decode_fused_stamps` has its own record (null turns it off).
extern "C" int decode_chain_stamps(unsigned long long* buf, cudaStream_t stream) {
#ifdef STJEP_FUSED_STAMPS
  return (int)cudaMemcpyToSymbol(g_stamps, &buf, sizeof(buf));
#else
  return (int)cudaErrorNotSupported;
#endif
}

// What a fused K3 (kind 0; quant: int8 weights, bf16: bf16 caches), K7c
// (kind 1) or K7a/K7b (kind 2) launch would be: out[0] the blocks an SM
// keeps resident at smem bytes, out[1] the SM count, out[2] the dynamic
// shared memory a block of that kernel may opt in to (decode_fused.cu
// `decode_fused_grid`'s answer for these three).
extern "C" int decode_chain_grid(int quant, int bf16, int kind, int smem, int* out,
                                 cudaStream_t stream) {
  const auto ask = [&](auto kern) {
    const cudaError_t e = smem_allow_max((const void*)kern, out + 2);
    return e != cudaSuccess ? (int)e : resident(kern, THREADS, smem, out, out + 1);
  };
  if (kind == 1) return ask(head_step_kernel);
  if (kind == 2) return ask(head_full_kernel);
  return quant ? (bf16 ? ask(chain_kernel<int8_t, __nv_bfloat16>) : ask(chain_kernel<int8_t, float>))
               : (bf16 ? ask(chain_kernel<float, __nv_bfloat16>) : ask(chain_kernel<float, float>));
}
