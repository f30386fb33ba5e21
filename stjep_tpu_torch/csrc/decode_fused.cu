// K5, K4 and K6a-c: the decoder layer step, the beam step and the
// tensor-parallel shard steps as cooperative persistent kernels on the
// phases of decode_fused.cuh, whose comment holds their design.

#include "decode_fused.cuh"

namespace {

struct LayerArgs {
  LayerW L;
  const float* x;
  float* y;
  void *ck, *cv;
  const void *mk, *mv;
  Ctx c;
};

// K5: LN1 of x, then one layer.
template <typename WT, typename CT>
__global__ void __launch_bounds__(THREADS) layer_kernel(const LayerArgs a) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float red[32];
  const Ctx& c = a.c;
  stamp();
  const LayerJobs J = layer_jobs(c, a.L, a.x);
  prefetch<WT>(phase(c, P_QKV, J.qkv), smem);
  row_phase(c, nullptr, 0, nullptr, a.x, nullptr, a.L.v[LN1G], a.L.v[LN1B], 1e-6f, red);
  cg::grid_group grid = cg::this_grid();
  barrier(grid);  // LN1(x) complete
  layer_body<WT, CT>(c, a.L, a.x, a.y, (CT*)a.ck, (CT*)a.cv, (const CT*)a.mk,
                     (const CT*)a.mv, nullptr, nullptr, 0.f, nullptr, false, smem, red);
}

struct BeamArgs {
  LayerW L;  // layer 0 of the stacked weights
  int nl, V, i, B, Lbuf;
  float pf;
  const float *norm_g, *norm_b, *out_w, *table, *tsig, *scores, *lenm;
  const int *last_tok, *preds, *eos;
  int* anc;
  void *ck, *cv;
  const void *mk, *mv;
  int *preds_o, *anc_o, *maskk_o, *tok_o, *eos_o, *flag;
  float *scores_o, *lenm_o;
  Ctx c;
};

// K4: embed + time signal (anc[pos] = own slot, flag = 1), LN1 of layer 0;
// the nl layers; the head's product; each row's log-softmax top-K; per
// batch item the select.
template <typename WT, typename CT>
__global__ void __launch_bounds__(THREADS) beam_kernel(const BeamArgs a) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float red[32];
  cg::grid_group grid = cg::this_grid();
  const Ctx& c = a.c;
  stamp();
  const int BK = c.BK, D = c.D, pos = c.pos, K = c.K;
  const int wbytes = sizeof(WT);
  const Job head = {c.XN, nullptr, 0, a.out_w, nullptr, c.PA, a.V, D};
  const Phase ph_head = phase(c, P_HEAD, &head);
  {
    const LayerJobs J = layer_jobs(c, a.L, c.X0);
    prefetch<WT>(phase(c, P_QKV, J.qkv), smem);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.flag = 1;
  for (int r = blockIdx.x; r < BK; r += gridDim.x) {
    const int t = a.last_tok[r];
    const float keep = t != STJEP_PAD ? 1.f : 0.f;
    for (int k = threadIdx.x; k < D; k += THREADS)
      c.X0[(size_t)r * D + k] = a.table[(size_t)t * D + k] * keep + a.tsig[(size_t)pos * D + k];
    if (threadIdx.x == 0) a.anc[(size_t)pos * BK + r] = r % K;
  }
  // each thread reads back only the columns it wrote (the same row per block)
  row_phase(c, nullptr, 0, nullptr, c.X0, nullptr, a.L.v[LN1G], a.L.v[LN1B], 1e-6f, red);
  barrier(grid);  // embedded rows, anc[pos] and LN1 complete
  for (int l = 0; l < a.nl; ++l) {
    const LayerW L = layer_at(a.L, l, D, c.FF, wbytes);
    const bool last = l + 1 == a.nl;
    const LayerW N = layer_at(a.L, last ? l : l + 1, D, c.FF, wbytes);
    const LayerJobs JN = layer_jobs(c, N, c.X0);
    const Phase next = last ? ph_head : phase(c, P_QKV, JN.qkv);
    layer_body<WT, CT>(c, L, c.X0, c.X0, (CT*)a.ck + (size_t)l * K * (BK / K) * c.Lpad * D,
                       (CT*)a.cv + (size_t)l * K * (BK / K) * c.Lpad * D,
                       (const CT*)a.mk + (size_t)l * (BK / K) * c.Lk * D,
                       (const CT*)a.mv + (size_t)l * (BK / K) * c.Lk * D,
                       last ? a.norm_g : N.v[LN1G], last ? a.norm_b : N.v[LN1B],
                       last ? 1e-5f : 1e-6f, &next, last, smem, red);
  }
  product_phase<float>(ph_head, BK, smem);
  barrier(grid);  // head partials complete
  const int SD = cdiv(D, KC);
  for (int r = blockIdx.x; r < BK; r += gridDim.x) {
    for (int v = threadIdx.x; v < a.V; v += THREADS)
      c.LG[(size_t)r * a.V + v] = psum(c.PA, SD, BK, a.V, r, v);
    __syncthreads();
    head_topk_row(c.LG, nullptr, c.SCK, c.IDK, nullptr, nullptr, nullptr, a.V, K, r);
    __syncthreads();
  }
  barrier(grid);  // every row's top-K complete
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    select_group(c.SCK, c.IDK, a.scores, a.eos, a.lenm, a.preds, a.anc, c.maskk, a.preds_o,
                 a.anc_o, a.maskk_o, a.tok_o, a.scores_o, a.eos_o, a.lenm_o, a.flag, a.i, a.B,
                 K, a.Lbuf, a.pf, b);
    __syncthreads();
  }
}

// K6a-c: one shard's step, f32 weights. `add`: K6a and K6b add x
// (residual); K6c adds b_2 and x (not partial_tp).
struct StepArgs {
  LayerW L;  // K6a: LN1G/LN1B, WQ, WK, WV, WO; K6b: LN2G/LN2B, WCQ, WCO; K6c: LN3G/LN3B, B1,
             // B2, W1, W2
  const float* x;
  float* y;
  void *ck, *cv;        // K6a: the self caches
  const void *mk, *mv;  // K6b: the memory K/V
  int add;
  Ctx c;
};

// K6a: LN(x); q from it, k and v from x; self-attention at c.pos (the new
// K/V row into the caches); fc; y = the fc partials summed (+ x).
template <typename CT>
__global__ void __launch_bounds__(THREADS) self_step_kernel(const StepArgs a) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float red[32];
  cg::grid_group grid = cg::this_grid();
  const Ctx& c = a.c;
  stamp();
  const LayerJobs J = layer_jobs(c, a.L, a.x);
  const Phase qkv = phase(c, P_QKV, J.qkv), fc = phase(c, P_FC, &J.fc);
  prefetch<float>(qkv, smem);
  row_phase(c, nullptr, 0, nullptr, a.x, nullptr, a.L.v[LN1G], a.L.v[LN1B], 1e-6f, red);
  barrier(grid);  // LN(x) complete
  product_phase<float>(qkv, c.BK, smem);
  barrier(grid);  // q, k, v partials complete
  self_phase<CT>(c, J, (CT*)a.ck, (CT*)a.cv, smem);
  prefetch<float>(fc, smem);
  barrier(grid);  // context complete
  product_phase<float>(fc, c.BK, smem);
  barrier(grid);  // the shard's fc partials complete
  row_phase<false>(c, J.fc.P, cdiv(c.Dq, KC), nullptr, a.add ? a.x : nullptr, a.y, nullptr,
                   nullptr, 0.f, red);
}

// K6b: LN(x); the cross query from it; cross-attention over the memory;
// co; y = the co partials summed (+ x).
template <typename CT>
__global__ void __launch_bounds__(THREADS) cross_step_kernel(const StepArgs a) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float red[32];
  cg::grid_group grid = cg::this_grid();
  const Ctx& c = a.c;
  stamp();
  const LayerJobs J = layer_jobs(c, a.L, a.x);
  const Phase cq = phase(c, P_CQ, &J.cq), co = phase(c, P_CO, &J.co);
  row_phase(c, nullptr, 0, nullptr, a.x, nullptr, a.L.v[LN2G], a.L.v[LN2B], 1e-6f, red);
  barrier(grid);  // LN(x) complete
  prefetch<float>(cq, smem);
  product_phase<float>(cq, c.BK, smem);
  barrier(grid);  // cross query partials complete
  cross_phase<CT>(c, J, (const CT*)a.mk, (const CT*)a.mv, smem);
  barrier(grid);  // context complete
  prefetch<float>(co, smem);
  product_phase<float>(co, c.BK, smem);
  barrier(grid);  // co partials complete
  row_phase<false>(c, J.co.P, cdiv(c.Dq, KC), nullptr, a.add ? a.x : nullptr, a.y, nullptr,
                   nullptr, 0.f, red);
}

// K6c: LN(x); w1 (its partials); w2 from relu(sum + b_1); y = the w2
// partials summed (+ b_2 + x).
__global__ void __launch_bounds__(THREADS) ffn_step_kernel(const StepArgs a) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float red[32];
  cg::grid_group grid = cg::this_grid();
  const Ctx& c = a.c;
  stamp();
  const LayerJobs J = layer_jobs(c, a.L, a.x);
  const Phase w1 = phase(c, P_W1, &J.w1), w2 = phase(c, P_W2, &J.w2);
  prefetch<float>(w1, smem);
  row_phase(c, nullptr, 0, nullptr, a.x, nullptr, a.L.v[LN3G], a.L.v[LN3B], 1e-6f, red);
  barrier(grid);  // LN(x) complete
  product_phase<float>(w1, c.BK, smem);
  prefetch<float>(w2, smem);
  barrier(grid);  // w1 partials complete
  product_phase<float>(w2, c.BK, smem);
  barrier(grid);  // w2 partials complete
  row_phase<false>(c, J.w2.P, cdiv(c.FF, KC), a.add ? a.L.v[B2] : nullptr,
                   a.add ? a.x : nullptr, a.y, nullptr, nullptr, 0.f, red);
}

// The warps of a K6a or K6b block that run attention items: as many of
// its 8 as `smem` bytes stage at head width d over n positions (0: none
// fits).
int step_warps(int smem, int d, int n) {
  const int w = smem / (attend_smem_floats(d, n) * (int)sizeof(float));
  return w < THREADS / 32 ? w : THREADS / 32;
}

// The shapes K6a and K6b take: heads of d % 8 == 0 columns (16-byte cache
// row loads) over Dq <= D, D within a row phase's registers, groups of K
// rows, the workspace and two product stages.
bool attn_step_ok(int D, int Dq, int nh, int BK, int K, int ws_floats, int smem) {
  return nh >= 1 && Dq % nh == 0 && (Dq / nh) % 8 == 0 && Dq <= D && D % 4 == 0 &&
         D <= ROW_COLS * THREADS && K >= 1 && BK % K == 0 &&
         (size_t)ws_floats >= ws_need(BK, K, D, Dq, 0, 0) && smem >= prod_smem(4);
}

template <typename WT, typename CT>
int layer_launch(const LayerArgs& a, int smem, int grid, cudaStream_t stream) {
  return launch_coop(layer_kernel<WT, CT>, a, THREADS, smem, grid, stream);
}

template <typename WT, typename CT>
int beam_launch(const BeamArgs& a, int smem, int grid, cudaStream_t stream) {
  return launch_coop(beam_kernel<WT, CT>, a, THREADS, smem, grid, stream);
}

}  // namespace

// K5: one decoder layer at `pos` (decode_flash.py decoder_layer_step_flash).
// w: host array of the layer's 24 pointers; quant: int8 matrices; bf16: the
// self caches and memory K/V in bf16. x [BK, D] in, y [BK, D] out; caches
// [K, B, Lpad, D] updated at pos; memory [B, Lk, D]; anc, maskk [>= pos+1,
// BK]; memmask [Lk, B]; ws: ws_floats of workspace. tiles, smem: the plan's
// tile table (on the card) and shared bytes; grid: blocks (0: all the card
// keeps).
extern "C" int decoder_layer_fused(const void* const* w, int quant, int bf16, const float* x,
                                   float* y, void* ck, void* cv, const void* mk,
                                   const void* mv, const int* anc, const int* maskk,
                                   const int* memmask, float* ws, const int* tiles,
                                   int ws_floats, int pos, int BK, int K, int Lpad, int Lk,
                                   int D, int FF, int nh, int smem, int grid,
                                   cudaStream_t stream) {
  if (!shapes_ok(quant, D, FF, nh) || BK % K || pos >= Lpad ||
      (size_t)ws_floats < ws_need(BK, K, D, D, FF, 0) ||
      smem < smem_need(quant ? 1 : 4, D / nh, Lpad, Lk))
    return (int)cudaErrorInvalidValue;
  LayerArgs a;
  a.L = read_layer(w);
  a.x = x;
  a.y = y;
  a.ck = ck;
  a.cv = cv;
  a.mk = mk;
  a.mv = mv;
  a.c = make_ctx(ws, BK, K, D, D, FF, 0);
  set_layer_ctx(a.c, nh, Lpad, Lk, pos, anc, maskk, memmask, tiles);
  if (quant)
    return bf16 ? layer_launch<int8_t, __nv_bfloat16>(a, smem, grid, stream)
                : layer_launch<int8_t, float>(a, smem, grid, stream);
  return bf16 ? layer_launch<float, __nv_bfloat16>(a, smem, grid, stream)
              : layer_launch<float, float>(a, smem, grid, stream);
}

// K4: one beam position i (decode_flash.py decode_beam_step_flash). w: the
// stacked layers' 24 pointers ([nl, ...] each); caches [nl, K, B, Lpad, D],
// memory [nl, B, Lk, D]; the head norm and out_w [D, V]; table [., D] and
// tsig [., D]; the beam state in (last_tok, preds [BK, Lbuf], anc and maskk
// [Lbuf, BK], scores, eos, lenm) and out (the *_o tensors, flag).
extern "C" int decode_beam_fused(
    const void* const* w, int quant, int bf16, const float* norm_g, const float* norm_b,
    const float* out_w, const float* table, const float* tsig, const int* last_tok,
    const int* preds, int* anc, const int* maskk, const int* memmask, const float* scores,
    const int* eos, const float* lenm, void* ck, void* cv, const void* mk, const void* mv,
    int* preds_o, int* anc_o, int* maskk_o, int* tok_o, float* scores_o, int* eos_o,
    float* lenm_o, int* flag, float* ws, const int* tiles, int ws_floats, int i, int B, int K,
    int Lpad, int Lbuf, int Lk, int D, int FF, int nh, int nl, int V, int smem, int grid,
    float pf, cudaStream_t stream) {
  const int BK = B * K;
  if (!shapes_ok(quant, D, FF, nh) || K < 1 || K > MAX_BEAM || K > V || i < 1 ||
      i >= Lbuf || i - 1 >= Lpad || (size_t)ws_floats < ws_need(BK, K, D, D, FF, V) ||
      smem < smem_need(4, D / nh, Lpad, Lk))
    return (int)cudaErrorInvalidValue;
  BeamArgs a;
  a.L = read_layer(w);
  a.nl = nl;
  a.V = V;
  a.i = i;
  a.B = B;
  a.Lbuf = Lbuf;
  a.pf = pf;
  a.norm_g = norm_g;
  a.norm_b = norm_b;
  a.out_w = out_w;
  a.table = table;
  a.tsig = tsig;
  a.scores = scores;
  a.lenm = lenm;
  a.last_tok = last_tok;
  a.preds = preds;
  a.eos = eos;
  a.anc = anc;
  a.ck = ck;
  a.cv = cv;
  a.mk = mk;
  a.mv = mv;
  a.preds_o = preds_o;
  a.anc_o = anc_o;
  a.maskk_o = maskk_o;
  a.tok_o = tok_o;
  a.eos_o = eos_o;
  a.flag = flag;
  a.scores_o = scores_o;
  a.lenm_o = lenm_o;
  a.c = make_ctx(ws, BK, K, D, D, FF, V);
  set_layer_ctx(a.c, nh, Lpad, Lk, i - 1, anc, maskk, memmask, tiles);
  if (quant)
    return bf16 ? beam_launch<int8_t, __nv_bfloat16>(a, smem, grid, stream)
                : beam_launch<int8_t, float>(a, smem, grid, stream);
  return bf16 ? beam_launch<float, __nv_bfloat16>(a, smem, grid, stream)
              : beam_launch<float, float>(a, smem, grid, stream);
}

// K6a: one head shard's self-attention step at `pos` (decode_flash.py
// self_attn_step). ln_g, ln_b [D]; wq, wk, wv [D, Dq], wo [Dq, D] (f32);
// bf16: caches in bf16; residual: y = fc + x, else the partial alone. x
// [BK, D] in, y [BK, D] out; caches [K, B, Lpad, Dq] updated at pos; anc,
// maskk [>= pos+1, BK]; ws: ws_floats of workspace; tiles, smem: the
// plan's tile table (on the card) and shared bytes (the attention runs on
// as many warps a block as smem stages); grid: blocks, at most what the
// card keeps resident.
extern "C" int self_attn_step_fused(const float* ln_g, const float* ln_b, const float* wq,
                                    const float* wk, const float* wv, const float* wo,
                                    const float* x, float* y, void* ck, void* cv,
                                    const int* anc, const int* maskk, float* ws,
                                    const int* tiles, int bf16, int residual, int ws_floats,
                                    int pos, int BK, int K, int Lpad, int D, int Dq, int nh,
                                    int smem, int grid, cudaStream_t stream) {
  if (!attn_step_ok(D, Dq, nh, BK, K, ws_floats, smem) || pos < 0 || pos >= Lpad ||
      step_warps(smem, Dq / nh, Lpad) < 1)
    return (int)cudaErrorInvalidValue;
  StepArgs a = {};
  a.L.v[LN1G] = ln_g;
  a.L.v[LN1B] = ln_b;
  a.L.w[WQ] = wq;
  a.L.w[WK] = wk;
  a.L.w[WV] = wv;
  a.L.w[WO] = wo;
  a.x = x;
  a.y = y;
  a.ck = ck;
  a.cv = cv;
  a.add = residual;
  a.c = make_ctx(ws, BK, K, D, Dq, 0, 0);
  Ctx& c = a.c;
  c.nh = nh;
  c.d = Dq / nh;
  c.aw = step_warps(smem, c.d, Lpad);
  c.Lpad = Lpad;
  c.pos = pos;
  c.anc = anc;
  c.maskk = maskk;
  c.tiles = (const int4*)tiles;
  return bf16 ? step_launch(self_step_kernel<__nv_bfloat16>, a, smem, grid, stream)
              : step_launch(self_step_kernel<float>, a, smem, grid, stream);
}

// K6b: one head shard's cross-attention step (decode_flash.py
// cross_attn_step). ln_g, ln_b [D]; wq [D, Dq], wo [Dq, D] (f32); bf16:
// memory K/V in bf16; residual: y = co + x, else the partial alone. x [BK,
// D] in, y [BK, D] out; memory K/V [B, Lk, Dq], memmask [Lk, B]; ws, tiles,
// smem, grid as K6a's (the attention on as many warps as smem stages).
extern "C" int cross_attn_step_fused(const float* ln_g, const float* ln_b, const float* wq,
                                     const float* wo, const float* x, float* y, const void* mk,
                                     const void* mv, const int* memmask, float* ws,
                                     const int* tiles, int bf16, int residual, int ws_floats,
                                     int BK, int K, int Lk, int D, int Dq, int nh, int smem,
                                     int grid, cudaStream_t stream) {
  if (!attn_step_ok(D, Dq, nh, BK, K, ws_floats, smem) || Lk < 1 ||
      step_warps(smem, Dq / nh, Lk) < 1)
    return (int)cudaErrorInvalidValue;
  StepArgs a = {};
  a.L.v[LN2G] = ln_g;
  a.L.v[LN2B] = ln_b;
  a.L.w[WCQ] = wq;
  a.L.w[WCO] = wo;
  a.x = x;
  a.y = y;
  a.mk = mk;
  a.mv = mv;
  a.add = residual;
  a.c = make_ctx(ws, BK, K, D, Dq, 0, 0);
  Ctx& c = a.c;
  c.nh = nh;
  c.d = Dq / nh;
  c.aw = step_warps(smem, c.d, Lk);
  c.Lk = Lk;
  c.memmask = memmask;
  c.tiles = (const int4*)tiles;
  return bf16 ? step_launch(cross_step_kernel<__nv_bfloat16>, a, smem, grid, stream)
              : step_launch(cross_step_kernel<float>, a, smem, grid, stream);
}

// K6c: the FFN step on a hidden shard of width FF (decode_flash.py
// ffn_step). ln_g, ln_b, b2 [D]; w1 [D, FF], b1 [FF], w2 [FF, D] (f32);
// partial_tp: y = the partial h @ w2, else + b2 + x. x [BK, D] in, y [BK, D]
// out; ws, tiles, smem, grid as K6a's.
extern "C" int ffn_step_fused(const float* ln_g, const float* ln_b, const float* w1,
                              const float* b1, const float* w2, const float* b2,
                              const float* x, float* y, float* ws, const int* tiles,
                              int partial_tp, int ws_floats, int BK, int D, int FF, int smem,
                              int grid, cudaStream_t stream) {
  if (FF < 1 || D % 4 || D > ROW_COLS * THREADS || BK < 1 ||
      (size_t)ws_floats < ws_need(BK, 1, D, 0, FF, 0) || smem < prod_smem(4))
    return (int)cudaErrorInvalidValue;
  StepArgs a = {};
  a.L.v[LN3G] = ln_g;
  a.L.v[LN3B] = ln_b;
  a.L.v[B1] = b1;
  a.L.v[B2] = b2;
  a.L.w[W1] = w1;
  a.L.w[W2] = w2;
  a.x = x;
  a.y = y;
  a.add = !partial_tp;
  a.c = make_ctx(ws, BK, 1, D, 0, FF, 0);
  a.c.tiles = (const int4*)tiles;
  return step_launch(ffn_step_kernel, a, smem, grid, stream);
}

// What a fused launch would be: out[0] the blocks an SM keeps resident,
// out[1] the SM count, for kind 0 (K5), 1 (K4), 2 (K6a), 3 (K6c) or 4
// (K6b) at smem bytes (quant: int8 weights, K5 and K4 only; bf16: bf16
// caches or memory, not K6c), and out[2] the dynamic shared memory a block
// of that kernel may opt in to (`smem_allow_max`), which the shard steps'
// plans stage their attention items within.
extern "C" int decode_fused_grid(int quant, int bf16, int kind, int smem, int* out,
                                 cudaStream_t stream) {
  const auto ask = [&](auto kern) {
    const cudaError_t e = smem_allow_max((const void*)kern, out + 2);
    return e != cudaSuccess ? (int)e : resident(kern, THREADS, smem, out, out + 1);
  };
  if (kind == 4)
    return bf16 ? ask(cross_step_kernel<__nv_bfloat16>) : ask(cross_step_kernel<float>);
  if (kind == 3) return ask(ffn_step_kernel);
  if (kind == 2) return bf16 ? ask(self_step_kernel<__nv_bfloat16>) : ask(self_step_kernel<float>);
  if (kind == 1)
    return quant ? (bf16 ? ask(beam_kernel<int8_t, __nv_bfloat16>) : ask(beam_kernel<int8_t, float>))
                 : (bf16 ? ask(beam_kernel<float, __nv_bfloat16>) : ask(beam_kernel<float, float>));
  return quant ? (bf16 ? ask(layer_kernel<int8_t, __nv_bfloat16>) : ask(layer_kernel<int8_t, float>))
               : (bf16 ? ask(layer_kernel<float, __nv_bfloat16>) : ask(layer_kernel<float, float>));
}

// The timer buffer of a library built with -DSTJEP_FUSED_STAMPS (unsigned
// 64-bit, 2 + barriers entries, zeroed by the caller; null stops the
// reads). Without the define: cudaErrorNotSupported.
extern "C" int decode_fused_stamps(unsigned long long* buf, cudaStream_t stream) {
#ifdef STJEP_FUSED_STAMPS
  return (int)cudaMemcpyToSymbol(g_stamps, &buf, sizeof(buf));
#else
  return (int)cudaErrorNotSupported;
#endif
}
