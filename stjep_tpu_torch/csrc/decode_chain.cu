// K3 and K7c: a decode position through every stacked layer and the head
// (K3, `decode_chain_fused`), and a vocabulary shard of the decode head
// (K7c, `head_partial_fused`), as cooperative persistent kernels on the
// phases of decode_fused.cuh, whose comment holds their design. They
// replace stjep_tpu/ops/decode_flash.py `decode_chain_step_flash` :1078 (its
// `pallas_call` :1168, body `_chain_kernel` :1024) and `decode_head_partial`
// :1666 (:1704, `_head_kernel`'s partial branch), which the port ran as
// chains of ~10 (six K5 launches and the head's LayerNorm, split-K GEMM,
// reduction and top-K) and 4 launches, with the stacked weights and caches
// sliced on the host every position.
//
// K3 is K4 less the embedding and the select: a row phase copies x (token
// embedding plus time signal, added by the caller, which also sets
// anc[pos]) into X0 and takes LN1 of layer 0; the stacked layers by layer
// stride (layer_at, no host slicing), the last ending on the final
// LayerNorm (eps 1e-5); the head's product (f32 weights in every variant);
// a phase of each row's top-K (`topk_rows`): 2 + 11 nl barriers. K7c is a
// shard step like K6c: a row phase (LayerNorm, eps 1e-5), the head's
// product over the shard's [D, V/n], and the same top-K phase, raw: 2
// barriers. Bounds: K3 at B*K = 80 is K4's work less the select (~0.04 ms
// on an H100, operations) and 68 barriers; its gather variant at dev
// eval's 16 rows moves the same weights for a fifth of the products; K7c
// at V/n = 50 moves 0.1 MB, so its launch and 2 barriers set its floor.

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


// What a fused K3 (kind 0; quant: int8 weights, bf16: bf16 caches) or K7c
// (kind 1) launch would be: out[0] the blocks an SM keeps resident at smem
// bytes, out[1] the SM count, out[2] the dynamic shared memory a block of
// that kernel may opt in to (decode_fused.cu `decode_fused_grid`'s
// answer for these two).
extern "C" int decode_chain_grid(int quant, int bf16, int kind, int smem, int* out,
                                 cudaStream_t stream) {
  const auto ask = [&](auto kern) {
    const cudaError_t e = smem_allow_max((const void*)kern, out + 2);
    return e != cudaSuccess ? (int)e : resident(kern, THREADS, smem, out, out + 1);
  };
  if (kind == 1) return ask(head_step_kernel);
  return quant ? (bf16 ? ask(chain_kernel<int8_t, __nv_bfloat16>) : ask(chain_kernel<int8_t, float>))
               : (bf16 ? ask(chain_kernel<float, __nv_bfloat16>) : ask(chain_kernel<float, float>));
}
