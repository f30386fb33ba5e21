// The decode kernels that run as launches of their own: the attention
// kernels, the head's top-K (K7, K7c) and the beam's select.
//
// They serve stjep_tpu/ops/decode_flash.py `decode_head` /
// `decode_head_gather` (K7, body `_head_kernel` -> `_head_topk`: layernorm
// and GEMM in gemm.cu, then head_topk here), `decode_chain_step_flash` (K3,
// body `_chain_kernel`: the fused K5 per layer, then K7), the general beam
// loop's select (`beam_select`, the k^2 -> k update of
// `_beam_step_kernel`) and the tensor-parallel trio K6a-c below. K5
// (`decoder_layer_step_flash`) and K4 (`decode_beam_step_flash`) are one
// cooperative launch each in decode_fused.cu, which runs the same
// attention bodies (attend.cuh) and the same head top-K and select
// (head_select.cuh) as phases of its persistent grid.
//
// Cache semantics are the TPU kernel's: self caches [K, B, Lpad, D] per
// layer are never reordered; row r = b*K + k writes its new K/V row at
// `pos` in slot (k, b), and reads position l from slot (anc[l, r], b) —
// the ancestry map the beam carries instead of permuting caches. Memory
// K/V stay unexpanded [B, Lk, D]; row r reads batch entry r / K.
//
// What bounds the attention kernels on the H100: at B*K = 80 rows a layer
// reads at most 2 x 80 x 160 x 512 x 4 B = 52 MB of self cache, and the
// launch latency. Design: one warp per (row, head), reading only the live
// prefix 0..pos, a lane per position for the scores (16-byte row loads) and
// a lane per head entry for the context; exact two-pass softmax in shared
// memory (the lengths are short); the warp writes its new K/V row into the
// cache and reads it back at `pos`.
//
// K6a-c, the tensor-parallel trio (`self_attn_step` :348, `cross_attn_step`
// :543, `ffn_step` :622), are launch sequences on these kernels and gemm.cu
// at a head shard's width: each shard of n holds Dq = D/n columns of the
// Q/K/V projections (its caches and memory K/V are [.., Dq]) and D/n heads.
// The attention kernels index every row by their D argument, which is then
// Dq, so the head width d = Dq / (heads/n) = D / heads is the unsharded one
// and the attention's d % 8 == 0 holds as before. The row-parallel
// products (fc, w_2) return partials with no residual: the caller sums the
// shards (ops/decode_flash_tp.py). K7c is `head_topk_partial` below.
//
// bf16 caches (`self_attn_anc_bf16`, `cross_attn_bf16`): the TPU kernels take
// the cache dtype as a parameter (decode_flash.py:795,843-855, and the
// chain and beam kernels' scratch and outputs). Both attention kernels are
// templates over the element type of the self caches or of the memory K/V,
// float or __nv_bfloat16, and round where the JAX cores round: the scaled
// query to the cache type, each q.k product to bf16 before the f32 sum over
// the head's dims (`_self_core` :283-285, `_cross_core` :503-505), p.v summed
// in f32 from the bf16 V (:296-298); softmax, max and sum stay f32. The new
// K/V row is computed in f32 by the product and stored rounded to nearest
// (`__float2bfloat16_rn`), and attention at `pos` reads it back from the
// cache, so it sees the rounded row as the TPU kernel's VMEM buffer does.
// bf16 halves the cache and memory bytes, which bound these kernels at
// B*K = 80 (2 x 6 x 80 x 160 x 512 x 2 B = 157 MB of self cache a position
// at most).

#include "attend.cuh"
#include "head_select.cuh"

namespace {

constexpr int ATT_THREADS = 256;

// One warp per (row, head) item, up to ATT_WARPS items a block (fewer where
// their staging would pass the shared memory a block may opt in to:
// `attn_warps`), item = blockIdx.x * warps + warp, row = item / nh, head =
// item % nh (attend.cuh `self_attend`, `cross_attend`).
constexpr int ATT_WARPS = ATT_THREADS / 32;

template <typename T>
__global__ void __launch_bounds__(ATT_THREADS) self_attn_kernel(
    const float* __restrict__ q, const float* __restrict__ knew,
    const float* __restrict__ vnew, T* ck, T* cv, const int* __restrict__ anc,
    const int* __restrict__ maskk, float* __restrict__ out, int pos, int BK,
    int K, int Lpad, int D, int d, int nh) {
  extern __shared__ float sm[];
  const int warp = threadIdx.x >> 5, it = blockIdx.x * (blockDim.x >> 5) + warp;
  if (it >= BK * nh) return;
  const int r = it / nh, h = it % nh;
  const size_t o = (size_t)r * D + (size_t)h * d;
  self_attend<T>([&](int t) { return q[o + t]; }, [&](int t) { return knew[o + t]; },
                 [&](int t) { return vnew[o + t]; }, ck, cv, anc, maskk, out, pos,
                 BK, K, Lpad, D, d, r, h, sm + warp * attend_smem_floats(d, pos + 1));
}

template <typename T>
__global__ void __launch_bounds__(ATT_THREADS) cross_attn_kernel(
    const float* __restrict__ q, const T* __restrict__ mk,
    const T* __restrict__ mv, const int* __restrict__ memmask,
    float* __restrict__ out, int BK, int K, int Lk, int D, int d, int nh) {
  extern __shared__ float sm[];
  const int warp = threadIdx.x >> 5, it = blockIdx.x * (blockDim.x >> 5) + warp;
  if (it >= BK * nh) return;
  const int r = it / nh, h = it % nh;
  const size_t o = (size_t)r * D + (size_t)h * d;
  cross_attend<T>([&](int t) { return q[o + t]; }, mk, mv, memmask, out, BK, K, Lk,
                  D, d, r, h, sm + warp * attend_smem_floats(d, Lk));
}

__global__ void head_topk_kernel(const float* __restrict__ logits,
                                 const int* __restrict__ gid,
                                 float* __restrict__ sc, int* __restrict__ ids,
                                 float* __restrict__ glp,
                                 float* __restrict__ mx_o,
                                 float* __restrict__ se_o, int V, int K) {
  head_topk_row(logits, gid, sc, ids, glp, mx_o, se_o, V, K, blockIdx.x);
}

__global__ void beam_select_kernel(
    const float* __restrict__ sc_k, const int* __restrict__ id_k,
    const float* __restrict__ scores, const int* __restrict__ eos,
    const float* __restrict__ lenm, const int* __restrict__ preds,
    const int* __restrict__ anc, const int* __restrict__ maskk,
    int* __restrict__ preds_o, int* __restrict__ anc_o,
    int* __restrict__ maskk_o, int* __restrict__ tok_o,
    float* __restrict__ scores_o, int* __restrict__ eos_o,
    float* __restrict__ lenm_o, int* __restrict__ flag, int i, int K,
    int Lbuf, float pf) {
  select_group(sc_k, id_k, scores, eos, lenm, preds, anc, maskk, preds_o, anc_o,
               maskk_o, tok_o, scores_o, eos_o, lenm_o, flag, i, gridDim.x, K, Lbuf,
               pf, blockIdx.x);
}

// Warps a block of the attention kernels runs at head width d over n
// positions with `most` bytes of dynamic shared memory allowed
// (`smem_allow_max`): ATT_WARPS, or as many items as it stages; 0 where
// not even one fits (n past ~19 000 at d = 64).
int attn_warps(int most, int d, int n) {
  const size_t w = (size_t)most / (attend_smem_floats(d, n) * sizeof(float));
  return w < (size_t)ATT_WARPS ? (int)w : ATT_WARPS;
}

// d a multiple of 8 (16-byte row loads)
bool attn_ok(int D, int nh) { return nh > 0 && D % nh == 0 && (D / nh) % 8 == 0; }

template <typename T>
int self_attn_launch(const float* q, const float* knew, const float* vnew,
                     T* ck, T* cv, const int* anc, const int* maskk, float* out,
                     int pos, int BK, int K, int Lpad, int D, int nh,
                     cudaStream_t stream) {
  if (!attn_ok(D, nh) || pos < 0 || pos >= Lpad) return (int)cudaErrorInvalidValue;
  int most = 0;
  const cudaError_t e = smem_allow_max((const void*)self_attn_kernel<T>, &most);
  if (e != cudaSuccess) return (int)e;
  const int d = D / nh, warps = attn_warps(most, d, pos + 1);
  if (!warps) return (int)cudaErrorInvalidValue;
  self_attn_kernel<T><<<(BK * nh + warps - 1) / warps, warps * 32,
                        warps * attend_smem_floats(d, pos + 1) * sizeof(float), stream>>>(
      q, knew, vnew, ck, cv, anc, maskk, out, pos, BK, K, Lpad, D, d, nh);
  STJEP_RETURN_LAUNCH_STATUS();
}

template <typename T>
int cross_attn_launch(const float* q, const T* mk, const T* mv,
                      const int* memmask, float* out, int BK, int K, int Lk,
                      int D, int nh, cudaStream_t stream) {
  if (!attn_ok(D, nh)) return (int)cudaErrorInvalidValue;
  int most = 0;
  const cudaError_t e = smem_allow_max((const void*)cross_attn_kernel<T>, &most);
  if (e != cudaSuccess) return (int)e;
  const int d = D / nh, warps = attn_warps(most, d, Lk);
  if (!warps) return (int)cudaErrorInvalidValue;
  cross_attn_kernel<T><<<(BK * nh + warps - 1) / warps, warps * 32,
                         warps * attend_smem_floats(d, Lk) * sizeof(float), stream>>>(
      q, mk, mv, memmask, out, BK, K, Lk, D, d, nh);
  STJEP_RETURN_LAUNCH_STATUS();
}

}  // namespace

extern "C" int self_attn_anc(const float* q, const float* knew,
                             const float* vnew, float* ck, float* cv,
                             const int* anc, const int* maskk, float* out,
                             int pos, int BK, int K, int Lpad, int D, int nh,
                             cudaStream_t stream) {
  return self_attn_launch(q, knew, vnew, ck, cv, anc, maskk, out, pos, BK, K,
                          Lpad, D, nh, stream);
}

extern "C" int self_attn_anc_bf16(const float* q, const float* knew,
                                  const float* vnew, __nv_bfloat16* ck,
                                  __nv_bfloat16* cv, const int* anc,
                                  const int* maskk, float* out, int pos, int BK,
                                  int K, int Lpad, int D, int nh,
                                  cudaStream_t stream) {
  return self_attn_launch(q, knew, vnew, ck, cv, anc, maskk, out, pos, BK, K,
                          Lpad, D, nh, stream);
}

extern "C" int cross_attn(const float* q, const float* mk, const float* mv,
                          const int* memmask, float* out, int BK, int K,
                          int Lk, int D, int nh, cudaStream_t stream) {
  return cross_attn_launch(q, mk, mv, memmask, out, BK, K, Lk, D, nh, stream);
}

extern "C" int cross_attn_bf16(const float* q, const __nv_bfloat16* mk,
                               const __nv_bfloat16* mv, const int* memmask,
                               float* out, int BK, int K, int Lk, int D, int nh,
                               cudaStream_t stream) {
  return cross_attn_launch(q, mk, mv, memmask, out, BK, K, Lk, D, nh, stream);
}

// gid and glp may be null (no gather).
extern "C" int head_topk(const float* logits, const int* gid, float* sc,
                         int* ids, float* glp, int BK, int V, int K,
                         cudaStream_t stream) {
  if (K < 1 || K > MAX_BEAM || K > V) return (int)cudaErrorInvalidValue;
  head_topk_kernel<<<BK, V >= 4096 ? 1024 : 256, 0, stream>>>(
      logits, gid, sc, ids, glp, nullptr, nullptr, V, K);
  STJEP_RETURN_LAUNCH_STATUS();
}

// K7c: one vocabulary shard [BK, V] of a tensor-parallel head; raw top-K
// logits and local ids, mx, se, and (gid and glog given, else null) the raw
// logit at the shard-local id. K may exceed V (see head_topk_kernel).
extern "C" int head_topk_partial(const float* logits, const int* gid, float* sc,
                                 int* ids, float* glog, float* mx, float* se,
                                 int BK, int V, int K, cudaStream_t stream) {
  if (K < 1 || K > MAX_BEAM || V < 1) return (int)cudaErrorInvalidValue;
  head_topk_kernel<<<BK, V >= 4096 ? 1024 : 256, 0, stream>>>(
      logits, gid, sc, ids, glog, mx, se, V, K);
  STJEP_RETURN_LAUNCH_STATUS();
}

extern "C" int beam_select(const float* sc_k, const int* id_k,
                           const float* scores, const int* eos,
                           const float* lenm, const int* preds, const int* anc,
                           const int* maskk, int* preds_o, int* anc_o,
                           int* maskk_o, int* tok_o, float* scores_o,
                           int* eos_o, float* lenm_o, int* flag, int i, int B,
                           int K, int Lbuf, float pf, cudaStream_t stream) {
  if (K > MAX_BEAM) return (int)cudaErrorInvalidValue;
  beam_select_kernel<<<B, 256, 0, stream>>>(
      sc_k, id_k, scores, eos, lenm, preds, anc, maskk, preds_o, anc_o, maskk_o,
      tok_o, scores_o, eos_o, lenm_o, flag, i, K, Lbuf, pf);
  STJEP_RETURN_LAUNCH_STATUS();
}
