// K3 / K4 / K5 / K7: the transformer decode-step kernels.
//
// They replace stjep_tpu/ops/decode_flash.py `decoder_layer_step_flash`
// (K5, body `_layer_kernel`: `_self_core`, `_cross_core`, `_ffn_core`),
// `decode_head` / `decode_head_gather` (K7, body `_head_kernel` ->
// `_head_topk`), `decode_chain_step_flash` (K3, body `_chain_kernel`: every
// layer's cores, then `_head_topk`) and `decode_beam_step_flash` (K4, body
// `_beam_step_kernel`). On the TPU each was one launch. Here K5 is a chain
// of launches — layernorm, GEMMs (gemm.cu), and the two attention kernels
// below; K7 is layernorm, GEMM and head_topk; K3 is K5 per layer then K7;
// K4 is embed_time, K3's layers and head, then beam_select, which the
// general beam loop also launches alone after its own decode position.
//
// Cache semantics are the TPU kernel's: self caches [K, B, Lpad, D] per
// layer are never reordered; row r = b*K + k writes its new K/V row at
// `pos` in slot (k, b), and reads position l from slot (anc[l, r], b) —
// the ancestry map the beam carries instead of permuting caches. Memory
// K/V stay unexpanded [B, Lk, D]; row r reads batch entry r / K.
//
// What bounds it on the H100: at B*K = 80 rows a position reads every
// decoder weight once (6 layers x 4.2M f32 = 100 MB) and at most
// 2 x 6 x 80 x 160 x 512 x 4 B = 315 MB of self cache, so a step is bound by
// memory bandwidth and by the launch latency of ~80 launches. Design: one
// block per (row, head) in the attention kernels, reading only the live
// prefix 0..pos; exact two-pass softmax in shared memory (the lengths are
// short); the new K/V row is used from registers at `pos` and written to
// the cache in the same kernel. Fusing a layer into fewer launches and CUDA
// graphs are later work.
//
// K6a-c, the tensor-parallel trio (`self_attn_step` :348, `cross_attn_step`
// :543, `ffn_step` :622), are launch sequences on these kernels and gemm.cu
// at a head shard's width: each shard of n holds Dq = D/n columns of the
// Q/K/V projections (its caches and memory K/V are [.., Dq]) and D/n heads.
// The attention kernels index every row by their D argument, which is then
// Dq, so the head width d = Dq / (heads/n) = D / heads is the unsharded one
// and softmax_context's blockDim % d == 0 holds as before. The row-parallel
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
// K/V row is computed in f32 by the GEMM and stored rounded to nearest
// (`__float2bfloat16_rn`), and attention at `pos` reads it back from the
// cache, so it sees the rounded row as the TPU kernel's VMEM buffer does.
// bf16 halves the cache and memory bytes, which bound these kernels at
// B*K = 80 (2 x 6 x 80 x 160 x 512 x 2 B = 157 MB of self cache a position
// at most); the loads are 2 bytes a thread, a later PR can widen them.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int ATT_THREADS = 256;

// x[r] = table[tok[r]] * (tok[r] != PAD) + tsig[pos]; anc[pos, r] = r % K
// (the K/V this step writes lives in the row itself); flag = 1, to be
// and-ed with each group's all-EOS bit by beam_select.
__global__ void embed_time_kernel(const float* __restrict__ table,
                                  const int* __restrict__ tok,
                                  const float* __restrict__ tsig,
                                  float* __restrict__ x, int* __restrict__ anc,
                                  int* __restrict__ flag, int pos, int BK,
                                  int K, int D) {
  const int r = blockIdx.x;
  const int t = tok[r];
  const float keep = t != STJEP_PAD ? 1.f : 0.f;
  for (int c = threadIdx.x; c < D; c += blockDim.x)
    x[(size_t)r * D + c] = table[(size_t)t * D + c] * keep + tsig[(size_t)pos * D + c];
  if (threadIdx.x == 0) {
    anc[(size_t)pos * BK + r] = r % K;
    if (flag && r == 0) *flag = 1;
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// Store v into the cache element type, rounded to nearest.
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The value x takes in element type T (the scaled query's rounding).
template <typename T>
__device__ __forceinline__ float in_type(float x) { return x; }
template <>
__device__ __forceinline__ float in_type<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// acc + q * k: one fused step in f32; for bf16 the product is rounded to
// bf16 first (exact in f32, then rounded once), as the TPU core's bf16
// elementwise product before its f32-accumulating head sum.
__device__ __forceinline__ float dot_step(float q, float k, float acc) {
  return fmaf(q, k, acc);
}
__device__ __forceinline__ float dot_step(float q, __nv_bfloat16 k, float acc) {
  return acc + __bfloat162float(__float2bfloat16_rn(q * __bfloat162float(k)));
}

// Softmax over s[0..n) in shared memory, then the context
// out[t] = sum_l p[l] * vrow(l)[t] for t < d. Threads split as
// G = blockDim / d groups over l; `part` holds blockDim floats.
template <typename VRow>
__device__ void softmax_context(float* s, int n, int d, VRow vrow,
                                float* part, float* red, float* out) {
  float m = -INFINITY;
  for (int l = threadIdx.x; l < n; l += blockDim.x) m = fmaxf(m, s[l]);
  m = block_max(m, red);
  float z = 0.f;
  for (int l = threadIdx.x; l < n; l += blockDim.x) z += expf(s[l] - m);
  z = block_sum(z, red);
  for (int l = threadIdx.x; l < n; l += blockDim.x) s[l] = expf(s[l] - m) / z;
  __syncthreads();
  const int G = blockDim.x / d;
  const int t = threadIdx.x % d, g = threadIdx.x / d;
  float acc = 0.f;
#pragma unroll 4
  for (int l = g; l < n; l += G) acc = fmaf(s[l], to_f(vrow(l)[t]), acc);
  part[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < d) {
    float v = 0.f;
    for (int j = 0; j < G; ++j) v += part[j * d + threadIdx.x];
    out[threadIdx.x] = v;
  }
}

// s[l] = q . krow(l) for l < n (one warp per position, lanes over d), or
// -1e9 where valid[l] == 0. qs is the scaled query in shared memory.
template <typename KRow>
__device__ void scores(const float* qs, int n, int d, KRow krow,
                       const int* valid, float* s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll 2
  for (int l = warp; l < n; l += nw) {
    const auto* kp = krow(l);
    float acc = 0.f;
    for (int t = lane; t < d; t += 32) acc = dot_step(qs[t], kp[t], acc);
    acc = warp_sum(acc);
    if (lane == 0) s[l] = valid[l] ? acc : -1e9f;
  }
}

// Self-attention of one (row, head) over positions 0..pos through the
// ancestry map; masked keys (maskk == 0) score -1e9, so a fully masked
// row becomes uniform attention, never NaN. The block first stores its new
// K/V row (f32 from the GEMM) into its own slot at `pos`, in the cache
// type, and stages the ancestry column and mask of the row in shared memory
// (slot[pos] = own); after the barrier every position, `pos` included, is
// read from the cache. No other block reads that slice at `pos`: each row
// reads position pos from its own slot.
template <typename T>
__global__ void __launch_bounds__(ATT_THREADS) self_attn_kernel(
    const float* __restrict__ q, const float* __restrict__ knew,
    const float* __restrict__ vnew, T* ck, T* cv, const int* __restrict__ anc,
    const int* __restrict__ maskk, float* __restrict__ out, int pos, int BK,
    int K, int Lpad, int D, int d) {
  extern __shared__ float sm[];
  const int n = pos + 1;
  float* qs = sm;                          // [d]
  float* part = qs + d;                    // [blockDim]
  float* s = part + blockDim.x;            // [n]
  int* slot = (int*)(s + n);               // [n]
  int* valid = slot + n;                   // [n]
  __shared__ float red[32];
  const int r = blockIdx.x, h = blockIdx.y;
  const int B = BK / K, b = r / K, own = r % K;
  const size_t hoff = (size_t)h * d;
  const float temp = sqrtf((float)d);
  for (int t = threadIdx.x; t < d; t += blockDim.x) {
    qs[t] = in_type<T>(q[(size_t)r * D + hoff + t] / temp);
    const size_t dst = (((size_t)own * B + b) * Lpad + pos) * D + hoff + t;
    store(ck + dst, knew[(size_t)r * D + hoff + t]);
    store(cv + dst, vnew[(size_t)r * D + hoff + t]);
  }
  for (int l = threadIdx.x; l < n; l += blockDim.x) {
    slot[l] = l == pos ? own : anc[(size_t)l * BK + r];
    valid[l] = maskk[(size_t)l * BK + r];
  }
  __syncthreads();
  const size_t lstride = (size_t)Lpad * D;
  auto row = [&](const T* c, int l) -> const T* {
    return c + ((size_t)slot[l] * B + b) * lstride + (size_t)l * D + hoff;
  };
  scores(qs, n, d, [&](int l) { return row(ck, l); }, valid, s);
  __syncthreads();
  softmax_context(s, n, d, [&](int l) { return row(cv, l); }, part, red,
                  out + (size_t)r * D + hoff);
}

// Cross-attention of one (row, head) over the unexpanded memory of batch
// entry r / K; padded memory positions are masked (memmask [Lk, B]).
template <typename T>
__global__ void __launch_bounds__(ATT_THREADS) cross_attn_kernel(
    const float* __restrict__ q, const T* __restrict__ mk,
    const T* __restrict__ mv, const int* __restrict__ memmask,
    float* __restrict__ out, int BK, int K, int Lk, int D, int d) {
  extern __shared__ float sm[];
  float* qs = sm;
  float* part = qs + d;
  float* s = part + blockDim.x;   // [Lk]
  int* valid = (int*)(s + Lk);    // [Lk]
  __shared__ float red[32];
  const int r = blockIdx.x, h = blockIdx.y;
  const int B = BK / K, b = r / K;
  const size_t hoff = (size_t)h * d;
  const float temp = sqrtf((float)d);
  for (int t = threadIdx.x; t < d; t += blockDim.x)
    qs[t] = in_type<T>(q[(size_t)r * D + hoff + t] / temp);
  for (int l = threadIdx.x; l < Lk; l += blockDim.x)
    valid[l] = memmask[(size_t)l * B + b];
  __syncthreads();
  const T* kb = mk + (size_t)b * Lk * D + hoff;
  const T* vb = mv + (size_t)b * Lk * D + hoff;
  scores(qs, Lk, d, [&](int l) { return kb + (size_t)l * D; }, valid, s);
  __syncthreads();
  softmax_context(s, Lk, d, [&](int l) { return vb + (size_t)l * D; }, part,
                  red, out + (size_t)r * D + hoff);
}

constexpr int MAX_BEAM = 16;

// K7, the decode head after its layernorm and GEMM (`_head_topk`, and the
// gather of `_head_kernel`): one row per block. The logit row is read from
// global memory, where L2 holds it (120 KB at a 30 000-word vocabulary), so
// V has no bound. One pass gives the log-sum-exp (each thread keeps an
// online max and a sum rescaled to it; the block combines them) and picks up
// logit[gid] for glp = logit[gid] - lse (0 - lse for an id outside [0, V),
// as the TPU kernel's masked sum gives). Then K arg-max passes with the
// lowest index winning ties (jax.lax.top_k's order); each pass skips the ids
// already taken, held in a shared list of at most MAX_BEAM, so the row is
// never written.
//
// K7c, `decode_head_partial` (decode_flash.py:1666, `_head_kernel`'s
// partial branch :1559-1592), is the same kernel with mx and se given: the
// row is one vocabulary shard of a tensor-parallel head, and the caller
// merges the shards (ops/decode_flash_tp.py decode_head_tp). It writes the
// RAW top-K logits with their local ids, the row max mx and se = sum
// exp(l - mx) (the online pass's own (m, z), combined at the block max),
// and the raw logit at gid, 0 for an id outside [0, V) (the id arrives
// offset into the shard, so an id of another shard is negative or >= V).
// A shard may hold fewer than K ids: the passes past V write -1e30 at id 0,
// the candidates the TPU kernel's repeated max extraction gives once every
// logit is taken. Bounds: the [BK, V/n] logit row once from L2 and 4 + 2K
// floats out, so the head's GEMM (layernorm, then [D, V/n]) dominates.
__global__ void head_topk_kernel(const float* __restrict__ logits,
                                 const int* __restrict__ gid,
                                 float* __restrict__ sc, int* __restrict__ ids,
                                 float* __restrict__ glp,
                                 float* __restrict__ mx_o,
                                 float* __restrict__ se_o, int V, int K) {
  __shared__ float rv[32];
  __shared__ int ri[32];
  __shared__ float red[32];
  __shared__ int taken[MAX_BEAM];
  __shared__ float glog;
  const int r = blockIdx.x;
  const float* x = logits + (size_t)r * V;
  const int g = gid ? gid[r] : -1;
  if (threadIdx.x == 0) glog = 0.f;
  __syncthreads();
  float m = -INFINITY, z = 0.f;
  for (int c = threadIdx.x; c < V; c += blockDim.x) {
    const float v = x[c];
    if (v > m) {
      z = z * expf(m - v) + 1.f;
      m = v;
    } else {
      z += expf(v - m);
    }
    if (c == g) glog = v;
  }
  const float mx = block_max(m, red);
  const float se = block_sum(m == -INFINITY ? 0.f : z * expf(m - mx), red);
  const bool partial = mx_o != nullptr;
  const float lse = partial ? 0.f : mx + logf(se);  // partial: raw logits out
  if (threadIdx.x == 0) {
    if (glp) glp[r] = glog - lse;
    if (partial) {
      mx_o[r] = mx;
      se_o[r] = se;
    }
  }
  for (int k = 0; k < K; ++k) {
    if (k >= V) {  // a shard narrower than K (partial only)
      if (threadIdx.x == 0) {
        sc[(size_t)r * K + k] = -1e30f;
        ids[(size_t)r * K + k] = 0;
      }
      continue;
    }
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int c = threadIdx.x; c < V; c += blockDim.x) {
      const float v = x[c];
      if (!better(v, c, bv, bi)) continue;
      bool was_taken = false;
      for (int j = 0; j < k; ++j) was_taken |= taken[j] == c;
      if (!was_taken) { bv = v; bi = c; }
    }
    block_argmax(bv, bi, rv, ri);
    if (threadIdx.x == 0) {
      sc[(size_t)r * K + k] = bv - lse;
      ids[(size_t)r * K + k] = bi;
      taken[k] = bi;
    }
    __syncthreads();
  }
}

// The k^2 -> k beam update for one batch item per block, transcribing
// stjep_tpu/infer/beam.py body() / decode_flash.py `_beam_step_kernel`:
// EOS rows contribute one candidate (column 0 at +0, the rest -1e9);
// candidates are ranked by score / lenm^pf; top-K over flat index j*K + c
// with the lowest index winning ties; the kept score is multiplied back by
// the OLD slot's penalty; eos/lenm stay slot-indexed; preds, anc and maskk
// are back-copied from the source rows; the caches are never touched.
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
  __shared__ float st[MAX_BEAM * MAX_BEAM];
  __shared__ int src_s[MAX_BEAM], tok_s[MAX_BEAM];
  __shared__ float sel_s[MAX_BEAM];
  const int b = blockIdx.x;
  const int BK = gridDim.x * K;
  if (threadIdx.x == 0) {
    for (int j = 0; j < K; ++j) {
      const int r = b * K + j;
      const float lp = pf == 1.f ? lenm[r] : powf(lenm[r], pf);
      for (int c = 0; c < K; ++c) {
        const float smk = eos[r] ? (c == 0 ? 0.f : -1e9f) : sc_k[r * K + c];
        st[j * K + c] = (scores[r] + smk) / lp;
      }
    }
    bool all_eos = true;
    for (int slot = 0; slot < K; ++slot) {
      float bv = -INFINITY;
      int bf = 0;
      for (int f = 0; f < K * K; ++f)
        if (st[f] > bv) { bv = st[f]; bf = f; }
      st[bf] = -1e30f;
      const int src = b * K + bf / K;
      const int tok = id_k[src * K + bf % K];
      src_s[slot] = src;
      tok_s[slot] = tok;
      sel_s[slot] = bv;
      const int s = b * K + slot;
      const float lp_old = pf == 1.f ? lenm[s] : powf(lenm[s], pf);
      const int e = (eos[s] || tok == STJEP_EOS) ? 1 : 0;
      scores_o[s] = bv * lp_old;
      tok_o[s] = tok;
      eos_o[s] = e;
      lenm_o[s] = lenm[s] + (e ? 0.f : 1.f);
      all_eos = all_eos && e;
    }
    if (!all_eos) atomicAnd(flag, 0);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < K * Lbuf; e += blockDim.x) {
    const int slot = e / Lbuf, l = e % Lbuf;
    const int s = b * K + slot, src = src_s[slot];
    preds_o[(size_t)s * Lbuf + l] = l == i ? tok_s[slot] : preds[(size_t)src * Lbuf + l];
    anc_o[(size_t)l * BK + s] = anc[(size_t)l * BK + src];
    maskk_o[(size_t)l * BK + s] =
        l == i ? (tok_s[slot] != STJEP_PAD) : maskk[(size_t)l * BK + src];
  }
}

// qs[d] + part[ATT_THREADS] + s[n] + two int arrays [n]
int attn_smem(int d, int n) { return (d + ATT_THREADS + 3 * n) * (int)sizeof(float); }

template <typename T>
int self_attn_launch(const float* q, const float* knew, const float* vnew,
                     T* ck, T* cv, const int* anc, const int* maskk, float* out,
                     int pos, int BK, int K, int Lpad, int D, int nh,
                     cudaStream_t stream) {
  const int d = D / nh;
  if (d > ATT_THREADS || ATT_THREADS % d || attn_smem(d, Lpad) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  self_attn_kernel<T><<<dim3(BK, nh), ATT_THREADS, attn_smem(d, pos + 1), stream>>>(
      q, knew, vnew, ck, cv, anc, maskk, out, pos, BK, K, Lpad, D, d);
  STJEP_RETURN_LAUNCH_STATUS();
}

template <typename T>
int cross_attn_launch(const float* q, const T* mk, const T* mv,
                      const int* memmask, float* out, int BK, int K, int Lk,
                      int D, int nh, cudaStream_t stream) {
  const int d = D / nh;
  if (d > ATT_THREADS || ATT_THREADS % d || attn_smem(d, Lk) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cross_attn_kernel<T><<<dim3(BK, nh), ATT_THREADS, attn_smem(d, Lk), stream>>>(
      q, mk, mv, memmask, out, BK, K, Lk, D, d);
  STJEP_RETURN_LAUNCH_STATUS();
}

}  // namespace

extern "C" int embed_time(const float* table, const int* tok, const float* tsig,
                          float* x, int* anc, int* flag, int pos, int BK, int K,
                          int D, cudaStream_t stream) {
  embed_time_kernel<<<BK, 256, 0, stream>>>(table, tok, tsig, x, anc, flag, pos,
                                            BK, K, D);
  STJEP_RETURN_LAUNCH_STATUS();
}

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
