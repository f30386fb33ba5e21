// The decode head's top-K over one logit row, and the beam's k^2 -> k
// select for one batch item: device functions that take the whole block,
// shared by decode.cu's kernels (`head_topk`, `beam_select`: one row or
// item per block) and the fused kernels of decode_fused.cu (K4) and
// decode_chain.cu (K3, K7c): a block walks over rows or batch items.
#pragma once

#include "common.cuh"

namespace {

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
// partial branch :1559-1592), is the same row top-K with mx and se given
// (decode_chain.cu's head_step_kernel runs it after its own LayerNorm and
// product phases): the row is one vocabulary shard of a tensor-parallel
// head, and the caller merges the shards (ops/decode_flash_tp.py
// decode_head_tp). It writes the RAW top-K logits with their local ids, the
// row max mx and se = sum exp(l - mx) (the online pass's own (m, z),
// combined at the block max), and the raw logit at gid, 0 for an id
// outside [0, V) (the id arrives offset into the shard, so an id of
// another shard is negative or >= V). A shard may hold fewer than K ids:
// the passes past V write -1e30 at id 0, the candidates the TPU kernel's
// repeated max extraction gives once every logit is taken. Bounds: the
// [BK, V/n] logit row once from L2 and 4 + 2K floats out, so the head's
// product ([D, V/n]) dominates.
//
// head_topk_row does row r of the logits for the whole block.
__device__ void head_topk_row(const float* __restrict__ logits,
                              const int* __restrict__ gid,
                              float* __restrict__ sc, int* __restrict__ ids,
                              float* __restrict__ glp, float* __restrict__ mx_o,
                              float* __restrict__ se_o, int V, int K, int r) {
  __shared__ float rv[32];
  __shared__ int ri[32];
  __shared__ float red[32];
  __shared__ int taken[MAX_BEAM];
  __shared__ float glog;
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
// select_group does batch item b of B for the whole block. anc is read
// through the coherent path: the fused beam step writes anc[pos] earlier in
// the same launch.
__device__ void select_group(
    const float* __restrict__ sc_k, const int* __restrict__ id_k,
    const float* __restrict__ scores, const int* __restrict__ eos,
    const float* __restrict__ lenm, const int* __restrict__ preds,
    const int* anc, const int* __restrict__ maskk,
    int* __restrict__ preds_o, int* __restrict__ anc_o,
    int* __restrict__ maskk_o, int* __restrict__ tok_o,
    float* __restrict__ scores_o, int* __restrict__ eos_o,
    float* __restrict__ lenm_o, int* __restrict__ flag, int i, int B, int K,
    int Lbuf, float pf, int b) {
  __shared__ float st[MAX_BEAM * MAX_BEAM];
  __shared__ int src_s[MAX_BEAM], tok_s[MAX_BEAM];
  __shared__ float sel_s[MAX_BEAM];
  const int BK = B * K;
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

}  // namespace
