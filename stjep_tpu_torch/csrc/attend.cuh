// Decode attention for one (row, head) by one warp: the bodies of the
// attention phases of the fused layer step (K5), beam step (K4) and shard
// steps (K6a, K6b) in decode_fused.cu. A warp per item keeps every
// (row, head) of a phase in flight at once: an item is a chain of
// dependent loads (the scores, then the context), so the phase takes about
// one item's latency. Numerics follow stjep_tpu/ops/decode_flash.py
// `_self_core` :144 and `_cross_core` :431.
//
// Cache semantics are the TPU kernel's: self caches [K, B, Lpad, D] per
// layer are never reordered; row r = b*K + k writes its new K/V row at
// `pos` in slot (k, b), and reads position l from slot (anc[l, r], b) —
// the ancestry map the beam carries instead of permuting caches. Memory
// K/V stay unexpanded [B, Lk, D]; row r reads batch entry r / K. A lane per
// position for the scores (16-byte row loads where the head width allows),
// a lane per head entry for the context; exact two-pass softmax in shared
// memory (the lengths are short); the warp writes its new K/V row into the
// cache and reads it back at `pos`.
//
// bf16 caches: the TPU kernels take the cache dtype as a parameter
// (decode_flash.py:795,843-855). The bodies are templates over the element
// type of the self caches or of the memory K/V, float or __nv_bfloat16, and
// round where the JAX cores round: the scaled query to the cache type, each
// q.k product to bf16 before the f32 sum over the head's dims (`_self_core`
// :283-285, `_cross_core` :503-505), p.v summed in f32 from the bf16 V
// (:296-298); softmax, max and sum stay f32. The new K/V row is computed in
// f32 and stored rounded to nearest (`__float2bfloat16_rn`), and attention
// at `pos` reads it back from the cache, so it sees the rounded row as the
// TPU kernel's VMEM buffer does.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

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

// q . k over one head's d entries: qs (the scaled query, shared memory)
// against a cache row kp, summed in order of the entries: 16 bytes a load
// where d % 8 == 0 (then every row starts 16-byte aligned), else an entry
// a load (head widths such as 6; the same sum in the same order).
__device__ __forceinline__ float dot_row(const float* qs, const float* kp, int d) {
  float acc = 0.f;
  if (d % 8) {
    for (int t = 0; t < d; ++t) acc = dot_step(qs[t], kp[t], acc);
    return acc;
  }
  for (int t = 0; t < d; t += 4) {
    const float4 k = *reinterpret_cast<const float4*>(kp + t);
    acc = dot_step(qs[t], k.x, acc);
    acc = dot_step(qs[t + 1], k.y, acc);
    acc = dot_step(qs[t + 2], k.z, acc);
    acc = dot_step(qs[t + 3], k.w, acc);
  }
  return acc;
}
__device__ __forceinline__ float dot_pair(const float* qs, unsigned u, float acc) {
  acc = dot_step(qs[0], __ushort_as_bfloat16((unsigned short)(u & 0xffffu)), acc);
  return dot_step(qs[1], __ushort_as_bfloat16((unsigned short)(u >> 16)), acc);
}
__device__ __forceinline__ float dot_row(const float* qs, const __nv_bfloat16* kp, int d) {
  float acc = 0.f;
  if (d % 8) {
    for (int t = 0; t < d; ++t) acc = dot_step(qs[t], kp[t], acc);
    return acc;
  }
  for (int t = 0; t < d; t += 8) {
    const uint4 k = *reinterpret_cast<const uint4*>(kp + t);  // entries t .. t+7
    acc = dot_pair(qs + t, k.x, acc);
    acc = dot_pair(qs + t + 2, k.y, acc);
    acc = dot_pair(qs + t + 4, k.z, acc);
    acc = dot_pair(qs + t + 6, k.w, acc);
  }
  return acc;
}

// One warp's attention over n positions: s[l] = q . krow(l) (a lane per
// position), or -1e9 where valid[l] == 0; softmax over s in shared memory;
// then out[t] = sum_l p[l] * vrow(l)[t] (a lane per entry t < d, summed in
// order of l).
template <typename KRow, typename VRow>
__device__ void warp_attend(const float* qs, int n, int d, KRow krow, VRow vrow,
                            const int* valid, float* s, float* out) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
  for (int l = lane; l < n; l += 32) {
    const float v = valid[l] ? dot_row(qs, krow(l), d) : -1e9f;
    s[l] = v;
    m = fmaxf(m, v);
  }
  m = warp_max(m);
  float z = 0.f;
  for (int l = lane; l < n; l += 32) z += expf(s[l] - m);
  z = warp_sum(z);
  for (int l = lane; l < n; l += 32) s[l] = expf(s[l] - m) / z;
  __syncwarp();
  for (int t = lane; t < d; t += 32) {
    float acc = 0.f;
#pragma unroll 8
    for (int l = 0; l < n; ++l) acc = fmaf(s[l], to_f(vrow(l)[t]), acc);
    out[t] = acc;
  }
  __syncwarp();
}

// Shared floats a warp's item needs at n positions: qs[d], s[n] and two
// int arrays [n].
__host__ __device__ inline int attend_smem_floats(int d, int n) { return d + 3 * n; }

// Self-attention of row r, head h over positions 0..pos through the
// ancestry map, by one warp; masked keys (maskk == 0) score -1e9, so a
// fully masked row becomes uniform attention, never NaN. qv(t), kv(t),
// vv(t) give the row's unscaled query and new K/V (f32) at column h*d + t.
// The warp first stores its new K/V row into its own slot at `pos`, in the
// cache type, and stages the ancestry column and mask of the row in shared
// memory (slot[pos] = own); after the warp's barrier every position, `pos`
// included, is read from the cache. No other item reads that slice at
// `pos`: each row reads position pos from its own slot. `sm` holds
// attend_smem_floats(d, pos + 1).
template <typename T, typename Q, typename KN, typename VN>
__device__ void self_attend(Q qv, KN kv, VN vv, T* ck, T* cv,
                            const int* __restrict__ anc,
                            const int* __restrict__ maskk, float* out, int pos,
                            int BK, int K, int Lpad, int D, int d, int r, int h,
                            float* sm) {
  const int n = pos + 1;
  const int lane = threadIdx.x & 31;
  float* qs = sm;                          // [d]
  float* s = qs + d;                       // [n]
  int* slot = (int*)(s + n);               // [n]
  int* valid = slot + n;                   // [n]
  const int B = BK / K, b = r / K, own = r % K;
  const size_t hoff = (size_t)h * d;
  const float temp = sqrtf((float)d);
  for (int t = lane; t < d; t += 32) {
    qs[t] = in_type<T>(qv(t) / temp);
    const size_t dst = (((size_t)own * B + b) * Lpad + pos) * D + hoff + t;
    store(ck + dst, kv(t));
    store(cv + dst, vv(t));
  }
  for (int l = lane; l < n; l += 32) {
    slot[l] = l == pos ? own : anc[(size_t)l * BK + r];
    valid[l] = maskk[(size_t)l * BK + r];
  }
  __syncwarp();
  const size_t lstride = (size_t)Lpad * D;
  auto row = [&](const T* c, int l) -> const T* {
    return c + ((size_t)slot[l] * B + b) * lstride + (size_t)l * D + hoff;
  };
  warp_attend(qs, n, d, [&](int l) { return row(ck, l); }, [&](int l) { return row(cv, l); },
              valid, s, out + (size_t)r * D + hoff);
}

// Cross-attention of row r, head h over the unexpanded memory of batch
// entry r / K, by one warp; padded memory positions are masked (memmask
// [Lk, B]). qv(t) gives the row's unscaled query at column h*d + t. `sm`
// holds attend_smem_floats(d, Lk).
template <typename T, typename Q>
__device__ void cross_attend(Q qv, const T* __restrict__ mk,
                             const T* __restrict__ mv,
                             const int* __restrict__ memmask, float* out,
                             int BK, int K, int Lk, int D, int d, int r, int h,
                             float* sm) {
  const int lane = threadIdx.x & 31;
  float* qs = sm;
  float* s = qs + d;              // [Lk]
  int* valid = (int*)(s + Lk);    // [Lk]
  const int B = BK / K, b = r / K;
  const size_t hoff = (size_t)h * d;
  const float temp = sqrtf((float)d);
  for (int t = lane; t < d; t += 32) qs[t] = in_type<T>(qv(t) / temp);
  for (int l = lane; l < Lk; l += 32) valid[l] = memmask[(size_t)l * B + b];
  __syncwarp();
  const T* kb = mk + (size_t)b * Lk * D + hoff;
  const T* vb = mv + (size_t)b * Lk * D + hoff;
  warp_attend(qs, Lk, d, [&](int l) { return kb + (size_t)l * D; },
              [&](int l) { return vb + (size_t)l * D; }, valid, s, out + (size_t)r * D + hoff);
}

}  // namespace
