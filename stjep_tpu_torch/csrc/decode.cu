// The decode kernel that runs as a launch of its own: the beam's select.
//
// It serves the general beam loop's select (`beam_select`, the k^2 -> k
// update of stjep_tpu/ops/decode_flash.py `_beam_step_kernel`). K3
// (`decode_chain_step_flash`), K4 (`decode_beam_step_flash`), K5
// (`decoder_layer_step_flash`), the tensor-parallel trio K6a-c and the
// decode heads K7a/K7b (`decode_head`, `decode_head_gather`) and K7c
// (`decode_head_partial`) are one cooperative launch each in
// decode_fused.cu and decode_chain.cu, which run the attention bodies
// (attend.cuh), the head top-K and the same select (head_select.cuh) as
// phases of their persistent grids.

#include "head_select.cuh"

namespace {

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

}  // namespace

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
