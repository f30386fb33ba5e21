"""Port vs JAX on CPU: the plain versions of K3 (decode_chain_step) and K4
(decode_beam_step, through the port's beam search) against the JAX
package's dense XLA decode. Scores within 1e-5 (f32 on both sides, only the
summation order differs); ids and tokens equal."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stjep_tpu.config import BOS, EOS, PAD, ModelConfig
from stjep_tpu.infer.beam import _expand_beam
from stjep_tpu.infer.beam import beam_search as jax_beam_search
from stjep_tpu.models.seq2seq import _decode_pos
from stjep_tpu.models.seq2seq import init_seq2seq as jax_init
from stjep_tpu.models.tf_decoder import tf_decoder_init_cache
from stjep_tpu_torch.bridge import params_from_numpy
from stjep_tpu_torch.infer.beam import beam_search
from stjep_tpu_torch.models.seq2seq import _embed_tgt_token
from stjep_tpu_torch.models.tf_decoder import tf_decoder_init_cache_chain
from stjep_tpu_torch.ops.decode_flash import (
    CHAIN_KEYS,
    decode_chain_step_flash,
    decode_chain_step_plain,
    pad_len,
    stack_decoder_layers,
    topk_lowest_index,
)
from stjep_tpu_torch.ops.masks import position_signal

TOL = 1e-5

CFG = ModelConfig(
    enc_vocab_size=50, dec_vocab_size=40, enc_embedding_size=16,
    dec_embedding_size=128, acous_dim=8, acous_hidden_size=64, dim_model=128,
    dim_feedforward=256, num_heads=4, enc_layers=2, dec_layers=2,
    num_unilstm_dec=3, spec_aug=False, dropout=0.0, max_seq_len_src=12,
    max_seq_len_tgt=16, mode="ASR_ST")
B, LK, MAX_LEN = 3, 11, 16


@pytest.fixture(scope="module")
def setup():
    jp = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(0), CFG))
    rng = np.random.RandomState(5)
    enc = rng.randn(B, LK, CFG.dim_model).astype(np.float32)
    mem_mask = np.arange(LK)[None, :] < np.array([11, 6, 9])[:, None]
    return jp, params_from_numpy(jp), enc, mem_mask


def test_topk_lowest_index_matches_lax_top_k():
    x = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0],
                  [0.0, 0.0, 0.0, 0.0, 1.0, 1.0]], np.float32)
    rv, ri = jax.lax.top_k(jnp.asarray(x), 4)
    v, i = topk_lowest_index(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))


def test_stack_and_pad_len(setup):
    _, tp, _, _ = setup
    stacked, quant = stack_decoder_layers(tp["dec_tgt"])
    assert not quant and len(stacked) == len(CHAIN_KEYS)
    assert stacked[2].shape == (CFG.dec_layers, CFG.dim_model, CFG.dim_model)
    assert all(t.is_contiguous() for t in stacked)
    assert (pad_len(150), pad_len(89, 32), pad_len(16)) == (160, 96, 16)


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("step", [decode_chain_step_plain, decode_chain_step_flash])
def test_chain_step_position1_matches_dense(setup, K, step):
    jp, tp, enc, mem_mask = setup
    BK = B * K
    # JAX: dense KV-cached position + lax.top_k
    enc_x = _expand_beam(jnp.asarray(enc), K)
    mask_x = _expand_beam(jnp.asarray(mem_mask), K)
    preds = jnp.full((BK, MAX_LEN), PAD, jnp.int32).at[:, 0].set(BOS)
    cache = tf_decoder_init_cache(jp["dec_tgt"], CFG, enc_x, MAX_LEN)
    logp, _ = _decode_pos(jp, CFG, preds, cache, jnp.int32(0), mask_x, 500,
                          enc_memory=enc_x)
    ref_sc, ref_ids = jax.lax.top_k(logp, K)

    Lpad, Lk_pad = pad_len(MAX_LEN), pad_len(LK, 32)
    chain = tf_decoder_init_cache_chain(tp["dec_tgt"], CFG, torch.from_numpy(enc),
                                        MAX_LEN, K)
    assert chain.self_k.shape == (CFG.dec_layers, K, B, Lpad, CFG.dim_model)
    assert chain.mem_k.shape == (CFG.dec_layers, B, Lk_pad, CFG.dim_model)
    tok = torch.full((BK,), BOS, dtype=torch.int32)
    x = _embed_tgt_token(tp, CFG, tok) + position_signal(500, CFG.dim_model)[0, 0]
    anc = (torch.arange(BK, dtype=torch.int32) % K)[None].repeat(Lpad, 1)
    maskk = torch.zeros((Lpad, BK), dtype=torch.int32)
    maskk[0] = 1
    mm = torch.zeros((Lk_pad, B), dtype=torch.int32)
    mm[:LK] = torch.from_numpy(mem_mask.T.astype(np.int32))
    sc, ids = step(stack_decoder_layers(tp["dec_tgt"]), tp["dec_tgt"]["norm"],
                   tp["out_tgt"], x, chain.self_k, chain.self_v, chain.mem_k,
                   chain.mem_v, 0, CFG.num_heads, anc, K, mm, maskk, K)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_allclose(sc.numpy(), np.asarray(ref_sc), atol=TOL, rtol=0)
    # the new K/V row landed in each row's own slot at position 0
    assert torch.count_nonzero(chain.self_k[:, :, :, 0]) > 0
    assert torch.count_nonzero(chain.self_k[:, :, :, 1:]) == 0


@pytest.mark.parametrize("K,pf,eos_bias", [
    (1, 1.0, 0.0), (2, 1.0, 0.0), (3, 1.0, 0.0), (3, 0.7, 0.0),
    (1, 1.0, 2.5), (2, 0.7, 2.5), (3, 1.0, 2.5)])
def test_beam_search_matches_dense(setup, K, pf, eos_bias):
    """K3 at position 1, then K4 per position, vs the JAX dense beam with
    physical cache reorders. eos_bias > 0 shifts the final LayerNorm bias
    so that the EOS logit rises by that much: beams then finish early,
    exercising EOS freezing and the all-EOS stop."""
    jp, tp, enc, mem_mask = setup
    if eos_bias:
        jp = copy.deepcopy(jp)
        w = jp["out_tgt"]["w"][:, EOS]
        jp["dec_tgt"]["norm"]["bias"] = (eos_bias * w / (w @ w)).astype(np.float32)
        tp = params_from_numpy(jp)
    ref_preds, ref_scores = jax_beam_search(
        jp, CFG, jnp.asarray(enc), jnp.asarray(mem_mask), K, pf, MAX_LEN,
        use_flash=False)
    preds, scores = beam_search(tp, CFG, torch.from_numpy(enc),
                                torch.from_numpy(mem_mask), K, pf, MAX_LEN)
    np.testing.assert_array_equal(preds.numpy(), np.asarray(ref_preds))
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), atol=TOL,
                               rtol=0)
    if eos_bias:
        assert (preds == EOS).any()
