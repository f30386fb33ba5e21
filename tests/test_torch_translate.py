"""The port's ST slice end to end vs JAX on CPU: encoder memory within
1e-5, and forward_translate tokens line-identical for beam widths 1-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stjep_tpu.config import ModelConfig
from stjep_tpu.infer.forward import _encode_for_mode
from stjep_tpu.infer.forward import forward_translate as jax_forward_translate
from stjep_tpu.models.seq2seq import init_seq2seq as jax_init
from stjep_tpu_torch.bridge import params_from_numpy
from stjep_tpu_torch.infer.forward import encode_st, forward_translate

TOL = 1e-5

CFG = ModelConfig(
    enc_vocab_size=50, dec_vocab_size=40, enc_embedding_size=16,
    dec_embedding_size=128, acous_dim=8, acous_hidden_size=64, dim_model=128,
    dim_feedforward=256, num_heads=4, enc_layers=2, dec_layers=2,
    num_unilstm_dec=3, spec_aug=False, dropout=0.0, max_seq_len_src=12,
    max_seq_len_tgt=16, mode="ASR_ST")
B, T, MAX_LEN = 3, 64, 16


@pytest.fixture(scope="module")
def setup():
    jp = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(0), CFG))
    rng = np.random.RandomState(7)
    feats = rng.randn(B, T, CFG.acous_dim).astype(np.float32)
    lens = np.array([64, 29, 47], np.int32)
    return jp, params_from_numpy(jp), feats, lens


def test_encoder_memory_matches_jax(setup):
    jp, tp, feats, lens = setup
    ref, ref_mask = _encode_for_mode(jp, CFG, "ST", None, jnp.asarray(feats),
                                     jnp.asarray(lens), None, False)
    enc, mask, _ = encode_st(tp, CFG, torch.from_numpy(feats),
                             torch.from_numpy(lens))
    np.testing.assert_allclose(enc.numpy(), np.asarray(ref), atol=TOL, rtol=0)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))


@pytest.mark.parametrize("beam", [1, 2, 3])
def test_st_tokens_line_identical(setup, beam):
    jp, tp, feats, lens = setup
    ref = jax_forward_translate(jp, CFG, "ST", acous_feats=jnp.asarray(feats),
                                acous_lens=jnp.asarray(lens), beam_width=beam,
                                penalty_factor=1.0, max_seq_len=MAX_LEN)
    out = forward_translate(tp, CFG, "ST", acous_feats=torch.from_numpy(feats),
                            acous_lens=torch.from_numpy(lens), beam_width=beam,
                            penalty_factor=1.0, max_seq_len=MAX_LEN, device="cpu")
    assert out.shape == (B, MAX_LEN)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_asr_mode_matches_jax(setup):
    jp, tp, feats, lens = setup
    ref = jax_forward_translate(jp, CFG, "ASR", acous_feats=jnp.asarray(feats),
                                acous_lens=jnp.asarray(lens))
    out = forward_translate(tp, CFG, "ASR", acous_feats=torch.from_numpy(feats),
                            acous_lens=torch.from_numpy(lens), device="cpu")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mode", ["MT", "ST_BASE"])
def test_unported_modes_raise(setup, mode):
    _, tp, feats, lens = setup
    with pytest.raises(NotImplementedError):
        forward_translate(tp, CFG, mode, acous_feats=torch.from_numpy(feats),
                          acous_lens=torch.from_numpy(lens), device="cpu")
