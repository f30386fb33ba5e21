"""Port vs JAX on CPU: the LSTM ops, K1's plain version (bilstm), the
pyramid encoder, K2's plain version (free-running LAS greedy) and the LAS
pass. Tolerance 1e-5: both sides compute in f32 on the CPU; only the
summation order of the matrix products differs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stjep_tpu.config import ModelConfig
from stjep_tpu.models.las import las_forward as jax_las_forward
from stjep_tpu.models.las_decoder import las_decoder_forward as jax_las_decoder
from stjep_tpu.models.las_encoder import las_encoder_forward as jax_las_encoder
from stjep_tpu.models.seq2seq import init_seq2seq as jax_init
from stjep_tpu.ops.lstm import bilstm as jax_bilstm
from stjep_tpu_torch.bridge import params_from_numpy
from stjep_tpu_torch.models.las import las_forward
from stjep_tpu_torch.models.las_decoder import las_decoder_forward
from stjep_tpu_torch.models.las_encoder import las_encoder_forward
from stjep_tpu_torch.ops.lstm_pallas import bilstm_pallas, bilstm_plain

TOL = 1e-5

CFG = ModelConfig(
    enc_vocab_size=50, dec_vocab_size=40, enc_embedding_size=16,
    dec_embedding_size=128, acous_dim=8, acous_hidden_size=64, dim_model=128,
    dim_feedforward=256, num_heads=4, enc_layers=2, dec_layers=2,
    num_unilstm_dec=3, spec_aug=False, dropout=0.0, max_seq_len_src=12,
    max_seq_len_tgt=16, mode="ASR_ST")
B, T = 3, 64


@pytest.fixture(scope="module")
def setup():
    jp = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(0), CFG))
    rng = np.random.RandomState(1)
    feats = rng.randn(B, T, CFG.acous_dim).astype(np.float32)
    lens = np.array([64, 37, 50], np.int32)
    return jp, params_from_numpy(jp), feats, lens


@pytest.mark.parametrize("wrapper", [bilstm_plain, bilstm_pallas])
def test_bilstm_matches_jax(setup, wrapper):
    jp, tp, _, _ = setup
    p = jp["las"]["encoder"]["acous_enc_l1"]
    rng = np.random.RandomState(2)
    x = rng.randn(B, 21, CFG.acous_dim).astype(np.float32)
    lens = np.array([21, 9, 1], np.int32)
    ref = np.asarray(jax_bilstm(p["fwd"], p["bwd"], jnp.asarray(x),
                                lengths=jnp.asarray(lens)))
    q = tp["las"]["encoder"]["acous_enc_l1"]
    out = wrapper(q["fwd"], q["bwd"], torch.from_numpy(x),
                  torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    assert np.all(out[2, 1:] == 0)  # zero past the valid length


def test_pyramid_matches_jax(setup):
    jp, tp, feats, lens = setup
    ref, ref_lens = jax_las_encoder(jp["las"]["encoder"], CFG, jnp.asarray(feats),
                                    jnp.asarray(lens), is_training=False)
    out, out_lens = las_encoder_forward(tp["las"]["encoder"], CFG,
                                        torch.from_numpy(feats),
                                        torch.from_numpy(lens))
    assert out.shape == (B, T // 8, 2 * CFG.acous_hidden_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(ref_lens))


def test_las_greedy_matches_jax(setup):
    jp, tp, _, lens = setup
    rng = np.random.RandomState(3)
    acous = rng.randn(B, T // 8, 2 * CFG.acous_hidden_size).astype(np.float32)
    r_embs, _, r_syms, r_lens = jax_las_decoder(
        jp["las"]["decoder"], CFG, jnp.asarray(acous), acous_lens=jnp.asarray(lens),
        want_logps=False)
    embs, _, syms, lengths = las_decoder_forward(
        tp["las"]["decoder"], CFG, torch.from_numpy(acous), torch.from_numpy(lens))
    np.testing.assert_array_equal(syms.numpy(), np.asarray(r_syms))
    np.testing.assert_allclose(embs.numpy(), np.asarray(r_embs), atol=TOL, rtol=0)
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(r_lens))


def test_las_pass_matches_jax(setup):
    jp, tp, feats, lens = setup
    r_embs, _, r_syms, r_lens = jax_las_forward(
        jp["las"], CFG, jnp.asarray(feats), jnp.asarray(lens), want_logps=False,
        max_seq_len=CFG.max_seq_len_src)
    embs, _, syms, lengths = las_forward(tp["las"], CFG, torch.from_numpy(feats),
                                         torch.from_numpy(lens),
                                         max_seq_len=CFG.max_seq_len_src)
    np.testing.assert_array_equal(syms.numpy(), np.asarray(r_syms))
    np.testing.assert_allclose(embs.numpy(), np.asarray(r_embs), atol=TOL, rtol=0)
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(r_lens))
