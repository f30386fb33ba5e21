"""The port's translate modes end to end vs JAX on CPU: the ST encoder
memory within 1e-5, and forward_translate tokens line-identical in modes
ST, MT, ST_BASE, ST-REF (beam widths 1-3) and ASR, ASR-REF, and ST under
an n-gram LM; an unknown mode raises ValueError on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stjep_tpu.config import BOS, ModelConfig
from stjep_tpu.infer import lm_fusion as jlf
from stjep_tpu.infer import lm_table as jlt
from stjep_tpu.infer.forward import _encode_for_mode as jax_encode_for_mode
from stjep_tpu.infer.forward import forward_translate as jax_forward_translate
from stjep_tpu.models.seq2seq import init_seq2seq as jax_init
from stjep_tpu_torch.bridge import params_from_numpy
from stjep_tpu_torch.infer import lm_fusion as tlf
from stjep_tpu_torch.infer import lm_table as tlt
from stjep_tpu_torch.infer.forward import (
    _encode_for_mode,
    forward_translate,
    forward_translate_refen,
)

from tests.test_lm_fusion import BackoffLM, _toy_entries

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
    jp["emb_dyn_ave"] = rng.randn(CFG.dim_model).astype(np.float32)  # MT, ST_BASE read it
    feats = rng.randn(B, T, CFG.acous_dim).astype(np.float32)
    lens = np.array([64, 29, 47], np.int32)
    return jp, params_from_numpy(jp), feats, lens


def _src(seed=9):
    """Reference source ids [B, 12], BOS first, row 1 PAD after 7."""
    src = np.random.RandomState(seed).randint(5, CFG.enc_vocab_size, (B, 12)).astype(np.int32)
    src[:, 0] = BOS
    src[1, 7:] = 0
    return src


def _pair(setup, mode, beam=1, **kw):
    """(port tokens, JAX tokens) of forward_translate on the same inputs;
    array kwargs go to both as numpy."""
    jp, tp, feats, lens = setup
    arrays = {"acous_feats": feats, "acous_lens": lens, "src": _src()}
    jkw = {k: kw.pop(k) for k in ("lm_jax",) if k in kw}
    tkw = {k: kw.pop(k) for k in ("lm_port",) if k in kw}
    ref = jax_forward_translate(jp, CFG, mode, beam_width=beam, penalty_factor=1.0,
                                max_seq_len=MAX_LEN, lm_fuse=jkw.get("lm_jax"),
                                **{k: jnp.asarray(v) for k, v in arrays.items()}, **kw)
    out = forward_translate(tp, CFG, mode, beam_width=beam, penalty_factor=1.0,
                            max_seq_len=MAX_LEN, device="cpu", lm_fuse=tkw.get("lm_port"),
                            **{k: torch.from_numpy(v) for k, v in arrays.items()}, **kw)
    return out.numpy(), np.asarray(ref)


def test_encoder_memory_matches_jax(setup):
    jp, tp, feats, lens = setup
    ref, ref_mask = jax_encode_for_mode(jp, CFG, "ST", None, jnp.asarray(feats),
                                        jnp.asarray(lens), None, False)
    enc, mask = _encode_for_mode(tp, CFG, "ST", None, torch.from_numpy(feats),
                                 torch.from_numpy(lens), False)
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


@pytest.mark.parametrize("beam", [1, 2, 3])
@pytest.mark.parametrize("mode,refen", [("MT", False), ("ST_BASE", False), ("ST", True)],
                         ids=["MT", "ST_BASE", "ST-REF"])
def test_modes_line_identical(setup, mode, refen, beam):
    """MT (emb_dyn_ave over the source), ST_BASE (LAS hypotheses with
    emb_dyn_ave) and ST-REF (the LAS teacher-forced on src, its static
    embeddings): the best beams line-identical to JAX's."""
    out, ref = _pair(setup, mode, beam, refen=refen)
    assert out.shape == (B, MAX_LEN) and (out[:, 0] == BOS).all()
    np.testing.assert_array_equal(out, ref)


def test_asr_refen_matches_jax(setup):
    """ASR-REF: the symbols of the LAS teacher-forced on src, [B, 11]."""
    out, ref = _pair(setup, "ASR", refen=True)
    assert out.shape == (B, 11)
    np.testing.assert_array_equal(out, ref)
    jp, tp, feats, lens = setup
    again = forward_translate_refen(tp, CFG, "ASR", acous_feats=torch.from_numpy(feats),
                                    acous_lens=torch.from_numpy(lens),
                                    src=torch.from_numpy(_src()), device="cpu")
    np.testing.assert_array_equal(again.numpy(), out)


@pytest.mark.parametrize("kind", ["host", "table"])
def test_st_with_lm_line_identical(setup, kind):
    """ST beam 2 with an n-gram LM fused into its LAS pass (host fuser or
    device table): JAX's tokens."""
    entries = _toy_entries(vocab=CFG.enc_vocab_size, seed=2)
    backoffs = {k: -0.4 for i, k in enumerate(sorted(entries)) if len(k) <= 3 and i % 2}
    if kind == "host":
        lm = BackoffLM(entries, backoffs)
        fj, ft = jlf.make_ngram_fuser(lm, "s-4g_0.7"), tlf.make_ngram_fuser(lm, "s-4g_0.7")
    else:
        fj = jlt.make_table_fuser(jlt.NGramTable.from_ngrams(entries, backoffs), "s-4g_0.7")
        ft = tlt.make_table_fuser(tlt.NGramTable.from_ngrams(entries, backoffs, device="cpu"),
                                  "s-4g_0.7")
    out, ref = _pair(setup, "ST", 2, lm_jax=fj, lm_port=ft)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("mode", ["AE", "ST-REF", "mt"])
def test_unknown_mode_raises(setup, mode):
    """A mode forward_translate does not serve raises ValueError, as JAX's
    does (stjep_tpu/infer/forward.py:85)."""
    jp, tp, feats, lens = setup
    with pytest.raises(ValueError, match="unknown translate mode"):
        jax_forward_translate(jp, CFG, mode, src=jnp.asarray(_src()),
                              acous_feats=jnp.asarray(feats), acous_lens=jnp.asarray(lens))
    with pytest.raises(ValueError, match="unknown translate mode"):
        forward_translate(tp, CFG, mode, src=torch.from_numpy(_src()),
                          acous_feats=torch.from_numpy(feats),
                          acous_lens=torch.from_numpy(lens), device="cpu")
