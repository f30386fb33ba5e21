"""The port's n-gram LM shallow fusion against JAX on the CPU: the host
fuser (infer/lm_fusion.py, a copy) and the hashed device table
(infer/lm_table.py: the hash bit for bit, the builder's arrays, the table
fuser within 1e-6 where the 10th and 11th candidates tie), and the fused
LAS decode, free running and teacher forced, token-identical with either
fuser (as tests/test_lm_fusion.py:195-302 holds the JAX fusers), in
las_decoder_forward, forward_translate ASR and forward_eval."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stjep_tpu.config import BOS, ModelConfig
from stjep_tpu.infer import lm_fusion as jlf
from stjep_tpu.infer import lm_table as jlt
from stjep_tpu.infer.forward import forward_translate as jax_forward_translate
from stjep_tpu.models.las_decoder import las_decoder_forward as jax_las_decoder
from stjep_tpu.models.las_decoder import las_decoder_init as jax_las_decoder_init
from stjep_tpu.models.seq2seq import forward_eval as jax_forward_eval
from stjep_tpu.models.seq2seq import init_seq2seq as jax_init

from stjep_tpu_torch.bridge import params_from_numpy
from stjep_tpu_torch.infer import lm_fusion as tlf
from stjep_tpu_torch.infer import lm_table as tlt
from stjep_tpu_torch.infer.forward import forward_eval, forward_translate
from stjep_tpu_torch.models.las_decoder import las_decoder_forward

from tests.test_lm_fusion import BackoffLM, DictLM, FakeLM, _toy_entries

V = 16
ALPHA = "s-4g_0.6"


def _backoffs(entries, seed):
    rng = np.random.RandomState(seed)
    return {k: float(-rng.uniform(0.1, 1.5)) for k in entries
            if len(k) <= 3 and rng.rand() < 0.6}


@pytest.fixture(scope="module")
def lms():
    """(JAX fuser, port fuser) pairs: host fusers on a strict dict LM and
    on a backoff LM, and the tables built from the same n-grams."""
    entries = _toy_entries(vocab=V, seed=2)
    backoffs = _backoffs(entries, 4)
    out = {}
    for name, lm, bo in (("strict", DictLM(entries), None),
                         ("backoff", BackoffLM(entries, backoffs), backoffs)):
        out["host " + name] = (jlf.make_ngram_fuser(lm, ALPHA), tlf.make_ngram_fuser(lm, ALPHA))
        out["table " + name] = (
            jlt.make_table_fuser(jlt.NGramTable.from_ngrams(entries, bo), ALPHA),
            tlt.make_table_fuser(tlt.NGramTable.from_ngrams(entries, bo, device="cpu"), ALPHA))
    return out


def test_host_fuser_copy_equals_jax():
    lm, rng = FakeLM(), np.random.RandomState(0)
    ours, ref = tlf.make_ngram_fuser(lm, "s-4g_0.5"), jlf.make_ngram_fuser(lm, "s-4g_0.5")
    for step in range(5):
        logp = np.log(rng.dirichlet(np.ones(20), size=4)).astype(np.float32)
        ctx = rng.randint(0, 20, (4, 3)).astype(np.int32)
        np.testing.assert_array_equal(ours(logp, ctx, step), ref(logp, ctx, step))
    assert tlf.make_ngram_fuser(lm, "null") is None and tlf.make_ngram_fuser(None, ALPHA) is None
    with pytest.raises(NotImplementedError):
        tlf.make_ngram_fuser(lm, "s-rnn_0.5")


def test_hash_bit_equal_on_int32_tokens():
    """Random int32 tokens over the whole range, negatives included: the
    int64 hash equals _hash_np's uint32 bit for bit, and the hashes (each
    step's product, then its shift) reach past 2^31."""
    rng = np.random.RandomState(1)
    toks = rng.randint(-2 ** 31, 2 ** 31 - 1, (512, 4), dtype=np.int64).astype(np.int32)
    toks[:8] = np.iinfo(np.int32).max
    for k in (1, 2, 4):
        for mult, seed in ((jlt._MULT1, jlt._SEED1), (jlt._MULT2, jlt._SEED2)):
            ref = jlt._hash_np(toks[:, :k], mult, seed)
            ours = tlt._hash_torch(torch.from_numpy(toks[:, :k]), int(mult), int(seed))
            assert ours.dtype == torch.int64
            np.testing.assert_array_equal(ours.numpy(), ref.astype(np.int64))
            assert (ref >= 2 ** 31).any() and (ref < 2 ** 31).any()
            np.testing.assert_array_equal(tlt._hash_np(toks[:, :k], mult, seed), ref)
    # both hashes in one call on keys [4, 128, 4] of lengths 1-4, as the
    # table's probe makes it: each key's hash is that of its last tokens
    keys = toks.reshape(4, 128, 4)
    length = torch.arange(1, 5).view(4, 1)
    both = tlt._hash_torch(torch.from_numpy(keys), torch.tensor([int(jlt._MULT1), int(jlt._MULT2)]),
                           torch.tensor([int(jlt._SEED1), int(jlt._SEED2)]), length)
    assert both.shape == (2, 4, 128) and both.dtype == torch.int64
    for i, (mult, seed) in enumerate(((jlt._MULT1, jlt._SEED1), (jlt._MULT2, jlt._SEED2))):
        for g in range(4):
            ref = jlt._hash_np(keys[g, :, 3 - g:], mult, seed)
            np.testing.assert_array_equal(both[i, g].numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("kind", ["strict", "backoff"])
def test_table_arrays_equal_jax(kind):
    entries = _toy_entries(vocab=40, seed=7)
    bo = _backoffs(entries, 8) if kind == "backoff" else None
    ref = jlt.NGramTable.from_ngrams(entries, bo)
    ours = tlt.NGramTable.from_ngrams(entries, bo, device="cpu")
    assert (ours.size, ours.order, ours.backoff) == (ref.size, ref.order, ref.backoff)
    assert ours.backoff == (kind == "backoff")
    np.testing.assert_array_equal(ours.h2.numpy(), np.asarray(ref.h2).astype(np.int64))
    np.testing.assert_array_equal(ours.val.numpy(), np.asarray(ref.val))
    np.testing.assert_array_equal(ours.bow.numpy(), np.asarray(ref.bow))


@pytest.mark.parametrize("kind", ["strict", "backoff"])
def test_table_fuser_matches_jax_on_ties(lms, kind):
    """Rows whose 10th and 11th candidates tie (and a row of one value):
    the lowest id enters the top 10 on both sides, within 1e-6."""
    ref, ours = lms["table " + kind]
    rng = np.random.RandomState(3)
    for step in range(5):
        logp = np.log(rng.dirichlet(np.ones(V), size=4)).astype(np.float32)
        for r in range(3):
            order = np.argsort(-logp[r], kind="stable")
            logp[r, order[10]] = logp[r, order[9]]  # ranks 10 and 11 tie
        logp[3] = np.float32(np.log(1.0 / V))
        ctx = rng.randint(0, V, (4, 3)).astype(np.int32)
        want = np.asarray(jax.jit(ref)(jnp.asarray(logp), jnp.asarray(ctx), jnp.int32(step)))
        got = ours(torch.from_numpy(logp), torch.from_numpy(ctx), step).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        assert ((got != logp).sum(axis=1) <= 10).all()


def _las_cfg():
    return ModelConfig(enc_vocab_size=V, dec_vocab_size=V, enc_embedding_size=4,
                       acous_dim=4, acous_hidden_size=4, dim_model=8, num_unilstm_dec=2,
                       max_seq_len_src=9, dropout=0.0, mode="ASR")


@pytest.mark.parametrize("teacher_forced", [False, True], ids=["free", "tf"])
@pytest.mark.parametrize("fuser", ["host strict", "table strict", "host backoff",
                                   "table backoff"])
def test_fused_las_decode_matches_jax(lms, fuser, teacher_forced):
    """las_decoder_forward under each fuser: symbols and lengths equal to
    JAX's, the fused log-probs within 1e-5 (the dense buffer teacher
    forced, the picked ones free running)."""
    cfg = _las_cfg()
    jp = jax.tree_util.tree_map(np.asarray, jax_las_decoder_init(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(0)
    acous = rng.randn(2, 6, 2 * cfg.acous_hidden_size).astype(np.float32)
    tgt = rng.randint(4, V, (2, cfg.max_seq_len_src)).astype(np.int32)
    tgt[:, 0] = BOS
    ref_fuse, our_fuse = lms[fuser]
    kw = (dict(tgt=tgt, use_teacher_forcing=True) if teacher_forced
          else dict(ref_tokens=tgt[:, 1:]))
    ref = jax_las_decoder(jp, cfg, jnp.asarray(acous), lm_fuse=ref_fuse,
                          **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                             for k, v in kw.items()})
    out = las_decoder_forward(params_from_numpy(jp), cfg, torch.from_numpy(acous),
                              lm_fuse=our_fuse,
                              **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                                 for k, v in kw.items()})
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    assert out[1].shape == ref[1].shape
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=1e-5, rtol=0)


CFG = ModelConfig(
    enc_vocab_size=V, dec_vocab_size=12, enc_embedding_size=16, dec_embedding_size=128,
    acous_dim=8, acous_hidden_size=64, dim_model=128, dim_feedforward=256, num_heads=4,
    enc_layers=1, dec_layers=1, num_unilstm_dec=3, spec_aug=False, dropout=0.0,
    max_seq_len_src=10, max_seq_len_tgt=12, mode="ASR_ST")


@pytest.fixture(scope="module")
def model():
    jp = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(0), CFG))
    rng = np.random.RandomState(2)
    src = rng.randint(5, V, (3, CFG.max_seq_len_src)).astype(np.int32)
    src[:, 0] = BOS
    tgt = rng.randint(4, CFG.dec_vocab_size, (3, CFG.max_seq_len_tgt)).astype(np.int32)
    tgt[:, 0] = BOS
    batch = dict(acous_feats=rng.randn(3, 48, CFG.acous_dim).astype(np.float32),
                 acous_lens=np.array([48, 21, 33], np.int32), src=src)
    return jp, params_from_numpy(jp), batch, tgt


@pytest.mark.parametrize("refen", [False, True], ids=["free", "refen"])
@pytest.mark.parametrize("fuser", ["host backoff", "table backoff"])
def test_fused_asr_translate_token_identical(model, lms, fuser, refen):
    """forward_translate ASR (and ASR-REF, teacher forced on src) with each
    fuser: JAX's tokens; the LM changes them from the unfused decode."""
    jp, tp, batch, _ = model
    ref_fuse, our_fuse = lms[fuser]
    ref = jax_forward_translate(jp, CFG, "ASR", refen=refen, lm_fuse=ref_fuse,
                                **{k: jnp.asarray(v) for k, v in batch.items()})
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = forward_translate(tp, CFG, "ASR", refen=refen, lm_fuse=our_fuse, device="cpu", **t)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    plain = forward_translate(tp, CFG, "ASR", refen=refen, device="cpu", **t)
    assert not torch.equal(out, plain)


@pytest.mark.parametrize("fuser", ["host strict", "table backoff"])
def test_forward_eval_with_lm_matches_jax(model, lms, fuser):
    """forward_eval ASR_ST with refs under an LM (the LM-fused ASR pass of
    dev eval): preds and lengths equal to JAX's, embeddings and picked
    log-probs within 1e-5 and 2e-5 (tests/test_torch_eval.py's limits)."""
    jp, tp, batch, tgt = model
    ref_fuse, our_fuse = lms[fuser]
    kw = dict(acous_feats=batch["acous_feats"], acous_lens=batch["acous_lens"],
              ref_src=batch["src"], ref_tgt=tgt)
    ref = jax_forward_eval(jp, CFG, "ASR_ST", use_flash=False, lm_fuse=ref_fuse,
                           **{k: jnp.asarray(v) for k, v in kw.items()})
    out = forward_eval(tp, CFG, "ASR_ST", device="cpu", lm_fuse=our_fuse,
                       **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert set(out) == set(ref)
    for k in ref:
        a, b = out[k].numpy(), np.asarray(ref[k])
        if k.startswith(("preds", "lengths")):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            tol = 2e-5 if k.startswith("picked") else 1e-5
            np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=k)
