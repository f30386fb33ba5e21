"""Port vs JAX on CPU: the dense eval routes and the AE heads.

- `forward_eval` without reference ids (JAX's XLA while loop, the dense
  `logps_*` buffers) on the standard, universal and ACT transformers in
  modes ASR, MT, ST and ASR_ST: preds and lengths equal, embeddings and
  `logps_*` within 1e-5. The standard and universal greedy run one K5
  step a position through tf_decoder_step_flash (never the chain step);
  the ACT one re-runs its buffer (no step at all).
- The AE head (`logps_ae`, `preds_ae`) in `forward_train` and
  `forward_eval`, modes AE_ASR and AE_MT: against JAX, 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stjep_tpu.config import BOS, PAD, ModelConfig
from stjep_tpu.models.seq2seq import forward_eval as jax_forward_eval
from stjep_tpu.models.seq2seq import forward_train as jax_forward_train
from stjep_tpu.models.seq2seq import init_seq2seq as jax_init
from stjep_tpu_torch.bridge import params_from_numpy
from stjep_tpu_torch.models import seq2seq
from stjep_tpu_torch.models.seq2seq import forward_eval, forward_train

TOL = 1e-5
CFG = ModelConfig(
    enc_vocab_size=40, dec_vocab_size=30, enc_embedding_size=16, dec_embedding_size=32,
    acous_dim=8, acous_hidden_size=16, dim_model=32, dim_feedforward=64, num_heads=4,
    enc_layers=2, dec_layers=2, num_unilstm_dec=3, spec_aug=False, dropout=0.0,
    max_seq_len_src=10, max_seq_len_tgt=14, mode="ASR_ST")
CFGS = {"standard": CFG,
        "universal": dataclasses.replace(CFG, transformer_type="universal"),
        "act": dataclasses.replace(CFG, transformer_type="universal", act=True)}
B, T = 3, 48


@pytest.fixture(scope="module")
def models():
    return {k: jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(4), c))
            for k, c in CFGS.items()}


def _batch(seed):
    rng = np.random.RandomState(seed)
    src = rng.randint(4, CFG.enc_vocab_size, (B, CFG.max_seq_len_src)).astype(np.int32)
    tgt = rng.randint(4, CFG.dec_vocab_size, (B, CFG.max_seq_len_tgt)).astype(np.int32)
    src[:, 0] = tgt[:, 0] = BOS
    src[2, 6:] = tgt[1, 9:] = PAD
    return {"src": src, "tgt": tgt,
            "acous_feats": rng.randn(B, T, CFG.acous_dim).astype(np.float32),
            "acous_lens": np.array([T, 21, 37], np.int32)}


def _same(out, ref, tol=TOL):
    assert set(out) == set(ref)
    for k in ref:
        a, b = out[k].detach().numpy(), np.asarray(ref[k])
        assert a.shape == b.shape, k
        if k.startswith(("preds", "lengths")):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=k)


@pytest.mark.parametrize("mode", ["ASR", "MT", "ST", "ASR_ST"])
@pytest.mark.parametrize("kind", list(CFGS))
def test_forward_eval_without_refs_matches_jax(models, monkeypatch, kind, mode):
    cfg, mb = CFGS[kind], _batch(0)
    kw = {k: mb[k] for k in ("src", "acous_feats", "acous_lens")}
    ref = jax_forward_eval(models[kind], cfg, mode, use_flash=False,
                           **{k: jnp.asarray(v) for k, v in kw.items()})
    calls = {"step": 0, "chain": 0}
    for name, key in (("tf_decoder_step_flash", "step"), ("tf_decoder_chain_step", "chain")):
        real = getattr(seq2seq, name)

        def counted(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(seq2seq, name, counted)
    out = forward_eval(params_from_numpy(models[kind]), cfg, mode, device="cpu",
                       **{k: torch.from_numpy(v) for k, v in kw.items()})
    _same(out, ref)
    key = "st" if "ST" in mode else "mt" if mode == "MT" else None
    if key:
        assert out["logps_" + key].shape == (B, cfg.max_seq_len_tgt, cfg.dec_vocab_size)
        assert calls["chain"] == 0
        assert (calls["step"] > 0) == (kind != "act")
    if "ASR" in mode:
        assert out["logps_asr"].shape == (B, cfg.max_seq_len_src - 1, cfg.enc_vocab_size)


@pytest.mark.parametrize("mode", ["AE_ASR", "AE_MT"])
@pytest.mark.parametrize("fn", ["train", "eval"])
def test_ae_head_matches_jax(models, fn, mode):
    jp, mb = models["standard"], _batch(1)
    keys = ("src", "tgt", "acous_feats", "acous_lens") if fn == "train" else (
        "src", "acous_feats", "acous_lens")
    kw = {k: mb[k] for k in keys}
    if fn == "train":
        ref = jax_forward_train(jp, CFG, mode, is_training=False,
                                **{k: jnp.asarray(v) for k, v in kw.items()})
        out = forward_train(params_from_numpy(jp), CFG, mode, is_training=False,
                            **{k: torch.from_numpy(v) for k, v in kw.items()})
    else:
        ref = jax_forward_eval(jp, CFG, mode, use_flash=False,
                               **{k: jnp.asarray(v) for k, v in kw.items()})
        out = forward_eval(params_from_numpy(jp), CFG, mode, device="cpu",
                           **{k: torch.from_numpy(v) for k, v in kw.items()})
    _same(out, ref)
    L = CFG.max_seq_len_src - 1
    assert out["logps_ae"].shape == (B, L, CFG.enc_vocab_size)
