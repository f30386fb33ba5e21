"""Port vs JAX on CPU: dev eval (`forward_eval` with reference ids), the
general beam loop and the universal transformer.

- forward_eval in modes ASR_ST, ST and MT on the standard and the
  universal model against the JAX package's dense route
  (`forward_eval(use_flash=False)`): preds and lengths equal, embeddings
  within 1e-5, picked_* within 2e-5 (JAX's own tolerance for this
  comparison, tests/test_eval_fast.py:97-101); one EOS-heavy case, where
  every row stops early, compares the early exit and the log(1/V) fill.
- forward_translate ST on the universal model (K5 per hop + K7 in the
  general loop) and on a standard model with dec_emb_proj (the chain step
  in the general loop): tokens line-identical to the JAX dense beam for
  widths 1-3.
- the routes once refused here: an ACT model's dev eval, forward_eval
  without ref_src or ref_tgt (the dense logps_* buffers) and the AE head,
  against JAX's dense forward_eval (logps_* within 1e-5).
- forward_train through the universal encoder and decoder: loss and the
  whole gradient tree against jax.value_and_grad, dropout off (forward
  values 1e-5; gradients rtol 1e-4 / atol 1e-6, as tests/test_torch_train.py).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stjep_tpu.config import EOS, PAD, ModelConfig
from stjep_tpu.infer.forward import forward_translate as jax_forward_translate
from stjep_tpu.models.seq2seq import forward_eval as jax_forward_eval
from stjep_tpu.models.seq2seq import forward_train as jax_forward_train
from stjep_tpu.models.seq2seq import init_seq2seq as jax_init
from stjep_tpu.train.trainer import Trainer
from stjep_tpu_torch.bridge import named_leaves, params_from_numpy
from stjep_tpu_torch.infer.forward import forward_eval, forward_translate
from stjep_tpu_torch.models.tf_decoder import tf_decoder_init
from stjep_tpu_torch.models.tf_encoder import tf_encoder_init
from stjep_tpu_torch.ops.decode_flash import (
    decode_chain_step_flash,
    decode_head,
    decode_head_gather,
    decoder_layer_step_flash,
)
from stjep_tpu_torch.train.trainer import compute_grads

TOL, TOL_PICKED = 1e-5, 2e-5
CFG = ModelConfig(
    enc_vocab_size=50, dec_vocab_size=40, enc_embedding_size=16,
    dec_embedding_size=128, acous_dim=8, acous_hidden_size=64, dim_model=128,
    dim_feedforward=256, num_heads=4, enc_layers=2, dec_layers=2,
    num_unilstm_dec=3, spec_aug=False, dropout=0.0, max_seq_len_src=12,
    max_seq_len_tgt=16, mode="ASR_ST")
UNIVERSAL = dataclasses.replace(CFG, transformer_type="universal")
B, T, MAX_LEN = 3, 64, 16
CFGS = {"standard": CFG, "universal": UNIVERSAL}


@pytest.fixture(scope="module")
def models():
    return {k: jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(0), c))
            for k, c in CFGS.items()}


def _batch(seed):
    rng = np.random.RandomState(seed)
    src = rng.randint(4, CFG.enc_vocab_size, (B, CFG.max_seq_len_src)).astype(np.int32)
    tgt = rng.randint(4, CFG.dec_vocab_size, (B, CFG.max_seq_len_tgt)).astype(np.int32)
    src[:, 0] = tgt[:, 0] = 2
    src[1, 7:] = tgt[2, 9:] = PAD
    return {"srcid": src, "tgtid": tgt,
            "acous_feat": rng.randn(B, T, CFG.acous_dim).astype(np.float32),
            "acouslen": np.array([T, 29, 47], np.int32)}


def _eos_biased(jp, bias):
    """Raise the EOS logit by `bias` through the decoder's final LayerNorm
    bias (its output feeds out_tgt)."""
    jp = copy.deepcopy(jp)
    w = jp["out_tgt"]["w"][:, EOS]
    jp["dec_tgt"]["norm"]["bias"] = (bias * w / (w @ w)).astype(np.float32)
    return jp


def _compare_eval(jp, cfg, mode, mb):
    kw = dict(src=mb["srcid"], acous_feats=mb["acous_feat"],
              acous_lens=mb["acouslen"], ref_src=mb["srcid"], ref_tgt=mb["tgtid"])
    ref = jax_forward_eval(jp, cfg, mode, use_flash=False,
                           **{k: jnp.asarray(v) for k, v in kw.items()})
    out = forward_eval(params_from_numpy(jp), cfg, mode, device="cpu",
                       **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert set(out) == set(ref)
    for k in ref:
        a, b = out[k].numpy(), np.asarray(ref[k])
        assert a.shape == b.shape, k
        if k.startswith(("preds", "lengths")):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            tol = TOL_PICKED if k.startswith("picked") else TOL
            np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=k)
    return out


@pytest.mark.parametrize("mode", ["ASR_ST", "ST", "MT"])
@pytest.mark.parametrize("kind", ["standard", "universal"])
def test_forward_eval_matches_jax(models, kind, mode):
    cfg = CFGS[kind]
    wrappers = ((decode_chain_step_flash, "gather_launches"),
                (decoder_layer_step_flash, "launches"),
                (decode_head_gather, "launches"))
    before = [getattr(w, a) for w, a in wrappers]
    out = _compare_eval(models[kind], cfg, mode, _batch(0))
    assert [getattr(w, a) for w, a in wrappers] == before  # CPU: no launch
    key = "st" if "ST" in mode else "mt"
    assert out["picked_" + key].shape == (B, CFG.max_seq_len_tgt - 1)


@pytest.mark.parametrize("kind", ["standard", "universal"])
def test_forward_eval_eos_heavy_matches_jax(models, kind):
    """Every row emits EOS early: the loop exits before the last slot, and
    the slots it never wrote keep log(1/V)."""
    jp = _eos_biased(models[kind], 6.0)
    out = _compare_eval(jp, CFGS[kind], "ASR_ST", _batch(1))
    preds = out["preds_st"].numpy()
    assert (preds == EOS).any(axis=1).all()
    assert (preds[:, -1] == PAD).all()  # early exit
    fill = np.float32(np.log(1.0 / CFG.dec_vocab_size))
    assert np.isclose(out["picked_st"].numpy()[:, -1], fill, atol=1e-6).all()


def _translate_pair(jp, cfg, beam, seed=7):
    mb = _batch(seed)
    ref = jax_forward_translate(
        jp, cfg, "ST", acous_feats=jnp.asarray(mb["acous_feat"]),
        acous_lens=jnp.asarray(mb["acouslen"]), beam_width=beam,
        penalty_factor=1.0, max_seq_len=MAX_LEN)
    out = forward_translate(
        params_from_numpy(jp), cfg, "ST", acous_feats=torch.from_numpy(mb["acous_feat"]),
        acous_lens=torch.from_numpy(mb["acouslen"]), beam_width=beam,
        penalty_factor=1.0, max_seq_len=MAX_LEN, device="cpu")
    assert out.shape == (B, MAX_LEN)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("beam", [1, 2, 3])
def test_universal_st_beam_line_identical(models, beam):
    before = decode_head.launches
    _translate_pair(models["universal"], UNIVERSAL, beam)
    assert decode_head.launches == before


def test_universal_st_beam_eos_heavy_line_identical(models):
    _translate_pair(_eos_biased(models["universal"], 2.5), UNIVERSAL, 3)


@pytest.mark.parametrize("beam", [1, 3])
def test_dec_emb_proj_st_beam_line_identical(beam):
    """dec_emb_proj keeps the standard model off the megastep: the chain
    step runs in the general loop."""
    cfg = dataclasses.replace(CFG, dec_emb_proj=True)
    jp = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(1), cfg))
    assert "dec_emb_proj" in jp
    _translate_pair(jp, cfg, beam)


def test_universal_shares_one_layer():
    g = torch.Generator().manual_seed(0)
    assert len(tf_encoder_init(g, UNIVERSAL)["layers"]) == 1
    assert len(tf_decoder_init(g, UNIVERSAL)["layers"]) == 1
    assert len(tf_decoder_init(g, CFG)["layers"]) == CFG.dec_layers


@pytest.mark.parametrize("what", ["act", "unknown"])
def test_unported_transformer_types_raise(what):
    """An unknown transformer type still raises; ACT, once refused here,
    now inits its halting units and its dev eval (forward_eval ASR_ST
    with reference ids: `_greedy_decode` plus `_pick`, each position
    re-running the token buffer) matches JAX's."""
    if what == "unknown":
        with pytest.raises(ValueError):
            tf_decoder_init(torch.Generator().manual_seed(0),
                            dataclasses.replace(CFG, transformer_type="recurrent"))
        return
    cfg = dataclasses.replace(UNIVERSAL, act=True)
    assert "act_fn" in tf_decoder_init(torch.Generator().manual_seed(0), cfg)
    jp = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(2), cfg))
    before = decoder_layer_step_flash.launches
    out = _compare_eval(jp, cfg, "ASR_ST", _batch(0))
    assert decoder_layer_step_flash.launches == before
    assert out["picked_st"].shape == (B, CFG.max_seq_len_tgt - 1)


@pytest.mark.parametrize("mode,kw", [
    ("ASR_ST", {"ref_src": None}), ("MT", {"ref_tgt": None}), ("AE_ASR", {})])
def test_unported_eval_routes_raise(models, mode, kw):
    """The routes this once refused, against JAX's dense forward_eval: the
    ASR head without ref_src (`logps_asr` from the LAS step loop, beside
    `picked_st`), MT without ref_tgt (`logps_mt` from the dense greedy)
    and the AE head with refs."""
    mb = _batch(0)
    args = dict(src=mb["srcid"], acous_feats=mb["acous_feat"], acous_lens=mb["acouslen"],
                ref_src=mb["srcid"], ref_tgt=mb["tgtid"])
    args = {k: v for k, v in {**args, **kw}.items() if v is not None}
    ref = jax_forward_eval(models["standard"], CFG, mode, use_flash=False,
                           **{k: jnp.asarray(v) for k, v in args.items()})
    out = forward_eval(params_from_numpy(models["standard"]), CFG, mode, device="cpu",
                       **{k: torch.from_numpy(v) for k, v in args.items()})
    assert set(out) == set(ref)
    for k in ref:
        a, b = out[k].numpy(), np.asarray(ref[k])
        assert a.shape == b.shape, k
        if k.startswith(("preds", "lengths")):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            tol = TOL_PICKED if k.startswith("picked") else TOL
            np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=k)
    dense = {"ASR_ST": "logps_asr", "MT": "logps_mt", "AE_ASR": "logps_ae"}[mode]
    assert out[dense].ndim == 3


@pytest.mark.parametrize("mode", ["MT", "ASR_ST"])
def test_universal_train_loss_and_gradients_match_jax(models, tmp_path, mode):
    jp = models["universal"]
    mb = _batch(2)
    tr = Trainer(expt_dir=str(tmp_path))
    tr.MODE = mode
    kw = {"src": mb["srcid"], "tgt": mb["tgtid"]}
    if mode != "MT":
        kw.update(acous_feats=mb["acous_feat"], acous_lens=mb["acouslen"])

    def loss(p):
        out = jax_forward_train(p, UNIVERSAL, mode, rng=jax.random.PRNGKey(0),
                                is_training=False, ref_pick=True,
                                **{k: jnp.asarray(v) for k, v in kw.items()})
        return tr._head_losses(UNIVERSAL, out, {k: jnp.asarray(v) for k, v in mb.items()},
                               1.0)[0]

    r_loss, r_grads = jax.jit(jax.value_and_grad(loss))(jp)
    keep = {"MT": ("srcid", "tgtid")}.get(mode, tuple(mb))
    tp = params_from_numpy(jp)
    losses, grads = compute_grads(UNIVERSAL, mode, tp,
                                  [{k: torch.from_numpy(mb[k]) for k in keep}],
                                  torch.Generator().manual_seed(0), is_training=False)
    np.testing.assert_allclose(float(sum(losses.values())), float(r_loss), rtol=TOL)
    ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, r_grads)))
    mine = dict(zip(dict(named_leaves(tp)).keys(), grads))
    assert mine.keys() == ref.keys()
    assert len(tp["dec_tgt"]["layers"]) == len(tp["enc_src"]["layers"]) == 1
    for k in ref:
        np.testing.assert_allclose(mine[k].numpy(), ref[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
