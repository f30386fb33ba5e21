"""Port vs JAX on CPU: K9 (`las_tf_scan`) through its plain route, against
`jax.vjp` of a `lax.scan` over `las_decoder_step_core(..., emb_is_pre0=True)`,
with and without injected dropout masks; the teacher-forced LAS decoder
branch; the hoisted dropout masks. Tolerance 1e-5 (absolute, and relative
for gradients that sum over every step): f32 on both sides, only the
summation order of the products differs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stjep_tpu.config import ModelConfig
from stjep_tpu.models.las_decoder import DecodeState, las_decoder_step_core
from stjep_tpu.models.las_decoder import las_decoder_forward as jax_las_decoder
from stjep_tpu.models.seq2seq import init_seq2seq as jax_init
from stjep_tpu.ops.attention import precompute_keys as jax_precompute_keys
from stjep_tpu_torch.bridge import params_from_numpy
from stjep_tpu_torch.models.las_decoder import _make_drop_masks, las_decoder_forward
from stjep_tpu_torch.ops.las_tf_flash import las_tf_scan

TOL = 1e-5
CFG = ModelConfig(
    enc_vocab_size=50, dec_vocab_size=40, enc_embedding_size=16,
    dec_embedding_size=128, acous_dim=8, acous_hidden_size=64, dim_model=128,
    dim_feedforward=256, num_heads=4, enc_layers=2, dec_layers=2,
    num_unilstm_dec=3, spec_aug=False, dropout=0.0, max_seq_len_src=12,
    max_seq_len_tgt=16, mode="ASR_ST")
S, B, TK = 7, 3, 8
HD, HA2, E = CFG.dim_model, 2 * CFG.acous_hidden_size, CFG.enc_embedding_size
STACK = ("dec_l0", "dec_l1", "dec_l2")


@pytest.fixture(scope="module")
def dec_params():
    return jax.tree_util.tree_map(
        np.asarray, jax_init(jax.random.PRNGKey(0), CFG))["las"]["decoder"]


def _jax_scan(p, emb, acous, lens, masks):
    """The JAX package's XLA teacher-forced scan, as las_decoder_forward
    builds it, with the layer-0 pre-activation computed from w_ih inside."""
    p0 = p["dec_l0"]
    pre0 = emb @ p0["w_ih"][:E] + p0["b_ih"] + p0["b_hh"]
    pre_keys = jax_precompute_keys(p["acous_att"], acous, "bilinear")
    att_mask = jnp.arange(TK)[None, :] >= lens[:, None]
    init = DecodeState(
        h=jnp.zeros((3, B, HD)), c=jnp.zeros((3, B, HD)),
        cell_value=jnp.zeros((B, HD)), prev_c=jnp.zeros((B, 1, TK)),
        symbol=jnp.zeros((B,), jnp.int32), lengths=jnp.zeros((B,), jnp.int32),
        ctx=jnp.zeros((B, 3), jnp.int32))

    def body(state, xs):
        m = None if masks is None else (xs[1], xs[2])
        cell, _, state = las_decoder_step_core(p, CFG, pre_keys, acous, att_mask,
                                               xs[0], state, masks=m,
                                               emb_is_pre0=True)
        return state, cell

    xs = (pre0,) + (() if masks is None else masks)
    return jax.lax.scan(body, init, xs)[1]


@pytest.mark.parametrize("use_masks", [False, True], ids=["no_masks", "masks"])
def test_las_tf_scan_matches_jax_vjp(dec_params, use_masks):
    rng = np.random.RandomState(int(use_masks))
    emb = rng.randn(S, B, E).astype(np.float32)
    acous = rng.randn(B, TK, HA2).astype(np.float32)
    lens = np.array([TK, 3, 1], np.int32)
    g = rng.randn(S, B, HD).astype(np.float32)
    masks = None
    if use_masks:
        masks = ((rng.rand(S, 3, B, HD) < 0.8).astype(np.float32) / 0.8,
                 (rng.rand(S, B, 1, HA2) < 0.8).astype(np.float32) / 0.8)
    jm = None if masks is None else tuple(map(jnp.asarray, masks))
    out, vjp = jax.vjp(lambda p, e, a: _jax_scan(p, e, a, jnp.asarray(lens), jm),
                       dec_params, jnp.asarray(emb), jnp.asarray(acous))
    d_p, d_emb, d_acous = vjp(jnp.asarray(g))

    tp = params_from_numpy(dec_params)
    leaves = {k: tp[k] for k in STACK}
    for lp in leaves.values():
        for t in lp.values():
            t.requires_grad_(True)
    att_w = tp["acous_att"]["linear_att_w"]["w"].requires_grad_(True)
    ffn_w = tp["acous_ffn"]["w"].requires_grad_(True)
    te = torch.from_numpy(emb).requires_grad_(True)
    ta = torch.from_numpy(acous).requires_grad_(True)
    # dec_l0.w_ih enters twice: its embedding rows through pre0 (plain
    # autograd here), its cell rows inside the Function; autograd sums them
    p0 = tp["dec_l0"]
    pre0 = te @ p0["w_ih"][:E] + p0["b_ih"] + p0["b_hh"]
    tm = None if masks is None else tuple(map(torch.from_numpy, masks))
    o = las_tf_scan(leaves, att_w, ffn_w, pre0, ta, torch.from_numpy(lens), tm)
    o.backward(torch.from_numpy(g))

    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out), atol=TOL, rtol=0)
    close = lambda a, b, nm: np.testing.assert_allclose(
        a.numpy(), np.asarray(b), atol=TOL, rtol=TOL, err_msg=nm)
    close(te.grad, d_emb, "emb")
    close(ta.grad, d_acous, "acous")
    close(att_w.grad, d_p["acous_att"]["linear_att_w"]["w"], "att_w")
    close(ffn_w.grad, d_p["acous_ffn"]["w"], "ffn_w")
    for k in STACK:
        for kk in ("w_ih", "w_hh", "b_ih", "b_hh"):
            close(tp[k][kk].grad, d_p[k][kk], f"{k}/{kk}")
    # both parts of dec_l0.w_ih are non-zero: the sum is what is pinned
    assert float(p0["w_ih"].grad[:E].abs().max()) > 0
    assert float(p0["w_ih"].grad[E:].abs().max()) > 0


def test_teacher_forced_decoder_matches_jax(dec_params):
    """The static teacher-forced branch with ref tokens: embeddings, picked
    log-probs, argmax symbols and lengths."""
    rng = np.random.RandomState(5)
    L = CFG.max_seq_len_src
    acous = rng.randn(B, TK, HA2).astype(np.float32)
    acous_lens = np.array([64, 20, 7], np.int32)  # round_up8 // 8 -> 9 (all), 3, 1
    tgt = rng.randint(4, CFG.enc_vocab_size, (B, L)).astype(np.int32)
    tgt[:, 0] = 2
    tgt[2, 6:] = 0
    ref = tgt[:, 1:]
    r = jax_las_decoder(dec_params, CFG, jnp.asarray(acous), jnp.asarray(acous_lens),
                        tgt=jnp.asarray(tgt), use_teacher_forcing=True,
                        ref_tokens=jnp.asarray(ref))
    o = las_decoder_forward(params_from_numpy(dec_params), CFG,
                            torch.from_numpy(acous), torch.from_numpy(acous_lens),
                            tgt=torch.from_numpy(tgt), use_teacher_forcing=True,
                            ref_tokens=torch.from_numpy(ref))
    np.testing.assert_allclose(o[0].numpy(), np.asarray(r[0]), atol=TOL, rtol=0)
    np.testing.assert_allclose(o[1].numpy(), np.asarray(r[1]), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(o[2].numpy(), np.asarray(r[2]))
    np.testing.assert_array_equal(o[3].numpy(), np.asarray(r[3]))


def test_hoisted_dropout_masks():
    """Two draws, inverted-dropout values, the JAX shapes; one seed, one mask."""
    cfg = ModelConfig(**{**CFG.__dict__, "dropout": 0.25})
    draw = lambda seed: _make_drop_masks(torch.Generator().manual_seed(seed), cfg,
                                         S, B, HA2, "cpu")
    lstm_m, ctx_m = draw(3)
    assert lstm_m.shape == (S, 3, B, HD) and ctx_m.shape == (S, B, 1, HA2)
    for m in (lstm_m, ctx_m):
        assert set(torch.unique(m).tolist()) == {0.0, float(np.float32(1.0) / np.float32(0.75))}
        assert abs(float((m > 0).float().mean()) - 0.75) < 0.05
    again = draw(3)
    assert torch.equal(again[0], lstm_m) and torch.equal(again[1], ctx_m)
    assert not torch.equal(draw(4)[0], lstm_m)
