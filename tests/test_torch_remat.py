"""`cfg.remat` (torch.utils.checkpoint per transformer layer in training)
on the CPU.

- With dropout 0.2 the remat step's loss and every gradient leaf are
  bit-equal to the non-remat step from one seed: the checkpointed layer
  builds its dropout generator from the hop's seed, so the backward's
  recompute replays the forward's masks.
- Against JAX's remat step (jax.checkpoint per layer, is_training=True)
  with dropout off: the loss within 1e-5 and each gradient leaf within
  1e-5 of its norm. Attention-probability dropout (fixed at 0.1 whatever
  the rate) is patched to 0 on both sides, since the two frameworks'
  random streams cannot match.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from stjep_tpu.config import ModelConfig
from stjep_tpu.models.seq2seq import forward_train as jax_forward_train
from stjep_tpu.models.seq2seq import init_seq2seq as jax_init
from stjep_tpu.ops import transformer as jtransformer
from stjep_tpu.train.trainer import Trainer
from stjep_tpu_torch.bridge import named_leaves, params_from_numpy
from stjep_tpu_torch.ops import transformer as ttransformer
from stjep_tpu_torch.train.trainer import compute_grads

CFG = ModelConfig(
    enc_vocab_size=30, dec_vocab_size=24, enc_embedding_size=16,
    dec_embedding_size=32, acous_dim=8, acous_hidden_size=16, dim_model=32,
    dim_feedforward=64, num_heads=4, enc_layers=2, dec_layers=2,
    num_unilstm_dec=3, spec_aug=False, dropout=0.0, max_seq_len_src=10,
    max_seq_len_tgt=12, mode="ASR_ST", remat=True)
B, T = 3, 48
KINDS = {"standard": CFG, "universal": dataclasses.replace(CFG, transformer_type="universal")}


def _batch(seed):
    rng = np.random.RandomState(seed)
    src = rng.randint(4, CFG.enc_vocab_size, (B, CFG.max_seq_len_src)).astype(np.int32)
    tgt = rng.randint(4, CFG.dec_vocab_size, (B, CFG.max_seq_len_tgt)).astype(np.int32)
    src[:, 0] = tgt[:, 0] = 2
    src[1, 6:] = tgt[2, 8:] = 0
    return {"srcid": src, "tgtid": tgt,
            "acous_feat": rng.randn(B, T, CFG.acous_dim).astype(np.float32),
            "acouslen": np.array([T, 29, 40], np.int32)}


def _keep(mb, mode):
    return {k: v for k, v in mb.items() if mode != "MT" or k in ("srcid", "tgtid")}


def _grads(cfg, mode, jp, mb, seed):
    """compute_grads on fresh params, with checkpoint calls counted."""
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    torch.utils.checkpoint.checkpoint = counted
    try:
        losses, grads = compute_grads(
            cfg, mode, params_from_numpy(jp),
            [{k: torch.from_numpy(v) for k, v in _keep(mb, mode).items()}],
            torch.Generator().manual_seed(seed))
    finally:
        torch.utils.checkpoint.checkpoint = real
    return losses, grads, len(calls)


@pytest.mark.parametrize("kind", list(KINDS))
def test_remat_bit_equal_to_plain_step_with_dropout(kind):
    cfg = dataclasses.replace(KINDS[kind], dropout=0.2, embedding_dropout=0.1)
    jp = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(1), cfg))
    mb = _batch(0)
    l_r, g_r, n_r = _grads(cfg, "ASR_ST", jp, mb, 7)
    l_p, g_p, n_p = _grads(dataclasses.replace(cfg, remat=False), "ASR_ST", jp, mb, 7)
    assert n_r == cfg.enc_layers + cfg.dec_layers and n_p == 0
    for k in l_p:
        assert torch.equal(l_r[k], l_p[k]), k
    moved = 0
    for a, b in zip(g_r, g_p):
        assert torch.equal(a, b)
        moved += int(bool(a.abs().sum() > 0))
    assert moved > len(g_p) // 2
    # another seed draws other masks: the equality above is not vacuous
    l_o, _, _ = _grads(cfg, "ASR_ST", jp, mb, 8)
    assert not torch.equal(l_o["nll_loss_de"], l_p["nll_loss_de"])


@pytest.mark.parametrize("kind,mode", [("standard", "MT"), ("universal", "ASR_ST")])
def test_remat_matches_jax_remat_step(kind, mode, tmp_path, monkeypatch):
    monkeypatch.setattr(jtransformer, "ATTN_DROPOUT", 0.0)
    monkeypatch.setattr(ttransformer, "ATTN_DROPOUT", 0.0)
    cfg = KINDS[kind]
    jp = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(2), cfg))
    mb = _batch(3)
    tr = Trainer(expt_dir=str(tmp_path))
    tr.MODE = mode
    jmb = {k: jnp.asarray(v) for k, v in _keep(mb, mode).items()}

    def loss(p):
        out = jax_forward_train(p, cfg, mode, src=jmb["srcid"], tgt=jmb["tgtid"],
                                acous_feats=jmb.get("acous_feat"),
                                acous_lens=jmb.get("acouslen"),
                                rng=jax.random.PRNGKey(0), is_training=True,
                                ref_pick=True)
        return tr._head_losses(cfg, out, jmb, 1.0)[0]

    ref_loss, ref_g = jax.jit(jax.value_and_grad(loss))(jax.tree_util.tree_map(jnp.asarray, jp))
    losses, grads, n = _grads(cfg, mode, jp, mb, 0)
    assert n == cfg.enc_layers + cfg.dec_layers
    total = sum(float(v) for v in losses.values())
    np.testing.assert_allclose(total, float(ref_loss), rtol=1e-5, atol=1e-5)
    ref = dict(named_leaves(ref_g))
    names = [n for n, _ in named_leaves(params_from_numpy(jp))]
    for name, g in zip(names, grads):
        r = np.asarray(ref[name])
        err = float(np.abs(g.numpy() - r).max())
        assert err <= 1e-5 * max(float(np.linalg.norm(r)), 1e-3), (name, err)
