"""The port's K-step train window and its bf16 train step.

- `train_window` (Trainer._window_stream): with the device feature cache on
  (here on the CPU), K steps run back to back as a window; the params
  after the run equal the single-step path's (same batches, generator
  splits and LRs), with dropout on, within 1e-6 of each leaf's norm, and
  the window stream's grouping equals JAX's `_window_stream` on the same
  bucket sequences (tests/test_train_window.py's cases).
- bf16: one step's loss and gradients against JAX's bf16 step from the same
  bf16 init (tests/test_bf16.py's config, dropout 0, SpecAugment off, no
  attention-probability dropout). The port casts at K8's and K9's f32
  boundary where JAX runs its XLA scans in bf16, and the two sum in other
  orders, so they round at other points; the tolerance is measured (see
  test_bf16_step_matches_jax).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stjep_tpu.config import BOS
from stjep_tpu.config import ModelConfig as JConfig
from stjep_tpu.models.seq2seq import forward_train as jforward_train
from stjep_tpu.models.seq2seq import init_seq2seq as jinit
from stjep_tpu.ops import transformer as jtransformer
from stjep_tpu.train import trainer as jtrainer

from stjep_tpu_torch.bridge import leaves, named_leaves, params_from_numpy
from stjep_tpu_torch.config import ModelConfig
from stjep_tpu_torch.data.dataset import Dataset
from stjep_tpu_torch.models.seq2seq import init_seq2seq
from stjep_tpu_torch.ops import transformer as ttransformer
from stjep_tpu_torch.train.trainer import Trainer_ASR_ST, compute_grads

from tests.data_factory import make_corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(str(tmp_path_factory.mktemp("corpus")), n_sent=32)


def _dataset(corpus):
    return Dataset(path_src=corpus["path_src"], path_tgt=corpus["path_tgt"],
                   path_vocab_src=corpus["path_vocab_src"],
                   path_vocab_tgt=corpus["path_vocab_tgt"],
                   acous_path=corpus["acous_path"],
                   acous_norm_path=corpus["acous_norm_path"], acous_norm=True,
                   max_seq_len_src=16, max_seq_len_tgt=32, batch_size=8,
                   use_type="char", mode="ST", seed=5)


def _cfg(corpus, dropout):
    return ModelConfig(
        enc_vocab_size=corpus["vocab_src_size"], dec_vocab_size=corpus["vocab_tgt_size"],
        enc_embedding_size=8, dec_embedding_size=12, acous_dim=corpus["acous_dim"],
        acous_hidden_size=6, dim_model=12, dim_feedforward=24, num_heads=2,
        enc_layers=2, dec_layers=2, num_unilstm_dec=3, spec_aug=True,
        dropout=dropout, max_seq_len_src=16, max_seq_len_tgt=32, mode="ASR_ST")


@pytest.mark.parametrize("feat_dtype", [None, "int8"])
def test_window_matches_single_steps(corpus, tmp_path, feat_dtype):
    """2 epochs x 4 steps, train_window 4 against 1, dropout 0.2 and
    SpecAugment on: every param leaf within 1e-6 of its norm."""
    cfg = _cfg(corpus, 0.2)
    outs = {}
    for win in (1, 4):
        t = Trainer_ASR_ST(expt_dir=str(tmp_path / f"w{win}"), batch_size=8,
                           minibatch_partition=2, checkpoint_every=10 ** 9,
                           print_every=10 ** 9, learning_rate=0.003,
                           learning_rate_init=0.003, lr_warmup_steps=0, seed=0,
                           device_cache=True, feat_dtype=feat_dtype,
                           train_window=win, device="cpu")
        params = init_seq2seq(cfg, torch.Generator().manual_seed(0))
        _, outs[win] = t.train({"st": _dataset(corpus)}, (cfg, params), num_epochs=2)
        assert t.steps_run == 8
        assert t.windows_run == (2 if win == 4 else 0)
    for (name, a), b in zip(named_leaves(outs[1]), leaves(outs[4])):
        a, b = a.detach(), b.detach()
        err = float((a - b).norm() / max(float(a.norm()), 1e-12))
        assert err <= 1e-6, (name, err)


@pytest.mark.parametrize("case", [
    ([64] * 10, 5, 10 ** 9),
    ([64, 64, 64, 128, 128, 128, 128, 128, 128, 128], 5, 10 ** 9),
    ([64] * 7 + [128] * 6, 3, 4),
    ([32, 64] * 5, 10 ** 9, 10 ** 9),
])
def test_window_stream_equals_jax(tmp_path, case):
    """The grouping of batches into windows and singles, on fake staging:
    print/checkpoint boundaries, bucket changes and the epoch's end."""
    buckets, print_every, ckpt_every = case
    kw = dict(batch_size=8, checkpoint_every=ckpt_every, print_every=print_every,
              learning_rate=0.003, learning_rate_init=0.003, lr_warmup_steps=0,
              device_cache=True)
    streams = []
    for t in (jtrainer.Trainer_ASR_ST(expt_dir=str(tmp_path / "j"), **kw),
              Trainer_ASR_ST(expt_dir=str(tmp_path / "t"), device="cpu", **kw)):
        t._host_macro = lambda item: ({"x": np.zeros((1, 1), np.int32)}, 1.0, buckets[item])
        t._place_macro = lambda s, batch_axis=1: ("S", s[2])
        t._stage_window = lambda ss: ("W", ss[0][2], None, len(ss))  # JAX's only
        for step0 in (0, 3):
            # the port yields a window as the list of its staged steps
            streams.append([("W", o[0][1], None, len(o)) if isinstance(o, list) else tuple(o)
                            for o in t._window_stream(
                                iter(range(len(buckets))), step0, len(buckets) + step0, 2)])
    n = len(streams) // 2
    assert streams[:n] == streams[n:]
    assert sum(o[3] if o[0] == "W" else 1 for o in streams[0]) == len(buckets)


# ----------------------------------------------------------------- bf16

def _bf16_cfg():
    return dict(enc_vocab_size=20, dec_vocab_size=16, enc_embedding_size=8,
                dec_embedding_size=16, acous_dim=8, acous_hidden_size=8,
                dim_model=16, dim_feedforward=32, num_heads=4, enc_layers=1,
                dec_layers=1, num_unilstm_dec=2, spec_aug=False, dropout=0.0,
                max_seq_len_src=8, max_seq_len_tgt=8, mode="ASR_ST")


def _bf16_inputs(seed):
    rng = np.random.RandomState(seed)
    feats = rng.randn(2, 16, 8).astype(np.float32)
    lens = np.array([14, 8], np.int32)
    src = rng.randint(5, 20, (2, 8)).astype(np.int32)
    tgt = rng.randint(5, 16, (2, 8)).astype(np.int32)
    src[:, 0] = tgt[:, 0] = BOS
    src[1, 6:] = tgt[1, 5:] = 0
    return feats, lens, src, tgt


@pytest.fixture(scope="module")
def jax_bf16_grads():
    """JAX's masked-NLL loss and gradients, one jitted program for every
    seed (the attention-probability dropout is patched to 0 before it is
    traced)."""
    jcfg = JConfig(**_bf16_cfg())

    @jax.jit
    def value_and_grad(p, feats, lens, src, tgt):
        def loss(p):
            out = jforward_train(p, jcfg, "ASR_ST", src, tgt=tgt, acous_feats=feats,
                                 acous_lens=lens, rng=jax.random.PRNGKey(1),
                                 is_training=True, ref_pick=True)
            total = 0.0
            for key, ids in (("picked_asr", src), ("picked_st", tgt)):
                m = (ids[:, 1:] != 0).astype(jnp.float32)
                total = total - jnp.sum(out[key] * m) / jnp.maximum(jnp.sum(m), 1.0)
            return total
        return jax.value_and_grad(loss)(p)

    return jcfg, value_and_grad


def _rel_errs(mine, ref):
    """Each leaf's error relative to the reference's norm (at least 1e-3)."""
    return {k: float(np.linalg.norm(np.asarray(mine[k], np.float64) - np.asarray(ref[k], np.float64))
                     / max(np.linalg.norm(np.asarray(ref[k], np.float64)), 1e-3)) for k in ref}


def _bf16_steps(seed, jvg, jcfg, port_dtype):
    """JAX's bf16 step and its f32 step from the same (bf16-valued) init,
    and the port's step in port_dtype from that init: (JAX bf16 loss,
    JAX bf16 grads, JAX f32 grads, port loss, port grads), grads by leaf
    name."""
    jparams = jinit(jax.random.PRNGKey(seed), jcfg, dtype=jnp.bfloat16)
    feats, lens, src, tgt = _bf16_inputs(seed)
    jfeats = jnp.asarray(feats, jnp.bfloat16)
    jl, jg = jvg(jparams, jfeats, lens, src, tgt)
    _, jg32 = jvg(jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), jparams),
                  jfeats.astype(jnp.float32), lens, src, tgt)
    params = params_from_numpy(jax.device_get(jparams))
    assert {t.dtype for t in leaves(params)} == {torch.bfloat16}
    params = jax.tree_util.tree_map(lambda t: t.to(port_dtype), params)
    mb = {"srcid": torch.from_numpy(src), "tgtid": torch.from_numpy(tgt),
          "acous_feat": torch.from_numpy(feats).to(torch.bfloat16).to(port_dtype),
          "acouslen": torch.from_numpy(lens)}
    losses, grads = compute_grads(ModelConfig(**_bf16_cfg()), "ASR_ST", params, [mb],
                                  torch.Generator().manual_seed(1))
    assert all(g.dtype == port_dtype for g in grads)
    tl = float(losses["nll_loss_en"] + losses["nll_loss_de"])
    return (float(jl), dict(named_leaves(jax.device_get(jg))),
            dict(named_leaves(jax.device_get(jg32))), tl,
            {name: g.double().numpy() for (name, _), g in zip(named_leaves(params), grads)})


# the median leaf's distance from JAX's f32 step that a step computed in
# bf16 shows at least (see test_bf16_step_matches_jax)
BF16_ROUNDING_FLOOR = 4e-3


@pytest.mark.parametrize("seed", [0, 3])
def test_bf16_step_matches_jax(seed, jax_bf16_grads, monkeypatch):
    """The port's bf16 loss and gradients against JAX's bf16 step, each
    leaf's error relative to its norm (at least 1e-3). Measured on seeds
    0-5: loss within 7.2e-4 relative, the worst leaf 0.079 of its norm
    (seed 0: 5.1e-5 and 0.041; seed 3: 6.4e-4 and 0.079). Held to 2e-3 and
    0.12. These limits do not tell a bf16 step from an f32 one: the port's
    step computed in f32 from the same bf16 init reads 5.1e-4 and 0.039 on
    seed 0, 1.6e-4 and 0.072 on seed 3 against JAX's bf16 step, since two
    bf16 steps that round at other points differ as much as bf16 from f32.
    So the step must also round as bf16 does: the median leaf's distance
    from JAX's f32 step on the same init is at least 4e-3 of its norm.
    Measured on seeds 0-5: JAX's own bf16 step 0.0088-0.027, the port's
    0.0076-0.029; an f32 step rounded to bf16 only at its output 0.0016-0.0017
    (test_bf16_floor_refuses_an_f32_step)."""
    monkeypatch.setattr(jtransformer, "ATTN_DROPOUT", 0.0)
    monkeypatch.setattr(ttransformer, "ATTN_DROPOUT", 0.0)
    jcfg, jvg = jax_bf16_grads
    jl, jgrads, jgrads32, tl, grads = _bf16_steps(seed, jvg, jcfg, torch.bfloat16)
    loss_err = abs(tl - jl) / abs(jl)
    errs = _rel_errs(grads, jgrads)
    worst = max(errs, key=errs.get)
    rounding = float(np.median(list(_rel_errs(grads, jgrads32).values())))
    print(f"bf16 seed {seed}: loss rel err {loss_err:.3e}, worst grad {worst} {errs[worst]:.3e}, "
          f"median distance from f32 {rounding:.3e}")
    assert loss_err <= 2e-3
    assert errs[worst] <= 0.12, (worst, errs[worst])
    assert rounding >= BF16_ROUNDING_FLOOR


@pytest.mark.parametrize("seed", [0, 3])
def test_bf16_floor_refuses_an_f32_step(seed, jax_bf16_grads, monkeypatch):
    """The control: the port's step computed in f32 from the same bf16
    init, its gradients rounded to bf16 at the end (a step upcast inside),
    falls below the rounding floor that test_bf16_step_matches_jax holds
    the bf16 step to."""
    monkeypatch.setattr(jtransformer, "ATTN_DROPOUT", 0.0)
    monkeypatch.setattr(ttransformer, "ATTN_DROPOUT", 0.0)
    jcfg, jvg = jax_bf16_grads
    jl, jgrads, jgrads32, tl, grads = _bf16_steps(seed, jvg, jcfg, torch.float32)
    rounded = {k: torch.from_numpy(g).to(torch.bfloat16).double().numpy() for k, g in grads.items()}
    errs = _rel_errs(rounded, jgrads)
    rounding = float(np.median(list(_rel_errs(rounded, jgrads32).values())))
    print(f"f32 step seed {seed}: against JAX's bf16 step loss rel err {abs(tl - jl) / abs(jl):.3e}, "
          f"worst grad {max(errs.values()):.3e}; median distance from f32 {rounding:.3e}")
    assert rounding < BF16_ROUNDING_FLOOR
