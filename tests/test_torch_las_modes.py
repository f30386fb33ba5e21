"""Port vs JAX on CPU: the LAS decoder where JAX runs its XLA scan of
`las_decoder_step_core` rather than a kernel, and the port its plain step
loop: the attention modes dot_prod, bahdanau and hybrid, a bilinear stack
of 2 or 4 decoder LSTMs, and widths off the kernels' tiles. Free running
(greedy, with picked log-probs) and teacher forced, then the ASR train
step's loss and every gradient against `jax.value_and_grad`. Tolerances as
tests/test_torch_las_tf.py and tests/test_torch_train.py: f32 on both
sides, other summation orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stjep_tpu.config import ModelConfig
from stjep_tpu.models.las_decoder import las_decoder_forward as jax_las_decoder
from stjep_tpu.models.seq2seq import forward_train as jax_forward_train
from stjep_tpu.models.seq2seq import init_seq2seq as jax_init
from stjep_tpu_torch.bridge import named_leaves, params_from_numpy
from stjep_tpu_torch.config import ModelConfig as TorchConfig
from stjep_tpu_torch.models.las_decoder import las_decoder_forward
from stjep_tpu_torch.models.seq2seq import init_seq2seq
from stjep_tpu_torch.ops.las_flash import las_flash_supported
from stjep_tpu_torch.ops.las_tf_flash import las_tf_flash_supported
from stjep_tpu_torch.train.trainer import compute_grads
from tests.test_torch_train import _batch, _jax_kw, _torch_mb, _trainer

TOL = 1e-5
BASE = dict(
    enc_vocab_size=50, dec_vocab_size=40, enc_embedding_size=16,
    dec_embedding_size=128, acous_dim=8, acous_hidden_size=64, dim_model=128,
    dim_feedforward=256, num_heads=4, enc_layers=2, dec_layers=2,
    num_unilstm_dec=3, spec_aug=False, dropout=0.0, max_seq_len_src=12,
    max_seq_len_tgt=16, mode="ASR_ST")
# each a configuration JAX decodes through its XLA scan
CASES = {
    "dot_prod": dict(acous_att_mode="dot_prod"),
    "bahdanau": dict(acous_att_mode="bahdanau"),
    "hybrid": dict(acous_att_mode="hybrid"),
    "dec2": dict(num_unilstm_dec=2),
    "dec4": dict(num_unilstm_dec=4),
    "narrow": dict(dim_model=96, dec_embedding_size=96),  # off the kernels' 128 tile
}
B, TK = 3, 8


def _cfgs(case):
    kw = {**BASE, **CASES[case]}
    return ModelConfig(**kw), TorchConfig(**kw)


@pytest.fixture(scope="module")
def models():
    out = {}
    for case in CASES:
        jcfg, tcfg = _cfgs(case)
        jp = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(0), jcfg))
        out[case] = (jcfg, tcfg, jp)
    return out


def _inputs(tcfg, seed):
    rng = np.random.RandomState(seed)
    acous = rng.randn(B, TK, 2 * tcfg.acous_hidden_size).astype(np.float32)
    acous_lens = np.array([64, 20, 7], np.int32)  # round_up8 // 8 -> 8 (all), 3, 1
    L = tcfg.max_seq_len_src
    tgt = rng.randint(4, tcfg.enc_vocab_size, (B, L)).astype(np.int32)
    tgt[:, 0] = 2
    tgt[2, 6:] = 0
    return acous, acous_lens, tgt


def test_cases_take_the_step_loop(models):
    """Each case is one where JAX takes its XLA scan: no kernel condition holds."""
    for case, (_, tcfg, _) in models.items():
        tf_kernel = tcfg.num_unilstm_dec == 3 and las_tf_flash_supported(tcfg)
        assert not tf_kernel, case
        if tcfg.acous_att_mode != "bilinear" or case == "narrow":
            assert not las_flash_supported(tcfg), case


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("teacher_forced", [False, True], ids=["free", "tf"])
def test_decoder_matches_jax(models, case, teacher_forced):
    jcfg, tcfg, jp = models[case]
    acous, acous_lens, tgt = _inputs(tcfg, 5)
    dec = jp["las"]["decoder"]
    ref = tgt[:, 1:]
    kw = dict(tgt=tgt, use_teacher_forcing=True) if teacher_forced else {}
    r = jax_las_decoder(dec, jcfg, jnp.asarray(acous), jnp.asarray(acous_lens),
                        ref_tokens=jnp.asarray(ref), want_logps=False,
                        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                           for k, v in kw.items()})
    o = las_decoder_forward(params_from_numpy(dec), tcfg, torch.from_numpy(acous),
                            torch.from_numpy(acous_lens), ref_tokens=torch.from_numpy(ref),
                            **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                               for k, v in kw.items()})
    np.testing.assert_allclose(o[0].numpy(), np.asarray(r[0]), atol=TOL, rtol=0)
    np.testing.assert_allclose(o[1].numpy(), np.asarray(r[1]), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(o[2].numpy(), np.asarray(r[2]))
    np.testing.assert_array_equal(o[3].numpy(), np.asarray(r[3]))


@pytest.mark.parametrize("case", list(CASES))
def test_init_tree_matches_jax(models, case):
    """The port's init builds the JAX tree: the same key paths and shapes."""
    _, tcfg, jp = models[case]
    mine = dict(named_leaves(init_seq2seq(tcfg, torch.Generator().manual_seed(0), "cpu")))
    ref = dict(named_leaves(jp))
    assert mine.keys() == ref.keys()
    assert all(tuple(mine[k].shape) == ref[k].shape for k in ref)


@pytest.mark.parametrize("case", ["dot_prod", "bahdanau", "hybrid", "dec2", "dec4"])
def test_train_step_gradients_match_jax(models, tmp_path, case):
    """The ASR train step (teacher-forced LAS through the step loop): loss
    and every gradient leaf against jax.value_and_grad."""
    jcfg, tcfg, jp = models[case]
    mode, mb = "ASR", _batch(1)
    tr = _trainer(tmp_path, mode)

    def loss(p):
        out = jax_forward_train(p, jcfg, mode, rng=jax.random.PRNGKey(0), is_training=False,
                                ref_pick=True, **_jax_kw(mb, mode))
        return tr._head_losses(jcfg, out, {k: jnp.asarray(v) for k, v in mb.items()}, 1.0)[0]

    r_loss, r_grads = jax.value_and_grad(loss)(jax.tree_util.tree_map(jnp.asarray, jp))
    tp = params_from_numpy(jp)
    losses, grads = compute_grads(tcfg, mode, tp, [_torch_mb(mb, mode)],
                                  torch.Generator().manual_seed(0), is_training=False)
    np.testing.assert_allclose(float(sum(losses.values())), float(r_loss), rtol=TOL)
    ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, r_grads)))
    mine = dict(zip(dict(named_leaves(tp)).keys(), grads))
    assert mine.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(mine[k].numpy(), ref[k], rtol=1e-4, atol=1e-6, err_msg=k)
