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
from stjep_tpu_torch.ops.transformer import split
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


def _run_both(models, case, **kw):
    jcfg, tcfg, jp = models[case]
    acous, acous_lens, tgt = _inputs(tcfg, 5)
    dec = jp["las"]["decoder"]
    r = jax_las_decoder(dec, jcfg, jnp.asarray(acous), jnp.asarray(acous_lens),
                        tgt=jnp.asarray(tgt), ref_tokens=jnp.asarray(tgt[:, 1:]),
                        want_logps=False, **kw)
    o = las_decoder_forward(params_from_numpy(dec), tcfg, torch.from_numpy(acous),
                            torch.from_numpy(acous_lens), tgt=torch.from_numpy(tgt),
                            ref_tokens=torch.from_numpy(tgt[:, 1:]), **kw)
    return r, o


@pytest.mark.parametrize("ratio", [1.0, 0.0, 2.0, -1.0])
def test_teacher_forcing_ratio_static_branches_match_jax(models, ratio):
    """teacher_forcing_ratio >= 1 is teacher forced and <= 0 free running
    from tgt[:, 0] over tgt's length, in both packages (no draw)."""
    r, o = _run_both(models, "dec2", teacher_forcing_ratio=ratio)
    np.testing.assert_allclose(o[0].numpy(), np.asarray(r[0]), atol=TOL, rtol=0)
    np.testing.assert_allclose(o[1].numpy(), np.asarray(r[1]), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(o[2].numpy(), np.asarray(r[2]))
    np.testing.assert_array_equal(o[3].numpy(), np.asarray(r[3]))


def test_teacher_forcing_coin_runs_the_drawn_branch(models):
    """A ratio in (0, 1) draws one coin from the generator (JAX draws a
    traced bernoulli, so the two packages' coins differ) and then runs
    that branch exactly; over 8 seeds both branches are drawn."""
    _, tcfg, jp = models["dec2"]
    acous, acous_lens, tgt = (torch.from_numpy(x) for x in _inputs(tcfg, 5))
    dec = params_from_numpy(jp["las"]["decoder"])

    def run(**kw):
        return las_decoder_forward(dec, tcfg, acous, acous_lens, tgt=tgt,
                                   ref_tokens=tgt[:, 1:], **kw)

    branches = {True: run(teacher_forcing_ratio=1.0), False: run(teacher_forcing_ratio=0.0)}
    drawn = set()
    for seed in range(8):
        g = torch.Generator().manual_seed(seed)
        coin = bool(torch.rand((), generator=split(torch.Generator().manual_seed(seed))[1]) < 0.5)
        out = run(teacher_forcing_ratio=0.5, generator=g)
        for a, b in zip(out, branches[coin]):
            assert torch.equal(a, b), seed
        drawn.add(coin)
    assert drawn == {True, False}


@pytest.mark.parametrize("case,batch", [("dec2", 2), ("hybrid", 1)])
def test_st_alone_gradients_match_jax(models, tmp_path, case, batch):
    """ST alone: the LAS runs free (no dropout, no SpecAugment) and the
    translation loss differentiates through its step loop, as JAX's XLA
    scan: the loss and every gradient leaf against jax.value_and_grad.
    The hybrid model on batch 2 holds a ReLU tie and has a test of its own
    below."""
    jcfg, tcfg, jp = models[case]
    mode, mb = "ST", _batch(batch)
    tr = _trainer(tmp_path, mode)

    def loss(p):
        out = jax_forward_train(p, jcfg, mode, rng=jax.random.PRNGKey(0), is_training=False,
                                ref_pick=True, **_jax_kw(mb, mode))
        return tr._head_losses(jcfg, out, {k: jnp.asarray(v) for k, v in mb.items()}, 1.0)[0]

    r_loss, r_grads = jax.jit(jax.value_and_grad(loss))(jax.tree_util.tree_map(jnp.asarray, jp))
    tp = params_from_numpy(jp)
    tmb = {k: torch.from_numpy(v) for k, v in mb.items()}
    losses, grads = compute_grads(tcfg, mode, tp, [tmb], torch.Generator().manual_seed(0),
                                  is_training=False)
    np.testing.assert_allclose(float(sum(losses.values())), float(r_loss), rtol=TOL)
    ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, r_grads)))
    mine = dict(zip(dict(named_leaves(tp)).keys(), grads))
    assert any(float(g.abs().max()) > 0 for k, g in mine.items() if k.startswith("/las/decoder"))
    for k in ref:
        np.testing.assert_allclose(mine[k].numpy(), ref[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_st_alone_relu_tie_pinned_matches_jax(models, tmp_path, monkeypatch):
    """The hybrid model on batch 2 sits on a kink, and this test shows where.
    No LAS decision is near its threshold there (every greedy pick leads
    its runner-up by >= 1e-2 in f32 and float64 alike). One pre-activation
    of the target decoder's first FFN ReLU is 2.1e-7 in float64 and
    -1.7e-7 in the port's f32 pass, within that pass's own rounding of the
    layer (max |f32 - float64| 2.1e-6). A unit that rounds to the other side
    of 0 changes the gradient by 5.7e-3 of a leaf's norm. So: every ReLU
    input whose float64 value lies within the f32 pass's rounding of 0 is a
    tie, there is at least one, and each is pinned to its float64 side in
    both packages. The port's f32 gradients then match JAX's at the other
    cases' tolerance, and the port's own float64 ones to 1e-5 of each leaf's
    norm."""
    jcfg, tcfg, jp = models["hybrid"]
    mode, mb = "ST", _batch(2)
    tr = _trainer(tmp_path, mode)
    relu_t, relu_j = torch.relu, jax.nn.relu

    def port(dtype, pins=None):
        seen = []

        def relu(x):
            seen.append(x.detach().double())
            y = relu_t(x)
            if pins is not None:
                on, off = (torch.from_numpy(m) for m in pins[len(seen) - 1])
                y = torch.where(on, x, torch.where(off, torch.zeros_like(x), y))
            return y

        tp = jax.tree_util.tree_map(lambda t: t.to(dtype), params_from_numpy(jp))
        tmb = {k: torch.from_numpy(v) for k, v in mb.items()}
        tmb["acous_feat"] = tmb["acous_feat"].to(dtype)
        monkeypatch.setattr(torch, "relu", relu)
        try:
            losses, grads = compute_grads(tcfg, mode, tp, [tmb], torch.Generator().manual_seed(0),
                                          is_training=False)
        finally:
            monkeypatch.setattr(torch, "relu", relu_t)
        g = dict(zip(dict(named_leaves(tp)).keys(), (x.double().numpy() for x in grads)))
        return float(sum(losses.values())), g, [x.numpy() for x in seen]

    _, g64, x64 = port(torch.float64)
    _, _, x32 = port(torch.float32)
    assert len(x32) == len(x64) == jcfg.enc_layers + jcfg.dec_layers
    pins, n_tie = [], 0
    for a, b in zip(x32, x64):
        band = np.abs(a - b).max()  # the f32 pass's rounding of this layer
        tie = np.abs(b) <= band
        assert not ((a > 0) != (b > 0))[~tie].any()  # every sign flip is a tie
        n_tie += int(tie.sum())
        pins.append((tie & (b > 0), tie & (b <= 0)))
        if tie.any():
            print(f"ReLU ties: float64 {b[tie].tolist()}, f32 {a[tie].tolist()}, band {band:.2e}")
    assert n_tie >= 1

    def loss(p):
        seen = []

        def relu(x):
            seen.append(x)
            on, off = pins[len(seen) - 1]
            return jnp.where(on, x, jnp.where(off, 0.0, relu_j(x)))

        monkeypatch.setattr(jax.nn, "relu", relu)
        try:
            out = jax_forward_train(p, jcfg, mode, rng=jax.random.PRNGKey(0),
                                    is_training=False, ref_pick=True, **_jax_kw(mb, mode))
        finally:
            monkeypatch.setattr(jax.nn, "relu", relu_j)
        return tr._head_losses(jcfg, out, {k: jnp.asarray(v) for k, v in mb.items()}, 1.0)[0], seen

    (r_loss, xj), r_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, jp))
    for a, b, (on, off) in zip(xj, x64, pins):  # JAX's f32 pass sees the same ties
        a = np.asarray(a, np.float64)
        assert np.abs(b[on | off]).max(initial=0.0) <= np.abs(a - b).max() * 4
    l32, g32, _ = port(torch.float32, pins)
    np.testing.assert_allclose(l32, float(r_loss), rtol=TOL)
    ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, r_grads)))
    for k in ref:
        np.testing.assert_allclose(g32[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)
        assert np.linalg.norm(g32[k] - g64[k]) <= 1e-5 * np.linalg.norm(g64[k]) + 1e-12, k
