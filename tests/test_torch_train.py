"""Port vs JAX on CPU: the ASR_ST / ASR / MT train step.

`forward_train` (ref_pick) and `head_losses` against the JAX package's
`forward_train` and `Trainer._head_losses`; the whole gradient tree against
`jax.value_and_grad`; two optimizer steps against `make_optimizer` +
`set_lr`; the LR schedule; SpecAugment's bounds and dropout's scaling.
The JAX side runs its CPU (non-Pallas) routes, the port its plain routes
through the same autograd.Functions the card uses. Dropout and SpecAugment
are off for the comparisons (is_training=False on both sides: the random
streams of the two frameworks cannot match). Tolerances: forward values
1e-5 (f32 both sides, other summation orders); gradients rtol 1e-4 /
atol 1e-6, since they sum over every step and position; params after Adam
1e-5. The JAX side is jitted once per mode (eager it takes ~25 s a call
on this host).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stjep_tpu.config import ModelConfig
from stjep_tpu.models.seq2seq import forward_train as jax_forward_train
from stjep_tpu.models.seq2seq import init_seq2seq as jax_init
from stjep_tpu.ops.losses import nll_loss_masked as jax_nll
from stjep_tpu.ops.losses import normalise as jax_normalise
from stjep_tpu.train import optim as jax_optim
from stjep_tpu.train.trainer import Trainer
from stjep_tpu_torch.bridge import leaves, named_leaves, params_from_numpy
from stjep_tpu_torch.models.las_encoder import spec_augment
from stjep_tpu_torch.models.seq2seq import forward_train
from stjep_tpu_torch.ops import losses
from stjep_tpu_torch.ops.transformer import dropout, split
from stjep_tpu_torch.train import optim
from stjep_tpu_torch.train.trainer import compute_grads, head_losses, make_train_step

TOL = 1e-5
CFG = ModelConfig(
    enc_vocab_size=50, dec_vocab_size=40, enc_embedding_size=16,
    dec_embedding_size=128, acous_dim=8, acous_hidden_size=64, dim_model=128,
    dim_feedforward=256, num_heads=4, enc_layers=2, dec_layers=2,
    num_unilstm_dec=3, spec_aug=False, dropout=0.0, max_seq_len_src=12,
    max_seq_len_tgt=16, mode="ASR_ST")
B, T = 3, 64


def _batch(seed):
    """One minibatch: BOS-first ids with PAD tails, fbank-shaped features
    with ragged lengths (one at the full T)."""
    rng = np.random.RandomState(seed)
    src = rng.randint(4, CFG.enc_vocab_size, (B, CFG.max_seq_len_src)).astype(np.int32)
    tgt = rng.randint(4, CFG.dec_vocab_size, (B, CFG.max_seq_len_tgt)).astype(np.int32)
    src[:, 0] = tgt[:, 0] = 2
    src[1, 7:] = tgt[2, 9:] = 0
    return {"srcid": src, "tgtid": tgt,
            "acous_feat": rng.randn(B, T, CFG.acous_dim).astype(np.float32),
            "acouslen": np.array([T, 37, 50], np.int32)}


def _jax_kw(mb, mode):
    kw = {"src": jnp.asarray(mb["srcid"])}
    if mode != "ASR":
        kw["tgt"] = jnp.asarray(mb["tgtid"])
    if mode != "MT":
        kw["acous_feats"] = jnp.asarray(mb["acous_feat"])
        kw["acous_lens"] = jnp.asarray(mb["acouslen"])
    return kw


def _torch_mb(mb, mode):
    keep = {"ASR": ("srcid", "acous_feat", "acouslen"), "MT": ("srcid", "tgtid"),
            "ASR_ST": ("srcid", "tgtid", "acous_feat", "acouslen")}[mode]
    return {k: torch.from_numpy(mb[k]) for k in keep}


def _flat(tree):
    return dict(named_leaves(tree))


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(0), CFG))


def _trainer(tmp_path, mode, **kw):
    t = Trainer(expt_dir=str(tmp_path), **kw)
    t.MODE = mode
    return t


@pytest.fixture(scope="module")
def jax_loss(tmp_path_factory):
    """mode -> jitted (params, minibatch, inv_n) -> ((loss, out), grads):
    the JAX step's loss_fn with is_training=False, value_and_grad'ed."""
    fns = {}

    def get(mode):
        if mode not in fns:
            tr = _trainer(tmp_path_factory.mktemp(mode), mode)

            def loss(p, mb, inv_n):
                out = jax_forward_train(p, CFG, mode, rng=jax.random.PRNGKey(0),
                                        is_training=False, ref_pick=True,
                                        **_jax_kw(mb, mode))
                return tr._head_losses(CFG, out, mb, inv_n)[0], out

            fns[mode] = jax.jit(jax.value_and_grad(loss, has_aux=True))
        return fns[mode]

    return get


def _jnp(mb):
    return {k: jnp.asarray(v) for k, v in mb.items()}


@pytest.mark.parametrize("mode", ["ASR_ST", "ASR", "MT"])
def test_forward_train_and_head_losses_match_jax(jax_params, jax_loss, tmp_path, mode):
    mb = _batch(0)
    (_, ref), _ = jax_loss(mode)(jax_params, _jnp(mb), 1.0)
    tm = _torch_mb(mb, mode)
    out = forward_train(params_from_numpy(jax_params), CFG, mode, src=tm["srcid"],
                        tgt=tm.get("tgtid"), acous_feats=tm.get("acous_feat"),
                        acous_lens=tm.get("acouslen"), is_training=False,
                        ref_pick=True)
    assert set(out) == set(ref)
    for k in ref:
        a, b = out[k].detach().numpy(), np.asarray(ref[k])
        if k.startswith(("preds", "lengths")):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL, err_msg=k)
    for mask, norm in ((True, True), (True, False), (False, True)):
        coeff = {"nll_asr": 0.7, "nll_mt": 1.3, "nll_st": 0.9}
        tr = _trainer(tmp_path, mode, eval_with_mask=mask, normalise_loss=norm,
                      loss_coeff=coeff)
        r_total, r_losses = tr._head_losses(CFG, ref, _jnp(mb), 0.5)
        total, ls = head_losses(CFG, mode, out, tm["srcid"], tm.get("tgtid"), 0.5,
                                coeff, eval_with_mask=mask, normalise_loss=norm)
        np.testing.assert_allclose(float(total), float(r_total), rtol=TOL)
        for k in r_losses:
            np.testing.assert_allclose(float(ls[k]), float(r_losses[k]), rtol=TOL)


@pytest.mark.parametrize("mode", ["ASR_ST", "ASR", "MT"])
def test_gradient_tree_matches_jax(jax_params, jax_loss, mode):
    """Summed over two minibatches with inv_n = 1/2, as the JAX step's scan."""
    mbs = [_batch(1), _batch(2)]
    (l1, _), g1 = jax_loss(mode)(jax_params, _jnp(mbs[0]), 0.5)
    (l2, _), g2 = jax_loss(mode)(jax_params, _jnp(mbs[1]), 0.5)
    r_loss, r_grads = l1 + l2, jax.tree_util.tree_map(jnp.add, g1, g2)
    tp = params_from_numpy(jax_params)
    losses_t, grads = compute_grads(CFG, mode, tp, [_torch_mb(m, mode) for m in mbs],
                                    torch.Generator().manual_seed(0),
                                    is_training=False)
    np.testing.assert_allclose(float(sum(losses_t.values())), float(r_loss), rtol=TOL)
    ref = _flat(jax.tree_util.tree_map(np.asarray, r_grads))
    mine = dict(zip(_flat(tp).keys(), grads))
    assert mine.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(mine[k].numpy(), ref[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_two_train_steps_match_jax(jax_params, jax_loss):
    """The deterministic step (compute_grads, then the optimizer, as
    make_train_step composes them) against value_and_grad + the JAX
    optimizer: clip (the first step's norm is above 1) and Adam, two steps
    with different LRs. Adam divides each coordinate by its own running
    RMS, so where a gradient is near zero a 1e-6 difference between the
    frameworks' gradients can move that parameter by up to the LR: the LRs
    here (2e-4, 1e-4; the reference schedule runs 5e-4 -> 1e-5) keep that
    within 1e-5. test_clip_and_adam_match_optax holds the optimizer alone
    on equal gradients at any LR."""
    mode, lrs = "ASR_ST", (2e-4, 1e-4)
    tx = jax_optim.make_optimizer(1.0)
    jp = jax.tree_util.tree_map(jnp.asarray, jax_params)
    state = tx.init(jp)
    tp = params_from_numpy(jax_params)
    opt = optim.make_optimizer(1.0)
    opt_state = opt.init(tp)
    for i, lr in enumerate(lrs):
        mb = _batch(10 + i)
        _, grads = jax_loss(mode)(jp, _jnp(mb), 1.0)
        if i == 0:
            assert float(jax_optim.global_norm(grads)) > 1.0  # the clip acts
        updates, state = tx.update(grads, jax_optim.set_lr(state, lr), jp)
        jp = jax.tree_util.tree_map(jnp.add, jp, updates)
        _, grads_t = compute_grads(CFG, mode, tp, [_torch_mb(mb, mode)],
                                   torch.Generator().manual_seed(i), is_training=False)
        opt.update(grads_t, optim.set_lr(opt_state, lr))
    ref = _flat(jax.tree_util.tree_map(np.asarray, jp))
    for k, v in _flat(tp).items():
        np.testing.assert_allclose(v.detach().numpy(), ref[k], atol=TOL, rtol=0,
                                   err_msg=k)


def test_clip_and_adam_match_optax():
    """The optimizer alone on a small tree: clip above and below the norm,
    two Adam steps, set_lr between them."""
    rng = np.random.RandomState(0)
    tree = {"a": rng.randn(4, 3).astype(np.float32), "b": [rng.randn(5).astype(np.float32)]}
    grads = [jax.tree_util.tree_map(lambda x: (s * rng.randn(*x.shape)).astype(np.float32), tree)
             for s in (3.0, 0.01)]
    tx = jax_optim.make_optimizer(1.0)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(jp)
    tp = params_from_numpy(tree)
    opt = optim.make_optimizer(1.0)
    opt_state = opt.init(tp)
    for g, lr in zip(grads, (0.1, 0.03)):
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   jax_optim.set_lr(state, lr), jp)
        jp = jax.tree_util.tree_map(jnp.add, jp, updates)
        opt.update([torch.from_numpy(x) for x in leaves(g)], optim.set_lr(opt_state, lr))
    for k, v in _flat(tp).items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(_flat(jp)[k]),
                                   atol=TOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("step", [0, 1, 7, 8, 9, 100, 16000, 16001, 50000])
@pytest.mark.parametrize("init,peak,warmup", [(5e-4, 1e-5, 16000), (1e-4, 1e-3, 8),
                                              (3e-4, 3e-4, 0)])
def test_reference_lr_equal(step, init, peak, warmup):
    assert optim.reference_lr(step, init, peak, warmup) == \
        jax_optim.reference_lr(step, init, peak, warmup)


def test_losses_match_jax():
    rng = np.random.RandomState(0)
    logps = np.log(rng.dirichlet(np.ones(7), 10)).astype(np.float32)
    tgt = rng.randint(0, 7, 10).astype(np.int32)
    mask = tgt != 0
    s, n = losses.nll_loss_masked(torch.from_numpy(logps), torch.from_numpy(tgt),
                                  torch.from_numpy(mask))
    rs, rn = jax_nll(jnp.asarray(logps), jnp.asarray(tgt), jnp.asarray(mask))
    np.testing.assert_allclose(float(s), float(rs), rtol=TOL)
    assert float(n) == float(rn)
    for norm in (0.0, 0.5, 4.0):
        assert float(losses.normalise(s, torch.tensor(norm))) == pytest.approx(
            float(jax_normalise(rs, jnp.float32(norm))), rel=TOL)


def test_spec_augment_bounds():
    """At most two time bands of <= min(40, 0.2 T) frames and two channel
    bands of <= 7 are zeroed, for the whole batch; the same seed gives the
    same bands."""
    Tn, C = 300, 40
    x = torch.ones(2, Tn, C)
    seen_t = seen_f = 0
    for seed in range(30):
        y = spec_augment(torch.Generator().manual_seed(seed), x)
        assert torch.equal(y[0], y[1])
        zero_t = (y[0] == 0).all(dim=1)  # whole frames zeroed
        zero_f = (y[0] == 0).all(dim=0)  # whole channels zeroed
        assert torch.equal((y[0] == 0), zero_t[:, None] | zero_f[None, :])
        for z, bound in ((zero_t, int(min(40, 0.2 * Tn))), (zero_f, 7)):
            edges = torch.diff(z.int(), prepend=torch.zeros(1, dtype=torch.int32))
            assert int((edges == 1).sum()) <= 2  # at most two bands
            assert int(z.sum()) <= 2 * bound
        seen_t, seen_f = max(seen_t, int(zero_t.sum())), max(seen_f, int(zero_f.sum()))
        assert torch.equal(y, spec_augment(torch.Generator().manual_seed(seed), x))
    assert seen_t > 0 and seen_f > 0


def test_dropout_scaling_and_determinism():
    x = torch.ones(200, 50)
    y = dropout(torch.Generator().manual_seed(1), x, 0.2, True)
    assert set(torch.unique(y).tolist()) == {0.0, float(np.float32(1.0) / np.float32(0.8))}
    assert abs(float((y > 0).float().mean()) - 0.8) < 0.02
    assert torch.equal(y, dropout(torch.Generator().manual_seed(1), x, 0.2, True))
    assert not torch.equal(y, dropout(torch.Generator().manual_seed(2), x, 0.2, True))
    assert dropout(None, x, 0.2, False) is x and dropout(None, x, 0.0, True) is x
    a, b = split(torch.Generator().manual_seed(0))
    assert a.initial_seed() != b.initial_seed()


def test_train_step_draws_from_its_generator():
    """make_train_step with dropout and SpecAugment on: one generator seed
    gives one step (losses and parameters), another seed another; the loss
    is finite and every trained parameter moves."""
    cfg = ModelConfig(**{**CFG.__dict__, "dropout": 0.2, "spec_aug": True,
                         "embedding_dropout": 0.1})
    init = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(0), cfg))
    mbs = [_torch_mb(_batch(3), "ASR_ST"), _torch_mb(_batch(4), "ASR_ST")]

    def run(seed):
        p = params_from_numpy(init)
        opt = optim.make_optimizer(1.0)
        step = make_train_step(cfg, "ASR_ST", opt, device="cpu")
        _, _, ls = step(p, opt.init(p), mbs, torch.Generator().manual_seed(seed), 1e-3)
        return ls, _flat(p)

    (l0, p0), (l0b, p0b), (l1, p1) = run(0), run(0), run(1)
    assert all(np.isfinite(float(v)) for v in l0.values())
    assert l0 == l0b and all(torch.equal(p0[k], p0b[k]) for k in p0)
    assert l0 != l1
    moved = [k for k, v in p0.items() if not np.array_equal(v.detach().numpy(), _flat(init)[k])]
    assert set(p0) - set(moved) == {"/emb_dyn_ave"}  # no gradient by design


@pytest.mark.parametrize("mode", ["AE_MT", "AE_ASR", "ASR_AE"])
def test_unported_modes_raise(mode):
    """The AE modes do not train, for the JAX package's reason: its step has
    no AE loss and train.py no Trainer_AE* class."""
    with pytest.raises(ValueError, match="no AE loss"):
        make_train_step(CFG, mode, optim.make_optimizer())
