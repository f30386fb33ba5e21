"""Training on a (data, model) mesh in one process (stjep_tpu_torch/parallel,
train/trainer.py), on meshes of CPU devices, against the port's unsharded
step and JAX's single-device step.

JAX's own slow tests pin its mesh step to its single-device step
(tests/test_sharding.py); here the port's mesh step is held to the port's
unsharded step with dropout and SpecAugment on (one generator: the masks
are drawn for the whole batch and cut per shard), and with dropout off to
JAX's single-device `Trainer_ASR_ST._train_batch`, so the chain closes
without compiling a JAX mesh program. Tolerances: rtol 1e-5 / atol 1e-6,
those of JAX's test_trainer_step_on_mesh_matches_single_device; the
kernel wrappers per data shard against the whole-batch call: outputs at
1e-6, gradients summed over the shards at 1e-5 relative (atol 1e-6 of
each gradient's scale).
"""

import logging
import os

import numpy as np
import pytest
import torch

import jax

from stjep_tpu.config import ModelConfig as JConfig
from stjep_tpu.models.seq2seq import init_seq2seq as jinit
from stjep_tpu.ops import transformer as jtransformer
from stjep_tpu.train import trainer as jtrainer
from stjep_tpu.train.checkpoint import Checkpoint as JCheckpoint
from stjep_tpu.train.optim import make_optimizer as jmake_optimizer
from stjep_tpu.train.policies import trainable_mask as jtrainable_mask

from stjep_tpu_torch.bridge import named_leaves, params_from_numpy
from stjep_tpu_torch.config import BOS, ModelConfig
from stjep_tpu_torch.data import device_cache
from stjep_tpu_torch.data.dataset import Dataset
from stjep_tpu_torch.models.seq2seq import _decoder_de, init_seq2seq
from stjep_tpu_torch.ops import transformer as ttransformer
from stjep_tpu_torch.ops.lstm import bilstm_init
from stjep_tpu_torch.ops.lstm_pallas import bilstm_pallas
from stjep_tpu_torch.ops.lstm_pallas_bwd import bilstm_pallas_trainable
from stjep_tpu_torch.ops.transformer import ffn, ffn_init, mha, mha_init
from stjep_tpu_torch.parallel.mesh import (
    Shards,
    gather_params,
    logical_leaves,
    make_mesh,
    place_params,
)
from stjep_tpu_torch.parallel.spmd import (
    bilstm_dp,
    kernel_mesh,
    las_greedy_flash_dp,
    las_tf_scan_dp,
    set_kernel_mesh,
)
from stjep_tpu_torch.train import trainer as ttrainer

from tests.data_factory import make_corpus

RTOL, ATOL = 1e-5, 1e-6
B, T = 8, 16
CFG = dict(enc_vocab_size=32, dec_vocab_size=24, enc_embedding_size=8,
           dec_embedding_size=16, acous_dim=8, acous_hidden_size=8, dim_model=16,
           dim_feedforward=32, num_heads=4, enc_layers=1, dec_layers=1,
           num_unilstm_dec=3, spec_aug=True, dropout=0.2, max_seq_len_src=8,
           max_seq_len_tgt=10, mode="ASR_ST")


@pytest.fixture(autouse=True)
def _no_mesh_left():
    yield
    set_kernel_mesh(None)


def mesh_of(n_data, n_model):
    return make_mesh(n_data, n_model, ["cpu"] * (n_data * n_model))


def item_for(step, cfg):
    r = np.random.RandomState(100 + step)
    it = {"srcid": r.randint(5, cfg.enc_vocab_size, (B, cfg.max_seq_len_src)).astype(np.int32),
          "tgtid": r.randint(5, cfg.dec_vocab_size, (B, cfg.max_seq_len_tgt)).astype(np.int32),
          "acous_feat": r.randn(B, T, cfg.acous_dim).astype(np.float32),
          "acouslen": r.randint(T // 2, T - 1, (B,)).astype(np.int32)}
    it["srcid"][:, 0] = BOS
    it["tgtid"][:, 0] = BOS
    return it


def trainer(tmp_path, tag, mesh=None, **over):
    kw = dict(batch_size=B, minibatch_partition=1, lr_warmup_steps=0, learning_rate=1e-3,
              learning_rate_init=1e-3, seed=0, device="cpu")
    if mesh is not None:
        kw.update(n_model=mesh[1], devices=["cpu"] * (mesh[0] * mesh[1]))
    kw.update(over)
    return ttrainer.Trainer_ASR_ST(expt_dir=str(tmp_path / tag), **kw)


def steps(t, cfg, params, opt_state, idxs):
    for i in idxs:
        params, opt_state, losses = t._train_batch(cfg, params, opt_state, item_for(i, cfg), i + 1)
    return params, opt_state, losses


def assert_trees_close(got, want, rtol=RTOL, atol=ATOL, exact=False):
    a, b = dict(named_leaves(got)), dict(named_leaves(want))
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k].detach(), b[k].detach()
        if exact:
            assert x.dtype == y.dtype and torch.equal(x, y), k
        else:
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=rtol, atol=atol, err_msg=k)


# ---------------------------------------------------------------- C 1


def test_cache_upload_failure_falls_back_to_staging(tmp_path, monkeypatch, caplog):
    """DeviceFeatureCache.build raising (memory the estimate missed): JAX's
    warning, None recorded for the dataset, and the epoch's steps run on
    per-step staging, equal to a run that never asked for the cache."""
    corpus = make_corpus(str(tmp_path / "corpus"), n_sent=8)
    cfg = ModelConfig(**{**CFG, "enc_vocab_size": corpus["vocab_src_size"],
                         "dec_vocab_size": corpus["vocab_tgt_size"],
                         "acous_dim": corpus["acous_dim"], "dropout": 0.0,
                         "spec_aug": False, "max_seq_len_src": 16, "max_seq_len_tgt": 32})

    def ds():
        return Dataset(path_src=corpus["path_src"], path_tgt=corpus["path_tgt"],
                       path_vocab_src=corpus["path_vocab_src"],
                       path_vocab_tgt=corpus["path_vocab_tgt"], acous_path=corpus["acous_path"],
                       acous_norm_path=corpus["acous_norm_path"], acous_norm=True,
                       max_seq_len_src=16, max_seq_len_tgt=32, batch_size=4, use_type="char",
                       mode="ST", seed=5)

    def boom(*a, **kw):
        raise RuntimeError("CUDA out of memory (simulated)")

    finals = {}
    for cache in (False, True):
        if cache:
            monkeypatch.setattr(device_cache.DeviceFeatureCache, "build", classmethod(boom))
        t = trainer(tmp_path, f"c{cache}", batch_size=4, device_cache=cache,
                    checkpoint_every=10 ** 9, print_every=10 ** 9)
        train_set = ds()
        with caplog.at_level(logging.WARNING):
            _, finals[cache] = t.train({"st": train_set},
                                       (cfg, init_seq2seq(cfg, torch.Generator().manual_seed(0))),
                                       num_epochs=1)
        assert t.steps_run == 2
        if cache:
            assert t._feat_caches[id(train_set)] is None and t._feat_cache is None
    assert "device cache: upload FAILED" in caplog.text
    assert "falling back to per-step feature staging" in caplog.text
    assert_trees_close(finals[True], finals[False], exact=True)


def test_device_cache_on_mesh_feeds_each_data_shard(tmp_path):
    """The int8 device cache on the (4, 2) mesh: one copy, on the mesh's
    first device, where each minibatch gathers and dequantizes its rows
    before the data-shard wrappers cut it; the epoch equal, bit for bit, to
    per-step int8 staging on the same mesh."""
    corpus = make_corpus(str(tmp_path / "corpus"), n_sent=8)
    cfg = ModelConfig(**{**CFG, "enc_vocab_size": corpus["vocab_src_size"],
                         "dec_vocab_size": corpus["vocab_tgt_size"],
                         "acous_dim": corpus["acous_dim"], "max_seq_len_src": 16,
                         "max_seq_len_tgt": 32})
    finals = {}
    for cache in (False, True):
        t = trainer(tmp_path, f"m{cache}", (4, 2), batch_size=4, device_cache=cache,
                    feat_dtype="int8", checkpoint_every=10 ** 9, print_every=10 ** 9)
        ds = Dataset(path_src=corpus["path_src"], path_tgt=corpus["path_tgt"],
                     path_vocab_src=corpus["path_vocab_src"],
                     path_vocab_tgt=corpus["path_vocab_tgt"], acous_path=corpus["acous_path"],
                     acous_norm_path=corpus["acous_norm_path"], acous_norm=True,
                     max_seq_len_src=16, max_seq_len_tgt=32, batch_size=4, use_type="char",
                     mode="ST", seed=5)
        _, finals[cache] = t.train({"st": ds}, (cfg, init_seq2seq(
            cfg, torch.Generator().manual_seed(0))), num_epochs=1)
        assert t.steps_run == 2
        if cache:
            assert t._feat_cache is not None and t._feat_cache.feats.device == t._mesh.lead
    assert_trees_close(finals[True], finals[False], exact=True)


# ------------------------------------------------- the LAS kernels' wrappers


def _grads(out, leaves_):
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(7))
    gs = torch.autograd.grad((out * g).sum(), leaves_, allow_unused=True)
    return [torch.zeros(()) if x is None else x for x in gs]


def assert_grads_close(got, want):
    """Gradients summed over the data shards against the whole batch's:
    rtol 1e-5, atol 1e-6 of each gradient's largest magnitude (f32 sums
    of 8 shards in another order)."""
    for a, b in zip(got, want, strict=True):
        scale = max(1.0, float(b.abs().max()))
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("shape,batch", [((4, 2), 8), ((8, 1), 8), ((4, 2), 6)])
def test_bilstm_dp_matches_whole_batch(shape, batch):
    """K1 (eval) and K8 (autograd) per data shard: outputs and the weight
    and input gradients equal the whole-batch call's; a batch of 6 on 4
    data rows falls through to the plain call."""
    g = torch.Generator().manual_seed(0)
    p = bilstm_init(g, 6, 5)
    x = torch.randn(batch, 8, 6, generator=g)
    lens = torch.tensor([8, 6, 8, 2, 4, 8, 7, 8][:batch])
    whole = {"k1": bilstm_pallas(p["fwd"], p["bwd"], x, lens)}
    leaves_ = [x.requires_grad_(True)] + [t.requires_grad_(True) for _, t in named_leaves(p)]
    out = bilstm_pallas_trainable(p["fwd"], p["bwd"], x, lens)
    whole_g = _grads(out, leaves_)
    set_kernel_mesh(mesh_of(*shape))
    with torch.no_grad():
        k1 = bilstm_dp(bilstm_pallas, p["fwd"], p["bwd"], x, lens)
    np.testing.assert_allclose(k1.numpy(), whole["k1"].numpy(), rtol=0, atol=1e-6)
    out_dp = bilstm_dp(bilstm_pallas_trainable, p["fwd"], p["bwd"], x, lens)
    np.testing.assert_allclose(out_dp.detach().numpy(), out.detach().numpy(), rtol=0, atol=1e-6)
    assert_grads_close(_grads(out_dp, leaves_), whole_g)


@pytest.fixture(scope="module")
def las_params():
    cfg = ModelConfig(**CFG)
    return cfg, init_seq2seq(cfg, torch.Generator().manual_seed(4))


@pytest.mark.parametrize("shape,batch", [((4, 2), 8), ((8, 1), 8), ((4, 2), 6)])
def test_las_tf_scan_dp_matches_whole_batch(las_params, shape, batch):
    """K9 per data shard, with dropout masks drawn for the whole batch and
    cut: the scan's output and every input's and weight's gradient (6 rows
    on 4 data rows fall through)."""
    from stjep_tpu_torch.models.las_decoder import _make_drop_masks
    from stjep_tpu_torch.ops.las_tf_flash import las_tf_scan

    cfg, params = las_params
    dec = params["las"]["decoder"]
    g = torch.Generator().manual_seed(1)
    S, Tk, Ha2 = 5, 4, 2 * cfg.acous_hidden_size
    stack = {k: {n: t.detach().clone() for n, t in dec[k].items()}
             for k in ("dec_l0", "dec_l1", "dec_l2")}
    att_w = dec["acous_att"]["linear_att_w"]["w"].detach().clone()
    ffn_w = dec["acous_ffn"]["w"].detach().clone()
    pre0 = torch.randn(S, batch, 4 * cfg.dim_model, generator=g)
    acous = torch.randn(batch, Tk, Ha2, generator=g)
    lens_k = torch.tensor([4, 3, 4, 1, 2, 4, 4, 3][:batch])
    masks = _make_drop_masks(torch.Generator().manual_seed(2), cfg, S, batch, Ha2, "cpu")
    leaves_ = [t.requires_grad_(True) for t in
               [pre0, acous, att_w, ffn_w] + [t for _, t in named_leaves(stack)]]
    out = las_tf_scan(stack, att_w, ffn_w, pre0, acous, lens_k, masks)
    want = _grads(out, leaves_)
    set_kernel_mesh(mesh_of(*shape))
    got_out = las_tf_scan_dp(stack, att_w, ffn_w, pre0, acous, lens_k, masks)
    np.testing.assert_allclose(got_out.detach().numpy(), out.detach().numpy(), rtol=0, atol=1e-6)
    assert_grads_close(_grads(got_out, leaves_), want)


@pytest.mark.parametrize("shape,batch", [((4, 2), 8), ((8, 1), 8), ((4, 2), 6)])
def test_las_greedy_flash_dp_matches_whole_batch(las_params, shape, batch):
    """K2 per data shard, with and without reference ids: embeddings, symbols
    and picked log-probs equal the whole-batch call's (6 rows fall through)."""
    from stjep_tpu_torch.ops.attention import precompute_keys
    from stjep_tpu_torch.ops.las_flash import las_greedy_flash

    cfg, params = las_params
    dec = params["las"]["decoder"]
    g = torch.Generator().manual_seed(3)
    acous = torch.randn(batch, 4, 2 * cfg.acous_hidden_size, generator=g)
    wk = precompute_keys(dec["acous_att"], acous, cfg.acous_att_mode)["wk"]
    lens_k = torch.tensor([4, 3, 4, 1, 2, 4, 4, 3][:batch])
    sym0 = torch.full((batch,), BOS, dtype=torch.int64)
    refs = torch.randint(5, cfg.enc_vocab_size, (batch, 6), generator=g, dtype=torch.int32)
    for r in (None, refs):
        want = las_greedy_flash(dec, cfg, wk, acous, lens_k, sym0, 6, ref_tokens=r)
        set_kernel_mesh(mesh_of(*shape))
        got = las_greedy_flash_dp(dec, cfg, wk, acous, lens_k, sym0, 6, ref_tokens=r)
        set_kernel_mesh(None)
        for a, b in zip(got, want, strict=True):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


# ------------------------------------------- the Megatron transformer forward


@pytest.mark.parametrize("shape,heads", [((1, 2), 4), ((4, 2), 4), ((1, 4), 4), ((1, 4), 2)])
def test_tp_mha_ffn_head_match_unsharded(shape, heads):
    """mha, ffn and the vocabulary-split picked head on place_params' slices
    (dropout on, the same generator; 2 heads on 4 shards: the attention
    projections left replicated) against the unsharded forward: outputs
    at rtol 1e-5 / atol 1e-6, the argmax ids equal, and the gradients of
    the slices joined in shard order at 1e-5 (atol 1e-6 of each gradient's
    scale)."""
    mesh = mesh_of(*shape)
    cfg = ModelConfig(**CFG)
    g = torch.Generator().manual_seed(5)
    tree = {"dec_tgt": {"layers": [{"decslf_attn": mha_init(g, heads, 16, 16 // heads,
                                                            16 // heads),
                                    "pos_ffn": ffn_init(g, 16, 32)}],
                        "norm": {}},
            "out_tgt": {"w": torch.randn(16, 24, generator=g)}}
    placed = place_params(tree, mesh, heads)
    lay, lay_p = tree["dec_tgt"]["layers"][0], placed["dec_tgt"]["layers"][0]
    n = shape[1]
    assert isinstance(lay_p["pos_ffn"]["w_1"]["w"], Shards)
    if heads % n:
        assert not any(isinstance(lay_p["decslf_attn"][nm]["w"], Shards)
                       for nm in ("w_qs", "w_ks", "w_vs", "fc"))
    else:
        assert isinstance(lay_p["decslf_attn"]["w_qs"]["w"], Shards)
        assert [tuple(s.shape) for s in lay_p["decslf_attn"]["fc"]["w"]] == [(16 // n, 16)] * n
    x = torch.randn(3, 5, 16, generator=g)
    mask = torch.tensor([[1] * 5, [1] * 3 + [0] * 2, [1] * 4 + [0]])[:, None, :]
    ids = torch.randint(0, 24, (3, 4), generator=g)

    def run(t):
        a = mha(t["decslf_attn"], x, x, x, heads, mask,
                generator=torch.Generator().manual_seed(9), dropout_rate=0.2, training=True)
        return ffn(t["pos_ffn"], a, generator=torch.Generator().manual_seed(8),
                   dropout_rate=0.2, training=True)

    outs, grads = [], []
    for t, p in ((lay, tree), (lay_p, placed)):
        ws = [w.requires_grad_(True) for _, w in named_leaves(p)]
        y = run(t)
        _, _, picked, preds = _decoder_head(p, cfg, y, ids)
        outs.append((y, picked, preds))
        gs = torch.autograd.grad((y * y).sum() + picked.sum(), ws)
        grads.append(gs)
    (y0, p0, d0), (y1, p1, d1) = outs
    np.testing.assert_allclose(y1.detach().numpy(), y0.detach().numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(p1.detach().numpy(), p0.detach().numpy(), rtol=RTOL, atol=ATOL)
    assert torch.equal(d1, d0)
    # the slices' gradients, joined in shard order, are the unsharded ones
    it = iter(grads[1])
    joined = {}
    for (name, leaf), grad in zip(named_leaves(tree), grads[0], strict=True):
        holder = placed
        for part in name.strip("/").split("/"):
            holder = holder[int(part)] if isinstance(holder, list) else holder[part]
        if isinstance(holder, Shards):
            dim = 1 if name.endswith(("w_qs/w", "w_ks/w", "w_vs/w", "w_1/w", "out_tgt/w")) else 0
            joined[name] = torch.cat([next(it) for _ in holder], dim)
        else:
            joined[name] = next(it)
        scale = max(1.0, float(grad.abs().max()))
        np.testing.assert_allclose(joined[name].numpy(), grad.numpy(), rtol=RTOL,
                                   atol=ATOL * scale, err_msg=name)


def _decoder_head(p, cfg, y, ids):
    """_decoder_de's head alone: the decoder forward replaced by y."""
    from stjep_tpu_torch.models import seq2seq

    real = seq2seq.tf_decoder_forward
    seq2seq.tf_decoder_forward = lambda *a, **kw: y
    try:
        return _decoder_de(p, cfg, None, None, ref_pick_ids=ids)
    finally:
        seq2seq.tf_decoder_forward = real


# ------------------------------------------------------------ the mesh step


@pytest.mark.parametrize("shape", [(4, 2), (8, 1)])
def test_mesh_step_matches_unsharded_step(tmp_path, shape):
    """One Trainer_ASR_ST._train_batch on the mesh against the port's
    unsharded step, dropout 0.2 and SpecAugment on, the same generator:
    losses and the gathered params at rtol 1e-5 / atol 1e-6. Each ruled
    leaf and its Adam moments are held only as 1/n slices, on their
    shards' devices."""
    cfg = ModelConfig(**CFG)
    out = {}
    for tag, mesh in (("single", None), ("mesh", shape)):
        t = trainer(tmp_path, tag, mesh)
        p, opt, _, _ = t.setup(init_seq2seq(cfg, torch.Generator().manual_seed(0)), cfg)
        p, opt, losses = steps(t, cfg, p, opt, [0])
        out[tag] = (t, p, opt, {k: float(v) for k, v in losses.items()})
        set_kernel_mesh(None)
    t, p, opt, losses = out["mesh"]
    assert t._mesh.shape == {"data": shape[0], "model": shape[1]}
    for k, v in out["single"][3].items():
        np.testing.assert_allclose(losses[k], v, rtol=RTOL, atol=ATOL)
    assert_trees_close(gather_params(p), out["single"][1])
    # Adam's state tree: optax's unsharded layout, the same as the unsharded run's
    assert_trees_close(t._tx.state_tree(p, opt), out["single"][0]._tx.state_tree(
        out["single"][1], out["single"][2]), atol=1e-9)
    n = shape[1]
    split = [(name, x) for name, x in logical_leaves(p) if isinstance(x, Shards)]
    # enc: Q, K, V, fc, w_1, b_1, w_2; dec: twice the attention, the FFN; out_tgt
    assert len(split) == ((7 * cfg.enc_layers + 11 * cfg.dec_layers + 1) if n > 1 else 0)
    whole = dict(named_leaves(out["single"][1]))
    for name, x in split:
        dim = 1 if name.endswith(("w_qs/w", "w_ks/w", "w_vs/w", "w_1/w", "out_tgt/w")) else 0
        assert len(x) == n, name
        for s, part in enumerate(x):
            want = list(whole[name].shape)
            want[dim] //= n
            assert list(part.shape) == want and part.device == t._mesh.devices[0][s], name
            st = opt.state[part]
            assert st["exp_avg"].shape == part.shape == st["exp_avg_sq"].shape, name


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    """JAX's single-device Trainer_ASR_ST._train_batch from JAX's init, with
    dropout, SpecAugment and the attention-probability dropout off (no JAX
    mesh: its _setup_mesh is never called): (init, losses, params)."""
    kw = {**CFG, "dropout": 0.0, "spec_aug": False}
    jcfg = JConfig(**kw)
    init = jax.device_get(jinit(jax.random.PRNGKey(0), jcfg))
    jt = jtrainer.Trainer_ASR_ST(expt_dir=str(tmp_path_factory.mktemp("jax")), batch_size=B,
                                 minibatch_partition=1, lr_warmup_steps=0, learning_rate=1e-3,
                                 learning_rate_init=1e-3, seed=0)
    jp = jax.tree_util.tree_map(jax.numpy.asarray, init)
    jt._tx = jmake_optimizer(1.0, jtrainable_mask(jp, lambda n: False))
    real = jtransformer.ATTN_DROPOUT
    jtransformer.ATTN_DROPOUT = 0.0
    try:
        jp, _, jlosses = jt._train_batch(jcfg, jp, jt._init_opt(jp), item_for(0, jcfg), 1)
    finally:
        jtransformer.ATTN_DROPOUT = real
    assert jt._mesh is None
    return init, {k: float(v) for k, v in jlosses.items()}, jax.device_get(jp)


@pytest.mark.parametrize("shape", [(4, 2), (8, 1)])
def test_mesh_step_matches_jax_single_device(tmp_path, monkeypatch, jax_step, shape):
    """Dropout off, SpecAugment off, attention-probability dropout 0 on both
    sides: the port's step on the mesh against JAX's single-device
    Trainer_ASR_ST._train_batch from the same init, at rtol 1e-5 / atol
    1e-6."""
    monkeypatch.setattr(ttransformer, "ATTN_DROPOUT", 0.0)
    init, jlosses, jp = jax_step
    cfg = ModelConfig(**{**CFG, "dropout": 0.0, "spec_aug": False})
    t = trainer(tmp_path, "port", shape)
    p, opt, _, _ = t.setup(params_from_numpy(init), cfg)
    p, opt, losses = steps(t, cfg, p, opt, [0])
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k]), jlosses[k], rtol=RTOL, atol=ATOL)
    got = dict(named_leaves(gather_params(p)))
    for name, leaf in named_leaves(jp):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(leaf), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_mesh_checkpoint_lifecycle(tmp_path):
    """As JAX's test_tp_mesh_checkpoint_lifecycle, on the (4, 2) mesh: the
    mesh's save is byte-equal to an unsharded save of the gathered params
    and state tree; JAX's Checkpoint.load reads it and equals it; a fresh
    mesh trainer resumed from it (load_mode resume, the generator aligned)
    steps bit-equal to a mesh run that never stopped."""
    cfg = ModelConfig(**CFG)
    init = lambda: init_seq2seq(cfg, torch.Generator().manual_seed(0))  # noqa: E731
    ta = trainer(tmp_path, "a", (4, 2))
    pa, oa, _, _ = ta.setup(init(), cfg)
    pa, oa, _ = steps(ta, cfg, pa, oa, [0, 1])
    gen = ta._root_gen.get_state()
    saved = ta._save(cfg, pa, oa, 1, 2, _Vocabs()).path
    # an unsharded trainer holding the gathered params and the same state
    tu = trainer(tmp_path, "u")
    pu, ou, _, _ = tu.setup(gather_params(pa), cfg)
    tu._tx.load_state_tree(pu, ou, ta._tx.state_tree(pa, oa))
    saved_u = tu._save(cfg, pu, ou, 1, 2, _Vocabs()).path
    for f in ("params.msgpack", "opt_state.msgpack"):
        with open(os.path.join(saved, f), "rb") as x, open(os.path.join(saved_u, f), "rb") as y:
            assert x.read() == y.read(), f
    # JAX reads the mesh's checkpoint
    jp = jinit(jax.random.PRNGKey(9), JConfig(**CFG))
    jtx = jmake_optimizer(1.0, jtrainable_mask(jp, lambda n: False))
    jck = JCheckpoint.load(saved, params_template=jp, opt_state_template=jtx.init(jp))
    assert_trees_close(params_from_numpy(jax.device_get(jck.params)), gather_params(pa),
                       exact=True)
    assert int(jck.opt_state.inner_states["train"].inner_state[1].count) == 2
    set_kernel_mesh(None)
    # resume on the mesh against a run that never stopped
    tr = trainer(tmp_path, "r", (4, 2), load_dir=saved, load_mode="resume")
    pr, orr, epoch, step = tr.setup(init_seq2seq(cfg, torch.Generator().manual_seed(3)), cfg)
    assert (epoch, step) == (1, 2)
    assert_trees_close(gather_params(pr), gather_params(pa), exact=True)
    tr._root_gen.set_state(gen)
    pr, orr, _ = steps(tr, cfg, pr, orr, [2])
    set_kernel_mesh(None)
    tb = trainer(tmp_path, "b", (4, 2))
    pb, ob, _, _ = tb.setup(init(), cfg)
    pb, ob, _ = steps(tb, cfg, pb, ob, [0, 1, 2])
    assert_trees_close(gather_params(pr), gather_params(pb), exact=True)
    assert_trees_close(tr._tx.state_tree(pr, orr), tb._tx.state_tree(pb, ob), exact=True)


class _Vocabs:
    vocab_src, vocab_tgt = ["a"], ["b"]


def _copy(tree):
    """A copy of a tree of tensors that no later step writes into (on the
    CPU a gathered leaf or a state tree's moment is the live tensor)."""
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy(v) for v in tree)
    return tree.clone()


def test_mesh_rollback_restores_saved_state(tmp_path):
    """A rollback on the (4, 2) mesh (the dev score stalled): the latest
    checkpoint's params and Adam state come back bit for bit, assigned in
    place into the training layout (the slices Adam holds)."""
    cfg = ModelConfig(**CFG)
    t = trainer(tmp_path, "rb", (4, 2))
    p, o, _, _ = t.setup(init_seq2seq(cfg, torch.Generator().manual_seed(0)), cfg)
    p, o, _ = steps(t, cfg, p, o, [0])
    t._save(cfg, p, o, 1, 1, _Vocabs())
    want_p, want_o = _copy(gather_params(p)), _copy(t._tx.state_tree(p, o))
    slices = [x for _, x in named_leaves(p)]
    p, o, _ = steps(t, cfg, p, o, [1])
    assert not torch.equal(gather_params(p)["out_tgt"]["w"], want_p["out_tgt"]["w"])
    t._rollback(p, o, logging.getLogger("rollback"), 1, 2)
    assert [x for _, x in named_leaves(p)] == slices  # the same tensors, in place
    assert isinstance(p["out_tgt"]["w"], Shards)
    assert_trees_close(gather_params(p), want_p, exact=True)
    assert_trees_close(t._tx.state_tree(p, o), want_o, exact=True)


def test_trainer_keeps_no_mesh_on_one_device(tmp_path, caplog):
    """One device and n_model 1: no mesh (JAX's single chip); n_model 2 on
    one device: make_mesh's degrade warning and a (1, 1) mesh, installed
    by setup and cleared again after train."""
    cfg = ModelConfig(**CFG)
    t = trainer(tmp_path, "one")
    t.setup(init_seq2seq(cfg, torch.Generator().manual_seed(0)), cfg)
    assert t._mesh is None and kernel_mesh() is None
    t2 = trainer(tmp_path, "two", n_model=2)
    with caplog.at_level(logging.WARNING):
        t2.setup(init_seq2seq(cfg, torch.Generator().manual_seed(0)), cfg)
    assert t2._mesh.shape == {"data": 1, "model": 1} and kernel_mesh() is t2._mesh
    assert "falling back to pure data parallelism" in caplog.text
    t3 = trainer(tmp_path, "three", (4, 2))
    t3.train({"st": _NoBatches()}, (cfg, init_seq2seq(cfg, torch.Generator().manual_seed(0))),
             num_epochs=0)
    assert kernel_mesh() is t2._mesh


class _NoBatches:
    pass
