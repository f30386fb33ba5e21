"""Load policies, the freezing optimizer and checkpoints of the port
against the JAX package's.

- `train/policies.py`: `apply_load_mode`'s params and `trainable_mask`
  equal JAX's for every load mode, with and without freezing, including
  the embedder fallback.
- `train/optim.py` with a mask: two updates from the same gradients (large
  enough that the global-norm clip acts) equal optax's multi_transform
  updates, and the state maps to optax's tree leaf by leaf (each leaf within
  1e-5 of its norm: float32 Adam steps rounded in another order, read on
  leaves as small as the LayerNorm biases after 3 steps); frozen leaves
  stay unchanged, and the clip's norm is taken over the trainable leaves
  only.
- `train/checkpoint.py` / `flax_msgpack.py`: the files are flax's bytes;
  JAX's Checkpoint.load reads a port checkpoint (f32 and bf16, params and
  optimizer state) and the port reads a JAX one; combine_weights, rm_old,
  the latest lookups and upgrade_params match JAX's.
"""

import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

from stjep_tpu.config import ModelConfig as JConfig
from stjep_tpu.models.seq2seq import init_seq2seq as jinit
from stjep_tpu.train import checkpoint as jckpt
from stjep_tpu.train import optim as joptim
from stjep_tpu.train import policies as jpol

from stjep_tpu_torch.bridge import leaves, named_leaves, params_from_numpy
from stjep_tpu_torch.train import checkpoint as tckpt
from stjep_tpu_torch.train import flax_msgpack
from stjep_tpu_torch.train import optim as toptim
from stjep_tpu_torch.train import policies as tpol

CFG = dict(enc_vocab_size=20, dec_vocab_size=16, enc_embedding_size=8,
           dec_embedding_size=16, acous_dim=8, acous_hidden_size=8, dim_model=16,
           dim_feedforward=32, num_heads=4, enc_layers=1, dec_layers=2,
           num_unilstm_dec=2, mode="ASR_ST")
MODES = ["null", "LAS", "ASR", "ASR-PARTIAL", "ALL-PARTIAL", "ALL"]


def _np(tree):
    return jax.device_get(tree)


def _params(seed, dtype=jnp.float32, **over):
    return _np(jinit(jax.random.PRNGKey(seed), JConfig(**{**CFG, **over}), dtype=dtype))


def _as_np(x):
    if torch.is_tensor(x):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x, np.float32) if np.asarray(x).dtype.name == "bfloat16" else np.asarray(x)


def assert_trees_close(port_tree, jax_tree, leaf_tol=0.0):
    """Equal leaf by leaf, or each within leaf_tol of its norm."""
    a, b = dict(named_leaves(port_tree)), dict(named_leaves(jax_tree))
    assert a.keys() == b.keys()
    for k in a:
        x, y = _as_np(a[k]).astype(np.float64), _as_np(b[k]).astype(np.float64)
        assert x.shape == y.shape, k
        err = np.linalg.norm(x - y)
        assert err <= leaf_tol * np.linalg.norm(y), (k, err, np.linalg.norm(y))


# ------------------------------------------------------------ policies


@pytest.mark.parametrize("freeze", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_apply_load_mode_matches_jax(mode, freeze):
    base = _params(0)
    loaded = _params(1)
    jp, jmask = jpol.apply_load_mode(base, loaded, mode, freeze)
    tp, tmask = tpol.apply_load_mode(params_from_numpy(base), params_from_numpy(loaded),
                                     mode, freeze)
    assert_trees_close(tp, _np(jp))
    assert tmask == jmask


@pytest.mark.parametrize("mode", ["ASR", "ASR-PARTIAL"])
def test_embedder_fallback_matches_jax(mode):
    """A checkpoint without las.decoder.embedder: the LAS embedder takes the
    checkpoint's enc_embedder (ref: trainer_base.py:299-313)."""
    base = _params(0)
    loaded = _params(1)
    del loaded["las"]["decoder"]["embedder"]
    jp, jmask = jpol.apply_load_mode(base, loaded, mode, True)
    tp, tmask = tpol.apply_load_mode(params_from_numpy(base), params_from_numpy(loaded),
                                     mode, True)
    assert_trees_close(tp, _np(jp))
    np.testing.assert_array_equal(tp["las"]["decoder"]["embedder"].numpy(),
                                  loaded["enc_embedder"])
    assert tmask == jmask


# ----------------------------------------------------------- optimizer


def _grads(params, seed, scale=50.0):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: (rng.randn(*np.shape(p)) * scale).astype(np.float32), params)


@pytest.mark.parametrize("frozen", ["las.", "none"])
@pytest.mark.parametrize("max_norm", [1.0, 0.0])
def test_masked_optimizer_matches_optax(frozen, max_norm):
    base = _params(2)
    pred = (lambda n: n.startswith(frozen)) if frozen != "none" else (lambda n: False)
    jmask = jpol.trainable_mask(base, pred)
    tx = joptim.make_optimizer(max_norm, jmask)
    jp = jax.tree_util.tree_map(jnp.asarray, base)
    jstate = tx.init(jp)
    tmask = tpol.trainable_mask(params_from_numpy(base), pred)
    opt = toptim.make_optimizer(max_norm, tmask)
    tp = params_from_numpy(base)
    tstate = opt.init(tp)
    for i, lr in enumerate((1e-3, 2e-3)):
        g = _grads(base, i)
        jstate = joptim.set_lr(jstate, lr)
        upd, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update(leaves(params_from_numpy(g)), toptim.set_lr(tstate, lr))
    assert_trees_close(tp, _np(jp), leaf_tol=1e-5)
    for (name, a), b in zip(named_leaves(tp), leaves(params_from_numpy(base))):
        if (frozen != "none" and name.startswith("/las/")) or name == "/emb_dyn_ave":
            assert torch.equal(a, b), name  # frozen: unchanged
        else:
            assert not torch.equal(a, b), name
    tree = opt.state_tree(tp, tstate)
    ref = serialization.to_state_dict(jstate)
    got = flax_msgpack.to_state_dict(tree)
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda x: 0, got)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda x: 0, ref))
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                 jax.tree_util.tree_flatten_with_path(ref)[0]):
        x, y = _as_np(a).astype(np.float64), np.asarray(b, np.float64)
        assert np.linalg.norm(x - y) <= 1e-5 * max(np.linalg.norm(y), 1e-30), str(path)


def test_clip_norm_over_trainable_leaves_only():
    """A frozen leaf with a huge gradient changes nothing: the trainable
    leaves' update equals the update without that leaf in the tree."""
    base = _params(4)
    mask = tpol.trainable_mask(params_from_numpy(base), lambda n: n.startswith("las."))
    g = _grads(base, 0, scale=1.0)
    g_big = jax.tree_util.tree_map(lambda x: x, g)
    g_big["las"]["encoder"]["acous_enc_l1"]["fwd"]["w_ih"] = (
        g["las"]["encoder"]["acous_enc_l1"]["fwd"]["w_ih"] * 1e6)
    outs = []
    for grads in (g, g_big):
        p = params_from_numpy(base)
        opt = toptim.make_optimizer(1.0, mask)
        st = opt.init(p)
        opt.update(leaves(params_from_numpy(grads)), toptim.set_lr(st, 1e-2))
        outs.append(p)
    for (name, a), b in zip(named_leaves(outs[0]), leaves(outs[1])):
        assert torch.equal(a, b), name


# ---------------------------------------------------------- checkpoints


def test_msgpack_bytes_equal_flax(monkeypatch):
    for dtype in (jnp.float32, jnp.bfloat16):
        p = _params(5, dtype)
        ref = serialization.to_bytes(p)
        assert flax_msgpack.to_bytes(params_from_numpy(p)) == ref
        back = flax_msgpack.msgpack_restore(ref)
        assert_trees_close(back, serialization.msgpack_restore(ref))
    # flax splits arrays over MAX_CHUNK_SIZE bytes; the reader joins them
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    p = _params(5)
    chunked = serialization.to_bytes(p)
    assert b"__msgpack_chunked_array__" in chunked
    assert_trees_close(flax_msgpack.msgpack_restore(chunked), p)


def _jax_opt(params, frozen=lambda n: False):
    tx = joptim.make_optimizer(1.0, jpol.trainable_mask(params, frozen))
    return tx, tx.init(jax.tree_util.tree_map(jnp.asarray, params))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_loads_port_checkpoint(tmp_path, dtype):
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    base = _params(6, jd)
    tp = params_from_numpy(base)
    mask = tpol.trainable_mask(tp, lambda n: False)
    opt = toptim.make_optimizer(1.0, mask)
    st = opt.init(tp)
    for i in range(2):
        opt.update([g.to(p.dtype) for g, p in zip(leaves(params_from_numpy(_grads(base, i))),
                                                   leaves(tp))], toptim.set_lr(st, 1e-3))
    ck = tckpt.Checkpoint(tp, opt.state_tree(tp, st), epoch=2, step=7,
                          input_vocab=["a", "b"], output_vocab=["c"],
                          model_config={"dim_model": 16})
    path = ck.save(str(tmp_path))
    _, template = _jax_opt(base)
    loaded = jckpt.Checkpoint.load(path, params_template=jax.tree_util.tree_map(jnp.asarray, base),
                                   opt_state_template=template)
    assert (loaded.epoch, loaded.step, loaded.input_vocab, loaded.output_vocab) == \
        (2, 7, ["a", "b"], ["c"])
    assert loaded.model_config == {"dim_model": 16}
    assert_trees_close(tp, _np(loaded.params))
    for a in jax.tree_util.tree_leaves(loaded.params):
        assert a.dtype == jd
    adam = loaded.opt_state.inner_states["train"].inner_state[1]
    assert int(adam.count) == 2
    assert jax.tree_util.tree_leaves(adam.mu)[0].dtype == jd
    assert float(joptim.get_lr(loaded.opt_state)) == pytest.approx(1e-3)


def test_port_loads_jax_checkpoint_and_continues(tmp_path):
    """JAX trains 2 updates and saves; the port loads params and optimizer
    state; one more update each from the same gradients agrees."""
    base = _params(7)
    tx, jstate = _jax_opt(base, lambda n: n.startswith("las.encoder"))
    jp = jax.tree_util.tree_map(jnp.asarray, base)
    for i in range(2):
        upd, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, _grads(base, i)),
                                joptim.set_lr(jstate, 1e-3), jp)
        jp = optax.apply_updates(jp, upd)
    path = jckpt.Checkpoint(jp, jstate, epoch=1, step=2).save(str(tmp_path))
    ck = tckpt.Checkpoint.load(path, params_template=params_from_numpy(base),
                               with_opt_state=True)
    assert (ck.epoch, ck.step) == (1, 2)
    assert_trees_close(ck.params, _np(jp))
    tp = ck.params
    frozen = lambda n: n.startswith("las.encoder")
    opt = toptim.make_optimizer(1.0, tpol.trainable_mask(tp, frozen))
    st = opt.init(tp)
    opt.load_state_tree(tp, st, ck.opt_state)
    assert st.param_groups[0]["lr"] == pytest.approx(1e-3)
    g = _grads(base, 9)
    upd, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                            joptim.set_lr(jstate, 2e-3), jp)
    jp = optax.apply_updates(jp, upd)
    opt.update(leaves(params_from_numpy(g)), toptim.set_lr(st, 2e-3))
    assert_trees_close(tp, _np(jp), leaf_tol=1e-5)


def test_directory_discipline_matches_jax(tmp_path):
    """Three checkpoints: the latest lookups, rm_old and combine_weights
    (float64 average back in each dtype) against JAX's on the same dir."""
    trees = [_params(10 + i) for i in range(3)]
    for i, p in enumerate(trees):
        tckpt.Checkpoint(params_from_numpy(p), epoch=i, step=i).save(str(tmp_path))
        time.sleep(0.002)
    for fn in ("get_latest_checkpoint", "get_secondlast_checkpoint",
               "get_thirdlast_checkpoint"):
        assert getattr(tckpt.Checkpoint, fn)(str(tmp_path)) == \
            getattr(jckpt.Checkpoint, fn)(str(tmp_path))
    assert tckpt.Checkpoint.load(tckpt.Checkpoint.get_latest_checkpoint(str(tmp_path))).step == 2
    ck_dir = os.path.join(str(tmp_path), "checkpoints")
    avg_t = tckpt.combine_weights(ck_dir, params_template=params_from_numpy(trees[0]))
    avg_j = jckpt.combine_weights(ck_dir, params_template=jax.tree_util.tree_map(
        jnp.asarray, trees[0]))
    assert_trees_close(avg_t, _np(avg_j))
    tckpt.log_ckpts(ck_dir, str(tmp_path))
    assert open(os.path.join(str(tmp_path), "ckpts.log")).read().count("\n") == 3
    tckpt.Checkpoint(None).rm_old(str(tmp_path), keep_num=1)
    assert len(os.listdir(ck_dir)) == 1
    assert tckpt.Checkpoint.get_latest_checkpoint(str(tmp_path / "nothing")) is None
    e = tckpt.Checkpoint(params_from_numpy(trees[0]), epoch=3).save_epoch(str(tmp_path), 3)
    assert e.endswith(os.path.join("checkpoints_epoch", "3"))


def test_upgrade_params_matches_jax():
    old = _params(20)
    del old["emb_dyn_ave"]
    old["enc_emb_proj"]["w"] = old["enc_emb_proj"]["w"][:3]  # another shape
    template = _params(21)
    ref = jckpt.upgrade_params(old, jax.tree_util.tree_map(jnp.asarray, template))
    got = tckpt.upgrade_params(params_from_numpy(old), params_from_numpy(template))
    assert_trees_close(got, _np(ref))
