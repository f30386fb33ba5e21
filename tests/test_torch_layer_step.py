"""Port vs JAX on CPU: the plain versions of K5 (decoder_layer_step) and K7
(decode_head, decode_head_gather), and their wrappers' CPU routes.

K7 is held against the JAX package's Pallas kernels run in interpret mode,
as that package runs them on the CPU; K5 against its dense XLA layer steps
(`decoder_layer_step` at group 1, `decoder_layer_step_beam` with an
ancestry map) and once against the Pallas `decoder_layer_step_flash` in
interpret mode, at the smallest shapes its block asserts allow. Caches are
converted between the two layouts: the port's [K, B, Lpad, D] slot (k, b)
is the JAX dense cache's row b*K + k, [n, L, d]. f32 on both sides, other
summation orders: values within 1e-5, ids equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stjep_tpu.ops import decode_flash as jdf
from stjep_tpu.ops.transformer import (
    KVCache,
    decoder_layer_init,
    decoder_layer_step,
    decoder_layer_step_beam,
    mha_cross_precompute,
)
from stjep_tpu_torch.bridge import params_from_numpy
from stjep_tpu_torch.ops.decode_flash import (
    CROSS_BLOCK,
    decode_head,
    decode_head_gather,
    decode_head_gather_plain,
    decode_head_plain,
    decoder_layer_step_flash,
    decoder_layer_step_plain,
    pad_len,
)

TOL = 1e-5
D, NH, FF = 128, 4, 256
LK, LPAD = 11, 16


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL, rtol=0)


def _head_inputs(V, ties, BK=6):
    rng = np.random.RandomState(V + ties)
    x = rng.randn(BK, D).astype(np.float32)
    norm = {"scale": (1 + 0.1 * rng.randn(D)).astype(np.float32),
            "bias": (0.1 * rng.randn(D)).astype(np.float32)}
    w = (rng.randn(D, V) / np.sqrt(D)).astype(np.float32)
    if ties:
        # two live LayerNorm features: each logit is a sum of two products,
        # exact in any order, and every column repeats every 8 ids, so the
        # top ids are exact ties that must resolve to the lowest id
        norm["scale"] = np.zeros(D, np.float32)
        norm["scale"][[5, 77]] = [1.3, -0.8]
        norm["bias"] = np.zeros(D, np.float32)
        w = w[:, np.arange(V) % 8].copy()
    gid = rng.randint(0, V, BK).astype(np.int32)
    return x, norm, {"w": w}, gid


@pytest.mark.parametrize("V,ties", [(40, False), (13000, False), (40, True)])
@pytest.mark.parametrize("route", ["plain", "wrapper"])
def test_decode_head_matches_jax_kernel(V, ties, route):
    x, norm, out, gid = _head_inputs(V, ties)
    topk = 3
    jn, jo = jax.tree_util.tree_map(jnp.asarray, (norm, out))
    r_sc, r_ids = jdf.decode_head(jn, jo, jnp.asarray(x), topk)
    g_sc, g_ids, g_lp = jdf.decode_head_gather(jn, jo, jnp.asarray(x), topk,
                                               jnp.asarray(gid))
    head, head_g = ((decode_head_plain, decode_head_gather_plain) if route == "plain"
                    else (decode_head, decode_head_gather))
    tn, to, tx = params_from_numpy(norm), params_from_numpy(out), torch.from_numpy(x)
    sc, ids = head(tn, to, tx, topk)
    sc2, ids2, glp = head_g(tn, to, tx, topk, torch.from_numpy(gid))
    assert ids.dtype == ids2.dtype == torch.int32
    for a, b in ((ids, r_ids), (ids2, g_ids)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in ((sc, r_sc), (sc2, g_sc), (glp, g_lp)):
        _close(a.numpy(), b)
    if ties:
        assert (ids[:, 1:] - ids[:, :-1] == 8).all()  # lowest copies first


def _layer(seed):
    """One decoder layer from the JAX init, LayerNorms and FFN biases
    randomised so that none is the identity."""
    lp = jax.tree_util.tree_map(np.asarray, decoder_layer_init(
        jax.random.PRNGKey(seed), D, NH, FF))
    rng = np.random.RandomState(seed)
    for blk in ("decslf_attn", "encdec_attn", "pos_ffn"):
        lp[blk]["layer_norm"] = {"scale": (1 + 0.1 * rng.randn(D)).astype(np.float32),
                                 "bias": (0.1 * rng.randn(D)).astype(np.float32)}
    for k in ("w_1", "w_2"):
        b = lp["pos_ffn"][k]["b"]
        lp["pos_ffn"][k]["b"] = (0.1 * rng.randn(*b.shape)).astype(np.float32)
    return lp


def _state(B, K, pos, seed, Lk=LK):
    """Numpy inputs of one layer step: caches filled below pos, a random
    ancestry (own slot at pos), one masked prefix key, ragged memory."""
    rng = np.random.RandomState(seed)
    BK = B * K
    ck = np.zeros((K, B, LPAD, D), np.float32)
    cv = np.zeros_like(ck)
    ck[:, :, :pos] = rng.randn(K, B, pos, D)
    cv[:, :, :pos] = rng.randn(K, B, pos, D)
    anc = rng.randint(0, K, (LPAD, BK)).astype(np.int32)
    anc[pos] = np.arange(BK) % K
    maskk = (np.arange(LPAD)[:, None] <= pos).repeat(BK, 1).astype(np.int32)
    maskk[1, 0] = 0
    mem_len = rng.randint(1, Lk + 1, B)
    mem_len[0] = Lk
    return dict(x=rng.randn(BK, D).astype(np.float32), ck=ck, cv=cv, anc=anc,
                maskk=maskk, memory=rng.randn(B, Lk, D).astype(np.float32),
                mem_mask=np.arange(Lk)[None, :] < mem_len[:, None])


def _port_step(step, lp, s, pos, K):
    """The port's layer step on s; returns (y, ck, cv) as numpy."""
    tp = params_from_numpy(lp)
    B, Lk = s["mem_mask"].shape
    Lk_pad = pad_len(Lk, CROSS_BLOCK)
    mem = F.pad(torch.from_numpy(s["memory"]), (0, 0, 0, Lk_pad - Lk))
    mk, mv = (mem @ tp["encdec_attn"][k]["w"] for k in ("w_ks", "w_vs"))
    mm = torch.from_numpy(np.pad(s["mem_mask"], ((0, 0), (0, Lk_pad - Lk))).T
                          .astype(np.int32).copy())
    ck, cv = torch.from_numpy(s["ck"].copy()), torch.from_numpy(s["cv"].copy())
    y = step(tp, torch.from_numpy(s["x"]), ck, cv, mk, mv, pos, NH,
             torch.from_numpy(s["anc"]), K, mm, torch.from_numpy(s["maskk"]))
    assert y.shape == (B * K, D)
    return y.numpy(), ck.numpy(), cv.numpy()


def _to_dense(c):
    """[K, B, L, D] slots -> the dense [B*K, n, L, d] rows."""
    K, B, L, _ = c.shape
    return c.transpose(1, 0, 2, 3).reshape(B * K, L, NH, D // NH).transpose(0, 2, 1, 3)


def _from_dense(c, K):
    BK, n, L, d = c.shape
    return np.asarray(c).transpose(0, 2, 1, 3).reshape(BK // K, K, L, n * d).transpose(1, 0, 2, 3)


STEPS = [decoder_layer_step_plain, decoder_layer_step_flash]


@pytest.mark.parametrize("pos", [0, 5, LPAD - 1])
@pytest.mark.parametrize("step", STEPS)
def test_layer_step_group1_matches_dense(step, pos):
    lp, s, B = _layer(1), _state(3, 1, pos, 10 + pos), 3
    y, ck, cv = _port_step(step, lp, s, pos, 1)
    jl = jax.tree_util.tree_map(jnp.asarray, lp)
    ry, rc = decoder_layer_step(
        jl, jnp.asarray(s["x"])[:, None], KVCache(k=_to_dense(s["ck"]), v=_to_dense(s["cv"])),
        mha_cross_precompute(jl["encdec_attn"], jnp.asarray(s["memory"]), NH),
        jnp.int32(pos), NH, mem_mask=jnp.asarray(s["mem_mask"]),
        self_mask_k=jnp.asarray(s["maskk"].T != 0))
    _close(y, np.asarray(ry)[:, 0])
    _close(ck, _from_dense(rc.k, 1))
    _close(cv, _from_dense(rc.v, 1))
    assert np.array_equal(ck[:, :, pos + 1:], s["ck"][:, :, pos + 1:])


@pytest.mark.parametrize("pos", [1, 7])
@pytest.mark.parametrize("step", STEPS)
def test_layer_step_ancestry_matches_dense_beam(step, pos):
    """Group 3: row r reads position l from slot anc[l, r] of its group."""
    K, B = 3, 2
    lp, s = _layer(2), _state(B, K, pos, 20 + pos)
    y, ck, cv = _port_step(step, lp, s, pos, K)
    jl = jax.tree_util.tree_map(jnp.asarray, lp)
    ry, rc = decoder_layer_step_beam(
        jl, jnp.asarray(s["x"])[:, None], KVCache(k=_to_dense(s["ck"]), v=_to_dense(s["cv"])),
        mha_cross_precompute(jl["encdec_attn"], jnp.asarray(s["memory"]), NH),
        jnp.int32(pos), NH, jnp.asarray(s["anc"].T), K,
        mem_mask_b=jnp.asarray(s["mem_mask"]),
        self_mask_k=jnp.asarray(s["maskk"].T != 0))
    _close(y, np.asarray(ry)[:, 0])
    _close(ck, _from_dense(rc.k, K))
    _close(cv, _from_dense(rc.v, K))


@pytest.mark.parametrize("step", STEPS)
def test_layer_step_matches_pallas_kernel(step):
    """The JAX package's decoder_layer_step_flash in interpret mode: B=1,
    K=2, one 16-row self block and one 32-row memory block."""
    K, B, pos, Lk = 2, 1, 6, CROSS_BLOCK
    lp, s = _layer(3), _state(B, K, pos, 30, Lk=Lk)
    y, ck, cv = _port_step(step, lp, s, pos, K)
    jl = jax.tree_util.tree_map(jnp.asarray, lp)
    mem = jnp.asarray(s["memory"])
    ry, rck, rcv = jdf.decoder_layer_step_flash(
        jl, jnp.asarray(s["x"])[:, None], jnp.asarray(s["ck"]), jnp.asarray(s["cv"]),
        mem @ jl["encdec_attn"]["w_ks"]["w"], mem @ jl["encdec_attn"]["w_vs"]["w"],
        jnp.int32(pos), NH, jnp.asarray(s["anc"]), K, jnp.asarray(s["mem_mask"].T),
        jnp.asarray(s["maskk"] != 0))
    _close(y, np.asarray(ry)[:, 0])
    _close(ck, rck)
    _close(cv, rcv)


def test_layer_step_wrapper_counts_no_cpu_launch():
    """On CPU tensors the wrappers run the plain versions and launch
    nothing."""
    before = (decoder_layer_step_flash.launches, decode_head.launches,
              decode_head_gather.launches)
    test_layer_step_group1_matches_dense(decoder_layer_step_flash, 3)
    x, norm, out, gid = _head_inputs(40, False)
    decode_head_gather(params_from_numpy(norm), params_from_numpy(out),
                       torch.from_numpy(x), 2, torch.from_numpy(gid))
    assert (decoder_layer_step_flash.launches, decode_head.launches,
            decode_head_gather.launches) == before
