"""Port vs JAX on CPU: tensor-parallel decode over a model axis driven from
one process (parallel/mesh.py, parallel/spmd.py, ops/decode_flash_tp.py),
on the plain routes.

- shard_params: shard m of every TP-ruled leaf holds the bytes of JAX's
  param_pspec slice m; every other leaf is the whole tensor.
- K6a-c (self_attn_step, cross_attn_step, ffn_step) and K7c
  (decode_head_partial) against the JAX Pallas kernels in interpret mode,
  on a head shard (Dq = D/2, 2 of 4 heads), residual / partial_tp on and
  off: f32 values within TOL, ids equal, the written cache rows within TOL;
  bf16 caches within TOL_BF16 and one bf16 step (tests/test_torch_serving.py
  gives the reason).
- The trio (K6a-c with residuals) and the TP layer step (2 and 4 shards,
  joined) against the port's K5 at full width.
- decode_head_tp against JAX's under jax.shard_map over 2 CPU devices, and
  against the port's dense head.
- The slice: forward_eval("MT") with refs on meshes (8/n, n), n = 2 and 4,
  standard and universal, against JAX forward_eval(use_flash=False); the
  beam at width 2 on mesh (4, 2) against JAX's single-device beam: tokens
  equal after masking past EOS (each data shard stops at its own all-EOS),
  picked and scores within 1e-4 (JAX tests/test_tp_decode.py's limits).
- The gates: a vocabulary that does not divide (tp_flash_ok false) still
  decodes JAX's tokens; int8 weights under a model axis raise; a DP-only
  mesh decodes what no mesh decodes; make_mesh degrades as JAX's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from stjep_tpu.config import BOS, EOS, ModelConfig
from stjep_tpu.infer.beam import beam_search as jax_beam_search
from stjep_tpu.models.seq2seq import forward_eval as jax_forward_eval
from stjep_tpu.models.seq2seq import init_seq2seq as jax_init
from stjep_tpu.ops import decode_flash as jdf
from stjep_tpu.ops.decode_flash_tp import decode_head_tp as jax_decode_head_tp
from stjep_tpu.parallel import mesh as jmesh
from stjep_tpu.train.policies import map_with_path as jax_map_with_path
from stjep_tpu_torch.bridge import named_leaves, params_from_numpy
from stjep_tpu_torch.infer.beam import beam_search
from stjep_tpu_torch.infer.forward import forward_eval
from stjep_tpu_torch.ops import decode_flash as tdf
from stjep_tpu_torch.ops.decode_flash_tp import (
    ModelAxis,
    decode_head_tp,
    decoder_layer_step_flash_tp,
)
from stjep_tpu_torch.parallel import mesh as tmesh
from stjep_tpu_torch.parallel import spmd

TOL = 1e-5
TOL_BF16 = 2e-4  # tests/test_torch_serving.py TOL_BF16
TOL_DECODE = 1e-4  # picked / beam scores through the decode, JAX's TP limit
BF16 = torch.bfloat16


def _mt_cfg(**kw):
    """JAX tests/test_tp_decode.py's _mt_cfg: D=128, FF 64, 4 heads, 2
    decoder layers, V=20."""
    d = dict(
        enc_vocab_size=24, dec_vocab_size=20, enc_embedding_size=8,
        dec_embedding_size=16, acous_dim=8, acous_hidden_size=64,
        dim_model=128, dim_feedforward=64, num_heads=4, enc_layers=1,
        dec_layers=2, num_unilstm_dec=3, spec_aug=False, dropout=0.0,
        max_seq_len_src=10, max_seq_len_tgt=12, mode="MT")
    d.update(kw)
    return ModelConfig(**d)


CFG = _mt_cfg()
D, NH, FF, V = CFG.dim_model, CFG.num_heads, CFG.dim_feedforward, CFG.dec_vocab_size
LPAD, LK = 16, 32


@pytest.fixture(autouse=True)
def _clear_port_mesh():
    yield
    spmd.set_kernel_mesh(None)


def _jax_params(cfg=CFG, seed=0):
    return jax.tree_util.tree_map(np.array, jax_init(jax.random.PRNGKey(seed), cfg))


def _mask_after_eos(preds):
    p = np.asarray(preds).copy()
    for r in p:
        hit = np.where(r == EOS)[0]
        if hit.size:
            r[hit[0] + 1:] = 0
    return p


def _cpu_mesh(n_data, n_model):
    return tmesh.make_mesh(n_data, n_model, ["cpu"] * (n_data * n_model))


# ---------------------------------------------------------------------------
# the weight split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_shard_params_match_jax_pspec(n):
    jp = _jax_params()
    shards = tmesh.shard_params(params_from_numpy(jp), _cpu_mesh(1, n))
    specs = {}
    jax_map_with_path(jp, lambda name, leaf: specs.setdefault(
        name, tuple(jmesh.param_pspec(name, leaf, n))))
    split = 0
    for m, tree in enumerate(shards):
        for path, t in named_leaves(tree):
            name = path.lstrip("/").replace("/", ".")
            ref = jp
            for k in name.split("."):
                ref = ref[int(k)] if isinstance(ref, list) else ref[k]
            spec = specs[name]
            assert tmesh.param_pspec(name, t, 1) == () and (
                tmesh.param_pspec(name, torch.from_numpy(ref), n) == spec), name
            for dim, ax in enumerate(spec):
                if ax == jmesh.MODEL_AXIS:
                    w = ref.shape[dim] // n
                    ref = np.take(ref, np.arange(m * w, (m + 1) * w), axis=dim)
                    split += m == 0
            assert t.is_contiguous() and t.numpy().tobytes() == np.ascontiguousarray(
                ref).tobytes(), name
    assert split == sum(1 for v in specs.values() if v) > 0


def test_make_mesh_degrades_to_data_parallel():
    m = tmesh.make_mesh(n_model=3, devices=["cpu"] * 8)
    assert m.shape == {"data": 8, "model": 1}
    m = tmesh.make_mesh(n_data=3, n_model=2, devices=["cpu"] * 8)
    assert m.shape == {"data": 8, "model": 1}
    m = tmesh.make_mesh(n_model=4, devices=["cpu"] * 8)
    assert m.shape == {"data": 2, "model": 4} and len(m.devices[1]) == 4


# ---------------------------------------------------------------------------
# K6a-c and K7c against the JAX kernels (interpret mode), on a head shard
# ---------------------------------------------------------------------------


def _layer(seed=3):
    """One decoder layer (numpy), LayerNorms and FFN biases randomised."""
    lp = _jax_params()["dec_tgt"]["layers"][0]
    rng = np.random.RandomState(seed)
    for blk in ("decslf_attn", "encdec_attn", "pos_ffn"):
        lp[blk]["layer_norm"] = {"scale": (1 + 0.1 * rng.randn(D)).astype(np.float32),
                                 "bias": (0.1 * rng.randn(D)).astype(np.float32)}
    for k in ("w_1", "w_2"):
        lp["pos_ffn"][k]["b"] = (0.1 * rng.randn(*lp["pos_ffn"][k]["b"].shape)).astype(np.float32)
    return lp


def _shard_of(layer, m, n):
    """Shard m of n of a numpy decoder layer, by the port's rules under the
    layer's key path."""
    return tmesh.map_with_path(layer, lambda name, leaf: np.ascontiguousarray(
        tmesh._shard(torch.from_numpy(leaf), tmesh.param_pspec(
            "dec_tgt.layers.0." + name, torch.from_numpy(leaf), n), m, n, "cpu").numpy()))


def _bf16_exact(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float().numpy()


def _state(K, Dq, pos, seed, bf16):
    """A decode state for B=2 and group K at a head shard: caches [K, B,
    LPAD, Dq] filled below pos (bf16-exact for bf16), a random ancestry with
    each row's own slot at pos, one masked prefix key, ragged memory K/V
    [B, LK, Dq]."""
    rng = np.random.RandomState(seed)
    B, BK = 2, 2 * K
    ck = np.zeros((K, B, LPAD, Dq), np.float32)
    cv = np.zeros_like(ck)
    ck[:, :, :pos] = rng.randn(K, B, pos, Dq)
    cv[:, :, :pos] = rng.randn(K, B, pos, Dq)
    mk, mv = (rng.randn(B, LK, Dq).astype(np.float32) for _ in range(2))
    if bf16:
        ck, cv, mk, mv = map(_bf16_exact, (ck, cv, mk, mv))
    anc = rng.randint(0, K, (LPAD, BK)).astype(np.int32)
    anc[pos] = np.arange(BK) % K
    maskk = (np.arange(LPAD)[:, None] <= pos).repeat(BK, 1).astype(np.int32)
    maskk[1, 0] = 0
    mem_mask = (np.arange(LK)[:, None] < np.array([LK, 9])[None, :]).astype(np.int32)
    return dict(x=rng.randn(BK, D).astype(np.float32), ck=ck, cv=cv, mk=mk, mv=mv,
                anc=anc, maskk=maskk, mem_mask=mem_mask)


def _torch(s, bf16):
    dt = BF16 if bf16 else torch.float32
    return {k: torch.from_numpy(v.copy()).to(dt) if k in ("ck", "cv", "mk", "mv")
            else torch.from_numpy(v.copy()) for k, v in s.items()}


def _jax(s, bf16):
    dt = jnp.bfloat16 if bf16 else jnp.float32
    return {k: jnp.asarray(v, dt) if k in ("ck", "cv", "mk", "mv") else jnp.asarray(v)
            for k, v in s.items()}


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=tol, rtol=0)


def _cache_close(a, b, bf16):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    tol = 2.0 ** -7 * np.abs(b) + TOL if bf16 else TOL
    assert (np.abs(a - b) <= tol).all(), float(np.abs(a - b).max())


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_self_attn_step_matches_jax_kernel(bf16, residual):
    """K6a on shard 1 of 2 (Dq 64, 2 local heads), group 2 with a random
    ancestry, pos 6: the plain version and the wrapper's CPU route."""
    K, pos, n = 2, 6, 2
    sa = _shard_of(_layer(), 1, n)["decslf_attn"]
    assert sa["w_qs"]["w"].shape == (D, D // n) and sa["fc"]["w"].shape == (D // n, D)
    s = _state(K, D // n, pos, 11, bf16)
    js = _jax(s, bf16)
    ry, rck, rcv = jdf.self_attn_step(
        jax.tree_util.tree_map(jnp.asarray, sa), js["x"][:, None], js["ck"], js["cv"],
        jnp.int32(pos), NH // n, js["anc"], K, js["maskk"] != 0, residual=residual)
    for fn in (tdf.self_attn_step_plain, tdf.self_attn_step):
        ts = _torch(s, bf16)
        y = fn(params_from_numpy(sa), ts["x"], ts["ck"], ts["cv"], pos, NH // n, ts["anc"],
               K, ts["maskk"], residual=residual)
        _close(y.numpy(), np.asarray(ry)[:, 0], TOL_BF16 if bf16 else TOL)
        _cache_close(ts["ck"].float().numpy(), rck.astype(jnp.float32), bf16)
        _cache_close(ts["cv"].float().numpy(), rcv.astype(jnp.float32), bf16)


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cross_attn_step_matches_jax_kernel(bf16, residual):
    """K6b on shard 0 of 2 over unexpanded ragged memory, group 2."""
    K, n = 2, 2
    ca = _shard_of(_layer(), 0, n)["encdec_attn"]
    s = _state(K, D // n, 0, 12, bf16)
    js = _jax(s, bf16)
    ry = jdf.cross_attn_step(jax.tree_util.tree_map(jnp.asarray, ca), js["x"][:, None],
                             js["mk"], js["mv"], NH // n, K, js["mem_mask"] != 0,
                             residual=residual)
    ts = _torch(s, bf16)
    for fn in (tdf.cross_attn_step_plain, tdf.cross_attn_step):
        y = fn(params_from_numpy(ca), ts["x"], ts["mk"], ts["mv"], NH // n, K,
               ts["mem_mask"], residual=residual)
        _close(y.numpy(), np.asarray(ry)[:, 0], TOL_BF16 if bf16 else TOL)


@pytest.mark.parametrize("partial_tp", [False, True])
def test_ffn_step_matches_jax_kernel(partial_tp):
    """K6c on the hidden shard 1 of 2 (w_1 [128, 32] and b_1 [32], w_2
    [32, 128]); without partial_tp on the full layer (+ b_2 + x)."""
    ff = _layer()["pos_ffn"]
    if partial_tp:
        ff = _shard_of(_layer(), 1, 2)["pos_ffn"]
        assert ff["w_1"]["b"].shape == (FF // 2,) and ff["w_2"]["b"].shape == (D,)
    x = np.random.RandomState(13).randn(6, D).astype(np.float32)
    ry = jdf.ffn_step(jax.tree_util.tree_map(jnp.asarray, ff), jnp.asarray(x)[:, None],
                      partial_tp=partial_tp)
    for fn in (tdf.ffn_step_plain, tdf.ffn_step):
        _close(fn(params_from_numpy(ff), torch.from_numpy(x), partial_tp).numpy(),
               np.asarray(ry)[:, 0])


@pytest.mark.parametrize("v_local,topk,gather", [(10, 3, False), (10, 3, True),
                                                 (3, 5, True)])
def test_decode_head_partial_matches_jax_kernel(v_local, topk, gather):
    """K7c on one vocabulary shard: raw top-K logits, local ids, mx, se and
    the raw logit at gather ids in the shard, above it and negative (0
    there); a shard narrower than topk gives JAX's -1e30 candidates."""
    rng = np.random.RandomState(v_local + topk)
    BK = 6
    x = rng.randn(BK, D).astype(np.float32)
    norm = {"scale": (1 + 0.1 * rng.randn(D)).astype(np.float32),
            "bias": (0.1 * rng.randn(D)).astype(np.float32)}
    out = {"w": (rng.randn(D, v_local) / np.sqrt(D)).astype(np.float32)}
    gid = np.array([0, v_local - 1, v_local, 2 * v_local + 1, -1, -v_local], np.int32)
    jn, jo = jax.tree_util.tree_map(jnp.asarray, (norm, out))
    ref = jdf.decode_head_partial(jn, jo, jnp.asarray(x), topk,
                                  gather_ids=jnp.asarray(gid) if gather else None)
    for fn in (tdf.decode_head_partial_plain, tdf.decode_head_partial):
        got = fn(params_from_numpy(norm), params_from_numpy(out), torch.from_numpy(x), topk,
                 torch.from_numpy(gid) if gather else None)
        assert len(got) == len(ref) and got[1].dtype == torch.int32
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        for i in (0, 2, 3) + ((4,) if gather else ()):
            _close(got[i].numpy(), ref[i])
        if gather:
            assert (got[4][2:] == 0).all()
    if v_local < topk:
        assert (got[0][:, v_local:] == -1e30).all() and (got[1][:, v_local:] == 0).all()


# ---------------------------------------------------------------------------
# the trio and the TP layer step against K5; the vocabulary-split head
# ---------------------------------------------------------------------------


def test_trio_and_tp_layer_step_match_k5():
    """At full width the trio (residuals on) computes K5; the TP layer step
    on 2 and 4 shards, joined, too (group 3, pos 5)."""
    K, pos = 3, 5
    lp = params_from_numpy(_layer(4))
    s = _torch(_state(K, D, pos, 14, False), False)
    s["mk"], s["mv"] = s["mk"] / 4, s["mv"] / 4

    def run(step):
        ck, cv = s["ck"].clone(), s["cv"].clone()
        y = step(lp, s["x"], ck, cv, s["mk"], s["mv"], pos, NH, s["anc"], K,
                 s["mem_mask"], s["maskk"])
        return y, ck, cv

    y5, ck5, cv5 = run(tdf.decoder_layer_step_flash)
    for y, ck, cv in (run(tdf.decoder_layer_step_flash_trio), run(tdf.decoder_layer_step_plain)):
        _close(y, y5)
        _close(ck, ck5)
        _close(cv, cv5)
    for n in (2, 4):
        axis = ModelAxis(["cpu"] * n)
        shards = [_shard_of(_layer(4), m, n) for m in range(n)]
        dq = D // n
        cks = [s["ck"][..., m * dq:(m + 1) * dq].clone() for m in range(n)]
        cvs = [s["cv"][..., m * dq:(m + 1) * dq].clone() for m in range(n)]
        rep = lambda t: [t] * n
        ys = decoder_layer_step_flash_tp(
            [params_from_numpy(p) for p in shards], rep(s["x"]), cks, cvs,
            [s["mk"][..., m * dq:(m + 1) * dq].contiguous() for m in range(n)],
            [s["mv"][..., m * dq:(m + 1) * dq].contiguous() for m in range(n)],
            pos, NH // n, rep(s["anc"]), K, rep(s["mem_mask"]), rep(s["maskk"]), axis)
        assert all(y is ys[0] for y in ys)  # one join per device, shared
        _close(ys[0], y5)
        _close(torch.cat(cks, -1), ck5)
        _close(torch.cat(cvs, -1), cv5)


def test_decode_head_tp_matches_jax_shard_map():
    """The merge over 2 shards against JAX's decode_head_tp under
    jax.shard_map (tests/test_tp_decode.py's pattern) and the port's dense
    head: ids equal, scores and glp within TOL."""
    rng = np.random.RandomState(0)
    BK, Dh, Vh, k = 8, 16, 12, 3
    x = rng.randn(BK, Dh).astype(np.float32)
    norm = {"scale": (rng.rand(Dh) + 0.5).astype(np.float32),
            "bias": (rng.randn(Dh) * 0.1).astype(np.float32)}
    w = rng.randn(Dh, Vh).astype(np.float32)
    gids = rng.randint(0, Vh, size=(BK,)).astype(np.int32)
    mesh = jmesh.make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])

    def inner(x, s, b, w, g):
        sc, ids = jax_decode_head_tp({"scale": s, "bias": b}, {"w": w}, x, k, "model")
        _, _, glp = jax_decode_head_tp({"scale": s, "bias": b}, {"w": w}, x, k, "model",
                                       gather_ids=g)
        return sc, ids, glp

    fn = jax.shard_map(inner, mesh=mesh, in_specs=(P(), P(), P(), P(None, "model"), P()),
                       out_specs=(P(), P(), P()), check_vma=False)
    rsc, rids, rglp = (np.asarray(t) for t in fn(jnp.asarray(x), jnp.asarray(norm["scale"]),
                                                 jnp.asarray(norm["bias"]), jnp.asarray(w),
                                                 jnp.asarray(gids)))
    axis = ModelAxis(["cpu", "cpu"])
    tn = [params_from_numpy(norm)] * 2
    to = [{"w": torch.from_numpy(w[:, m * 6:(m + 1) * 6].copy())} for m in range(2)]
    tx = [torch.from_numpy(x)] * 2
    sc, ids = decode_head_tp(tn, to, tx, k, axis)
    sc_g, ids_g, glp = decode_head_tp(tn, to, tx, k, axis, gather_ids=torch.from_numpy(gids))
    dsc, dids = tdf.decode_head(tn[0], {"w": torch.from_numpy(w)}, tx[0], k)
    _, _, dglp = tdf.decode_head_gather(tn[0], {"w": torch.from_numpy(w)}, tx[0], k,
                                        torch.from_numpy(gids))
    for i in (ids[0], ids[1], ids_g[0]):
        np.testing.assert_array_equal(i.numpy(), rids)
        np.testing.assert_array_equal(i.numpy(), dids.numpy())
    for a, b in ((sc[0], rsc), (sc_g[0], rsc), (glp[0], rglp), (sc[0], dsc), (glp[1], dglp)):
        _close(a, b)


# ---------------------------------------------------------------------------
# the slice: dev eval and the beam on meshes
# ---------------------------------------------------------------------------


def _mt_inputs(cfg, B=8, seed=3):
    rng = np.random.RandomState(seed)
    src = rng.randint(5, cfg.enc_vocab_size, size=(B, cfg.max_seq_len_src)).astype(np.int32)
    tgt = rng.randint(5, cfg.dec_vocab_size, size=(B, cfg.max_seq_len_tgt)).astype(np.int32)
    src[:, 0] = tgt[:, 0] = BOS
    return src, tgt


def _eval_pair(cfg, mesh, seed=3):
    """(JAX forward_eval(use_flash=False) MT, the port's under `mesh`):
    (preds_mt, picked_mt) each."""
    jp = _jax_params(cfg)
    src, tgt = _mt_inputs(cfg, seed=seed)
    ref = jax_forward_eval(jax.tree_util.tree_map(jnp.asarray, jp), cfg, "MT",
                           src=jnp.asarray(src), ref_tgt=jnp.asarray(tgt), use_flash=False)
    spmd.set_kernel_mesh(mesh)
    out = forward_eval(params_from_numpy(jp), cfg, "MT", src=torch.from_numpy(src),
                       ref_tgt=torch.from_numpy(tgt), device="cpu")
    return ((np.asarray(ref["preds_mt"]), np.asarray(ref["picked_mt"])),
            (out["preds_mt"].numpy(), out["picked_mt"].numpy()))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["standard", "universal"])
def test_forward_eval_on_tp_mesh_matches_jax(kind, n):
    cfg = _mt_cfg(transformer_type=kind)
    before = (tdf.decode_head_partial.launches, tdf.self_attn_step.launches)
    calls = []
    real = tdf.decode_head_partial_plain

    def spy(*a, **kw):
        calls.append(a[1]["w"].shape)
        return real(*a, **kw)

    tdf.decode_head_partial_plain = spy
    try:
        (rp, rk), (p, k) = _eval_pair(cfg, _cpu_mesh(8 // n, n))
    finally:
        tdf.decode_head_partial_plain = real
    assert spmd.tp_flash_ok(cfg) and calls and all(c == (D, V // n) for c in calls)
    assert (tdf.decode_head_partial.launches, tdf.self_attn_step.launches) == before
    np.testing.assert_array_equal(_mask_after_eos(p), _mask_after_eos(rp))
    _close(k, rk, TOL_DECODE)


def test_tp_gate_indivisible_vocab_matches_jax():
    """V = 21 does not split over 2 shards: tp_flash_ok is false and the
    single-device route on the full params decodes JAX's tokens."""
    cfg = _mt_cfg(dec_vocab_size=21)
    (rp, rk), (p, k) = _eval_pair(cfg, _cpu_mesh(4, 2), seed=5)
    assert not spmd.tp_flash_ok(cfg)
    np.testing.assert_array_equal(_mask_after_eos(p), _mask_after_eos(rp))
    _close(k, rk, TOL_DECODE)


def _memory(seed=4, B=8, Lk=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Lk, D).astype(np.float32), rng.rand(B, Lk) > 0.2)


def test_beam_on_tp_mesh_matches_jax():
    """Beam width 2 on mesh (4, 2) against JAX's single-device beam."""
    jp = _jax_params()
    enc, mem = _memory()
    rp, rs = jax_beam_search(jax.tree_util.tree_map(jnp.asarray, jp), CFG, jnp.asarray(enc),
                             jnp.asarray(mem), 2, 1.0, 10, use_flash=False)
    spmd.set_kernel_mesh(_cpu_mesh(4, 2))
    p, s = beam_search(params_from_numpy(jp), CFG, torch.from_numpy(enc),
                       torch.from_numpy(mem), 2, 1.0, 10)
    np.testing.assert_array_equal(_mask_after_eos(p.numpy()), _mask_after_eos(rp))
    _close(s.numpy(), rs, TOL_DECODE)


@pytest.mark.parametrize("cache_dtype", [None, BF16], ids=["f32", "bf16"])
def test_tp_beam_matches_port_single_device(cache_dtype):
    """The port's TP beam (mesh (1, 4), universal model) against its own
    single-device route, f32 and bf16 caches; a ragged batch (7 rows over 2
    data shards) takes the unsharded call."""
    cfg = _mt_cfg(transformer_type="universal")
    p = params_from_numpy(_jax_params(cfg, 1))
    enc, mem = (torch.from_numpy(a) for a in _memory(6))
    for b in (8, 7):
        ref = beam_search(p, cfg, enc[:b], mem[:b], 3, 1.0, 10, cache_dtype=cache_dtype)
        spmd.set_kernel_mesh(_cpu_mesh(2, 4) if b == 7 else _cpu_mesh(1, 4))
        got = beam_search(p, cfg, enc[:b], mem[:b], 3, 1.0, 10, cache_dtype=cache_dtype)
        spmd.set_kernel_mesh(None)
        np.testing.assert_array_equal(_mask_after_eos(got[0]), _mask_after_eos(ref[0]))
        _close(got[1], ref[1], TOL_DECODE if cache_dtype is None else 1e-2)


def test_int8_under_model_axis_raises():
    spmd.set_kernel_mesh(_cpu_mesh(4, 2))
    enc, mem = _memory()
    with pytest.raises(ValueError, match="tensor-parallel mesh"):
        beam_search(params_from_numpy(_jax_params()), CFG, torch.from_numpy(enc),
                    torch.from_numpy(mem), 2, 1.0, 10, weight_dtype="int8")


def test_dp_only_mesh_equals_no_mesh():
    """Mesh (8, 1): each data shard's own loop gives what the whole batch
    gives, beam (int8 included) and dev eval."""
    p = params_from_numpy(_jax_params())
    enc, mem = (torch.from_numpy(a) for a in _memory(7))
    src, tgt = (torch.from_numpy(a) for a in _mt_inputs(CFG, seed=8))
    run = lambda: (beam_search(p, CFG, enc, mem, 2, 1.0, 10),
                   beam_search(p, CFG, enc, mem, 2, 1.0, 10, weight_dtype="int8"),
                   forward_eval(p, CFG, "MT", src=src, ref_tgt=tgt, device="cpu"))
    ref = run()
    spmd.set_kernel_mesh(_cpu_mesh(8, 1))
    assert spmd.dp_only_mesh() and not spmd.tp_flash_ok(CFG)
    got = run()
    for a, b in zip(ref[:2], got[:2]):
        np.testing.assert_array_equal(_mask_after_eos(a[0]), _mask_after_eos(b[0]))
        _close(a[1], b[1], TOL)
    np.testing.assert_array_equal(got[2]["preds_mt"], ref[2]["preds_mt"])
    _close(got[2]["picked_mt"], ref[2]["picked_mt"], TOL)
