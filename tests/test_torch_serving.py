"""Port vs JAX on CPU: the serving decode, int8 weight streaming and bf16
caches, in the plain routes (the CUDA kernels are held against these on the
card in tests/test_torch_cuda.py).

- quantize_decoder_weights: int8 and scale bytes equal to JAX's, an
  all-zero column included.
- K5 (decoder_layer_step) and K3 (decode_chain_step) with int8 weights,
  bf16 caches and both, against the JAX Pallas kernels in interpret mode.
  int8 with f32 caches: outputs, caches and scores within 1e-5, ids equal
  (f32 on both sides after the same dequantization; only the summation
  order differs). bf16 caches: see TOL_BF16.
- beam_search: int8 on grid-snapped weights (dequantization is then exact)
  line-identical to the port's f32 beam and to JAX's, at widths 1 and 3,
  standard and universal; int8 on random weights line-identical to JAX's
  int8 beam; bf16 caches line-identical to JAX's bf16 beam, scores within
  TOL_BF16_BEAM.
- The failure surface: forward_translate("ASR", weight_dtype=...) raises as
  JAX does; beam_search refuses other weight and cache dtypes; the entry
  points run on the card by default and refuse params that lie elsewhere.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stjep_tpu.config import ModelConfig
from stjep_tpu.infer.beam import beam_search as jax_beam_search
from stjep_tpu.infer.forward import forward_translate as jax_forward_translate
from stjep_tpu.models.seq2seq import init_seq2seq as jax_init
from stjep_tpu.ops import decode_flash as jdf
from stjep_tpu_torch.bridge import params_from_numpy
from stjep_tpu_torch.infer.beam import beam_search
from stjep_tpu_torch.infer.forward import forward_eval, forward_translate
from stjep_tpu_torch.ops import decode_flash as tdf
from stjep_tpu_torch.train import optim
from stjep_tpu_torch.train.trainer import make_train_step

TOL = 1e-5
# bf16 caches: both sides round q, the new K/V row and every q.k product to
# bf16 at the same points, but the f32 values rounded come from products
# summed in other orders, so a value within ~1e-7 of a rounding boundary
# may round one bf16 step (2^-8 to 2^-7 relative) apart, moving an output of unit
# scale by ~1e-5 to 1e-4 (these seeds: 2.6e-5 at most); the bf16 cache rows
# differ by at most one bf16 step. Kept beam scores sum ~14 such log-probs
# (these seeds: 5.7e-4 at most).
TOL_BF16 = 2e-4
TOL_BF16_BEAM = 2e-3
CFG = ModelConfig(
    enc_vocab_size=50, dec_vocab_size=40, enc_embedding_size=16,
    dec_embedding_size=32, acous_dim=8, acous_hidden_size=16, dim_model=32,
    dim_feedforward=64, num_heads=4, enc_layers=2, dec_layers=2,
    num_unilstm_dec=3, spec_aug=False, dropout=0.0, max_seq_len_src=12,
    max_seq_len_tgt=16, mode="ASR_ST")
CFGS = {"standard": CFG,
        "universal": dataclasses.replace(CFG, transformer_type="universal")}
D, NH, LPAD, LK = CFG.dim_model, CFG.num_heads, 16, 32
B, MAX_LEN = 2, 14
BF16 = torch.bfloat16


def _jax_params(kind, seed=0):
    return jax.tree_util.tree_map(np.array, jax_init(jax.random.PRNGKey(seed), CFGS[kind]))


def _snap(jp, rng, s=2.0 ** -9):
    """The streamed decoder matrices moved onto the int8 grid: w = q * s,
    integer |q| <= 127 with 127 in row 0 of every column, s a power of two,
    so quantization recovers (q, s) exactly."""
    for lp in jp["dec_tgt"]["layers"]:
        for sub, keys in (("decslf_attn", tdf.QUANT_SELF), ("encdec_attn", tdf.QUANT_CROSS),
                          ("pos_ffn", tdf.QUANT_FFN)):
            for k in keys:
                w = lp[sub][k]["w"]
                q = rng.randint(-127, 128, size=w.shape)
                q[0] = 127
                lp[sub][k] = {**lp[sub][k], "w": (q * s).astype(np.float32)}
    return jp


def _bf16_exact(a):
    """numpy f32 values that bf16 holds exactly (rounded once, here)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float().numpy()


@pytest.mark.parametrize("kind", ["standard", "universal"])
def test_quantize_bytes_match_jax(kind):
    jp = _jax_params(kind)
    jp["dec_tgt"]["layers"][0]["pos_ffn"]["w_1"]["w"][:, 3] = 0.0  # scale 0 -> 1
    jq = jdf.quantize_decoder_weights(jax.tree_util.tree_map(jnp.asarray, jp["dec_tgt"]))
    tdec = params_from_numpy(jp["dec_tgt"])
    tq = tdf.quantize_decoder_weights(tdec)
    for jl, tl, t0 in zip(jq["layers"], tq["layers"], tdec["layers"]):
        for sub, keys in (("decslf_attn", tdf.QUANT_SELF), ("encdec_attn", tdf.QUANT_CROSS),
                          ("pos_ffn", tdf.QUANT_FFN)):
            for k in keys:
                a, b = tl[sub][k], jl[sub][k]
                assert a["w"].dtype == torch.int8 and a["w_s"].dtype == torch.float32
                assert a["w"].numpy().tobytes() == np.asarray(b["w"]).tobytes(), (sub, k)
                assert a["w_s"].numpy().tobytes() == np.asarray(b["w_s"]).tobytes(), (sub, k)
            assert tl[sub]["layer_norm"]["scale"] is t0[sub]["layer_norm"]["scale"]  # shared
        assert "w_s" not in tl["encdec_attn"]["w_ks"]  # the cross K/V stay f32
    assert (tq["layers"][0]["pos_ffn"]["w_1"]["w_s"][0, 3] == 1.0
            and not tq["layers"][0]["pos_ffn"]["w_1"]["w"][:, 3].any())
    w, quant = tdf.layer_weights(tq["layers"][0])
    assert quant and len(w) == len(tdf.CHAIN_KEYS_Q8)
    stacked, quant = tdf.stack_decoder_layers(tq)
    assert quant and stacked[2].dtype == torch.int8


def _layer(seed):
    """One decoder layer (numpy) with random LayerNorms and FFN biases."""
    lp = _jax_params("standard", seed)["dec_tgt"]["layers"][0]
    rng = np.random.RandomState(seed)
    for blk in ("decslf_attn", "encdec_attn", "pos_ffn"):
        lp[blk]["layer_norm"] = {"scale": (1 + 0.1 * rng.randn(D)).astype(np.float32),
                                 "bias": (0.1 * rng.randn(D)).astype(np.float32)}
    for k in ("w_1", "w_2"):
        lp["pos_ffn"][k]["b"] = (0.1 * rng.randn(*lp["pos_ffn"][k]["b"].shape)).astype(np.float32)
    return lp


def _state(K, pos, seed, nl=None, bf16=False):
    """Numpy inputs of a decode step: caches filled below pos (bf16-exact
    values for bf16 caches), a random ancestry with the own slot at pos, one
    masked prefix key, ragged memory K/V [B, LK, D] (projected here once, so
    both sides cast the same values)."""
    rng = np.random.RandomState(seed)
    BK = B * K
    lead = () if nl is None else (nl,)
    ck = np.zeros(lead + (K, B, LPAD, D), np.float32)
    cv = np.zeros_like(ck)
    ck[..., :pos, :] = rng.randn(*lead, K, B, pos, D)
    cv[..., :pos, :] = rng.randn(*lead, K, B, pos, D)
    mk = rng.randn(*lead, B, LK, D).astype(np.float32)
    mv = rng.randn(*lead, B, LK, D).astype(np.float32)
    if bf16:
        ck, cv, mk, mv = map(_bf16_exact, (ck, cv, mk, mv))
    anc = rng.randint(0, K, (LPAD, BK)).astype(np.int32)
    anc[pos] = np.arange(BK) % K
    maskk = (np.arange(LPAD)[:, None] <= pos).repeat(BK, 1).astype(np.int32)
    maskk[1, 0] = 0
    mem_len = np.array([LK, 9])
    mem_mask = (np.arange(LK)[:, None] < mem_len[None, :]).astype(np.int32)  # [LK, B]
    return dict(x=rng.randn(BK, D).astype(np.float32), ck=ck, cv=cv, mk=mk, mv=mv,
                anc=anc, maskk=maskk, mem_mask=mem_mask)


def _torch_state(s, bf16):
    dt = BF16 if bf16 else torch.float32
    return {k: (torch.from_numpy(v.copy()).to(dt) if k in ("ck", "cv", "mk", "mv")
                else torch.from_numpy(v.copy())) for k, v in s.items()}


def _jax_state(s, bf16):
    dt = jnp.bfloat16 if bf16 else jnp.float32
    return {k: (jnp.asarray(v, dt) if k in ("ck", "cv", "mk", "mv") else jnp.asarray(v))
            for k, v in s.items()}


def _cache_close(a, b, bf16):
    """Cache rows: equal within 1e-5 (f32), or within one bf16 step (at
    most 2^-7 of the value) plus 1e-5 (bf16: the f32 rows rounded differ by
    the summation order, which matters near zero)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    tol = 2.0 ** -7 * np.abs(b) + TOL if bf16 else TOL
    assert (np.abs(a - b) <= tol).all(), float(np.abs(a - b).max())


COMBOS = [(True, False), (False, True), (True, True)]  # (int8 weights, bf16 caches)
COMBO_IDS = ["int8", "bf16", "int8+bf16"]


@pytest.mark.parametrize("quant,bf16", COMBOS, ids=COMBO_IDS)
@pytest.mark.parametrize("step", [tdf.decoder_layer_step_plain, tdf.decoder_layer_step_flash])
def test_layer_step_serving_matches_jax_kernel(step, quant, bf16):
    """K5's plain version (and its wrapper's CPU route) against JAX
    decoder_layer_step_flash in interpret mode: B=2, K=2, pos 6."""
    K, pos = 2, 6
    lp = _layer(3)
    s = _state(K, pos, 30, bf16=bf16)
    jl = jax.tree_util.tree_map(jnp.asarray, lp)
    if quant:
        jl = jdf.quantize_decoder_weights({"layers": [jl]})["layers"][0]
    js = _jax_state(s, bf16)
    ry, rck, rcv = jdf.decoder_layer_step_flash(
        jl, js["x"][:, None], js["ck"], js["cv"], js["mk"], js["mv"], jnp.int32(pos),
        NH, js["anc"], K, js["mem_mask"], js["maskk"] != 0)
    tl = params_from_numpy(lp)
    if quant:
        tl = tdf.quantize_decoder_weights({"layers": [tl]})["layers"][0]
    ts = _torch_state(s, bf16)
    y = step(tl, ts["x"], ts["ck"], ts["cv"], ts["mk"], ts["mv"], pos, NH, ts["anc"], K,
             ts["mem_mask"], ts["maskk"])
    assert y.dtype == torch.float32 and ts["ck"].dtype == (BF16 if bf16 else torch.float32)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry)[:, 0],
                               atol=TOL_BF16 if bf16 else TOL, rtol=0)
    _cache_close(ts["ck"].float().numpy(), np.asarray(rck.astype(jnp.float32)), bf16)
    _cache_close(ts["cv"].float().numpy(), np.asarray(rcv.astype(jnp.float32)), bf16)


@pytest.mark.parametrize("quant,bf16", COMBOS, ids=COMBO_IDS)
def test_chain_step_serving_matches_jax_kernel(quant, bf16):
    """K3's plain version against JAX decode_chain_step_flash in interpret
    mode (2 layers, B=2, K=3, pos 5): ids equal, scores within TOL (int8)
    or TOL_BF16 (bf16 caches)."""
    K, pos, topk = 3, 5, 4
    jp = _jax_params("standard", 1)
    s = _state(K, pos, 40, nl=CFG.dec_layers, bf16=bf16)
    jdec = jax.tree_util.tree_map(jnp.asarray, jp["dec_tgt"])
    tdec = params_from_numpy(jp["dec_tgt"])
    if quant:
        jdec, tdec = jdf.quantize_decoder_weights(jdec), tdf.quantize_decoder_weights(tdec)
    jstacked, jquant = jdf.stack_decoder_layers(jdec)
    assert jquant == quant
    js = _jax_state(s, bf16)
    rsc, rids, rck, rcv = jdf.decode_chain_step_flash(
        jstacked, jquant, jdec["norm"], jax.tree_util.tree_map(jnp.asarray, jp["out_tgt"]),
        js["x"][:, None], js["ck"], js["cv"], js["mk"], js["mv"], jnp.int32(pos), NH,
        js["anc"], K, js["mem_mask"], js["maskk"] != 0, topk)
    ts = _torch_state(s, bf16)
    sc, ids = tdf.decode_chain_step_plain(
        tdf.stack_decoder_layers(tdec), tdec["norm"], params_from_numpy(jp["out_tgt"]),
        ts["x"], ts["ck"], ts["cv"], ts["mk"], ts["mv"], pos, NH, ts["anc"], K,
        ts["mem_mask"], ts["maskk"], topk)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    np.testing.assert_allclose(sc.numpy(), np.asarray(rsc), atol=TOL_BF16 if bf16 else TOL,
                               rtol=0)
    _cache_close(ts["ck"].float().numpy(), np.asarray(rck.astype(jnp.float32)), bf16)
    _cache_close(ts["cv"].float().numpy(), np.asarray(rcv.astype(jnp.float32)), bf16)


def _memory(seed):
    rng = np.random.RandomState(seed)
    enc = (0.5 * rng.randn(B, 9, D)).astype(np.float32)
    mem_mask = np.ones((B, 9), bool)
    mem_mask[1, 6:] = False
    return enc, mem_mask


def _port_beam(jp, kind, enc, mm, K, **kw):
    preds, scores = beam_search(params_from_numpy(jp), CFGS[kind], torch.from_numpy(enc),
                                torch.from_numpy(mm), K, 1.0, MAX_LEN, **kw)
    return preds.numpy(), scores.numpy()


def _jax_beam(jp, kind, enc, mm, K, **kw):
    preds, scores = jax_beam_search(jp, CFGS[kind], jnp.asarray(enc), jnp.asarray(mm), K,
                                    1.0, MAX_LEN, **kw)
    return np.asarray(preds), np.asarray(scores)


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("kind", ["standard", "universal"])
def test_int8_beam_on_grid_line_identical(kind, K):
    """Weights on the int8 grid: quantization is lossless, so the int8 beam
    is the f32 beam, the port's and JAX's (dense XLA route)."""
    jp = _snap(_jax_params(kind, 2), np.random.RandomState(11))
    enc, mm = _memory(5)
    p8, s8 = _port_beam(jp, kind, enc, mm, K, weight_dtype="int8")
    pf, sf = _port_beam(jp, kind, enc, mm, K)
    rp, rs = _jax_beam(jp, kind, enc, mm, K, use_flash=False)
    np.testing.assert_array_equal(p8, pf)
    np.testing.assert_array_equal(p8, rp)
    np.testing.assert_allclose(s8, sf, atol=1e-6, rtol=0)
    np.testing.assert_allclose(s8, rs, atol=TOL, rtol=0)


@pytest.mark.parametrize("kind,K", [("standard", 1), ("standard", 3), ("universal", 3)])
def test_int8_beam_random_matches_jax_int8(kind, K):
    """Random weights: the port's int8 beam against JAX's int8 flash beam
    (interpret mode); both dequantize the same int8 bytes."""
    jp = _jax_params(kind, 3)
    enc, mm = _memory(6)
    p8, s8 = _port_beam(jp, kind, enc, mm, K, weight_dtype="int8")
    rp, rs = _jax_beam(jp, kind, enc, mm, K, use_flash=True, weight_dtype="int8")
    np.testing.assert_array_equal(p8, rp)
    np.testing.assert_allclose(s8, rs, atol=TOL, rtol=0)


@pytest.mark.parametrize("kind,K,quant", [("standard", 3, False), ("universal", 3, False),
                                          ("standard", 3, True)])
def test_bf16_beam_matches_jax_bf16(kind, K, quant):
    """bf16 caches (and int8 weights): tokens equal to JAX's flash beam with
    the same options, scores within TOL_BF16_BEAM. A bf16 rounding flip
    could reorder two candidates within ~1e-3 of each other (a tie at that
    margin, which would explain a differing row); these seeds have none."""
    jp = _jax_params(kind, 4)
    enc, mm = _memory(7)
    w = "int8" if quant else None
    pb, sb = _port_beam(jp, kind, enc, mm, K, cache_dtype=BF16, weight_dtype=w)
    rp, rs = _jax_beam(jp, kind, enc, mm, K, use_flash=True, cache_dtype=jnp.bfloat16,
                       weight_dtype=w)
    np.testing.assert_array_equal(pb, rp)
    np.testing.assert_allclose(sb, rs, atol=TOL_BF16_BEAM, rtol=0)


def _feats():
    rng = np.random.RandomState(8)
    return (torch.from_numpy(rng.randn(B, 32, CFG.acous_dim).astype(np.float32)),
            torch.tensor([32, 21]))


def test_asr_weight_dtype_raises_as_jax():
    jp = _jax_params("standard")
    feats, lens = _feats()
    with pytest.raises(ValueError, match="weight_dtype"):
        jax_forward_translate(jp, CFG, "ASR", acous_feats=jnp.asarray(feats.numpy()),
                              acous_lens=jnp.asarray(lens.numpy()), weight_dtype="int8")
    with pytest.raises(ValueError, match="weight_dtype"):
        forward_translate(params_from_numpy(jp), CFG, "ASR", acous_feats=feats,
                          acous_lens=lens, weight_dtype="int8", device="cpu")


@pytest.mark.parametrize("kw", [{"weight_dtype": "int4"}, {"weight_dtype": torch.int8},
                                {"cache_dtype": torch.float16}, {"cache_dtype": "bfloat16"}])
def test_beam_refuses_other_dtypes(kw):
    enc, mm = _memory(5)
    with pytest.raises(ValueError):
        _port_beam(_jax_params("standard"), "standard", enc, mm, 2, **kw)


def test_serving_options_run_on_cpu_without_launches():
    """forward_translate with both options on CPU tensors takes the plain
    routes: tokens of the right shape, no kernel counted."""
    tp = params_from_numpy(_jax_params("standard"))
    feats, lens = _feats()
    names = [(tdf.decode_chain_step_flash, "q8_bf16_launches"),
             (tdf.decode_beam_step_flash, "q8_bf16_launches"),
             (tdf.self_attn_anc, "bf16_launches"), (tdf.cross_attn, "bf16_launches")]
    before = [getattr(f, a) for f, a in names]
    out = forward_translate(tp, CFG, "ST", acous_feats=feats, acous_lens=lens, beam_width=3,
                            max_seq_len=MAX_LEN, device="cpu", cache_dtype=BF16,
                            weight_dtype="int8")
    assert out.shape == (B, MAX_LEN) and out.dtype in (torch.int32, torch.int64)
    assert [getattr(f, a) for f, a in names] == before


def _call_entry(entry, params):
    feats, lens = _feats()
    if entry == "forward_translate":
        return forward_translate(params, CFG, "ST", acous_feats=feats, acous_lens=lens,
                                 max_seq_len=MAX_LEN)
    if entry == "forward_eval":
        ref = torch.full((B, CFG.max_seq_len_tgt), 5)
        return forward_eval(params, CFG, "ST", acous_feats=feats, acous_lens=lens,
                            ref_tgt=ref)
    step = make_train_step(CFG, "ASR_ST", optim.make_optimizer())
    return step(params, None, [], torch.Generator().manual_seed(0), 1e-3)


@pytest.mark.parametrize("entry", ["forward_translate", "forward_eval", "train_step"])
def test_entry_points_default_to_card_and_refuse_cpu_params(entry):
    """Without device=, the entry points run on the card; params on the
    CPU are refused with both devices named, never moved or run there."""
    with pytest.raises(ValueError, match="on cpu but the call runs on cuda"):
        _call_entry(entry, params_from_numpy(_jax_params("standard")))
