"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Small shapes chosen for the edges the flagship run of chip_smoke.py does not
reach: batches that do not fill a tile, fully masked rows, finished beams, a
length penalty other than 1, strided GEMM operands, rows of length 0. Both
sides run on the card in f32 with TF32 off; they differ only in summation
order, hence the tolerances below. Integer outputs (symbols, ids,
back-copies) must be equal: with random weights at these sizes no two
candidates tie. The trainable kernels (K8, K9) are held forward and
backward, stream by stream, and through their autograd.Function against the
same Function on CPU copies; the inference kernels (K1-K5, K7) must refuse
inputs that require grad. The decode head K7 is also held at target
vocabularies of 13 000 and 30 000 words, and with exact ties; the general
beam loop and dev eval (forward_eval) run on the card against CPU copies.
The serving options: gemm_q8 (bit-equal to gemm_f32 on the dequantized
weight, whose values it reproduces), the bf16 attention kernels (the cache
rows they write bit-equal to the plain version's), and K3, K4 and K5 with
int8 weights, bf16 caches and both (TOL_BF16 below).

Every test needs a CUDA card and skips without one. Run them on a GPU host
(the tests' conftest imports JAX, which that host need not have):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from stjep_tpu_torch import kernels
from stjep_tpu_torch.bridge import leaves, params_to
from stjep_tpu_torch.config import BOS, PAD, ModelConfig
from stjep_tpu_torch.infer.beam import beam_search
from stjep_tpu_torch.infer.forward import forward_eval, forward_translate
from stjep_tpu_torch.models.seq2seq import _dec_embedder, init_seq2seq
from stjep_tpu_torch.models.tf_decoder import tf_decoder_init_cache_chain
from stjep_tpu_torch.ops.attention import precompute_keys
from stjep_tpu_torch.ops import decode_flash as tdf
from stjep_tpu_torch.ops.decode_flash import (
    CROSS_BLOCK,
    beam_select,
    beam_select_plain,
    decode_beam_step_flash,
    decode_beam_step_plain,
    decode_chain_step_flash,
    decode_chain_step_plain,
    decode_head,
    decode_head_gather,
    decode_head_gather_plain,
    decode_head_plain,
    decoder_layer_step_flash,
    decoder_layer_step_plain,
    pad_len,
    stack_decoder_layers,
)
from stjep_tpu_torch.ops import las_tf_flash as k9
from stjep_tpu_torch.ops import lstm_pallas_bwd as k8
from stjep_tpu_torch.ops.las_flash import las_greedy_flash, las_greedy_plain
from stjep_tpu_torch.ops.lstm import bilstm_init
from stjep_tpu_torch.ops.lstm_pallas import bilstm_pallas, bilstm_plain
from stjep_tpu_torch.ops.masks import position_signal
from stjep_tpu_torch.ops.transformer import layer_norm

pytestmark = pytest.mark.cuda

TOL_LSTM = 1e-5  # states in (-1, 1) after <= 40 contractive steps
TOL = 1e-4  # log-probs / projections of magnitude <= ~30 through a few layers
# bf16 caches, kernel against plain on the card: both round at the same
# points, but the f32 values they round come from GEMMs summed in other
# orders, so one may land a bf16 step (2^-8 to 2^-7 relative) from the other
TOL_BF16 = 2e-3
BF16 = torch.bfloat16

CFG = ModelConfig(
    enc_vocab_size=50, dec_vocab_size=40, enc_embedding_size=16,
    dec_embedding_size=128, acous_dim=8, acous_hidden_size=64, dim_model=128,
    dim_feedforward=256, num_heads=4, enc_layers=2, dec_layers=2,
    num_unilstm_dec=3, spec_aug=False, dropout=0.0, max_seq_len_src=12,
    max_seq_len_tgt=16, mode="ASR_ST")
B, LK, MAX_LEN = 3, 11, 16


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest tests/test_torch_cuda.py "
                    "-m cuda --noconftest on a GPU host")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.lib()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def params(dev):
    p = init_seq2seq(CFG, torch.Generator().manual_seed(0), "cpu")
    return p, params_to(p, dev)


def _randn(rng, *shape, dev=None):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)


def _close(a, b, tol):
    err = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
    assert err <= tol, err


def _close_rel(a, b, tol=TOL):
    """Within tol of b's largest magnitude (at least 1): gradients and
    backward streams, whose scale grows with the steps summed."""
    _close(a, b, tol * max(1.0, float(b.abs().max())))


@pytest.mark.parametrize("M,K,N,epilogue", [
    (80, 512, 512, ""), (16, 712, 1024, "bias"), (80, 1024, 512, "bias,resid"),
    (80, 512, 1024, "bias,relu"), (3, 7, 9, "bias,relu,resid"),
    (300, 40, 1024, "bias")])
def test_gemm_matches_matmul(dev, M, K, N, epilogue):
    rng = np.random.RandomState(M + K + N)
    a_full = _randn(rng, M, K + 5, dev=dev)
    a = a_full[:, 2:K + 2]  # row-strided view
    w = _randn(rng, K, N, dev=dev)
    bias = _randn(rng, N, dev=dev) if "bias" in epilogue else None
    resid = _randn(rng, M, N, dev=dev) if "resid" in epilogue else None
    out_full = torch.zeros((M, N + 3), device=dev)
    out = kernels.gemm(a, w, bias=bias, residual=resid, relu="relu" in epilogue,
                       out=out_full[:, :N])
    ref = a @ w + (bias if bias is not None else 0)
    if "relu" in epilogue:
        ref = torch.relu(ref)
    if resid is not None:
        ref = ref + resid
    _close(out, ref, TOL)
    assert torch.all(out_full[:, N:] == 0)  # nothing written past the view


def test_layernorm_matches_plain(dev):
    rng = np.random.RandomState(0)
    x, g, b = _randn(rng, 7, 130, dev=dev), _randn(rng, 130, dev=dev), _randn(rng, 130, dev=dev)
    for eps in (1e-6, 1e-5):
        _close(kernels.layernorm(x, g, b, eps),
               layer_norm({"scale": g, "bias": b}, x, eps), 1e-5)


def test_wrappers_reject_bad_cuda_input(dev):
    w = torch.zeros((4, 4), device=dev)
    with pytest.raises(ValueError):
        kernels.gemm(torch.zeros((2, 4), device=dev, dtype=torch.float64), w)
    with pytest.raises(ValueError):
        kernels.gemm(torch.zeros((2, 4), device=dev), w.t())  # not contiguous


@pytest.mark.parametrize("Bn,T,Din,H", [(3, 21, 8, 64), (9, 40, 24, 256)])
def test_bilstm_kernel_matches_plain(dev, Bn, T, Din, H):
    rng = np.random.RandomState(T)
    p = bilstm_init(torch.Generator().manual_seed(T), Din, H, dev)
    x = _randn(rng, Bn, T, Din, dev=dev)
    lens = torch.from_numpy(rng.randint(1, T + 1, size=(Bn,))).to(dev)
    lens[0] = T
    lens[-1] = 1
    before = bilstm_pallas.launches
    out = bilstm_pallas(p["fwd"], p["bwd"], x, lens)
    assert bilstm_pallas.launches == before + 1
    _close(out, bilstm_plain(p["fwd"], p["bwd"], x, lens), TOL_LSTM)
    valid = torch.arange(T, device=dev)[None, :] < lens[:, None]
    assert torch.all(out[~valid] == 0)


def test_las_greedy_kernel_matches_plain(dev, params):
    _, pg = params
    dec = pg["las"]["decoder"]
    rng = np.random.RandomState(3)
    Tk = 9
    acous = _randn(rng, 5, Tk, 2 * CFG.acous_hidden_size, dev=dev)
    wk = precompute_keys(dec["acous_att"], acous, "bilinear")["wk"]
    lens_k = torch.tensor([9, 1, 4, 9, 6], device=dev)
    sym0 = torch.full((5,), BOS, device=dev)
    n = CFG.max_seq_len_src - 1
    refs = torch.from_numpy(rng.randint(0, CFG.enc_vocab_size, (5, n))).to(dev)
    args = (dec, CFG, wk, acous, lens_k, sym0, n)
    embs, preds, picked = las_greedy_flash(*args, ref_tokens=refs)
    embs_p, preds_p, picked_p = las_greedy_plain(*args, ref_tokens=refs)
    assert torch.equal(preds, preds_p)
    _close(embs, embs_p, TOL)
    _close(picked, picked_p, TOL)


def _decode_state(pg, K, pos, rng, dev, Bn=B):
    """Caches filled below pos, a random ancestry and prefix, row 1's self
    mask all zero and batch entry 2's memory fully masked (both must give
    uniform attention, not NaN)."""
    BK = Bn * K
    enc = _randn(rng, Bn, LK, CFG.dim_model, dev=dev)
    cache = tf_decoder_init_cache_chain(pg["dec_tgt"], CFG, enc, MAX_LEN, K)
    Lpad = cache.self_k.shape[3]
    cache.self_k[:, :, :, :pos] = _randn(rng, *cache.self_k[:, :, :, :pos].shape, dev=dev)
    cache.self_v[:, :, :, :pos] = _randn(rng, *cache.self_v[:, :, :, :pos].shape, dev=dev)
    preds = torch.full((BK, Lpad), PAD, dtype=torch.int32)
    preds[:, 0] = BOS
    preds[:, 1:pos + 1] = torch.from_numpy(rng.randint(4, CFG.dec_vocab_size, (BK, pos)))
    anc = torch.from_numpy(rng.randint(0, K, (Lpad, BK))).int()
    anc[pos] = torch.arange(BK, dtype=torch.int32) % K
    maskk = (preds != PAD).T.int().contiguous()
    maskk[:, 1:2] = 0
    mem_mask = torch.zeros((pad_len(LK, CROSS_BLOCK), Bn), dtype=torch.int32)
    mem_mask[:LK, 0] = 1
    mem_mask[:5, 1:2] = 1
    return cache, preds.to(dev), anc.to(dev), maskk.to(dev), mem_mask.to(dev)


def _clone(cache):
    return type(cache)(*(t.clone() for t in cache))


@pytest.mark.parametrize("K,pos", [(1, 0), (3, 0), (3, 6), (2, 9)])
def test_chain_step_kernel_matches_plain(dev, params, K, pos):
    _, pg = params
    rng = np.random.RandomState(10 * K + pos)
    cache, _, anc, maskk, mem_mask = _decode_state(pg, K, pos, rng, dev)
    maskk[pos] = 1
    maskk[:, 1] = 0
    x = _randn(rng, B * K, CFG.dim_model, dev=dev)
    stacked = stack_decoder_layers(pg["dec_tgt"])
    outs = []
    for fn, c in ((decode_chain_step_flash, _clone(cache)),
                  (decode_chain_step_plain, _clone(cache))):
        sc, ids = fn(stacked, pg["dec_tgt"]["norm"], pg["out_tgt"], x, c.self_k,
                     c.self_v, c.mem_k, c.mem_v, pos, CFG.num_heads, anc, K,
                     mem_mask, maskk, K + 1)
        outs.append((sc, ids, c))
    (sc, ids, ck), (sc_p, ids_p, cp) = outs
    assert torch.isfinite(sc).all()
    assert torch.equal(ids, ids_p)
    _close(sc, sc_p, TOL)
    _close(ck.self_k, cp.self_k, TOL)
    _close(ck.self_v, cp.self_v, TOL)


@pytest.mark.parametrize("Bn,K,pos", [(1, 1, 0), (3, 1, 0), (3, 3, 6), (2, 2, MAX_LEN - 1)])
def test_layer_step_kernel_matches_plain(dev, params, Bn, K, pos):
    """K5 on layer 1's caches: the output and every cache row (the new one
    at pos, the rest untouched)."""
    _, pg = params
    rng = np.random.RandomState(1000 + 10 * K + pos)
    cache, _, anc, maskk, mem_mask = _decode_state(pg, K, pos, rng, dev, Bn=Bn)
    maskk[pos] = 1
    x = _randn(rng, Bn * K, CFG.dim_model, dev=dev)
    lp = pg["dec_tgt"]["layers"][1]
    before = decoder_layer_step_flash.launches
    outs = []
    for fn in (decoder_layer_step_flash, decoder_layer_step_plain):
        c = _clone(cache)
        y = fn(lp, x, c.self_k[1], c.self_v[1], c.mem_k[1], c.mem_v[1], pos,
               CFG.num_heads, anc, K, mem_mask, maskk)
        outs.append((y, c))
    assert decoder_layer_step_flash.launches == before + 1
    (y, ck), (y_p, cp) = outs
    assert torch.isfinite(y).all()
    _close(y, y_p, TOL)
    _close(ck.self_k, cp.self_k, TOL)
    _close(ck.self_v, cp.self_v, TOL)
    assert torch.equal(ck.self_k[0], cache.self_k[0])  # other layers untouched


def _head_params(rng, V, dev, ties=False):
    D = CFG.dim_model
    norm = {"scale": 1 + 0.1 * _randn(rng, D, dev=dev), "bias": 0.1 * _randn(rng, D, dev=dev)}
    w = _randn(rng, D, V, dev=dev) / D ** 0.5
    if ties:
        # two live LayerNorm features, so each logit is the same sum in any
        # summation order, and every column repeated 8 ids later: exact ties
        # that must resolve to the lowest copy
        norm["scale"] = torch.zeros(D, device=dev)
        norm["scale"][[5, 77]] = torch.tensor([1.3, -0.8], device=dev)
        norm["bias"] = torch.zeros(D, device=dev)
        w = w[:, torch.arange(V, device=dev) % 8].contiguous()
    return norm, {"w": w}


def _same_ids_up_to_ties(ids, ids_p, sc_p):
    """ids equal wherever the plain arm's top-K gap at that rank (to the next
    rank) exceeds 1e-5; returns the number of tied rows."""
    gaps = torch.cat([sc_p[:, :-1] - sc_p[:, 1:],
                      torch.full_like(sc_p[:, :1], float("inf"))], 1)
    bad = (ids != ids_p) & (gaps > 1e-5)
    assert not bad.any(), (ids[bad.any(1)], ids_p[bad.any(1)])
    return int((ids != ids_p).any(1).sum())


@pytest.mark.parametrize("BK,V,topk,ties", [
    (1, 1, 1, False), (5, 40, 3, False), (80, 200, 5, False), (7, 200, 16, False),
    (16, 13000, 5, False), (80, 30000, 5, False), (6, 40, 4, True),
    (6, 3000, 4, True), (6, 13000, 4, True)])
def test_head_kernels_match_plain(dev, BK, V, topk, ties):
    """K7 (decode_head) and its gather variant, head_topk without a bound
    on V; gather ids include 0 and V-1. The tie cases at V > the block's
    thread count put equal columns in one thread's scan as well as across
    threads."""
    rng = np.random.RandomState(BK + V + topk)
    norm, out = _head_params(rng, V, dev, ties)
    x = _randn(rng, BK, CFG.dim_model, dev=dev)
    gid = torch.from_numpy(rng.randint(0, V, BK).astype(np.int32)).to(dev)
    gid[0], gid[-1] = V - 1, 0
    before = (decode_head.launches, decode_head_gather.launches)
    sc, ids = decode_head(norm, out, x, topk)
    sc_g, ids_g, glp = decode_head_gather(norm, out, x, topk, gid)
    assert (decode_head.launches, decode_head_gather.launches) == (before[0] + 1, before[1] + 1)
    sc_p, ids_p = decode_head_plain(norm, out, x, topk)
    _, _, glp_p = decode_head_gather_plain(norm, out, x, topk, gid)
    assert ids.dtype == ids_g.dtype == torch.int32 and ids.shape == (BK, topk)
    assert torch.equal(ids, ids_g) and torch.equal(sc, sc_g)
    _same_ids_up_to_ties(ids, ids_p, sc_p)
    _close(sc, sc_p, 1e-5)
    _close(glp, glp_p, 1e-5)
    if ties:
        assert torch.equal(ids, ids_p)
        assert (ids[:, 1:] - ids[:, :-1] == 8).all()


@pytest.mark.parametrize("K,pos", [(1, 0), (1, 9)])
def test_chain_step_gather_matches_plain(dev, params, K, pos):
    """K3's gather variant: the greedy dev-eval step."""
    _, pg = params
    rng = np.random.RandomState(50 + pos)
    cache, _, anc, maskk, mem_mask = _decode_state(pg, K, pos, rng, dev)
    maskk[pos] = 1
    x = _randn(rng, B * K, CFG.dim_model, dev=dev)
    gid = torch.from_numpy(rng.randint(0, CFG.dec_vocab_size, B * K).astype(np.int32)).to(dev)
    stacked = stack_decoder_layers(pg["dec_tgt"])
    before = (decode_chain_step_flash.launches, decode_chain_step_flash.gather_launches)
    outs = []
    for fn in (decode_chain_step_flash, decode_chain_step_plain):
        c = _clone(cache)
        outs.append(fn(stacked, pg["dec_tgt"]["norm"], pg["out_tgt"], x, c.self_k,
                       c.self_v, c.mem_k, c.mem_v, pos, CFG.num_heads, anc, K,
                       mem_mask, maskk, 2, gather_ids=gid) + (c,))
    assert (decode_chain_step_flash.launches,
            decode_chain_step_flash.gather_launches) == (before[0], before[1] + 1)
    (sc, ids, glp, ck), (sc_p, ids_p, glp_p, cp) = outs
    assert torch.equal(ids, ids_p)
    _close(sc, sc_p, TOL)
    _close(glp, glp_p, TOL)
    _close(ck.self_k, cp.self_k, TOL)


@pytest.mark.parametrize("K,i,pf", [(1, 5, 1.0), (3, 7, 1.0), (3, 7, 0.7), (2, 12, 1.3)])
def test_beam_step_kernel_matches_plain(dev, params, K, i, pf):
    _, pg = params
    rng = np.random.RandomState(100 * K + i)
    BK = B * K
    cache, preds, anc, maskk, mem_mask = _decode_state(pg, K, i - 1, rng, dev)
    eos = torch.from_numpy((rng.rand(BK) < 0.3).astype(np.int32)).to(dev)
    scores = torch.from_numpy(-rng.uniform(0, 3 * i, BK).astype(np.float32)).to(dev)
    lenm = torch.from_numpy(rng.randint(1, i, BK).astype(np.float32)).to(dev)
    last_tok = preds[:, i - 1].contiguous()
    stacked = stack_decoder_layers(pg["dec_tgt"])
    table = _dec_embedder(pg, CFG).contiguous()
    tsig = position_signal(500, CFG.dim_model, dev)[0].contiguous()
    outs = []
    for fn in (decode_beam_step_flash, decode_beam_step_plain):
        c, a = _clone(cache), anc.clone()
        out = fn(stacked, pg["dec_tgt"]["norm"], pg["out_tgt"], table, tsig, i,
                 last_tok, preds, a, maskk, mem_mask, scores, eos, lenm,
                 c.self_k, c.self_v, c.mem_k, c.mem_v, CFG.num_heads, K, pf)
        outs.append((out, c, a))
    (out_k, ck, ak), (out_p, cp, ap) = outs
    names = ("preds", "anc", "maskk", "last_tok", "scores", "eos", "lenm", "flag")
    for nm, a, b in zip(names, out_k, out_p):
        if nm in ("scores", "lenm"):
            _close(a, b, TOL)
        else:
            assert torch.equal(a.int(), b.int()), nm
    assert torch.equal(ak, ap)  # anc[i-1] set in place to each row's own slot
    _close(ck.self_k, cp.self_k, TOL)
    _close(ck.self_v, cp.self_v, TOL)


@pytest.mark.parametrize("K,i,pf,eos_share", [
    (1, 5, 1.0, 0.3), (3, 7, 0.7, 0.3), (4, 2, 1.0, 1.0), (16, 9, 1.3, 0.3)])
def test_beam_select_kernel_matches_plain(dev, params, K, i, pf, eos_share):
    """The general loop's select alone (K4's select kernel), up to
    K = MAX_BEAM and with every row finished (the all-EOS flag set)."""
    _, pg = params
    rng = np.random.RandomState(300 + K + i)
    BK = B * K
    _, preds, anc, maskk, _ = _decode_state(pg, K, i - 1, rng, dev)
    sc = torch.from_numpy(-np.sort(rng.uniform(0, 8, (BK, K)), 1)
                          .astype(np.float32)).to(dev)
    ids = torch.from_numpy(np.stack([rng.permutation(CFG.dec_vocab_size)[:K]
                                     for _ in range(BK)]).astype(np.int32)).to(dev)
    eos = torch.from_numpy((rng.rand(BK) < eos_share).astype(np.int32)).to(dev)
    scores = torch.from_numpy(-rng.uniform(0, 3 * i, BK).astype(np.float32)).to(dev)
    lenm = torch.from_numpy(rng.randint(1, i + 1, BK).astype(np.float32)).to(dev)
    args = (sc, ids, scores, eos, lenm, preds, anc, maskk, i, K, pf)
    before = beam_select.launches
    out_k = beam_select(*args)
    assert beam_select.launches == before + 1
    out_p = beam_select_plain(*args)
    names = ("preds", "anc", "maskk", "last_tok", "scores", "eos", "lenm", "flag")
    for nm, a, b in zip(names, out_k, out_p):
        if nm in ("scores", "lenm"):
            _close(a, b, TOL)
        else:
            assert torch.equal(a.int(), b.int()), nm
    assert int(out_k[7]) == int(eos_share == 1.0)


@pytest.mark.parametrize("K", [1, 2, 3, 5])
def test_beam_search_card_matches_cpu(dev, params, K):
    pc, pg = params
    rng = np.random.RandomState(K)
    enc = _randn(rng, B, LK, CFG.dim_model)
    mem_mask = torch.arange(LK)[None, :] < torch.tensor([11, 6, 9])[:, None]
    preds_c, scores_c = beam_search(pc, CFG, enc, mem_mask, K, 1.0, MAX_LEN)
    preds_g, scores_g = beam_search(pg, CFG, enc.to(dev), mem_mask.to(dev), K,
                                    1.0, MAX_LEN)
    assert torch.equal(preds_g.cpu(), preds_c)
    _close(scores_g.cpu(), scores_c, TOL)


def test_forward_translate_card_matches_cpu(dev, params):
    pc, pg = params
    rng = np.random.RandomState(7)
    feats = _randn(rng, B, 64, CFG.acous_dim)
    lens = torch.tensor([64, 29, 47])
    wrappers = (bilstm_pallas, las_greedy_flash, decode_chain_step_flash,
                decode_beam_step_flash)
    before = [w.launches for w in wrappers]
    out_g = forward_translate(pg, CFG, "ST", acous_feats=feats, acous_lens=lens,
                              beam_width=3, max_seq_len=MAX_LEN, device=dev)
    assert all(w.launches > n for w, n in zip(wrappers, before))
    out_c = forward_translate(pc, CFG, "ST", acous_feats=feats, acous_lens=lens,
                              beam_width=3, max_seq_len=MAX_LEN, device="cpu")
    assert torch.equal(out_g.cpu(), out_c)
    assert out_c.shape == (B, MAX_LEN) and (out_c[:, 0] == BOS).all()


UNIVERSAL = dataclasses.replace(CFG, transformer_type="universal")
GENERAL_CFGS = {"universal": UNIVERSAL,
                "dec_emb_proj": dataclasses.replace(CFG, dec_emb_proj=True)}


@pytest.mark.parametrize("kind,K", [("universal", 1), ("universal", 3),
                                    ("universal", 5), ("dec_emb_proj", 2)])
def test_general_beam_card_matches_cpu(dev, kind, K):
    """The general beam loop: K5 per hop + K7 (universal), or K3 (standard
    with dec_emb_proj), then K4's select kernel; never the megastep."""
    cfg = GENERAL_CFGS[kind]
    pc = init_seq2seq(cfg, torch.Generator().manual_seed(K), "cpu")
    pg = params_to(pc, dev)
    rng = np.random.RandomState(20 + K)
    enc = _randn(rng, B, LK, CFG.dim_model)
    mem_mask = torch.arange(LK)[None, :] < torch.tensor([11, 6, 9])[:, None]
    wrappers = (decoder_layer_step_flash, decode_head, decode_chain_step_flash,
                beam_select, decode_beam_step_flash)
    before = [w.launches for w in wrappers]
    preds_g, scores_g = beam_search(pg, cfg, enc.to(dev), mem_mask.to(dev), K,
                                    1.0, MAX_LEN)
    ran = [w.launches > n for w, n in zip(wrappers, before)]
    assert ran == ([True, True, False, True, False] if kind == "universal"
                   else [False, False, True, True, False])
    preds_c, scores_c = beam_search(pc, cfg, enc, mem_mask, K, 1.0, MAX_LEN)
    assert torch.equal(preds_g.cpu(), preds_c)
    _close(scores_g.cpu(), scores_c, TOL)


@pytest.mark.parametrize("kind", ["standard", "universal"])
def test_forward_eval_card_matches_cpu(dev, kind):
    """Dev eval (ASR_ST with refs): K1, K2 with refs, then K3's gather
    variant (standard) or K5 per hop + K7's gather variant (universal)."""
    cfg = CFG if kind == "standard" else UNIVERSAL
    pc = init_seq2seq(cfg, torch.Generator().manual_seed(5), "cpu")
    pg = params_to(pc, dev)
    rng = np.random.RandomState(9)
    kw = dict(acous_feats=_randn(rng, B, 64, CFG.acous_dim),
              acous_lens=torch.tensor([64, 29, 47]),
              ref_src=torch.from_numpy(rng.randint(4, CFG.enc_vocab_size, (B, CFG.max_seq_len_src))),
              ref_tgt=torch.from_numpy(rng.randint(4, CFG.dec_vocab_size, (B, 9))))
    kw["ref_src"][:, 0] = kw["ref_tgt"][:, 0] = BOS
    counts = lambda: (decode_chain_step_flash.gather_launches,
                      decoder_layer_step_flash.launches, decode_head_gather.launches,
                      las_greedy_flash.launches)
    before = counts()
    out_g = forward_eval(pg, cfg, "ASR_ST", device=dev, **kw)
    ran = [a > b for a, b in zip(counts(), before)]
    assert ran == ([True, False, False, True] if kind == "standard"
                   else [False, True, True, True])
    out_c = forward_eval(pc, cfg, "ASR_ST", device="cpu", **kw)
    assert set(out_g) == set(out_c)
    for k, v in out_c.items():
        if k.startswith(("preds", "lengths")):
            assert torch.equal(out_g[k].cpu(), v), k
        else:
            _close(out_g[k].cpu(), v, TOL)
    assert out_c["picked_st"].shape == (B, 8)


def _grad_leaves(tree, dev):
    """A copy of the tree on dev whose leaves require grad."""
    if isinstance(tree, dict):
        return {k: _grad_leaves(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grad_leaves(v, dev) for v in tree]
    return tree.detach().to(dev).clone().requires_grad_(True)


@pytest.mark.parametrize("Bn,T,Din,H", [(3, 21, 8, 64), (9, 40, 24, 256)])
def test_bilstm_trainable_kernels_match_plain(dev, Bn, T, Din, H):
    """K8 forward streams, backward stream and the Function's gradients; one
    row of length 0, one of length T, batches that do not fill the 8-row
    tile."""
    rng = np.random.RandomState(T + 1)
    p = bilstm_init(torch.Generator().manual_seed(T), Din, H, "cpu")
    x = _randn(rng, Bn, T, Din)
    lens = torch.from_numpy(rng.randint(1, T + 1, size=(Bn,)))
    lens[0], lens[-1] = T, 0
    g_out = _randn(rng, Bn, T, 2 * H)
    w = lambda d, k: p[("fwd", "bwd")[d]][k].to(dev)
    args = ((w(0, "w_ih"), w(1, "w_ih")), (w(0, "w_hh"), w(1, "w_hh")),
            (w(0, "b_ih") + w(0, "b_hh"), w(1, "b_ih") + w(1, "b_hh")),
            x.to(dev), lens.to(dev))
    before = (k8.bilstm_fwd_save.launches, k8.bilstm_bwd.launches)
    fwd_k, fwd_p = k8.bilstm_fwd_save(*args), k8.bilstm_fwd_save_plain(*args)
    for a, b in zip(fwd_k, fwd_p):
        _close(a, b, TOL_LSTM)
    bargs = (g_out.to(dev), fwd_p[2], fwd_p[3], args[1], args[4])
    _close_rel(k8.bilstm_bwd(*bargs), k8.bilstm_bwd_plain(*bargs))
    assert (k8.bilstm_fwd_save.launches, k8.bilstm_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    grads = []
    for d in ("cpu", dev):
        q = _grad_leaves(p, d)
        xd = _grad_leaves(x, d)
        out = k8.bilstm_pallas_trainable(q["fwd"], q["bwd"], xd, lens.to(d))
        out.backward(g_out.to(d))
        grads.append([xd.grad] + [t.grad for t in leaves(q)])
    for a, b in zip(*grads):  # card against the CPU route
        _close_rel(b.cpu(), a)


@pytest.mark.parametrize("use_masks", [False, True])
def test_las_tf_kernels_match_plain(dev, params, use_masks):
    """K9 forward streams, backward streams and the Function's gradients,
    with a fully masked row (lens_k 0) and an odd batch."""
    pc, _ = params
    dec = pc["las"]["decoder"]
    rng = np.random.RandomState(11 + use_masks)
    S, Bn, Tk = 6, 5, 9
    Hd, Ha2 = CFG.dim_model, 2 * CFG.acous_hidden_size
    E = CFG.enc_embedding_size
    pre0 = _randn(rng, S, Bn, 4 * Hd)
    acous = _randn(rng, Bn, Tk, Ha2)
    lens_k = torch.tensor([9, 1, 4, 0, 6])
    g_cell = _randn(rng, S, Bn, Hd)
    masks = None
    if use_masks:
        masks = (torch.from_numpy((rng.rand(S, 3, Bn, Hd) < 0.8).astype(np.float32) / 0.8),
                 torch.from_numpy((rng.rand(S, Bn, 1, Ha2) < 0.8).astype(np.float32) / 0.8))
    stack = {k: dec[k] for k in ("dec_l0", "dec_l1", "dec_l2")}
    att_w, ffn_w = dec["acous_att"]["linear_att_w"]["w"], dec["acous_ffn"]["w"]

    w = k9.scan_weights(*(t.to(dev) for t in (
        stack["dec_l0"]["w_ih"], stack["dec_l0"]["w_hh"], stack["dec_l1"]["w_ih"],
        stack["dec_l1"]["w_hh"], stack["dec_l1"]["b_ih"], stack["dec_l1"]["b_hh"],
        stack["dec_l2"]["w_ih"], stack["dec_l2"]["w_hh"], stack["dec_l2"]["b_ih"],
        stack["dec_l2"]["b_hh"], ffn_w)))
    m = None if masks is None else k9.Masks(masks[0].to(dev).contiguous(),
                                            masks[1][:, :, 0].to(dev).contiguous())
    ac = acous.to(dev)
    wk = (ac @ att_w.to(dev)).contiguous()
    fargs = (w, pre0.to(dev), wk, ac, lens_k.to(dev), m)
    before = (k9.las_tf_fwd.launches, k9.las_tf_bwd.launches)
    st_k, st_p = k9.las_tf_fwd(*fargs), k9.las_tf_fwd_plain(*fargs)
    for a, b in zip(st_k, st_p):
        _close(a, b, TOL)
    bargs = (w, st_p, g_cell.to(dev), wk, ac, m)
    for a, b in zip(k9.las_tf_bwd(*bargs), k9.las_tf_bwd_plain(*bargs)):
        _close_rel(a, b)
    assert (k9.las_tf_fwd.launches, k9.las_tf_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    grads = []
    for d in ("cpu", dev):
        st = _grad_leaves(stack, d)
        aw, fw = _grad_leaves([att_w, ffn_w], d)
        p0, ad = _grad_leaves([pre0, acous], d)
        md = None if masks is None else tuple(t.to(d) for t in masks)
        out = k9.las_tf_scan(st, aw, fw, p0, ad, lens_k.to(d), md)
        out.backward(g_cell.to(d))
        grads.append([p0.grad, ad.grad, aw.grad, fw.grad]
                     + [t.grad for t in leaves(st) if t.grad is not None])
    for a, b in zip(*grads):  # card against the CPU route
        _close_rel(b.cpu(), a)


def _k1_call(pg, dev):
    enc = pg["las"]["encoder"]["acous_enc_l1"]
    x = torch.zeros((2, 16, CFG.acous_dim), device=dev)
    return lambda: bilstm_pallas(enc["fwd"], enc["bwd"], x, torch.tensor([16, 9], device=dev))


def _k2_call(pg, dev):
    dec = pg["las"]["decoder"]
    acous = torch.zeros((2, 4, 2 * CFG.acous_hidden_size), device=dev)
    wk = precompute_keys(dec["acous_att"], acous, "bilinear")["wk"]
    return lambda: las_greedy_flash(dec, CFG, wk.detach(), acous,
                                    torch.tensor([4, 2], device=dev),
                                    torch.full((2,), BOS, device=dev), 3)


def _k3_call(pg, dev, gather=False):
    rng = np.random.RandomState(0)
    cache, _, anc, maskk, mem_mask = _decode_state(pg, 1, 0, rng, dev)
    maskk[0] = 1
    stacked = stack_decoder_layers(pg["dec_tgt"])
    x = _randn(rng, B, CFG.dim_model, dev=dev)
    gid = torch.zeros(B, device=dev, dtype=torch.int32) if gather else None
    return lambda: decode_chain_step_flash(
        stacked, pg["dec_tgt"]["norm"], pg["out_tgt"], x, cache.self_k,
        cache.self_v, cache.mem_k, cache.mem_v, 0, CFG.num_heads, anc, 1,
        mem_mask, maskk, 1, gather_ids=gid)


def _k4_call(pg, dev):
    rng = np.random.RandomState(1)
    K, i = 2, 3
    cache, preds, anc, maskk, mem_mask = _decode_state(pg, K, i - 1, rng, dev)
    BK = B * K
    z = lambda dt: torch.zeros(BK, device=dev, dtype=dt)
    stacked = stack_decoder_layers(pg["dec_tgt"])
    return lambda: decode_beam_step_flash(
        stacked, pg["dec_tgt"]["norm"], pg["out_tgt"],
        _dec_embedder(pg, CFG).contiguous(),
        position_signal(500, CFG.dim_model, dev)[0].contiguous(), i,
        preds[:, i - 1].contiguous(), preds, anc, maskk, mem_mask,
        z(torch.float32), z(torch.int32), z(torch.float32) + 1, cache.self_k,
        cache.self_v, cache.mem_k, cache.mem_v, CFG.num_heads, K, 1.0)


def _k5_call(pg, dev):
    rng = np.random.RandomState(2)
    cache, _, anc, maskk, mem_mask = _decode_state(pg, 1, 0, rng, dev)
    maskk[0] = 1
    x = _randn(rng, B, CFG.dim_model, dev=dev)
    return lambda: decoder_layer_step_flash(
        pg["dec_tgt"]["layers"][0], x, cache.self_k[0], cache.self_v[0],
        cache.mem_k[0], cache.mem_v[0], 0, CFG.num_heads, anc, 1, mem_mask, maskk)


def _k7_call(pg, dev, gather=False):
    x = _randn(np.random.RandomState(3), B, CFG.dim_model, dev=dev)
    if gather:
        gid = torch.zeros(B, device=dev, dtype=torch.int32)
        return lambda: decode_head_gather(pg["dec_tgt"]["norm"], pg["out_tgt"], x, 2, gid)
    return lambda: decode_head(pg["dec_tgt"]["norm"], pg["out_tgt"], x, 2)


def _select_call(pg, dev):
    rng = np.random.RandomState(4)
    K, i = 2, 3
    _, preds, anc, maskk, _ = _decode_state(pg, K, i - 1, rng, dev)
    BK = B * K
    z = lambda dt: torch.zeros(BK, device=dev, dtype=dt)
    ids = torch.arange(BK * K, device=dev, dtype=torch.int32).view(BK, K) % CFG.dec_vocab_size
    # head scores that carry the output weight's autograd history
    return lambda: beam_select((-pg["out_tgt"]["w"][:BK, :K].abs()).contiguous(), ids,
                               z(torch.float32), z(torch.int32), z(torch.float32) + 1,
                               preds, anc, maskk, i, K, 1.0)


@pytest.mark.parametrize("make_call", [
    _k1_call, _k2_call, _k3_call, lambda pg, dev: _k3_call(pg, dev, gather=True),
    _k4_call, _select_call, _k5_call, _k7_call,
    lambda pg, dev: _k7_call(pg, dev, gather=True)],
    ids=["K1", "K2", "K3", "K3_gather", "K4", "K4_select", "K5", "K7", "K7_gather"])
def test_inference_kernels_refuse_autograd(dev, make_call):
    """With a weight that requires grad, the CUDA route raises instead of
    returning outputs without a grad_fn; under no_grad it runs."""
    p = init_seq2seq(CFG, torch.Generator().manual_seed(0), "cpu")
    pg = params_to(p, dev)
    call = make_call(pg, dev)
    with torch.no_grad():
        call()
    for t in leaves(pg):
        t.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        call()


# ---------------------------------------------------------------------------
# the serving options: int8 weights (gemm_q8) and bf16 caches
# ---------------------------------------------------------------------------


def _q8(rng, K, N, dev, zero_col=None):
    """A random int8 weight [K, N] with per-column f32 scales [1, N]."""
    q = torch.from_numpy(rng.randint(-127, 128, (K, N)).astype(np.int8)).to(dev)
    s = torch.from_numpy((rng.uniform(0.5, 2.0, (1, N)) / 127).astype(np.float32)).to(dev)
    if zero_col is not None:
        q[:, zero_col] = 0
        s[0, zero_col] = 1.0
    return q, s


@pytest.mark.parametrize("M,K,N,epilogue", [
    (1, 512, 512, ""), (5, 512, 1024, "bias,relu"), (80, 1024, 512, "bias,resid"),
    (80, 512, 512, "resid"), (320, 700, 333, "bias"), (5, 37, 9, "bias,relu,resid")])
def test_gemm_q8_matches_plain(dev, M, K, N, epilogue):
    """gemm_q8 at decode rows (1, 5, 80) and beyond, K and N off the
    tile, a zero column: within TOL of the plain product on the
    dequantized weight, and bit-equal to gemm_f32 on that weight (the same
    tiles and order, the same dequantized values)."""
    rng = np.random.RandomState(M + K + N)
    a = _randn(rng, M, K + 3, dev=dev)[:, 1:K + 1]  # row-strided view
    q, sc = _q8(rng, K, N, dev, zero_col=N // 2)
    bias = _randn(rng, N, dev=dev) if "bias" in epilogue else None
    resid = _randn(rng, M, N, dev=dev) if "resid" in epilogue else None
    kw = dict(bias=bias, residual=resid, relu="relu" in epilogue)
    before = (kernels.gemm.launches, kernels.gemm.q8_launches)
    out = kernels.gemm(a, q, w_scale=sc, **kw)
    assert (kernels.gemm.launches, kernels.gemm.q8_launches) == (before[0], before[1] + 1)
    w = q.float() * sc
    assert torch.equal(out, kernels.gemm(a, w, **kw))
    ref = a @ w + (bias if bias is not None else 0)
    if "relu" in epilogue:
        ref = torch.relu(ref)
    if resid is not None:
        ref = ref + resid
    _close(out, ref, TOL * max(1.0, float(ref.abs().max()) / 30))
    with pytest.raises(ValueError):
        kernels.gemm(a, q, **kw)  # int8 without its scales
    with pytest.raises(ValueError):
        kernels.gemm(a, q.float(), w_scale=sc, **kw)  # scales on an f32 weight


def _attn_state(rng, dev, dtype, K=3, Bn=3, Lpad=160, D=CFG.dim_model):
    BK = Bn * K
    ck = _randn(rng, K, Bn, Lpad, D, dev=dev).to(dtype)
    cv = _randn(rng, K, Bn, Lpad, D, dev=dev).to(dtype)
    anc = torch.from_numpy(rng.randint(0, K, (Lpad, BK)).astype(np.int32)).to(dev)
    maskk = torch.from_numpy((rng.rand(Lpad, BK) < 0.8).astype(np.int32)).to(dev)
    maskk[:, 1] = 0  # a fully masked self row: uniform attention, not NaN
    mk = _randn(rng, Bn, 96, D, dev=dev).to(dtype)
    mv = _randn(rng, Bn, 96, D, dev=dev).to(dtype)
    mem_mask = torch.zeros((96, Bn), dtype=torch.int32, device=dev)
    mem_mask[:89, 0] = 1
    mem_mask[:7, 2] = 1  # batch entry 1 fully masked
    return ck, cv, anc, maskk, mk, mv, mem_mask, K


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pos", [0, 15, 16, 159])
def test_attn_kernels_match_plain(dev, pos, dtype):
    """self_attn_anc and cross_attn alone, f32 and bf16: at pos 0, the
    last row of a 16-row block, the first of the next and the last of 160;
    a fully masked self row and a fully masked memory entry. The new K/V
    row is bit-equal to the plain version's (both round the same f32 row)."""
    rng = np.random.RandomState(pos + 7)
    ck, cv, anc, maskk, mk, mv, mem_mask, K = _attn_state(rng, dev, dtype)
    BK, D = anc.shape[1], CFG.dim_model
    anc[pos] = torch.arange(BK, device=dev, dtype=torch.int32) % K
    q, kn, vn = (_randn(rng, BK, D, dev=dev) for _ in range(3))
    var = "bf16_" if dtype == BF16 else ""
    counts = lambda: (getattr(tdf.self_attn_anc, var + "launches"),
                      getattr(tdf.cross_attn, var + "launches"))
    before = counts()
    ckk, cvk, ckp, cvp = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    out = tdf.self_attn_anc(q, kn, vn, ckk, cvk, anc, maskk, pos, K, CFG.num_heads)
    ref = tdf.self_attn_anc_plain(q, kn, vn, ckp, cvp, anc, maskk, pos, K, CFG.num_heads)
    assert torch.isfinite(out).all()
    _close(out, ref, 1e-5)
    assert torch.equal(ckk, ckp) and torch.equal(cvk, cvp)
    out = tdf.cross_attn(q, mk, mv, mem_mask, K, CFG.num_heads)
    _close(out, tdf.cross_attn_plain(q, mk, mv, mem_mask, K, CFG.num_heads), 1e-5)
    assert counts() == (before[0] + 1, before[1] + 1)


def _serving_state(pg, K, pos, rng, dev, quant, bf16, Bn=B):
    """_decode_state with the caches in bf16 and the decoder quantized as
    asked; returns (dec, cache, preds, anc, maskk, mem_mask)."""
    cache, preds, anc, maskk, mem_mask = _decode_state(pg, K, pos, rng, dev, Bn=Bn)
    if bf16:
        cache = type(cache)(*(t.to(BF16) for t in cache))
    dec = tdf.quantize_decoder_weights(pg["dec_tgt"]) if quant else pg["dec_tgt"]
    return dec, cache, preds, anc, maskk, mem_mask


def _bf16_cache_close(a, b):
    """Within one bf16 step (at most 2^-7 of the value), elementwise, plus
    TOL_BF16: the two f32 rows rounded differ by the GEMMs' summation order
    and, past the first layer, by the earlier layers' outputs (within
    TOL_BF16), which matters near zero. The attention kernels alone hold
    the rows bit-equal (test_attn_kernels_match_plain)."""
    bad = (a.float() - b.float()).abs() > 2.0 ** -7 * b.float().abs() + TOL_BF16
    assert not bad.any(), int(bad.sum())


SERVING = [(True, False), (False, True), (True, True)]
SERVING_IDS = ["int8", "bf16", "int8+bf16"]


def _variant(quant, bf16):
    return ("q8_" if quant else "") + ("bf16_" if bf16 else "") + "launches"


@pytest.mark.parametrize("quant,bf16", SERVING, ids=SERVING_IDS)
@pytest.mark.parametrize("Bn,K,pos", [(1, 1, 0), (3, 3, 6), (2, 2, MAX_LEN - 1)])
def test_serving_layer_step_kernel_matches_plain(dev, params, Bn, K, pos, quant, bf16):
    _, pg = params
    rng = np.random.RandomState(2000 + 10 * K + pos)
    dec, cache, _, anc, maskk, mem_mask = _serving_state(pg, K, pos, rng, dev, quant, bf16, Bn)
    maskk[pos] = 1
    x = _randn(rng, Bn * K, CFG.dim_model, dev=dev)
    lp = dec["layers"][1]
    name = _variant(quant, bf16)
    before = getattr(decoder_layer_step_flash, name)
    outs = []
    for fn in (decoder_layer_step_flash, decoder_layer_step_plain):
        c = _clone(cache)
        outs.append((fn(lp, x, c.self_k[1], c.self_v[1], c.mem_k[1], c.mem_v[1], pos,
                        CFG.num_heads, anc, K, mem_mask, maskk), c))
    assert getattr(decoder_layer_step_flash, name) == before + 1
    (y, ck), (y_p, cp) = outs
    assert torch.isfinite(y).all() and y.dtype == torch.float32
    _close(y, y_p, TOL_BF16 if bf16 else TOL)
    for a, b in ((ck.self_k, cp.self_k), (ck.self_v, cp.self_v)):
        _bf16_cache_close(a, b) if bf16 else _close(a, b, TOL)


@pytest.mark.parametrize("quant,bf16", SERVING, ids=SERVING_IDS)
@pytest.mark.parametrize("K,pos", [(1, 0), (3, 6)])
def test_serving_chain_step_kernel_matches_plain(dev, params, K, pos, quant, bf16):
    _, pg = params
    rng = np.random.RandomState(3000 + 10 * K + pos)
    dec, cache, _, anc, maskk, mem_mask = _serving_state(pg, K, pos, rng, dev, quant, bf16)
    maskk[pos] = 1
    x = _randn(rng, B * K, CFG.dim_model, dev=dev)
    stacked = stack_decoder_layers(dec)
    assert stacked[1] == quant
    name = _variant(quant, bf16)
    before = getattr(decode_chain_step_flash, name)
    outs = []
    for fn in (decode_chain_step_flash, decode_chain_step_plain):
        c = _clone(cache)
        sc, ids = fn(stacked, dec["norm"], pg["out_tgt"], x, c.self_k, c.self_v, c.mem_k,
                     c.mem_v, pos, CFG.num_heads, anc, K, mem_mask, maskk, K + 1)
        outs.append((sc, ids, c))
    assert getattr(decode_chain_step_flash, name) == before + 1
    (sc, ids, ck), (sc_p, ids_p, cp) = outs
    _same_ids_up_to_ties(ids, ids_p, sc_p)
    _close(sc, sc_p, TOL_BF16 if bf16 else TOL)
    for a, b in ((ck.self_k, cp.self_k), (ck.self_v, cp.self_v)):
        _bf16_cache_close(a, b) if bf16 else _close(a, b, TOL)


@pytest.mark.parametrize("quant,bf16", SERVING, ids=SERVING_IDS)
@pytest.mark.parametrize("K,i", [(1, 5), (3, 7)])
def test_serving_beam_step_kernel_matches_plain(dev, params, K, i, quant, bf16):
    _, pg = params
    rng = np.random.RandomState(4000 + 100 * K + i)
    BK = B * K
    dec, cache, preds, anc, maskk, mem_mask = _serving_state(pg, K, i - 1, rng, dev, quant,
                                                             bf16)
    eos = torch.from_numpy((rng.rand(BK) < 0.3).astype(np.int32)).to(dev)
    scores = torch.from_numpy(-rng.uniform(0, 3 * i, BK).astype(np.float32)).to(dev)
    lenm = torch.from_numpy(rng.randint(1, i, BK).astype(np.float32)).to(dev)
    last_tok = preds[:, i - 1].contiguous()
    stacked = stack_decoder_layers(dec)
    table = _dec_embedder(pg, CFG).contiguous()
    tsig = position_signal(500, CFG.dim_model, dev)[0].contiguous()
    name = _variant(quant, bf16)
    before = getattr(decode_beam_step_flash, name)
    outs = []
    for fn in (decode_beam_step_flash, decode_beam_step_plain):
        c, a = _clone(cache), anc.clone()
        out = fn(stacked, dec["norm"], pg["out_tgt"], table, tsig, i, last_tok, preds, a,
                 maskk, mem_mask, scores, eos, lenm, c.self_k, c.self_v, c.mem_k, c.mem_v,
                 CFG.num_heads, K, 1.0)
        outs.append((out, c))
    assert getattr(decode_beam_step_flash, name) == before + 1
    (out_k, ck), (out_p, cp) = outs
    names = ("preds", "anc", "maskk", "last_tok", "scores", "eos", "lenm", "flag")
    for nm, a, b in zip(names, out_k, out_p):
        if nm in ("scores", "lenm"):
            _close(a, b, TOL_BF16 if bf16 else TOL)
        else:
            assert torch.equal(a.int(), b.int()), nm
    for a, b in ((ck.self_k, cp.self_k), (ck.self_v, cp.self_v)):
        _bf16_cache_close(a, b) if bf16 else _close(a, b, TOL)


@pytest.mark.parametrize("quant,bf16", SERVING, ids=SERVING_IDS)
@pytest.mark.parametrize("kind,K", [("standard", 1), ("standard", 3), ("universal", 3)])
def test_serving_beam_card_matches_cpu(dev, kind, K, quant, bf16):
    """beam_search with the serving options on the card against CPU
    copies: tokens equal, scores within TOL (int8) or TOL_BF16; the
    variant's kernels launched (K3 and K4 on the standard decoder, K5 on
    the universal one)."""
    cfg = CFG if kind == "standard" else UNIVERSAL
    pc = init_seq2seq(cfg, torch.Generator().manual_seed(40 + K), "cpu")
    pg = params_to(pc, dev)
    rng = np.random.RandomState(30 + K)
    enc = _randn(rng, B, LK, CFG.dim_model)
    mem_mask = torch.arange(LK)[None, :] < torch.tensor([11, 6, 9])[:, None]
    kw = dict(cache_dtype=BF16 if bf16 else None, weight_dtype="int8" if quant else None)
    name = _variant(quant, bf16)
    wrappers = ((decode_chain_step_flash, decode_beam_step_flash) if kind == "standard"
                else (decoder_layer_step_flash,))
    before = [getattr(w, name) for w in wrappers]
    before_q8 = kernels.gemm.q8_launches
    preds_g, scores_g = beam_search(pg, cfg, enc.to(dev), mem_mask.to(dev), K, 1.0, MAX_LEN,
                                    **kw)
    assert all(getattr(w, name) > n for w, n in zip(wrappers, before))
    assert (kernels.gemm.q8_launches > before_q8) == quant
    preds_c, scores_c = beam_search(pc, cfg, enc, mem_mask, K, 1.0, MAX_LEN, **kw)
    assert torch.equal(preds_g.cpu(), preds_c)
    _close(scores_g.cpu(), scores_c, TOL_BF16 if bf16 else TOL)


def test_serving_wrappers_reject_other_dtypes(dev, params):
    """Caches or memory in another dtype than f32 or bf16 raise on the card;
    nothing falls back."""
    _, pg = params
    rng = np.random.RandomState(5)
    cache, _, anc, maskk, mem_mask = _decode_state(pg, 1, 0, rng, dev)
    x = _randn(rng, B, CFG.dim_model, dev=dev)
    lp = pg["dec_tgt"]["layers"][0]
    half = lambda t: t.to(torch.float16)
    for ck, mk in ((half(cache.self_k[0]), cache.mem_k[0]),
                   (cache.self_k[0], half(cache.mem_k[0]))):
        cv = ck.clone()
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            decoder_layer_step_flash(lp, x, ck, cv, mk, mk.clone(), 0, CFG.num_heads, anc,
                                     1, mem_mask, maskk)


# ---------------------------------------------------------------------------
# tensor-parallel decode: K6a-c, K7c, and the TP routes on one card
# ---------------------------------------------------------------------------


def _tp_weights(rng, dev, Dq, D=512, FF=1024, n=None):
    """A random decoder layer shard at width D: Q/K/V [D, Dq], fc [Dq, D]
    (Dq / 64 local heads), the FFN's hidden shard FF * Dq / D, LayerNorms
    and biases random."""
    w = lambda *s: _randn(rng, *s, dev=dev) / s[0] ** 0.5
    ln = lambda: {"scale": 1 + 0.1 * _randn(rng, D, dev=dev),
                  "bias": 0.1 * _randn(rng, D, dev=dev)}
    fh = FF * Dq // D
    return {"decslf_attn": {"w_qs": {"w": w(D, Dq)}, "w_ks": {"w": w(D, Dq)},
                            "w_vs": {"w": w(D, Dq)}, "fc": {"w": w(Dq, D)},
                            "layer_norm": ln()},
            "encdec_attn": {"w_qs": {"w": w(D, Dq)}, "fc": {"w": w(Dq, D)},
                            "layer_norm": ln()},
            "pos_ffn": {"w_1": {"w": w(D, fh), "b": 0.1 * _randn(rng, fh, dev=dev)},
                        "w_2": {"w": w(fh, D), "b": 0.1 * _randn(rng, D, dev=dev)},
                        "layer_norm": ln()}}


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pos", [0, 75])
@pytest.mark.parametrize("Dq", [64, 128, 256])
def test_tp_step_kernels_match_plain(dev, Dq, pos, dtype):
    """K6a and K6b at a head shard of width Dq (1, 2 or 4 local heads of 64)
    with and without the residual, f32 and bf16 caches, K = 5 rows a group
    over B = 4 (a fully masked self row and memory entry among them); K6c
    on the matching hidden shard, partial and whole. The new cache row is
    bit-equal to the plain version's."""
    rng = np.random.RandomState(Dq + pos)
    K, nh, D = 5, Dq // 64, 512
    ck, cv, anc, maskk, mk, mv, mem_mask, _ = _attn_state(rng, dev, dtype, K=K, Bn=4, D=Dq)
    anc[pos] = torch.arange(anc.shape[1], device=dev, dtype=torch.int32) % K
    p = _tp_weights(rng, dev, Dq)
    x = _randn(rng, anc.shape[1], D, dev=dev)
    var = "bf16_launches" if dtype == BF16 else "launches"
    for residual in (True, False):
        before = (getattr(tdf.self_attn_step, var), getattr(tdf.cross_attn_step, var))
        ckk, cvk, ckp, cvp = ck.clone(), cv.clone(), ck.clone(), cv.clone()
        y = tdf.self_attn_step(p["decslf_attn"], x, ckk, cvk, pos, nh, anc, K, maskk, residual)
        y_p = tdf.self_attn_step_plain(p["decslf_attn"], x, ckp, cvp, pos, nh, anc, K, maskk,
                                       residual)
        assert torch.isfinite(y).all()
        _close(y, y_p, TOL)
        if dtype == BF16:
            _bf16_cache_close(ckk, ckp)
        else:
            _close(ckk, ckp, TOL)
        y = tdf.cross_attn_step(p["encdec_attn"], x, mk, mv, nh, K, mem_mask, residual)
        _close(y, tdf.cross_attn_step_plain(p["encdec_attn"], x, mk, mv, nh, K, mem_mask,
                                            residual), TOL)
        assert (getattr(tdf.self_attn_step, var), getattr(tdf.cross_attn_step, var)) == (
            before[0] + 1, before[1] + 1)
    for partial in (True, False):
        f = p["pos_ffn"]
        if not partial:  # the whole FFN: w_1 [D, FF], w_2 [FF, D]
            f = _tp_weights(rng, dev, D)["pos_ffn"]
        before = tdf.ffn_step.launches
        _close(tdf.ffn_step(f, x, partial), tdf.ffn_step_plain(f, x, partial), TOL)
        assert tdf.ffn_step.launches == before + 1


@pytest.mark.parametrize("topk", [1, 5, 16])
@pytest.mark.parametrize("v_local", [7, 50, 7500])
def test_head_partial_kernel_matches_plain(dev, v_local, topk):
    """K7c on one vocabulary shard: raw top-K (ids equal up to ties), mx, se
    (relative: the kernel's online sum rescales), and the raw logit at
    gather ids in the shard (0, V/n - 1), above it and below it (0 there);
    a shard narrower than K gives -1e30 at id 0 past its width."""
    rng = np.random.RandomState(v_local + topk)
    BK, D = 80, 512
    norm = {"scale": 1 + 0.1 * _randn(rng, D, dev=dev), "bias": 0.1 * _randn(rng, D, dev=dev)}
    out = {"w": _randn(rng, D, v_local, dev=dev) / D ** 0.5}
    x = _randn(rng, BK, D, dev=dev)
    gid = torch.from_numpy(rng.randint(-2 * v_local, 2 * v_local, BK).astype(np.int32)).to(dev)
    gid[:4] = torch.tensor([0, v_local - 1, v_local, -1], dtype=torch.int32)
    before = tdf.decode_head_partial.launches
    got = tdf.decode_head_partial(norm, out, x, topk)
    got_g = tdf.decode_head_partial(norm, out, x, topk, gid)
    assert tdf.decode_head_partial.launches == before + 2
    ref = tdf.decode_head_partial_plain(norm, out, x, topk)
    ref_g = tdf.decode_head_partial_plain(norm, out, x, topk, gid)
    for a, b in zip(got, got_g):
        assert torch.equal(a, b)
    assert got[1].dtype == torch.int32 and got[0].shape == (BK, topk)
    k = min(topk, v_local)
    _same_ids_up_to_ties(got[1][:, :k], ref[1][:, :k], ref[0][:, :k])
    _close(got[0][:, :k], ref[0][:, :k], 1e-5)
    _close(got[2], ref[2], 1e-5)
    _close(got[3], ref[3], 1e-5 * float(ref[3].abs().max()))
    _close(got_g[4], ref_g[4], 1e-5)
    assert (got_g[4][2:4] == 0).all() and (got_g[4][(gid < 0) | (gid >= v_local)] == 0).all()
    if topk > v_local:
        assert (got[0][:, v_local:] == -1e30).all() and (got[1][:, v_local:] == 0).all()


def test_tp_trio_and_layer_step_match_k5_on_card(dev, params):
    """On the card, the trio (K6a-c with residuals) and the TP layer step
    over 2 and 4 shards of one card, joined, against K5 at full width."""
    from stjep_tpu_torch.ops.decode_flash_tp import ModelAxis, decoder_layer_step_flash_tp
    from stjep_tpu_torch.parallel.mesh import _shard, param_pspec, map_with_path

    _, pg = params
    rng = np.random.RandomState(77)
    K, pos, Bn = 3, 6, 3
    cache, _, anc, maskk, mem_mask = _decode_state(pg, K, pos, rng, dev, Bn=Bn)
    maskk[pos] = 1
    x = _randn(rng, Bn * K, CFG.dim_model, dev=dev)
    lp = pg["dec_tgt"]["layers"][1]
    args = lambda c: (c.self_k[1], c.self_v[1], c.mem_k[1], c.mem_v[1], pos, CFG.num_heads,
                      anc, K, mem_mask, maskk)
    c5 = _clone(cache)
    y5 = decoder_layer_step_flash(lp, x, *args(c5))
    ct = _clone(cache)
    _close(tdf.decoder_layer_step_flash_trio(lp, x, *args(ct)), y5, TOL)
    _close(ct.self_k, c5.self_k, TOL)
    for n in (2, 4):
        dq = CFG.dim_model // n
        shards = [map_with_path(lp, lambda nm, t, m=m: _shard(
            t, param_pspec("dec_tgt.layers.1." + nm, t, n), m, n, dev)) for m in range(n)]
        cs = [_clone(cache) for _ in range(n)]
        sl = lambda t, m: t[..., m * dq:(m + 1) * dq].contiguous()
        cks = [sl(c.self_k[1], m) for m, c in enumerate(cs)]
        trio = (tdf.self_attn_step, tdf.cross_attn_step, tdf.ffn_step)
        before = [f.launches for f in trio]
        ys = decoder_layer_step_flash_tp(
            shards, [x] * n, cks, [sl(c.self_v[1], m) for m, c in enumerate(cs)],
            [sl(cache.mem_k[1], m) for m in range(n)], [sl(cache.mem_v[1], m) for m in range(n)],
            pos, CFG.num_heads // n, [anc] * n, K, [mem_mask] * n, [maskk] * n,
            ModelAxis([dev] * n))
        assert [f.launches for f in trio] == [b + n for b in before]
        _close(ys[0], y5, TOL)
        _close(torch.cat(cks, -1), c5.self_k[1], TOL)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["standard", "universal"])
def test_tp_beam_and_eval_card_match_cpu(dev, kind, n):
    """beam_search (width 3, f32 and bf16 caches) and forward_eval (MT with
    refs) on mesh (1, n) of one card against the same mesh of CPU devices:
    tokens equal, scores and picked within TOL (TOL_BF16 for bf16); the TP
    kernels launched, K3, K4 and K5 not."""
    from stjep_tpu_torch.parallel import spmd
    from stjep_tpu_torch.parallel.mesh import make_mesh

    cfg = dataclasses.replace(CFG if kind == "standard" else UNIVERSAL, mode="MT")
    pc = init_seq2seq(cfg, torch.Generator().manual_seed(60 + n), "cpu")
    pg = params_to(pc, dev)
    rng = np.random.RandomState(61)
    enc = _randn(rng, B, LK, CFG.dim_model)
    mem_mask = torch.arange(LK)[None, :] < torch.tensor([11, 6, 9])[:, None]
    src = torch.from_numpy(rng.randint(4, CFG.enc_vocab_size, (B, CFG.max_seq_len_src)))
    tgt = torch.from_numpy(rng.randint(4, CFG.dec_vocab_size, (B, 9)))
    src[:, 0] = tgt[:, 0] = BOS
    wrappers = (tdf.self_attn_step, tdf.cross_attn_step, tdf.ffn_step, tdf.decode_head_partial,
                decode_chain_step_flash, decode_beam_step_flash, decoder_layer_step_flash)
    try:
        for cache_dtype in (None, BF16):
            outs = []
            for d in (dev, "cpu"):
                spmd.set_kernel_mesh(make_mesh(1, n, [d] * n))
                p = pg if d == dev else pc
                before = [w.launches + getattr(w, "bf16_launches", 0) for w in wrappers]
                outs.append(beam_search(p, cfg, enc.to(d), mem_mask.to(d), 3, 1.0, MAX_LEN,
                                        cache_dtype=cache_dtype))
                if d == dev:
                    ran = [w.launches + getattr(w, "bf16_launches", 0) > b
                           for w, b in zip(wrappers, before)]
                    assert ran == [True] * 4 + [False] * 3, ran
            assert torch.equal(outs[0][0].cpu(), outs[1][0])
            _close(outs[0][1].cpu(), outs[1][1], TOL if cache_dtype is None else TOL_BF16)
        ev = []
        for d in (dev, "cpu"):
            spmd.set_kernel_mesh(make_mesh(1, n, [d] * n))
            ev.append(forward_eval(pg if d == dev else pc, cfg, "MT", src=src, ref_tgt=tgt,
                                   device=d))
        assert torch.equal(ev[0]["preds_mt"].cpu(), ev[1]["preds_mt"])
        _close(ev[0]["picked_mt"].cpu(), ev[1]["picked_mt"], TOL)
    finally:
        spmd.set_kernel_mesh(None)


def _k6_call(pg, dev):
    rng = np.random.RandomState(5)
    cache, _, anc, maskk, mem_mask = _decode_state(pg, 1, 0, rng, dev)
    maskk[0] = 1
    x = _randn(rng, B, CFG.dim_model, dev=dev)
    return lambda: tdf.decoder_layer_step_flash_trio(
        pg["dec_tgt"]["layers"][0], x, cache.self_k[0], cache.self_v[0],
        cache.mem_k[0], cache.mem_v[0], 0, CFG.num_heads, anc, 1, mem_mask, maskk)


def _k7c_call(pg, dev):
    x = _randn(np.random.RandomState(6), B, CFG.dim_model, dev=dev)
    return lambda: tdf.decode_head_partial(pg["dec_tgt"]["norm"], pg["out_tgt"], x, 2)


@pytest.mark.parametrize("make_call", [_k6_call, _k7c_call], ids=["K6_trio", "K7c"])
def test_tp_kernels_refuse_autograd(dev, make_call):
    """K6a (the trio's first launch) and K7c refuse weights that require
    grad on the card; under no_grad they run."""
    test_inference_kernels_refuse_autograd(dev, make_call)
