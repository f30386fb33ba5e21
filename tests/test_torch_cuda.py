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
inputs that require grad. The decode head K7 (one launch in
csrc/decode_chain.cu) is also held at target vocabularies of 13 000 and
30 000 words, and with exact ties, bit-identical at any grid and one
device kernel a call; the general beam loop and dev eval (forward_eval)
run on the card against CPU copies, and so do the dense greedy of
forward_eval without refs (K5 per hop) and the ACT beam (beam_select).
The serving options: K3, K4 and K5 with int8 weights, bf16 caches and
both (TOL_BF16 below). The fused K5 and K4
(csrc/decode_fused.cu) at the flagship width and off-tile shapes in every
variant, bit-identical at two grid sizes, int8 on grid-snapped weights
bit-equal to f32, and their split partials summed in split order; the
K4 and K5 tests and K3's draw every LayerNorm at random. The
fused tensor-parallel steps K6a-c (the same source at a shard's width) at
head shards of 64-256 columns, the first and last cache position, f32 and
bf16 caches and memories, with and without their residuals,
bit-identical at three grid sizes, one device kernel a call, and refusing
what they cannot run. The fused K3 (every layer and the head in one
launch) in every variant, with and without gather ids, at groups of 1, 3
and 5 and positions 0, 1 and 75, and the fused K7c at shards of 7 to
15 000 ids (and with exact ties): bit-identical at any grid, one device
kernel a call. The
fused K2 and K9 (csrc/las_fused.cu) at the flagship's LAS widths over
batches, key lengths, vocabularies and layer counts, with forced head ties
and a PAD symbol fed back, bit-identical at two grid sizes, at alternating
key lengths, and one device kernel a call. The widths of the quality run
and the staged recipe (stjep_tpu_torch/scripts/quality_ab.py and
full_recipe.py: D = 32 with 4 heads and D = 16 with 2, head width 8,
acoustic hidden sizes 16 and 6, vocabularies of 15 to 21 ids): K1 and K8
(SWEEPS), K2 and K9, K3, K4 and K5 in every variant, K7, and the decode
routes card against CPU.

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
from stjep_tpu_torch.models.las_decoder import las_decoder_init
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
from stjep_tpu_torch.ops import las_flash as k2
from stjep_tpu_torch.ops import las_tf_flash as k9
from stjep_tpu_torch.ops import lstm_pallas_bwd as k8
from stjep_tpu_torch.ops.las_flash import las_greedy_flash, las_greedy_plain
from stjep_tpu_torch.ops.lstm import bilstm_init
from stjep_tpu_torch.ops.lstm_pallas import (
    MAX_HIDDEN,
    bilstm_pallas,
    bilstm_plain,
    sweep_plan,
    sweep_shape,
)
from stjep_tpu_torch.ops.masks import position_signal

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


def test_wrappers_reject_bad_cuda_input(dev):
    w = torch.zeros((4, 4), device=dev)
    with pytest.raises(ValueError):
        kernels.gemm(torch.zeros((2, 4), device=dev, dtype=torch.float64), w)
    with pytest.raises(ValueError):
        kernels.gemm(torch.zeros((2, 4), device=dev), w.t())  # not contiguous


# the cluster sweeps (K1, K8) at every batch and width the flags give: B 1
# to 64, H 50 (not a multiple of 4) to 512 (W_hh's slice streamed from L2),
# T up to the flagship's 1504 frames
SWEEPS = [(1, 5, 8, 50), (3, 21, 8, 64), (9, 40, 24, 256), (3, 97, 8, 50),
          (16, 60, 24, 200), (3, 300, 16, 512), (64, 33, 8, 512), (64, 188, 64, 256),
          (1, 1504, 40, 256), (16, 1504, 40, 256),
          # the quality run's and the staged recipe's LAS (acoustic hidden
          # sizes 16 and 6): layer 1 (8-dim features) and a pyramid layer (4H)
          (32, 64, 8, 16), (32, 32, 64, 16), (8, 72, 8, 6), (8, 36, 24, 6),
          # quality.py's kernel profile (acoustic hidden 64): the same two
          (32, 64, 8, 64), (32, 32, 256, 64)]
SWEEP_IDS = [f"B{b}-T{t}-H{h}" for b, t, _, h in SWEEPS]


def _sweep_lens(rng, Bn, T):
    """Lengths with T, 0 and 1 in one batch (where it has three rows)."""
    lens = torch.from_numpy(rng.randint(1, T + 1, size=(Bn,)))
    lens[0] = T
    if Bn >= 3:
        lens[1], lens[2] = 0, 1
    return lens


@pytest.mark.parametrize("Bn,T,Din,H", SWEEPS, ids=SWEEP_IDS)
def test_bilstm_kernel_matches_plain(dev, Bn, T, Din, H):
    rng = np.random.RandomState(T)
    p = bilstm_init(torch.Generator().manual_seed(T), Din, H, dev)
    x = _randn(rng, Bn, T, Din, dev=dev)
    lens = _sweep_lens(rng, Bn, T).to(dev)
    before = bilstm_pallas.launches
    out = bilstm_pallas(p["fwd"], p["bwd"], x, lens)
    assert bilstm_pallas.launches == before + 1
    _close(out, bilstm_plain(p["fwd"], p["bwd"], x, lens), TOL_LSTM)
    valid = torch.arange(T, device=dev)[None, :] < lens[:, None]
    assert torch.all(out[~valid] == 0)
    assert torch.equal(bilstm_pallas(p["fwd"], p["bwd"], x, lens), out)  # bit for bit
    plan = sweep_plan(Bn, H)
    assert plan["max_clusters"] > 0
    # W_hh's slice in shared memory up to H = 256, streamed at H = 512
    assert plan["w_hh"] == ("streamed" if H > 256 else "shared"), plan


def test_bilstm_kernels_raise_where_they_cannot_run(dev):
    """A width past the kernels' reach raises before any launch; a shape
    the launcher refuses (a batch tile it does not take) raises too."""
    p = bilstm_init(torch.Generator().manual_seed(0), 8, MAX_HIDDEN + 1, dev)
    x = torch.zeros((2, 3, 8), device=dev)
    with pytest.raises(ValueError, match="1 <= H"):
        bilstm_pallas(p["fwd"], p["bwd"], x)
    w = (p["fwd"]["w_ih"], p["bwd"]["w_ih"]), (p["fwd"]["w_hh"], p["bwd"]["w_hh"])
    bias = (p["fwd"]["b_ih"], p["bwd"]["b_ih"])
    with pytest.raises(ValueError, match="1 <= H"):
        k8.bilstm_fwd_save(*w, bias, x, torch.tensor([3, 2], device=dev))
    xp = torch.zeros((6, 4 * 64), device=dev)
    wh = torch.zeros((64, 4 * 64), device=dev)
    with pytest.raises(RuntimeError, match="failed to launch"):
        kernels.launch("bilstm_recurrent", xp, xp, wh, wh, torch.ones(2, dtype=torch.int32,
                       device=dev), torch.empty((2, 3, 128), device=dev), 2, 3, 64, 5, 8)


def test_las_greedy_kernel_matches_plain(dev, params):
    _check_las_greedy(dev, CFG, params[1]["las"]["decoder"])


def _check_las_greedy(dev, cfg, dec, refs=True):
    """K2 (with reference tokens, or free running) against its plain
    version on 5 rows, one key of length 1."""
    rng = np.random.RandomState(3)
    Tk = 9
    acous = _randn(rng, 5, Tk, 2 * cfg.acous_hidden_size, dev=dev)
    wk = precompute_keys(dec["acous_att"], acous, "bilinear")["wk"]
    lens_k = torch.tensor([9, 1, 4, 9, 6], device=dev)
    sym0 = torch.full((5,), BOS, device=dev)
    n = cfg.max_seq_len_src - 1
    ref = torch.from_numpy(rng.randint(0, cfg.enc_vocab_size, (5, n))).to(dev) if refs else None
    args = (dec, cfg, wk, acous, lens_k, sym0, n)
    before = las_greedy_flash.launches
    embs, preds, picked = las_greedy_flash(*args, ref_tokens=ref)
    assert las_greedy_flash.launches == before + 1
    embs_p, preds_p, picked_p = las_greedy_plain(*args, ref_tokens=ref)
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
    """K5 on layer 1's caches, its three LayerNorms drawn at random: the
    output and every cache row (the new one at pos, the rest untouched)."""
    _, pg = params
    rng = np.random.RandomState(1000 + 10 * K + pos)
    cache, _, anc, maskk, mem_mask = _decode_state(pg, K, pos, rng, dev, Bn=Bn)
    maskk[pos] = 1
    x = _randn(rng, Bn * K, CFG.dim_model, dev=dev)
    lp = _random_norms(pg["dec_tgt"], rng, dev)["layers"][1]
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


def _head_params(rng, V, dev, ties=False, D=CFG.dim_model):
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


def _same_ids_up_to_ties(ids, ids_p, sc_p, tie=1e-5):
    """ids equal wherever the plain arm's top-K gap at that rank (to the next
    rank) exceeds tie; returns the number of tied rows."""
    gaps = torch.cat([sc_p[:, :-1] - sc_p[:, 1:],
                      torch.full_like(sc_p[:, :1], float("inf"))], 1)
    bad = (ids != ids_p) & (gaps > tie)
    assert not bad.any(), (ids[bad.any(1)], ids_p[bad.any(1)])
    return int((ids != ids_p).any(1).sum())


@pytest.mark.parametrize("BK,V,topk,ties", [
    (1, 1, 1, False), (5, 40, 3, False), (80, 200, 5, False), (7, 200, 16, False),
    (16, 13000, 5, False), (80, 30000, 5, False), (6, 40, 4, True),
    (6, 3000, 4, True), (6, 13000, 4, True), (16, 200, 1, False)])
def test_head_kernels_match_plain(dev, BK, V, topk, ties):
    """K7 (decode_head) and its gather variant, one launch of head_fused,
    up to 30 000 ids (15 column slices merged); gather ids include 0 and
    V-1; the last case is universal dev eval's shape. The tie cases put
    equal columns in one thread's registers, across threads and, past 2048
    ids, across slices."""
    _check_head(dev, BK, V, topk, ties)


def _check_head(dev, BK, V, topk, ties, D=CFG.dim_model):
    rng = np.random.RandomState(BK + V + topk)
    norm, out = _head_params(rng, V, dev, ties, D)
    x = _randn(rng, BK, D, dev=dev)
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


@pytest.mark.parametrize("kind", ["standard", "universal"])
def test_dense_greedy_card_matches_cpu(dev, kind):
    """forward_eval ASR_ST without refs: K1, the LAS step loop for
    logps_asr (no K2), then the dense greedy, K5 per hop and a plain head
    (no K3, no K7); the dense logps_* against CPU copies."""
    cfg = CFG if kind == "standard" else UNIVERSAL
    pc = init_seq2seq(cfg, torch.Generator().manual_seed(6), "cpu")
    pg = params_to(pc, dev)
    rng = np.random.RandomState(10)
    kw = dict(acous_feats=_randn(rng, B, 64, CFG.acous_dim), acous_lens=torch.tensor([64, 29, 47]))
    wrappers = ((bilstm_pallas, "launches"), (las_greedy_flash, "launches"),
                (decoder_layer_step_flash, "launches"), (decode_chain_step_flash, "launches"),
                (decode_chain_step_flash, "gather_launches"), (decode_head, "launches"),
                (decode_head_gather, "launches"))
    before = [getattr(w, a) for w, a in wrappers]
    out_g = forward_eval(pg, cfg, "ASR_ST", device=dev, **kw)
    ran = [getattr(w, a) > n for (w, a), n in zip(wrappers, before)]
    assert ran == [True, False, True, False, False, False, False]
    out_c = forward_eval(pc, cfg, "ASR_ST", device="cpu", **kw)
    assert set(out_g) == set(out_c) >= {"logps_asr", "logps_st"}
    for k, v in out_c.items():
        if k.startswith(("preds", "lengths")):
            assert torch.equal(out_g[k].cpu(), v), k
        else:
            _close(out_g[k].cpu(), v, TOL)


@pytest.mark.parametrize("K", [1, 3, 5])
def test_act_beam_card_matches_cpu(dev, K):
    """The ACT beam: every position re-runs the token buffer in plain
    PyTorch, then K4's select kernel keeps K; no K3, K4, K5 or K7."""
    cfg = dataclasses.replace(UNIVERSAL, act=True)
    pc = init_seq2seq(cfg, torch.Generator().manual_seed(30 + K), "cpu")
    pg = params_to(pc, dev)
    rng = np.random.RandomState(40 + K)
    enc = _randn(rng, B, LK, CFG.dim_model)
    mem_mask = torch.arange(LK)[None, :] < torch.tensor([11, 6, 9])[:, None]
    wrappers = (beam_select, decoder_layer_step_flash, decode_head, decode_chain_step_flash,
                decode_beam_step_flash)
    before = [w.launches for w in wrappers]
    preds_g, scores_g = beam_search(pg, cfg, enc.to(dev), mem_mask.to(dev), K, 1.0, MAX_LEN)
    ran = [w.launches > n for w, n in zip(wrappers, before)]
    assert ran == [True, False, False, False, False]
    preds_c, scores_c = beam_search(pc, cfg, enc, mem_mask, K, 1.0, MAX_LEN)
    assert torch.equal(preds_g.cpu(), preds_c)
    _close(scores_g.cpu(), scores_c, TOL)


def _grad_leaves(tree, dev):
    """A copy of the tree on dev whose leaves require grad."""
    if isinstance(tree, dict):
        return {k: _grad_leaves(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grad_leaves(v, dev) for v in tree]
    return tree.detach().to(dev).clone().requires_grad_(True)


@pytest.mark.parametrize("Bn,T,Din,H", SWEEPS, ids=SWEEP_IDS)
def test_bilstm_trainable_kernels_match_plain(dev, Bn, T, Din, H):
    """K8 forward streams, backward stream and the Function's gradients;
    rows of length 0, 1 and T, batches that do not fill a tile; each sweep
    twice, bit for bit."""
    rng = np.random.RandomState(T + 1)
    p = bilstm_init(torch.Generator().manual_seed(T), Din, H, "cpu")
    x = _randn(rng, Bn, T, Din)
    lens = _sweep_lens(rng, Bn, T)
    g_out = _randn(rng, Bn, T, 2 * H)
    w = lambda d, k: p[("fwd", "bwd")[d]][k].to(dev)
    args = ((w(0, "w_ih"), w(1, "w_ih")), (w(0, "w_hh"), w(1, "w_hh")),
            (w(0, "b_ih") + w(0, "b_hh"), w(1, "b_ih") + w(1, "b_hh")),
            x.to(dev), lens.to(dev))
    before = (k8.bilstm_fwd_save.launches, k8.bilstm_bwd.launches)
    fwd_k, fwd_p = k8.bilstm_fwd_save(*args), k8.bilstm_fwd_save_plain(*args)
    for a, b in zip(fwd_k, fwd_p):
        _close(a, b, TOL_LSTM)
    assert all(torch.equal(a, b) for a, b in zip(k8.bilstm_fwd_save(*args), fwd_k))
    bargs = (g_out.to(dev), fwd_p[2], fwd_p[3], args[1], args[4])
    dxp = k8.bilstm_bwd(*bargs)
    _close_rel(dxp, k8.bilstm_bwd_plain(*bargs))
    assert torch.equal(k8.bilstm_bwd(*bargs), dxp)
    assert (k8.bilstm_fwd_save.launches, k8.bilstm_bwd.launches) == (
        before[0] + 2, before[1] + 2)
    assert sweep_plan(Bn, H, backward=True)["max_clusters"] > 0
    if T > 300:
        return  # the Function's CPU route below loops over every step on the host
    grads = []
    for d in ("cpu", dev):
        q = _grad_leaves(p, d)
        xd = _grad_leaves(x, d)
        out = k8.bilstm_pallas_trainable(q["fwd"], q["bwd"], xd, lens.to(d))
        out.backward(g_out.to(d))
        grads.append([xd.grad] + [t.grad for t in leaves(q)])
    for a, b in zip(*grads):  # card against the CPU route
        _close_rel(b.cpu(), a)


def test_bilstm_bwd_sums_pieces_in_rank_order(dev):
    """The reduce-scatter's owner adds the C pieces of dh in rank order
    0..C-1. Inputs where that order is visible: at t = 1 (the first step
    of the forward direction's reverse sweep) every i-gate column carries
    dPre = 1 exactly (gates i = g = o = f = 1/2, c_{t-1} = -1/2, so
    tanh(c_t) = 0, and g_out = 16), and W_hh is zero but for one i-gate
    column in each of ranks 0, 1 and 2, whose pieces of dh for unit k0 are
    2^24, 1 and -2^24. In rank order they sum to 0 in f32; in any other
    order that starts with rank 1 or 2 to 1. At t = 0 that dh shows in the
    i gate's dPre: (dc + dh / 2) / 8 with dc = 4, so exactly 0.5."""
    Bn, T, H = 1, 2, 64
    bt, c = sweep_shape(Bn, H, backward=True)
    U = -(-H // c)
    k0 = 5
    whh = torch.zeros((H, 4 * H))
    for q, v in enumerate((2.0 ** 24, 1.0, -(2.0 ** 24))):
        whh[k0, q * U] = v  # the i-gate column of rank q's first unit
    cs = torch.full((2, T, Bn, H), -0.5)
    gates = torch.full((2, T, Bn, 4 * H), 0.5)
    g_out = torch.zeros((Bn, T, 2 * H))
    g_out[:, 1, :H] = 16.0
    lens = torch.tensor([T])
    dxp = k8.bilstm_bwd(g_out.to(dev), cs.to(dev), gates.to(dev),
                        (whh.to(dev), torch.zeros_like(whh).to(dev)), lens.to(dev))
    assert float(dxp[0, 1, 0, k0]) == 1.0  # dPre_i at t = 1
    assert float(dxp[0, 0, 0, k0]) == 0.5, float(dxp[0, 0, 0, k0])


@pytest.mark.parametrize("use_masks", [False, True])
def test_las_tf_kernels_match_plain(dev, params, use_masks):
    """K9 forward streams, backward streams and the Function's gradients,
    with a fully masked row (lens_k 0) and an odd batch."""
    _check_las_tf(dev, CFG, params[0], use_masks)


def _check_las_tf(dev, cfg, pc, use_masks):
    dec = pc["las"]["decoder"]
    rng = np.random.RandomState(11 + use_masks)
    S, Bn, Tk = 6, 5, 9
    Hd, Ha2 = cfg.dim_model, 2 * cfg.acous_hidden_size
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
        stack["dec_l2"]["b_hh"], ffn_w)), pack=True)
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
# the serving options: int8 weights and bf16 caches
# ---------------------------------------------------------------------------


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
    TOL_BF16), which matters near zero."""
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
    other = _variant(not quant, bf16)  # the other weight type's variant
    before = [(getattr(w, name), getattr(w, other)) for w in wrappers]
    preds_g, scores_g = beam_search(pg, cfg, enc.to(dev), mem_mask.to(dev), K, 1.0, MAX_LEN,
                                    **kw)
    assert all(getattr(w, name) > n and getattr(w, other) == m
               for w, (n, m) in zip(wrappers, before))
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
# the fused K5 and K4: one cooperative launch each (csrc/decode_fused.cu)
# ---------------------------------------------------------------------------

# the flagship decoder's widths (bench.py), two layers
WIDE = dataclasses.replace(CFG, dec_vocab_size=200, dec_embedding_size=512, dim_model=512,
                           dim_feedforward=1024, num_heads=8, max_seq_len_tgt=150)
VARIANTS = [(False, False)] + SERVING
VARIANT_IDS = ["f32"] + SERVING_IDS


@pytest.fixture(scope="module")
def wide_params(dev):
    return params_to(init_seq2seq(WIDE, torch.Generator().manual_seed(7), "cpu"), dev)


# the widths of stjep_tpu_torch/scripts/quality_ab.py (DIMS, on the hard
# corpus's vocabularies), of full_recipe.py (run_full_recipe.sh's COMMON,
# on its corpus's) and quality.py's kernel profile: head widths 8 and 32,
# acoustic hidden sizes 16, 6 and 64
NARROW = {
    "quality": ModelConfig(
        enc_vocab_size=21, dec_vocab_size=15, enc_embedding_size=16, dec_embedding_size=32,
        acous_dim=8, acous_hidden_size=16, dim_model=32, dim_feedforward=64, num_heads=4,
        enc_layers=2, dec_layers=2, spec_aug=False, dropout=0.0, max_seq_len_src=10,
        max_seq_len_tgt=24, mode="ASR_ST"),
    "recipe": ModelConfig(
        enc_vocab_size=20, dec_vocab_size=15, enc_embedding_size=8, dec_embedding_size=16,
        acous_dim=8, acous_hidden_size=6, dim_model=16, dim_feedforward=32, num_heads=2,
        enc_layers=2, dec_layers=2, spec_aug=False, dropout=0.0, max_seq_len_src=16,
        max_seq_len_tgt=32, mode="ASR_ST"),
    # stjep_tpu_torch/scripts/quality.py's kernel profile on the learnable
    # corpus's vocabularies: D 128 and 2H 128 pass JAX's gate for K2 and K9
    "kernel": ModelConfig(
        enc_vocab_size=20, dec_vocab_size=15, enc_embedding_size=16, dec_embedding_size=32,
        acous_dim=8, acous_hidden_size=64, dim_model=128, dim_feedforward=256, num_heads=4,
        enc_layers=2, dec_layers=2, spec_aug=False, dropout=0.0, max_seq_len_src=10,
        max_seq_len_tgt=24, mode="ASR_ST")}
# stjep_tpu_torch/scripts/eval_audit.py's --dims audit (run_eval_audit.py's
# DIMS): D 12 in 2 heads, a head width of 6 (no 16-byte cache row loads),
# and no int8 weights (D % 16); its own tests at the end of the file
AUDIT = ModelConfig(
    enc_vocab_size=20, dec_vocab_size=15, enc_embedding_size=8, dec_embedding_size=12,
    acous_dim=8, acous_hidden_size=6, dim_model=12, dim_feedforward=24, num_heads=2,
    enc_layers=2, dec_layers=2, spec_aug=False, dropout=0.0, max_seq_len_src=16,
    max_seq_len_tgt=32, mode="ASR_ST")


@pytest.fixture(scope="module")
def narrow(dev):
    """width -> (cfg, CPU params, card params), NARROW's and "audit"."""
    out = {}
    for i, (k, cfg) in enumerate({**NARROW, "audit": AUDIT}.items()):
        pc = init_seq2seq(cfg, torch.Generator().manual_seed(40 + i), "cpu")
        out[k] = (cfg, pc, params_to(pc, dev))
    return out


def _kind(kind, params, wide_params, narrow):
    """(cfg, card params) of a fused case's config."""
    if kind == "small":
        return CFG, params[1]
    if kind == "wide":
        return WIDE, wide_params
    return narrow[kind][0], narrow[kind][2]


def _fused_state(pg, cfg, Bn, K, pos, rng, dev, quant=False, bf16=False, Lk=LK,
                 snap=False):
    """A decode state at `pos`: memory of Lk rows (the K/V cut to Lk, not
    padded to 32), caches filled below pos, a random ancestry with each
    row's own slot at pos, a fully masked self row and a memory entry with
    5 valid rows. snap puts the streamed matrices on the int8 grid (q *
    2^-12, 127 in row 0), where quantization is lossless. Returns (dec,
    cache, preds, anc, maskk, mem_mask)."""
    from stjep_tpu_torch.models.tf_decoder import TFDecCache

    dec = pg["dec_tgt"]
    if snap:
        layers = []
        for lp in dec["layers"]:
            nl_ = {k: dict(v) for k, v in lp.items()}
            for sub, keys in (("decslf_attn", tdf.QUANT_SELF), ("encdec_attn", tdf.QUANT_CROSS),
                              ("pos_ffn", tdf.QUANT_FFN)):
                for k in keys:
                    q = rng.randint(-127, 128, size=tuple(lp[sub][k]["w"].shape))
                    q[0] = 127
                    nl_[sub][k] = {**lp[sub][k], "w": torch.from_numpy(
                        (q * 2.0 ** -12).astype(np.float32)).to(dev)}
            layers.append(nl_)
        dec = {**dec, "layers": layers}
    BK, D = Bn * K, cfg.dim_model
    enc = _randn(rng, Bn, Lk, D, dev=dev)
    c = tf_decoder_init_cache_chain(dec, cfg, enc, cfg.max_seq_len_tgt, K)
    Lpad = c.self_k.shape[3]
    for t in (c.self_k, c.self_v):
        t[:, :, :, :pos] = _randn(rng, *t[:, :, :, :pos].shape, dev=dev)
    cache = TFDecCache(c.self_k, c.self_v, c.mem_k[:, :, :Lk].contiguous(),
                       c.mem_v[:, :, :Lk].contiguous())
    if bf16:
        cache = type(cache)(*(t.to(BF16) for t in cache))
    preds = torch.full((BK, Lpad), PAD, dtype=torch.int32)
    preds[:, 0] = BOS
    preds[:, 1:pos + 1] = torch.from_numpy(rng.randint(4, cfg.dec_vocab_size, (BK, pos)))
    anc = torch.from_numpy(rng.randint(0, K, (Lpad, BK))).int()
    anc[pos] = torch.arange(BK, dtype=torch.int32) % K
    maskk = (preds != PAD).T.int().contiguous()
    maskk[:, min(1, BK - 1)] = 0
    maskk[pos] = 1
    mem_mask = torch.ones((Lk, Bn), dtype=torch.int32)
    mem_mask[5:, Bn - 1] = 0
    if quant:
        dec = tdf.quantize_decoder_weights(dec)
    return dec, cache, preds.to(dev), anc.to(dev), maskk.to(dev), mem_mask.to(dev)


def _k5(dec, cache, x, pos, anc, K, mem_mask, maskk, fn=decoder_layer_step_flash, layer=1,
        n_head=None):
    c = _clone(cache)
    if n_head is None:
        n_head = WIDE.num_heads if x.shape[1] == WIDE.dim_model else CFG.num_heads
    y = fn(dec["layers"][layer], x, c.self_k[layer], c.self_v[layer], c.mem_k[layer],
           c.mem_v[layer], pos, n_head, anc, K, mem_mask, maskk)
    return y, c


FUSED_K5_CASES = [  # (config, Bn, K, pos, Lk): BK = 5, 320, 9, 80
    ("small", 1, 5, 0, LK), ("small", 64, 5, 7, 45), ("small", 3, 3, MAX_LEN - 1, 45),
    ("wide", 16, 5, 75, 89),
    # head width 8: the quality run's (D 32, 4 heads) and the recipe's (D 16, 2)
    ("quality", 16, 5, 0, 8), ("quality", 16, 5, 23, 8), ("recipe", 8, 3, 31, 9),
    # head width 32 at the kernel profile (D 128, 4 heads, 15 target ids)
    ("kernel", 16, 5, 0, 8), ("kernel", 16, 5, 23, 8)]


@pytest.mark.parametrize("quant,bf16", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("kind,Bn,K,pos,Lk", FUSED_K5_CASES)
def test_fused_layer_step_matches_plain(dev, params, wide_params, narrow, kind, Bn, K, pos, Lk,
                                        quant, bf16):
    """Fused K5 against decoder_layer_step_plain, every LayerNorm drawn at
    random: the output, every cache row (the new one at pos, the rest
    untouched), one launch counted."""
    cfg, pg = _kind(kind, params, wide_params, narrow)
    rng = np.random.RandomState(6000 + Bn + pos)
    dec, cache, _, anc, maskk, mem_mask = _fused_state(pg, cfg, Bn, K, pos, rng, dev, quant,
                                                       bf16, Lk)
    x = _randn(rng, Bn * K, cfg.dim_model, dev=dev)
    dec = _random_norms(dec, rng, dev)
    name = _variant(quant, bf16)
    before = getattr(decoder_layer_step_flash, name)
    y, ck = _k5(dec, cache, x, pos, anc, K, mem_mask, maskk, n_head=cfg.num_heads)
    assert getattr(decoder_layer_step_flash, name) == before + 1
    y_p, cp = _k5(dec, cache, x, pos, anc, K, mem_mask, maskk, decoder_layer_step_plain,
                  n_head=cfg.num_heads)
    assert torch.isfinite(y).all()
    _close(y, y_p, TOL_BF16 if bf16 else TOL)
    for a, b in ((ck.self_k, cp.self_k), (ck.self_v, cp.self_v)):
        _bf16_cache_close(a, b) if bf16 else _close(a, b, TOL)
    assert torch.equal(ck.self_k[0], cache.self_k[0])  # other layers untouched


def _k4(dec, pg, cfg, cache, preds, anc, maskk, mem_mask, i, K, fn=decode_beam_step_flash,
        pf=1.0, seed=0):
    rng = np.random.RandomState(seed)
    BK = preds.shape[0]
    dev = preds.device
    eos = torch.from_numpy((rng.rand(BK) < 0.3).astype(np.int32)).to(dev)
    scores = torch.from_numpy(-rng.uniform(0, 3 * i, BK).astype(np.float32)).to(dev)
    lenm = torch.from_numpy(rng.randint(1, i, BK).astype(np.float32)).to(dev)
    last_tok = preds[:, i - 1].contiguous()
    table = _dec_embedder(pg, cfg).contiguous()
    tsig = position_signal(500, cfg.dim_model, dev)[0].contiguous()
    c, a = _clone(cache), anc.clone()
    out = fn(stack_decoder_layers(dec), dec["norm"], pg["out_tgt"], table, tsig, i, last_tok,
             preds, a, maskk, mem_mask, scores, eos, lenm, c.self_k, c.self_v, c.mem_k,
             c.mem_v, cfg.num_heads, K, pf)
    return out, c, a, (table, tsig, last_tok, scores, eos, lenm)


FUSED_K4_CASES = [("small", 1, 5, 2, LK, 1.0), ("small", 3, 3, 7, 45, 0.7),
                  ("small", 2, 2, MAX_LEN - 1, 45, 1.3), ("wide", 16, 5, 75, 89, 1.0),
                  ("quality", 16, 5, 2, 8, 1.0), ("quality", 16, 5, 23, 8, 1.0),
                  ("recipe", 8, 3, 31, 9, 1.0)]


@pytest.mark.parametrize("quant,bf16", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("kind,Bn,K,i,Lk,pf", FUSED_K4_CASES)
def test_fused_beam_step_matches_plain(dev, params, wide_params, narrow, kind, Bn, K, i, Lk, pf,
                                       quant, bf16):
    """Fused K4 against decode_beam_step_plain, every LayerNorm (each
    layer's three and the final one) drawn at random: the select's outputs
    equal (scores and lenm within tolerance) except in a beam group whose
    plain candidates tie within the tolerance, anc[i-1] set in place, the
    caches."""
    cfg, pg = _kind(kind, params, wide_params, narrow)
    rng = np.random.RandomState(7000 + Bn + i)
    dec, cache, preds, anc, maskk, mem_mask = _fused_state(pg, cfg, Bn, K, i - 1, rng, dev,
                                                           quant, bf16, Lk)
    dec = _random_norms(dec, rng, dev)
    name = _variant(quant, bf16)
    before = getattr(decode_beam_step_flash, name)
    out_k, ck, ak, ins = _k4(dec, pg, cfg, cache, preds, anc, maskk, mem_mask, i, K, pf=pf)
    assert getattr(decode_beam_step_flash, name) == before + 1
    out_p, cp, ap, _ = _k4(dec, pg, cfg, cache, preds, anc, maskk, mem_mask, i, K,
                           decode_beam_step_plain, pf)
    tol = TOL_BF16 if bf16 else TOL
    # the plain candidates, to tell a tie from a fault
    table, tsig, last_tok, scores, eos, lenm = ins
    x = _dec_embedder(pg, cfg)[last_tok.long()] + tsig[i - 1]
    c = _clone(cache)
    sc, _ = decode_chain_step_plain(stack_decoder_layers(dec), dec["norm"], pg["out_tgt"], x,
                                    c.self_k, c.self_v, c.mem_k, c.mem_v, i - 1, cfg.num_heads,
                                    ap, K, mem_mask, maskk, K)
    cand = tdf.beam_candidates(sc, scores, eos, lenm, pf)[0].sort(dim=1, descending=True)[0]
    gaps = (cand[:, :K] - cand[:, 1:K + 1]).min(dim=1)[0] if K > 1 else cand[:, 0] * 0 + 1
    grp = torch.arange(Bn * K, device=dev) // K
    tied = torch.zeros(Bn, dtype=torch.bool, device=dev)
    names = ("preds", "anc", "maskk", "last_tok", "scores", "eos", "lenm", "flag")
    for nm, a, b in zip(names[:4] + names[5:6], out_k[:4] + out_k[5:6], out_p[:4] + out_p[5:6]):
        bad = a != b
        bad = bad.any(dim=1) if nm == "preds" else bad.any(dim=0) if a.dim() == 2 else bad
        tied[grp[bad]] = True
    assert bool((gaps[tied] <= tol).all()), (nm, gaps[tied])
    keep = ~tied[grp]
    _close(out_k[4][keep], out_p[4][keep], tol * 10)  # cumulative scores up to ~3 * i
    _close(out_k[6][keep], out_p[6][keep], 0)
    if not tied.any():
        assert torch.equal(out_k[7], out_p[7])
    assert torch.equal(ak, ap)  # anc[i-1] set in place to each row's own slot
    for a, b in ((ck.self_k, cp.self_k), (ck.self_v, cp.self_v)):
        _bf16_cache_close(a, b) if bf16 else _close(a, b, TOL)


@pytest.mark.parametrize("quant,bf16", [(False, False), (True, True)], ids=["f32", "int8+bf16"])
@pytest.mark.parametrize("step", ["K5", "K4", "K3"])
def test_fused_kernels_bit_identical_at_two_grid_sizes(dev, wide_params, monkeypatch, step,
                                                       quant, bf16):
    """The same inputs on every block the card keeps resident and on 7
    blocks: outputs and caches bit-identical (the tiling and every
    summation order follow from the shapes alone); K3 with gather ids."""
    rng = np.random.RandomState(8000)
    pos = 40
    dec, cache, preds, anc, maskk, mem_mask = _fused_state(wide_params, WIDE, 16, 5, pos, rng,
                                                           dev, quant, bf16, 89)
    x = _randn(rng, 80, WIDE.dim_model, dev=dev)
    runs = []
    for grid in (0, 7):
        monkeypatch.setattr(tdf, "FUSED_GRID", grid)
        if step == "K5":
            y, c = _k5(dec, cache, x, pos, anc, 5, mem_mask, maskk)
            runs.append((y, c.self_k, c.self_v))
        elif step == "K3":
            gid = torch.arange(80, device=dev, dtype=torch.int32) * 7 % WIDE.dec_vocab_size
            out, c = _k3(dec, wide_params, cache, x, pos, anc, 5, mem_mask, maskk, 6, gid)
            runs.append((*out, c.self_k, c.self_v))
        else:
            out, c, a, _ = _k4(dec, wide_params, WIDE, cache, preds, anc, maskk, mem_mask,
                               pos + 1, 5)
            runs.append((*out, c.self_k, c.self_v, a))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _k3(dec, pg, cache, x, pos, anc, K, mem_mask, maskk, topk, gid=None,
        fn=decode_chain_step_flash, n_head=WIDE.num_heads):
    """K3 (or fn), n_head heads (the flagship's by default), on a copy of
    the caches; returns (its outputs, the caches)."""
    c = _clone(cache)
    out = fn(stack_decoder_layers(dec), dec["norm"], pg["out_tgt"], x, c.self_k, c.self_v,
             c.mem_k, c.mem_v, pos, n_head, anc, K, mem_mask, maskk, topk,
             gather_ids=gid)
    return out, c


def _random_norms(dec, rng, dev):
    """dec with every LayerNorm (each layer's three and the final one) at
    random scales and biases, so that no two are alike: init_seq2seq gives
    them all ones and zeros, under which a kernel reading the wrong one
    still matches."""
    D = dec["norm"]["scale"].numel()
    ln = lambda: {"scale": 1 + 0.1 * _randn(rng, D, dev=dev), "bias": 0.1 * _randn(rng, D, dev=dev)}
    layers = [{k: {**v, "layer_norm": ln()} for k, v in lp.items()} for lp in dec["layers"]]
    return {**dec, "layers": layers, "norm": ln()}


# (K, pos, topk, gather): the beam's groups at positions 0 and 1 (topk K + 1,
# as beam position 1 asks), greedy dev eval's group of 1 with gather ids, a
# top-K of MAX_BEAM, and position 75 of the 160-row caches
FUSED_K3_CASES = [(1, 0, 2, True), (1, 1, 1, True), (1, 75, 16, False), (3, 0, 4, False),
                  (3, 1, 3, True), (3, 75, 4, True), (5, 0, 6, False), (5, 1, 5, False),
                  (5, 75, 6, True)]


@pytest.mark.parametrize("quant,bf16", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("K,pos,topk,gather", FUSED_K3_CASES)
def test_fused_chain_step_matches_plain(dev, wide_params, K, pos, topk, gather, quant, bf16):
    """Fused K3 (one launch: every layer and the head) against
    decode_chain_step_plain at the flagship's widths, B = 16: scores and
    glp within TOL (bf16 caches: TOL_BF16), ids equal up to ties at that
    margin, every cache row (each layer's new one at pos, the rest
    untouched) within TOL (bf16: one bf16 step), one launch counted under
    the variant's name. Every LayerNorm differs from every other."""
    _check_chain_step(dev, WIDE, wide_params, 16, K, pos, topk, gather, quant, bf16, 89,
                      12000 + 100 * K + pos)


def _check_chain_step(dev, cfg, pg, Bn, K, pos, topk, gather, quant, bf16, Lk, seed):
    rng = np.random.RandomState(seed)
    dec, cache, _, anc, maskk, mem_mask = _fused_state(pg, cfg, Bn, K, pos, rng, dev,
                                                       quant, bf16, Lk)
    dec = _random_norms(dec, rng, dev)
    BK, V = Bn * K, cfg.dec_vocab_size
    x = _randn(rng, BK, cfg.dim_model, dev=dev)
    gid = None
    if gather:
        gid = torch.from_numpy(rng.randint(0, V, BK).astype(np.int32)).to(dev)
        gid[0], gid[-1] = V - 1, 0
    name = ("gather_" if gather else "") + _variant(quant, bf16)
    before = getattr(decode_chain_step_flash, name)
    out, ck = _k3(dec, pg, cache, x, pos, anc, K, mem_mask, maskk, topk, gid,
                  n_head=cfg.num_heads)
    assert getattr(decode_chain_step_flash, name) == before + 1
    ref, cp = _k3(dec, pg, cache, x, pos, anc, K, mem_mask, maskk, topk, gid,
                  decode_chain_step_plain, n_head=cfg.num_heads)
    tol = TOL_BF16 if bf16 else TOL
    assert len(out) == (3 if gather else 2) and out[0].shape == (BK, topk)
    assert torch.isfinite(out[0]).all() and out[1].dtype == torch.int32
    _same_ids_up_to_ties(out[1], ref[1], ref[0], tol)
    _close(out[0], ref[0], tol)
    if gather:
        _close(out[2], ref[2], tol)
    for a, b in ((ck.self_k, cp.self_k), (ck.self_v, cp.self_v)):
        _bf16_cache_close(a, b) if bf16 else _close(a, b, TOL)
    assert torch.equal(ck.self_k[:, :, :, pos + 1:], cache.self_k[:, :, :, pos + 1:])


def test_fused_chain_and_head_partial_refuse_what_they_cannot_run(dev, wide_params):
    """No fallback: K3 with a top-K past MAX_BEAM or a position past the
    cache is refused by the kernel, and rows that do not fit the caches'
    groups before a launch; K7c with a top-K past MAX_BEAM is refused by
    the kernel, and a shard whose rows are not D before a launch; K7 the
    same, and a top-K past V by the kernel."""
    rng = np.random.RandomState(12500)
    dec, cache, _, anc, maskk, mem_mask = _fused_state(wide_params, WIDE, 2, 5, 3, rng, dev)
    x = _randn(rng, 10, WIDE.dim_model, dev=dev)
    k3 = lambda topk=5, pos=3, xx=x: _k3(dec, wide_params, cache, xx, pos, anc, 5, mem_mask,
                                         maskk, topk)
    assert torch.isfinite(k3(16)[0][0]).all()
    with pytest.raises(RuntimeError, match="decode_chain_fused"):
        k3(17)
    with pytest.raises(RuntimeError, match="decode_chain_fused"):
        k3(pos=cache.self_k.shape[3])
    with pytest.raises(ValueError):
        k3(xx=x[:9].contiguous())
    norm = dec["norm"]
    out = {"w": wide_params["out_tgt"]["w"][:, :50].contiguous()}
    assert torch.isfinite(tdf.decode_head_partial(norm, out, x, 16)[0]).all()
    with pytest.raises(RuntimeError, match="head_partial_fused"):
        tdf.decode_head_partial(norm, out, x, 17)
    with pytest.raises(ValueError):
        tdf.decode_head_partial(norm, {"w": out["w"][:64].contiguous()}, x, 5)
    assert torch.isfinite(decode_head(norm, out, x, 16)[0]).all()
    with pytest.raises(RuntimeError, match="head_fused"):
        decode_head(norm, out, x, 17)
    with pytest.raises(RuntimeError, match="head_fused"):
        decode_head(norm, {"w": out["w"][:, :4].contiguous()}, x, 5)  # a top-K past V
    with pytest.raises(ValueError):
        decode_head(norm, {"w": out["w"][:64].contiguous()}, x, 5)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_fused_int8_on_grid_equals_f32(dev, wide_params, bf16):
    """On weights that sit on the int8 grid, the int8 route of fused K5 and
    K4 gives the f32 route's bits: the same tiles, the same order, and
    float(q) * s is the f32 weight exactly."""
    pos = 30
    f32 = _fused_state(wide_params, WIDE, 16, 5, pos, np.random.RandomState(9), dev, False,
                       bf16, 89, snap=True)
    q8 = _fused_state(wide_params, WIDE, 16, 5, pos, np.random.RandomState(9), dev, True,
                      bf16, 89, snap=True)
    x = _randn(np.random.RandomState(10), 80, WIDE.dim_model, dev=dev)
    (y_f, c_f), (y_q, c_q) = (_k5(s[0], s[1], x, pos, s[3], 5, s[5], s[4]) for s in (f32, q8))
    assert torch.equal(y_f, y_q) and torch.equal(c_f.self_k, c_q.self_k)
    outs = [_k4(s[0], wide_params, WIDE, s[1], s[2], s[3], s[4], s[5], pos + 1, 5)
            for s in (f32, q8)]
    for a, b in zip(outs[0][0] + (outs[0][1].self_v,), outs[1][0] + (outs[1][1].self_v,)):
        assert torch.equal(a, b)


def test_fused_partials_summed_in_split_order(dev, params):
    """w_2's split partials are 2^24, 1 and -2^24 (h = relu(b_1) = 1, w_1 =
    0, one nonzero row of w_2 in each of its first three 64-deep slices):
    summed in split order they give 0, so the layer's output equals the one
    with w_2 = 0 bit for bit; any other order gives 1 somewhere."""
    _, pg = params
    rng = np.random.RandomState(11)
    dec, cache, _, anc, maskk, mem_mask = _fused_state(pg, CFG, 3, 3, 6, rng, dev)
    lp = dec["layers"][1]
    ffn = lp["pos_ffn"]
    D, FF, kc = CFG.dim_model, CFG.dim_feedforward, tdf.FUSED_KC
    assert FF >= 3 * kc
    w2 = torch.zeros((FF, D), device=dev)
    w2[0], w2[kc], w2[2 * kc] = 2.0 ** 24, 1.0, -(2.0 ** 24)
    base = {**ffn, "w_1": {"w": torch.zeros_like(ffn["w_1"]["w"]),
                           "b": torch.ones_like(ffn["w_1"]["b"])},
            "w_2": {"w": torch.zeros_like(w2), "b": torch.zeros_like(ffn["w_2"]["b"])}}
    x = _randn(rng, 9, D, dev=dev)
    ys = []
    for w in (base["w_2"]["w"], w2):
        layer = {**lp, "pos_ffn": {**base, "w_2": {"w": w, "b": base["w_2"]["b"]}}}
        d = {**dec, "layers": [dec["layers"][0], layer]}
        ys.append(_k5(d, cache, x, 6, anc, 3, mem_mask, maskk)[0])
    assert torch.equal(ys[0], ys[1])


@pytest.mark.parametrize("step", ["K5", "K4"])
def test_fused_launches_at_growing_and_shrinking_shared_memory(dev, wide_params, step):
    """int8 weights, f32 caches, at 800 memory rows (the attention staging,
    8 x (64 + 3 x 800) floats, sets the shared memory, past the product
    stages), then 40 rows, then 800 again: every launch goes through (the
    shared memory limit is one value per kernel) and matches the plain
    version."""
    for Lk in (800, 40, 800):
        rng = np.random.RandomState(9000 + Lk)
        pos = 10
        dec, cache, preds, anc, maskk, mem_mask = _fused_state(wide_params, WIDE, 2, 5, pos, rng,
                                                               dev, True, False, Lk)
        if step == "K5":
            x = _randn(rng, 10, WIDE.dim_model, dev=dev)
            y, ck = _k5(dec, cache, x, pos, anc, 5, mem_mask, maskk)
            y_p, cp = _k5(dec, cache, x, pos, anc, 5, mem_mask, maskk, decoder_layer_step_plain)
            _close(y, y_p, TOL)
        else:
            _, ck, ak, _ = _k4(dec, wide_params, WIDE, cache, preds, anc, maskk, mem_mask,
                               pos + 1, 5)
            _, cp, ap, _ = _k4(dec, wide_params, WIDE, cache, preds, anc, maskk, mem_mask,
                               pos + 1, 5, decode_beam_step_plain)
            assert torch.equal(ak, ap)
        for a, b in ((ck.self_k, cp.self_k), (ck.self_v, cp.self_v)):
            _close(a, b, TOL)


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
@pytest.mark.parametrize("pos", [0, 75, 159])
@pytest.mark.parametrize("Dq", [64, 128, 256])
def test_tp_step_kernels_match_plain(dev, Dq, pos, dtype):
    """K6a and K6b at a head shard of width Dq (1, 2 or 4 local heads of 64)
    with and without the residual, f32 and bf16 caches, at the first, a
    middle and the last (Lpad - 1) cache position, K = 5 rows a group over
    B = 4 (BK = 20, not a multiple of a tile's 16 rows; a fully masked self
    row and memory entry among them); K6c on the matching hidden shard,
    partial and whole. The new cache rows (K and V) within TOL of the plain
    version's (one bf16 step with bf16 caches: both round f32 rows summed
    in other orders), and nothing else of the caches touched."""
    rng = np.random.RandomState(Dq + pos)
    K, nh, D = 5, Dq // 64, 512
    ck, cv, anc, maskk, mk, mv, mem_mask, _ = _attn_state(rng, dev, dtype, K=K, Bn=4, D=Dq)
    assert pos < ck.shape[2]
    anc[pos] = torch.arange(anc.shape[1], device=dev, dtype=torch.int32) % K
    p = _tp_weights(rng, dev, Dq)
    x = _randn(rng, anc.shape[1], D, dev=dev)
    var = "bf16_launches" if dtype == BF16 else "launches"
    others = torch.ones(ck.shape[2], dtype=torch.bool, device=dev)
    others[pos] = False
    for residual in (True, False):
        before = (getattr(tdf.self_attn_step, var), getattr(tdf.cross_attn_step, var))
        ckk, cvk, ckp, cvp = ck.clone(), cv.clone(), ck.clone(), cv.clone()
        y = tdf.self_attn_step(p["decslf_attn"], x, ckk, cvk, pos, nh, anc, K, maskk, residual)
        y_p = tdf.self_attn_step_plain(p["decslf_attn"], x, ckp, cvp, pos, nh, anc, K, maskk,
                                       residual)
        assert torch.isfinite(y).all()
        _close(y, y_p, TOL)
        for a, b, c0 in ((ckk, ckp, ck), (cvk, cvp, cv)):
            assert torch.equal(a[:, :, others], c0[:, :, others])
            assert not torch.equal(a[:, :, pos], c0[:, :, pos])
            if dtype == BF16:
                _bf16_cache_close(a, b)
            else:
                _close(a, b, TOL)
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


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("L", [600, 4000])
def test_tp_attention_steps_over_long_memory(dev, L, dtype):
    """K6b over L memory rows and K6a at position L - 1 of L cache rows,
    past the ~490 rows that 8 warps' staging fits in 48 KB at d = 64: 600
    (8 warps a block in opted-in shared memory) and 4000 (fewer warps a
    block); then 96 rows and L again. Each against its plain version."""
    rng = np.random.RandomState(L)
    K, Bn, Dq, D = 5, 2, 128, 512
    nh, BK = Dq // 64, K * Bn
    p = _tp_weights(rng, dev, Dq)
    x = _randn(rng, BK, D, dev=dev)
    var = "bf16_launches" if dtype == BF16 else "launches"
    for n in (L, 96, L):
        mk, mv = (_randn(rng, Bn, n, Dq, dev=dev).to(dtype) for _ in range(2))
        mem_mask = torch.ones((n, Bn), dtype=torch.int32, device=dev)
        mem_mask[n // 3:, 1] = 0
        before = getattr(tdf.cross_attn_step, var)
        y = tdf.cross_attn_step(p["encdec_attn"], x, mk, mv, nh, K, mem_mask, True)
        assert getattr(tdf.cross_attn_step, var) == before + 1
        assert torch.isfinite(y).all()
        _close(y, tdf.cross_attn_step_plain(p["encdec_attn"], x, mk, mv, nh, K, mem_mask, True),
               TOL)
        ck, cv = (_randn(rng, K, Bn, n, Dq, dev=dev).to(dtype) for _ in range(2))
        anc = torch.from_numpy(rng.randint(0, K, (n, BK)).astype(np.int32)).to(dev)
        anc[n - 1] = torch.arange(BK, device=dev, dtype=torch.int32) % K
        maskk = torch.from_numpy((rng.rand(n, BK) < 0.8).astype(np.int32)).to(dev)
        maskk[n - 1] = 1
        ckk, cvk, ckp, cvp = ck.clone(), cv.clone(), ck.clone(), cv.clone()
        y = tdf.self_attn_step(p["decslf_attn"], x, ckk, cvk, n - 1, nh, anc, K, maskk, True)
        y_p = tdf.self_attn_step_plain(p["decslf_attn"], x, ckp, cvp, n - 1, nh, anc, K, maskk,
                                       True)
        assert torch.isfinite(y).all()
        _close(y, y_p, TOL)
        # the fused K6a stages as many attention items a block as fit: 4
        # warps at 4000 rows
        plan = tdf.fused_plan(BK, D, 0, nh, n, 0, K=K, Dq=Dq, step="self",
                              smem_max=tdf.step_smem_max("self", dtype == BF16))
        assert plan["att_warps"] == (8 if n <= 900 else 4)


def _tp_step_calls(dev, bf16, Dq=128, pos=75, Bn=16):
    """K6a and K6b (residual off, then on) and K6c (partial_tp on, then
    off) at a head and hidden shard of width Dq of the flagship (BK = 80 at
    Bn = 16): a function running them on fresh cache copies and returning
    every output and the caches."""
    rng = np.random.RandomState(400 + Dq)
    K, D = 5, 512
    ck, cv, anc, maskk, mk, mv, mem_mask, _ = _attn_state(
        rng, dev, BF16 if bf16 else torch.float32, K=K, Bn=Bn, D=Dq)
    anc[pos] = torch.arange(anc.shape[1], device=dev, dtype=torch.int32) % K
    p = _tp_weights(rng, dev, Dq)
    x = _randn(rng, anc.shape[1], D, dev=dev)

    def run():
        c = [ck.clone(), cv.clone()]
        ys = [tdf.self_attn_step(p["decslf_attn"], x, *c, pos, Dq // 64, anc, K, maskk, r)
              for r in (False, True)]
        ys += [tdf.cross_attn_step(p["encdec_attn"], x, mk, mv, Dq // 64, K, mem_mask, r)
               for r in (False, True)]
        ys += [tdf.ffn_step(p["pos_ffn"], x, partial) for partial in (True, False)]
        return ys + c

    return run


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("Dq", [128, 256])
def test_tp_steps_bit_identical_at_any_grid(dev, monkeypatch, Dq, bf16):
    """The fused K6a-c on 7 blocks, on the plan's blocks (as many as
    the largest phase has items) and on every block the card keeps resident
    (a grid asked past it is cut to it): outputs and caches bit-identical,
    the tiling and every summation order following from the shapes alone."""
    run = _tp_step_calls(dev, bf16, Dq)
    runs = []
    for grid in (7, None, 1 << 20):
        monkeypatch.setattr(tdf, "STEP_GRID", grid)
        runs.append(run())
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)


def _device_ops(fn):
    """The names of the device operations of one call of fn under
    torch.profiler. torch.profiler records no device event at all in ~1 %
    of profiles, several in a row at times; such a profile is taken again,
    up to eight times, a little later each time, and an empty list is
    returned if none records one (the callers then fail)."""
    import time

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(8):
        time.sleep(0.1 * attempt)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if ops:
            return ops
    return []


@pytest.mark.parametrize("step", ["K6a f32", "K6a bf16", "K6b f32", "K6b bf16", "K6c"])
def test_tp_steps_one_device_kernel_per_call(dev, step):
    """After a warm-up call (the plan and the tile table cached), a call of
    self_attn_step, cross_attn_step or ffn_step is one device operation under
    torch.profiler: its decode_fused.cu kernel. A profile that records no
    device operation is taken again, up to eight times; if none records
    one, the test fails."""
    rng = np.random.RandomState(41)
    K, Dq, D, pos = 5, 128, 512, 30
    ck, cv, anc, maskk, mk, mv, mem_mask, _ = _attn_state(
        rng, dev, BF16 if step.endswith("bf16") else torch.float32, K=K, Bn=16, D=Dq)
    anc[pos] = torch.arange(anc.shape[1], device=dev, dtype=torch.int32) % K
    p = _tp_weights(rng, dev, Dq)
    x = _randn(rng, anc.shape[1], D, dev=dev)
    if step == "K6c":
        fn, name = lambda: tdf.ffn_step(p["pos_ffn"], x, True), "ffn_step_kernel"
    elif step.startswith("K6b"):
        fn, name = (lambda: tdf.cross_attn_step(p["encdec_attn"], x, mk, mv, 2, K, mem_mask,
                                                False), "cross_step_kernel")
    else:
        fn, name = (lambda: tdf.self_attn_step(p["decslf_attn"], x, ck, cv, pos, 2, anc, K,
                                               maskk, False), "self_step_kernel")
    fn()
    ops = _device_ops(fn)
    assert len(ops) == 1 and name in ops[0], ops


def test_tp_steps_refuse_what_they_cannot_run(dev):
    """No fallback: int8 weights, a cache or a memory whose groups do not
    fit the rows, a weight of another shape, and a position past the cache
    raise before a launch; a shape the kernel refuses (a head width not a
    multiple of 8) raises from the launch."""
    rng = np.random.RandomState(42)
    K, Dq, D = 5, 128, 512
    ck, cv, anc, maskk, mk, mv, mem_mask, _ = _attn_state(rng, dev, torch.float32, K=K, Bn=3,
                                                          D=Dq)
    p = _tp_weights(rng, dev, Dq)
    x = _randn(rng, anc.shape[1], D, dev=dev)
    sa = p["decslf_attn"]
    step = lambda prm, c=ck, pos=3, nh=2: tdf.self_attn_step(prm, x, c, cv, pos, nh, anc, K,
                                                             maskk, False)
    q8 = {**sa, "w_qs": {"w": sa["w_qs"]["w"].to(torch.int8)}}
    with pytest.raises(ValueError):
        step(q8)
    with pytest.raises(ValueError):
        step(sa, c=ck[:, :1].contiguous())
    with pytest.raises(ValueError):
        step({**sa, "fc": {"w": sa["fc"]["w"][:64]}})
    with pytest.raises(ValueError):
        step(sa, pos=ck.shape[2])
    assert torch.isfinite(step(sa, nh=16)).all()  # 16 heads of 8 columns run
    with pytest.raises(RuntimeError, match="self_attn_step_fused"):
        step(sa, nh=32)  # heads of 4 columns: refused by the kernel
    ca = p["encdec_attn"]
    with pytest.raises(ValueError):  # memory of 2 batch entries for 3
        tdf.cross_attn_step(ca, x, mk[:2].contiguous(), mv[:2].contiguous(), 2, K,
                            mem_mask[:, :2].contiguous())
    with pytest.raises(ValueError):
        tdf.cross_attn_step({**ca, "w_qs": {"w": ca["w_qs"]["w"][:, :64].contiguous()}}, x, mk,
                            mv, 2, K, mem_mask)
    ff = p["pos_ffn"]
    with pytest.raises(ValueError):
        tdf.ffn_step({**ff, "w_2": {"w": ff["w_2"]["w"][:, :64].contiguous(),
                                    "b": ff["w_2"]["b"]}}, x)


@pytest.mark.parametrize("topk", [1, 5, 16])
@pytest.mark.parametrize("v_local", [7, 50, 7500, 15000])
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


def _k7c_calls(dev, v_local, BK=80, D=512):
    """K7c on one vocabulary shard of v_local ids at the flagship's width,
    without and with gather ids (in the shard, above and below it): a
    function returning every output of both calls."""
    rng = np.random.RandomState(600 + v_local)
    norm = {"scale": 1 + 0.1 * _randn(rng, D, dev=dev), "bias": 0.1 * _randn(rng, D, dev=dev)}
    out = {"w": _randn(rng, D, v_local, dev=dev) / D ** 0.5}
    x = _randn(rng, BK, D, dev=dev)
    gid = torch.from_numpy(rng.randint(-v_local, 2 * v_local, BK).astype(np.int32)).to(dev)
    return lambda: (tdf.decode_head_partial(norm, out, x, 5)
                    + tdf.decode_head_partial(norm, out, x, 5, gid))


@pytest.mark.parametrize("v_local", [50, 15000])
def test_head_partial_bit_identical_at_any_grid(dev, monkeypatch, v_local):
    """The fused K7c on 7 blocks, on the plan's blocks and on every block
    the card keeps resident (a grid asked past it is cut to it): every
    output bit-identical."""
    run = _k7c_calls(dev, v_local)
    runs = []
    for grid in (7, None, 1 << 20):
        monkeypatch.setattr(tdf, "STEP_GRID", grid)
        runs.append(run())
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)


@pytest.mark.parametrize("v_local", [40, 3000])
def test_head_partial_resolves_ties_to_the_lowest_id(dev, v_local):
    """K7c (and with it the head top-K K3 and K4 run) on exact ties, every
    column repeated 8 ids later: raw top-K ids the plain version's, the
    lowest copy first, across threads and within one thread's scan."""
    rng = np.random.RandomState(700 + v_local)
    norm, out = _head_params(rng, v_local, dev, ties=True)
    x = _randn(rng, 6, CFG.dim_model, dev=dev)
    got = tdf.decode_head_partial(norm, out, x, 4)
    ref = tdf.decode_head_partial_plain(norm, out, x, 4)
    assert torch.equal(got[1], ref[1])
    assert (got[1][:, 1:] - got[1][:, :-1] == 8).all()
    _close(got[0], ref[0], 1e-5)


def _k7_calls(dev, BK, V, D=512):
    """K7 at the flagship's width over V ids, without and with gather ids
    (0 and V - 1 among them): a function returning every output of both."""
    rng = np.random.RandomState(800 + BK + V)
    norm = {"scale": 1 + 0.1 * _randn(rng, D, dev=dev), "bias": 0.1 * _randn(rng, D, dev=dev)}
    out = {"w": _randn(rng, D, V, dev=dev) / D ** 0.5}
    x = _randn(rng, BK, D, dev=dev)
    gid = torch.from_numpy(rng.randint(0, V, BK).astype(np.int32)).to(dev)
    gid[0], gid[-1] = V - 1, 0
    topk = 1 if BK == 16 else 5
    return lambda: decode_head(norm, out, x, topk) + decode_head_gather(norm, out, x, topk, gid)


@pytest.mark.parametrize("BK", [16, 80])
@pytest.mark.parametrize("V", [200, 30000])
def test_head_bit_identical_at_any_grid(dev, monkeypatch, V, BK):
    """K7 on 7 blocks, on the plan's blocks and on every block the card
    keeps resident (a grid asked past it is cut to it): every output of
    decode_head and decode_head_gather bit-identical, at the model's 200
    ids (one slice a row) and at 30 000 (15 slices merged)."""
    run = _k7_calls(dev, BK, V)
    runs = []
    for grid in (7, None, 1 << 20):
        monkeypatch.setattr(tdf, "STEP_GRID", grid)
        runs.append(run())
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)


@pytest.mark.parametrize("route", ["K3 f32", "K3 gather", "K3 int8+bf16", "K7c",
                                   "K7c gather", "K7a", "K7a gather"])
def test_chain_and_head_partial_one_device_kernel_per_call(dev, wide_params, route):
    """After a warm-up call, a call of decode_chain_step_flash (every
    variant, with and without gather ids), of decode_head_partial, or of
    decode_head and decode_head_gather (the universal beam's 80 rows, dev
    eval's 16 at top-1) is one device operation under torch.profiler: its
    decode_chain.cu kernel. A profile that records no device operation is
    taken again, up to eight times; if none records one, the test fails."""
    rng = np.random.RandomState(13000)
    if route.startswith("K7a"):
        norm, out = wide_params["dec_tgt"]["norm"], wide_params["out_tgt"]
        if route.endswith("gather"):
            x = _randn(rng, 16, WIDE.dim_model, dev=dev)
            gid = torch.arange(16, device=dev, dtype=torch.int32)
            fn = lambda: decode_head_gather(norm, out, x, 1, gid)
        else:
            x = _randn(rng, 80, WIDE.dim_model, dev=dev)
            fn = lambda: decode_head(norm, out, x, 5)
        name = "head_full_kernel"
    elif route.startswith("K7c"):
        norm = wide_params["dec_tgt"]["norm"]
        out = {"w": wide_params["out_tgt"]["w"][:, :50].contiguous()}
        x = _randn(rng, 80, WIDE.dim_model, dev=dev)
        gid = torch.arange(80, device=dev, dtype=torch.int32) - 10
        fn = lambda: tdf.decode_head_partial(norm, out, x, 5, gid if "gather" in route else None)
        name = "head_step_kernel"
    else:
        both = route.endswith("int8+bf16")
        K = 1 if route.endswith("gather") else 5
        dec, cache, _, anc, maskk, mem_mask = _fused_state(wide_params, WIDE, 16, K, 30, rng,
                                                           dev, both, both, 89)
        x = _randn(rng, 16 * K, WIDE.dim_model, dev=dev)
        gid = torch.arange(16, device=dev, dtype=torch.int32) if K == 1 else None
        stacked = stack_decoder_layers(dec)
        fn = lambda: decode_chain_step_flash(
            stacked, dec["norm"], wide_params["out_tgt"], x, cache.self_k, cache.self_v,
            cache.mem_k, cache.mem_v, 30, WIDE.num_heads, anc, K, mem_mask, maskk, K + 1,
            gather_ids=gid)
        name = "chain_kernel"
    fn()
    ops = _device_ops(fn)
    assert len(ops) == 1 and name in ops[0], ops


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


# ---------------------------------------------------------------------------
# the fused K2 and K9 (csrc/las_fused.cu)
# ---------------------------------------------------------------------------

# K2's embeddings are unbounded FFN outputs fed back through the steps, at
# the flagship's widths summed over ~1000-term products in another order
# than the plain version's (chip_smoke.py holds K2 at the same 1e-3)
TOL_K2 = 1e-3


def _las_cfg(V, nl):
    """The flagship's LAS decoder widths (bench.py): E 200, 2Ha = Hd = Hs =
    512; V source ids and nl decoder LSTMs."""
    return dataclasses.replace(CFG, enc_vocab_size=V, enc_embedding_size=200,
                               acous_hidden_size=256, dim_model=512, num_unilstm_dec=nl)


@pytest.fixture(scope="module")
def las_decoders(dev):
    """(cfg, LAS decoder params on the card) by (V, nl), made once each."""
    made = {}

    def get(V, nl):
        if (V, nl) not in made:
            cfg = _las_cfg(V, nl)
            made[V, nl] = cfg, params_to(
                las_decoder_init(torch.Generator().manual_seed(V + nl), cfg), dev)
        return made[V, nl]
    return get


def _k2_args(dec, cfg, Bn, Tk, n, rng, dev):
    """K2's arguments on uniform keys, every row's lens_k < Tk (one row of
    a single key), and int32 reference ids."""
    acous = torch.from_numpy(rng.uniform(-1, 1, (Bn, Tk, 2 * cfg.acous_hidden_size))
                             .astype(np.float32)).to(dev)
    wk = precompute_keys(dec["acous_att"], acous, "bilinear")["wk"]
    lens = torch.from_numpy(rng.randint(max(1, Tk // 2), Tk, size=Bn)).to(dev)
    lens[-1] = 1
    refs = torch.from_numpy(rng.randint(0, cfg.enc_vocab_size, (Bn, n)).astype(np.int32)).to(dev)
    return (dec, cfg, wk, acous, lens, torch.full((Bn,), BOS, device=dev), n), refs


def _k2_against_plain(args, refs, tol):
    """K2 against las_greedy_plain on the card: a row's symbols may part
    only where the plain arm's own log-probs of the two symbols tie within
    TOL; embeddings and picked values within tol up to there."""
    before = las_greedy_flash.launches
    embs, preds, picked = las_greedy_flash(*args, ref_tokens=refs)
    assert las_greedy_flash.launches == before + 1
    embs_p, preds_p, picked_p = las_greedy_plain(*args, ref_tokens=refs)
    at_k = las_greedy_plain(*args, ref_tokens=preds)[2]
    at_p = las_greedy_plain(*args, ref_tokens=preds_p)[2]
    assert preds.dtype == torch.int64 and torch.isfinite(embs).all()
    for r in range(preds.shape[0]):
        d = (preds[r] != preds_p[r]).nonzero()
        end = int(d[0]) + 1 if len(d) else preds.shape[1]
        _close(embs[r, :end], embs_p[r, :end], tol)
        _close(picked[r, :end], picked_p[r, :end], tol)
        if len(d):
            assert float(at_p[r, end - 1] - at_k[r, end - 1]) <= TOL, (r, end)
    return embs, preds, picked


@pytest.mark.parametrize("Bn,Tk,V,nl,n", [
    (16, 188, 30000, 3, 6), (1, 37, 32, 1, 3), (16, 3000, 32, 3, 4), (3, 37, 30000, 4, 2),
    (1, 188, 30000, 3, 4)])
def test_las_greedy_fused_matches_plain(dev, las_decoders, Bn, Tk, V, nl, n):
    """The fused K2 at the flagship's widths: B 1 and 16, 37 to 3000 keys,
    32 and 30 000 ids, 1, 3 and 4 decoder LSTMs."""
    cfg, dec = las_decoders(V, nl)
    args, refs = _k2_args(dec, cfg, Bn, Tk, n, np.random.RandomState(Bn + Tk + V + nl), dev)
    _k2_against_plain(args, refs, TOL_K2)


@pytest.mark.parametrize("forced", ["tie", "pad"])
def test_las_greedy_fused_ties_and_pad(dev, las_decoders, forced):
    """Head columns 3, 5 and 200 equal and far above the rest: the kernel
    picks 3 (lowest index, within a 128-id tile and across tiles), and the
    tied ids' embedding rows are equal so both arms go on alike. Or PAD far
    above the rest: every step feeds PAD back, whose embedding row (random
    here) must read 0."""
    cfg, base = las_decoders(300, 3)
    table = base["embedder"].clone()
    w, b = base["acous_out"]["w"].clone(), base["acous_out"]["b"].clone()
    table[PAD] = _randn(np.random.RandomState(1), table.shape[1], dev=dev)
    if forced == "tie":
        w[:, 5] = w[:, 200] = w[:, 3]
        b[3] = b[5] = b[200] = 50.0
        table[5] = table[200] = table[3]
        want = 3
    else:
        b[PAD] = 50.0
        want = PAD
    dec = {**base, "embedder": table, "acous_out": {"w": w, "b": b}}
    args, refs = _k2_args(dec, cfg, 4, 37, 5, np.random.RandomState(2), dev)
    _, preds, _ = _k2_against_plain(args, refs, TOL_K2)
    assert bool((preds == want).all()), preds


def _k9_args(dec, S, Bn, Tk, rng, dev, use_masks=True):
    """K9's forward and backward arguments at the decoder's widths, as
    chip_smoke.py makes them: pre0 from random ids, uniform keys, lens_k <
    Tk, dropout masks (keep 0.8) or none, a random head cotangent."""
    Hd, E = dec["dec_l1"]["w_hh"].shape[0], dec["embedder"].shape[1]
    Ha2 = dec["acous_ffn"]["w"].shape[0] - Hd
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    w = k9.scan_weights(*(dec[k][nm] for k, nm in (
        ("dec_l0", "w_ih"), ("dec_l0", "w_hh"), ("dec_l1", "w_ih"), ("dec_l1", "w_hh"),
        ("dec_l1", "b_ih"), ("dec_l1", "b_hh"), ("dec_l2", "w_ih"), ("dec_l2", "w_hh"),
        ("dec_l2", "b_ih"), ("dec_l2", "b_hh"))), dec["acous_ffn"]["w"], pack=True)
    ids = torch.from_numpy(rng.randint(5, dec["embedder"].shape[0], (S, Bn))).to(dev)
    p0 = dec["dec_l0"]
    pre0 = (dec["embedder"][ids] @ p0["w_ih"][:E] + p0["b_ih"] + p0["b_hh"]).contiguous()
    acous = t(rng.uniform(-1, 1, (Bn, Tk, Ha2)))
    wk = (acous @ dec["acous_att"]["linear_att_w"]["w"]).contiguous()
    lens = torch.from_numpy(rng.randint(max(1, Tk // 2), Tk, size=Bn)).to(dev)
    masks = None
    if use_masks:
        masks = k9.Masks(t((rng.rand(S, 3, Bn, Hd) < 0.8) / 0.8),
                         t((rng.rand(S, Bn, Ha2) < 0.8) / 0.8))
    return (w, pre0, wk, acous, lens, masks), t(rng.randn(S, Bn, dec["acous_ffn"]["w"].shape[1]))


def _k9_against_plain(fargs, g):
    """K9 forward and backward against their plain versions on the card,
    every stream within TOL of its scale; returns both kernels' outputs."""
    before = (k9.las_tf_fwd.launches, k9.las_tf_bwd.launches)
    st, st_p = k9.las_tf_fwd(*fargs), k9.las_tf_fwd_plain(*fargs)
    for a, b in zip(st, st_p):
        _close_rel(a, b)
    w, _, wk, acous, _, masks = fargs
    bargs = (w, st_p, g, wk, acous, masks)
    back = k9.las_tf_bwd(*bargs)
    for a, b in zip(back, k9.las_tf_bwd_plain(*bargs)):
        _close_rel(a, b)
    assert (k9.las_tf_fwd.launches, k9.las_tf_bwd.launches) == (before[0] + 1, before[1] + 1)
    return tuple(st) + tuple(back)


@pytest.mark.parametrize("use_masks", [False, True])
def test_las_tf_fused_matches_plain_at_flagship_widths(dev, las_decoders, use_masks):
    """K9 forward and backward at the flagship's widths, B 16 and 188
    keys, with and without dropout masks."""
    _, dec = las_decoders(32, 3)
    fargs, g = _k9_args(dec, 8, 16, 188, np.random.RandomState(20 + use_masks), dev, use_masks)
    _k9_against_plain(fargs, g)


@pytest.mark.parametrize("step", ["K2", "K9"])
def test_las_fused_bit_identical_at_two_grid_sizes(dev, las_decoders, monkeypatch, step):
    """The same inputs on every block the card keeps resident and on 7
    blocks: every output bit-identical (the item table and every summation
    order follow from the shapes alone; a ticket only picks which block
    merges)."""
    runs = []
    for grid in (0, 7):
        monkeypatch.setattr(k2, "LAS_GRID", grid)
        rng = np.random.RandomState(30)
        if step == "K2":
            cfg, dec = las_decoders(30000, 3)
            args, refs = _k2_args(dec, cfg, 16, 188, 4, rng, dev)
            runs.append(las_greedy_flash(*args, ref_tokens=refs))
        else:
            _, dec = las_decoders(32, 3)
            fargs, g = _k9_args(dec, 4, 16, 188, rng, dev)
            st = k9.las_tf_fwd(*fargs)
            runs.append(tuple(st) + k9.las_tf_bwd(fargs[0], st, g, *fargs[2:4], fargs[5]))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_las_fused_launches_at_alternating_key_lengths(dev, las_decoders):
    """K2 and K9 at 3000, then 37, then 3000 keys: every launch goes
    through (one shared memory limit a kernel) and matches its plain
    version."""
    for Tk in (3000, 37, 3000):
        rng = np.random.RandomState(Tk)
        cfg, dec = las_decoders(32, 3)
        args, refs = _k2_args(dec, cfg, 2, Tk, 2, rng, dev)
        _k2_against_plain(args, refs, TOL_K2)
        fargs, g = _k9_args(dec, 3, 2, Tk, rng, dev)
        _k9_against_plain(fargs, g)


@pytest.mark.parametrize("route", ["K2", "K9 fwd", "K9 bwd"])
def test_las_fused_one_device_kernel_per_call(dev, las_decoders, route):
    """After a warm-up call (the packed weights and the item table cached),
    a call of las_greedy_flash, las_tf_fwd or las_tf_bwd is one device
    operation under torch.profiler: its las_fused.cu kernel (an empty
    profile taken again, as `_device_ops` does)."""
    rng = np.random.RandomState(40)
    if route == "K2":
        cfg, dec = las_decoders(30000, 3)
        args, refs = _k2_args(dec, cfg, 16, 188, 3, rng, dev)
        fn, name = lambda: las_greedy_flash(*args, ref_tokens=refs), "greedy_kernel"
    else:
        _, dec = las_decoders(32, 3)
        fargs, g = _k9_args(dec, 3, 16, 188, rng, dev)
        st = k9.las_tf_fwd(*fargs)
        if route == "K9 fwd":
            fn, name = lambda: k9.las_tf_fwd(*fargs), "tf_fwd_kernel"
        else:
            fn, name = (lambda: k9.las_tf_bwd(fargs[0], st, g, *fargs[2:4], fargs[5]),
                        "tf_bwd_kernel")
    fn()
    ops = _device_ops(fn)
    assert len(ops) == 1 and name in ops[0], ops


def test_las_fused_partials_summed_in_warp_order(dev, params):
    """K9 backward's first product, dcell @ W_ffn^T, at one step: the
    cotangent is 1 at columns 0, 32 and 64 of dcell, which three warps of
    a narrow item take, and W_ffn's columns there are 2^24, 1 and -2^24, so
    the warps' partials summed in warp order give exactly 0 for every dctx
    entry; any other order gives 1 somewhere."""
    pc, _ = params
    dec = pc["las"]["decoder"]
    rng = np.random.RandomState(50)
    Hd, Ha2 = CFG.dim_model, 2 * CFG.acous_hidden_size
    ffn = torch.zeros_like(dec["acous_ffn"]["w"])
    ffn[:, 0], ffn[:, 32], ffn[:, 64] = 2.0 ** 24, 1.0, -(2.0 ** 24)
    w = k9.scan_weights(*(dec[k][nm].to(dev) for k, nm in (
        ("dec_l0", "w_ih"), ("dec_l0", "w_hh"), ("dec_l1", "w_ih"), ("dec_l1", "w_hh"),
        ("dec_l1", "b_ih"), ("dec_l1", "b_hh"), ("dec_l2", "w_ih"), ("dec_l2", "w_hh"),
        ("dec_l2", "b_ih"), ("dec_l2", "b_hh"))), ffn.to(dev), pack=True)
    Bn, Tk = 3, 9
    pre0 = _randn(rng, 1, Bn, 4 * Hd, dev=dev)
    acous = _randn(rng, Bn, Tk, Ha2, dev=dev)
    wk = (acous @ dec["acous_att"]["linear_att_w"]["w"].to(dev)).contiguous()
    st = k9.las_tf_fwd(w, pre0, wk, acous, torch.full((Bn,), Tk, device=dev), None)
    g = torch.zeros((1, Bn, ffn.shape[1]), device=dev)
    g[..., 0] = g[..., 32] = g[..., 64] = 1.0
    dctx = k9.las_tf_bwd(w, st, g, wk, acous, None)[2]
    assert torch.equal(dctx, torch.zeros_like(dctx)), dctx.abs().max()


# ----------------------------------------------------------------------
# the train entry point's data path and window on the card
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def train_corpus(dev, tmp_path_factory):
    from tests.data_factory import make_corpus

    return make_corpus(str(tmp_path_factory.mktemp("corpus")), n_sent=32)


def _train_dataset(corpus):
    from stjep_tpu_torch.data.dataset import Dataset

    return Dataset(path_src=corpus["path_src"], path_tgt=corpus["path_tgt"],
                   path_vocab_src=corpus["path_vocab_src"],
                   path_vocab_tgt=corpus["path_vocab_tgt"], acous_path=corpus["acous_path"],
                   acous_norm_path=corpus["acous_norm_path"], acous_norm=True,
                   max_seq_len_src=12, max_seq_len_tgt=16, batch_size=8, use_type="char",
                   mode="ST", seed=5)


def _train_cfg(corpus):
    return dataclasses.replace(CFG, enc_vocab_size=corpus["vocab_src_size"],
                               dec_vocab_size=corpus["vocab_tgt_size"],
                               acous_dim=corpus["acous_dim"])


@pytest.mark.parametrize("feat_dtype", ["float32", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_features_on_card_matches_numpy(dev, train_corpus, feat_dtype, dtype):
    """The resident corpus on the card and a minibatch gathered from it,
    dequantized into the compute dtype, against numpy on the host copy of
    the same features: q * scale with the scale in the compute dtype, the
    product exact in f32 (8-bit q times an f32 or bf16 scale) and rounded
    once to the compute dtype, as the card's multiply rounds it."""
    from stjep_tpu_torch.data.device_cache import DeviceFeatureCache, gather_features

    ds = _train_dataset(train_corpus)
    cache = DeviceFeatureCache.build(ds, 64, feat_dtype, device=dev)
    assert cache.feats.is_cuda and cache.feats.dtype == (torch.int8 if feat_dtype == "int8"
                                                         else torch.float32)
    idx = np.array([5, 0, 17, 5, 3], np.int32)
    got = gather_features(cache.arrays, torch.from_numpy(idx).to(dev), 40, dtype)
    assert got.is_cuda and got.dtype == dtype and tuple(got.shape) == (5, 40, 8)
    feats = cache.feats.cpu().numpy()[idx, :40].astype(np.float32)
    if feat_dtype == "int8":
        scale = cache.scale.cpu()[idx].to(dtype).float().numpy()
        feats = feats * scale[:, None, None]
    want = torch.from_numpy(feats).to(dtype).float().numpy()
    np.testing.assert_array_equal(got.float().cpu().numpy(), want)


def test_train_window_no_host_sync_and_equals_single_steps(dev, train_corpus, tmp_path):
    """4-step windows on the int8 device cache: every step of the windowed
    run (after the single-step run has built the tables the kernels keep a
    shape) runs under torch.cuda.set_sync_debug_mode("error") (a host read
    inside raises), and the params after 2 windows equal 8 single steps
    (dropout on: the generator splits are the same) within 1e-6 of each
    leaf's norm."""
    from stjep_tpu_torch.train import trainer as T

    cfg = dataclasses.replace(_train_cfg(train_corpus), dropout=0.2, spec_aug=True)
    train_batch = T.Trainer._train_batch

    def strict(self, *a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return train_batch(self, *a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    finals = {}
    for win in (1, 4):
        t = T.Trainer_ASR_ST(expt_dir=str(tmp_path / f"w{win}"), batch_size=8,
                             learning_rate=1e-3, learning_rate_init=1e-3, lr_warmup_steps=0,
                             seed=3, print_every=10 ** 9, checkpoint_every=10 ** 9,
                             device_cache=True, feat_dtype="int8", train_window=win,
                             device=dev)
        if win == 4:
            t._train_batch = strict.__get__(t)
        params = init_seq2seq(cfg, torch.Generator().manual_seed(1), device=dev)
        _, finals[win] = t.train({"st": _train_dataset(train_corpus)}, (cfg, params),
                                 num_epochs=2)
        assert t.steps_run == 8 and t.windows_run == (2 if win == 4 else 0)
    from stjep_tpu_torch.bridge import named_leaves

    for (name, a), b in zip(named_leaves(finals[1]), leaves(finals[4])):
        a, b = a.detach(), b.detach()
        err = float((a - b).norm() / max(float(a.norm()), 1e-12))
        assert err <= 1e-6, (name, err)


def test_native_loader_built_and_used_by_the_trainer(dev, train_corpus, tmp_path):
    """The fastloader builds with the host compiler and loads every batch
    of an epoch with per-step staging; the K8 and K9 kernels train."""
    from stjep_tpu_torch.data.loader import NativeLoader, get_native_loader, library_path
    from stjep_tpu_torch.train.trainer import Trainer_ASR_ST

    assert get_native_loader() is not None and library_path().exists()
    calls, fwd = NativeLoader.calls, k8.bilstm_fwd_save.launches
    k9_fwd = k9.las_tf_fwd.launches
    t = Trainer_ASR_ST(expt_dir=str(tmp_path / "n"), batch_size=8, learning_rate=1e-3,
                       learning_rate_init=1e-3, lr_warmup_steps=0, device_cache=False,
                       device=dev)
    cfg = _train_cfg(train_corpus)
    t.train({"st": _train_dataset(train_corpus)},
            (cfg, init_seq2seq(cfg, torch.Generator().manual_seed(2), device=dev)), num_epochs=1)
    assert NativeLoader.calls - calls == t.steps_run == 4
    assert k8.bilstm_fwd_save.launches > fwd and k9.las_tf_fwd.launches > k9_fwd


def test_bf16_train_step_on_card(dev, train_corpus):
    """bf16 params through K8's and K9's f32 kernels (cast at their
    boundary): bf16 gradients for every leaf, finite losses, both kernels
    launched forward and backward, and the loss within 2e-2 of the same
    step on CPU copies (bf16 rounds differently on the two devices)."""
    from stjep_tpu_torch.bridge import params_to as to
    from stjep_tpu_torch.train.trainer import compute_grads

    cfg = _train_cfg(train_corpus)
    p_cpu = init_seq2seq(cfg, torch.Generator().manual_seed(4), dtype=torch.bfloat16)
    p_dev = to(p_cpu, dev)
    rng = np.random.RandomState(4)
    mb = {"srcid": torch.from_numpy(rng.randint(5, cfg.enc_vocab_size, (4, 12))),
          "tgtid": torch.from_numpy(rng.randint(5, cfg.dec_vocab_size, (4, 16))),
          "acous_feat": _randn(rng, 4, 48, 8).to(torch.bfloat16),
          "acouslen": torch.tensor([48, 40, 17, 9])}
    mb["srcid"][:, 0] = mb["tgtid"][:, 0] = BOS
    before = (k8.bilstm_bwd.launches, k9.las_tf_bwd.launches)
    out = {}
    for name, p in (("card", p_dev), ("cpu", p_cpu)):
        d = next(iter(leaves(p))).device
        losses, grads = compute_grads(cfg, "ASR_ST", p, [{k: v.to(d) for k, v in mb.items()}],
                                      torch.Generator().manual_seed(0), is_training=False)
        assert all(g.dtype == torch.bfloat16 for g in grads)
        out[name] = float(losses["nll_loss_en"] + losses["nll_loss_de"])
    assert k8.bilstm_bwd.launches > before[0] and k9.las_tf_bwd.launches > before[1]
    assert np.isfinite(out["card"])
    assert abs(out["card"] - out["cpu"]) <= 2e-2 * abs(out["cpu"]), out


# --------------------------------------------------------------------------
# the translate entry point: modes MT / ST_BASE / refen, LM fusion, the CLI
# --------------------------------------------------------------------------


def _translate_inputs(seed=3):
    rng = np.random.RandomState(seed)
    src = torch.from_numpy(rng.randint(5, CFG.enc_vocab_size, (B, CFG.max_seq_len_src)))
    src[:, 0] = BOS
    src[1, 7:] = PAD
    return dict(acous_feats=_randn(rng, B, 64, CFG.acous_dim),
                acous_lens=torch.tensor([64, 29, 47]), src=src)


@pytest.mark.parametrize("mode,refen", [("MT", False), ("ST_BASE", False), ("ASR", True),
                                        ("ST", True)],
                         ids=["MT", "ST_BASE", "ASR-REF", "ST-REF"])
def test_translate_modes_match_cpu(dev, params, mode, refen):
    """forward_translate in the modes this slice ports, on the card (K9's
    forward in the refen modes, K1-K4) against CPU copies: the same tokens."""
    p_cpu, p_dev = params
    rng = np.random.RandomState(1)
    ave = torch.from_numpy(rng.randn(CFG.dim_model).astype(np.float32))
    p_cpu, p_dev = {**p_cpu, "emb_dyn_ave": ave}, {**p_dev, "emb_dyn_ave": ave.to(dev)}
    x = _translate_inputs()
    before = k9.las_tf_fwd.launches
    outs = [forward_translate(p, CFG, mode, beam_width=3, max_seq_len=MAX_LEN, refen=refen,
                              device=d, **x).cpu() for p, d in ((p_dev, "cuda"), (p_cpu, "cpu"))]
    assert torch.equal(outs[0], outs[1])
    assert (k9.las_tf_fwd.launches > before) == refen


def test_lm_table_hash_and_fuser_on_card(dev):
    """The table's int64 hash on the card equals numpy's uint32 hash bit for
    bit over the whole int32 range, also both hashes in one call on keys of
    lengths 1-4 as the probe makes them, and the table fuser on the card
    equals it on CPU copies (1e-6), ties at the 10th candidate included."""
    from stjep_tpu_torch.infer import lm_table as lt

    rng = np.random.RandomState(2)
    toks = rng.randint(-2 ** 31, 2 ** 31 - 1, (4096, 4), dtype=np.int64).astype(np.int32)
    for mult, seed in ((lt._MULT1, lt._SEED1), (lt._MULT2, lt._SEED2)):
        got = lt._hash_torch(torch.from_numpy(toks).to(dev), int(mult), int(seed)).cpu().numpy()
        np.testing.assert_array_equal(got, lt._hash_np(toks, mult, seed).astype(np.int64))
    both = lt._hash_torch(torch.from_numpy(toks.reshape(4, 1024, 4)).to(dev),
                          torch.tensor([int(lt._MULT1), int(lt._MULT2)], device=dev),
                          torch.tensor([int(lt._SEED1), int(lt._SEED2)], device=dev),
                          torch.arange(1, 5, device=dev).view(4, 1)).cpu().numpy()
    for i, (mult, seed) in enumerate(((lt._MULT1, lt._SEED1), (lt._MULT2, lt._SEED2))):
        for g in range(4):
            np.testing.assert_array_equal(
                both[i, g], lt._hash_np(toks.reshape(4, 1024, 4)[g, :, 3 - g:], mult,
                                        seed).astype(np.int64))
    V = 40
    entries = {(w,): float(-rng.uniform(1, 6)) for w in range(V)}
    for _ in range(300):
        entries[tuple(int(t) for t in rng.randint(0, V, rng.randint(2, 5)))] = float(-rng.rand())
    backoffs = {k[:-1]: float(-rng.rand()) for k in entries if len(k) > 1}
    fusers = [lt.make_table_fuser(lt.NGramTable.from_ngrams(entries, backoffs, device=d),
                                  "s-4g_0.5") for d in ("cuda", "cpu")]
    for step in range(5):
        logp = torch.log_softmax(_randn(rng, 6, V), dim=-1)
        logp[0, 3] = logp[0, 7] = logp[0].topk(10).values[-1]
        ctx = torch.from_numpy(rng.randint(0, V, (6, 3)))
        on_card = fusers[0](logp.to(dev), ctx.to(dev), step).cpu()
        _close(on_card, fusers[1](logp, ctx, step), 1e-6)


def test_lm_fused_asr_on_card_matches_cpu(dev, params):
    """An LM-fused ASR decode on the card (the plain step loop; K1, no K2)
    against CPU copies, through the device table and the host fuser."""
    from stjep_tpu_torch.infer import lm_fusion, lm_table

    p_cpu, p_dev = params
    rng = np.random.RandomState(4)
    entries = {(w,): float(-rng.uniform(1, 6)) for w in range(CFG.enc_vocab_size)}
    x = _translate_inputs()
    before = (las_greedy_flash.launches, k9.las_tf_fwd.launches)
    for kind in ("table", "host"):
        outs = []
        for p, d in ((p_dev, "cuda"), (p_cpu, "cpu")):
            fuse = (lm_table.make_table_fuser(lm_table.NGramTable.from_ngrams(entries, device=d),
                                              "s-4g_0.8") if kind == "table" else
                    lm_fusion.make_ngram_fuser(
                        type("LM", (), {"logscore": lambda self, w, c: entries[(int(w),)]})(),
                        "s-4g_0.8"))
            outs.append(forward_translate(p, CFG, "ASR", device=d, lm_fuse=fuse, **x).cpu())
        assert torch.equal(outs[0], outs[1]), kind
    assert (las_greedy_flash.launches, k9.las_tf_fwd.launches) == before


def test_translate_cli_on_card_writes_the_cpu_file(dev, train_corpus, tmp_path):
    """main() of the translate CLI on the card (its default) and on the
    host, on one checkpoint: the same translate.txt; mode 3 within 1e-5."""
    from stjep_tpu_torch.cli import translate as cli
    from stjep_tpu_torch.train.checkpoint import Checkpoint

    cfg = _train_cfg(train_corpus)
    ds = _train_dataset(train_corpus)
    ckpt = Checkpoint(params=init_seq2seq(cfg, torch.Generator().manual_seed(6)),
                      input_vocab=ds.vocab_src, output_vocab=ds.vocab_tgt,
                      model_config=dataclasses.asdict(cfg)).save_customise(str(tmp_path / "ckpt"))
    c = train_corpus
    for mode, extra in (("1", ["--gen_mode", "ST", "--beam_width", "3"]), ("3", [])):
        outs = [cli.main(["--test_path_src", c["path_src"], "--test_path_tgt", c["path_tgt"],
                          "--test_acous_path", c["acous_path"], "--load", ckpt,
                          "--test_path_out", str(tmp_path / f"{mode}{d}"), "--batch_size", "8",
                          "--max_seq_len", "16", "--eval_mode", mode, *extra], **kw)
                for d, kw in (("card", {}), ("cpu", {"device": "cpu"}))]
        if mode == "1":
            lines = [open(o, encoding="utf8").read() for o in outs]
            assert lines[0] == lines[1] and lines[0].count("\n") == 32
        else:
            _close(*(torch.from_numpy(np.load(o)) for o in outs), 1e-5)


# ---------------------------------------------------------------------------
# The quality runs' and the staged recipe's widths (NARROW: head widths 8
# and 32, acoustic hidden sizes 16, 6 and 64, vocabularies of 15 to 21
# ids). K1 and K8
# run them in SWEEPS, K4 and K5 in the fused cases; here K2, K9, K3, K7 and
# the routes that chain them.


@pytest.mark.parametrize("refs", [True, False], ids=["refs", "free"])
@pytest.mark.parametrize("width", list(NARROW))
def test_narrow_las_greedy_kernel_matches_plain(dev, narrow, width, refs):
    cfg, _, pg = narrow[width]
    _check_las_greedy(dev, cfg, pg["las"]["decoder"], refs)


@pytest.mark.parametrize("use_masks", [False, True])
@pytest.mark.parametrize("width", list(NARROW))
def test_narrow_las_tf_kernels_match_plain(dev, narrow, width, use_masks):
    cfg, pc, _ = narrow[width]
    _check_las_tf(dev, cfg, pc, use_masks)


# (K, pos, topk, gather): the beam's first two positions, dev eval's group
# of 1 with gather ids, the last position of the quality run's 24
NARROW_K3_CASES = [(5, 0, 6, False), (5, 1, 5, False), (1, 0, 2, True), (1, 23, 1, True)]


@pytest.mark.parametrize("quant,bf16", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("K,pos,topk,gather", NARROW_K3_CASES)
@pytest.mark.parametrize("width", list(NARROW))
def test_narrow_chain_step_matches_plain(dev, narrow, width, K, pos, topk, gather, quant, bf16):
    cfg, _, pg = narrow[width]
    _check_chain_step(dev, cfg, pg, 16, K, pos, topk, gather, quant, bf16, 9,
                      13000 + 100 * K + pos)


@pytest.mark.parametrize("BK,topk", [(16, 1), (48, 5), (80, 6)])
@pytest.mark.parametrize("width", list(NARROW))
def test_narrow_head_kernels_match_plain(dev, width, BK, topk):
    """K7 and its gather variant at the narrow vocabulary (15 ids) and
    width: the universal decoder's head there."""
    cfg = NARROW[width]
    _check_head(dev, BK, cfg.dec_vocab_size, topk, False, cfg.dim_model)


@pytest.mark.parametrize("route", ["beam", "eval", "beam universal", "eval universal"])
@pytest.mark.parametrize("width", list(NARROW))
def test_narrow_routes_card_match_cpu(dev, narrow, width, route):
    """The decode routes at the narrow widths on B = 16, card against CPU
    copies: the ST beam-5 (K1, K3, K4 or the select; universal: K1, K5,
    K7, the select)
    tokens equal, and dev eval with refs (K1, K3's gather variant;
    universal: K1, K5, K7's gather variant) outputs equal (floats within
    TOL). The LAS decoder runs K2 at the kernel profile only: JAX's gate
    (`las_flash_supported`: D and 2H multiples of 128) sends the other
    widths to its XLA scan, the port's plain step loop."""
    cfg, pc, pg = narrow[width]
    gated = k2.las_flash_supported(cfg)
    assert gated == (width == "kernel")
    k2_before = las_greedy_flash.launches
    if "universal" in route:
        cfg = dataclasses.replace(cfg, transformer_type="universal")
        pc = init_seq2seq(cfg, torch.Generator().manual_seed(50), "cpu")
        pg = params_to(pc, dev)
    rng = np.random.RandomState(60)
    Bn = 16
    feats = _randn(rng, Bn, 64, cfg.acous_dim)
    lens = torch.from_numpy(rng.randint(24, 65, Bn))
    lens[0] = 64
    if route.startswith("beam"):
        # the standard decoder's megastep K4, or where it projects its
        # embeddings (the kernel profile: E 32, D 128) the general loop's select
        wrappers = ((decoder_layer_step_flash, decode_head, beam_select, bilstm_pallas)
                    if "universal" in route else
                    (bilstm_pallas, decode_chain_step_flash,
                     beam_select if cfg.dec_emb_proj_flag else decode_beam_step_flash))
        before = [w.launches for w in wrappers]
        kw = dict(acous_feats=feats, acous_lens=lens, beam_width=5,
                  max_seq_len=cfg.max_seq_len_tgt)
        out_g = forward_translate(pg, cfg, "ST", device=dev, **kw)
        assert all(w.launches > n for w, n in zip(wrappers, before))
        assert (las_greedy_flash.launches > k2_before) == gated
        out_c = forward_translate(pc, cfg, "ST", device="cpu", **kw)
        assert torch.equal(out_g.cpu(), out_c)
        return
    kw = dict(acous_feats=feats, acous_lens=lens,
              ref_src=torch.from_numpy(rng.randint(4, cfg.enc_vocab_size,
                                                   (Bn, cfg.max_seq_len_src))),
              ref_tgt=torch.from_numpy(rng.randint(4, cfg.dec_vocab_size, (Bn, 12))))
    kw["ref_src"][:, 0] = kw["ref_tgt"][:, 0] = BOS
    counts = lambda: (decode_chain_step_flash.gather_launches,
                      decoder_layer_step_flash.launches, decode_head_gather.launches,
                      las_greedy_flash.launches, bilstm_pallas.launches)
    before = counts()
    out_g = forward_eval(pg, cfg, "ASR_ST", device=dev, **kw)
    ran = [a > b for a, b in zip(counts(), before)]
    assert ran == ([False, True, True, gated, True] if "universal" in route
                   else [True, False, False, gated, True])
    out_c = forward_eval(pc, cfg, "ASR_ST", device="cpu", **kw)
    assert set(out_g) == set(out_c)
    for k, v in out_c.items():
        if k.startswith(("preds", "lengths")):
            assert torch.equal(out_g[k].cpu(), v), k
        else:
            _close(out_g[k].cpu(), v, TOL)


# The audit's widths (AUDIT: head width 6): the fused kernels' attention
# loads a cache row an entry at a time there. K3 in f32 and with bf16
# caches, K5 and K4 likewise, and the decode routes, through the narrow
# tests' bodies.


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("K,pos,topk,gather", NARROW_K3_CASES)
def test_audit_width_chain_step_matches_plain(dev, narrow, K, pos, topk, gather, bf16):
    test_narrow_chain_step_matches_plain(dev, narrow, "audit", K, pos, topk, gather, False,
                                         bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("pos", [0, 31])
def test_audit_width_fused_steps_match_plain(dev, params, wide_params, narrow, pos, bf16):
    """K5 and K4 (the audit's decoder embeds at D: the megastep) at head
    width 6."""
    test_fused_layer_step_matches_plain(dev, params, wide_params, narrow, "audit", 8, 2, pos, 9,
                                        False, bf16)
    test_fused_beam_step_matches_plain(dev, params, wide_params, narrow, "audit", 8, 2,
                                       max(pos, 2), 9, 1.0, False, bf16)


@pytest.mark.parametrize("route", ["beam", "eval", "beam universal", "eval universal"])
def test_audit_width_routes_card_match_cpu(dev, narrow, route):
    test_narrow_routes_card_match_cpu(dev, narrow, "audit", route)
