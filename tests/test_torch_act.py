"""Port vs JAX on CPU: ACT (the universal transformer's halting loop) and
the decode routes it takes.

- The ACT encoder and decoder stacks: values within 1e-5 and layer maps
  equal; a differing map would be allowed only where JAX's halting sums
  lie within 1e-5 of a threshold at some hop (a tie, read from a replay of
  JAX's loop body, `_jax_halting_trace`).
- ACT greedy `forward_eval("MT")` (every position re-runs the token
  buffer): tokens equal to JAX's and to a literal re-run of each growing
  prefix (as tests/test_act.py:91-140), logps within 1e-5.
- The ACT ST beam through `forward_translate` at widths 1 and 3 and on an
  EOS-heavy model: line-identical to JAX's dense beam.
- `act_max_hop` past the layer count: JAX reads NaN, the port raises.
- What ACT refuses: training (JAX has no gradient through its while
  loop) and int8 weight streaming; under a kernel mesh its decodes equal
  those without one.
- The translate CLI on an ACT checkpoint: translate.txt byte-identical to
  translate.py's translate() in gen modes ST, ST-REF, MT and ST_BASE, and
  main() in eval modes 1-4 reading the checkpoint.
"""

import copy
import dataclasses
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import translate as jax_tr
from stjep_tpu.config import BOS, EOS, PAD, ModelConfig
from stjep_tpu.data.dataset import Dataset as JaxDataset
from stjep_tpu.infer.forward import forward_translate as jax_forward_translate
from stjep_tpu.models.act import ACT_THRESHOLD
from stjep_tpu.models.seq2seq import forward_eval as jax_forward_eval
from stjep_tpu.models.seq2seq import init_seq2seq as jax_init
from stjep_tpu.models.tf_decoder import tf_decoder_forward as jax_dec
from stjep_tpu.models.tf_encoder import tf_encoder_forward as jax_enc
from stjep_tpu.ops.attention import linear as jlinear
from stjep_tpu.ops.masks import position_signal as jpos
from stjep_tpu.ops.transformer import decoder_layer as jdec_layer
from stjep_tpu.ops.transformer import encoder_layer as jenc_layer
from stjep_tpu.train import checkpoint as jckpt
from stjep_tpu_torch.bridge import params_from_numpy
from stjep_tpu_torch.cli import translate as cli
from stjep_tpu_torch.data.dataset import Dataset
from stjep_tpu_torch.infer.forward import forward_eval, forward_translate
from stjep_tpu_torch.models.seq2seq import (
    _encoder_en,
    _get_tgt_emb,
    _src_emb_ave,
    forward_train,
)
from stjep_tpu_torch.models import tf_decoder, tf_encoder
from stjep_tpu_torch.models.tf_decoder import tf_decoder_forward
from stjep_tpu_torch.models.tf_encoder import tf_encoder_forward
from stjep_tpu_torch.ops.attention import linear
from stjep_tpu_torch.parallel.mesh import make_mesh
from stjep_tpu_torch.parallel.spmd import set_kernel_mesh
from stjep_tpu_torch.train import optim
from stjep_tpu_torch.train.trainer import make_train_step

from tests.data_factory import make_corpus

TOL, TIE = 1e-5, 1e-5
CFG = ModelConfig(
    enc_vocab_size=50, dec_vocab_size=40, enc_embedding_size=16, dec_embedding_size=32,
    acous_dim=8, acous_hidden_size=16, dim_model=32, dim_feedforward=64, num_heads=4,
    enc_layers=3, dec_layers=3, num_unilstm_dec=3, spec_aug=False, dropout=0.0,
    max_seq_len_src=12, max_seq_len_tgt=16, mode="ASR_ST", transformer_type="universal",
    act=True)
B, T, MAX_LEN = 3, 64, 16
QUIET = dict(logger_print=lambda *a: None)


@pytest.fixture(scope="module")
def jp():
    return jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(0), CFG))


def _batch(seed):
    rng = np.random.RandomState(seed)
    src = rng.randint(4, CFG.enc_vocab_size, (B, CFG.max_seq_len_src)).astype(np.int32)
    src[:, 0] = BOS
    src[1, 7:] = PAD
    return {"src": src, "acous_feats": rng.randn(B, T, CFG.acous_dim).astype(np.float32),
            "acous_lens": np.array([T, 29, 47], np.int32)}


def _jax_halting_trace(act_p, transform, x, max_hop, L):
    """JAX's ACT loop body replayed eagerly: per hop, the halting sums the
    thresholds are compared with ([B, L] each: halting_p + p*running
    against 0.9, and halting_p after the hop against 1.0)."""
    B_ = x.shape[0]
    tsig, lsig = jpos(max(500, L), x.shape[-1]), jpos(max_hop, x.shape[-1])
    z = jnp.zeros((B_, L))
    h, r, n = z, z, z
    sums, step = [], 0
    while bool(jnp.any((h < ACT_THRESHOLD) & (n < max_hop))):
        x = x + tsig[:, :L] + lsig[:, step][:, None]
        p = jax.nn.sigmoid(jlinear(act_p, x))[..., 0]
        run = (h < 1.0).astype(x.dtype)
        q = h + p * run
        new = (q > ACT_THRESHOLD).astype(x.dtype) * run
        run = (q <= ACT_THRESHOLD).astype(x.dtype) * run
        h = h + p * run
        r = r + new * (1 - h)
        h = h + new * r
        n = n + run + new
        sums += [np.asarray(q) - ACT_THRESHOLD, np.asarray(h) - 1.0]
        x, step = transform(x), step + 1
    return sums


def _explain_maps(ours, ref, sums):
    """Every position whose layer map differs is a tie: some hop's halting
    sum lies within TIE of its threshold. Returns the rows that differ."""
    diff = np.argwhere(ours != ref)
    for b, l in diff:
        gap = min(abs(s[b, l]) for s in sums)
        assert gap < TIE, f"layer map differs at {(b, l)} with threshold gap {gap}"
    return {int(b) for b, _ in diff}


def _with_layer_map(monkeypatch, module, name, call):
    """call() with `module.name` (act_enc_apply / act_dec_apply, which
    return (state, layer map)) recording its layer map: (result, map)."""
    real, maps = getattr(module, name), []

    def recording(*a, **kw):
        out = real(*a, **kw)
        maps.append(out[1])
        return out

    monkeypatch.setattr(module, name, recording)
    return call(), maps[0]


@pytest.mark.parametrize("side", ["encoder", "decoder"])
def test_act_stack_matches_jax(jp, monkeypatch, side):
    rng = np.random.RandomState(11)
    x = rng.randn(B, 7, CFG.dim_model).astype(np.float32)
    mem = rng.randn(B, 5, CFG.dim_model).astype(np.float32)
    pad = np.ones((B, 1, 7), bool)
    pad[1, 0, 5:] = False
    causal = pad & np.tril(np.ones((1, 7, 7), bool))
    mmask = np.ones((B, 1, 5), bool)
    mmask[2, 0, 3:] = False
    if side == "decoder":  # at bias 1 every decoder position runs 3 hops
        jp = copy.deepcopy(jp)
        jp["dec_tgt"]["act_fn"]["p"]["b"] = np.full((1,), 6.0, np.float32)
    tp = params_from_numpy(jp)
    if side == "encoder":
        p = jp["enc_src"]
        ref, ref_map = jax_enc(p, CFG, jnp.asarray(x), src_mask=jnp.asarray(pad))
        out, lmap = _with_layer_map(monkeypatch, tf_encoder, "act_enc_apply", lambda: (
            tf_encoder_forward(tp["enc_src"], CFG, torch.from_numpy(x),
                               src_mask=torch.from_numpy(pad))))

        def transform(s):
            return jenc_layer(p["layers"][0], s, CFG.num_heads, mask=jnp.asarray(pad),
                              deterministic=True)[0]
    else:
        p = jp["dec_tgt"]
        ref, ref_map, _ = jax_dec(p, CFG, jnp.asarray(x), jnp.asarray(mem),
                                  tgt_mask=jnp.asarray(causal), src_mask=jnp.asarray(mmask))
        out, lmap = _with_layer_map(monkeypatch, tf_decoder, "act_dec_apply", lambda: (
            tf_decoder_forward(tp["dec_tgt"], CFG, torch.from_numpy(x), torch.from_numpy(mem),
                               tgt_mask=torch.from_numpy(causal),
                               src_mask=torch.from_numpy(mmask))))

        def transform(s):
            return jdec_layer(p["layers"][0], s, jnp.asarray(mem), CFG.num_heads,
                              self_mask=jnp.asarray(causal), cross_mask=jnp.asarray(mmask),
                              deterministic=True)[0]
    sums = _jax_halting_trace(p["act_fn"]["p"], transform, jnp.asarray(x), 3, 7)
    rows = _explain_maps(lmap.numpy(), np.asarray(ref_map), sums)
    keep = [b for b in range(B) if b not in rows]
    np.testing.assert_allclose(out.numpy()[keep], np.asarray(ref)[keep], atol=TOL, rtol=0)
    assert len(keep) == B  # at this seed no position lies within TIE of a threshold
    assert len(np.unique(lmap.numpy())) > 1  # positions halt at different hops


def test_act_greedy_mt_matches_jax_and_prefix_rerun(jp):
    mb = _batch(0)
    ref = jax_forward_eval(jp, CFG, "MT", src=jnp.asarray(mb["src"]), use_flash=False)
    tp = params_from_numpy(jp)
    src = torch.from_numpy(mb["src"])
    out = forward_eval(tp, CFG, "MT", src=src, device="cpu")
    got = out["preds_mt"].numpy()
    np.testing.assert_array_equal(got, np.asarray(ref["preds_mt"]))
    np.testing.assert_allclose(out["logps_mt"].numpy(), np.asarray(ref["logps_mt"]),
                               atol=TOL, rtol=0)

    # the reference's algorithm: re-run each growing true prefix
    _, emb_src, mask = _src_emb_ave(tp, CFG, src)
    enc = _encoder_en(tp, CFG, emb_src, src_mask=mask)
    toks = torch.full((B, MAX_LEN), PAD, dtype=torch.int32)
    toks[:, 0] = BOS
    done = torch.zeros(B, dtype=torch.bool)
    for i in range(1, MAX_LEN):
        tgt_mask, emb = _get_tgt_emb(tp, CFG, toks[:, :i])
        dec = tf_decoder_forward(tp["dec_tgt"], CFG, emb, enc, tgt_mask=tgt_mask,
                                 src_mask=mask, max_time=500)
        toks[:, i] = linear(tp["out_tgt"], dec[:, -1]).argmax(-1).to(torch.int32)
        done |= toks[:, i] == EOS
        if bool(done.all()):
            break
    for b in range(B):  # up to each row's first EOS
        stop = np.where(toks[b].numpy() == EOS)[0]
        upto = int(stop[0]) + 1 if len(stop) else MAX_LEN
        np.testing.assert_array_equal(got[b, :upto], toks[b, :upto].numpy())


def _eos_biased(p, bias):
    p = copy.deepcopy(p)
    w = p["out_tgt"]["w"][:, EOS]
    p["dec_tgt"]["norm"]["bias"] = (bias * w / (w @ w)).astype(np.float32)
    return p


@pytest.mark.parametrize("beam", [1, 3, "eos"])
def test_act_st_beam_line_identical(jp, beam):
    eos = beam == "eos"
    if eos:
        jp, beam = _eos_biased(jp, 2.5), 3
    mb = _batch(7)
    kw = dict(beam_width=beam, penalty_factor=1.0, max_seq_len=MAX_LEN)
    ref = jax_forward_translate(jp, CFG, "ST", acous_feats=jnp.asarray(mb["acous_feats"]),
                                acous_lens=jnp.asarray(mb["acous_lens"]), **kw)
    out = forward_translate(params_from_numpy(jp), CFG, "ST",
                            acous_feats=torch.from_numpy(mb["acous_feats"]),
                            acous_lens=torch.from_numpy(mb["acous_lens"]), device="cpu", **kw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    if eos:  # every row stops, the loop exits before the last slot
        assert (out.numpy() == EOS).any(axis=1).all() and (out.numpy()[:, -1] == PAD).all()


def test_act_max_hop_past_the_layers(jp):
    """A halting bias of -30 keeps every position running to max_hop: past
    the 3 layers JAX's layer-signal read fills NaN; the port raises."""
    cfg = dataclasses.replace(CFG, act_max_hop=5)
    p = copy.deepcopy(jp["enc_src"])
    p["act_fn"]["p"]["b"] = np.full((1,), -30.0, np.float32)
    x = np.random.RandomState(1).randn(2, 4, CFG.dim_model).astype(np.float32)
    ref, _ = jax_enc(p, cfg, jnp.asarray(x))
    assert np.isnan(np.asarray(ref)).all()
    with pytest.raises(ValueError, match="act_max_hop 5 exceeds the 3 layers"):
        tf_encoder_forward(params_from_numpy(p), cfg, torch.from_numpy(x))
    ok, _ = jax_enc(p, dataclasses.replace(CFG, act_max_hop=3), jnp.asarray(x))
    out = tf_encoder_forward(params_from_numpy(p), dataclasses.replace(CFG, act_max_hop=3),
                             torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ok), atol=TOL, rtol=0)


def test_act_refusals(jp):
    tp = params_from_numpy(jp)
    mb = _batch(1)
    tgt = torch.from_numpy(np.full((B, 6), 5, np.int32))
    with pytest.raises(ValueError, match="lax.while_loop"):
        forward_train(tp, CFG, "MT", src=torch.from_numpy(mb["src"]), tgt=tgt)
    with pytest.raises(ValueError, match="lax.while_loop"):
        make_train_step(CFG, "ASR_ST", optim.make_optimizer(), device="cpu")
    feats, lens = torch.from_numpy(mb["acous_feats"]), torch.from_numpy(mb["acous_lens"])
    with pytest.raises(ValueError, match="int8"):
        forward_translate(tp, CFG, "ST", acous_feats=feats, acous_lens=lens, beam_width=2,
                          max_seq_len=8, device="cpu", weight_dtype="int8")
    # under a kernel mesh ACT decodes the whole batch where the call runs, as
    # JAX's decode_flash_auto sends it to its dense decode: the beam, the
    # greedy eval and dev eval with refs equal the calls without a mesh
    src = torch.from_numpy(mb["src"])
    ref_tgt = torch.from_numpy(np.full((B, 8), 5, np.int32))
    ref_tgt[:, 0] = BOS
    calls = {
        "beam": lambda: forward_translate(tp, CFG, "ST", acous_feats=feats, acous_lens=lens,
                                          beam_width=2, max_seq_len=8, device="cpu"),
        "greedy": lambda: forward_eval(tp, CFG, "MT", src=src, device="cpu"),
        "dev eval": lambda: forward_eval(tp, CFG, "ASR_ST", acous_feats=feats,
                                         acous_lens=lens, ref_src=src, ref_tgt=ref_tgt,
                                         device="cpu")}
    alone = {k: fn() for k, fn in calls.items()}
    set_kernel_mesh(make_mesh(1, 2, ["cpu"] * 2))
    try:
        meshed = {k: fn() for k, fn in calls.items()}
    finally:
        set_kernel_mesh(None)
    for k, want in alone.items():
        got = meshed[k]
        if torch.is_tensor(want):
            got, want = [got], [want]
        elif isinstance(want, dict):
            assert got.keys() == want.keys(), k
            got, want = [got[x] for x in want], list(want.values())
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a, b), k


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("act_cli")
    corpus = make_corpus(str(root / "corpus"), n_sent=6)
    cfg = dataclasses.replace(CFG, enc_vocab_size=corpus["vocab_src_size"],
                              dec_vocab_size=corpus["vocab_tgt_size"], max_seq_len_src=16,
                              max_seq_len_tgt=24)
    p = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(2), cfg))
    p["emb_dyn_ave"] = np.random.RandomState(3).randn(cfg.dim_model).astype(np.float32)
    ds = _dataset(JaxDataset, corpus)
    ckpt = jckpt.Checkpoint(params=p, input_vocab=ds.vocab_src, output_vocab=ds.vocab_tgt,
                            model_config=dataclasses.asdict(cfg)).save_customise(
                                str(root / "ckpt"))
    return dict(corpus=corpus, cfg=cfg, jp=p, ckpt=ckpt)


def _dataset(cls, corpus):
    return cls(path_src=corpus["path_src"], path_tgt=corpus["path_tgt"],
               path_vocab_src=corpus["path_vocab_src"],
               path_vocab_tgt=corpus["path_vocab_tgt"], acous_path=corpus["acous_path"],
               acous_norm=False, acous_max_len=400, use_type="char", max_seq_len_src=16,
               max_seq_len_tgt=24, batch_size=3, mode="ST", seed=0)


@pytest.mark.parametrize("gen", ["ST", "ST-REF", "MT", "ST_BASE"])
def test_act_translate_file_byte_identical(world, tmp_path, gen):
    mode, _, history = gen.partition("-")
    kw = dict(max_seq_len=24, beam_width=2, gen_mode=mode, history=history or "HYP", **QUIET)
    ref = jax_tr.translate(_dataset(JaxDataset, world["corpus"]), world["cfg"], world["jp"],
                           str(tmp_path / "j"), **kw)
    ours = cli.translate(_dataset(Dataset, world["corpus"]), world["cfg"],
                         params_from_numpy(world["jp"]), str(tmp_path / "t"), device="cpu",
                         **kw)
    text = Path(ours).read_text(encoding="utf8")
    assert text == Path(ref).read_text(encoding="utf8") and text.strip()


class _Recorder:
    """A SummaryWriter that keeps what add_embedding receives."""
    got = []

    def __init__(self, log_dir=None):
        pass

    def add_embedding(self, feats, metadata=None):
        self.got.append((feats.numpy(), list(metadata)))

    def close(self):
        pass


def test_act_checkpoint_through_main(world, tmp_path, monkeypatch):
    """main() reads the ACT checkpoint (its model_config carries act) in
    eval modes 1 (lines equal to translate() on the loaded model), 2 (the
    average of two ACT checkpoints, act_fn included), 3 and 4 (a recording
    SummaryWriter)."""
    c = world["corpus"]
    argv = ["--test_path_src", c["path_src"], "--test_path_tgt", c["path_tgt"],
            "--test_acous_path", c["acous_path"], "--load", world["ckpt"],
            "--batch_size", "3", "--max_seq_len", "24"]
    out = cli.main(argv + ["--test_path_out", str(tmp_path / "m1"), "--eval_mode", "1",
                           "--gen_mode", "ST", "--beam_width", "2"], device="cpu")
    cfg, params, _ = cli._load_model(world["ckpt"], device="cpu")
    assert cfg.act and "act_fn" in params["dec_tgt"] and "act_fn" in params["enc_src"]
    ref = jax_tr.translate(_dataset(JaxDataset, c), world["cfg"], world["jp"],
                           str(tmp_path / "j"), 24, 2, gen_mode="ST", **QUIET)
    assert Path(out).read_text() == Path(ref).read_text()
    comb = tmp_path / "ckpts"
    for i, d in enumerate((0.0, 1.0)):
        p = jax.tree_util.tree_map(lambda a: a + d, world["jp"])
        jckpt.Checkpoint(params=p, model_config=dataclasses.asdict(world["cfg"])
                         ).save_customise(str(comb / f"c{i}"))
    saved = cli.main(argv + ["--test_path_out", str(tmp_path / "m2"), "--eval_mode", "2",
                             "--combine_path", str(comb) + "/"], device="cpu")
    avg = cli._load_model(saved, device="cpu")[1]
    np.testing.assert_array_equal(avg["dec_tgt"]["act_fn"]["p"]["b"].numpy(),
                                  world["jp"]["dec_tgt"]["act_fn"]["p"]["b"] + 0.5)
    dyn = cli.main(argv + ["--test_path_out", str(tmp_path / "m3"), "--eval_mode", "3"],
                   device="cpu")
    assert np.load(dyn).shape == (CFG.dim_model,)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=_Recorder))
    _Recorder.got = []
    cli.main(argv + ["--test_path_out", str(tmp_path / "m4"), "--eval_mode", "4"],
             device="cpu")
    (rows, words), = _Recorder.got
    assert rows.shape == (len(words), CFG.dim_model) and words
