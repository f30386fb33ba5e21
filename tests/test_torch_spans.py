"""The port's spans (stjep_tpu_torch/utils/profiling.py `span`) on the CPU
routes: under torch.profiler a decode request and a train step leave their
named ranges in the Chrome trace, nested as the sites open them, with one
`stjep.decode.flag_read` a beam position; with no profiler running a span
is the one shared null context and no `record_function` is entered."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from stjep_tpu_torch.config import ModelConfig
from stjep_tpu_torch.infer import beam as beam_mod
from stjep_tpu_torch.infer.forward import forward_translate
from stjep_tpu_torch.models.seq2seq import init_seq2seq
from stjep_tpu_torch.train import optim
from stjep_tpu_torch.train.trainer import make_train_step
from stjep_tpu_torch.utils import profiling

MODEL = dict(enc_vocab_size=50, dec_vocab_size=30, enc_embedding_size=8, dec_embedding_size=32,
             dim_model=32, dim_feedforward=64, num_heads=4, enc_layers=2, dec_layers=2,
             acous_dim=8, acous_hidden_size=16, num_unilstm_dec=3, max_seq_len_src=12,
             max_seq_len_tgt=15)
B, T, BEAM, MAX_LEN = 2, 48, 3, 9


def _cfg(transformer_type="standard", mode="ST", **kw):
    return ModelConfig(**MODEL, transformer_type=transformer_type, mode=mode, **kw)


def _params(cfg):
    return init_seq2seq(cfg, torch.Generator().manual_seed(0), device="cpu")


def _feats():
    rng = np.random.RandomState(1)
    return (torch.from_numpy(rng.randn(B, T, MODEL["acous_dim"]).astype(np.float32)),
            torch.tensor([T, 33], dtype=torch.int32))


def _batch():
    rng = np.random.RandomState(2)
    src = rng.randint(4, MODEL["enc_vocab_size"], (B, MODEL["max_seq_len_src"])).astype(np.int64)
    tgt = rng.randint(4, MODEL["dec_vocab_size"], (B, MODEL["max_seq_len_tgt"])).astype(np.int64)
    src[:, 0] = tgt[:, 0] = 2
    src[1, 7:] = tgt[1, 9:] = 0
    f, lens = _feats()
    return {"srcid": torch.from_numpy(src).int(), "tgtid": torch.from_numpy(tgt).int(),
            "acous_feat": f, "acouslen": lens}


def _spans(tmp_path, fn):
    """fn() under torch.profiler (host activity): the stjep.* ranges of the
    Chrome trace as (name, start, end), by start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"
           and e["name"].startswith("stjep.")]
    return sorted(out, key=lambda s: s[1])


def _named(spans, name):
    return [(s, e) for n, s, e in spans if n == name]


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("transformer_type", ["standard", "universal"])
def test_decode_request_spans(tmp_path, monkeypatch, transformer_type):
    """One stjep.decode holding one .las, then one .encoder, then one
    .beam_loop, and one .flag_read a position inside the beam loop: position
    1's, and one for each megastep or k^2 -> k select the loop ran."""
    cfg = _cfg(transformer_type)
    params = _params(cfg)
    f, lens = _feats()
    steps = []
    for name in ("decode_beam_step_flash", "beam_select"):
        inner = getattr(beam_mod, name)
        monkeypatch.setattr(beam_mod, name,
                            lambda *a, _f=inner, _n=name, **k: steps.append(_n) or _f(*a, **k))
    spans = _spans(tmp_path, lambda: forward_translate(
        params, cfg, "ST", acous_feats=f, acous_lens=lens, beam_width=BEAM,
        max_seq_len=MAX_LEN, device="cpu"))
    (decode,) = _named(spans, "stjep.decode")
    (las,) = _named(spans, "stjep.decode.las")
    (enc,) = _named(spans, "stjep.decode.encoder")
    (loop,) = _named(spans, "stjep.decode.beam_loop")
    reads = _named(spans, "stjep.decode.flag_read")
    assert all(_inside(s, decode) for s in (las, enc, loop))
    assert las[1] <= enc[0] and enc[1] <= loop[0]
    assert all(_inside(r, loop) for r in reads)
    assert steps and len(set(steps)) == 1
    assert steps[0] == ("decode_beam_step_flash" if transformer_type == "standard"
                        else "beam_select")
    assert len(reads) == 1 + len(steps)
    assert {n for n, _, _ in spans} == {"stjep.decode", "stjep.decode.las",
                                        "stjep.decode.encoder", "stjep.decode.beam_loop",
                                        "stjep.decode.flag_read"}


def test_train_step_spans(tmp_path):
    """One make_train_step step of two minibatches: one stjep.train.step
    holding a .forward then a .backward per minibatch, then one .optimizer."""
    cfg = _cfg(mode="ASR_ST")
    params = _params(cfg)
    opt = optim.make_optimizer(1.0)
    state = opt.init(params)
    step = make_train_step(cfg, "ASR_ST", opt, device="cpu")
    mbs = [_batch(), _batch()]
    spans = _spans(tmp_path, lambda: step(params, state, mbs,
                                          torch.Generator().manual_seed(0), 1e-3))
    (root,) = _named(spans, "stjep.train.step")
    fwd = _named(spans, "stjep.train.forward")
    bwd = _named(spans, "stjep.train.backward")
    (upd,) = _named(spans, "stjep.train.optimizer")
    assert len(fwd) == len(bwd) == 2
    assert all(_inside(s, root) for s in fwd + bwd + [upd])
    assert fwd[0][1] <= bwd[0][0] <= bwd[0][1] <= fwd[1][0] <= fwd[1][1] <= bwd[1][0]
    assert bwd[1][1] <= upd[0]
    assert len(spans) == 6


def test_no_profiler_no_record_function(monkeypatch):
    """With no profiler running every span is the one shared null context:
    a decode request and a train step enter no record_function."""
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("stjep.decode") is profiling._NO_SPAN
    assert profiling.span("stjep.train.step") is profiling._NO_SPAN

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    cfg = _cfg()
    params = _params(cfg)
    f, lens = _feats()
    forward_translate(params, cfg, "ST", acous_feats=f, acous_lens=lens, beam_width=BEAM,
                      max_seq_len=MAX_LEN, device="cpu")
    tcfg = _cfg(mode="ASR_ST")
    tparams = _params(tcfg)
    opt = optim.make_optimizer(1.0)
    make_train_step(tcfg, "ASR_ST", opt, device="cpu")(
        tparams, opt.init(tparams), [_batch()], torch.Generator().manual_seed(0), 1e-3)

