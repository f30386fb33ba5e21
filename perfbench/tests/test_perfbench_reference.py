"""The plain reference against the port's CPU route at a tiny width. The
test imports both; the reference and the harness import nothing of the
port (their sources are read here), and the weight tree has the port's key
paths and shapes."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

from perfbench import checks, traffic as traffic_mod
from perfbench.reference import stjep as ref
from perfbench.tests.tiny import MODEL, TRAFFIC
from perfbench.weights import draw_params, leaf_paths

PB = Path(__file__).resolve().parents[1]


def cfg_of(model, **kw):
    from stjep_tpu_torch.config import ModelConfig

    return ModelConfig(**{**model, **kw})


@pytest.mark.parametrize("tt", ["standard", "universal"])
def test_weights_have_the_ports_layout(tt):
    from stjep_tpu_torch.bridge import named_leaves
    from stjep_tpu_torch.models.seq2seq import init_seq2seq

    model = dict(MODEL, transformer_type=tt)
    port = init_seq2seq(cfg_of(model, mode="ASR_ST"), torch.Generator().manual_seed(0))
    ours = draw_params(model, 5, "cpu")
    assert sorted((n, tuple(t.shape)) for n, t in named_leaves(port)) == sorted(
        (n, tuple(t.shape)) for n, t in leaf_paths(ours))


def test_weights_repeat_for_a_seed():
    a, b, c = (draw_params(MODEL, s, "cpu") for s in (3, 3, 2 ** 40 + 3))
    for (_, x), (_, y), (_, z) in zip(leaf_paths(a), leaf_paths(b), leaf_paths(c)):
        assert torch.equal(x, y)
    assert not torch.equal(leaf_paths(a)[0][1], leaf_paths(c)[0][1])


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(p.relative_to(PB).as_posix() for p in PB.rglob("*.py")
                                        if "tests" not in p.parts))
def test_no_jax_anywhere_and_the_reference_imports_no_program(path):
    mods = {m.split(".")[0] for m in _imports(PB / path)}
    assert not mods & {"jax", "jaxlib", "flax", "stjep_tpu"}, mods
    if path.startswith(("reference/", "checks.py", "weights.py", "traffic.py", "yardstick.py")):
        assert "stjep_tpu_torch" not in mods


def _batch(model, seed=4):
    tr = TRAFFIC["st_beam_b64"]
    b = traffic_mod.make_pool({**tr, "pool": 1}, model, seed)[0]
    return torch.from_numpy(b["acous_feat"]), torch.from_numpy(b["acouslen"])


def test_las_against_the_port():
    from stjep_tpu_torch.models.las_decoder import las_decoder_forward
    from stjep_tpu_torch.models.las_encoder import las_encoder_forward

    cfg = cfg_of(MODEL, mode="ST")
    p = draw_params(MODEL, 8, "cpu")
    feats, lens = _batch(MODEL)
    with torch.no_grad():
        acous_p, _ = las_encoder_forward(p["las"]["encoder"], cfg, feats, lens)
        acous_r, _ = ref.las_encoder(p["las"]["encoder"], MODEL, feats, lens)
        assert torch.allclose(acous_p, acous_r, atol=1e-6)
        embs, _, hyps, _ = las_decoder_forward(p["las"]["decoder"], cfg, acous_p, lens,
                                               max_seq_len=MODEL["max_seq_len_src"])
        dyn, logits = ref.las_decoder(p["las"]["decoder"], MODEL, acous_r, lens,
                                      torch.cat([torch.full_like(hyps[:, :1], 2), hyps], 1))
    assert torch.allclose(embs, dyn, atol=1e-5)
    assert torch.equal(logits.argmax(-1), hyps)


@pytest.mark.parametrize("tt", ["standard", "universal"])
def test_st_decode_against_the_port(tt):
    """The port's beam (CPU route) reads rounding in every decode number,
    its kept hypotheses recorded position by position as a run records
    them; a served token altered reads a miss."""
    from stjep_tpu_torch.infer.forward import forward_translate
    import stjep_tpu_torch.infer.beam as beam
    import stjep_tpu_torch.infer.forward as fwd
    from perfbench.entries.st_beam import hold_eos, kept_state
    from perfbench.tracing import Recorder

    model = dict(MODEL, transformer_type=tt)
    cfg = cfg_of(model, mode="ST")
    p = draw_params(model, 9, "cpu")
    hold_eos(p)
    feats, lens = _batch(model, 5)
    recs = [Recorder(fwd, "_las_pass"), Recorder(fwd, "beam_search"),
            Recorder(beam, "decode_beam_step_flash", keep=kept_state),
            Recorder(beam, "beam_select", keep=kept_state)]
    try:
        toks = forward_translate(p, cfg, "ST", acous_feats=feats, acous_lens=lens, beam_width=3,
                                 max_seq_len=15, device="cpu")
    finally:
        for r in recs:
            r.remove()
    las, served, *steps = (r.calls for r in recs)
    out = {"pool": 0, "tokens": toks, "hyps": las[0][1], "scores": served[0][1],
           "emb_host": las[0][0], "steps_host": steps[0] + steps[1]}
    assert [s[0] for s in out["steps_host"]] == list(range(2, 15))
    got = checks.decode_numbers(model, p, [(feats, lens)], [out], [out], 3, "cpu")
    assert got["asr_gap"] < 1e-5 and got["st_select_gap"] < 1e-5 and got["st_score_err"] < 1e-4
    assert got["dyn_emb_err"] < 1e-5
    bad = {**out, "tokens": toks.clone()}
    bad["tokens"][0, 2] = (bad["tokens"][0, 2] + 7) % model["dec_vocab_size"]
    worse = checks.decode_numbers(model, p, [(feats, lens)], [bad], [bad], 3, "cpu")
    assert worse["st_select_gap"] > checks.MISS / 2


def test_rank_gap_reads_a_wrong_pick_and_a_duplicate():
    cand = torch.tensor([[0.0, -1.0, -3.0, -6.0]])
    ok = torch.ones((1, 2), dtype=torch.bool)
    assert checks._rank_gap(cand, torch.tensor([[-1.0, 0.0]]), ok) == 0.0
    assert checks._rank_gap(cand, torch.tensor([[0.0, -3.0]]), ok) == 2.0
    flat, found = checks._match(torch.tensor([[[2, 1], [2, 1]]]), torch.tensor([[[2]]]), 4)
    assert flat.tolist() == [[1, 1]] and found.tolist() == [[True, False]]
    assert checks._rank_gap(cand, torch.tensor([[0.0, 0.0]]), found) > checks.MISS / 2


@pytest.mark.parametrize("mode", ["ASR_ST", "MT"])
@pytest.mark.parametrize("training", [False, True])
def test_train_losses_and_gradients_against_the_port(mode, training):
    """The port's training forward and backward (CPU route) against the
    reference; in training, dropout and SpecAugment on, the port's draws
    recorded as a run records them and handed to the reference."""
    from stjep_tpu_torch.train.trainer import compute_grads
    from perfbench.entries.train_step import draws

    tr = TRAFFIC["train_asr_st_b32" if mode == "ASR_ST" else "train_mt_b64"]
    b = {k: torch.from_numpy(v) for k, v in
         traffic_mod.make_pool({**tr, "pool": 1}, MODEL, 6)[0].items()}
    cfg = cfg_of(MODEL, mode=mode, dropout=0.2 if training else 0.0, spec_aug=training)
    p = draw_params(MODEL, 10, "cpu")
    with draws(0.2) as rec:
        losses, grads = compute_grads(cfg, mode, p, [b], torch.Generator().manual_seed(0),
                                      is_training=training)
        got = rec.take()
    assert bool(got["draws"]) == training
    q = draw_params(MODEL, 10, "cpu")
    qs = [t.requires_grad_(True) for _, t in leaf_paths(q)]
    drops = ref.Drops(got["draws"], got["spec_keep"], got["rate"]) if training else None
    out = ref.train_losses(q, MODEL, mode, b, drops)
    g = ref.grads_of(qs, out["nll_loss_en"] + out["nll_loss_de"])
    for k in out:
        assert float(losses[k]) == pytest.approx(float(out[k]), rel=1e-5, abs=1e-7)
    err = checks.leaf_norm_err(grads, g)
    assert err < 1e-4
    if training and mode == "ASR_ST":
        assert got["spec_keep"] is not None and not bool(got["spec_keep"].all())
        plain = ref.train_losses(q, MODEL, mode, b)  # the draws matter
        assert abs(float(plain["nll_loss_de"]) - float(out["nll_loss_de"])) > 1e-4
