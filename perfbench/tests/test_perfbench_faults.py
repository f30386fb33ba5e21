"""The harness end to end on the CPU at a tiny width (its look for a card
skipped): `correct` is true on the sound program, and false with the timed
path broken underneath in each way the cell can break: a step that returns
its state unchanged, half of the batch left out, a token or an answer
altered where it is produced; in decode a beam that keeps the wrong
candidates or serves a row that is not its best, and a LAS that picks
another symbol than its best; in training a dropout mask drawn and not
applied."""

from __future__ import annotations

import functools

import pytest
import torch

from perfbench import run as pb_run
from perfbench.tests import tiny

SEED = 2 ** 33 + 17


def execute(monkeypatch, tmp_path, cell):
    bench = tiny.install(monkeypatch, tmp_path)
    return pb_run.execute(cell, SEED, 0.5, 0, device_name="cpu", bench=bench)


@pytest.mark.parametrize("cell", ["standard.st_beam_b64", "universal.st_beam_b64",
                                  "standard.train_asr_st_b32", "standard.train_mt_b64"])
def test_sound_program_is_correct(monkeypatch, tmp_path, cell):
    res = execute(monkeypatch, tmp_path, cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


def _unchanged_megastep(inner):
    """decode_beam_step_flash's state handed back as it came in."""
    @functools.wraps(inner)
    def f(*a, **kw):
        i, last_tok, preds, anc, maskk, _, scores, eos, lenm = a[5:14]
        return preds, anc, maskk, last_tok, scores, eos, lenm, torch.zeros(1, dtype=torch.int32)
    return f


def _unchanged_select(sc, ids, scores, eos, lenm, preds, anc, maskk, i, group, pf):
    return (preds, anc, maskk, preds[:, i - 1].contiguous(), scores, eos, lenm,
            torch.zeros(1, dtype=torch.int32))


def _half_batch(inner):
    def f(params, cfg, enc, mask, *a, **kw):
        h = enc.shape[0] // 2
        preds, scores = inner(params, cfg, enc[:h], mask[:h], *a, **kw)
        full = torch.zeros((enc.shape[0], preds.shape[1]), dtype=preds.dtype)
        full[:h], full[h:, 0] = preds, 2
        return full, torch.cat([scores, torch.full_like(scores, scores.mean())])
    return f


def _altered_token(inner):
    def f(*a, **kw):
        preds, scores = inner(*a, **kw)
        preds = preds.clone()
        preds[0, 2] = (preds[0, 2] + 1) % tiny.MODEL["dec_vocab_size"]
        return preds, scores
    return f


def _altered_hypothesis(inner):
    def f(*a, **kw):
        emb, preds, lengths = inner(*a, **kw)
        preds = preds.clone()
        preds[1, 0] = (preds[1, 0] + 1) % tiny.MODEL["enc_vocab_size"]
        return emb, preds, lengths
    return f


def _select_topk(change):
    """topk_lowest_index with `change` applied where the beam's k^2 -> k
    select calls it (candidates [B, K*K]); the head's top K (over the
    vocabulary) is left as it is."""
    def make(inner):
        def f(x, k):
            if x.shape[-1] != k * k:
                return inner(x, k)
            return change(inner, x, k)
        return f
    return make


def _wrong_five(inner, x, k):
    """Keeps the 2nd to (k+1)-th candidates, with their true scores."""
    vals, ids = inner(x, k + 1)
    return vals[..., 1:], ids[..., 1:]


def _best_second(inner, x, k):
    """Keeps the right k, with the best in slot 1 and the second in slot 0."""
    vals, ids = inner(x, k)
    order = [1, 0] + list(range(2, k))
    return vals[..., order], ids[..., order]


class _SecondBest:
    """The torch module as the LAS decoder's greedy step sees it, with the
    argmax over the vocabulary giving the second best symbol."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def argmax(x, dim=None, **kw):
        if x.shape[-1] == tiny.MODEL["enc_vocab_size"]:
            return x.topk(2, dim=dim).indices.select(dim, 1)
        return torch.argmax(x, dim=dim, **kw)


DECODE_FAULTS = {
    "a wrong merge (megastep)": ("standard.st_beam_b64", "stjep_tpu_torch.ops.decode_flash",
                                 "topk_lowest_index", _select_topk(_wrong_five)),
    "a wrong merge (select)": ("universal.st_beam_b64", "stjep_tpu_torch.ops.decode_flash",
                               "topk_lowest_index", _select_topk(_wrong_five)),
    "slot 0 not the best": ("standard.st_beam_b64", "stjep_tpu_torch.ops.decode_flash",
                            "topk_lowest_index", _select_topk(_best_second)),
    "the ASR's second best symbol": ("universal.st_beam_b64", "stjep_tpu_torch.models.las_decoder",
                                     "torch", lambda inner: _SecondBest()),
    "state unchanged (megastep)": ("standard.st_beam_b64", "stjep_tpu_torch.infer.beam",
                                   "decode_beam_step_flash", _unchanged_megastep),
    "state unchanged (select)": ("universal.st_beam_b64", "stjep_tpu_torch.infer.beam",
                                 "beam_select", lambda inner: _unchanged_select),
    "half of the batch": ("standard.st_beam_b64", "stjep_tpu_torch.infer.forward", "beam_search",
                          _half_batch),
    "a served token": ("universal.st_beam_b64", "stjep_tpu_torch.infer.forward", "beam_search",
                       _altered_token),
    "an ASR hypothesis": ("standard.st_beam_b64", "stjep_tpu_torch.infer.forward", "_las_pass",
                          _altered_hypothesis),
}


@pytest.mark.parametrize("fault", sorted(DECODE_FAULTS))
def test_decode_fault_is_not_correct(monkeypatch, tmp_path, fault):
    import importlib

    cell, mod, attr, make = DECODE_FAULTS[fault]
    m = importlib.import_module(mod)
    monkeypatch.setattr(m, attr, make(getattr(m, attr)))
    res = execute(monkeypatch, tmp_path, cell)
    assert not res["correct"], res["checks"]


def _no_update(self, grads, opt_state):
    return None


def _half_rows(inner):
    def f(cfg, mode, params, minibatches, *a, **kw):
        cut = [{k: v[: v.shape[0] // 2 or 1] for k, v in mb.items()} for mb in minibatches]
        return inner(cfg, mode, params, cut, *a, **kw)
    return f


def _altered_target(inner):
    def f(cfg, mode, params, minibatches, *a, **kw):
        mbs = []
        for mb in minibatches:
            t = mb["tgtid"].clone()
            t[0, 3] = 5 + (t[0, 3] - 4) % (tiny.MODEL["dec_vocab_size"] - 5)
            mbs.append({**mb, "tgtid": t})
        return inner(cfg, mode, params, mbs, *a, **kw)
    return f


def _ctx_mask_dropped(inner):
    """The LAS decoder's masks drawn as always, its context mask not applied."""
    def f(*a, **kw):
        lstm, ctx = inner(*a, **kw)
        return lstm, torch.ones_like(ctx)
    return f


def _attention_mask_dropped(inner):
    """The attention probabilities' dropout drawn as always, not applied."""
    def f(q, k, v, temperature, mask=None, generator=None, training=False, u=None):
        import stjep_tpu_torch.ops.transformer as tfm

        if training and u is None and tfm.ATTN_DROPOUT > 0.0:
            tfm.uniform(generator, (q.shape[0], q.shape[2], q.shape[1], k.shape[1]), q.device)
            training = False
        return inner(q, k, v, temperature, mask, generator, training, u)
    return f


BOTH = ("standard.train_asr_st_b32", "standard.train_mt_b64")
TRAIN_FAULTS = {
    "state unchanged": (BOTH, "stjep_tpu_torch.train.optim", "Optimizer.update",
                        lambda inner: _no_update),
    "half of the batch": (BOTH, "stjep_tpu_torch.train.trainer", "compute_grads", _half_rows),
    "a target token": (BOTH, "stjep_tpu_torch.train.trainer", "compute_grads", _altered_target),
    "the LAS context mask not applied": (("standard.train_asr_st_b32",),
                                         "stjep_tpu_torch.models.las_decoder",
                                         "_make_drop_masks", _ctx_mask_dropped),
    "the attention dropout not applied": (BOTH, "stjep_tpu_torch.ops.transformer",
                                          "scaled_dot_attention", _attention_mask_dropped),
}


@pytest.mark.parametrize("cell,fault", [(c, f) for f, v in sorted(TRAIN_FAULTS.items())
                                        for c in v[0]])
def test_train_fault_is_not_correct(monkeypatch, tmp_path, cell, fault):
    import importlib

    _, mod, attr, make = TRAIN_FAULTS[fault]
    m = importlib.import_module(mod)
    owner, name = (getattr(m, attr.split(".")[0]), attr.split(".")[1]) if "." in attr else (
        m, attr)
    monkeypatch.setattr(owner, name, make(getattr(owner, name)))
    res = execute(monkeypatch, tmp_path, cell)
    assert not res["correct"], res["checks"]
