"""The port's Trainer (stjep_tpu_torch/train/trainer.py) against JAX's.

Both packages train the same tiny model from the same init (JAX's, carried
over by bridge.params_from_numpy) on the same corpus files, with dropout 0,
SpecAugment off and the attention-probability dropout (fixed at 0.1 in
both packages' transformer) set to 0, so no random stream is drawn: the
two RNG streams cannot match across frameworks. The JAX side runs as its
own tests run it (XLA on the CPU, its 8-device test mesh). Tolerances:
printed train losses and dev losses within 1e-4 relative, dev accuracies
and BLEU equal to 1e-6, and the best checkpoint's params within 1e-4 of
each leaf's norm (float32 runs that sum in other orders agree to ~1e-6).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from stjep_tpu.config import ModelConfig as JConfig
from stjep_tpu.data.dataset import Dataset as JDataset
from stjep_tpu.models.seq2seq import init_seq2seq as jinit
from stjep_tpu.ops import transformer as jtransformer
from stjep_tpu.train import trainer as jtrainer
from stjep_tpu.train.checkpoint import Checkpoint as JCheckpoint

from stjep_tpu_torch.bridge import named_leaves, params_from_numpy
from stjep_tpu_torch.config import ModelConfig
from stjep_tpu_torch.data.dataset import Dataset
from stjep_tpu_torch.ops import transformer as ttransformer
from stjep_tpu_torch.train import trainer as ttrainer
from stjep_tpu_torch.train.checkpoint import Checkpoint

from tests.data_factory import make_corpus

LEAF_TOL = 1e-4

CLASSES = {"ASR": ("Trainer_ASR", "asr"), "MT": ("Trainer_MT", "mt"),
           "ST": ("Trainer_ST", "st"), "ASR_ST": ("Trainer_ASR_ST", "st")}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    # learnable: the word -> chars map is seeded, not Python's hash, so
    # the corpus is the same in every process
    return make_corpus(str(tmp_path_factory.mktemp("corpus")), n_sent=16, learnable=True)


@pytest.fixture(autouse=True)
def _no_attention_dropout(monkeypatch):
    monkeypatch.setattr(jtransformer, "ATTN_DROPOUT", 0.0)
    monkeypatch.setattr(ttransformer, "ATTN_DROPOUT", 0.0)


def cfg_kw(corpus, mode):
    return dict(
        enc_vocab_size=corpus["vocab_src_size"], dec_vocab_size=corpus["vocab_tgt_size"],
        enc_embedding_size=8, dec_embedding_size=12, acous_dim=corpus["acous_dim"],
        acous_hidden_size=6, dim_model=12, dim_feedforward=24, num_heads=2,
        enc_layers=2, dec_layers=2, num_unilstm_dec=3, spec_aug=False,
        dropout=0.0, max_seq_len_src=16, max_seq_len_tgt=32, mode=mode)


def datasets(corpus, mode, batch_size):
    kw = dict(path_src=corpus["path_src"],
              path_tgt=corpus["path_tgt"] if mode != "ASR" else None,
              path_vocab_src=corpus["path_vocab_src"],
              path_vocab_tgt=corpus["path_vocab_tgt"],
              acous_path=corpus["acous_path"] if mode != "MT" else None,
              acous_norm_path=corpus["acous_norm_path"], acous_norm=(mode != "MT"),
              max_seq_len_src=16, max_seq_len_tgt=32, batch_size=batch_size,
              use_type="char", mode=mode, seed=5)
    return JDataset(**kw), Dataset(**kw)


def trainer_kw(**over):
    kw = dict(batch_size=7, minibatch_partition=3, checkpoint_every=1,
              print_every=1, learning_rate=0.005, learning_rate_init=0.005,
              lr_warmup_steps=0, seed=0, keep_num=1,
              loss_coeff={"nll_asr": 1.0, "nll_mt": 1.0, "nll_st": 1.0})
    kw.update(over)
    return kw


def scalars(expt):
    with open(os.path.join(expt, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f if '"Memory_MB"' not in line]


def leaf_errs(a_tree, b_tree):
    """{path: |a - b| / max(|a|, tiny)} over two trees of arrays/tensors
    with bridge paths."""
    a = dict(named_leaves(a_tree))
    b = dict(named_leaves(b_tree))
    assert a.keys() == b.keys()
    out = {}
    for k in a:
        x = np.asarray(a[k], np.float64)
        y = b[k].detach().double().numpy() if torch.is_tensor(b[k]) \
            else np.asarray(b[k], np.float64)
        out[k] = float(np.linalg.norm(x - y) / max(np.linalg.norm(x), 1e-12))
    return out


def run_pair(corpus, tmp_path, mode, jax_params=None, num_epochs=1, dev=True, **over):
    """One epoch (or num_epochs) of JAX's and the port's trainer of `mode`
    from one init. Returns (jax expt dir, port expt dir, port trainer, and
    the final params of JAX's and the port's)."""
    cls, key = CLASSES[mode]
    jcfg = JConfig(**cfg_kw(corpus, mode))
    if jax_params is None:
        jax_params = jinit(jax.random.PRNGKey(0), jcfg)
    init = jax.device_get(jax_params)  # the JAX step donates its params
    out, finals = [], []
    for side in ("jax", "port"):
        jds, tds = datasets(corpus, mode, over.get("batch_size", 7))
        expt = str(tmp_path / f"{side}_{mode}")
        if side == "jax":
            t = getattr(jtrainer, cls)(expt_dir=expt, **trainer_kw(**over))
            _, p = t.train({key: jds}, (jcfg, jax.tree_util.tree_map(jax.numpy.asarray, init)),
                           num_epochs=num_epochs, dev_sets={key: jds} if dev else None)
        else:
            t = getattr(ttrainer, cls)(expt_dir=expt, device="cpu", **trainer_kw(**over))
            _, p = t.train({key: tds}, (ModelConfig(**cfg_kw(corpus, mode)),
                                        params_from_numpy(init)),
                           num_epochs=num_epochs, dev_sets={key: tds} if dev else None)
        out.append(expt)
        finals.append(jax.device_get(p) if side == "jax" else p)
    return out[0], out[1], t, finals


@pytest.mark.parametrize("mode", ["ASR", "MT", "ST", "ASR_ST"])
def test_trainer_epoch_matches_jax(corpus, tmp_path, mode):
    """One epoch of 3 steps (batches of 7, 7 and 2 rows; minibatches of 2,
    the last ragged), printing and evaluating every step: the printed
    train losses, the dev losses and metrics, the final params, and the
    best checkpoint (on the same steps in both, or in neither)."""
    jexpt, texpt, t, (jfinal, tfinal) = run_pair(corpus, tmp_path, mode)
    js, ts = scalars(jexpt), scalars(texpt)
    assert [(s["tag"], s["step"]) for s in js] == [(s["tag"], s["step"]) for s in ts]
    assert any(s["tag"] == "train_loss_en" for s in ts)
    for a, b in zip(js, ts):
        tol = 1e-6 if ("accuracy" in a["tag"] or "bleu" in a["tag"]) else 1e-4
        assert b["value"] == pytest.approx(a["value"], rel=tol, abs=1e-6), (a, b)
    errs = leaf_errs(jfinal, tfinal)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= LEAF_TOL, (worst, errs[worst])
    jbest = JCheckpoint.get_latest_checkpoint(jexpt)
    tbest = Checkpoint.get_latest_checkpoint(texpt)
    assert (jbest is None) == (tbest is None)
    if jbest is not None:
        jck = JCheckpoint.load(jbest)
        tck = Checkpoint.load(tbest)
        assert (jck.epoch, jck.step) == (tck.epoch, tck.step)
        assert jck.input_vocab == tck.input_vocab and jck.output_vocab == tck.output_vocab
        errs = leaf_errs(jck.params, tck.params)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= LEAF_TOL, (worst, errs[worst])
    assert t.steps_run == 3


def test_resume_continues_a_jax_run(corpus, tmp_path):
    """JAX trains 2 steps (no dev set: a per-epoch checkpoint with its opt
    state); the port resumes it for 2 more; held against JAX resumed for
    2 more from the same checkpoint."""
    jcfg = JConfig(**cfg_kw(corpus, "ASR"))
    jds, _ = datasets(corpus, "ASR", 8)
    first = str(tmp_path / "first")
    jt = jtrainer.Trainer_ASR(expt_dir=first, **trainer_kw(batch_size=8, minibatch_partition=2))
    jt.train({"asr": jds}, (jcfg, jinit(jax.random.PRNGKey(0), jcfg)), num_epochs=1)
    ckpt = os.path.join(first, "checkpoints_epoch", "1")
    assert JCheckpoint.load(ckpt).step == 2

    fresh = jinit(jax.random.PRNGKey(3), jcfg)  # overwritten by the load
    jexpt, texpt, t, _ = run_pair(corpus, tmp_path, "ASR", jax_params=fresh, dev=False,
                               batch_size=8, minibatch_partition=2, load_dir=ckpt,
                               load_mode="resume")
    assert t.steps_run == 2
    jfinal = JCheckpoint.load(os.path.join(jexpt, "checkpoints_epoch", "1"))
    tfinal = Checkpoint.load(os.path.join(texpt, "checkpoints_epoch", "1"),
                             with_opt_state=True)
    assert jfinal.step == tfinal.step == 4
    errs = leaf_errs(jfinal.params, tfinal.params)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= LEAF_TOL, (worst, errs[worst])
    assert int(tfinal.opt_state["inner_states"]["train"]["inner_state"]["1"]["count"]) == 4
