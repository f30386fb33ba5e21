"""The port's translate CLI (`python -m stjep_tpu_torch.cli.translate`)
against the root translate.py (JAX) on the CPU: a tiny corpus, a JAX
checkpoint with its model_config (init params and a random emb_dyn_ave),
and each eval mode's output held against the JAX function's on the same
inputs: translate.txt byte-identical in every gen mode, dyn_emb_ave.npy
within 1e-5, the combined checkpoint bit-equal, the projector rows equal;
and the same flags."""

import argparse
import dataclasses
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import translate as jax_tr
from stjep_tpu.config import ModelConfig
from stjep_tpu.data.dataset import Dataset as JaxDataset
from stjep_tpu.data.device_cache import quantize_batch
from stjep_tpu.models.seq2seq import init_seq2seq as jax_init
from stjep_tpu.train import checkpoint as jckpt

from stjep_tpu_torch.bridge import named_leaves, params_from_numpy
from stjep_tpu_torch.cli import translate as cli
from stjep_tpu_torch.data.dataset import Dataset
from stjep_tpu_torch.train.checkpoint import Checkpoint

from tests.data_factory import make_corpus

QUIET = dict(logger_print=lambda *a: None)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("translate_cli")
    corpus = make_corpus(str(root / "corpus"), n_sent=12)
    cfg = ModelConfig(
        enc_vocab_size=corpus["vocab_src_size"], dec_vocab_size=corpus["vocab_tgt_size"],
        enc_embedding_size=16, dec_embedding_size=128, acous_dim=8,
        acous_hidden_size=64, dim_model=128, dim_feedforward=256, num_heads=4,
        enc_layers=2, dec_layers=2, num_unilstm_dec=3, spec_aug=False, dropout=0.0,
        max_seq_len_src=16, max_seq_len_tgt=24, mode="ASR_ST")
    jp = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(0), cfg))
    jp["emb_dyn_ave"] = np.random.RandomState(3).randn(cfg.dim_model).astype(np.float32)
    ds = _dataset(JaxDataset, corpus)
    ckpt = jckpt.Checkpoint(params=jp, input_vocab=ds.vocab_src, output_vocab=ds.vocab_tgt,
                            model_config=dataclasses.asdict(cfg))
    ckpt_dir = ckpt.save_customise(str(root / "ckpt"))
    return dict(corpus=corpus, cfg=cfg, jp=jp, tp=params_from_numpy(jp), ckpt=ckpt_dir)


def _dataset(cls, corpus, **kw):
    return cls(path_src=corpus["path_src"], path_tgt=corpus["path_tgt"],
               path_vocab_src=corpus["path_vocab_src"],
               path_vocab_tgt=corpus["path_vocab_tgt"], acous_path=corpus["acous_path"],
               acous_norm=False, acous_max_len=400, use_type="char",
               max_seq_len_src=16, max_seq_len_tgt=24, batch_size=5, mode="ST", seed=0,
               **kw)


def _port_translate(world, out, **kw):
    kw = {"max_seq_len": 24, "beam_width": 2, "gen_mode": "ST", **QUIET, **kw}
    return Path(cli.translate(_dataset(Dataset, world["corpus"]), world["cfg"], world["tp"],
                              str(out), device="cpu", **kw)).read_text(encoding="utf8")


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.type, a.default, a.choices, a.help,
                     a.required, a.nargs)
            for a in parser._actions}


def test_parser_equals_translate_py():
    ours = _actions(cli.load_arguments(argparse.ArgumentParser()))
    ref = _actions(jax_tr.load_arguments(argparse.ArgumentParser()))
    assert ours == ref
    assert len(ours) > 20


@pytest.mark.parametrize("gen", ["ASR", "ASR-REF", "ST", "ST-REF", "MT", "ST_BASE"])
def test_mode1_file_byte_identical(world, tmp_path, gen):
    """translate.txt of every gen mode equals the JAX CLI's translate()
    byte for byte (beam 2; the LAS decodes 149 steps, the eval override)."""
    mode, _, history = gen.partition("-")
    kw = dict(max_seq_len=24, beam_width=2, gen_mode=mode, history=history or "HYP")
    ref = Path(jax_tr.translate(_dataset(JaxDataset, world["corpus"]), world["cfg"],
                                world["jp"], str(tmp_path / "j"), **QUIET, **kw))
    ours = _port_translate(world, tmp_path / "t", **kw)
    assert ours == ref.read_text(encoding="utf8")
    assert len(ours.splitlines()) == 12 and ours.strip()


def test_pipeline_depths_write_one_file(world, tmp_path, monkeypatch):
    """Depth 0 (inline), 1 and 3 (prefetch thread, decodes in flight)
    write the same rows in the same order."""
    outs = {}
    for depth in ("0", "1", "3"):
        monkeypatch.setenv("STJEP_DECODE_PIPELINE", depth)
        outs[depth] = _port_translate(world, tmp_path / depth, gen_mode="ST")
    assert outs["0"] == outs["1"] == outs["3"] and outs["0"].strip()


def test_feat_dtype_int8_equals_roundtrip_f32(world, tmp_path):
    """--feat_dtype int8 (quantized on the prefetch thread, dequantized on
    the device) decodes exactly what f32 staging of the host-quantized and
    dequantized features decodes (tests/test_cli.py:176)."""
    int8 = _port_translate(world, tmp_path / "q", feat_dtype="int8")
    ds = _dataset(Dataset, world["corpus"])
    orig = ds.materialise_batch

    def roundtrip(idx):
        item = dict(orig(idx))
        packed = quantize_batch(item["acous_feat"], np.float32)
        item["acous_feat"] = packed["q"].astype(np.float32) * packed["scale"][..., None, None]
        return item

    ds.materialise_batch = roundtrip
    f32 = Path(cli.translate(ds, world["cfg"], world["tp"], str(tmp_path / "r"),
                             max_seq_len=24, beam_width=2, gen_mode="ST",
                             feat_dtype="float32", device="cpu", **QUIET)).read_text()
    assert int8 == f32 and int8.strip()


def test_mode3_dyn_emb_ave_matches_jax(world, tmp_path):
    ref = np.load(jax_tr.gather_emb(_dataset(JaxDataset, world["corpus"]), world["cfg"],
                                    world["jp"], str(tmp_path / "j"), **QUIET))
    ours = np.load(cli.gather_emb(_dataset(Dataset, world["corpus"]), world["cfg"],
                                  world["tp"], str(tmp_path / "t"), device="cpu", **QUIET))
    assert ours.shape == (world["cfg"].dim_model,)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


def test_mode2_combine_bit_equal_to_jax(world, tmp_path):
    """main --eval_mode 2 averages three JAX checkpoints: every leaf equal
    to JAX's combine_weights bit for bit, and the same ckpts.log."""
    rng = np.random.RandomState(5)
    comb = tmp_path / "ckpts"
    for i in range(3):
        p = jax.tree_util.tree_map(lambda a: a + rng.randn(*a.shape).astype(a.dtype), world["jp"])
        jckpt.Checkpoint(params=p, model_config=dataclasses.asdict(world["cfg"])
                         ).save_customise(str(comb / f"c{i}"))
    c = world["corpus"]
    saved = cli.main(["--test_path_src", c["path_src"], "--test_path_tgt", c["path_tgt"],
                      "--test_acous_path", c["acous_path"], "--load", world["ckpt"],
                      "--test_path_out", str(tmp_path / "o"), "--eval_mode", "2",
                      "--combine_path", str(comb) + "/"], device="cpu")
    assert saved == str(tmp_path / "ckpts-combine" / "combine")
    ref = jckpt.combine_weights(str(comb), params_template=world["jp"])
    ours = Checkpoint.load(saved, params_template=world["tp"]).params
    for (name, a), (_, b) in zip(named_leaves(ours), named_leaves(params_from_numpy(ref)),
                                 strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    jckpt.log_ckpts(str(comb), str(tmp_path))
    assert (tmp_path / "ckpts-combine" / "ckpts.log").read_text() == \
        (tmp_path / "ckpts.log").read_text() == "c0\nc1\nc2\n"


class _Recorder:
    """A SummaryWriter that keeps what add_embedding receives."""
    got = []

    def __init__(self, log_dir=None):
        pass

    def add_embedding(self, feats, metadata=None):
        self.got.append((feats.numpy(), list(metadata)))

    def close(self):
        pass


def test_mode4_rows_and_words_match_jax(world, tmp_path, monkeypatch):
    """plot_emb projects the same rows and words as JAX's (a recording
    SummaryWriter on both sides), and select_emb_rows gives them."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=_Recorder))
    _Recorder.got = []
    c, cfg = world["corpus"], world["cfg"]
    jax_tr.plot_emb(_dataset(JaxDataset, c), cfg, world["jp"], str(tmp_path), **QUIET)
    ds = _dataset(Dataset, c)
    assert cli.plot_emb(ds, cfg, world["tp"], str(tmp_path), device="cpu", **QUIET) == str(tmp_path)
    (ref, ref_words), (ours, words) = _Recorder.got
    assert words == ref_words and len(words) == ours.shape[0] > 0
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)
    rows = cli.select_emb_rows(ds, cfg, world["tp"], ds.materialise_batch(0), device="cpu")
    assert rows["words"] == words and len(rows["hyp_ids"]) == len(rows["ref_ids"])


def test_mode4_skips_without_tensorboard(world, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    said = []
    assert cli.plot_emb(_dataset(Dataset, world["corpus"]), world["cfg"], world["tp"],
                        str(tmp_path), logger_print=said.append, device="cpu") is None
    assert said == ["tensorboard unavailable; skipping plot_emb"]


def _main_argv(world, out, *extra):
    c = world["corpus"]
    return ["--test_path_src", c["path_src"], "--test_path_tgt", c["path_tgt"],
            "--test_acous_path", c["acous_path"], "--load", world["ckpt"],
            "--test_path_out", str(out), "--batch_size", "5", "--max_seq_len", "24",
            "--use_gpu", "True", *extra]


def test_main_reads_jax_checkpoint_and_writes_jax_file(world, tmp_path):
    """main() on the JAX checkpoint writes what the JAX CLI's own
    _load_model + Dataset + translate() write, and its eval.cfg."""
    out = cli.main(_main_argv(world, tmp_path / "t", "--eval_mode", "1", "--gen_mode", "ST",
                              "--beam_width", "2"), device="cpu")
    cfg_j, params_j, ck = jax_tr._load_model(world["ckpt"])
    c = world["corpus"]
    ds = JaxDataset(path_src=c["path_src"], path_tgt=c["path_tgt"],
                    vocab_src_list=ck.input_vocab, vocab_tgt_list=ck.output_vocab,
                    use_type="char", acous_path=c["acous_path"], acous_max_len=6000,
                    max_seq_len_src=900, max_seq_len_tgt=900, batch_size=5, mode="ST")
    ref = jax_tr.translate(ds, cfg_j, params_j, str(tmp_path / "j"), 24, 2, gen_mode="ST",
                           **QUIET)
    assert Path(out).read_text() == Path(ref).read_text()
    assert "gen_mode:ST" in (tmp_path / "t" / "eval.cfg").read_text()


def test_main_fails_as_jax_cli_does(world, tmp_path):
    """An lm_mode other than null or s-4g* raises NotImplementedError, and
    mode 2 without --combine_path refuses, as translate.py's main does."""
    with pytest.raises(NotImplementedError, match="lm_mode"):
        cli.main(_main_argv(world, tmp_path / "a", "--eval_mode", "1", "--lm_mode", "d"),
                 device="cpu")
    with pytest.raises(ValueError, match="combine_path"):
        cli.main(_main_argv(world, tmp_path / "b", "--eval_mode", "2"), device="cpu")


def test_main_without_a_card_raises(world, tmp_path):
    """No fallback: with no card visible, main() on its default device
    raises before it reads anything."""
    if torch.cuda.is_available():
        pytest.skip("checks the host without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(_main_argv(world, tmp_path / "n", "--eval_mode", "1"))
    assert not (tmp_path / "n").exists()
