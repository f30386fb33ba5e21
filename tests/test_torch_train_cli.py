"""The port's train CLI (`python -m stjep_tpu_torch.cli.train`) against
train.py's: the same flag surface and config files, and runs on the CPU
through `main(argv, device="cpu")`."""

import argparse
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import train as jax_train
from stjep_tpu.config import save_config as jsave_config
from stjep_tpu.config import validate_config as jvalidate_config

from stjep_tpu_torch.bridge import named_leaves
from stjep_tpu_torch.cli import train as cli
from stjep_tpu_torch.data.dataset import load_vocab_file
from stjep_tpu_torch.train.checkpoint import Checkpoint

from tests.data_factory import make_corpus

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(str(tmp_path_factory.mktemp("cli")), n_sent=12)


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.type, a.default, a.choices, a.help,
                     a.required, a.nargs)
            for a in parser._actions}


def test_parser_equals_train_py():
    ours = _actions(cli.load_arguments(argparse.ArgumentParser()))
    ref = _actions(jax_train.load_arguments(argparse.ArgumentParser()))
    assert ours == ref
    assert len(ours) > 80


def _argv(corpus, save, *extra):
    return ["--mode", "ASR_ST", "--save", str(save),
            "--st_train_path_src", corpus["path_src"], "--st_train_path_tgt", corpus["path_tgt"],
            "--st_train_acous_path", corpus["acous_path"],
            "--st_acous_norm_path", corpus["acous_norm_path"],
            "--st_dev_path_src", corpus["path_src"], "--st_dev_path_tgt", corpus["path_tgt"],
            "--st_dev_acous_path", corpus["acous_path"],
            "--path_vocab_src", corpus["path_vocab_src"],
            "--path_vocab_tgt", corpus["path_vocab_tgt"],
            "--las_acous_dim", "8", "--las_acous_hidden_size", "4",
            "--dim_model", "8", "--dim_feedforward", "16", "--num_heads", "2",
            "--enc_layers", "1", "--dec_layers", "1",
            "--embedding_size_enc", "8", "--embedding_size_dec", "8",
            "--max_seq_len_src", "16", "--max_seq_len_tgt", "32",
            "--batch_size", "6", "--minibatch_partition", "2",
            "--num_epochs", "1", "--checkpoint_every", "1", "--print_every", "1",
            "--learning_rate", "0.005", "--learning_rate_init", "0.005",
            "--lr_warmup_steps", "0", "--loss_nll_asr_coeff", "1.0",
            "--loss_nll_st_coeff", "1.0", *extra]


def _jax_cfg_bytes(argv, path):
    """train.py main's config steps: parse, validate, save."""
    parser = jax_train.load_arguments(argparse.ArgumentParser())
    jsave_config(jvalidate_config(vars(parser.parse_args(argv))), path)
    return Path(path).read_bytes()


def test_cli_trains_and_writes_train_py_config(corpus, tmp_path):
    """An ASR_ST epoch with dev eval on the CPU: model.cfg byte-equal to
    train.py's for the same argv, a checkpoint on improvement, finite
    printed losses; then --load_mode resume writes model-cont.cfg and
    continues from the saved step."""
    argv = _argv(corpus, tmp_path / "a", "--length_bucket", "True", "--feat_dtype", "int8")
    t, (cfg, params) = cli.main(argv, device="cpu")
    assert (tmp_path / "a" / "model.cfg").read_bytes() == _jax_cfg_bytes(argv, tmp_path / "j.cfg")
    assert t.steps_run == 2 and t.MODE == "ASR_ST" and t.feat_dtype == "int8"
    assert cfg.dim_model == 8 and cfg.enc_vocab_size == corpus["vocab_src_size"]
    latest = Checkpoint.get_latest_checkpoint(str(tmp_path / "a"))
    assert latest is not None
    lines = (tmp_path / "a" / "scalars.jsonl").read_text().splitlines()
    assert any('"train_loss_de"' in x for x in lines) and any('"dev_bleu_de"' in x for x in lines)

    saved = Checkpoint.load(latest)
    argv_r = _argv(corpus, tmp_path / "r", "--load", latest, "--load_mode", "resume",
                   "--num_epochs", "0")
    t2, (_, p2) = cli.main(argv_r, device="cpu")
    assert (tmp_path / "r" / "model-cont.cfg").read_bytes() == \
        _jax_cfg_bytes(argv_r, tmp_path / "jr.cfg")
    assert not (tmp_path / "r" / "model.cfg").exists()
    assert t2.start == (saved.epoch, saved.step) and t2.steps_run == 0
    assert torch.equal(p2["enc_src"]["layers"][0]["pos_ffn"]["w_1"]["w"],
                       saved.params["enc_src"]["layers"]["0"]["pos_ffn"]["w_1"]["w"])


def test_cli_embedding_overlay_shared_and_dyn_ave(corpus, tmp_path):
    """--load_embedding_src/tgt with --share_embedder: the tgt-side table
    wins (ref: Seq2seq.py:119-121); --emb_dyn_ave loads the artifact;
    --dtype bfloat16 gives bf16 params."""
    _, w2i, _ = load_vocab_file(corpus["path_vocab_src"])
    words = [w for w in w2i if not w.startswith("<")]
    (tmp_path / "src.vec").write_text(f"{words[0]} " + " ".join(["0.5"] * 8) + "\n"
                                      f"{words[1]} " + " ".join(["0.25"] * 8) + "\n")
    (tmp_path / "tgt.vec").write_text(f"{words[0]} " + " ".join(["-1.5"] * 8) + "\n")
    np.save(tmp_path / "dyn.npy", np.arange(8, dtype=np.float32))
    argv = ["--mode", "MT", "--save", str(tmp_path / "m"),
            "--mt_train_path_src", corpus["path_src"], "--mt_train_path_tgt", corpus["path_src"],
            "--path_vocab_src", corpus["path_vocab_src"],
            "--path_vocab_tgt", corpus["path_vocab_src"], "--use_type", "word",
            "--share_embedder", "True", "--load_embedding_src", str(tmp_path / "src.vec"),
            "--load_embedding_tgt", str(tmp_path / "tgt.vec"),
            "--emb_dyn_ave", str(tmp_path / "dyn.npy"), "--dtype", "bfloat16",
            "--dim_model", "8", "--dim_feedforward", "16", "--num_heads", "2",
            "--enc_layers", "1", "--dec_layers", "1", "--embedding_size_enc", "8",
            "--embedding_size_dec", "8", "--num_epochs", "0"]
    _, (_, p) = cli.main(argv, device="cpu")
    assert p["enc_embedder"].dtype == torch.bfloat16
    assert torch.equal(p["enc_embedder"], p["dec_embedder"])
    assert torch.all(p["enc_embedder"][w2i[words[0]]] == -1.5)
    assert not torch.all(p["enc_embedder"][w2i[words[1]]] == 0.25)
    assert torch.equal(p["emb_dyn_ave"], torch.arange(8, dtype=torch.bfloat16))


@pytest.mark.parametrize("flags,item", [
    (["--n_model", "2"], "item 11"), (["--remat", "True"], "item 6"),
    (["--act", "True", "--transformer_type", "universal"], "item 9"),
    (["--mode", "AE_ASR"], "item 6")])
def test_cli_refuses_unported_options(corpus, tmp_path, flags, item, caplog):
    """`item` is the ROADMAP Queue A item each option had when this test
    was written (the ids keep it). --n_model 2 trains: on the one CPU
    device the mesh degrades to (1, 1) with make_mesh's warning, and the
    run equals --n_model 1 at 1e-5; --remat trains; --act on a universal
    transformer and the AE modes refuse with the JAX package's reasons
    before anything is written."""
    if flags[0] == "--n_model":
        finals = {}
        for n in ("1", "2"):
            with caplog.at_level("WARNING"):
                t, (_, finals[n]) = cli.main(_argv(corpus, tmp_path / f"n{n}", "--n_model", n,
                                                   "--num_epochs", "1", "--batch_size", "12"),
                                             device="cpu")
            assert t.steps_run == 1
            assert (t._mesh is None) == (n == "1")
        assert t._mesh.shape == {"data": 1, "model": 1}
        assert "n_model=2 does not divide 1 devices" in caplog.text
        for (name, a), (_, b) in zip(named_leaves(finals["2"]), named_leaves(finals["1"]),
                                     strict=True):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
    elif flags[0] == "--remat":
        t, (cfg, _) = cli.main(_argv(corpus, tmp_path / "x", *flags, "--num_epochs", "1",
                                     "--batch_size", "12"), device="cpu")
        assert cfg.remat and t.steps_run == 1
    else:
        reason = "lax.while_loop" if flags[0] == "--act" else "no AE loss"
        with pytest.raises(ValueError, match=reason):
            cli.main(_argv(corpus, tmp_path / "x", *flags), device="cpu")
        assert not (tmp_path / "x").exists()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the host without a card")
def test_cli_without_a_card_raises(corpus, tmp_path):
    """No fallback: with no card visible the CLI raises instead of
    training on the CPU."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    r = subprocess.run([sys.executable, "-m", "stjep_tpu_torch.cli.train",
                        *_argv(corpus, tmp_path / "n")], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert not (tmp_path / "n" / "checkpoints").exists()
