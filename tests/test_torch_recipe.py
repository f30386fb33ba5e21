"""The port's end-to-end training scripts on the CPU
(stjep_tpu_torch/scripts/corpus.py, full_recipe.py, quality_ab.py): the
corpus copies write what tests/data_factory.py writes, byte for byte; the
staged recipe of scripts/run_full_recipe.sh runs its six stages through the
port's CLIs with both load-policy checks, and the checks refuse broken
params; the JAX package decodes the port's stage-5 checkpoint to the port's
stage-6 lines and gathers the port's mode-3 artifact from its ASR
checkpoint; one short quality seed writes its result with every field, and
the band logic on fixed numbers."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import translate as jax_tr
from stjep_tpu.data.dataset import Dataset as JaxDataset

from stjep_tpu_torch.scripts import corpus, full_recipe, quality_ab
from stjep_tpu_torch.scripts.full_recipe import StageError

from tests import data_factory

QUIET = dict(logger_print=lambda *a: None)


def _files(root: Path) -> dict:
    """relative path -> bytes of every file under root, root's own path
    in the file lists replaced by a marker."""
    return {str(p.relative_to(root)): p.read_bytes().replace(str(root).encode(), b"<root>")
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("fn,kw", [
    ("make_corpus", dict(n_sent=24)),
    ("make_hard_corpus", dict(n_sent=24, seed=0)),
    ("make_hard_corpus", dict(n_sent=8, seed=7, prefix="dev"))],
    ids=["recipe", "hard-train", "hard-dev"])
def test_corpus_copy_writes_the_same_files(tmp_path, fn, kw):
    ref = getattr(data_factory, fn)(str(tmp_path / "ref"), **kw)
    ours = getattr(corpus, fn)(str(tmp_path / "ours"), **kw)
    a, b = _files(tmp_path / "ref"), _files(tmp_path / "ours")
    assert a == b and len(a) > kw["n_sent"]
    assert {k: str(v).replace(str(tmp_path / "ref"), "") for k, v in ref.items()} == \
        {k: str(v).replace(str(tmp_path / "ours"), "") for k, v in ours.items()}
    assert (corpus.HARD_N_WORDS, corpus.HARD_N_PAIRS, corpus.SPECIALS) == (
        data_factory.HARD_N_WORDS, data_factory.HARD_N_PAIRS, data_factory.SPECIALS)


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    work = tmp_path_factory.mktemp("recipe")
    torch.manual_seed(0)
    return full_recipe.run(str(work), device="cpu", dims="recipe", log=lambda *a: None)


def test_recipe_runs_six_stages_with_load_policies(recipe):
    """Every stage in run_full_recipe.sh's order, each with its output;
    stage 4 started from the ASR checkpoint's LAS, stage 5 kept the joint
    LAS bit-equal while other leaves moved."""
    assert [s["stage"] for s in recipe["stages"]] == list(full_recipe.STAGES)
    assert all(s["seconds"] > 0 for s in recipe["stages"])
    # on the CPU every wrapper runs its plain version: nothing launches
    assert not any(v for s in recipe["stages"] for v in s["launches"].values())
    stages = {s["stage"]: s for s in recipe["stages"]}
    assert stages["asr_st"]["asr_leaves_loaded"] >= 10
    for label in ("final", "checkpoint"):
        fc = stages["st"]["frozen_check"][label]
        assert fc["frozen"] == stages["asr_st"]["asr_leaves_loaded"] and fc["moved"] > 0
    assert np.load(recipe["emb"]).shape == (16,)
    lines = Path(recipe["translate"]).read_text(encoding="utf8").splitlines()
    assert len(lines) == recipe["n_test"] == 24
    for k in ("asr_ckpt", "mt_ckpt", "joint_ckpt", "st_ckpt"):
        assert Path(recipe[k]).is_dir()


def test_recipe_policy_checks_refuse_broken_params(recipe):
    """A LAS leaf moved at step 0 of stage 4, or moved by stage 5, raises
    with the stage's name; so does a stage 5 that moved nothing."""
    from stjep_tpu_torch.train.checkpoint import Checkpoint

    joint = Checkpoint.load(recipe["joint_ckpt"]).params
    asr = Checkpoint.load(recipe["asr_ckpt"]).params
    assert full_recipe.check_asr_load(asr, recipe["asr_ckpt"]) >= 10
    # the joint LAS started from the ASR checkpoint's and then trained
    with pytest.raises(StageError, match="stage asr_st: las.* differs"):
        full_recipe.check_asr_load(joint, recipe["asr_ckpt"])
    st = Checkpoint.load(recipe["st_ckpt"]).params
    emb = joint["las"]["decoder"]["embedder"] + 1.0
    moved = {**st, "las": {**st["las"], "decoder": {**st["las"]["decoder"], "embedder": emb}}}
    with pytest.raises(StageError, match="stage st: frozen las.decoder.embedder moved"):
        full_recipe.check_frozen_las(moved, recipe["st_ckpt"], recipe["joint_ckpt"])
    with pytest.raises(StageError, match="stage st: no trainable leaf moved"):
        full_recipe.check_frozen_las(joint, recipe["joint_ckpt"], recipe["joint_ckpt"])


def _jax_test_set(c, ck):
    """The test set as translate.py's main builds it."""
    return JaxDataset(path_src=c["dev_src"], path_tgt=c["dev_tgt"],
                      vocab_src_list=ck.input_vocab, vocab_tgt_list=ck.output_vocab,
                      use_type="char", acous_path=c["dev_flis"], acous_max_len=6000,
                      max_seq_len_src=900, max_seq_len_tgt=900, batch_size=8, mode="ST")


def test_jax_decodes_port_checkpoint_to_port_lines(recipe, tmp_path):
    """The JAX CLI's decode (its _load_model, Dataset and translate) of the
    port's stage-5 checkpoint writes the port's stage-6 translate.txt, line
    for line (f32); its mode 3 on the port's ASR checkpoint gives the
    port's dyn_emb_ave.npy within 1e-5."""
    c, dec = recipe["corpus"], recipe["decode"]
    cfg_j, params_j, ck = jax_tr._load_model(recipe["st_ckpt"])
    ref = jax_tr.translate(_jax_test_set(c, ck), cfg_j, params_j, str(tmp_path / "j"),
                           dec["max_seq_len"], dec["beam_width"], gen_mode="ST", **QUIET)
    ours = Path(recipe["translate"]).read_text(encoding="utf8")
    assert ours.splitlines() == Path(ref).read_text(encoding="utf8").splitlines()
    assert any(line.strip() for line in ours.splitlines())
    cfg_a, params_a, ck_a = jax_tr._load_model(recipe["asr_ckpt"])
    emb_j = np.load(jax_tr.gather_emb(_jax_test_set(c, ck_a), cfg_a, params_a,
                                      str(tmp_path / "e"), **QUIET))
    emb = np.load(recipe["emb"])
    assert emb.shape == emb_j.shape == (16,) and np.abs(emb).max() > 0
    np.testing.assert_allclose(emb, emb_j, atol=1e-5, rtol=0)


def test_quality_seed_writes_every_field(tmp_path):
    """One seed at 1 + 2 epochs on 24 + 8 sentences (the joint stage saves
    only where its dev ST accuracy rises above 0, which takes it two steps
    here): the result file has every field, the seed a result.json that a
    rerun with the same settings reads instead of training, and that a
    rerun with other epochs, corpus or device wipes."""
    out = tmp_path / "q.json"
    argv = ["--device", "cpu", "--workdir", str(tmp_path / "w"), "--epochs_asr", "1",
            "--epochs_joint", "2", "--seeds", "333", "--n_train", "24", "--n_dev", "8",
            "--out", str(out)]
    assert quality_ab.main(argv) == 0
    res = json.loads(out.read_text())
    assert set(res) >= {"corpus", "config", "epochs", "seeds", "cards",
                        "source_sha256", "summary", "band", "status",
                        "per_seed_vs_jax_and_reference", "runs"}
    assert res["status"] == "partial" and res["seeds"] == [333]
    assert res["config"] == quality_ab.DIMS and res["epochs"] == {"asr": 1, "joint": 2}
    run = res["runs"][0]
    assert set(run) >= {"seed", "settings", "card", "wall_s", "steps", "loop", "trajectory",
                        "asr_dev_wer", "st_dev_bleu", "best_dev_joint"}
    assert run["settings"] == {"epochs_asr": 1, "epochs_joint": 2, "device": "cpu",
                               "corpus": {"train": 24, "dev": 8}}
    assert run["steps"] == {"asr": 1, "joint": 2} and run["n_decoded"] == {"asr": 8, "st": 8}
    assert 0.0 <= run["asr_dev_wer"] and 0.0 <= run["st_dev_bleu"] <= 1.0
    assert [p["step"] for p in run["trajectory"]["joint_stage"]["DE"]] == [2]
    assert set(run["trajectory"]["joint_stage"]["DE"][0]) == {"step", "nll_loss", "accuracy",
                                                              "bleu"}
    for k in quality_ab.METRICS:
        s = res["summary"][k]
        assert s["mean"] == s["min"] == s["max"] == run[k]
    row = res["per_seed_vs_jax_and_reference"][0]
    assert row["asr_dev_wer_jax"] == 0.1688 and row["st_dev_bleu_reference"] == 0.6597
    seed_dir = tmp_path / "w" / "port_s333"
    (seed_dir / "asr").rename(seed_dir / "asr_moved")  # a rerun must not train
    assert quality_ab.main(argv) == 0
    assert json.loads(out.read_text())["runs"] == res["runs"]
    for key, other in (("epochs_joint", 3), ("device", "cuda"), ("corpus", {"train": 360})):
        assert quality_ab._seed_cached(str(seed_dir), {**run["settings"], key: other}) is None
        assert not seed_dir.exists()
        seed_dir.mkdir()
        (seed_dir / "result.json").write_text(json.dumps(run))
    assert quality_ab._seed_cached(str(seed_dir), run["settings"]) == run


@pytest.mark.parametrize("seeds,means,want", [
    (quality_ab.SEEDS, {"asr_dev_wer": 0.213, "st_dev_bleu": 0.5839}, ("pass", 0)),
    (quality_ab.SEEDS, {"asr_dev_wer": 0.1415, "st_dev_bleu": 0.6893}, ("pass", 0)),
    (quality_ab.SEEDS, {"asr_dev_wer": 0.30, "st_dev_bleu": 0.5839}, ("fail", 1)),
    (quality_ab.SEEDS, {"asr_dev_wer": 0.20, "st_dev_bleu": 0.40}, ("fail", 1)),
    (quality_ab.SEEDS, {"asr_dev_wer": 0.10, "st_dev_bleu": 0.70}, ("fail", 2)),
    ((333, 334), {"asr_dev_wer": 0.90, "st_dev_bleu": 0.0}, ("partial", 0)),
], ids=["mean", "edges", "wer-high", "bleu-low", "both", "partial"])
def test_quality_band_verdict(seeds, means, want):
    status, failures = quality_ab.verdict(means, seeds)
    assert (status, len(failures)) == want
