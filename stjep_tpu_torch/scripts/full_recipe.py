"""The staged training recipe of scripts/run_full_recipe.sh on the port:
six stages through the port's own CLIs, in one process, on one device.

    python -m stjep_tpu_torch.scripts.full_recipe [--workdir DIR]
        [--device cuda|cpu] [--dims recipe|flagship]

1. ASR pretrain (LAS)
2. translate mode 3 on the ASR checkpoint: dyn_emb_ave.npy
3. MT pretrain on the artifact
4. joint ASR_ST, loading the ASR checkpoint (--load_mode ASR)
5. ST finetune from the joint checkpoint (--load_mode ALL-PARTIAL
   --load_freeze True: the LAS frozen)
6. ST beam decode of the ST checkpoint (translate mode 1)

`--dims recipe` is the shell script's own: its flags and widths (`COMMON`,
D = 16, 2 heads, an acoustic hidden size of 6), its 24-sentence corpus
(corpus.make_corpus) used as train, dev and test set, its epochs (2, 2, 2,
1) and its decode (batch 8, beam 3, 32 positions). `--dims flagship` is
the flagship model of scripts/flagship.py (D = 512, 8 heads, FF 1024, 6 + 6
layers, acoustic hidden size 256, 40-dim features) on a flagship.write_corpus
corpus (CORPUS_UTTS: 64 train and 16 dev utterances, the dev split also the
test set), one epoch of 4 steps a training stage, and bench's decode (batch
16, beam 5, 150 positions).

Each stage's output is checked, and a stage whose output is missing or
malformed raises with its name: a checkpoint written (its params finite),
dyn_emb_ave.npy of the shape the MT stage reads, one translate.txt line per
test utterance. The two load policies are checked on the params: after
stage 4's setup every `las.` leaf equals the ASR checkpoint's
(train/policies.py, `load_mode == "ASR"`, with the LAS decoder embedder's
fallback to `enc_embedder`); after stage 5 every leaf whose name holds
`las` is bit-equal to the joint checkpoint's, in the final params and the
stage's checkpoint, and some trainable leaf has moved. One line a stage
gives its seconds and the kernel launches counted across it
(utils/profiling.py); on the CPU the wrappers run their plain versions and
count nothing. The workdir defaults to a fresh directory under the system's
temporary directory.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

STAGES = ("asr", "emb", "mt", "asr_st", "st", "decode")
COUNTED = ("K1", "K2", "K3", "K3 gather", "K4", "K8 fwd", "K8 bwd", "K9 fwd", "K9 bwd")
# run_full_recipe.sh's COMMON (less the vocab paths) and epochs
RECIPE_FLAGS = [
    "--las_acous_dim", "8", "--las_acous_hidden_size", "6", "--las_acous_norm", "False",
    "--dim_model", "16", "--dim_feedforward", "32", "--num_heads", "2", "--enc_layers", "2",
    "--dec_layers", "2", "--embedding_size_enc", "8", "--embedding_size_dec", "16",
    "--max_seq_len_src", "16", "--max_seq_len_tgt", "32", "--batch_size", "8",
    "--minibatch_partition", "1", "--checkpoint_every", "3", "--print_every", "3",
    "--learning_rate", "0.004", "--learning_rate_init", "0.004", "--lr_warmup_steps", "0",
    "--use_type", "char"]
RECIPE_EPOCHS = {"asr": 2, "mt": 2, "asr_st": 2, "st": 1}
RECIPE_DECODE = {"batch_size": 8, "beam_width": 3, "max_seq_len": 32}
FLAGSHIP_EPOCHS = {"asr": 1, "mt": 1, "asr_st": 1, "st": 1}


def flagship_flags():
    """flagship.train_flags() with the recipe's own two: one dev eval and
    checkpoint an epoch of the CORPUS_UTTS corpus, and unnormalised
    features, as run_full_recipe.sh's COMMON trains (`--las_acous_norm
    False`; the train cli phase of chip_smoke.py trains with CMVN)."""
    from stjep_tpu_torch.scripts.flagship import B, CORPUS_UTTS, train_flags

    return [*train_flags(), "--checkpoint_every", str(CORPUS_UTTS["train"] // B),
            "--las_acous_norm", "False"]


def flagship_decode():
    from stjep_tpu_torch.scripts.flagship import B, BEAM, DECODE_LEN

    return {"batch_size": B, "beam_width": BEAM, "max_seq_len": DECODE_LEN}


def recipe_corpus(root: Path) -> dict:
    """run_full_recipe.sh's corpus, its train split also dev and test, in
    flagship.write_corpus's keys."""
    from stjep_tpu_torch.scripts.corpus import make_corpus

    c = make_corpus(str(root), n_sent=24)
    split = {"src": c["path_src"], "tgt": c["path_tgt"], "flis": c["acous_path"]}
    return {"vocab_src": c["path_vocab_src"], "vocab_tgt": c["path_vocab_tgt"],
            **{f"{s}_{k}": v for s in ("train", "dev") for k, v in split.items()}}


class StageError(RuntimeError):
    """A stage's output missing or malformed, or a load policy broken."""

    def __init__(self, stage: str, what: str):
        super().__init__(f"stage {stage}: {what}")
        self.stage = stage


def need(ok: bool, stage: str, what: str):
    if not ok:
        raise StageError(stage, what)


def _dotted(tree) -> dict:
    """name -> leaf of a params tree, names as train/policies.py writes them
    ("las.decoder.dec_l0.w_ih", list entries by index)."""
    from stjep_tpu_torch.train.policies import map_with_path

    out = {}
    map_with_path(tree, lambda n, leaf: out.__setitem__(n, leaf))
    return out


def _raw_params(path: str) -> dict:
    """A checkpoint's params as dotted name -> CPU tensor."""
    from stjep_tpu_torch.train.checkpoint import Checkpoint

    return _dotted(Checkpoint.load(path).params)


def _written(stage: str, save: str) -> str:
    """The stage's latest checkpoint; raises unless one was written with
    finite params."""
    from stjep_tpu_torch.train.checkpoint import Checkpoint

    path = Checkpoint.get_latest_checkpoint(save)
    need(path is not None, stage, f"no checkpoint under {save}")
    bad = [n for n, t in _raw_params(path).items()
           if t.is_floating_point() and not bool(torch.isfinite(t.float()).all())]
    need(not bad, stage, f"non-finite params in {path}: {bad[:5]}")
    return path


@contextlib.contextmanager
def setup_params(store: list):
    """While open, every Trainer.setup appends a CPU copy of the params it
    hands the loop (the load mode applied, step 0) to `store`."""
    from stjep_tpu_torch.train import trainer as trainer_mod
    from stjep_tpu_torch.train.policies import map_with_path

    orig = trainer_mod.Trainer.setup

    def recording(self, params, cfg):
        out = orig(self, params, cfg)  # Adam then updates these tensors in place
        store.append(map_with_path(out[0], lambda n, t: t.detach().to("cpu", copy=True)))
        return out

    trainer_mod.Trainer.setup = recording
    try:
        yield store
    finally:
        trainer_mod.Trainer.setup = orig


def check_asr_load(step0: dict, asr_ckpt: str) -> int:
    """--load_mode ASR: every `las.` leaf of the joint model at step 0
    equals the ASR checkpoint's leaf of that name (the LAS decoder's
    embedder the checkpoint's enc_embedder where it has no LAS embedder).
    Returns the number of leaves held."""
    loaded = _raw_params(asr_ckpt)
    held = 0
    for name, leaf in _dotted(step0).items():
        if not name.startswith("las."):
            continue
        src = name if name in loaded else (
            "enc_embedder" if name == "las.decoder.embedder" else None)
        need(src is not None and tuple(loaded[src].shape) == tuple(leaf.shape), "asr_st",
             f"{name} has no leaf of its shape in the ASR checkpoint")
        need(torch.equal(leaf, loaded[src].to(leaf.dtype)), "asr_st",
             f"{name} at step 0 differs from the ASR checkpoint's {src}")
        held += 1
    need(held > 0, "asr_st", "the joint model has no las. leaves")
    return held


def check_frozen_las(final: dict, st_ckpt: str, joint_ckpt: str) -> dict:
    """ALL-PARTIAL with --load_freeze True: every leaf whose name holds
    `las` is bit-equal to the joint checkpoint's, in the final params and
    in the stage's checkpoint, and at least one other leaf has moved."""
    joint = _raw_params(joint_ckpt)
    counts = {}
    for label, tree in (("final", _dotted(final)), ("checkpoint", _raw_params(st_ckpt))):
        frozen = moved = 0
        for name, leaf in tree.items():
            if name == "emb_dyn_ave" or name not in joint:
                continue
            same = torch.equal(leaf.cpu(), joint[name].to(leaf.dtype))
            if "las" in name:
                need(same, "st", f"frozen {name} moved ({label} params)")
                frozen += 1
            else:
                moved += not same
        need(frozen > 0, "st", f"no las leaves in the {label} params")
        need(moved > 0, "st", f"no trainable leaf moved ({label} params)")
        counts[label] = {"frozen": frozen, "moved": moved}
    return counts


def _train_argv(mode, save, corpus, flags, epochs, *extra):
    data = {"ASR": ("asr", ("src", "flis")), "MT": ("mt", ("src", "tgt")),
            "ASR_ST": ("st", ("src", "tgt", "flis")), "ST": ("st", ("src", "tgt", "flis"))}
    key, parts = data[mode]
    argv = ["--mode", mode, "--save", save, "--path_vocab_src", corpus["vocab_src"],
            "--path_vocab_tgt", corpus["vocab_tgt"], *flags, "--num_epochs", str(epochs)]
    names = {"src": "path_src", "tgt": "path_tgt", "flis": "acous_path"}
    for split in ("train", "dev"):
        for p in parts:
            argv += [f"--{key}_{split}_{names[p]}", corpus[f"{split}_{p}"]]
    return argv + list(extra)


def _test_argv(corpus, load, out, batch_size):
    return ["--load", load, "--test_path_src", corpus["dev_src"],
            "--test_path_tgt", corpus["dev_tgt"], "--test_acous_path", corpus["dev_flis"],
            "--test_path_out", out, "--batch_size", str(batch_size)]


def run(workdir=None, device="cuda", dims="recipe", corpus=None, log=print) -> dict:
    """The six stages in workdir (a fresh temporary directory when None)
    on `device`. corpus: flagship.write_corpus's path dict (train and dev
    splits) to train on instead of writing one. Returns {"workdir",
    "corpus", "stages": [{"stage", "seconds", "launches", ...}], and the
    stages' outputs "asr_ckpt", "emb", "mt_ckpt", "joint_ckpt", "st_ckpt",
    "translate", "n_test", "decode" (the stage-6 flags)}."""
    from stjep_tpu_torch.cli import train as tcli
    from stjep_tpu_torch.cli import translate as xcli
    from stjep_tpu_torch.utils.profiling import launch_counts, zero_launch_counts

    if dims not in ("recipe", "flagship"):
        raise ValueError(f"dims {dims!r}: recipe or flagship")
    work = Path(workdir or tempfile.mkdtemp(prefix="stjep_recipe_"))
    work.mkdir(parents=True, exist_ok=True)
    dev = torch.device(device)
    if corpus is None:
        if dims == "recipe":
            corpus = recipe_corpus(work / "data")
        else:
            from stjep_tpu_torch.scripts.flagship import CORPUS_UTTS, write_corpus

            corpus = write_corpus(work / "data", 0, utts=CORPUS_UTTS)
    flags, epochs, decode = ((RECIPE_FLAGS, RECIPE_EPOCHS, RECIPE_DECODE) if dims == "recipe"
                             else (flagship_flags(), FLAGSHIP_EPOCHS, flagship_decode()))
    dim_model = int(flags[flags.index("--dim_model") + 1])
    n_test = len(Path(corpus["dev_src"]).read_text(encoding="utf-8").splitlines())
    out = {"workdir": str(work), "corpus": corpus, "stages": [], "n_test": n_test,
           "decode": decode}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def stage(name, fn):
        zero_launch_counts()
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        secs = time.perf_counter() - t0
        got = launch_counts()
        rec = {"stage": name, "seconds": secs, "launches": {k: got[k] for k in COUNTED}}
        out["stages"].append(rec)
        log(f"[recipe] stage={name} seconds={secs:.3f} "
            + " ".join(f"{k.replace(' ', '_')}={v}" for k, v in rec["launches"].items()))
        return res, rec

    def train(mode, save, *extra):
        return tcli.main(_train_argv(mode, str(work / save), corpus, flags, epochs[save], *extra),
                         device=dev)

    # 1. ASR pretrain
    stage("asr", lambda: train("ASR", "asr"))
    out["asr_ckpt"] = _written("asr", str(work / "asr"))

    # 2. the mean dynamic embedding of the ASR model
    emb, _ = stage("emb", lambda: xcli.main(
        ["--eval_mode", "3", *_test_argv(corpus, out["asr_ckpt"], str(work / "emb"),
                                         decode["batch_size"])], device=dev))
    need(emb is not None and os.path.exists(emb), "emb", "no dyn_emb_ave.npy")
    arr = np.load(emb)
    need(arr.shape == (dim_model,) and bool(np.isfinite(arr).all()), "emb",
         f"dyn_emb_ave.npy is {arr.shape}, the MT stage reads ({dim_model},) finite")
    out["emb"] = emb

    # 3. MT pretrain on the artifact
    stage("mt", lambda: train("MT", "mt", "--loss_nll_mt_coeff", "1.0", "--emb_dyn_ave", emb))
    out["mt_ckpt"] = _written("mt", str(work / "mt"))

    # 4. joint ASR_ST from the ASR checkpoint: the LAS loaded at step 0
    step0 = []
    with setup_params(step0):
        stage("asr_st", lambda: train(
            "ASR_ST", "asr_st", "--load", out["asr_ckpt"], "--load_mode", "ASR",
            "--loss_nll_asr_coeff", "1.0", "--loss_nll_st_coeff", "1.0", "--emb_dyn_ave", emb))
    need(len(step0) == 1, "asr_st", f"{len(step0)} Trainer setups")
    out["joint_ckpt"] = _written("asr_st", str(work / "asr_st"))
    out["stages"][-1]["asr_leaves_loaded"] = check_asr_load(step0[0], out["asr_ckpt"])

    # 5. ST finetune, the LAS frozen
    (_, (_, final)), rec = stage("st", lambda: train(
        "ST", "st", "--load", out["joint_ckpt"], "--load_mode", "ALL-PARTIAL",
        "--load_freeze", "True", "--loss_nll_st_coeff", "1.0"))
    out["st_ckpt"] = _written("st", str(work / "st"))
    rec["frozen_check"] = check_frozen_las(final, out["st_ckpt"], out["joint_ckpt"])

    # 6. ST beam decode
    path, _ = stage("decode", lambda: xcli.main(
        ["--eval_mode", "1", "--gen_mode", "ST",
         *_test_argv(corpus, out["st_ckpt"], str(work / "decode"), decode["batch_size"]),
         "--beam_width", str(decode["beam_width"]), "--max_seq_len",
         str(decode["max_seq_len"])], device=dev))
    lines = Path(path).read_text(encoding="utf8").splitlines()
    need(len(lines) == n_test, "decode", f"{len(lines)} lines for {n_test} test utterances")
    out["translate"] = path
    log(f"[recipe] ok workdir={work} decoded={len(lines)} first={lines[0]!r}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workdir", default=None,
                    help="where the stages write (default: a fresh temporary directory)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dims", default="recipe", choices=("recipe", "flagship"))
    args = ap.parse_args(argv)
    res = run(args.workdir, args.device, args.dims)
    print(json.dumps({"stages": res["stages"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
