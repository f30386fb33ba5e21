"""The port of scripts/measure_quality.py: the staged recipe trained to
quality on the learnable synthetic corpus through the port's CLIs on one
device, its dev WER and BLEU held to the gate the JAX package met.

    python -m stjep_tpu_torch.scripts.quality [--profile tiny|kernel]
        [--dtype float32|bfloat16] [--staging none|int8|cache|cache_int8]
        [--device cuda|cpu] [--workdir DIR] [--out FILE]
        [--n_train 360] [--n_dev 48] [--epochs_asr 80] [--epochs_joint N]

The corpus is corpus.make_corpus(learnable=True): 360 train sentences at
seed 0, 48 dev sentences at seed 7. The stages (measure_quality.py:137-237),
each through cli/train.py main or cli/translate.py main in this process:
1. ASR pretrain, EPOCHS_ASR epochs;
2. translate mode 3 of the ASR stage's latest checkpoint over the train
   split: dyn_emb_ave.npy;
3. joint ASR_ST from that checkpoint (--load_mode ASR) with the artifact,
   EPOCHS_JOINT epochs at the common LR, or JOINT_HP's for the profile;
4. ASR greedy and ST beam-5 decodes of the joint stage's latest checkpoint
   on dev, scored by quality_ab.final_metrics (corpus WER and BLEU).

`--profile tiny` is D 32 (the LAS decoder runs its step loop: JAX's gate
`las_flash_supported` wants D and 2H multiples of 128); `--profile kernel`
is D 128 with acoustic hidden 64, which passes the gate, so K9 runs in
every training step and K2 in every dev eval and free-running decode.
`--dtype bfloat16` trains in bf16; `--staging` adds --feat_dtype int8
and/or --device_cache True to every stage.

The result (default stjep_tpu_torch/results/quality_synthetic[_<profile>]
[_bf16][_<staging>].json, measure_quality.py's names) holds WER and BLEU,
each stage's seconds and kernel launches (utils/profiling.py; on the CPU
the wrappers run their plain versions and count nothing), each training
stage's steps, loop steps/s (dev evals and checkpoint writes left out), its
dev-eval batches (`forward_eval` calls), and how many steps and dev-eval
batches launched each kernel; the card and its power limit and
source_sha256.
Exit 1 where WER > 0.02 or BLEU < 0.98 (GATE; the JAX records read 0.0 and
1.0), or where a kernel the profile routes through did not launch on the
card (`route_problems`). A run with other corpus sizes or epochs than the
defaults is marked short and its metrics are not judged.
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

N_TRAIN = 360
N_DEV = 48
EPOCHS_ASR = 80
EPOCHS_JOINT = 80

PROFILES = {
    "tiny": dict(
        las_acous_dim=8, las_acous_hidden_size=16, dim_model=32,
        dim_feedforward=64, num_heads=4, enc_layers=2, dec_layers=2,
        embedding_size_enc=16, embedding_size_dec=32,
        max_seq_len_src=10, max_seq_len_tgt=24,
    ),
    "kernel": dict(
        las_acous_dim=8, las_acous_hidden_size=64, dim_model=128,
        dim_feedforward=256, num_heads=4, enc_layers=2, dec_layers=2,
        embedding_size_enc=16, embedding_size_dec=32,
        max_seq_len_src=10, max_seq_len_tgt=24,
    ),
}
# the joint stage's overrides (the kernel profile plateaus at LR 0.003)
JOINT_HP = {
    "tiny": {},
    "kernel": {"learning_rate": "0.001", "learning_rate_init": "0.001",
               "epochs": 120},
}
STAGINGS = ("none", "int8", "cache", "cache_int8")
DTYPES = ("float32", "bfloat16")
# the gate, and the JAX package's records it was set from (profile, dtype)
GATE = {"asr_dev_wer": 0.02, "st_dev_bleu": 0.98}  # at most; at least
JAX_RECORDS = {
    ("tiny", "float32"): {"file": "benchmarks/quality_synthetic.json", "backend": "cpu",
                          "asr_dev_wer": 0.0, "st_dev_bleu": 1.0},
    ("tiny", "bfloat16"): {"file": "benchmarks/quality_synthetic_bf16.json", "backend": "tpu",
                           "asr_dev_wer": 0.0, "st_dev_bleu": 1.0},
    ("kernel", "float32"): {"file": "benchmarks/quality_synthetic_kernel.json",
                            "backend": "tpu", "asr_dev_wer": 0.0, "st_dev_bleu": 1.0},
}
STAGES = ("asr", "emb", "asr_st", "dec_asr", "dec_st")
TRAINING = ("asr", "asr_st")
STEP_KERNELS = ("K8 fwd", "K8 bwd", "K9 fwd", "K9 bwd")
EVAL_KERNELS = ("K1", "K2", "K3 gather")


def common_flags(data, dims):
    """measure_quality.py's common_flags."""
    flags = [
        "--path_vocab_src", f"{data}/vocab.src",
        "--path_vocab_tgt", f"{data}/vocab.tgt",
        "--las_acous_norm", "False", "--use_type", "char",
        "--batch_size", "32", "--minibatch_partition", "1",
        "--checkpoint_every", "12", "--print_every", "12",
        "--learning_rate", "0.003", "--learning_rate_init", "0.003",
        "--lr_warmup_steps", "0", "--max_count_no_improve", "30",
        "--max_count_num_rollback", "30",
    ]
    for k, v in dims.items():
        flags += [f"--{k}", str(v)]
    return flags


def staging_flags(staging):
    """measure_quality.py's staging levers: int8 features, the device cache."""
    if staging not in STAGINGS:
        raise ValueError(f"staging {staging!r}: one of {STAGINGS}")
    return ((["--feat_dtype", "int8"] if "int8" in staging else [])
            + (["--device_cache", "True"] if staging.startswith("cache") else []))


def result_name(profile, dtype, staging):
    name = "quality_synthetic"
    if profile != "tiny":
        name += f"_{profile}"
    if dtype != "float32":
        name += "_bf16"
    if staging != "none":
        name += f"_{staging}"
    return name + ".json"


def default_out(profile, dtype, staging) -> str:
    return str(Path(__file__).resolve().parents[1] / "results"
               / result_name(profile, dtype, staging))


def gate(metrics):
    """(passed, [what lies outside GATE])."""
    bad = []
    if not metrics["asr_dev_wer"] <= GATE["asr_dev_wer"]:
        bad.append(f"asr_dev_wer {metrics['asr_dev_wer']} > {GATE['asr_dev_wer']}")
    if not metrics["st_dev_bleu"] >= GATE["st_dev_bleu"]:
        bad.append(f"st_dev_bleu {metrics['st_dev_bleu']} < {GATE['st_dev_bleu']}")
    return not bad, bad


def route_problems(stages, profile, device) -> list:
    """What the stages' launches say against the profile's route on the
    card: K8 in every training step, K3 and K4 (the tiny profile) or K4's
    select (the kernel one) in the ST beam; at the kernel profile K9
    forward and backward in every training step, K2 in every dev-eval
    batch and in both decodes, K9's forward in mode 3; at the tiny one no
    K2 or K9 at all.
    On the CPU nothing launches and nothing is checked."""
    if str(device).split(":")[0] != "cuda":
        return []
    bad = []
    kernel = profile == "kernel"
    for name in TRAINING:
        s = stages[name]
        for k in STEP_KERNELS:
            want = s["steps"] if (kernel or k.startswith("K8")) else 0
            if s["steps_with"][k] != want:
                bad.append(f"{name}: {s['steps_with'][k]} of {s['steps']} steps launched {k}, "
                           f"want {want}")
        want = s["dev_evals"] if kernel else 0
        if not s["dev_evals"] or s["dev_evals_with"]["K2"] != want:
            bad.append(f"{name}: {s['dev_evals_with']['K2']} of {s['dev_evals']} dev evals "
                       f"launched K2, want {want}")
    # the ST beam: K3 at position 1, then the megastep K4, or at the kernel
    # profile (the decoder projects its 32-wide embeddings to D) the
    # general loop, K3 and K4's select a position
    need = [("dec_st", "K3"), ("dec_st", "K4 select" if kernel else "K4")] + (
        [("emb", "K9 fwd"), ("dec_asr", "K2"), ("dec_st", "K2")] if kernel else [])
    bad += [f"{name}: {k} never launched" for name, k in need
            if not stages[name]["launches"][k]]
    if not kernel:
        bad += [f"{name}: {k} launched {stages[name]['launches'][k]} times at D 32"
                for name in STAGES for k in ("K2", "K9 fwd", "K9 bwd")
                if stages[name]["launches"][k]]
    return bad


@contextlib.contextmanager
def per_call_launches(owner, name, store):
    """While open, each call of owner.<name> appends the kernel launches
    made inside it (utils/profiling.py's counts, before and after) to
    `store`."""
    from stjep_tpu_torch.utils.profiling import launch_counts

    orig = getattr(owner, name)

    def counting(*a, **kw):
        before = launch_counts()
        out = orig(*a, **kw)
        after = launch_counts()
        store.append({k: after[k] - before[k] for k in after})
        return out

    setattr(owner, name, counting)
    try:
        yield store
    finally:
        setattr(owner, name, orig)


def _calls_with(calls, kernels):
    return {k: sum(1 for c in calls if c[k] > 0) for k in kernels}


def run(profile="tiny", dtype="float32", staging="none", device="cuda", workdir=None,
        n_train=N_TRAIN, n_dev=N_DEV, epochs_asr=EPOCHS_ASR, epochs_joint=None,
        on_stage=None, log=print) -> dict:
    """The four stages in workdir (a fresh temporary directory when None) on
    `device`; on_stage(name) is called as each stage starts. Returns the
    result (module docstring) without writing it."""
    import torch

    from stjep_tpu_torch.cli import train as tcli
    from stjep_tpu_torch.cli import translate as xcli
    from stjep_tpu_torch.scripts.corpus import make_corpus
    from stjep_tpu_torch.scripts.full_recipe import COUNTED
    from stjep_tpu_torch.scripts.quality_ab import (asr_flags, card, dec_flags, final_metrics,
                                                    source_digest, st_flags)
    from stjep_tpu_torch.train import trainer as trainer_mod
    from stjep_tpu_torch.train.checkpoint import Checkpoint
    from stjep_tpu_torch.utils.profiling import launch_counts, zero_launch_counts

    if profile not in PROFILES or dtype not in DTYPES:
        raise ValueError(f"profile {profile!r}, dtype {dtype!r}")
    dims, hp = PROFILES[profile], JOINT_HP[profile]
    e_joint = epochs_joint if epochs_joint is not None else hp.get("epochs", EPOCHS_JOINT)
    short = (n_train, n_dev, epochs_asr, e_joint) != (
        N_TRAIN, N_DEV, EPOCHS_ASR, hp.get("epochs", EPOCHS_JOINT))
    work = Path(workdir or tempfile.mkdtemp(prefix="stjep_quality_"))
    work.mkdir(parents=True, exist_ok=True)
    data = str(work / "data")
    make_corpus(data, n_sent=n_train, learnable=True, seed=0, prefix="train")
    make_corpus(data, n_sent=n_dev, learnable=True, seed=7, prefix="dev")
    dev = torch.device(device)
    C = common_flags(data, dims) + ["--dtype", dtype] + staging_flags(staging)
    J = list(C)
    for flag in ("learning_rate", "learning_rate_init"):
        if flag in hp:
            J[J.index(f"--{flag}") + 1] = hp[flag]
    stages = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def stage(name, fn):
        if on_stage is not None:
            on_stage(name)
        steps, evals = [], []
        zero_launch_counts()
        sync()
        t0 = time.perf_counter()
        with per_call_launches(trainer_mod.Trainer, "_step", steps), \
                per_call_launches(trainer_mod, "forward_eval", evals):
            res = fn()
        sync()
        secs = time.perf_counter() - t0
        got = launch_counts()
        rec = {"seconds": secs, "launches": {k: got[k] for k in COUNTED + ("K4 select",)}}
        if name in TRAINING:
            t = res[0]
            tm = t.timing
            train_s = tm["loop_s"] - tm["eval_s"] - tm["save_s"]
            rec.update(steps=t.steps_run, loop_s=tm["loop_s"], eval_s=tm["eval_s"],
                       save_s=tm["save_s"],
                       loop_steps_per_s=t.steps_run / train_s if train_s > 0 else None,
                       steps_with=_calls_with(steps, STEP_KERNELS), dev_evals=len(evals),
                       dev_evals_with=_calls_with(evals, EVAL_KERNELS))
        stages[name] = rec
        log(f"[quality] stage={name} seconds={secs:.3f} "
            + " ".join(f"{k.replace(' ', '_')}={v}" for k, v in rec["launches"].items())
            + (f" steps={rec['steps']} dev_evals={rec['dev_evals']}" if name in TRAINING else ""))
        return res

    def latest(save):
        path = Checkpoint.get_latest_checkpoint(save)
        if path is None:
            raise RuntimeError(f"no checkpoint saved under {save}")
        return path

    stage("asr", lambda: tcli.main(
        ["--mode", "ASR", "--save", str(work / "asr"), "--num_epochs", str(epochs_asr),
         *asr_flags(data), *C], device=dev))
    asr_ckpt = latest(str(work / "asr"))
    emb = stage("emb", lambda: xcli.main(
        ["--eval_mode", "3", "--load", asr_ckpt, "--test_path_src", f"{data}/train.src",
         "--test_path_tgt", f"{data}/train.tgt", "--test_acous_path", f"{data}/train.flis",
         "--test_path_out", str(work / "emb"), "--batch_size", "32"], device=dev))
    stage("asr_st", lambda: tcli.main(
        ["--mode", "ASR_ST", "--save", str(work / "asr_st"), "--num_epochs", str(e_joint),
         "--load", asr_ckpt, "--load_mode", "ASR", "--emb_dyn_ave", emb, *st_flags(data), *J],
        device=dev))
    joint_ckpt = latest(str(work / "asr_st"))
    stage("dec_asr", lambda: xcli.main(
        ["--load", joint_ckpt, *dec_flags(data, str(work / "dec_asr"), "ASR", 0)], device=dev))
    stage("dec_st", lambda: xcli.main(
        ["--load", joint_ckpt, *dec_flags(data, str(work / "dec_st"), "ST", 5)], device=dev))

    metrics = final_metrics(str(work), data)
    passed, failures = gate(metrics)
    problems = route_problems(stages, profile, dev)
    return {
        "corpus": {"train_sents": n_train, "dev_sents": n_dev,
                   "task": "synthetic learnable ST (corpus.make_corpus, learnable=True)"},
        "config": dims, "profile": profile, "dtype": dtype, "staging": staging,
        "epochs": {"asr": epochs_asr, "joint": e_joint}, "joint_hp": hp,
        **metrics,
        "train_wall_s": {k: stages[k]["seconds"] for k in TRAINING},
        "short": short,
        "gate": {"asr_dev_wer_max": GATE["asr_dev_wer"], "st_dev_bleu_min": GATE["st_dev_bleu"],
                 "jax_record": JAX_RECORDS.get((profile, dtype)),
                 "status": "not judged (short run)" if short else ("pass" if passed else "fail"),
                 "failures": [] if short else failures},
        "routes": {"status": "fail" if problems else "pass", "problems": problems},
        "stages": stages,
        "checkpoints": {"asr": os.path.basename(asr_ckpt),
                        "joint": os.path.basename(joint_ckpt)},
        "device": str(dev), "card": card() if dev.type == "cuda" else None,
        "source_sha256": source_digest(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", default="tiny", choices=tuple(PROFILES))
    ap.add_argument("--dtype", default="float32", choices=DTYPES)
    ap.add_argument("--staging", default="none", choices=STAGINGS)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--workdir", default=None,
                    help="the corpus and the stages' output (default: a fresh temporary "
                         "directory)")
    ap.add_argument("--out", default=None,
                    help="the result's JSON (default stjep_tpu_torch/results/"
                         "quality_synthetic[_<profile>][_bf16][_<staging>].json)")
    ap.add_argument("--n_train", type=int, default=N_TRAIN, help="train sentences (360)")
    ap.add_argument("--n_dev", type=int, default=N_DEV, help="dev sentences (48)")
    ap.add_argument("--epochs_asr", type=int, default=EPOCHS_ASR)
    ap.add_argument("--epochs_joint", type=int, default=None,
                    help="joint epochs (default 80; the kernel profile's JOINT_HP 120)")
    args = ap.parse_args(argv)
    res = run(args.profile, args.dtype, args.staging, args.device, args.workdir, args.n_train,
              args.n_dev, args.epochs_asr, args.epochs_joint,
              log=lambda line: print(line, flush=True))
    out = args.out or default_out(args.profile, args.dtype, args.staging)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(res, f, indent=2)
    g, r = res["gate"], res["routes"]
    print(f"[quality] profile={args.profile} dtype={args.dtype} staging={args.staging} "
          f"device={res['device']} asr_dev_wer={res['asr_dev_wer']} "
          f"st_dev_bleu={res['st_dev_bleu']} gate={g['status']} routes={r['status']} "
          f"card={res['card']!r} wrote={out}", flush=True)
    for line in g["failures"] + r["problems"]:
        print(f"[quality] {line}", flush=True)
    return 1 if g["status"] == "fail" or r["status"] == "fail" else 0


if __name__ == "__main__":
    sys.exit(main())
