"""The port's arm of scripts/measure_quality_ab.py: the same staged recipe,
corpus, widths, flags and seeds through the port's CLIs on one device, its
mean dev WER and BLEU held to the band the JAX package recorded.

    python -m stjep_tpu_torch.scripts.quality_ab [--workdir DIR]
        [--epochs_asr 120] [--epochs_joint 120] [--seeds 333,334,335,336,337]
        [--device cuda|cpu] [--out FILE] [--n_train 360] [--n_dev 48]

The corpus is corpus.make_hard_corpus (homophone pairs plant a WER floor
near 0.25): 360 train sentences at seed 0, 48 dev sentences at seed 7. A
seed trains ASR (--load_mode ALL) for epochs_asr epochs, then ASR_ST from
the ASR stage's latest saved checkpoint (--load_mode ASR) for epochs_joint
epochs, then decodes the joint stage's latest saved checkpoint (the best
dev checkpoint: the Trainer saves only where the dev criterion improves)
twice through the translate CLI: ASR greedy and ST beam 5. Each seed is
scored with utils/metrics.py (corpus WER of the ASR lines, corpus BLEU of
the ST lines against dev.src and dev.tgt) and its dev trajectory is read
from each stage's scalars.jsonl.

A finished seed leaves <workdir>/port_s<seed>/result.json and is not run
again; an unfinished one is wiped and run from the start, so that seeds can
run as separate calls on one workdir. The result (--out) holds each seed's
WER, BLEU, seconds, steps, trajectory, card and power limit, the means and
ranges over the seeds, and a digest of the port's sources. A seed's
result.json records its epochs, corpus sizes and device; a resume with
other ones runs the seed again. With all five seeds of SEEDS run,
either mean outside its band (BAND: the JAX package's five-seed mean plus
or minus its recorded band, benchmarks/quality_synthetic_hard.json) exits
1; with fewer, the means are printed and marked partial, and the exit code
is 0.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

N_TRAIN, N_DEV = 360, 48
CKPT_EVERY = 24  # 12 steps an epoch: a dev eval every 2 epochs
SEEDS = (333, 334, 335, 336, 337)

DIMS = dict(
    las_acous_dim=8, las_acous_hidden_size=16, dim_model=32,
    dim_feedforward=64, num_heads=4, enc_layers=2, dec_layers=2,
    embedding_size_enc=16, embedding_size_dec=32,
    max_seq_len_src=10, max_seq_len_tgt=24,
)

# benchmarks/quality_synthetic_hard.json (120 + 120 epochs, seeds 333-337):
# the JAX package's per-seed dev metrics and the torch reference's, and the
# band, the JAX mean plus or minus its recorded band (0.213 +- 0.0715 and
# 0.5839 +- 0.1054)
JAX_PER_SEED = {
    "asr_dev_wer": {333: 0.1688, 334: 0.2403, 335: 0.2273, 336: 0.2273, 337: 0.2013},
    "st_dev_bleu": {333: 0.659, 334: 0.5536, 335: 0.5581, 336: 0.5741, 337: 0.5748},
}
REFERENCE_PER_SEED = {
    "asr_dev_wer": {333: 0.1753, 334: 0.2208, 335: 0.2143, 336: 0.2338, 337: 0.1883},
    "st_dev_bleu": {333: 0.6597, 334: 0.6207, 335: 0.5145, 336: 0.5665, 337: 0.6703},
}
BAND = {"asr_dev_wer": (0.1415, 0.2845), "st_dev_bleu": (0.4785, 0.6893)}
METRICS = tuple(BAND)


def default_out() -> str:
    return str(Path(__file__).resolve().parents[1] / "results" / "quality_synthetic_hard.json")


def common_flags(data):
    """measure_quality_ab.py's common_flags less --use_gpu, which the
    port's CLI accepts and ignores."""
    flags = [
        "--path_vocab_src", f"{data}/vocab.src",
        "--path_vocab_tgt", f"{data}/vocab.tgt",
        "--las_acous_norm", "False", "--use_type", "char",
        "--batch_size", "32", "--minibatch_partition", "1",
        "--checkpoint_every", str(CKPT_EVERY),
        "--print_every", str(CKPT_EVERY),
        "--learning_rate", "0.003", "--learning_rate_init", "0.003",
        "--lr_warmup_steps", "0", "--max_count_no_improve", "300",
        "--max_count_num_rollback", "300",
        "--grab_memory", "False",
    ]
    for k, v in DIMS.items():
        flags += [f"--{k}", str(v)]
    return flags


def asr_flags(data):
    return [
        "--asr_train_path_src", f"{data}/train.src",
        "--asr_train_acous_path", f"{data}/train.flis",
        "--asr_dev_path_src", f"{data}/dev.src",
        "--asr_dev_acous_path", f"{data}/dev.flis",
    ]


def st_flags(data):
    return [
        "--loss_nll_asr_coeff", "1.0", "--loss_nll_st_coeff", "1.0",
        "--st_train_path_src", f"{data}/train.src",
        "--st_train_path_tgt", f"{data}/train.tgt",
        "--st_train_acous_path", f"{data}/train.flis",
        "--st_dev_path_src", f"{data}/dev.src",
        "--st_dev_path_tgt", f"{data}/dev.tgt",
        "--st_dev_acous_path", f"{data}/dev.flis",
    ]


def dec_flags(data, out, gen_mode, beam):
    f = ["--eval_mode", "1", "--gen_mode", gen_mode,
         "--test_path_src", f"{data}/dev.src",
         "--test_path_tgt", f"{data}/dev.tgt",
         "--test_acous_path", f"{data}/dev.flis",
         "--test_path_out", out, "--batch_size", "16",
         "--max_seq_len", "24", "--use_type", "char"]
    if beam:
        f += ["--beam_width", str(beam)]
    return f


def parse_scalars(expt):
    """The dev trajectory in an experiment's scalars.jsonl (tags dev_loss_en,
    dev_accuracy_de, ...): {"EN": [...], "DE": [...]}, points by step."""
    traj = {"EN": [], "DE": []}
    path = os.path.join(expt, "scalars.jsonl")
    if not os.path.exists(path):
        return traj
    by_step = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            tag = rec.get("tag", "")
            if not tag.startswith("dev_"):
                continue
            side = "EN" if tag.endswith("_en") else ("DE" if tag.endswith("_de") else None)
            if side is None:
                continue
            key = (side, rec["step"])
            by_step.setdefault(key, {"step": rec["step"]})
            base = tag[4:].rsplit("_", 1)[0]  # loss | acc | bleu
            by_step[key][base] = round(float(rec["value"]), 4)
    for (side, _), rec in sorted(by_step.items(), key=lambda kv: kv[0][1]):
        traj[side].append(rec)
    return traj


def peak_dev(traj):
    """Best dev point of a trajectory, each side."""
    return {side: {"best_bleu": max(p.get("bleu", 0.0) for p in pts),
                   "best_acc": max(p.get("acc", p.get("accuracy", 0.0)) for p in pts)}
            for side, pts in traj.items() if pts}


def _lines(path):
    with open(path, encoding="utf8") as f:
        return [line.rstrip("\n") for line in f]


def final_metrics(arm, data):
    """Corpus WER of the ASR decode and BLEU of the ST decode on dev."""
    from stjep_tpu_torch.utils.metrics import corpus_bleu, corpus_wer

    asr_hyp = [s.split() for s in _lines(f"{arm}/dec_asr/translate.txt")]
    asr_ref = [s.split() for s in _lines(f"{data}/dev.src")]
    st_hyp = [s.split() for s in _lines(f"{arm}/dec_st/translate.txt")]
    st_ref = [s.split() for s in _lines(f"{data}/dev.tgt")]
    n, m = min(len(asr_hyp), len(asr_ref)), min(len(st_hyp), len(st_ref))
    return {"asr_dev_wer": round(corpus_wer(asr_hyp[:n], asr_ref[:n]), 4),
            "st_dev_bleu": round(corpus_bleu(st_hyp[:m], [[r] for r in st_ref[:m]]), 4),
            "n_decoded": {"asr": n, "st": m}}


def card():
    """nvidia-smi's `name, power.limit` of the first card, or None."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = r.stdout.strip().splitlines()
    return lines[0] if lines else None


def source_digest() -> str:
    """sha256 over the port's Python and CUDA sources (path and bytes, in
    path order): which code ran. The card's checkout carries no git, so
    this, not a commit, names the tree; recompute it on a checkout to
    tell whether a result is that checkout's."""
    pkg = Path(__file__).resolve().parents[1]
    h = hashlib.sha256()
    for p in sorted(pkg.rglob("*")):
        if p.suffix in (".py", ".cu", ".cuh", ".cpp") and "build" not in p.parts:
            h.update(str(p.relative_to(pkg)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def _seed_cached(arm, settings):
    """A finished seed's result where it ran with these settings (epochs,
    corpus sizes, device); an unfinished seed's directory, or one that ran
    with other settings, is wiped."""
    res = os.path.join(arm, "result.json")
    if os.path.exists(res):
        with open(res) as f:
            done = json.load(f)
        if done.get("settings") == settings:
            return done
    if os.path.isdir(arm):
        shutil.rmtree(arm)
    return None


def _seed_done(arm, result):
    tmp = os.path.join(arm, "result.json.tmp")
    with open(tmp, "w") as f:
        json.dump(result, f)
    os.replace(tmp, os.path.join(arm, "result.json"))
    return result


def run_seed(work, data, e_asr, e_joint, seed, corpus, device="cuda", log=print):
    """One seed of the recipe through the port's CLIs on `device`;
    returns (and leaves in <work>/port_s<seed>/result.json) its record.
    corpus: the sentences a split in data ({"train": n, "dev": n}), with
    the epochs and device the settings a resume must match."""
    import torch

    from stjep_tpu_torch.cli import train as tcli
    from stjep_tpu_torch.cli import translate as xcli
    from stjep_tpu_torch.train.checkpoint import Checkpoint

    arm = f"{work}/port_s{seed}"
    settings = {"epochs_asr": e_asr, "epochs_joint": e_joint, "device": str(device),
                "corpus": corpus}
    cached = _seed_cached(arm, settings)
    if cached is not None:
        log(f"  (cached: {arm}/result.json)")
        return cached
    os.makedirs(arm)
    dev = torch.device(device)
    C = common_flags(data) + ["--random_seed", str(seed)]

    def timed(fn):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return res, time.perf_counter() - t0

    (t_asr, _), s_asr = timed(lambda: tcli.main(
        ["--mode", "ASR", "--save", f"{arm}/asr", "--load_mode", "ALL",
         "--num_epochs", str(e_asr), *asr_flags(data), *C], device=dev))
    asr_ckpt = Checkpoint.get_latest_checkpoint(f"{arm}/asr")
    if asr_ckpt is None:
        raise RuntimeError(f"seed {seed}: the ASR stage saved no checkpoint")
    (t_joint, _), s_joint = timed(lambda: tcli.main(
        ["--mode", "ASR_ST", "--save", f"{arm}/asr_st", "--load", asr_ckpt,
         "--load_mode", "ASR", "--num_epochs", str(e_joint), *st_flags(data), *C],
        device=dev))
    joint_ckpt = Checkpoint.get_latest_checkpoint(f"{arm}/asr_st")
    if joint_ckpt is None:
        raise RuntimeError(f"seed {seed}: the ASR_ST stage saved no checkpoint")
    _, s_dec_asr = timed(lambda: xcli.main(
        ["--load", joint_ckpt, *dec_flags(data, f"{arm}/dec_asr", "ASR", 0)], device=dev))
    _, s_dec_st = timed(lambda: xcli.main(
        ["--load", joint_ckpt, *dec_flags(data, f"{arm}/dec_st", "ST", 5)], device=dev))
    traj = {"asr_stage": parse_scalars(f"{arm}/asr"),
            "joint_stage": parse_scalars(f"{arm}/asr_st")}

    def loop(t):
        tm = t.timing
        return {"steps": t.steps_run, "loop_s": tm["loop_s"], "eval_s": tm["eval_s"],
                "save_s": tm["save_s"]}

    return _seed_done(arm, {
        "seed": seed, "settings": settings,
        "device": str(dev), "card": card() if dev.type == "cuda" else None,
        "wall_s": {"asr": s_asr, "joint": s_joint, "dec_asr": s_dec_asr, "dec_st": s_dec_st,
                   "total": s_asr + s_joint + s_dec_asr + s_dec_st},
        "steps": {"asr": t_asr.steps_run, "joint": t_joint.steps_run},
        "loop": {"asr": loop(t_asr), "joint": loop(t_joint)},
        "checkpoints": {"asr": os.path.basename(asr_ckpt),
                        "joint": os.path.basename(joint_ckpt)},
        "best_dev_joint": peak_dev(traj["joint_stage"]),
        "trajectory": traj,
        **final_metrics(arm, data),
    })


def summarize(runs):
    """Mean, min and max over the seeds of each metric, and the seeds'
    values."""
    out = {}
    for key in METRICS:
        vals = [r[key] for r in runs]
        out[key] = {"mean": round(sum(vals) / len(vals), 4), "min": min(vals),
                    "max": max(vals), "per_seed": {str(r["seed"]): r[key] for r in runs}}
    return out


def verdict(means: dict, seeds) -> tuple:
    """("partial", []) unless every seed of SEEDS ran; then ("pass", []) or
    ("fail", [what lies outside BAND])."""
    if not set(SEEDS) <= set(seeds):
        return "partial", []
    bad = [f"{k}: mean {means[k]} outside [{lo}, {hi}]"
           for k, (lo, hi) in BAND.items() if not lo <= means[k] <= hi]
    return ("fail" if bad else "pass"), bad


def seed_table(runs):
    """Each seed's metrics beside JAX's and the reference's for that seed."""
    return [{"seed": r["seed"], **{f"{k}_{who}": v for k in METRICS for who, v in (
        ("port", r[k]), ("jax", JAX_PER_SEED[k].get(int(r["seed"]))),
        ("reference", REFERENCE_PER_SEED[k].get(int(r["seed"]))))}} for r in runs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workdir", default=None,
                    help="the corpus and one directory a seed (default: a fresh temporary "
                         "directory); reuse it to resume")
    ap.add_argument("--epochs_asr", type=int, default=120)
    ap.add_argument("--epochs_joint", type=int, default=120)
    ap.add_argument("--seeds", default=",".join(map(str, SEEDS)))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="the result's JSON (default stjep_tpu_torch/results/"
                         "quality_synthetic_hard.json)")
    ap.add_argument("--n_train", type=int, default=N_TRAIN, help="train sentences (360)")
    ap.add_argument("--n_dev", type=int, default=N_DEV, help="dev sentences (48)")
    args = ap.parse_args(argv)
    from stjep_tpu_torch.scripts.corpus import HARD_N_PAIRS, HARD_N_WORDS, make_hard_corpus

    work = args.workdir or tempfile.mkdtemp(prefix="stjep_quality_")
    seeds = [int(s) for s in args.seeds.split(",")]
    data = os.path.join(work, "data")
    make_hard_corpus(data, n_sent=args.n_train, seed=0, prefix="train")
    make_hard_corpus(data, n_sent=args.n_dev, seed=7, prefix="dev")

    runs = []
    for seed in seeds:
        print(f"[quality] seed {seed}", flush=True)
        r = run_seed(work, data, args.epochs_asr, args.epochs_joint, seed,
                     {"train": args.n_train, "dev": args.n_dev}, args.device)
        runs.append(r)
        print(json.dumps({k: r[k] for k in ("seed", *METRICS, "wall_s", "steps")}), flush=True)

    summary = summarize(runs)
    means = {k: summary[k]["mean"] for k in METRICS}
    status, failures = verdict(means, seeds)
    result = {
        "corpus": {"train_sents": args.n_train, "dev_sents": args.n_dev,
                   "task": "synthetic hard ST (corpus.make_hard_corpus)",
                   "bayes_wer_floor_approx": HARD_N_PAIRS / HARD_N_WORDS},
        "config": DIMS,
        "epochs": {"asr": args.epochs_asr, "joint": args.epochs_joint},
        "seeds": seeds,
        "selection": "latest saved checkpoint of the joint stage (saved only where the dev "
                     "criterion improves)",
        "recipe": "ASR (load_mode ALL) -> ASR_ST (load_mode ASR), constant LR 0.003, batch 32",
        "device": args.device,
        "cards": sorted({r["card"] for r in runs if r.get("card")}),
        "source_sha256": source_digest(),
        "summary": summary,
        "band": {k: list(v) for k, v in BAND.items()},
        "status": status,
        "failures": failures,
        "per_seed_vs_jax_and_reference": seed_table(runs),
        "runs": runs,
    }
    out = args.out or default_out()
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=2)
    for row in result["per_seed_vs_jax_and_reference"]:
        print(json.dumps(row), flush=True)
    print(f"[quality] {status} mean asr_dev_wer={means['asr_dev_wer']} "
          f"band={list(BAND['asr_dev_wer'])} mean st_dev_bleu={means['st_dev_bleu']} "
          f"band={list(BAND['st_dev_bleu'])} seeds={seeds} wrote={out}", flush=True)
    if status == "fail":
        print("[quality] out of band: " + "; ".join(failures), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
