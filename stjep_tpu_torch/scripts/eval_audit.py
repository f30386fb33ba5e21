"""The port of scripts/run_eval_audit.py: every translate surface of the
port's CLI on one device, each cell also held against the same call on
the CPU.

    python -m stjep_tpu_torch.scripts.eval_audit [--dims audit|kernel]
        [--device cuda|cpu] [--workdir DIR] [--out FILE] [--cells NAME,...]

The matrix (run_eval_audit.py:113-157), each cell one call of
cli/translate.py main(argv, device=) with that script's argv:
  eval mode 1 x gen mode {ASR, ASR-REF, MT, ST, ST-REF, ST_BASE}
              x LM {off, s-4g_0.5}                       (12 decodes)
  eval mode 2 (the per-epoch checkpoints averaged)
  eval mode 3 (dyn_emb_ave.npy)
  eval mode 4 (the embedding projector)

The checkpoint comes from a 2-epoch ASR_ST run on the audit's own corpus
(corpus.make_corpus, N_SENT learnable sentences, no dev set, so one
checkpoint an epoch under checkpoints_epoch/), at `--dims audit`
(run_eval_audit.py's DIMS: D 12, acoustic hidden 6) or `--dims kernel`
(quality.py's kernel profile: D 128, acoustic hidden 64, which passes
JAX's gate for the fused LAS kernels). The LM is the script's dict n-gram
export (:86-91), written with pickle (the card's host has no dill); the
CLI builds the device table from it.

A cell passes, as in JAX's audit, where the call returns and its artifact
exists (mode 1: translate.txt with N_SENT lines), and besides where it
agrees with the same call on the CPU: mode 1 lines equal; mode 2 the
combined params bit-equal to the leaf-wise mean of the checkpoints, on
both devices; mode 3 dyn_emb_ave.npy within REL_TOL; mode 4
select_emb_rows (the rows the projector shows) within ROW_TOL, and where
torch.utils.tensorboard cannot be imported the cell records
"projector": "tensorboard absent" and is held on the rows alone. On the
card each cell's launches are counted (utils/profiling.py), and a cell
fails where K2 or K9 launches under an LM (the LAS runs its step loop
there), or, at --dims kernel without an LM, where K2 does not launch in
ASR, ST and ST_BASE or K9's forward in ASR-REF and ST-REF.

The result (default stjep_tpu_torch/results/eval_audit_<dims>.json) has
n_pass and n_fail as JAX's, and each cell's seconds on both devices, its
launches and what was held. Exit 1 on any failed cell.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import tempfile
import time
import traceback
from pathlib import Path

N_SENT = 16
DIMS = {
    "audit": [
        "--las_acous_dim", "8", "--las_acous_hidden_size", "6",
        "--dim_model", "12", "--dim_feedforward", "24", "--num_heads", "2",
        "--enc_layers", "2", "--dec_layers", "2",
        "--embedding_size_enc", "8", "--embedding_size_dec", "12",
        "--max_seq_len_src", "16", "--max_seq_len_tgt", "32",
    ],
}
GEN_MODES = ("ASR", "ASR-REF", "MT", "ST", "ST-REF", "ST_BASE")
LM_MODE = "s-4g_0.5"
CELLS = tuple(f"mode1_{gm}" + ("_lm" if lm else "") for gm in GEN_MODES for lm in (None, LM_MODE)
              ) + ("mode2_combine", "mode3_gather_emb", "mode4_plot_emb")
REL_TOL = 1e-5  # mode 3's mean embedding, card against CPU, relative
ROW_TOL = 1e-5  # mode 4's rows, card against CPU, relative to their largest magnitude
LAS_IDLE_UNDER_LM = ("K2", "K9 fwd", "K9 bwd")
# --dims kernel without an LM: the kernel each gen mode's LAS pass runs
LAS_KERNEL = {"ASR": "K2", "ST": "K2", "ST_BASE": "K2", "ASR-REF": "K9 fwd",
              "ST-REF": "K9 fwd"}


def dims_flags(dims):
    if dims == "kernel":
        from stjep_tpu_torch.scripts.quality import PROFILES

        return [x for k, v in PROFILES["kernel"].items() for x in (f"--{k}", str(v))]
    if dims not in DIMS:
        raise ValueError(f"dims {dims!r}: audit or kernel")
    return list(DIMS[dims])


def train_argv(corpus, save, dims):
    """run_eval_audit.py's ASR_ST training argv (:55-70)."""
    return [
        "--mode", "ASR_ST", "--save", save,
        "--st_train_path_src", corpus["path_src"],
        "--st_train_path_tgt", corpus["path_tgt"],
        "--st_train_acous_path", corpus["acous_path"],
        "--path_vocab_src", corpus["path_vocab_src"],
        "--path_vocab_tgt", corpus["path_vocab_tgt"],
        "--las_acous_norm", "False", "--use_type", "char",
        "--batch_size", "8", "--minibatch_partition", "1",
        "--num_epochs", "2", "--checkpoint_every", "1000000",
        "--print_every", "1000000", "--learning_rate", "0.003",
        "--learning_rate_init", "0.003", "--lr_warmup_steps", "0",
        "--loss_nll_asr_coeff", "1.0", "--loss_nll_st_coeff", "1.0",
        "--use_gpu", "False", "--grab_memory", "False", *dims_flags(dims),
    ]


def lm_export(vocab_tgt_size):
    """run_eval_audit.py's dict n-gram export (:86-91): unigram log-probs
    over the target vocabulary and light bigrams after id 5."""
    entries = {(i,): -1.0 for i in range(vocab_tgt_size)}
    entries.update({(5, i): -0.5 for i in range(5, 10)})
    return {"entries": entries, "backoffs": {(i,): -0.3 for i in range(5, 10)}}


def base_argv(corpus, load):
    return ["--load", load,
            "--test_path_src", corpus["path_src"],
            "--test_path_tgt", corpus["path_tgt"],
            "--test_acous_path", corpus["acous_path"],
            "--batch_size", "8", "--use_type", "char"]


def cell_argv(name, base, out, lm_path, combine_path):
    """The translate argv of a cell (run_eval_audit.py:114-157), writing to out."""
    if name.startswith("mode1_"):
        gm = name[len("mode1_"):].removesuffix("_lm")
        argv = ["--eval_mode", "1", "--gen_mode", gm, "--test_path_out", out,
                "--beam_width", "2", "--max_seq_len", "32", *base]
        return argv + (["--lm_mode", LM_MODE, "--lm_path", lm_path]
                       if name.endswith("_lm") else [])
    if name == "mode2_combine":
        return ["--eval_mode", "2", "--combine_path", combine_path, "--test_path_out", out,
                *base]
    return ["--eval_mode", "3" if name == "mode3_gather_emb" else "4", "--test_path_out", out,
            *base]


def default_out(dims) -> str:
    return str(Path(__file__).resolve().parents[1] / "results" / f"eval_audit_{dims}.json")


def _mean_params(combine_path, template):
    """The leaf-wise mean, in float64 then each leaf's dtype, of the
    checkpoints under combine_path, as named leaves."""
    from stjep_tpu_torch.bridge import named_leaves
    from stjep_tpu_torch.train.checkpoint import Checkpoint

    trees = [named_leaves(Checkpoint.load(os.path.join(combine_path, d),
                                          params_template=template).params)
             for d in sorted(os.listdir(combine_path))]
    return [(n, (sum(t[i][1].double() for t in trees) / len(trees)).to(leaf.dtype))
            for i, (n, leaf) in enumerate(trees[0])]


def _rel(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = float(np.abs(b).max()) if b.size else 0.0
    err = float(np.abs(a - b).max()) if b.size else 0.0
    return err / scale if scale > 0 else err


def hold(name, argv, outs, device):
    """What a cell's outputs on `device` and on the CPU show against each
    other (modes 1, 3 and 4): (ok, details)."""
    import numpy as np

    from stjep_tpu_torch.cli import translate as xcli

    if name.startswith("mode1_"):
        lines = [Path(o).read_text(encoding="utf8").splitlines() for o in outs]
        differ = [i for i, (a, b) in enumerate(zip(*lines)) if a != b]
        ok = all(len(x) == N_SENT for x in lines) and not differ
        return ok, {"lines": len(lines[0]), "rows_differ": differ,
                    "nonempty_rows": sum(map(bool, lines[0]))}
    if name == "mode3_gather_emb":
        a, b = (np.load(o) for o in outs)
        rel = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
        return (a.shape == b.shape and bool(np.isfinite(a).all()) and rel <= REL_TOL,
                {"shape": list(a.shape), "rel_err": rel, "tol": REL_TOL})
    # mode 4: the projector's rows on both devices
    config = xcli.parse_config(argv)
    rows = []
    for d in (device, "cpu"):
        cfg, params, ckpt = xcli._load_model(config["load"], d)
        ds = xcli.build_test_set(config, ckpt)
        ds.construct_batches(is_train=False)
        rows.append(xcli.select_emb_rows(ds, cfg, params, ds.materialise_batch(0), d))
    errs = {k: _rel(rows[0][k], rows[1][k]) for k in ("dyn", "static")}
    same_ids = all(np.array_equal(rows[0][k], rows[1][k]) for k in ("hyp_ids", "ref_ids"))
    out = outs[0]
    wrote = out is not None and any(Path(out).rglob("events.out.tfevents*"))
    return (same_ids and all(e <= ROW_TOL for e in errs.values())
            and (out is None or wrote),
            {"rows": int(rows[0]["dyn"].shape[0]), "rel_err": errs, "tol": ROW_TOL,
             "ids_equal": same_ids,
             "projector": "written" if wrote else (
                 "tensorboard absent" if out is None else "missing")})


def launch_problems(name, got, dims):
    """The cell's card launches against its route."""
    gm = name[len("mode1_"):].removesuffix("_lm") if name.startswith("mode1_") else None
    bad = []
    if name.endswith("_lm"):
        bad += [f"{k} launched {got[k]} times under an LM" for k in LAS_IDLE_UNDER_LM
                if got[k]]
    elif dims == "kernel" and gm in LAS_KERNEL and not got[LAS_KERNEL[gm]]:
        bad.append(f"{LAS_KERNEL[gm]} never launched")
    if dims == "audit":
        bad += [f"{k} launched {got[k]} times at D 12" for k in LAS_IDLE_UNDER_LM if got[k]]
    if gm == "MT":
        bad += [f"{k} launched {got[k]} times in MT" for k in ("K1", "K2", "K9 fwd") if got[k]]
    return bad


def run_cell(name, argv_of, device, combine_path, template_of):
    """One cell on `device`, then on the CPU: (record, outputs, the card
    arm's launches). Mode 2 writes both arms to one directory, so each
    arm's combined params are held against the mean as it finishes."""
    import torch

    from stjep_tpu_torch.bridge import named_leaves
    from stjep_tpu_torch.cli import translate as xcli
    from stjep_tpu_torch.train.checkpoint import Checkpoint
    from stjep_tpu_torch.utils.profiling import launch_counts, zero_launch_counts

    rec, outs, secs = {}, [], []
    for arm in (device, "cpu"):
        cuda = torch.device(arm).type == "cuda"
        zero_launch_counts()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = xcli.main(argv_of(arm), device=arm)
        if cuda:
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if arm == device:
            got = launch_counts()
        if name == "mode2_combine":
            mean = _mean_params(combine_path, template_of())
            leaves = named_leaves(Checkpoint.load(out, params_template=template_of()).params)
            rec.setdefault("leaves_not_the_mean", {})[str(arm)] = sum(
                not torch.equal(a, b) for (_, a), (_, b) in zip(leaves, mean, strict=True))
            rec.update(leaves=len(mean), ckpts=sorted(os.listdir(combine_path)))
        outs.append(out)
    rec["wall_s"], rec["cpu_s"] = secs
    rec["launches"] = {k: v for k, v in got.items() if v}
    return rec, outs, got


def run(workdir=None, dims="audit", device="cuda", load=None, combine_path=None, cells=None,
        log=print) -> dict:
    """The audit in workdir (a fresh temporary directory when None) on
    `device`, every cell also on the CPU. load: a checkpoint to audit
    instead of training one (then combine_path: the directory of
    checkpoints mode 2 averages); cells: the names to run (default
    CELLS). Returns the summary (module docstring) without writing it."""
    import torch

    from stjep_tpu_torch.cli import train as tcli
    from stjep_tpu_torch.cli import translate as xcli
    from stjep_tpu_torch.scripts.corpus import make_corpus
    from stjep_tpu_torch.scripts.quality_ab import card, source_digest

    work = Path(workdir or tempfile.mkdtemp(prefix="stjep_eval_audit_"))
    work.mkdir(parents=True, exist_ok=True)
    dev = torch.device(device)
    corpus = make_corpus(str(work / "data"), n_sent=N_SENT, learnable=True)
    train_s = None
    if load is None:
        t0 = time.perf_counter()
        tcli.main(train_argv(corpus, str(work / "expt"), dims), device=dev)
        train_s = time.perf_counter() - t0
        # no dev set: one checkpoint an epoch (checkpoints_epoch/<n>)
        combine_path = str(work / "expt" / "checkpoints_epoch")
        load = os.path.join(combine_path, "2")
        if not os.path.isdir(load):
            raise RuntimeError(f"the audit's training wrote no {load}")
    lm_path = str(work / "lm.pkl")
    with open(lm_path, "wb") as f:
        pickle.dump(lm_export(corpus["vocab_tgt_size"]), f)
    base = base_argv(corpus, load)
    template = {}

    def template_of():
        if not template:
            template["p"] = xcli._load_model(load, "cpu")[1]
        return template["p"]

    runs = {}
    for name in cells or CELLS:
        argv_of = lambda arm, name=name: cell_argv(
            name, base, str(work / ("dec_" + name + ("" if arm == device else "_cpu"))),
            lm_path, combine_path)
        try:
            rec, outs, got = run_cell(name, argv_of, device, combine_path, template_of)
            problems = launch_problems(name, got, dims) if dev.type == "cuda" else []
            if name == "mode2_combine":
                ok, held = not any(rec["leaves_not_the_mean"].values()), {}
            else:
                ok, held = hold(name, argv_of(device), outs, device)
            rec.update(held=held, launch_problems=problems,
                       status="PASS" if ok and not problems else "FAIL")
        except Exception as e:  # noqa: BLE001 - a failed call is a failed cell, as rc != 0 in JAX's
            traceback.print_exc()
            rec = {"status": "FAIL", "error": f"{type(e).__name__}: {e}"}
        runs[name] = rec
        log(f"[{rec['status']}] {name} " + json.dumps(
            {k: v for k, v in rec.items() if k != "status"}, default=str))
    n_pass = sum(r["status"] == "PASS" for r in runs.values())
    return {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "card": card() if dev.type == "cuda" else None,
        "dims": dims, "n_sent": N_SENT, "checkpoint": os.path.relpath(load, work),
        "train_s": train_s,
        "n_pass": n_pass, "n_fail": len(runs) - n_pass,
        "runs": runs,
        "source_sha256": source_digest(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dims", default="audit", choices=("audit", "kernel"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--workdir", default=None,
                    help="the corpus, checkpoints and outputs (default: a fresh temporary "
                         "directory)")
    ap.add_argument("--out", default=None,
                    help="the result's JSON (default stjep_tpu_torch/results/"
                         "eval_audit_<dims>.json)")
    ap.add_argument("--cells", default=None, help="comma-separated cell names (default: all 15)")
    args = ap.parse_args(argv)
    cells = args.cells.split(",") if args.cells else None
    res = run(args.workdir, args.dims, args.device, cells=cells,
              log=lambda line: print(line, flush=True))
    out = args.out or default_out(args.dims)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: res[k] for k in ("platform", "device", "card", "dims", "n_pass",
                                          "n_fail")}), flush=True)
    print(f"wrote {out}", flush=True)
    return 0 if res["n_fail"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
