"""stjep_tpu_torch/scripts/eval_audit.py, the port of
scripts/run_eval_audit.py, on the CPU: its corpus size, widths, LM export
and matrix equal the JAX script's, the launch rules on recorded counts,
and a short run of a few cells (ST under the LM, mode 2 on the per-epoch
checkpoints, mode 3) whose ST-with-LM lines the JAX package's translate
gives too."""

import importlib.util
import inspect
import json
import os
import pickle
import textwrap
import types
from pathlib import Path

import pytest

import translate as jax_tr
from stjep_tpu.data.dataset import Dataset as JaxDataset

from stjep_tpu_torch.scripts import eval_audit, quality

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def rea():
    """scripts/run_eval_audit.py (it imports no JAX at import)."""
    spec = importlib.util.spec_from_file_location("_jax_run_eval_audit",
                                                  ROOT / "scripts" / "run_eval_audit.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_corpus_and_dims_equal_run_eval_audit(rea):
    assert eval_audit.N_SENT == rea.N_SENT == 16
    assert eval_audit.dims_flags("audit") == rea.DIMS
    mq = importlib.util.spec_from_file_location("_jax_mq", ROOT / "scripts" / "measure_quality.py")
    mod = importlib.util.module_from_spec(mq)
    mq.loader.exec_module(mod)
    kernel = eval_audit.dims_flags("kernel")
    assert dict(zip(kernel[::2], kernel[1::2])) == {
        f"--{k}": str(v) for k, v in mod.PROFILES["kernel"].items()}
    paths = {k: f"<{k}>" for k in ("path_src", "path_tgt", "acous_path", "path_vocab_src",
                                   "path_vocab_tgt")}
    argv = eval_audit.train_argv(paths, "<save>", "audit")
    assert argv[-len(rea.DIMS):] == rea.DIMS
    # every other flag of :55-70 with its value, or with a path
    flat = " ".join(inspect.getsource(rea.main).split())
    pairs = list(zip(argv[:-len(rea.DIMS):2], argv[1:-len(rea.DIMS):2]))
    assert len(pairs) == 21
    for flag, value in pairs:
        assert (f'"{flag}",' in flat if value.startswith("<")
                else f'"{flag}", "{value}"' in flat), (flag, value)


def test_lm_export_equals_run_eval_audit_expressions(rea, tmp_path):
    """The dict n-gram export equals what run_eval_audit.py's own lines
    (:86-91) build, run with dill standing in for a recorder."""
    lines = inspect.getsource(rea.main).splitlines()
    start = next(i for i, line in enumerate(lines) if line.strip().startswith("entries = "))
    end = next(i for i, line in enumerate(lines) if "dill.dump" in line)
    block = textwrap.dedent("\n".join(lines[start:end + 2]))
    got = []
    fake_dill = types.SimpleNamespace(dump=lambda obj, f: got.append(obj))
    ns = {"corpus": {"vocab_tgt_size": 15}, "work": str(tmp_path), "os": os, "dill": fake_dill}
    exec(block, ns)
    assert got == [eval_audit.lm_export(15)]
    assert len(got[0]["entries"]) == 15 + 5 and len(got[0]["backoffs"]) == 5


def test_matrix_has_the_fifteen_cells_of_the_jax_record():
    jax_runs = json.loads((ROOT / "benchmarks" / "eval_audit.json").read_text())["runs"]
    assert len(eval_audit.CELLS) == 15 and set(eval_audit.CELLS) == set(jax_runs)
    a = eval_audit.cell_argv("mode1_ST-REF_lm", ["--load", "C"], "/o", "/lm", "/c")
    assert a == ["--eval_mode", "1", "--gen_mode", "ST-REF", "--test_path_out", "/o",
                 "--beam_width", "2", "--max_seq_len", "32", "--load", "C",
                 "--lm_mode", "s-4g_0.5", "--lm_path", "/lm"]
    assert eval_audit.cell_argv("mode2_combine", [], "/o", "/lm", "/c") == [
        "--eval_mode", "2", "--combine_path", "/c", "--test_path_out", "/o"]
    assert eval_audit.cell_argv("mode4_plot_emb", [], "/o", "/lm", "/c")[:2] == [
        "--eval_mode", "4"]
    assert Path(eval_audit.default_out("kernel")).name == "eval_audit_kernel.json"


@pytest.mark.parametrize("name,got,dims,n_bad", [
    ("mode1_ST_lm", {"K1": 2, "K2": 0, "K9 fwd": 0, "K9 bwd": 0}, "kernel", 0),
    ("mode1_ST_lm", {"K1": 2, "K2": 2, "K9 fwd": 0, "K9 bwd": 0}, "kernel", 1),
    ("mode1_ST-REF", {"K1": 2, "K2": 0, "K9 fwd": 2, "K9 bwd": 0}, "kernel", 0),
    ("mode1_ST-REF", {"K1": 2, "K2": 0, "K9 fwd": 0, "K9 bwd": 0}, "kernel", 1),
    ("mode1_ASR", {"K1": 2, "K2": 0, "K9 fwd": 0, "K9 bwd": 0}, "kernel", 1),
    ("mode1_ASR", {"K1": 2, "K2": 0, "K9 fwd": 0, "K9 bwd": 0}, "audit", 0),
    ("mode1_ASR", {"K1": 2, "K2": 2, "K9 fwd": 0, "K9 bwd": 0}, "audit", 1),
    ("mode1_MT", {"K1": 2, "K2": 0, "K9 fwd": 0, "K9 bwd": 0}, "kernel", 1),
    ("mode3_gather_emb", {"K1": 2, "K2": 0, "K9 fwd": 2, "K9 bwd": 0}, "kernel", 0)])
def test_launch_rules(name, got, dims, n_bad):
    assert len(eval_audit.launch_problems(name, got, dims)) == n_bad


def test_short_run_holds_cells_and_matches_jax(tmp_path):
    """Three cells at the audit's widths on the CPU (both arms on the CPU):
    each passes with its holds recorded; mode 2 averages the two per-epoch
    checkpoints to their leaf-wise mean; the JAX CLI's translate of the
    same checkpoint with the same LM export writes the ST-with-LM lines."""
    cells = ["mode1_ST_lm", "mode2_combine", "mode3_gather_emb"]
    out = tmp_path / "a.json"
    rc = eval_audit.main(["--device", "cpu", "--workdir", str(tmp_path / "w"), "--cells",
                          ",".join(cells), "--out", str(out)])
    res = json.loads(out.read_text())
    assert rc == 0 and (res["n_pass"], res["n_fail"]) == (3, 0) and list(res["runs"]) == cells
    st = res["runs"]["mode1_ST_lm"]
    assert st["held"]["lines"] == 16 and st["held"]["rows_differ"] == []
    assert res["runs"]["mode2_combine"]["ckpts"] == ["1", "2"]
    assert res["runs"]["mode2_combine"]["leaves_not_the_mean"] == {"cpu": 0}
    assert res["runs"]["mode3_gather_emb"]["held"]["shape"] == [12]

    work = tmp_path / "w"
    cfg_j, params_j, ck = jax_tr._load_model(str(work / "expt/checkpoints_epoch/2"))
    ds = JaxDataset(path_src=str(work / "data/train.src"), path_tgt=str(work / "data/train.tgt"),
                    vocab_src_list=ck.input_vocab, vocab_tgt_list=ck.output_vocab,
                    use_type="char", acous_path=str(work / "data/train.flis"),
                    acous_max_len=6000, max_seq_len_src=900, max_seq_len_tgt=900, batch_size=8,
                    mode="ST")
    with open(work / "lm.pkl", "rb") as f:
        lm = pickle.load(f)
    ref = jax_tr.translate(ds, cfg_j, params_j, str(tmp_path / "j"), 32, 2, gen_mode="ST",
                           lm_mode=eval_audit.LM_MODE, lm_model=lm,
                           logger_print=lambda *a: None)
    ours = (work / "dec_mode1_ST_lm" / "translate.txt").read_text(encoding="utf8")
    assert ours.splitlines() == Path(ref).read_text(encoding="utf8").splitlines()
    assert quality.PROFILES["kernel"]["dim_model"] == 128
