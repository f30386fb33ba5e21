"""Every file BENCHMARK.json names loads by its name, the contract's shape
holds, and a new cell's files are picked up without an edit."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from perfbench import registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and BENCH["command"][1].startswith("perfbench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    for kind, keys in (("end_to_end", {"name", "unit", "better", "bound", "source"}),
                       ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        for m in BENCH[kind]:
            assert set(m) - {"workloads"} == keys, m["name"]
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    w = registry.cell(BENCH, cell)
    cfg = registry.config(BENCH, w["config"])
    assert cfg["name"] == w["config"] and cfg["reduced"] == []
    tr = registry.traffic(w["traffic"])
    assert tr["entry"] in ("st_beam", "train_step")
    assert set(registry.limits(cell)["limits"]) == (
        {"asr_gap", "dyn_emb_err", "st_select_gap", "st_score_err"} if tr["entry"] == "st_beam"
        else {"loss_err", "grad_err", "change_err"})
    e2e = {m["name"] for m in registry.metrics_of(BENCH, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = registry.metrics_of(BENCH, cell, "per_layer")
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (cell, m["name"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_matches_its_entry(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    r = registry.reader(metric)
    assert (r.LAYER, r.UNIT, r.MOVES) == (m["layer"], m["unit"], m["moves"])
    if getattr(r, "WORK", None):
        spec = registry.work(r.WORK)
        counter = registry.count(spec["count"])
        assert spec["kernels"]
        assert (callable(getattr(counter, "keep", None)) and callable(counter.count)
                if spec["hook"] else callable(counter.stretch))


def test_one_layer_name_per_layer():
    names = {m["layer"] for m in BENCH["per_layer"]}
    assert all("\n" not in n and 1 <= len(n) <= 200 for n in names)


def test_new_files_are_picked_up_without_an_edit(tmp_path):
    """A later change adds a traffic mix, a limit file, a metric reader, a
    kernel for an existing roofline's work, and a new roofline's work with
    its count, as new files only."""
    here = tmp_path / "perfbench"
    shutil.copytree(registry.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    (here / "traffic" / "st_beam_b16.json").write_text(json.dumps(
        {**registry.traffic("st_beam_b64"), "batch": 16}))
    (here / "limits" / "standard.st_beam_b16.json").write_text(json.dumps(
        registry.limits("standard.st_beam_b64")))
    (here / "metrics" / "k1_roofline.py").write_text(
        'LAYER = "LAS"\nUNIT = "%"\nMOVES = "decode_utt_per_s"\n'
        'WORK = "beam_step"\n\ndef read(r):\n    return r.roofline(WORK)\n')
    (here / "work" / "beam_step.k4v2.json").write_text(json.dumps({"kernels": ["beam2_kernel"]}))
    (here / "work" / "las_step.json").write_text(json.dumps(
        {"count": "las_step", "hook": None, "kernels": ["greedy_kernel"], "what": "K2"}))
    (here / "counts" / "las_step.py").write_text(
        "def stretch(run, st, n):\n    return 8 * n, 2 * n\n")
    assert registry.count(registry.work("las_step", here=str(here))["count"],
                          here=str(here)).stretch(None, None, 3) == (24, 6)
    assert registry.traffic("st_beam_b16", here=str(here))["batch"] == 16
    assert registry.limits("standard.st_beam_b16", here=str(here))
    assert registry.reader("k1_roofline", here=str(here)).WORK == "beam_step"
    assert registry.work("beam_step", here=str(here))["kernels"] == ["beam_kernel", "beam2_kernel"]
    assert registry.work("beam_step")["kernels"] == ["beam_kernel"]


def test_every_traffic_file_is_a_cells():
    from pathlib import Path

    used = {w["traffic"] for w in BENCH["workloads"]}
    assert {p.stem for p in (Path(registry.HERE) / "traffic").glob("*.json")} == used
