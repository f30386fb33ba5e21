"""The control on the card: the reference in TF32 in the program's place
fails at least one of each cell's numbers, at the cell's own sizes, where
the program passes every one. One seed a cell; the limits' readings over
many seeds are perfbench/control.py's (PERF.md lists them)."""

from __future__ import annotations

import importlib

import pytest

from perfbench import registry

BENCH = registry.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read on the card at the cell's sizes")
    from perfbench.control import readings
    from perfbench.run import Run

    run = Run(BENCH, registry.cell(BENCH, cell), 0, 0, 0, torch.device("cuda", 0))
    entry = importlib.import_module(f"perfbench.entries.{run.traffic['entry']}")
    lim = registry.limits(cell)["limits"]
    got = dict(readings(run, entry, 4_000_000_007, control=True))
    assert all(got["program"][k] <= v for k, v in lim.items()), got["program"]
    assert any(got["control tf32"][k] > v for k, v in lim.items()), got["control tf32"]
