"""A run loads no module whose top-level name is jax, jaxlib, flax or
stjep_tpu (whole names: stjep_tpu_torch is the program), and without a card
the command exits non-zero and prints no result."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RUN_TINY = """
import json, pathlib, sys, tempfile
sys.path.insert(0, {root!r})
from perfbench import run
from perfbench.tests import tiny

class Patch:
    def setattr(self, obj, name, value):
        setattr(obj, name, value)

bench = tiny.install(Patch(), pathlib.Path(tempfile.mkdtemp()))
res = run.execute({cell!r}, 5, 0.2, {trace}, device_name="cpu", bench=bench)
assert res["correct"], res
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("cell,trace", [("standard.st_beam_b64", 1),
                                        ("standard.train_asr_st_b32", 0)])
def test_a_run_loads_no_jax(tmp_path, cell, trace):
    env = {**os.environ, "TMPDIR": str(tmp_path)}
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", RUN_TINY.format(root=ROOT, cell=cell,
                                                                trace=trace)],
                         capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    import json

    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "stjep_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "stjep_tpu"}


def test_the_guard_compares_whole_names(monkeypatch):
    from perfbench import run

    monkeypatch.setitem(sys.modules, "stjep_tpu_torch_extra", sys)
    assert "stjep_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert run.loaded_forbidden() == ["jaxlib"]


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "standard.st_beam_b64",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
