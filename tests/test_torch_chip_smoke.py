"""chip_smoke.py says on stdout why it fails: one `[failed] phase=...
error=...` line, no result line, a non-zero exit code. Run in a subprocess
from another working directory: the repo's script on this host (no CUDA
card: the device phase fails), and a copy of the script alone, told that a
card is there (the package import fails)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

SCRIPT = Path(__file__).resolve().parents[1] / "chip_smoke.py"
# run a script as __main__ with torch.cuda.is_available() patched to True
AS_IF_CARD = ("import runpy, sys, torch; torch.cuda.is_available = lambda: True; "
              "sys.argv = sys.argv[1:]; "
              "runpy.run_path(sys.argv[0], run_name='__main__')")


@pytest.mark.parametrize("where,phase,error", [
    ("repo", "device", "RuntimeError: no CUDA device"),
    ("alone", "imports", "ModuleNotFoundError: No module named 'stjep_tpu_torch'"),
])
def test_chip_smoke_failure_names_phase_on_stdout(tmp_path, where, phase, error):
    if where == "repo":
        cmd = [sys.executable, str(SCRIPT)]
    else:
        shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
        cmd = [sys.executable, "-c", AS_IF_CARD, "chip_smoke.py"]
    proc = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=120,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    assert lines[-1].startswith(f"[failed] phase={phase} error={error}"), proc.stdout
    assert not any('"ok": true' in ln for ln in lines)
    assert "Traceback" in proc.stderr


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("pos,drift,ok", [
    (1, 0.5, True),  # parts at the first position: no prefix, no drift
    (2, 0.0059, True), (2, 0.0061, False), (8, 0.0075, True), (21, 0.0197, True),
    (8, 0.025, False), (40, 0.2, False)])
def test_net_divergence_caps_the_prefix_drift(pos, drift, ok):
    """A row of two recorded bf16 runs that agree up to position pos - 1,
    their kept scores apart by drift there, and part at pos: net_divergence
    gives (pos, margin, drift) while the drift is within BF16_DRIFT a
    position up to pos, and fails the check past it."""
    import torch

    cs = _chip_smoke()
    K = cs.BEAM
    base = torch.arange(K, dtype=torch.float32) * -0.5
    st_c, st_p = [], []
    for t in range(pos):
        pc = torch.arange(K, dtype=torch.int32)
        pp = pc.flip(0) if t == pos - 1 else pc
        d = drift if t == pos - 2 else 0.0
        st_c.append((pc, base + d))
        st_p.append((pp, base.clone()))
    assert cs.BF16_DRIFT == 3e-3
    if ok:
        got = cs.net_divergence(st_c, st_p, 0)
        assert got[0] == pos and got[1] == 0.0
        assert got[2] == pytest.approx(drift if pos > 1 else 0.0, abs=1e-6)
    else:
        with pytest.raises(RuntimeError, match="drifted"):
            cs.net_divergence(st_c, st_p, 0)
