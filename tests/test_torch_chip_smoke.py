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
