#!/usr/bin/env python3
"""Compare the compiled kernels of one CUDA source in two checkouts, kernel by kernel.

    python3 stjep_tpu_torch/scripts/sass_diff.py --root DIR [--source decode_fused.cu] \\
        [--other decode_chain.cu]

Compiles stjep_tpu_torch/csrc/SOURCE of this checkout and of DIR (for a
parent commit, a checkout of it unpacked from `git archive`) with the
flags kernels.py builds with plus `-Xptxas -v`, both at once, reads each
object's SASS with cuobjdump, and prints one line per kernel: SAME where
the two instruction streams are equal (addresses and encodings left out),
else DIFF, with each side's registers, spill stores and loads and static
shared memory from ptxas. A kernel's device time can move with code it
does not run (a kernel added to its unit has changed its shared-memory
layout and registers, PERF.md section 6), so a change that must leave a
kernel as it was shows SAME here. With --other, this checkout's OTHER
source is compiled too and its kernels' ptxas figures printed. Needs
nvcc and cuobjdump (the CUDA toolkit); runs no kernel.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
CUDA_BIN = Path("/usr/local/cuda/bin")


def _tool(name: str) -> str:
    path = shutil.which(name) or str(CUDA_BIN / name)
    if not Path(path).exists():
        raise SystemExit(f"sass_diff: {name} not found (needs the CUDA toolkit)")
    return path


def _kernel(mangled: str) -> str:
    """A mangled kernel name without its unit's anonymous-namespace tag."""
    return re.sub(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}", "", mangled)


def compile_source(csrc: Path, source: str, out: Path):
    """Start nvcc on csrc/source with kernels.py's flags and -Xptxas -v."""
    sys.path.insert(0, str(HERE.parents[1]))
    from stjep_tpu_torch.kernels import NVCC_FLAGS

    return subprocess.Popen([_tool("nvcc"), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(out),
                             source], cwd=csrc, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def ptxas_figures(log: str):
    """{kernel: (registers, spill stores, spill loads, static smem bytes)}."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spills = _kernel(m.group(1)), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and name:
            out[name] = (int(m.group(1)), *spills, int(m.group(2)))
            name = None
    return out


def sass(obj: Path):
    """{kernel: [instructions]} from cuobjdump, addresses and encodings dropped."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(obj)], capture_output=True,
                          text=True, check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", text)
    out = {}
    for i in range(1, len(parts), 2):
        lines = (re.sub(r"/\*[0-9a-f]{4,}\*/", "", ln).strip() for ln in parts[i + 1].splitlines())
        out[_kernel(parts[i])] = [ln for ln in lines if ln and not ln.startswith("/*")]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True, help="the other checkout (e.g. the parent's)")
    ap.add_argument("--source", default="decode_fused.cu")
    ap.add_argument("--other", default=None, help="a further source of this checkout to report")
    args = ap.parse_args()
    mine = HERE.parents[1] / "stjep_tpu_torch" / "csrc"
    theirs = Path(args.root).resolve() / "stjep_tpu_torch" / "csrc"
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {"root": compile_source(theirs, args.source, Path(tmp) / "root.o"),
                "this": compile_source(mine, args.source, Path(tmp) / "this.o")}
        if args.other:
            jobs["other"] = compile_source(mine, args.other, Path(tmp) / "other.o")
        logs = {}
        for label, proc in jobs.items():
            _, err = proc.communicate()
            if proc.returncode:
                print(err, file=sys.stderr)
                return proc.returncode
            logs[label] = ptxas_figures(err)
        a, b = sass(Path(tmp) / "root.o"), sass(Path(tmp) / "this.o")
    fig = lambda f: "regs={} spill_st={} spill_ld={} smem={}".format(*f) if f else "-"
    for name in sorted(set(a) | set(b)):
        verdict = ("SAME" if a.get(name) == b.get(name) else "DIFF") if name in a and name in b \
            else ("ONLY_THIS" if name in b else "ONLY_ROOT")
        print(f"{verdict} {name} root[{fig(logs['root'].get(name))}] "
              f"this[{fig(logs['this'].get(name))}]", flush=True)
    for name, f in sorted(logs.get("other", {}).items()):
        print(f"{args.other} {name} [{fig(f)}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
