"""Finds what a cell is made of, by the names in BENCHMARK.json: its
configuration (configs/<config>.json), its traffic mix
(traffic/<traffic>.json), its limits (limits/<cell>.json), the readers of
its per-layer metrics (metrics/<metric>.py) and the work a roofline counts
(work/<work>.json, and work/<work>.<anything>.json files that name more
kernels for the same work) with the count of that work that the work file
names (counts/<count>.py). Adding any of these is adding a file."""

from __future__ import annotations

import glob
import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: Dict, name: str, here: str = HERE) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(os.path.dirname(here), c["file"]))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, here: str = HERE) -> Dict:
    return load_json(os.path.join(here, "traffic", f"{name}.json"))


def limits(cell_name: str, here: str = HERE) -> Dict:
    return load_json(os.path.join(here, "limits", f"{cell_name}.json"))


def metrics_of(bench: Dict, cell_name: str, kind: str) -> List[Dict]:
    """The cell's metrics of `kind` ("end_to_end" or "per_layer"): those
    whose `workloads` list the cell, and those without the key."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]


def _module(kind: str, name: str, here: str) -> ModuleType:
    path = os.path.join(here, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, here: str = HERE) -> ModuleType:
    """The per-layer metric's reader module, metrics/<name>.py."""
    return _module("metrics", name, here)


def count(name: str, here: str = HERE) -> ModuleType:
    """The count of a roofline's work, counts/<name>.py: `keep(args, out)`
    and `count(kept, model)` for work read from a hooked call's arguments,
    or `stretch(run, st, n)` for work read from the traced stretch; each
    gives (bytes, operations)."""
    return _module("counts", name, here)


def work(name: str, here: str = HERE) -> Dict:
    """work/<name>.json with the kernels of every work/<name>.*.json added."""
    base = load_json(os.path.join(here, "work", f"{name}.json"))
    kernels = list(base["kernels"])
    for extra in sorted(glob.glob(os.path.join(here, "work", f"{glob.escape(name)}.*.json"))):
        kernels += [k for k in load_json(extra)["kernels"] if k not in kernels]
    return {**base, "kernels": kernels}
