"""Find a cell's parts by name, each in files of its own under portbench/:

  workloads/<cell>.json      the cell: config, chips, traffic kind and its
                             parameters, the batcher's settings, why
  configs/<config>.json      one model configuration (published keys, the
                             FlatQuant recipe, the port family)
  traffic/<kind>.py          one traffic generator (`Traffic`)
  families/<family>.py       one adapter per port family (build, batcher,
                             work of a forward call)
  reference/<family>.py      the plain float32 reference
  metrics/<metric>.py        one metric each (UNIT, LAYER, MOVES, SOURCE,
                             read(ctx))

BENCHMARK.json at the checkout's root names the metrics of each cell.
Adding a cell, configuration, traffic kind or metric adds files and edits
none.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"{name!r} is not a benchmark name")
    return name


def load_json(kind: str, name: str) -> dict:
    path = PORTBENCH / kind / f"{_checked(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """The module portbench/<kind>/<name>.py, imported from its file (a
    metric's name may hold dots)."""
    path = PORTBENCH / kind / f"{_checked(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module named {name!r} ({path})")
    mod_name = "portbench_" + re.sub(r"\W", "_", f"{kind}_{name}")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell(name: str) -> dict:
    """The workload file with its configuration under "cfg"."""
    wl = dict(load_json("workloads", name), name=name)
    wl["cfg"] = load_json("configs", wl["config"])
    return wl


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def metric_names(cell_name: str, kind: str, man: dict) -> list:
    """The metrics of `kind` ("end_to_end" or "per_layer") that the
    manifest gives this cell: those without a workloads key, and those
    whose key lists it."""
    return [m["name"] for m in man[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def kernel_names(metric: str) -> list:
    """The kernel names a roofline metric reads: one per file under
    metrics/<metric>/ (the first line that is neither blank nor a
    comment)."""
    names = []
    folder = PORTBENCH / "metrics" / _checked(metric)
    for path in sorted(folder.glob("*.txt")):
        for line in path.read_text().splitlines():
            line = line.strip()
            if line and not line.startswith("#"):
                names.append(line)
                break
    return names
