import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.harness import catalog

MAN = catalog.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = catalog.cell(name)
    entry = next(w for w in MAN["workloads"] if w["name"] == name)
    assert cell["config"] == entry["config"]
    assert cell["chips"] == entry["chips"]
    assert cell["why"] == entry["why"]
    assert cell["traffic"]["kind"] == entry["traffic"]
    conf = next(c for c in MAN["configs"] if c["name"] == cell["config"])
    assert conf["file"] == f"portbench/configs/{cell['config']}.json"
    assert conf["source"] == cell["cfg"]["source"]
    assert conf["reduced"] == cell["cfg"]["reduced"]
    for kind in ("families", "reference"):
        catalog.load_module(kind, cell["cfg"]["family"])
    assert hasattr(catalog.load_module("traffic", entry["traffic"]),
                   "Traffic")


@pytest.mark.parametrize("kind,name", [
    (k, m["name"]) for k in ("end_to_end", "per_layer") for m in MAN[k]])
def test_metric_module_matches_the_manifest(kind, name):
    entry = next(m for m in MAN[kind] if m["name"] == name)
    mod = catalog.load_module("metrics", name)
    assert mod.UNIT == entry["unit"] and mod.SOURCE == entry["source"]
    if kind == "per_layer":
        assert mod.LAYER == entry["layer"] and mod.MOVES == entry["moves"]
    assert callable(mod.read)


def test_roofline_kernel_names_live_in_files():
    assert "w4a4_matmul_i8_tile_kernel" in catalog.kernel_names(
        "roofline.int4_gemm")
    assert "decode_attention_int4_kernel" in catalog.kernel_names(
        "roofline.paged_attn")


NEW_METRIC = '''"""Requests finished in the window per second."""

from portbench.harness.stats import rate

UNIT, LAYER, MOVES, SOURCE = "requests/s", None, None, "host_clock"


def read(ctx):
    return rate(len(ctx.win["done"]), ctx.win["t0"], ctx.win["t1"])
'''


def _digest(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            if "__pycache__" not in p:
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha1(
                        fh.read()).hexdigest()
    return out


def test_a_new_cell_and_metric_are_files_only(tmp_path):
    """A copy of the benchmark gains a cell (a workload file), a traffic
    variant (its parameters) and an end-to-end metric (a metric file and
    its manifest entry); it runs without an edit to any file that was
    there."""
    shutil.copytree(catalog.PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(catalog.ROOT / "flatquant_torch", tmp_path / "flatquant_torch")
    man = json.loads(json.dumps(MAN))
    before = _digest(tmp_path / "portbench")
    wl = json.loads((catalog.PORTBENCH / "workloads" /
                     "tiny-qwen.prefill-heavy.json").read_text())
    wl.pop("rehearses")
    wl["traffic"]["prompt"].update(median=60, min=30, max=100)
    (tmp_path / "portbench/workloads/tiny-qwen.longer.json").write_text(
        json.dumps(wl))
    (tmp_path / "portbench/metrics/finished_per_s.py").write_text(NEW_METRIC)
    man["workloads"].append({"name": "tiny-qwen.longer",
                             "config": "tiny-qwen-w4a4kv4",
                             "traffic": "closed_loop", "chips": 1,
                             "why": "a test cell"})
    man["end_to_end"].append({"name": "finished_per_s", "unit": "requests/s",
                              "better": "higher", "bound": 0.05,
                              "source": "host_clock",
                              "workloads": ["tiny-qwen.longer"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "tiny-qwen.longer",
         "--seed", "7", "--seconds", "1", "--trace", "0", "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert set(res["metrics"]) == {"tokens_per_s", "itl_p95_ms",
                                   "peak_mem_gib", "setup_s",
                                   "finished_per_s"}
    after = _digest(tmp_path / "portbench")
    assert {k: after[k] for k in before} == before
