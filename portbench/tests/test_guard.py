import json
import subprocess
import sys

import pytest

from portbench.harness import catalog, guard

SOURCES = sorted(p for p in catalog.PORTBENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(catalog.PORTBENCH)))
def test_nothing_imports_jax_or_the_jax_package(path):
    assert not guard.imports_of(path) & guard.FORBIDDEN


@pytest.mark.parametrize("sub", ["reference", "weights"])
def test_reference_imports_nothing_of_the_port(sub):
    for path in (catalog.PORTBENCH / sub).glob("*.py"):
        assert "flatquant_torch" not in guard.imports_of(path), path


def test_top_level_names_compare_whole():
    assert guard.loaded(["flatquant_torch.serving", "jaxtyping"]) == []
    assert guard.loaded(["jax.numpy", "flatquant_tpu.core"]) == [
        "flatquant_tpu", "jax"]


def _run(prelude, extra):
    code = (prelude + "import runpy, sys; sys.argv = ['portbench/run.py'] + "
            + repr(extra) + "; runpy.run_path('portbench/run.py', "
            "run_name='__main__')")
    return subprocess.run([sys.executable, "-c", code], cwd=catalog.ROOT,
                          capture_output=True, text=True, timeout=300)


ARGS = ["--workload", "tiny-qwen.prefill-heavy", "--seed", "3", "--seconds",
        "0.5", "--trace", "0"]


def test_a_run_that_loaded_jax_prints_no_result():
    p = _run("import sys, types; sys.modules['jaxlib.xla'] = "
             "types.ModuleType('jaxlib.xla'); ", ARGS + ["--device", "cpu"])
    assert p.returncode == 3 and "jaxlib" in p.stderr
    assert not p.stdout.strip()


def test_a_clean_run_prints_its_result():
    p = _run("", ARGS + ["--device", "cpu"])
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "compared"]
    assert res["device"]["platform"] == "cpu"
    assert all(m["value"] == "not measured" for m in res["metrics"].values())
    assert p.stderr.strip().splitlines()[-1].startswith("compared ")


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    p = _run("", ARGS)
    assert p.returncode == 2 and not p.stdout.strip()


def test_no_program_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copytree(catalog.PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(catalog.ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "portbench/run.py"] + ARGS
                       + ["--device", "cpu"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()
