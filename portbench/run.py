"""Run one benchmark cell once, on the machine this starts on:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's files (portbench/workloads/<cell>
.json and what it names) give the model, the traffic and the batcher's
settings. Set-up builds the port's kernels (into
flatquant_torch/kernels/_build/, keyed by a hash of their sources: only a
checkout's first run compiles), builds the model from the seed on the
card, and fills every slot; then the window runs `ContinuousBatcher.step`
for --seconds. --trace 0 reports the cell's end-to-end metrics, --trace 1
its per-layer metrics from spans and one profiled slice of the window.
After the window the program's state is freed and a sample of the
served requests is judged against the plain reference (`correct`).

The last line of standard output is the result (one JSON object); the
numbers compared for `correct`, each beside its limit, are the last lines
of standard error and the result's last key. No result, and a non-zero
exit, when the card is missing or there are fewer than the cell asks for,
or when JAX or the JAX package was loaded. --device cpu rehearses a tiny
cell on the CPU for the tests: every device metric reads "not measured".
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".portbench_cache"

for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = str(CACHE / _sub)
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench.harness import catalog, check, faults, guard, serve, spans  # noqa
from portbench.harness import trace as trace_mod  # noqa: E402
from portbench.reference.common import (  # noqa: E402
    PRECISIONS,
    restore_matmul,
    set_exact_matmul,
)

NOT_MEASURED = "not measured"
# device metrics: what a CPU rehearsal cannot give
DEVICE_SOURCES = ("device_trace", "host_clock", "program_span")


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cpu: the tests' rehearsal of a tiny cell")
    return p.parse_args(argv)


def _device_info(dev, chips):
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", str(dev.index or 0)],
            capture_output=True, text=True, timeout=20)
        info["power_limit"] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        info["power_limit"] = f"unread ({type(exc).__name__})"
    return info


def serve_cell(cell, seed, seconds, dev, traced, family, fault=None):
    """Set-up and the window. Returns (window record, the traced run's
    spans {"forwards", "spans", "marks"}, the traced slice's file or
    None, setup peak bytes). `fault` names a fault of harness/faults.py
    to plant under the batcher (the tests and calibrate.py only)."""
    cfg = cell["cfg"]
    cuda = dev.type == "cuda"
    traffic = catalog.load_module("traffic", cell["traffic"]["kind"]).Traffic(
        cell["traffic"], seed, cfg["vocab_size"])
    parts = {"imports": time.perf_counter() - T_PROCESS}
    t = time.perf_counter()
    if cuda:
        from flatquant_torch.kernels import common
        common.build()
    parts["kernel_build"], t = time.perf_counter() - t, time.perf_counter()
    model = family.build(cfg, seed, dev)
    b = family.batcher(model, cell["batcher"], dev)
    if cuda:
        torch.cuda.synchronize()
    parts["model_and_caches"], t = time.perf_counter() - t, time.perf_counter()
    undo = faults.plant(fault, b) if fault else None
    tap = serve.Tap(b)
    rec = spans.Recorder(b, family) if traced else None
    live = serve.fill(b, traffic)
    parts["first_wave"] = time.perf_counter() - t
    setup_peak = None
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    slicer = (spans.Slicer(rec, seconds, cell["trace"])
              if traced and cuda else None)
    win = serve.window(b, traffic, live, seconds, slicer)
    win["setup_s"] = win["t0"] - T_PROCESS
    win["setup_parts"] = parts
    win["peak_bytes"] = None
    if cuda:
        torch.cuda.synchronize()
        win["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    path = None
    if slicer is not None:
        slicer.close()
        fd, path = tempfile.mkstemp(prefix="portbench_trace_",
                                    suffix=".json")
        os.close(fd)
        if not slicer.export(path):
            os.remove(path)
            path = None
    recorded = {"forwards": [], "spans": [], "marks": {}}
    if rec is not None:
        rec.uninstall()
        recorded.update(forwards=rec.forwards, spans=rec.spans,
                        marks=slicer.marks if slicer is not None else {})
    tap.uninstall()
    win["tapped"] = tap.values()
    if undo is not None:
        undo()
    return win, recorded, path, setup_peak


def judge(cell, seed, win, dev, reference):
    """The numbers of check.numbers (and "requests") for a sample of the
    requests the window finished, against the plain reference computed at
    check.PRECISION."""
    picks = check.sample(win["done"], seed, cell["check"]["served_tokens"])
    if not picks:
        return dict(check.numbers([], [], []), requests=0)
    rnd = PRECISIONS[check.PRECISION]
    prev = set_exact_matmul()
    try:
        ref = reference.logits(cell["cfg"], seed, check.sequences(picks),
                               dev, rnd=rnd)
    finally:
        restore_matmul(prev)
    nums = check.numbers(ref, [r.req.out_tokens for r in picks],
                         check.served_logits(picks, win["tapped"]))
    return dict(nums, requests=len(picks))


def main(argv=None) -> int:
    args = _args(argv)
    cell = catalog.cell(args.workload)
    cfg = cell["cfg"]
    if args.device == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < cell["chips"]:
            print(f"portbench: the cell asks for {cell['chips']} CUDA "
                  f"device(s), this machine has {n}; no result",
                  file=sys.stderr)
            return 2
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device("cpu")
    torch.set_num_threads(1)
    family = catalog.load_module("families", cfg["family"])
    reference = catalog.load_module("reference", cfg["family"])
    traced = bool(args.trace)

    with torch.no_grad():
        win, recorded, trace_path, setup_peak = serve_cell(
            cell, args.seed, args.seconds, dev, traced, family)
    served = serve.served(win)
    failed = check.bad_requests(served, cfg["vocab_size"])
    device = _device_info(dev, cell["chips"])
    if dev.type == "cuda":
        device["memory_peak_bytes"] = max(setup_peak, win["peak_bytes"])
    else:
        device["memory_peak_bytes"] = NOT_MEASURED
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    nums = judge(cell, args.seed, win, dev, reference)

    sl, trace_bytes = None, 0
    if trace_path is not None:
        trace_bytes = os.path.getsize(trace_path)
        try:
            sl = trace_mod.read(trace_path, recorded["marks"],
                                recorded["forwards"], recorded["spans"])
        finally:
            os.remove(trace_path)
    ctx = types.SimpleNamespace(
        cell=cell, cfg=cfg, family=family, win=win,
        forwards=recorded["forwards"],
        slice=sl, slots=cell["batcher"]["slots"],
        kernel_names=catalog.kernel_names)
    kind = "per_layer" if traced else "end_to_end"
    names = catalog.metric_names(cell.get("rehearses", cell["name"]), kind,
                                 catalog.manifest())
    metrics = {}
    for name in names:
        mod = catalog.load_module("metrics", name)
        if dev.type != "cuda" and mod.SOURCE in DEVICE_SOURCES:
            value = NOT_MEASURED
        else:
            value = mod.read(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": mod.UNIT}
    if sl is not None:
        device["busy_s"] = sl["busy_s"]
        device["window_s"] = sl["window_s"]

    compared = {name: {"value": nums[name], "limit": limit}
                for name, limit in cell["check"]["limits"].items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in compared.values())
    compared["bad_requests"] = {"value": failed, "limit": 0}
    compared["tokens_judged"] = {"value": nums["tokens"],
                                 "limit": cell["check"]["min_tokens"]}
    correct = (correct and failed == 0
               and nums["tokens"] >= cell["check"]["min_tokens"])
    result = {"correct": correct, "attempted": len(served),
              "failed": failed, "metrics": metrics, "device": device}
    if sl is not None:
        result["breakdown"] = trace_mod.breakdown(sl)
    result["compared"] = compared

    bad = guard.loaded()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}; no "
              "result", file=sys.stderr)
        return 3
    print(f"portbench: {args.workload} seed {args.seed}: window "
          f"{win['t1'] - win['t0']:.3f} s, {win['steps']} steps, "
          f"{len(win['done'])} requests finished; set-up s "
          f"{ {k: round(v, 3) for k, v in win['setup_parts'].items()} }; "
          f"{nums['requests']} requests judged against the "
          f"{check.PRECISION} reference: mean gap "
          f"{nums['mean_gap']}, widest gap {nums['widest_gap']}, logit "
          f"error {nums['logit_error']}; "
          f"{device['kind']} power limit {device.get('power_limit')}; "
          f"slice ops attributed "
          f"{sl['attributed'] if sl else NOT_MEASURED}, clock drift "
          f"{sl['drift_s'] if sl else NOT_MEASURED} s, trace {trace_bytes} "
          "bytes", file=sys.stderr)
    for name, c in compared.items():
        print(f"compared {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
