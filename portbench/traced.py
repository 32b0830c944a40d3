"""Run one cell with the program's own tracer on, and join its spans to
the traced slice:

    python3 portbench/traced.py --workload <cell> --seed <n> --seconds <s>
        [--alternate] [--sync-debug] [--device cpu]

From the root of a checkout. The set-up, window and profiled slice are
run.py's with --trace 1 (`run.serve_cell`); in addition the port's tracer
(flatquant_torch/utils/tracing.py) is enabled when the window opens and
drained when it closes, and `harness/program.py` maps its spans onto the
slice. The last line of standard output is one JSON object:

  - "metrics": the per-layer numbers the program's records give
    (`program.metrics`: queue_wait_ms, prefill_useful_share,
    host_syncs_per_step, decode_idle_ms, moe_useful_share);
  - "breakdown": trace.py's `idle_gaps` and `device_ops`, and
    `idle_gaps_by_span` and `device_time_by_span` (top 10 paths);
  - "decode_idle": the idle seconds trace.py puts in decode calls beside
    those the join puts under `decode` and strictly below it;
  - "counters" and "calls": the program's counters over the window and
    its spans counted by name in the slice;
  - --alternate: the tracer is on only in every other step outside the
    slice (always on inside it), and "cost" compares the host wall of
    the decode calls outside the slice (each ending in the harness's
    synchronization) in steps with the tracer on against off;
  - --sync-debug: the window runs under
    torch.cuda.set_sync_debug_mode("warn") with every warning shown, and
    "syncs" counts the synchronizing calls raised from flatquant_torch/
    (innermost frame outside torch's own package) beside the program's
    `host_syncs` counter, and those raised from anywhere else.

The result is for reading, not for comparison: the tracer and the sync
check change what they measure.
"""

import argparse
import bisect
import collections
import json
import os
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402  (sets the build caches' paths)

import torch  # noqa: E402

from flatquant_torch.utils import tracing  # noqa: E402
from portbench.harness import catalog, program, serve  # noqa: E402
from portbench.harness import trace as trace_mod  # noqa: E402

PROGRAM = str(ROOT / "flatquant_torch") + os.sep
TORCH = str(Path(torch.__file__).resolve().parent) + os.sep


class SyncWarnings:
    """Counts the warnings of torch.cuda.set_sync_debug_mode("warn") by
    where they were raised: the innermost frame outside torch's own
    package and the warnings machinery."""

    def __init__(self):
        self.program = collections.Counter()
        self.other = collections.Counter()

    def __enter__(self):
        self._cm = warnings.catch_warnings()
        self._cm.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = self._show
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        return self._cm.__exit__(*exc)

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        if "synchroniz" not in str(message):
            return
        for fr in reversed(traceback.extract_stack()[:-1]):
            path = str(Path(fr.filename).resolve())
            if path.endswith(os.sep + "warnings.py") or path.startswith(
                    TORCH):
                continue
            rel = os.path.relpath(path, ROOT)
            where = self.program if path.startswith(PROGRAM) else self.other
            where[f"{rel}:{fr.lineno}"] += 1
            return
        self.other["unknown"] += 1


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--alternate", action="store_true")
    p.add_argument("--sync-debug", action="store_true")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p.parse_args(argv)


def _window(args, rec):
    """serve.window with the tracer on (every other step outside the
    slice with --alternate) and, with --sync-debug, the sync check."""
    orig = serve.window

    def window(b, traffic, live, seconds, slicer=None):
        steps, orig_step = [], b.step

        def step():
            on = (not args.alternate or len(steps) % 2 == 0
                  or (slicer is not None and slicer.state == "on"))
            (tracing.enable if on else tracing.disable)()
            t = time.perf_counter()
            orig_step()
            steps.append((t, time.perf_counter(), on))

        b.step = step
        sync = SyncWarnings() if args.sync_debug else None
        try:
            if sync is not None:
                with sync:
                    out = orig(b, traffic, live, seconds, slicer)
            else:
                out = orig(b, traffic, live, seconds, slicer)
        finally:
            tracing.disable()
            del b.step
        rec["spans"], rec["counters"] = tracing.drain()
        rec.update(steps=steps, sync=sync)
        return out

    return window


def _cost(forwards, steps):
    """Mean host wall (ms) of the decode calls outside the slice, in steps
    with the tracer on and off."""
    walls = {True: [], False: []}
    starts = [s[0] for s in steps]
    for f in forwards:
        i = bisect.bisect_right(starts, f["t0"]) - 1
        if f["phase"] != "decode" or f["slice"] or i < 0:
            continue  # not a decode call of the window outside the slice
        walls[steps[i][2]].append(1e3 * (f["t1"] - f["t0"]))
    out = {k: {"calls": len(v), "mean_ms": sum(v) / len(v) if v else None}
           for k, v in (("on", walls[True]), ("off", walls[False]))}
    if out["on"]["mean_ms"] and out["off"]["mean_ms"]:
        out["on_over_off"] = out["on"]["mean_ms"] / out["off"]["mean_ms"]
    return out


def main(argv=None) -> int:
    args = _args(argv)
    cell = catalog.cell(args.workload)
    cfg = cell["cfg"]
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("portbench: no CUDA device; no result", file=sys.stderr)
            return 2
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device("cpu")
    torch.set_num_threads(1)
    family = catalog.load_module("families", cfg["family"])
    rec = {}
    serve.window = _window(args, rec)
    with torch.no_grad():
        win, recorded, path, _ = run.serve_cell(cell, args.seed,
                                                args.seconds, dev, True,
                                                family)
    spans, counters = rec["spans"], rec["counters"]
    result = {"workload": args.workload, "seed": args.seed,
              "device": run._device_info(dev, cell["chips"]),
              "window_s": win["t1"] - win["t0"], "steps": win["steps"],
              "counters": counters}
    joined = None
    if path is not None:
        try:
            sl = trace_mod.read(path, recorded["marks"], recorded["forwards"],
                                recorded["spans"])
            psl = program.read(path, recorded["marks"])
        finally:
            os.remove(path)
        if sl is not None and psl is not None:
            joined = program.join(psl, spans)
            result["breakdown"] = dict(
                trace_mod.breakdown(sl),
                idle_gaps_by_span=program.top(joined["idle"]),
                device_time_by_span=program.top(joined["device_time"]))
            result["decode_idle"] = {
                "host_in_a_decode_call_s": sum(
                    s for k, s in sl["gaps"] if k == "host in a decode call"),
                "under_decode_s": program.under(joined["idle"], "decode"),
                "below_decode_s": program.under(joined["idle"], "decode",
                                                strictly=True),
                "idle_s": joined["idle_s"], "trace_idle_s":
                    sl["window_s"] - sl["busy_s"]}
            result["calls"] = joined["calls"]
    result["metrics"] = program.metrics(spans, counters, joined)
    if args.alternate:
        result["cost"] = _cost(recorded["forwards"], rec["steps"])
    if rec["sync"] is not None:
        result["syncs"] = {
            "program_warnings": sum(rec["sync"].program.values()),
            "host_syncs": counters.get("host_syncs", 0),
            "program_sites": dict(rec["sync"].program),
            "other_sites": dict(rec["sync"].other)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
