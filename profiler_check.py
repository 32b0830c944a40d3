#!/usr/bin/env python3
"""How torch.profiler's device events hold up on the card, and whether
flatquant_torch/utils/benchmark.py's timers read through it.

    python3 profiler_check.py      # one CUDA card; ~4 minutes

Row 1's qkv GEMM (w4a4_matmul_i8, M = 2048, llama-2-7b's 12288 x 4096)
is traced 20 times per session and its device events are counted by
kernel name:
  (a) in a fresh process: alone, after 64 tiny kernels, before them,
      with acc_events;
  (b) the same after chip_smoke.py's phase 4 (a profiled full-depth
      llama-2-7b decode), where earlier sessions left the profiler;
  (c) 24 sessions, each after another short profiled session: 256 tiny
      kernels, the 20 GEMMs in a record_function range, 256 tiny kernels,
      each part synchronized, counted by the range's host timestamps;
  (d) device_compare and device_time_loop after each of 16 such
      sessions, against chip_smoke.py's cuda_ms (CUDA events over a CUDA
      graph) of the same launch.
Prints one line per session and, last, the card's name and power limit.
Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CALLS = 20


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_check: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from flatquant_torch.kernels import common
    from flatquant_torch.kernels import int4_matmul as im
    from flatquant_torch.utils import benchmark as tb
    from torch.profiler import ProfilerActivity, profile, record_function

    common.build(True)
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    xq, xs = cs._codes_scales(torch, dev, gen, 2048, 4096)
    ws = cs._rand_weights(torch, dev, gen, 12288, 4096, 1)
    args = (xq, xs, *ws[0])
    im.w4a4_matmul_i8(*args)
    small = torch.zeros(4096, device=dev)
    torch.cuda.synchronize()

    def gemms():
        for _ in range(CALLS):
            im.w4a4_matmul_i8(*args)

    def tiny(n=64):
        for _ in range(n):
            small.add_(1.0)

    def device_events(prof):
        path = os.path.join(tempfile.mkdtemp(), "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            ev = json.load(f)["traceEvents"]
        return ev, [e for e in ev if e.get("ph") == "X"
                    and e.get("cat") in tb.DEVICE_CATEGORIES]

    def traced(tag, body, **kw):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA], **kw) as prof:
            body()
            torch.cuda.synchronize()
        _, ops = device_events(prof)
        g = sum("w4a4" in e["name"] for e in ops)
        print(f"{tag}: {g} of {CALLS} GEMMs, {len(ops) - g} other device "
              "ops", flush=True)

    def variants(when):
        traced(f"{when}, alone", gemms)
        traced(f"{when}, after 64 tiny kernels",
               lambda: (tiny(), torch.cuda.synchronize(), gemms()))
        traced(f"{when}, before 64 tiny kernels", lambda: (gemms(), tiny()))
        traced(f"{when}, acc_events", gemms, acc_events=True)

    def other_session(k):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            tiny(50 * (k % 6 + 1))
            torch.cuda.synchronize()
        p.key_averages()

    variants("(a) fresh process")
    model = cs.build_model(torch, dev, 0)
    cs.run_main_path(torch, dev, model, {}, "card")
    del model
    torch.cuda.empty_cache()
    variants("(b) after phase 4")
    for k in range(24):
        other_session(k)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tiny(256)
            torch.cuda.synchronize()
            with record_function("gemms"):
                gemms()
                torch.cuda.synchronize()
            tiny(256)
            torch.cuda.synchronize()
        ev, ops = device_events(prof)
        rng = next(e for e in ev if e.get("name") == "gemms"
                   and e.get("cat") == "user_annotation")
        t0, t1 = rng["ts"], rng["ts"] + rng["dur"]
        parts = [sum(1 for e in ops if e["ts"] < t0),
                 sum(1 for e in ops if t0 <= e["ts"] < t1),
                 sum(1 for e in ops if e["ts"] >= t1)]
        g = sum("w4a4" in e["name"] for e in ops)
        print(f"(c) session {k}: by host time {parts[0]} of 256 before, "
              f"{parts[1]} of {CALLS} in the range, {parts[2]} of 256 "
              f"after; {g} of {CALLS} GEMMs anywhere", flush=True)
    graph = cs.cuda_ms(torch, im.w4a4_matmul_i8, [args], CALLS)
    for k in range(16):
        other_session(k)
        dc = tb.device_compare({"row 1": (im.w4a4_matmul_i8, args)},
                               iters=CALLS)["row 1"] * 1e3
        s, n = tb.device_time_loop(gemms)
        print(f"(d) after session {k}: device_compare {dc:.4f} ms, "
              f"device_time_loop {n} ops {s * 1e3 / CALLS:.4f} ms a call; "
              f"cuda_ms {graph:.4f}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    print(smi or "nvidia-smi gave nothing", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
