"""Timing helpers for benchmarks on the card (port of
flatquant_tpu/utils/benchmark.py).

Two measurement modes:
  - `device_compare` (preferred for a kernel): run each case N times under
    its own torch.profiler trace with CUDA activity and report the device
    time of its kernels, copies and fills per call: free of the host's
    launch overhead, which dominates a small kernel's wall time.
  - `compare` (wall clock): repetitions chained through an accumulator,
    so none can be skipped, each round ending in a synchronize. Valid for
    the end-to-end time of a step; for a small kernel it measures the
    host's launch rate.
`device_time_loop` traces an arbitrary call sequence that threads its own
state (a decode loop over one cache).
"""

from __future__ import annotations

import collections
import json
import os
import shutil
import tempfile
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

# the trace categories that are device work: kernels, copies and fills
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# the sentinel kernels that bracket a traced call sequence (_traced): how
# many before and after, their spin, and their kernel's name
SENTINEL_OPS, SENTINEL_CYCLES, SENTINEL = 256, 1000, "spin_kernel"
# traces device_compare takes of a case before it gives up
TRACE_TRIES = 3


def _sync_for(tensors: Sequence) -> None:
    """torch.cuda.synchronize() when any of `tensors` lies on a card."""
    if any(torch.is_tensor(t) and t.is_cuda for t in tensors):
        torch.cuda.synchronize()


def chained_timer(step_fn: Callable, args: tuple, iters: int = 20):
    """A closure running `iters` dependent repetitions of step_fn(*args).

    Each output's float32 sum feeds an accumulator (times 1 + 1e-12 i, as
    JAX's loop), so no repetition can be skipped; the closure returns the
    accumulator, a 0-d float32 tensor on the output's device."""

    def run(*a):
        acc = None
        for i in range(iters):
            out = step_fn(*a)
            s = out.to(torch.float32).sum() * (1.0 + 1e-12 * i)
            acc = s if acc is None else acc + s
        return acc

    return run


def measure(run, args: tuple, iters: int, reps: int = 3) -> float:
    """Wall seconds per iteration of run(*args) (min over reps); the first
    call warms up. Each rep ends in a synchronize for CUDA tensors."""
    float(run(*args))
    best = float("inf")
    for _ in range(reps):
        _sync_for(args)
        t0 = time.perf_counter()
        float(run(*args))
        _sync_for(args)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def compare(cases: Dict[str, Tuple[Callable, tuple]], iters: int = 20,
            reps: int = 3) -> Dict[str, float]:
    """Interleaved comparison: {name: wall seconds per iteration}, the
    minimum over reps, the cases taking turns within each rep."""
    runners = {name: (chained_timer(fn, args, iters), args)
               for name, (fn, args) in cases.items()}
    for run, args in runners.values():  # warm every case first
        float(run(*args))
    best = {name: float("inf") for name in cases}
    for _ in range(reps):
        for name, (run, args) in runners.items():
            _sync_for(args)
            t0 = time.perf_counter()
            float(run(*args))
            _sync_for(args)
            best[name] = min(best[name], (time.perf_counter() - t0) / iters)
    return best


def _require_cuda(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} reads device time from a CUDA trace; "
                           "this host has no CUDA device")


def _sentinel() -> None:
    """One tiny kernel of a known name (torch.cuda._sleep's spin
    kernel) that brackets the traced work."""
    torch.cuda._sleep(SENTINEL_CYCLES)


def _case_ops(events: list):
    """The traced work's device events of a trace whose device events are
    sentinels, the work, sentinels: the events between the leading and
    the trailing run of sentinels in device time order, or None when a
    run is missing (the profiler dropped it, and perhaps some of the
    work's events with it) or a sentinel falls among the work's."""
    ops = sorted((e for e in events if e.get("ph") == "X"
                  and e.get("cat") in DEVICE_CATEGORIES),
                 key=lambda e: e["ts"])
    is_s = [SENTINEL in e.get("name", "") for e in ops]
    lead = next((i for i, x in enumerate(is_s) if not x), len(ops))
    trail = next((i for i, x in enumerate(reversed(is_s)) if not x),
                 len(ops))
    if lead == len(ops):  # sentinels only: work with no device op
        return [] if lead else None
    mine = ops[lead:len(ops) - trail]
    if not lead or not trail or any(is_s[lead:len(ops) - trail]):
        return None
    return mine


def _traced(fn: Callable[[], None], trace_dir: str) -> list:
    """Run fn() under torch.profiler with CUDA activity -> the trace
    events of every kernel, copy and fill it launched. On an H100 a
    session that follows earlier ones drops its first device events (6
    after a profiled decode, every one of a 20-launch case after many;
    profiler_check.py, PERF.md §6), so fn's events are found on the
    device's own timeline between SENTINEL_OPS sentinel kernels before
    it and after it (each part synchronized). A trace that lost a whole
    run of sentinels is taken again with runs 16 times longer, then
    refused."""
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(trace_dir, "trace.json")
    for n in (SENTINEL_OPS, 16 * SENTINEL_OPS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                _sentinel()
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            for _ in range(n):
                _sentinel()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            mine = _case_ops(json.load(f).get("traceEvents", []))
        if mine is not None:
            return mine
    raise RuntimeError("the profiler dropped a whole run of "
                       f"{16 * SENTINEL_OPS} sentinel kernels")


def _seconds(events: list) -> float:
    return sum(float(e.get("dur", 0.0)) for e in events) / 1e6


def _whole_calls(events: list, iters: int) -> bool:
    """Whether `iters` calls of one case left every op of every call in
    the trace: each kernel, copy and fill name a multiple of iters times
    (a dropped event leaves a count that is not)."""
    counts = collections.Counter(e.get("name", "") for e in events)
    return all(c % iters == 0 for c in counts.values())


def device_compare(cases: Dict[str, Tuple[Callable, tuple]], iters: int = 10,
                   trace_dir: Optional[str] = None) -> Dict[str, float]:
    """{name: device seconds per call}: each case warmed, then called
    `iters` times under its own trace (one trace per case, as JAX's, so
    no two cases' work can be confused), its kernels', copies' and fills'
    device durations summed and divided by iters (NaN when the case
    launches nothing on the device). A trace that lost one of the calls'
    ops (_whole_calls) is taken again, up to TRACE_TRIES times, then
    refused. Raises on a host with no CUDA device."""
    _require_cuda("device_compare")
    base = trace_dir or tempfile.mkdtemp(prefix="fq_bench_trace_")
    results = {}
    try:
        for name, (fn, args) in cases.items():
            fn(*args)  # warm (builds and loads the kernel) outside the trace
            torch.cuda.synchronize()
            case_dir = os.path.join(base, name.replace(" ", "_")
                                    .replace(os.sep, "_"))
            os.makedirs(case_dir, exist_ok=True)

            def loop(fn=fn, args=args):
                for _ in range(iters):
                    fn(*args)

            for _ in range(TRACE_TRIES):
                events = _traced(loop, case_dir)
                if _whole_calls(events, iters):
                    results[name] = (_seconds(events) / iters if events
                                     else float("nan"))
                    break
            else:
                raise RuntimeError(f"device_compare {name!r}: the profiler "
                                   f"dropped device events in "
                                   f"{TRACE_TRIES} traces")
    finally:
        if trace_dir is None:
            shutil.rmtree(base, ignore_errors=True)
    return results


def device_time_loop(run_loop: Callable[[], None],
                     trace_dir: Optional[str] = None) -> Tuple[float, int]:
    """Device time of an arbitrary (pre-warmed) call sequence: run_loop()
    makes its calls (threading whatever state it carries, such as a
    decode loop's cache) under one trace; returns (device seconds, device
    ops), summed over every kernel, copy and fill in the trace. JAX's
    counts jit executables; here one call launches many ops, so the count
    is of device ops. The loop runs once, so an event the profiler drops
    inside it is not seen (device_compare retakes such traces). Raises on
    a host with no CUDA device."""
    _require_cuda("device_time_loop")
    base = trace_dir or tempfile.mkdtemp(prefix="fq_bench_trace_loop_")
    try:
        os.makedirs(base, exist_ok=True)
        events = _traced(run_loop, base)
        return _seconds(events), len(events)
    finally:
        if trace_dir is None:
            shutil.rmtree(base, ignore_errors=True)

