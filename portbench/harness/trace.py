"""Reading a traced slice: the device ops between the two runs of
sentinel kernels, each attributed to the host span it was launched in.

The trace holds device ops and the runtime or driver calls that launched
them (joined by correlation id), on the trace's clock; the spans are on
the host clock (harness/spans.py). The slicer noted the host time right
after the last leading sentinel's launch and right before the first
trailing one's; those launches in the trace give the offset between the
clocks. An op whose launch the trace lacks is placed by its own start.
The slice's wall is the device timeline from the end of the leading
sentinels to the start of the trailing ones.
"""

from __future__ import annotations

import bisect
import collections
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SENTINEL = "spin_kernel"


class _Spans:
    """Non-overlapping host intervals (t0, t1, value), searchable by
    time."""

    def __init__(self, items):
        self.items = sorted(items)
        self.starts = [a for a, _, _ in self.items]

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.items[i][1] >= t:
            return self.items[i][2]
        return None


def _corr(e):
    return e.get("args", {}).get("correlation")


def read(path: str, marks: dict, forwards: list, spans: list):
    """{"ops": [{"name", "ts", "dur" (s), "fwd" (index of the forward
    call it was launched in, or None), "spans" (names of the family spans
    around its launch)}], "window_s", "busy_s", "gaps": [(what the host
    was in, seconds)], "attributed": share of ops placed by their launch,
    "drift_s": the two sentinel offsets' difference} of the slice; None
    when a run of sentinels or both clock marks are missing."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    dev = sorted((e for e in events if e.get("ph") == "X"
                  and e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"])
    is_s = [SENTINEL in e.get("name", "") for e in dev]
    lead = next((i for i, x in enumerate(is_s) if not x), len(dev))
    trail = next((i for i, x in enumerate(reversed(is_s)) if not x),
                 len(dev))
    if not lead or not trail or lead == len(dev):
        return None
    launch = {_corr(e): e for e in events
              if e.get("cat") in LAUNCH_CATS and _corr(e) is not None}
    offsets = []
    first_trail = dev[len(dev) - trail]
    for op, mark, end in ((dev[lead - 1], "lead", True),
                          (first_trail, "trail", False)):
        ln = launch.get(_corr(op))
        if ln is not None and mark in marks:
            ts = float(ln["ts"]) + (float(ln.get("dur", 0)) if end else 0)
            offsets.append(ts / 1e6 - marks[mark])
    if not offsets:
        return None
    offset = offsets[0]
    t0 = float(dev[lead - 1]["ts"]) + float(dev[lead - 1]["dur"])
    t1 = float(first_trail["ts"])
    fwd = _Spans((f["t0"], f["t1"], f["n"]) for f in forwards if f["slice"])
    fam = collections.defaultdict(list)
    for name, a, b in spans:
        fam[name].append((a, b, name))
    fam = {k: _Spans(v) for k, v in fam.items()}
    ops, found = [], 0
    for e in dev[lead:len(dev) - trail]:
        ln = launch.get(_corr(e))
        found += ln is not None
        h = (float(ln["ts"]) if ln is not None else float(e["ts"])) / 1e6 \
            - offset
        ops.append({"name": e.get("name", ""), "ts": float(e["ts"]),
                    "dur": float(e["dur"]) / 1e6, "fwd": fwd.at(h),
                    "spans": {k for k, s in fam.items() if s.at(h)}})
    phase = {f["n"]: f["phase"] for f in forwards}
    busy, gaps, end = 0.0, [], t0
    for e in ops:
        a, b = max(e["ts"], t0), min(e["ts"] + e["dur"] * 1e6, t1)
        if b <= end:
            continue
        if a > end:
            n = fwd.at(end / 1e6 - offset)
            gaps.append((f"host in a {phase[n]} call" if n is not None
                         else "host between model calls", (a - end) / 1e6))
            end = a
        busy += b - end
        end = b
    if t1 > end:
        gaps.append(("host between model calls", (t1 - end) / 1e6))
    return {"ops": ops, "window_s": (t1 - t0) / 1e6, "busy_s": busy / 1e6,
            "gaps": gaps, "attributed": found / max(len(ops), 1),
            "drift_s": offsets[-1] - offsets[0]}


def breakdown(sl: dict, top: int = 10) -> dict:
    """The device ops that took most time, and the idle gaps summed by
    what the host was doing."""
    by_name = collections.Counter()
    for o in sl["ops"]:
        by_name[o["name"][:160]] += o["dur"]
    gaps = collections.Counter()
    for label, s in sl["gaps"]:
        gaps[label] += s
    return {"device_ops": [[n, s] for n, s in by_name.most_common(top)],
            "idle_gaps": [[n, s] for n, s in gaps.most_common(top)]}
