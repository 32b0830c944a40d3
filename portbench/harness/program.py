"""The program's own spans (flatquant_torch/utils/tracing.py) joined to a
traced slice on one clock.

The program records spans on the host clock (`time.perf_counter`, the
clock of the slicer's sentinel marks). `read` takes the slice's device
ops between the two runs of sentinels, as harness/trace.py does, with the
host time of each op's launch: the trace's launch time less the offset
between the clocks, which the last leading sentinel's launch and the
slicer's "lead" mark give. `join` then:

  - gives each op the innermost program span open at its launch, and sums
    device time by the span's path (`decode/layer/mlp`: the names from the
    root down, a leading `step` left out);
  - splits each idle gap of the device timeline among the innermost spans
    that overlap it on the host clock, summed by path; time no span
    covers is "outside spans".

Spans that time a wait and not host work (`queued`) take no part. The
per-layer numbers (`metrics`) read the join and the program's counters.
"""

from __future__ import annotations

import bisect
import collections
import json

from portbench.harness.trace import DEVICE_CATS, LAUNCH_CATS, SENTINEL, \
    _corr

OUTSIDE = "outside spans"
WAITS = ("queued",)


def read(path: str, marks: dict):
    """{"offset_s": trace seconds - host seconds, "t0", "t1": the slice's
    ends on the trace clock (seconds), "ops": [{"ts", "dur" (trace
    seconds), "launch_s" (host seconds of its launch, or None when the
    trace lacks it)}]}; None when a run of sentinels or the lead mark is
    missing."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    dev = sorted((e for e in events if e.get("ph") == "X"
                  and e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"])
    is_s = [SENTINEL in e.get("name", "") for e in dev]
    lead = next((i for i, x in enumerate(is_s) if not x), len(dev))
    trail = next((i for i, x in enumerate(reversed(is_s)) if not x),
                 len(dev))
    if not lead or not trail or lead == len(dev) or "lead" not in marks:
        return None
    launch = {_corr(e): e for e in events
              if e.get("cat") in LAUNCH_CATS and _corr(e) is not None}
    ln = launch.get(_corr(dev[lead - 1]))
    if ln is None:
        return None
    offset = (float(ln["ts"]) + float(ln.get("dur", 0))) / 1e6 - marks["lead"]
    ops = []
    for e in dev[lead:len(dev) - trail]:
        ln = launch.get(_corr(e))
        ops.append({"ts": float(e["ts"]) / 1e6, "dur": float(e["dur"]) / 1e6,
                    "launch_s": (None if ln is None
                                 else float(ln["ts"]) / 1e6 - offset)})
    t0 = (float(dev[lead - 1]["ts"]) + float(dev[lead - 1]["dur"])) / 1e6
    return {"offset_s": offset, "t0": t0,
            "t1": float(dev[len(dev) - trail]["ts"]) / 1e6, "ops": ops}


def _name(s) -> str:
    """A span's name in a path: a sync span's with its site."""
    return f"sync.{s[5]['site']}" if s[2] == "sync" else s[2]


def paths(spans) -> dict:
    """{span id: its path}: the names from the root down, joined by "/",
    a leading "step" left out."""
    by_id = {s[0]: s for s in spans}
    out = {}

    def path(sid):
        if sid not in out:
            parent, name = by_id[sid][1], _name(by_id[sid])
            head = path(parent) if parent in by_id else ""
            out[sid] = f"{head}/{name}" if head else (
                "" if name == "step" else name)
        return out[sid]

    for s in spans:
        path(s[0])
    return out


class Timeline:
    """The host timeline cut into pieces, each labelled with the path of
    the innermost program span open there (spans nest, so the pieces do
    not overlap)."""

    def __init__(self, spans):
        names = paths(spans)
        kids = collections.defaultdict(list)
        roots = []
        ids = {s[0] for s in spans}
        for s in spans:
            if s[2] in WAITS:
                continue
            (kids[s[1]] if s[1] in ids else roots).append(s)
        pieces = []

        def cut(s):
            at = s[3]
            for c in sorted(kids[s[0]], key=lambda c: c[3]):
                if c[3] > at:
                    pieces.append((at, c[3], names[s[0]]))
                cut(c)
                at = max(at, c[4])
            if s[4] > at:
                pieces.append((at, s[4], names[s[0]]))

        for r in sorted(roots, key=lambda r: r[3]):
            cut(r)
        self.pieces = sorted(pieces)
        self.starts = [p[0] for p in self.pieces]

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.pieces[i][1] >= t:
            return self.pieces[i][2]
        return OUTSIDE

    def split(self, a: float, b: float) -> dict:
        """{path: seconds} of the host interval [a, b]."""
        out = collections.Counter()
        i = max(bisect.bisect_right(self.starts, a) - 1, 0)
        covered = 0.0
        while i < len(self.pieces) and self.pieces[i][0] < b:
            lo, hi = max(a, self.pieces[i][0]), min(b, self.pieces[i][1])
            if hi > lo:
                out[self.pieces[i][2]] += hi - lo
                covered += hi - lo
            i += 1
        if b - a > covered:
            out[OUTSIDE] += b - a - covered
        return out


def join(sl: dict, spans) -> dict:
    """{"device_time": {path: device seconds launched under it}, "idle":
    {path: idle seconds the host spent in it}, "idle_s", "busy_s",
    "calls": {span name: spans begun inside the slice}} of a slice from
    `read`. An op whose launch the trace lacks is placed by its own
    start."""
    tl = Timeline(spans)
    off = sl["offset_s"]
    calls = collections.Counter(
        s[2] for s in spans if sl["t0"] - off <= s[3] <= sl["t1"] - off)
    dev, idle = collections.Counter(), collections.Counter()
    busy, end = 0.0, sl["t0"]
    for o in sl["ops"]:
        h = o["launch_s"] if o["launch_s"] is not None else o["ts"] - off
        dev[tl.at(h)] += o["dur"]
        a, b = max(o["ts"], sl["t0"]), min(o["ts"] + o["dur"], sl["t1"])
        if b <= end:
            continue
        if a > end:
            idle.update(tl.split(end - off, a - off))
            end = a
        busy += b - end
        end = b
    if sl["t1"] > end:
        idle.update(tl.split(end - off, sl["t1"] - off))
    return {"device_time": dict(dev), "idle": dict(idle),
            "idle_s": sum(idle.values()), "busy_s": busy,
            "calls": dict(calls)}


def top(by_path: dict, n: int = 10) -> list:
    return [[p, s] for p, s in collections.Counter(by_path).most_common(n)]


def under(by_path: dict, root: str, strictly: bool = False) -> float:
    """Seconds under `root` (its subtree; without `root`'s own time when
    `strictly`)."""
    return sum(s for p, s in by_path.items()
               if p.startswith(root + "/") or (p == root and not strictly))


def metrics(spans, counters: dict, joined=None) -> dict:
    """The per-layer numbers the program's records give (a key is left out
    where there is nothing to read): queue_wait_ms (mean submit ->
    admission of the requests admitted), prefill_useful_share and
    moe_useful_share (true over computed rows, %), host_syncs_per_step,
    and, from a joined slice, decode_idle_ms (device-idle ms under
    `decode` spans per decode call in the slice)."""
    out = {}
    waits = [s[4] - s[3] for s in spans if s[2] == "queued"]
    if waits:
        out["queue_wait_ms"] = 1e3 * sum(waits) / len(waits)
    for name, true, computed in (
            ("prefill_useful_share", "prefill.rows_true",
             "prefill.rows_computed"),
            ("moe_useful_share", "moe.rows_useful", "moe.rows_computed")):
        if counters.get(computed):
            out[name] = 100.0 * counters[true] / counters[computed]
    steps = sum(1 for s in spans if s[2] == "step")
    if steps:
        out["host_syncs_per_step"] = counters.get("host_syncs", 0) / steps
    if joined is not None and joined["calls"].get("decode"):
        out["decode_idle_ms"] = (1e3 * under(joined["idle"], "decode")
                                 / joined["calls"]["decode"])
    return out
