"""Spans of a traced run, recorded on the host clock by the harness's own
wrappers around the calls into each layer, installed only in traced runs
and removed after:

  - the batcher's call of the model step (`ContinuousBatcher._call`, the
    one call through which prefill, chunk and decode reach the engine's
    `_forward` or a family's forward hook): a record per call (phase, the
    call's true rows, attended lengths, emitted rows, host start and
    end). A decode call ends in a synchronization here (the step's argmax
    would synchronize right after it), so its span is the host wall of
    the whole call;
  - a family's SPANS, functions inside the program (DeepSeek's routed
    experts): (name, host start, host end).

`Slicer` profiles a whole number of scheduler steps from the middle of
the window with CUDA activity only (kernels, copies, fills and the
runtime calls that launched them; recording every host op as well slowed
a Qwen step 1.5x), bracketed by sentinel kernels (torch.cuda._sleep's
spin kernel): a profiler session can drop its first device events, so
the slice is found on the device's own timeline between the two runs of
sentinels (the technique of flatquant_torch/utils/benchmark.py
`_traced`). The host clock is tied to the trace's by the launch of the
last leading and the first trailing sentinel, whose host times the slicer
notes.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import ProfilerActivity, profile

SENTINEL_OPS, SENTINEL_CYCLES = 256, 1000


class Recorder:
    def __init__(self, b, family):
        self.forwards = []
        self.spans = []
        self.in_slice = False
        self._undo = []
        cuda = b.dev.type == "cuda"
        orig_call = b._call

        def call(tokens, cache, pos, phase, last_idx=None):
            rec = {"n": len(self.forwards), "phase": phase,
                   "slice": self.in_slice}
            if phase == "decode":
                rec["valid"] = [int(p) + 1 for p, r in zip(b.pos, b.slot_req)
                                if r is not None]
                rec.update(rows=len(rec["valid"]), start=0,
                           emitted=len(rec["valid"]))
            else:
                final = phase == "prefill" or (
                    b.pending["ci"] == b.pending["n"] - 1)
                rec.update(rows=int(last_idx[0]) + 1, start=int(pos),
                           emitted=int(final))
            rec["t0"] = time.perf_counter()
            out = orig_call(tokens, cache, pos, phase, last_idx)
            if phase == "decode" and cuda:
                torch.cuda.synchronize()
            rec["t1"] = time.perf_counter()
            self.forwards.append(rec)
            return out

        b._call = call
        self._undo.append(lambda: delattr(b, "_call"))
        for mod, name, label in family.SPANS:
            self._wrap(mod, name, label)

    def _wrap(self, mod, name, label):
        orig = getattr(mod, name)

        def wrapped(*a, **k):
            t0 = time.perf_counter()
            out = orig(*a, **k)
            if self.in_slice:
                self.spans.append((label, t0, time.perf_counter()))
            return out

        setattr(mod, name, wrapped)
        self._undo.append(lambda: setattr(mod, name, orig))

    def uninstall(self):
        for undo in reversed(self._undo):
            undo()
        self._undo = []


def _sentinels():
    """Launch a run of sentinels; returns the host times just before the
    first launch and just after the last."""
    t0 = time.perf_counter()
    for _ in range(SENTINEL_OPS):
        torch.cuda._sleep(SENTINEL_CYCLES)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return t0, t1


class Slicer:
    """Profiles whole steps from `start_frac` of the window on, until at
    least `min_steps` steps ran and a call of every phase in `phases`
    came, or `max_steps` ran."""

    def __init__(self, rec: Recorder, seconds: float, params: dict):
        self.rec = rec
        self.start_at = params["start_frac"] * seconds
        self.min_steps = params["min_steps"]
        self.max_steps = params["max_steps"]
        self.phases = set(params["phases"])
        self.prof = None
        self.steps = 0
        self.state = "before"
        self.marks = {}

    def before_step(self, elapsed: float):
        if self.state != "before" or elapsed < self.start_at:
            return
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.marks["lead"] = _sentinels()[1]
        self.rec.in_slice = True
        self.state = "on"

    def after_step(self):
        if self.state != "on":
            return
        self.steps += 1
        seen = {f["phase"] for f in self.rec.forwards if f["slice"]}
        if (self.steps >= self.max_steps
                or (self.steps >= self.min_steps and self.phases <= seen)):
            self.close()

    def close(self):
        """End the slice (also when the window closes inside it)."""
        if self.state != "on":
            return
        torch.cuda.synchronize()
        self.rec.in_slice = False
        self.marks["trail"] = _sentinels()[0]
        self.prof.stop()
        self.state = "done"

    def export(self, path: str) -> bool:
        """Write the slice's trace; False when no slice was taken."""
        if self.state != "done":
            return False
        self.prof.export_chrome_trace(path)
        return True
