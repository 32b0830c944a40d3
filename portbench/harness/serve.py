"""Driving the program's public serving entry: `ContinuousBatcher.submit`,
then `step` in a loop, from the clients of a traffic generator.

A timestamp is taken after each `step()` returns (a step ends in the
host copy of its argmax, a synchronization); a request's tokens are
stamped when they appear in its `out_tokens`, and the request is
submitted at the stamp of the step that finished its client's previous
request.
"""

from __future__ import annotations

import time

import torch

clock = time.perf_counter


class Req:
    """One request: its batcher Request, when it was submitted, and the
    stamp of each of its output tokens."""

    __slots__ = ("rid", "req", "prompt_len", "max_new", "submit_t", "stamps",
                 "finish_t")

    def __init__(self, b, prompt, max_new, t):
        self.rid = b.submit(prompt, max_new)
        self.req = b.queue[-1]
        self.prompt_len = len(prompt)
        self.max_new = max_new
        self.submit_t = t
        self.stamps = []
        self.finish_t = None


def _advance(b, traffic, live, t, done):
    """Stamp new tokens; a finished request's client submits its next."""
    still = []
    for r in live:
        new = len(r.req.out_tokens) - len(r.stamps)
        if new:
            r.stamps.extend([t] * new)
        if r.rid in b.finished:
            r.finish_t = t
            done.append(r)
            still.append(Req(b, *traffic.next(), t))
        else:
            still.append(r)
    return still


def fill(b, traffic) -> list:
    """Set-up: the first wave fills every slot, prefilled before the
    window opens; returns the requests in flight."""
    t = clock()
    live = [Req(b, p, n, t) for p, n in traffic.first_wave()]
    while b.queue or b.pending is not None:
        b.step()
        live = _advance(b, traffic, live, clock(), [])
    return live


def window(b, traffic, live, seconds: float, slicer=None) -> dict:
    """Whole steps until `seconds` have passed since the window opened
    and a traced slice that is on has ended. Returns {"t0", "t1", "done":
    requests finished in the window, "live": requests in flight at its
    close, "steps"}."""
    done, steps = [], 0
    t0 = t = clock()
    while t - t0 < seconds or (slicer is not None
                               and slicer.state == "on"):
        if slicer is not None:
            slicer.before_step(t - t0)
        b.step()
        t = clock()
        steps += 1
        live = _advance(b, traffic, live, t, done)
        if slicer is not None:
            slicer.after_step()
    return {"t0": t0, "t1": t, "done": done, "live": live, "steps": steps}


def served(win: dict) -> list:
    """Every request with a token stamped in the window."""
    return [r for r in win["done"] + win["live"]
            if any(win["t0"] < s <= win["t1"] for s in r.stamps)]


class Tap:
    """The logit of each served token as the program's forward call
    returned it (the row's best: the batcher serves its argmax). Wraps the
    batcher's decode call and its seating of a prefilled request; one
    reduction on the device a call, read back after the window."""

    def __init__(self, b):
        self.b, self.calls = b, []
        self._decode, self._activate = b._decode_multi, b._activate

        def decode(*a):
            rows = [(s, r, len(r.out_tokens))
                    for s, r in enumerate(b.slot_req) if r is not None]
            logits = self._decode(*a)
            self.calls.append((logits.amax(dim=-1), rows))
            return logits

        def activate(slot, req, S, logits):
            self.calls.append((logits[:1].amax(dim=-1), [(0, req, 0)]))
            return self._activate(slot, req, S, logits)

        b._decode_multi, b._activate = decode, activate

    def uninstall(self):
        self.b._decode_multi, self.b._activate = self._decode, self._activate

    def values(self) -> dict:
        """{id of a batcher Request: {token index: logit}}."""
        out = {}
        if not self.calls:
            return out
        flat = torch.cat([v.reshape(-1).float() for v, _ in self.calls])
        flat = flat.cpu().tolist()
        at = 0
        for v, rows in self.calls:
            for s, r, i in rows:
                out.setdefault(id(r), {})[i] = flat[at + s]
            at += v.numel()
        return out
