"""Closed-loop clients, one per batch slot: a client sends its next request
when its last one completes, so a slow server receives less load.

Sizes come from stratified quantiles of the mix's distributions: the
prompt and the output distribution are each cut into `strata` slices of
equal probability, and every block of `strata` consecutive requests holds
each slice's midpoint once. With a power of two of strata the block's
order is balanced: slice i takes place bitreverse(i) XOR a mask the seed
draws (prompts and outputs each their own mask), so every aligned run of
2^k requests holds one slice of each of 2^k equal groups, and a window
that takes part of a block still takes sizes from the whole range.
Otherwise the seed permutes the block. So every seed serves the same
sizes, in its own order, and a window holds nearly the same work whatever
the seed. The seed also draws the prompts' token ids (uniform over the
vocabulary: no two prompts share a prefix).

The first wave fills every slot before the window opens. Its output
lengths are the quantile midpoints of the residual of the output
distribution (the tokens still to come of a request in flight at a
random moment: a size drawn in proportion to its length, then a uniform
point of it), so that completions come at the steady rate from the
window's first second.

Parameters (the workload's "traffic"):
  clients                      requests in flight, one per batch slot
  prompt, output: {dist: "lognormal", median, sigma, min, max}
                  or {dist: "uniform", min, max}
  strata                       slices of each distribution
"""

from __future__ import annotations

import statistics

import numpy as np


def _quantiles(spec: dict, n: int) -> list:
    """Midpoints of n equal-probability slices of the distribution, as
    whole token counts."""
    mids = [(j + 0.5) / n for j in range(n)]
    if spec["dist"] == "lognormal":
        nd = statistics.NormalDist()
        vals = [spec["median"] * float(np.exp(spec["sigma"] * nd.inv_cdf(q)))
                for q in mids]
        return [int(min(max(round(v), spec["min"]), spec["max"]))
                for v in vals]
    if spec["dist"] == "uniform":
        width = spec["max"] - spec["min"] + 1
        return [spec["min"] + int(q * width) for q in mids]
    raise ValueError(f"unknown distribution {spec['dist']!r}")


class Traffic:
    """The request stream of one run: `first_wave()`, then `next()` for
    each request a client sends after its last one completed."""

    def __init__(self, params: dict, seed: int, vocab: int):
        self.clients = int(params["clients"])
        self.strata = int(params["strata"])
        self.vocab = int(vocab)
        self.rng = np.random.default_rng(seed)
        self.prompt_sizes = _quantiles(params["prompt"], self.strata)
        self.output_sizes = _quantiles(params["output"], self.strata)
        self._block = []

    def _tokens(self, n: int) -> np.ndarray:
        return self.rng.integers(0, self.vocab, size=n, dtype=np.int32)

    def _order(self) -> list:
        """The order of the slices in one block."""
        n = self.strata
        bits = n.bit_length() - 1
        if n != 1 << bits:
            return [int(i) for i in self.rng.permutation(n)]
        mask = int(self.rng.integers(n))
        return [int(format(i, f"0{bits}b")[::-1], 2) ^ mask if bits else 0
                for i in range(n)]

    def sizes(self):
        """The next (prompt length, output length) of the stratified
        stream."""
        if not self._block:
            p, o = self._order(), self._order()
            self._block = [(self.prompt_sizes[i], self.output_sizes[j])
                           for i, j in zip(p, o)][::-1]
        return self._block.pop()

    def next(self):
        """(prompt token ids, max_new_tokens) of the next request."""
        s, o = self.sizes()
        return self._tokens(s), o

    def residuals(self, n: int) -> list:
        """Quantile midpoints of n slices of the residual output length:
        P(R = r) = P(X >= r) / E[X] for r = 1 .. max X, X the stratified
        output sizes."""
        xs = np.asarray(self.output_sizes, np.float64)
        r = np.arange(1, int(xs.max()) + 1)
        pmf = (xs[None, :] >= r[:, None]).mean(axis=1) / xs.mean()
        cdf = np.cumsum(pmf)
        return [int(r[min(np.searchsorted(cdf, (j + 0.5) / n), len(r) - 1)])
                for j in range(n)]

    def first_wave(self) -> list:
        """One request per client, output lengths the residual's
        quantiles in an order the seed draws."""
        outs = self.residuals(self.clients)
        outs = [outs[i] for i in self.rng.permutation(self.clients)]
        wave = []
        for o in outs:
            s, _ = self.sizes()
            wave.append((self._tokens(s), o))
        return wave
