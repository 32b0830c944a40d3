"""Whether what the timed path served is correct: a sample of the
requests finished in the window (drawn from the seed, with the longest
in it), each prompt with its served tokens run once through the plain
reference, and at each served position the reference's logits against
what the program served there: the gap by which the served token's
logit lies below the reference's best, and the distance of the served
token's logit as the program's forward call returned it from the
reference's logit of that token, over the spread of the reference's
logits. A cell's check names which of these numbers are compared, each
with its limit.

The control (calibrate.py) reads the same numbers of the token that the
reference computed in a lower precision puts first, with its logit there.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# the reference's precision (reference/common.py PRECISIONS): the
# families serve in bf16, so the reference rounds to bf16 where the
# program holds bf16 and computes in float32
PRECISION = "bf16"


def sample(done: list, seed: int, served_tokens: int) -> list:
    """The longest finished request (prompt and output), then others in
    an order the seed draws, until `served_tokens` are covered."""
    if not done:
        return []
    longest = max(done, key=lambda r: (r.prompt_len + r.max_new, -r.rid))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng([seed & (2**63 - 1), 7]).permutation(
        len(rest))
    pick, n = [longest], longest.max_new
    for i in order:
        if n >= served_tokens:
            break
        pick.append(rest[i])
        n += rest[i].max_new
    return pick


def sequences(picks: list) -> list:
    """(prompt and served tokens but the last, prompt length) of each."""
    return [(np.concatenate([r.req.prompt,
                             np.asarray(r.req.out_tokens[:-1], np.int32)]),
             r.prompt_len) for r in picks]


def gaps(ref_logits: list, tokens: list) -> np.ndarray:
    """Per position: the reference's best logit minus its logit of the
    token (served, or put first by a control)."""
    out = []
    for lg, tok in zip(ref_logits, tokens):
        t = torch.as_tensor(np.asarray(tok), device=lg.device).long()
        out.append((lg.max(dim=-1).values
                    - lg.gather(1, t[:, None])[:, 0]).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def served_logits(picks: list, tapped: dict) -> list:
    """The program's logit of each served token of each pick, as its
    forward call returned it (serve.Tap); NaN where none was tapped."""
    out = []
    for r in picks:
        got = tapped.get(id(r.req), {})
        out.append([got.get(i, float("nan"))
                    for i in range(len(r.req.out_tokens))])
    return out


def numbers(ref_logits: list, tokens: list, values: list) -> dict:
    """What a run's served tokens read against the reference's logits at
    their positions: "mean_gap" and "widest_gap", the reference's best
    logit minus its logit of the served token; "logit_error", the mean
    distance of the served token's logit as served from the reference's,
    each over the spread (standard deviation) of the reference's logits
    at its position."""
    g = gaps(ref_logits, tokens)
    err = []
    for lg, tok, val in zip(ref_logits, tokens, values):
        t = torch.as_tensor(np.asarray(tok), device=lg.device).long()
        v = torch.as_tensor(np.asarray(val, np.float32), device=lg.device)
        ref = lg.gather(1, t[:, None])[:, 0]
        err.append(((v - ref).abs() / lg.std(dim=-1)).cpu().numpy())
    e = np.concatenate(err) if err else np.zeros(0)
    if not g.size:
        return {"mean_gap": math.inf, "widest_gap": math.inf,
                "logit_error": math.inf, "tokens": 0}
    return {"mean_gap": float(g.mean()), "widest_gap": float(g.max()),
            "logit_error": float(e.mean()), "tokens": int(g.size)}


def bad_requests(reqs: list, vocab: int) -> int:
    """Requests whose tokens are out of the vocabulary or more than asked
    for, or that finished with fewer."""
    bad = 0
    for r in reqs:
        toks = r.req.out_tokens
        if (len(toks) > r.max_new or (r.finish_t is not None
                                      and len(toks) != r.max_new)
                or any(not 0 <= t < vocab for t in toks)):
            bad += 1
    return bad
