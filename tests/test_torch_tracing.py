"""The port's tracer (flatquant_torch/utils/tracing.py) and the spans and
counters of the serving path, on the CPU at tiny sizes.

Off, the tracer hands out one shared no-op object and records nothing;
on, the continuous batcher serves the same tokens (paged with a bucket,
the int4 slot cache chunked, the bf16 cache whole, DeepSeek's hooks over
both MoE routes), every span lies inside its parent, each `decode` span
names the active slots' requests, each admitted request has one `queued`
span from its submit, and the counters equal the arithmetic of the calls
the spans record: rows of prefill and chunk calls, host syncs per call,
decode rows, and the MoE rows of each route."""

import collections
import dataclasses
import math

import numpy as np
import pytest
import torch

from flatquant_torch.models import deepseek as tds
from flatquant_torch.models import llama as tl
from flatquant_torch.models.config import get_config
from flatquant_torch.quantize.bake import bake_model
from flatquant_torch.quantize.spec import W4A4, W4A4KV4
from flatquant_torch.quantize.state import init_model_fq
from flatquant_torch.serving.batcher import ContinuousBatcher
from flatquant_torch.serving.quantized import build_serving_params
from flatquant_torch.utils import tracing

torch.set_num_threads(2)

# the Llama batchers: (cache mode and prefill settings, max_len)
LLAMA = {
    "paged-bucket": (dict(cache_mode="paged", block_size=128, n_blocks=3,
                          prefill_bucket=8), 128),
    "int4-chunk": (dict(cache_mode="int4", prefill_chunk=8), 64),
    "bf16-whole": (dict(cache_mode="bf16"), 64),
}
# host syncs a call passes: H2D of tokens and of the rope table's
# frequencies, of last_idx (prefill, chunk), of the positions (decode),
# of the block table (paged), and the D2H read of the first token (after
# a whole prefill or the last chunk) and of the decode argmax; DeepSeek's
# rope tables are cached on the device
SYNCS = {"prefill": 3, "chunk": 3, "decode": 3}
ROUTES = ("dense", "gather")


@pytest.fixture(autouse=True)
def _tracer_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


@pytest.fixture(scope="module")
def llama():
    cfg = get_config("tiny-llama")
    p = tl.init_params(cfg, 0, device="cpu")
    p["lm_head"] = p["lm_head"] * 6.0  # sharpen: no greedy ties
    bp, bf = bake_model(cfg, W4A4KV4, p,
                        init_model_fq(cfg, W4A4KV4, 0, device="cpu"))
    return cfg, build_serving_params(cfg, W4A4KV4, bp, bf,
                                     dtype=torch.float32,
                                     merge_projections=True)


@pytest.fixture(scope="module")
def deepseek():
    cfg = tds.TINY_DEEPSEEK
    params = tds.init_ds_params(cfg, 0, device="cpu")
    baked = tds.bake_ds_fq(*tds.init_ds_fq(cfg, W4A4, 0, device="cpu"))
    sp, fq = tds.build_ds_serving_params(cfg, W4A4, params, *baked,
                                         dtype=torch.float32)
    return {"params": sp, "fq": fq}


def _llama_batcher(llama, mode):
    cfg, sp = llama
    kw, max_len = LLAMA[mode]
    return ContinuousBatcher(cfg, W4A4KV4, sp, batch_slots=2,
                             max_len=max_len, compute_dtype=torch.float32,
                             device="cpu", **kw)


def _ds_batcher(deepseek, route):
    cfg = dataclasses.replace(tds.TINY_DEEPSEEK, moe_impl=route)
    return ContinuousBatcher(cfg, W4A4, deepseek, batch_slots=2, max_len=32,
                             prefill_chunk=8,
                             forward_fn=tds.ds_batch_forward,
                             init_cache_fn=tds.ds_init_batch_cache,
                             compute_dtype=torch.float32, device="cpu")


def _serve(b, lengths, traced):
    """Submit requests of these (prompt, output) lengths and run them all;
    returns (tokens by rid, the Request objects, spans, counters)."""
    rng = np.random.default_rng(11)
    reqs = []
    for n, m in lengths:
        b.submit(rng.integers(0, 256, n).astype(np.int32), m)
        reqs.append(b.queue[-1])
    if traced:
        tracing.enable()
    try:
        out = b.run(max_steps=200)
    finally:
        tracing.disable()
    spans, counters = tracing.drain()
    return out, reqs, spans, counters


LLAMA_LOAD = ((5, 4), (20, 3), (9, 5))
DS_LOAD = ((5, 3), (11, 4), (4, 2))
CASES = [("llama", m) for m in LLAMA] + [("deepseek", r) for r in ROUTES]


def _run(case, llama, deepseek, traced):
    family, mode = case
    if family == "llama":
        return _serve(_llama_batcher(llama, mode), LLAMA_LOAD, traced)
    return _serve(_ds_batcher(deepseek, mode), DS_LOAD, traced)


def test_off_records_nothing():
    """Off: span() and sync() return the one shared no-op object, and no
    span, record or counter is kept."""
    assert not tracing.ON
    assert tracing.span("decode", rids=[1]) is tracing.NOOP
    assert tracing.sync("h2d.tokens") is tracing.NOOP
    with tracing.span("x"):
        tracing.count("c", 3)
        tracing.record("queued", 0.0, 1.0, rid=0)
    assert tracing.drain() == ([], {})


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_same_tokens_traced(case, llama, deepseek):
    """Tracing on serves the same tokens as tracing off, and off records
    nothing."""
    off, _, spans, counters = _run(case, llama, deepseek, traced=False)
    assert spans == [] and counters == {}
    on, _, spans, _ = _run(case, llama, deepseek, traced=True)
    assert on == off and len(off) == 3 and spans


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_spans_nest_and_name_requests(case, llama, deepseek):
    """Every span lies inside its parent; each decode span carries the
    rids of the slots active in it; each admitted request has one queued
    span, from its submit to its admission (the start of its prefill or
    first chunk)."""
    _, reqs, spans, _ = _run(case, llama, deepseek, traced=True)
    by_id = {s[0]: s for s in spans}
    for sid, parent, name, t0, t1, attrs in spans:
        assert t0 <= t1, name
        if parent is not None:
            p = by_id[parent]
            assert p[3] <= t0 and t1 <= p[4], (name, p[2])
    names = collections.Counter(s[2] for s in spans)
    assert names["queued"] == len(reqs)
    queued = {s[5]["rid"]: s for s in spans if s[2] == "queued"}
    first = {}
    for s in sorted(spans, key=lambda s: s[3]):
        if s[2] in ("prefill", "chunk"):
            first.setdefault(s[5]["rids"][0], s)
    for r in reqs:
        q = queued[r.rid]
        assert q[1] is None and q[3] == r.submit_t
        assert q[4] <= first[r.rid][3]
    # a decode span names the requests in flight: those admitted before it
    # and not yet finished (each rid decodes max_new - 1 times)
    decodes = collections.Counter()
    for s in spans:
        if s[2] == "decode":
            assert len(s[5]["rids"]) == s[5]["rows_true"] >= 1
            for rid in s[5]["rids"]:
                assert queued[rid][4] <= s[3]
                decodes[rid] += 1
    assert decodes == {r.rid: r.max_new_tokens - 1 for r in reqs}
    family, _ = case
    layer = {"llama": {"qkv", "kv_write", "attn", "o_proj", "mlp"},
             "deepseek": {"mla", "ffn", "moe"}}[family]
    kids = {by_id[s[1]][2] for s in spans if s[2] in layer}
    assert kids == {"layer"}
    assert {by_id[s[1]][2] for s in spans if s[2] == "layer"} <= {
        "prefill", "chunk", "decode"}


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_counters_equal_the_calls(case, llama, deepseek):
    """prefill.rows_* sum the true and computed rows of the prefill and
    chunk calls (padding in computed); decode.* count the decode calls and
    their active rows; host_syncs the sites each call passes."""
    family, mode = case
    _, reqs, spans, counters = _run(case, llama, deepseek, traced=True)
    calls = [s for s in spans if s[2] in ("prefill", "chunk", "decode")]
    pre = [s[5] for s in calls if s[2] != "decode"]
    dec = [s[5] for s in calls if s[2] == "decode"]
    kw = LLAMA[mode][0] if family == "llama" else dict(prefill_chunk=8)
    lengths = [len(r.prompt) for r in reqs]
    if kw.get("prefill_chunk"):
        c = kw["prefill_chunk"]
        want_true = sum(lengths)
        want_comp = sum(-(-n // c) * c for n in lengths)
        assert all(a["rows_computed"] == c for a in pre)
    else:
        bucket = kw.get("prefill_bucket") or 1
        want_true = sum(lengths)
        want_comp = sum(-(-n // bucket) * bucket for n in lengths)
    assert counters["prefill.rows_true"] == want_true
    assert sum(a["rows_true"] for a in pre) == want_true
    assert counters["prefill.rows_computed"] == want_comp
    assert counters["decode.calls"] == len(dec)
    assert counters["decode.slot_rows"] == sum(a["rows_true"] for a in dec)
    n = collections.Counter(s[2] for s in calls)
    per = dict(SYNCS)
    if family == "deepseek":
        per = {k: v - 1 for k, v in per.items()}  # no rope-table copy
    if kw.get("cache_mode") == "paged":
        per = {k: v + 1 for k, v in per.items()}  # the block table
    want = (sum(per[k] * n[k] for k in n) + len(reqs)  # first tokens
            + n["decode"])  # the decode argmax
    assert counters["host_syncs"] == want
    steps = sum(1 for s in spans if s[2] == "step")
    assert steps == sum(1 for s in spans if s[2] == "admit")
    syncs = [s for s in spans if s[2] == "sync"]
    assert len(syncs) == want
    sites = collections.Counter(s[5]["site"] for s in syncs)
    assert {f"host_syncs.{k}": v for k, v in sites.items()} == {
        k: v for k, v in counters.items() if k.startswith("host_syncs.")}


@pytest.mark.parametrize("route", ROUTES)
def test_moe_rows_equal_the_routes(route, deepseek):
    """moe.rows_useful is T*K a MoE layer; moe.rows_computed E*T in the
    dense-masked route and E*C in the capacity gather (C = ceil(T*K/E *
    capacity factor)), summed over the calls' rows and the MoE layers."""
    cfg = tds.TINY_DEEPSEEK
    _, _, spans, counters = _serve(_ds_batcher(deepseek, route), DS_LOAD,
                                   traced=True)
    E, K = cfg.n_routed_experts, cfg.n_activated_experts
    n_moe = cfg.n_layers - cfg.n_dense_layers
    # every call computes its padded rows: a chunk's C, a decode's slots
    rows = [s[5]["rows_computed"] for s in spans
            if s[2] in ("prefill", "chunk", "decode")]
    assert counters["moe.rows_useful"] == n_moe * K * sum(rows)
    if route == "dense":
        want = n_moe * E * sum(rows)
    else:
        want = n_moe * sum(E * max(1, math.ceil(t * K / E
                                                * cfg.moe_capacity_factor))
                           for t in rows)
    assert counters["moe.rows_computed"] == want
    moe = {s[0] for s in spans if s[2] == "moe"}
    kids = collections.Counter(s[2] for s in spans if s[1] in moe)
    assert kids == {k: n_moe * len(rows) for k in
                    ("moe.gate", "moe.routed_experts", "moe.shared")}
