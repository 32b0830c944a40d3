"""Rank bodies of the port's parallel tests (tests/test_torch_serving_tp.py,
test_torch_pipeline.py, test_torch_sequence.py, test_torch_ds_ep.py).

Each function runs in a spawned rank process (flatquant_torch.parallel.launch
run_ranks) on the CPU over gloo, imports torch and flatquant_torch only (no
JAX: the rank must start fast), takes numpy inputs built by the test from
JAX's models, and returns numpy results for the test to hold against JAX's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return x


def _cfg(name, **kw):
    from flatquant_torch.models.config import get_config

    return dataclasses.replace(get_config(name), **kw)


def _fq(name):
    from flatquant_torch.quantize import spec

    return getattr(spec, name)


def _sp(sp_np):
    from flatquant_torch.utils.convert import from_jax_serving_params

    return from_jax_serving_params(sp_np, "cpu")


def _greedy(logits):
    return logits.argmax(dim=-1, keepdim=True).to(torch.int32)


# ---------------------------------------------------------------------------
# tensor parallelism (world 4: dp 2 x tp 2)
# ---------------------------------------------------------------------------


def _tp_decode_run(cfg, fq_cfg, mesh, sp_tp, toks, cache_mode, max_len,
                   n_decode, dp_axis):
    from flatquant_torch.parallel import serving_tp as stp

    local = stp.shard_serving_params(sp_tp, mesh)
    cache = stp.make_sharded_cache(
        cfg, toks.shape[0], max_len, mesh, mode=cache_mode,
        dtype=torch.float32, dp_axis=dp_axis)
    prefill, decode, _ = stp.tp_serving_programs(
        cfg, fq_cfg, mesh, use_kernel=False, max_len=max_len,
        compute_dtype=torch.float32, dp_axis=dp_axis)
    logits, cache = prefill(local, toks, cache)
    outs = [_np(logits)]
    pos = toks.shape[1]
    tok = _greedy(logits)
    for _ in range(n_decode):
        logits, cache = decode(local, tok, cache, pos)
        outs.append(_np(logits))
        tok = _greedy(logits)
        pos += 1
    return outs


def tp_cases(rank, world, payload):
    from flatquant_torch.parallel.mesh import make_mesh
    from flatquant_torch.serving.batcher import ContinuousBatcher

    mesh = make_mesh({"dp": 2, "tp": 2}, device="cpu")
    out = {}
    toks = _t(payload["toks"])
    for key, fq_name, mode in (("llama_w4a4", "W4A4", "bf16"),
                               ("llama_w4a4kv4", "W4A4KV4", "int4")):
        out["parity_" + mode] = _tp_decode_run(
            _cfg("tiny-llama"), _fq(fq_name), mesh,
            _sp(payload[key]["sptp"]), toks, mode, 16, 2, "dp")
    out["qwen_bias"] = _tp_decode_run(
        _cfg("tiny-qwen"), _fq("W4A4"), mesh,
        _sp(payload["qwen_w4a4"]["sptp"]), _t(payload["qwen_toks"]),
        "bf16", 16, 1, None)
    for mode in ("int4", "paged"):
        b = ContinuousBatcher(
            _cfg("tiny-llama"), _fq("W4A4KV4"),
            _sp(payload["llama_w4a4kv4"]["sptp"]), batch_slots=2,
            max_len=32, use_kernel=False, compute_dtype=torch.float32,
            cache_mode=mode, mesh=mesh, device="cpu")
        for p in payload["prompts"]:
            b.submit(p, max_new_tokens=6)
        out["batcher_" + mode] = b.run()
    out["kv_heads"] = int(b.cache["kp"][0].shape[1])
    return out


# ---------------------------------------------------------------------------
# pipeline parallelism (world 4: pp 4, and dp 2 x pp 2)
# ---------------------------------------------------------------------------


def _pp_serving(cfg, fq_cfg, sp, mesh, toks, cache_mode, max_len):
    """(pipelined logits, sequential logits) through prefill + 2 decode
    steps; the sequential run is engine._forward on its own cache."""
    from flatquant_torch.parallel.pipeline import pipeline_serving_forward
    from flatquant_torch.serving.engine import _forward, init_cache

    def run(step):
        cache = init_cache(cfg, toks.shape[0], max_len, dtype=torch.float32,
                           mode=cache_mode, device="cpu")
        logits = step(toks, cache, 0, "prefill")
        outs = [_np(logits)]
        pos = toks.shape[1]
        for _ in range(2):
            logits = step(_greedy(logits), cache, pos, "decode")
            outs.append(_np(logits))
            pos += 1
        return outs

    def pipe(tokens, cache, pos, phase):
        return pipeline_serving_forward(
            cfg, fq_cfg, sp, tokens, cache, pos, phase, mesh,
            n_microbatches=2, use_kernel=False, max_len=max_len,
            compute_dtype=torch.float32)[0]

    def seq(tokens, cache, pos, phase):
        return _forward(cfg, fq_cfg, sp, tokens.to(torch.long), cache, pos,
                        phase, False, max_len, torch.float32)

    return run(pipe), run(seq)


def _pp_dp_serving(cfg, fq_cfg, sp, mesh, toks, cache_mode, max_len):
    """pp 2 x dp 2 serving (dp_axis="dp") through prefill + 2 decode steps
    at per-slot positions, against the sequential engine: (pipelined
    logits, sequential logits, this rank's slot cache rows equal to the
    sequential cache's in the stage's layers). The slot caches are this
    rank's B / dp rows; the
    paged pool is whole, written through the rank's table rows."""
    from flatquant_torch.parallel.pipeline import pipeline_serving_forward
    from flatquant_torch.serving.engine import _forward, init_cache

    B, S = toks.shape
    dp = mesh.axis("dp")
    M, mb_l = 2, B // 4
    mine = [m * (B // M) + dp.index * mb_l + i for m in range(M)
            for i in range(mb_l)]
    local = cache_mode != "paged"
    caches = [init_cache(cfg, B // 2 if local and pipe else B, max_len,
                         dtype=torch.float32, mode=cache_mode, device="cpu")
              for pipe in (True, False)]
    outs = ([], [])
    for step in range(3):
        pos = 0 if step == 0 else torch.full((B,), S + step - 1,
                                             dtype=torch.int32)
        phase = "prefill" if step == 0 else "decode"
        tokens = toks if step == 0 else _greedy(torch.as_tensor(outs[1][-1]))
        outs[0].append(_np(pipeline_serving_forward(
            cfg, fq_cfg, sp, tokens, caches[0], pos, phase, mesh,
            n_microbatches=M, use_kernel=False, max_len=max_len,
            compute_dtype=torch.float32, dp_axis="dp")[0]))
        outs[1].append(_np(_forward(cfg, fq_cfg, sp, tokens.to(torch.long),
                                    caches[1], pos, phase, False, max_len,
                                    torch.float32)))
    same = True
    if local:  # the stage's own layers
        blk = mesh.axis("pp").block(cfg.num_layers)
        same = all(torch.equal(a, b[mine]) for k in caches[0]
                   for a, b in zip(caches[0][k][blk], caches[1][k][blk]))
    return outs[0], outs[1], same


def pp_cases(rank, world, payload):
    from flatquant_torch.models.llama import llama_forward
    from flatquant_torch.parallel.mesh import make_mesh
    from flatquant_torch.parallel.pipeline import (
        pipeline_llama_forward,
        pipeline_serving_forward,
    )
    from flatquant_torch.serving.batcher import ContinuousBatcher
    from flatquant_torch.serving.engine import init_cache
    from flatquant_torch.utils.convert import from_jax_fq, from_jax_params

    meshes = {4: make_mesh({"pp": 4}, device="cpu"),
              2: make_mesh({"dp": 2, "pp": 2}, device="cpu")}
    cfg = _cfg("tiny-llama", num_layers=4)
    fq_cfg = _fq("W4A4KV4")
    sp = _sp(payload["sp"])
    toks = _t(payload["toks"])
    out = {}
    for pp, mesh in meshes.items():
        for mode in ("bf16", "int4", "paged"):
            out[f"serve_pp{pp}_{mode}"] = _pp_serving(
                cfg, fq_cfg, sp, mesh, toks, mode, 16)
    for mode in ("bf16", "int4", "paged"):
        out[f"serve_dp2_pp2_{mode}"] = _pp_dp_serving(
            cfg, fq_cfg, sp, meshes[2], _t(payload["dp_toks"]), mode, 16)
        out[f"prefill4_dp2_pp2_{mode}"] = _np(pipeline_serving_forward(
            cfg, fq_cfg, sp, toks, init_cache(cfg, 4, 16, torch.float32,
                                              mode, device="cpu"),
            0, "prefill", meshes[2], use_kernel=False, max_len=16,
            compute_dtype=torch.float32, dp_axis="dp")[0])
    params = from_jax_params(payload["params"], "cpu")
    fq = from_jax_fq(payload["fq"], "cpu")
    for name, mesh, n_micro, kw, dp in (
            ("fp_pp2", meshes[2], 2, {}, None),
            ("fp_pp4", meshes[4], 3, {}, None),
            ("eval_pp2", meshes[2], 2, dict(fq=fq, fq_cfg=fq_cfg,
                                            mode="eval"), None),
            ("fp_dp2_pp2", meshes[2], 2, {}, "dp")):
        t = _t(payload["fwd_toks"][name])
        got = pipeline_llama_forward(cfg, params, t, mesh, n_micro,
                                     compute_dtype=torch.float32,
                                     dp_axis=dp, **kw)
        ref = llama_forward(cfg, params, t, compute_dtype=torch.float32,
                            **kw)
        out["fwd_" + name] = (_np(got), _np(ref))
    bsp = _sp(payload["batcher_sp"])
    for name, mode, kw, prompts, n_new in (
            ("bf16", "bf16", {}, payload["prompts"], (6, 4, 5)),
            ("int4", "int4", {}, payload["prompts"], (6, 4, 5)),
            ("paged", "paged", {}, payload["prompts"],
             (6, 4, 5)),
            ("chunked", "int4", dict(prefill_chunk=4),
             payload["chunk_prompts"], (5, 5))):
        res = []
        for pp_mesh in (None, meshes[2]):
            b = ContinuousBatcher(cfg, fq_cfg, bsp, batch_slots=2,
                                  max_len=32, cache_mode=mode,
                                  pp_mesh=pp_mesh, pp_microbatches=2,
                                  device="cpu", **kw)
            rids = [b.submit(p, n) for p, n in zip(prompts, n_new)]
            got = b.run(max_steps=300)
            res.append([got[r] for r in rids])
        out["batcher_" + name] = res
    out["stage_layers"] = len(b.sp["layers"])
    return out


# ---------------------------------------------------------------------------
# sequence parallelism (world 4: sp 4, and dp 2 x sp 2)
# ---------------------------------------------------------------------------


def sp_cases(rank, world, payload):
    from flatquant_torch.parallel.distributed import all_gather
    from flatquant_torch.parallel.mesh import make_mesh
    from flatquant_torch.parallel.sequence import (
        ring_attention,
        sp_gather_cache_for_decode,
        sp_llama_forward,
        sp_serving_prefill,
    )
    from flatquant_torch.serving.engine import serving_decode_step
    from flatquant_torch.utils.convert import from_jax_fq, from_jax_params

    sp4 = make_mesh({"sp": 4}, device="cpu")
    dpsp = make_mesh({"dp": 2, "sp": 2}, device="cpu")
    out = {"sp4_index": sp4.axis("sp").index,
           "dpsp_index": (dpsp.axis("dp").index, dpsp.axis("sp").index)}
    ax = sp4.axis("sp")
    q, k, v = (_t(payload["qkv"][n])[:, ax.block(64)] for n in "qkv")
    out["ring"] = _np(ring_attention(q, k, v, 0.25, ax))

    cfg2 = _cfg("tiny-llama", num_layers=2)
    params = from_jax_params(payload["params"], "cpu")
    fq = from_jax_fq(payload["fq"], "cpu")
    fq_cfg = _fq("W4A4KV4")
    for mode in ("fp", "eval"):
        kw = dict(fq=fq, fq_cfg=fq_cfg, mode="eval") if mode == "eval" else {}
        out["fwd_" + mode] = _np(sp_llama_forward(
            cfg2, params, _t(payload["fwd_toks"]), dpsp,
            compute_dtype=torch.float32, dp_axis="dp", **kw))

    cfg = _cfg("tiny-llama")
    sp = _sp(payload["sp"])
    logits, cache = sp_serving_prefill(cfg, fq_cfg, sp,
                                       _t(payload["toks"]), sp4,
                                       compute_dtype=torch.float32)
    out["prefill_logits"] = _np(logits)
    gathered = sp_gather_cache_for_decode(cfg, cache, sp4, 32, mode="bf16")
    out["prefill_cache"] = {k: np.stack([_np(t) for t in v])
                            for k, v in gathered.items()}

    # the handoff: sharpened head, prefill, gather, greedy decode
    spx = _sp(payload["sp_sharp"])
    toks = _t(payload["handoff_toks"])
    S, max_len = toks.shape[1], 48
    logits, cache = sp_serving_prefill(cfg, fq_cfg, spx, toks, sp4,
                                       compute_dtype=torch.float32)
    first = all_gather(logits, 1, ax)[:, -1]
    for mode in ("bf16", "int4"):
        c = sp_gather_cache_for_decode(cfg, cache, sp4, max_len, mode=mode)
        last = first
        outs = [_np(last.argmax(-1))]
        tok = _greedy(last)
        for i in range(4):
            last, c = serving_decode_step(
                cfg, fq_cfg, spx, tok, c, S + i, use_kernel=False,
                max_len=max_len, compute_dtype=torch.float32, device="cpu")
            outs.append(_np(last.argmax(-1)))
            tok = _greedy(last)
        out["handoff_" + mode] = np.stack(outs, 1)
    return out


# ---------------------------------------------------------------------------
# DeepSeek under expert parallelism (world 2: ep 2)
# ---------------------------------------------------------------------------


def ep_cases(rank, world, payload):
    from flatquant_torch.models import deepseek as tds
    from flatquant_torch.parallel.mesh import (
        make_mesh,
        shard_ds_serving_params,
    )
    from flatquant_torch.serving.batcher import ContinuousBatcher
    from flatquant_torch.utils.convert import (
        from_jax_ds_fq,
        from_jax_ds_serving_params,
    )

    mesh = make_mesh({"ep": 2}, device="cpu")
    spfq = {"params": from_jax_ds_serving_params(payload["sp"], "cpu"),
            "fq": from_jax_ds_fq(payload["fq"], "cpu")}
    local = shard_ds_serving_params(spfq, mesh)
    out = {"experts": int(local["params"]["moe_layers"][0]["e_w1"]["wp"]
                          .shape[0])}
    for name, kw in (("whole", {}), ("bucket", dict(prefill_bucket=8)),
                     ("gather", {})):
        b = ContinuousBatcher(tds.TINY_DEEPSEEK if name != "gather" else
                              dataclasses.replace(tds.TINY_DEEPSEEK,
                                                  moe_impl="gather"),
                              _fq("W4A4"), local, batch_slots=2, max_len=32,
                              forward_fn=tds.ds_batch_forward,
                              init_cache_fn=tds.ds_init_batch_cache,
                              compute_dtype=torch.float32, device="cpu",
                              **kw)
        rids = [b.submit(p, n) for p, n in zip(payload["prompts"],
                                                payload["n_new"])]
        got = b.run(max_steps=200)
        out[name] = [got[r] for r in rids]
    return out


# ---------------------------------------------------------------------------
# the launch glue
# ---------------------------------------------------------------------------


def raise_on_rank_one(rank, world):
    if rank == 1:
        raise ValueError("rank one fails on purpose")
    return rank


def sleep_past_the_limit(rank, world, seconds):
    import time

    time.sleep(seconds if rank == 0 else 0)
    return rank
