"""Rank bodies of the port's calibration-under-a-mesh tests
(tests/test_torch_parallel_calib.py, tests/test_torch_dist_checkpoint.py).

Each function runs in a spawned rank process (flatquant_torch.parallel.launch
run_ranks) on the CPU over gloo and imports torch and flatquant_torch only
(no JAX: the rank must start fast). Inputs are numpy trees that the test
made from JAX's models; results go back as numpy for the test to hold
against JAX's single-device runs and the port's own.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else x


def _leaves(tree):
    from flatquant_torch.utils.tree import tree_leaves

    return [_np(t) for t in tree_leaves(tree)]


def _llama(payload):
    from flatquant_torch.models.config import get_config
    from flatquant_torch.utils.convert import from_jax_fq, from_jax_params

    return (get_config("tiny-llama"),
            from_jax_params(payload["params"], "cpu"),
            {tp: from_jax_fq(payload["fq"][tp], "cpu") for tp in (1, 2)})


def _fq_cfg(name, **kw):
    from flatquant_torch.quantize import spec

    return dataclasses.replace(getattr(spec, name), **kw)


def _ds(payload):
    from flatquant_torch.models import deepseek as ds
    from flatquant_torch.utils.convert import (
        from_jax_ds_fq,
        from_jax_ds_serving_params,
    )

    return (ds.DeepSeekConfig(**payload["cfg"]),
            from_jax_ds_serving_params(payload["params"], "cpu"),
            from_jax_ds_fq(payload["fq"], "cpu"))


# ---------------------------------------------------------------------------
# the autograd Functions of parallel/tp_autograd.py (world 4: tp 4)
# ---------------------------------------------------------------------------


def function_losses(name, x, c, tp):
    """(this rank's loss, the leaf whose gradient is compared) for the
    sharded form of function `name` (tests/test_torch_parallel_calib.py
    `_unsharded` is the single-process form). The summed losses of all
    ranks (a partial-gradient use) or the replicated loss (a whole-
    gradient use) equal the unsharded loss."""
    from flatquant_torch.parallel import tp_autograd as ta

    blk = tp.block(x.shape[-1])
    if name == "copy_to":  # column-parallel: x replicated, w by rows
        x = x.clone().requires_grad_(True)
        y = ta.copy_to(x, tp) @ c[tp.block(c.shape[0])].T
        return y.sum(), x
    if name == "reduce_from":  # row-parallel: x by columns, w too
        xl = x[:, blk].clone().requires_grad_(True)
        y = ta.reduce_from(xl @ c[:, blk].T, tp)
        return (y * y).sum(), xl
    if name == "gather_from":
        xl = x[:, blk].clone().requires_grad_(True)
        z = ta.gather_from(xl, -1, tp)
        return (z * z * c[: z.shape[0], : z.shape[1]]).sum(), xl
    if name == "scatter_to":
        x = x.clone().requires_grad_(True)
        z = ta.scatter_to(x, -1, tp)
        return (z * z * c[: z.shape[0], blk]).sum(), x
    fn = ta.shard_max if name == "shard_max" else ta.shard_min
    xl = x[:, blk].clone().requires_grad_(True)
    m = fn(xl, -1, tp)
    # every rank uses the extremum on its own block: partial gradients
    return (m * c[: m.shape[0], tp.index: tp.index + 1]).sum(), xl


def _function_cases(payload):
    from flatquant_torch.parallel.mesh import make_mesh

    tp = make_mesh({"tp": 4}, device="cpu").axis("tp")
    out = {}
    for name in ("copy_to", "reduce_from", "gather_from", "scatter_to",
                 "shard_max", "shard_min"):
        x = torch.as_tensor(payload["fn_x"])
        c = torch.as_tensor(payload["fn_c"])
        loss, leaf = function_losses(name, x, c, tp)
        loss.backward()
        out[name] = _np(leaf.grad)
    out["row_quant"] = row_quant(torch.as_tensor(payload["rq_w"]), tp)
    return out


def row_quant(w, tp):
    """core/quant.py's quantizers on this rank's block of the in features
    of w [out, in] with parallel/tp_autograd.py row_reducer(tp) (tp None:
    the whole rows in one process): {name: (scale, zero)} of the weight
    scales, with and without the MSE shrink search, symmetric and not,
    and of the per-token activation scales of w read as tokens."""
    from flatquant_torch.core.quant import (
        ActQuantCfg,
        WeightQuantCfg,
        act_scale_zero,
        weight_find_params,
    )
    from flatquant_torch.parallel.tp_autograd import row_reducer

    if tp is not None:
        w = w[:, tp.block(w.shape[1])]
    red = row_reducer(tp)
    out = {}
    for sym in (True, False):
        for mse in (False, True):
            cfg = WeightQuantCfg(bits=4, sym=sym, mse=mse)
            out[f"w_sym{sym}_mse{mse}"] = tuple(
                _np(t) for t in weight_find_params(w, cfg, row_reduce=red))
        out[f"a_sym{sym}"] = tuple(_np(t) for t in act_scale_zero(
            w, ActQuantCfg(bits=4, sym=sym), row_reduce=red))
    return out


# ---------------------------------------------------------------------------
# calibration under a mesh (world 4)
# ---------------------------------------------------------------------------


def _llama_step(cfg, fq_cfg, params, fq, x, mesh, total_steps):
    """One calibration step of layer 0 (the fp teacher, calib student,
    normalised MSE, backward, AdamW) under `mesh`: the rank's dp rows of
    x and its tp blocks of the layer."""
    from flatquant_torch.calib import trainer as tt
    from flatquant_torch.models.llama import (
        causal_mask,
        llama_layer,
        rope_tables,
    )
    from flatquant_torch.parallel.mesh import (
        llama_param_specs,
        mesh_axis,
        shard_tree,
    )

    tp, dp = mesh_axis(mesh, "tp"), mesh_axis(mesh, "dp")
    lp = shard_tree(params, llama_param_specs(cfg, params, tp_size=(
        tp.size if tp else None)), mesh)["layers"][0]
    S = x.shape[1]
    cos, sin = rope_tables(cfg, torch.arange(S))
    mask = causal_mask(S, "cpu")
    x = x[dp.block(x.shape[0])] if dp else x
    with torch.no_grad():
        teacher = llama_layer(cfg, None, "fp", lp, None, x, cos, sin, mask,
                              tp_axis=tp)
    state = tt._master(fq[0])
    opt = tt.make_optimizer(fq_cfg, state, tt.build_labels(state),
                            total_steps)
    mse = tt.calib_step(
        opt, lambda f, lpp, xx: llama_layer(cfg, fq_cfg, "calib", lpp, f, xx,
                                            cos, sin, mask, tp_axis=tp),
        state, lp, x, teacher, dp)
    return mse, state


def calib_cases(rank, world, payload):
    """Every rank case of tests/test_torch_parallel_calib.py in one
    spawn of four ranks."""
    from flatquant_torch.calib.trainer import calibrate
    from flatquant_torch.models import deepseek as ds
    from flatquant_torch.models.llama import llama_forward
    from flatquant_torch.parallel.mesh import (
        deepseek_param_specs,
        llama_param_specs,
        make_mesh,
        mesh_axis,
        shard_tree,
    )

    out = {"functions": _function_cases(payload)}
    cfg, params, fqs = _llama(payload["llama"])
    mesh = make_mesh({"dp": 2, "tp": 2}, device="cpu")
    tp, dp = mesh_axis(mesh, "tp"), mesh_axis(mesh, "dp")
    w4a4kv4 = _fq_cfg("W4A4KV4")
    toks = payload["llama"]["toks"]
    for tps, vocab in ((1, False), (2, True)):
        lp = shard_tree(params, llama_param_specs(cfg, params,
                                                  shard_vocab=vocab), mesh)
        out[f"forward_tp{tps}"] = _np(llama_forward(
            cfg, lp, toks, fq=fqs[tps], fq_cfg=w4a4kv4, mode="calib",
            compute_dtype=torch.float32, tp_axis=tp, dp_axis=dp))
        mse, state = _llama_step(cfg, w4a4kv4, params, fqs[tps],
                                 torch.as_tensor(payload["llama"]["step_x"]),
                                 mesh, total_steps=10)
        out[f"step_tp{tps}"] = (mse, _leaves(state))

    # a 2-layer calibrate, float32, under the mesh
    rec = _fq_cfg("W4A4KV4", **payload["recipe"])
    lp = shard_tree(params, llama_param_specs(cfg, params, tp_size=2), mesh)
    hist = []
    st = calibrate(cfg, rec, lp, fqs[1], payload["llama"]["calib_toks"],
                   log=lambda m: None, history=hist, mesh=mesh)
    out["calibrate"] = ([h["step_mse"] for h in hist], _leaves(st))

    # DeepSeek under {ep 2, tp 2}
    dcfg, dparams, dfq = _ds(payload["ds"])
    emesh = make_mesh({"ep": 2, "tp": 2}, device="cpu")
    dlp = shard_tree(dparams, deepseek_param_specs(dcfg, dparams), emesh)
    w4a4 = _fq_cfg("W4A4")
    out["ds_forward"] = _np(ds.deepseek_forward(
        dcfg, dlp, payload["ds"]["toks"], fq=dfq, fq_cfg=w4a4, mode="calib",
        compute_dtype=torch.float32, device="cpu", mesh=emesh))
    hist = []
    drec = _fq_cfg("W4A4", **payload["ds_recipe"])
    st = ds.calibrate_deepseek(dcfg, drec, dlp, dfq[0], dfq[1],
                               payload["ds"]["toks"][:drec.nsamples],
                               log=lambda m: None, history=hist, mesh=emesh)
    out["ds_calibrate"] = ([h["step_mse"] for h in hist], _leaves(st))
    out["experts"] = int(dlp["moe_layers"][0]["e_w1"].shape[0])
    out["ds_generate"] = ds_generate_cases(payload["ds"], {
        "dp2_tp2": mesh, "ep2_tp2": emesh})
    out["gptq"] = gptq_cases(payload["gptq"], mesh)
    out["attn_fn"] = attn_fn_case(cfg, params, toks, mesh)
    return out


# ---------------------------------------------------------------------------
# the configurations under a mesh that JAX's GSPMD runs (world 4)
# ---------------------------------------------------------------------------


def ds_generate_cases(d, meshes, n_new=4, max_len=16):
    """DeepSeek generation on each mesh's blocks (deepseek_param_specs),
    TINY_DEEPSEEK's head sharpened 6x against greedy ties: {mesh name:
    ({mode: deepseek_generate's tokens} in "fp" and "calib", the float32
    last-token logits of "calib" _ds_step's prefill and two greedy decode
    steps)}."""
    from flatquant_torch.models import deepseek as ds
    from flatquant_torch.parallel.mesh import (
        deepseek_param_specs,
        mesh_axis,
        shard_tree,
    )

    cfg, params, fq = _ds(d)
    params = dict(params, head=params["head"] * 6.0)
    w4a4 = _fq_cfg("W4A4")
    prompt = torch.as_tensor(d["gen_prompt"]).long()
    out = {}
    for name, mesh in meshes.items():
        lp = shard_tree(params, deepseek_param_specs(cfg, params), mesh)
        toks = {mode: ds.deepseek_generate(
            cfg, lp, fq if mode == "calib" else None, w4a4, prompt,
            max_new_tokens=n_new, max_len=max_len, mode=mode,
            compute_dtype=torch.float32, device="cpu", mesh=mesh)
            for mode in ("fp", "calib")}
        dp = mesh_axis(mesh, "dp")
        cache = ds.init_ds_cache(cfg, prompt.shape[0] // (dp.size if dp
                                                          else 1),
                                 max_len, dtype=torch.float32, device="cpu")
        logits, tok, pos = [], prompt, 0
        for _ in range(3):
            lg, cache = ds._ds_step(cfg, w4a4, "calib", lp, fq, tok, cache,
                                    pos, max_len, torch.float32, mesh=mesh)
            logits.append(_np(lg))
            pos += tok.shape[1]
            tok = lg.argmax(-1, keepdim=True)
        out[name] = (toks, logits)
    return out


def gptq_cases(g, mesh):
    """gptq_model under the mesh's tp on tiny-llama's baked params (this
    rank's blocks by llama_param_specs), for a baked state as wide as the
    dim (tp = 1) and a shard-aligned one (tp = 2): {state tp: this rank's
    blocks of the quantized weights, layer by layer}."""
    from flatquant_torch.calib.gptq import gptq_model
    from flatquant_torch.models.config import get_config
    from flatquant_torch.parallel.mesh import llama_param_specs, shard_tree
    from flatquant_torch.utils.convert import from_jax_fq, from_jax_params

    cfg = get_config("tiny-llama")
    out = {}
    for tps in (1, 2):
        bp = from_jax_params(g["bp"][tps], "cpu")
        lp = shard_tree(bp, llama_param_specs(cfg, bp, tp_size=2), mesh)
        got = gptq_model(cfg, _fq_cfg("W4A4KV4"), lp,
                         from_jax_fq(g["bfq"][tps], "cpu"), g["train"],
                         log=lambda m: None, mesh=mesh)
        out[tps] = [{k: _np(v) for k, v in layer.items()}
                    for layer in got["layers"]]
    return out


def attn_fn_case(cfg, params, toks, mesh):
    """llama_layer under tp with attn_fn set to the eager core on the
    rank's heads, against attn_fn=None: (bit-equal, the heads attn_fn
    received)."""
    from flatquant_torch.models.llama import (
        _attention_core,
        causal_mask,
        llama_layer,
        rope_tables,
    )
    from flatquant_torch.parallel.mesh import (
        llama_param_specs,
        mesh_axis,
        shard_tree,
    )

    tp = mesh_axis(mesh, "tp")
    lp = shard_tree(params, llama_param_specs(cfg, params, tp_size=2),
                    mesh)["layers"][0]
    S = toks.shape[1]
    x = params["embed"][torch.as_tensor(toks).long()]
    cos, sin = rope_tables(cfg, torch.arange(S))
    mask = causal_mask(S, "cpu")
    heads = []

    def core(q, k, v):
        heads.append((q.shape[2], k.shape[2]))
        return _attention_core(dataclasses.replace(
            cfg, num_heads=q.shape[2], num_kv_heads=k.shape[2]), q, k, v,
            mask)

    with torch.no_grad():
        want = llama_layer(cfg, None, "fp", lp, None, x, cos, sin, mask,
                           tp_axis=tp)
        got = llama_layer(cfg, None, "fp", lp, None, x, cos, sin, mask,
                          attn_fn=core, tp_axis=tp)
    return bool(torch.equal(got, want)), heads


# ---------------------------------------------------------------------------
# sharded checkpoints (world 4)
# ---------------------------------------------------------------------------


def checkpoint_cases(rank, world, payload, path):
    """Write tiny-llama's params (and a replicated FQ state) sharded at
    {dp 2, tp 2}; read them back at {tp 4}. Returns, per leaf, whether
    the block read equals the block cut from the whole tree."""
    from flatquant_torch.parallel.mesh import (
        llama_param_specs,
        make_mesh,
        replicated_specs,
        shard_tree,
    )
    from flatquant_torch.utils.dist_checkpoint import (
        load_sharded,
        save_sharded,
    )
    from flatquant_torch.utils.tree import tree_leaves

    cfg, params, fqs = _llama(payload)
    tree = {"params": params, "fq": fqs[1]}
    m22 = make_mesh({"dp": 2, "tp": 2}, device="cpu")
    specs = {"params": llama_param_specs(cfg, params, shard_vocab=True),
             "fq": replicated_specs(fqs[1])}
    save_sharded(path, shard_tree(tree, specs, m22), mesh=m22, specs=specs)
    m4 = make_mesh({"tp": 4}, device="cpu")
    specs4 = {"params": llama_param_specs(cfg, params, tp_size=4),
              "fq": replicated_specs(fqs[1])}
    got = load_sharded(path, tree, mesh=m4, specs=specs4)
    want = shard_tree(tree, specs4, m4)
    return dict(
        equal=[bool(torch.equal(a, b)) and a.dtype == b.dtype
               for a, b in zip(tree_leaves(got), tree_leaves(want))],
        shapes=[tuple(a.shape) for a in tree_leaves(got)])
