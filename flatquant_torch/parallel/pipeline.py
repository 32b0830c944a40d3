"""Pipeline parallelism: GPipe stages of contiguous layer blocks over a "pp"
mesh axis (port of flatquant_tpu/parallel/pipeline.py).

Stage r (its index on the pp axis) owns layers [r L/pp, (r + 1) L/pp)
and, in serving, those layers' cache or pool shard. Microbatch m enters
stage 0, runs the stage's layers, and its hidden state goes to stage r + 1
by send / recv; stage r runs microbatch m at tick m + r, the GPipe
schedule, bubble fraction (P - 1) / (M + P - 1).

JAX runs one SPMD program in which every rank computes every tick, bubble
ticks on don't-care data whose cache writes a select discards. The port
has per-rank control flow: a stage runs only its own microbatches, so a
bubble tick computes nothing and writes no cache. The last stage collects
the microbatches and broadcasts the result over the axis. The schedule
changes which rank runs a layer, never the math of a row, so outputs equal
the sequential engine's.

Layer params and caches are per-layer lists (the port's layout); a
function given all L layers takes its stage's block (views: cache writes
land in the caller's tensors), and `stage_serving_params` cuts a stage's
params out (marked "pp_local", taken as they are) so the full model can be
freed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from flatquant_torch.parallel.distributed import (
    all_gather,
    broadcast,
    recv,
    send,
)
from flatquant_torch.parallel.mesh import Mesh


def _stage(items: list, n_layers: int, axis):
    """The stage's block of a per-layer list holding all n_layers layers,
    or the list itself when it holds the stage's block already."""
    if n_layers % axis.size:
        raise ValueError(f"n_layers {n_layers} % pp {axis.size} != 0")
    per = n_layers // axis.size
    if len(items) == n_layers:
        return items[axis.block(n_layers)]
    if len(items) == per:
        return items
    raise ValueError(f"{len(items)} layers: neither all {n_layers} nor one "
                     f"stage's {per}")


def stage_serving_params(sp: dict, mesh: Mesh, pp_axis: str = "pp") -> dict:
    """This stage's serving params: its block of layers, the embedding,
    final norm and head replicated, marked "pp_local"."""
    if "pp_local" in sp:
        return sp
    axis = mesh.axis(pp_axis)
    out = dict(sp)
    out["layers"] = list(_stage(sp["layers"], len(sp["layers"]), axis))
    out["pp_local"] = axis.size
    return out


def stage_config(cfg, mesh: Mesh, pp_axis: str = "pp"):
    """cfg with num_layers cut to one stage's block (its cache's size)."""
    pp = mesh.shape[pp_axis]
    if cfg.num_layers % pp:
        raise ValueError(f"num_layers {cfg.num_layers} % pp {pp} != 0")
    return dataclasses.replace(cfg, num_layers=cfg.num_layers // pp)


def _gpipe(axis, n_micro: int, inject, stage_fn, shape, dtype, device):
    """Run the GPipe schedule on this stage: for each microbatch m, take
    inject(m) (stage 0) or receive from the previous stage, run
    stage_fn(h, m), send on (or keep, on the last stage). Returns the last
    stage's outputs stacked [M, ...] on every rank of the axis."""
    r, P = axis.index, axis.size
    outs, pending = [], []
    for m in range(n_micro):
        h = inject(m) if r == 0 else recv(shape, dtype, r - 1, axis, device)
        h = stage_fn(h, m)
        if r < P - 1:
            pending.append(send(h, r + 1, axis))
        else:
            outs.append(h)
    for p in pending:
        p.wait()
    if r == P - 1:
        y = torch.stack(outs)
    else:
        y = torch.empty((n_micro,) + tuple(shape), dtype=dtype,
                        device=device)
    return broadcast(y, P - 1, axis)


def pipeline_apply(layer_fn, mesh: Mesh, stacked_layers: list, x_mb,
                   *broadcast_args, dp_axis: Optional[str] = None,
                   pp_axis: str = "pp"):
    """Run x_mb [M, mb, ...] through the layers pipelined over `pp_axis`.

    layer_fn(layer_params, x, *broadcast_args) -> next hidden state;
    stacked_layers: the list of all L layers' params (each stage runs its
    block). x_mb: the same global input on every
    rank; with dp_axis each dp rank runs its block of the mb rows and the
    results are gathered. Returns [M, mb, ...] on every rank, equal to
    the sequential loop."""
    axis = mesh.axis(pp_axis)
    layers = _stage(stacked_layers, len(stacked_layers), axis)
    dp = mesh.axis(dp_axis) if dp_axis is not None else None
    if dp is not None:
        x_mb = x_mb[:, dp.block(x_mb.shape[1])]

    def stage_fn(h, m):
        for lp in layers:
            h = layer_fn(lp, h, *broadcast_args)
        return h

    y = _gpipe(axis, x_mb.shape[0], lambda m: x_mb[m], stage_fn,
               x_mb.shape[1:], x_mb.dtype, x_mb.device)
    return y if dp is None else all_gather(y, 1, dp)


def pipeline_serving_forward(cfg, fq_cfg, sp, tokens, cache, pos, phase,
                             mesh: Mesh, n_microbatches: int = 2,
                             use_kernel: bool = False, max_len: int = 2048,
                             compute_dtype=torch.bfloat16,
                             dp_axis: Optional[str] = None, last_idx=None,
                             pp_axis: str = "pp"):
    """The real-quant serving forward (packed weights over the int4, bf16
    or paged cache) with the layer loop pipelined over `pp_axis`.

    sp: build_serving_params' output (all layers) or stage_serving_params'
    stage; cache: init_cache's for all layers or for one stage
    (stage_config), updated in place: a stage writes only its own layers'
    caches, each microbatch only its slots' rows (the paged pool through
    its slots' table rows). tokens [B, S] with B % n_microbatches == 0, the
    same on every rank; pos: an int or a per-slot [B] tensor; last_idx:
    the per-slot last real token. Returns (float32 last-token logits
    [B, V] on every rank, cache), equal to the sequential engine's
    (engine._forward) on the same inputs.

    dp_axis: each dp rank runs its block of every microbatch's rows
    (pipeline_apply's split; the microbatch size must divide over dp),
    and the last hidden states are gathered over dp before the head. The
    slot caches and the block table may hold the whole batch (the rank
    writes only its rows) or this rank's rows, microbatch by microbatch
    (B / dp slots); the paged pool is never cut over dp: each rank writes
    it only through its own slots' table rows. tokens, pos and last_idx
    stay whole."""
    from flatquant_torch.models.llama import rms_norm, rope_tables
    from flatquant_torch.serving.engine import (
        serving_layer,
        serving_layer_int4cache,
    )

    axis = mesh.axis(pp_axis)
    dp = mesh.axis(dp_axis) if dp_axis is not None else None
    n_dp, i_dp = (dp.size, dp.index) if dp is not None else (1, 0)
    dev = mesh.device
    tokens = torch.as_tensor(tokens, device=dev).to(torch.long)
    B, S = tokens.shape
    M = n_microbatches
    if B % M:
        raise ValueError(f"batch {B} % microbatches {M} != 0")
    mb = B // M
    if mb % n_dp:
        raise ValueError(f"microbatch {mb} % dp {n_dp} != 0")
    mb_l = mb // n_dp
    # this rank's rows of the batch, microbatch by microbatch
    mine = torch.cat([torch.arange(m * mb + i_dp * mb_l,
                                   m * mb + (i_dp + 1) * mb_l, device=dev)
                      for m in range(M)])
    L = cfg.num_layers
    layers = _stage(sp["layers"], L, axis)
    int4 = "kp" in cache
    keys = ("kp", "kparam", "vp", "vparam") if int4 else ("k", "v")
    state = [_stage(cache[k], L, axis) for k in keys]
    tbl = cache.get("tbl")
    per_slot = torch.is_tensor(pos) and pos.ndim == 1
    if per_slot:
        pos = pos.to(dev)[mine]
    if int4 and (fq_cfg.k_cfg.bits != 4 or fq_cfg.v_cfg.bits != 4):
        raise ValueError("the packed cache holds int4 nibbles; kv8/kv16 "
                         "configs use the bf16 cache mode")
    cos, sin = rope_tables(cfg, torch.arange(max_len, device=dev))
    H = sp["embed"].shape[1]

    def slots(t, m):
        """Microbatch m's rows (this rank's) of a per-slot tensor that
        holds the whole batch or this rank's B / dp rows."""
        if t.shape[0] == B:
            return t[m * mb + i_dp * mb_l:m * mb + (i_dp + 1) * mb_l]
        if t.shape[0] == B // n_dp:
            return t[m * mb_l:(m + 1) * mb_l]
        raise ValueError(f"{t.shape[0]} slots: neither the batch's {B} nor "
                         f"a dp rank's {B // n_dp}")

    def stage_fn(h, m):
        p = pos[m * mb_l:(m + 1) * mb_l] if per_slot else pos
        for i, sl in enumerate(layers):
            if tbl is not None:
                # the pool is shared by every slot: writes go through this
                # microbatch's table rows
                h = serving_layer_int4cache(
                    cfg, fq_cfg, sl, h, cos, sin, *(st[i] for st in state),
                    p, phase, use_kernel, compute_dtype, tbl=slots(tbl, m))
            elif int4:
                h = serving_layer_int4cache(
                    cfg, fq_cfg, sl, h, cos, sin,
                    *(slots(st[i], m) for st in state), p, phase,
                    use_kernel, compute_dtype)
            else:
                h = serving_layer(cfg, fq_cfg, sl, h, cos, sin,
                                  slots(state[0][i], m),
                                  slots(state[1][i], m), p, phase,
                                  use_kernel, compute_dtype)
        return h

    def inject(m):
        return sp["embed"][tokens[mine[m * mb_l:(m + 1) * mb_l]]].to(
            compute_dtype)

    y = _gpipe(axis, M, inject, stage_fn, (mb_l, S, H), compute_dtype, dev)
    x = rms_norm(y.reshape(M * mb_l, S, H), sp["final_norm_w"], cfg.rms_eps)
    last = (x[:, -1] if last_idx is None
            else x[torch.arange(M * mb_l, device=dev),
                   torch.as_tensor(last_idx, device=dev)[mine]])
    if dp is not None:  # the head runs on the whole batch, as JAX's
        last = all_gather(last.reshape(M, mb_l, -1), 1, dp).reshape(B, -1)
    logits = (last @ sp["lm_head"].T.to(x.dtype)).to(torch.float32)
    return logits, cache


def pipeline_forward_fn(mesh: Mesh, n_microbatches: int = 2,
                        pp_axis: str = "pp"):
    """A forward with engine._forward's signature (the batcher's hook)
    through pipeline_serving_forward: decode pipelines its slots over
    n_microbatches, a single-slot prefill or chunk runs as one microbatch
    (JAX's batcher programs)."""
    def forward(cfg, fq_cfg, sp, tokens, cache, pos, phase, use_kernel,
                max_len, compute_dtype=torch.bfloat16, last_idx=None):
        M = n_microbatches if phase == "decode" else 1
        logits, _ = pipeline_serving_forward(
            cfg, fq_cfg, sp, tokens, cache, pos, phase, mesh, M, use_kernel,
            max_len, compute_dtype, last_idx=last_idx, pp_axis=pp_axis)
        return logits

    return forward


def pipeline_llama_forward(cfg, params, tokens, mesh: Mesh,
                           n_microbatches: int = 4, fq=None, fq_cfg=None,
                           mode: str = "fp", compute_dtype=torch.bfloat16,
                           dp_axis: Optional[str] = None,
                           pp_axis: str = "pp"):
    """models.llama.llama_forward with the layer loop pipelined over
    `pp_axis`: tokens [B, S] (the same on every rank), B % n_microbatches
    == 0; the embedding and head run on every rank. Returns float32
    logits [B, S, V] on every rank, equal to llama_forward's."""
    from flatquant_torch.models.llama import (
        causal_mask,
        llama_layer,
        rms_norm,
        rope_tables,
    )

    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev).to(torch.long)
    B, S = tokens.shape
    M = n_microbatches
    if B % M:
        raise ValueError(f"batch {B} % microbatches {M} != 0")
    x = params["embed"][tokens].to(compute_dtype)
    cos, sin = rope_tables(cfg, torch.arange(S, device=dev))
    mask = causal_mask(S, dev)
    fqs = fq if fq is not None else [None] * len(params["layers"])
    stacked = list(zip(params["layers"], fqs))

    def layer_fn(lp_lfq, h):
        lp, lfq = lp_lfq
        return llama_layer(cfg, fq_cfg, mode if fq is not None else "fp",
                           lp, lfq, h, cos, sin, mask)

    y = pipeline_apply(layer_fn, mesh, stacked,
                       x.reshape((M, B // M) + x.shape[1:]),
                       dp_axis=dp_axis, pp_axis=pp_axis)
    x = y.reshape(x.shape)
    x = rms_norm(x, params["final_norm_w"], cfg.rms_eps)
    head = params.get("lm_head", params["embed"])
    return (x @ head.T.to(x.dtype)).to(torch.float32)
