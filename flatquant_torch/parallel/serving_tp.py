"""Tensor-parallel real-quant serving: the packed int4 engine on each
rank's shard (port of flatquant_tpu/parallel/serving_tp.py).

JAX runs the unmodified engine under shard_map on a local config (heads,
kv heads and intermediate divided by tp); the port runs it in one process
per rank, on the same local config:

  - build_serving_params(tp=tp) lays the packed weights out per shard
    (merged projections interleave [q_s; k_s; v_s] / [up_s; gate_s] row
    blocks; o / down pack their nibbles per input-channel block), so
    `shard_serving_params` hands every rank a whole local model by
    cutting each leaf along one dim (`serving_param_specs`);
  - the collectives are the engine's: one all-reduce SUM after o and one
    after down, a [T, 2] all-reduce MAX of the row-parallel inputs'
    per-token extrema (single-device codes), and the vocab-parallel head,
    whose [B, V/tp] blocks `tp_serving_programs` all-gathers;
  - the KV cache splits kv heads over tp and, with a dp axis, the batch
    over dp; the paged pool splits kv heads only (its blocks are shared
    by every slot) and its table is replicated.

Every rank calls the programs with the same global host inputs (tokens
[B, S], positions); each takes its dp block of the batch, and every rank
gets the full logits [B, V] back.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from flatquant_torch.models.config import LlamaConfig
from flatquant_torch.parallel.distributed import all_gather
from flatquant_torch.parallel.mesh import Mesh, shard_tree
from flatquant_torch.quantize.spec import FQConfig
from flatquant_torch.serving.engine import _forward, init_cache

_COL = {"q", "k", "v", "up", "gate", "qkv", "upgate"}
_ROW = {"o", "down"}
_BIAS = {"bqkv", "bq", "bk", "bv"}


def tp_local_config(cfg: LlamaConfig, tp: int) -> LlamaConfig:
    """The per-shard view of the model: heads, kv heads and intermediate
    divided by tp (the head-granular rule: tp must divide num_kv_heads);
    hidden and vocab unchanged."""
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise ValueError(f"tp={tp} must divide num_heads {cfg.num_heads} "
                         f"and num_kv_heads {cfg.num_kv_heads}")
    if cfg.intermediate_size % tp:
        raise ValueError(f"tp={tp} must divide intermediate_size "
                         f"{cfg.intermediate_size}")
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // tp,
        num_kv_heads=cfg.num_kv_heads // tp,
        intermediate_size=cfg.intermediate_size // tp)


def serving_param_specs(sp: dict, tp_axis: str = "tp") -> dict:
    """The spec of each build_serving_params(tp=...) leaf ((tp_axis, dim),
    parallel/mesh.py's form, or None: replicated), JAX's PartitionSpec
    tree on the port's per-layer layout: column-parallel codes and scales
    on dim 0 (out), row-parallel codes on dim 1 (the packed in), their
    scales (full out) replicated, biases on dim 0, lm_head on dim 0
    (vocab-parallel); norms, transform factors (the o / down ones already
    shard-aligned) and clips replicated."""
    def leaf(v, dim):
        if isinstance(v, (list, tuple)):
            return type(v)(leaf(u, None) for u in v)
        return None if dim is None else (tp_axis, dim)

    def layer(sl):
        out = {}
        for name, v in sl.items():
            if name in _COL:
                out[name] = {k: leaf(u, 0 if k in ("wp", "w8", "scale")
                                     else None) for k, u in v.items()}
            elif name in _ROW:
                out[name] = {k: leaf(u, 1 if k in ("wp", "w8") else None)
                             for k, u in v.items()}
            elif name in _BIAS:
                out[name] = (tp_axis, 0)
            else:
                out[name] = leaf(v, None)
        return out

    specs = {k: leaf(v, None) for k, v in sp.items() if k != "layers"}
    specs["lm_head"] = (tp_axis, 0)
    specs["layers"] = [layer(sl) for sl in sp["layers"]]
    return specs


def shard_serving_params(sp: dict, mesh: Mesh, tp_axis: str = "tp"):
    """This rank's local serving params from the full tp-layout params,
    each leaf cut as `serving_param_specs` says. The local params carry
    "tp_local" (the tp size they were cut for), and a params dict that
    already carries it is returned as it is, so a caller may hand every
    rank its slice and free the full model."""
    if "tp_local" in sp:
        return sp
    local = shard_tree(sp, serving_param_specs(sp, tp_axis), mesh)
    local["tp_local"] = mesh.shape[tp_axis]
    return local


def make_sharded_cache(cfg: LlamaConfig, batch: int, max_len: int,
                       mesh: Mesh, mode: str = "bf16", dtype=torch.bfloat16,
                       tp_axis: str = "tp", dp_axis: Optional[str] = None,
                       n_blocks: int = 0, block_size: int = 256):
    """This rank's cache shard on mesh.device: init_cache's cache at the
    local kv heads (kv heads split over tp) and, with dp_axis, the local
    batch (the batch split over dp). A paged pool splits kv heads only:
    it keeps every block (n_blocks as init_cache sizes it for the global
    batch, the blocks shared by every slot) and the whole table."""
    tp = mesh.shape[tp_axis]
    lcfg = tp_local_config(cfg, tp)
    local_b = batch
    if dp_axis is not None and mode != "paged":
        dp = mesh.shape[dp_axis]
        if batch % dp:
            raise ValueError(f"batch {batch} does not split over {dp_axis}"
                             f"={dp}")
        local_b = batch // dp
    if mode == "paged" and n_blocks <= 0:
        n_blocks = 1 + batch * -(-max_len // block_size)
    return init_cache(lcfg, local_b, max_len, dtype=dtype, mode=mode,
                      n_blocks=n_blocks, block_size=block_size,
                      device=mesh.device)


def tp_forward(cfg: LlamaConfig, mesh: Mesh, tp_axis: str = "tp",
               dp_axis: Optional[str] = None):
    """A forward with engine._forward's signature (the batcher's hook)
    over the rank's local params and cache: the global inputs' dp block
    (tokens, a per-slot pos, last_idx), `_forward` on the local config
    with the tp axis, then the logits gathered to [B, V] on every rank.
    Its cfg argument is the global config (read only for the shapes the
    caller sees); the local one is fixed here."""
    tp = mesh.axis(tp_axis)
    dp = mesh.axis(dp_axis) if dp_axis is not None else None
    lcfg = tp_local_config(cfg, tp.size)

    def rows(t):
        if t is None or dp is None or not torch.is_tensor(t) or t.ndim == 0:
            return t
        return t[dp.block(t.shape[0])]

    @torch.no_grad()
    def forward(cfg_, fq_cfg, sp, tokens, cache, pos, phase, use_kernel,
                max_len, compute_dtype=torch.bfloat16, last_idx=None):
        logits = _forward(lcfg, fq_cfg, sp, rows(tokens), cache, rows(pos),
                          phase, use_kernel, max_len, compute_dtype,
                          last_idx=rows(last_idx), tp_axis=tp)
        logits = all_gather(logits, 1, tp)
        return logits if dp is None else all_gather(logits, 0, dp)

    return forward


def tp_serving_programs(cfg: LlamaConfig, fq_cfg: FQConfig, mesh: Mesh,
                        use_kernel: bool = False, max_len: int = 2048,
                        compute_dtype=torch.bfloat16, tp_axis: str = "tp",
                        dp_axis: Optional[str] = None):
    """(prefill, decode_step, chunk) over the rank's local params and
    cache, with JAX's signatures:

      prefill(sp, tokens [B, S], cache, last_idx=None) -> (logits, cache)
      decode_step(sp, tok [B, 1], cache, pos) -> (logits, cache)
      chunk(sp, tokens, cache, pos, last_idx=None) -> (logits, cache)

    sp: shard_serving_params' local params; cache: make_sharded_cache's
    shard (updated in place). Tokens, positions and last_idx are the
    global host inputs, the same on every rank; with dp_axis each rank
    takes its block of the batch. logits: float32 [B, V] on every rank
    (the head's vocab blocks gathered over tp, the batch over dp). JAX's
    sp_specs / cache_specs arguments have no counterpart: the shards are
    the local tensors."""
    dev = mesh.device
    forward = tp_forward(cfg, mesh, tp_axis, dp_axis)

    @torch.no_grad()
    def run(sp, tokens, cache, pos, phase, last_idx):
        tokens = torch.as_tensor(tokens, device=dev).to(torch.long)
        if last_idx is not None:
            last_idx = torch.as_tensor(last_idx, device=dev)
        logits = forward(cfg, fq_cfg, sp, tokens, cache, pos, phase,
                         use_kernel, max_len, compute_dtype,
                         last_idx=last_idx)
        return logits, cache

    def prefill(sp, tokens, cache, last_idx=None):
        return run(sp, tokens, cache, 0, "prefill", last_idx)

    def decode_step(sp, tok, cache, pos):
        # per-slot positions always, as JAX broadcasts pos to [B] (the
        # int4 cache then writes through write_token)
        B = torch.as_tensor(tok).shape[0]
        pos = torch.as_tensor(pos, device=dev).to(torch.int32)
        pos = pos.expand(B) if pos.ndim == 0 else pos
        return run(sp, tok, cache, pos, "decode", None)

    def chunk(sp, tokens, cache, pos, last_idx=None):
        return run(sp, tokens, cache, int(pos), "chunk", last_idx)

    return prefill, decode_step, chunk
