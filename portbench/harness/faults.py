"""Faults planted in the timed path, for the tests and for the readings
that set a cell's limit (calibrate.py --faults): each is a function of
the batcher that breaks one part of the program underneath and returns
a function that undoes it.

Inside the layers (every layer, every call of the part):
  decode_reads_previous_block
                       llama: the paged decode attention reads the block
                       before the newest position's in its place
  decode_latent_early  deepseek: a decode step writes its latent one
                       position early (over the previous token's) and
                       attends up to there
  gemm_tile_zeroed     the W4A4 GEMM (row 1, and its plain version) loses
                       its first 128 x 128 output tile
  kv_zero_off_by_one   llama: every K and V written to the paged int4
                       cache has its zero point one code off
  expert_dropped       deepseek: routed expert 0 returns zeros
At the output:
  token_altered        every third decode call's logits rolled by one
                       token, so the step emits the next token id
  half_batch           the second half of the slots takes the first
                       half's logits
"""

from __future__ import annotations

import sys

import torch


def _swap(name: str, wrap) -> callable:
    """Replace the function `name` in every module of the port that holds
    it by wrap(original); returns the undo."""
    done = []
    for mod_name, mod in list(sys.modules.items()):
        if not mod_name.startswith("flatquant_torch") or mod is None:
            continue
        orig = mod.__dict__.get(name)
        if callable(orig):
            done.append((mod, orig))
    if not done:
        raise LookupError(f"no module of the port holds {name!r}")
    for mod, orig in done:
        setattr(mod, name, wrap(orig))

    def undo():
        for mod, orig in done:
            setattr(mod, name, orig)
    return undo


def _undo_all(undos):
    def undo():
        for u in undos:
            u()
    return undo


def decode_reads_previous_block(b):
    import flatquant_torch.serving.engine  # noqa: F401

    def wrap(fn):
        def paged(q, kp, kparam, vp, vparam, tbl, valid, *a, **k):
            last = ((valid.long() - 1) // kp.shape[2])[:, None]
            prev = tbl.gather(1, (last - 1).clamp(min=0))
            return fn(q, kp, kparam, vp, vparam,
                      tbl.scatter(1, last, prev), valid, *a, **k)
        return paged
    return _undo_all([_swap("paged_decode_attention_int4", wrap),
                      _swap("paged_decode_attention_ref", wrap)])


def decode_latent_early(b):
    import flatquant_torch.models.deepseek  # noqa: F401

    def wrap(fn):
        def mla(cfg, fq_cfg, mode, lp, fqa, x, cos, sin, mask, cache=None,
                pos=0, *a, **k):
            if cache is not None and torch.is_tensor(pos) and pos.dim() == 1:
                pos = (pos - 1).clamp(min=0)
            return fn(cfg, fq_cfg, mode, lp, fqa, x, cos, sin, mask, cache,
                      pos, *a, **k)
        return mla
    return _swap("ds_mla", wrap)


def gemm_tile_zeroed(b):
    import flatquant_torch.serving.engine  # noqa: F401

    def wrap(fn):
        def gemm(*a, **k):
            y = fn(*a, **k)
            y[:128, :128] = 0
            return y
        return gemm
    return _undo_all([_swap("w4a4_matmul_i8", wrap),
                      _swap("w4a8_matmul_ref", wrap)])


def kv_zero_off_by_one(b):
    import flatquant_torch.serving.engine  # noqa: F401

    def wrap(fn):
        def write(pool_c, pool_p, codes, params, *a, **k):
            params = params.clone()
            params[..., 1] += 1
            return fn(pool_c, pool_p, codes, params, *a, **k)
        return write
    return _undo_all([_swap(n, wrap) for n in (
        "write_prompt_paged", "write_chunk_paged", "write_token_paged")])


def expert_dropped(b):
    import flatquant_torch.models.deepseek  # noqa: F401

    def wrap(fn):
        def routed(*a, **k):
            y = fn(*a, **k)
            y[0] = 0
            return y
        return routed
    return _swap("_routed_experts", wrap)


def token_altered(b):
    orig, calls = b._decode_multi, [0]

    def decode(*a):
        logits = orig(*a)
        calls[0] += 1
        return logits.roll(1, dims=-1) if calls[0] % 3 == 0 else logits

    b._decode_multi = decode

    def undo():
        b._decode_multi = orig
    return undo


def half_batch(b):
    orig = b._decode_multi

    def decode(*a):
        logits = orig(*a).clone()
        h = logits.shape[0] // 2
        logits[h:2 * h] = logits[:h]
        return logits

    b._decode_multi = decode

    def undo():
        b._decode_multi = orig
    return undo


# the faults each family's cells can have
FAMILY = {"llama": ("decode_reads_previous_block", "gemm_tile_zeroed",
                    "kv_zero_off_by_one", "token_altered", "half_batch"),
          "deepseek": ("decode_latent_early", "gemm_tile_zeroed",
                       "expert_dropped", "token_altered", "half_batch")}


def plant(name: str, b):
    """Plant the fault `name` under batcher b; returns its undo."""
    return globals()[name](b)
