"""Serving engine over the packed int4 slot cache (port of
flatquant_tpu/serving/engine.py, the decode-serving configuration).

Semantics follow the reference deploy stack:
  - prefill attends with *unquantized* (transformed) K/V while writing the
    quantized entries into the cache
  - decode attends over the quantized cache, q rotated by Pk^{-T} into the
    transformed K space
  - KV entries are asym-int4 per (token, head), k-transform applied
    before quantization

What differs from JAX: the cache is a dict of per-layer lists of tensors
in the token-major layout (kernels/kv_cache.py), UPDATED IN PLACE by
prefill and decode (JAX returns new, donated buffers); the layer loop is
a Python loop over the per-layer parameter list. Branches this
configuration never reaches raise NotImplementedError naming the ROADMAP
item that ports them: the fused T >= 256 / S >= 256 prefill routes, flash
prefill (S >= 1024), the paged cache, the chunk phase, tp and the bf16
cache mode.
"""

from __future__ import annotations

import numpy as np
import torch

from flatquant_torch.kernels.common import resolve_device
from flatquant_torch.kernels.kv_cache import (
    decode_attention_int4,
    decode_attention_ref,
    pack_kv_token_major,
    write_token,
    write_token_ref,
)
from flatquant_torch.kernels.prefill_attention import dense_causal_attention
from flatquant_torch.models.config import LlamaConfig
from flatquant_torch.models.llama import apply_rope, rms_norm, rope_tables, rotate_half
from flatquant_torch.quantize.spec import FQConfig
from flatquant_torch.serving.quantized import (
    LONG_PREFILL,
    _quant_linear,
    _quant_swiglu,
    kron_transform,
)

_OTHER_CACHES = ("bf16 and paged cache modes wait for ROADMAP queue 1 "
                 "items 3 and 6")


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               mode: str = "int4", device="cuda") -> dict:
    """Packed int4 KV cache, one zeroed tensor per layer:
    "kp"/"vp" [B, nkv, max_len, hd/2] uint8 and "kparam"/"vparam"
    [B, nkv, max_len, 2] float32 (scale, zero). Prefill and decode update
    these tensors in place."""
    if mode != "int4":
        raise NotImplementedError(_OTHER_CACHES)
    dev = resolve_device(device)
    L, nkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim

    def zeros(last, dtype):
        return [torch.zeros((batch, nkv, max_len, last), dtype=dtype,
                            device=dev) for _ in range(L)]

    return {"kp": zeros(hd // 2, torch.uint8),
            "kparam": zeros(2, torch.float32),
            "vp": zeros(hd // 2, torch.uint8),
            "vparam": zeros(2, torch.float32)}


def _apply_head_matrix(t, mat):
    """t [..., h, d] @ mat [d, d], in mat's dtype."""
    return t.to(mat.dtype) @ mat


def _check_ported(cfg, fq_cfg, sl, B, S, per_slot, phase, use_kernel,
                  tp_axis, tbl):
    """Raise NotImplementedError, before any cache write, for every branch
    of JAX's serving_layer_int4cache that this slice does not port (each
    names the ROADMAP item that will), instead of taking another route."""
    a_cfg = fq_cfg.a_cfg
    if tp_axis is not None:
        raise NotImplementedError("tp waits for ROADMAP queue 1 item 9")
    if tbl is not None:
        raise NotImplementedError(_OTHER_CACHES)
    if phase not in ("prefill", "decode") or (phase == "decode" and S != 1):
        raise NotImplementedError(
            f"phase {phase!r} with {S} tokens (chunked prefill) waits for "
            "ROADMAP queue 1 item 6")
    if per_slot and S != 1:
        raise ValueError("per-slot positions only in single-token decode")
    if not a_cfg.enabled:
        raise NotImplementedError(
            "weight-only serving waits for ROADMAP queue 1 item 3")
    if "qkv" not in sl or "upgate" not in sl:
        raise NotImplementedError(
            "unmerged projections wait for ROADMAP queue 1 item 4")
    if sl.get("o_t") is None:
        raise NotImplementedError(
            "serving without the o head-mixing transform waits for ROADMAP "
            "queue 1 item 3")
    if use_kernel and a_cfg.q_max == 7 and B * S >= 256:
        raise NotImplementedError(
            f"{B * S} rows take JAX's fused prefill routes "
            f"(_grouped_attn_in, _quant_mlp_grouped[_full], the fused "
            f"swiglu GEMM); they wait for {LONG_PREFILL}")
    if (use_kernel and phase == "prefill" and cfg.head_dim == 128
            and S % 128 == 0 and S >= 256 and "k_t" in sl
            and sl["o_t"].shape[-1] == cfg.num_heads and a_cfg.q_max == 7):
        raise NotImplementedError(
            f"the fused attention prologue (S >= 256) waits for "
            f"{LONG_PREFILL}")
    if phase == "prefill" and S >= 1024 and S % 128 == 0:
        raise NotImplementedError(
            f"flash prefill attention (S >= 1024) waits for {LONG_PREFILL}")


def serving_layer_int4cache(cfg, fq_cfg, sl, x, cos, sin, kp, kparam, vp,
                            vparam, pos, phase, use_kernel, compute_dtype,
                            tp_axis=None, tbl=None):
    """One quantized decoder layer over the packed int4 cache.

    x [B, S, H]; kp/kparam/vp/vparam: this layer's cache tensors, written
    IN PLACE; pos: an int (the first position of x) or, in single-token
    decode, a per-slot tensor [B]. Prefill writes the quantized prompt K/V
    and attends unquantized; decode writes one token and attends over the
    cache through decode_attention_int4. Returns the layer output."""
    B, S, H = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    a_cfg = fq_cfg.a_cfg
    per_slot = torch.is_tensor(pos) and pos.ndim == 1
    _check_ported(cfg, fq_cfg, sl, B, S, per_slot, phase, use_kernel,
                  tp_axis, tbl)

    def qlin(h, lin, bias=None):
        y = _quant_linear(h.reshape(-1, h.shape[-1]), lin, use_kernel,
                          compute_dtype, quant_acts=True, a_q_max=a_cfg.q_max)
        y = y.reshape(h.shape[:-1] + (lin["scale"].shape[0],))
        return y if bias is None else y + bias.to(y.dtype)

    h = rms_norm(x, sl["ln1_w"], cfg.rms_eps)
    if "ln_t" in sl:
        h = kron_transform(h, sl["ln_t"])
    qkv = qlin(h, sl["qkv"], sl.get("bqkv"))

    q, k, v = torch.split(qkv, [cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
    q = q.reshape(B, S, nh, hd)
    k = k.reshape(B, S, nkv, hd)
    v = v.reshape(B, S, nkv, hd)

    if per_slot:
        cb = cos[pos][:, None, None, :]  # [B, 1, 1, d]
        sb = sin[pos][:, None, None, :]
        q = q * cb.to(q.dtype) + rotate_half(q) * sb.to(q.dtype)
        k = k * cb.to(k.dtype) + rotate_half(k) * sb.to(k.dtype)
    else:
        q, k = apply_rope(q, k, cos[pos:pos + S], sin[pos:pos + S])
    if "k_t" in sl:
        k = _apply_head_matrix(k, sl["k_t"])
        q = _apply_head_matrix(q, sl["k_t_inv"])

    kq, kpar = pack_kv_token_major(k, sl.get("kc_clip"))  # [B, nkv, S, .]
    vq, vpar = pack_kv_token_major(v, sl.get("vc_clip"))
    if per_slot:
        put = write_token if use_kernel else write_token_ref
        put(kp, kparam, vp, vparam, kq, kpar, vq, vpar, pos)
    else:
        kp[:, :, pos:pos + S] = kq
        kparam[:, :, pos:pos + S] = kpar
        vp[:, :, pos:pos + S] = vq
        vparam[:, :, pos:pos + S] = vpar

    sm_scale = 1.0 / float(np.sqrt(hd))
    if phase == "prefill":
        attn = dense_causal_attention(q, k, v, sm_scale, compute_dtype)
    else:
        if per_slot:
            valid = (pos + 1).to(torch.int32)
        else:
            valid = torch.full((B,), pos + 1, dtype=torch.int32,
                               device=x.device)
        if use_kernel:
            attn = decode_attention_int4(q[:, 0], kp, kparam, vp, vparam,
                                         valid, sm_scale)
        else:
            attn = decode_attention_ref(
                q[:, 0], kp, kparam[..., 0:1], kparam[..., 1:2], vp,
                vparam[..., 0:1], vparam[..., 1:2], valid, sm_scale)
        attn = attn[:, None]

    o_mat = sl["o_t"].to(attn.dtype)
    g = o_mat.shape[0]
    attn = attn.reshape(B, S, nh // g, g, hd)
    attn = torch.einsum("ji,bstjd->bstid", o_mat, attn).reshape(B, S, nh * hd)
    x = x + qlin(attn, sl["o"])
    return _int4cache_mlp(cfg, fq_cfg, sl, x, use_kernel, compute_dtype)


def _int4cache_mlp(cfg, fq_cfg, sl, x, use_kernel, compute_dtype):
    """The MLP half of a serving layer (the composed branch: eager ln2 +
    Kronecker glue, the merged up||gate W4A4 GEMM, silu, the down
    transform and the down GEMM)."""
    H = x.shape[-1]
    a_cfg = fq_cfg.a_cfg
    h2 = rms_norm(x, sl["ln2_w"], cfg.rms_eps)
    if "ug_t" in sl:
        h2 = kron_transform(h2, sl["ug_t"])
    act = _quant_swiglu(h2.reshape(-1, H), sl["upgate"], use_kernel,
                        compute_dtype, True, a_cfg.q_max)
    act = act.reshape(h2.shape[:-1] + (act.shape[-1],))
    if "down_t" in sl:
        act = kron_transform(act, sl["down_t"])
    y = _quant_linear(act.reshape(-1, act.shape[-1]), sl["down"], use_kernel,
                      compute_dtype, True, a_cfg.q_max)
    return x + y.reshape(x.shape)


def _forward(cfg, fq_cfg, sp, tokens, cache, pos, phase, use_kernel, max_len,
             compute_dtype=torch.bfloat16, last_idx=None):
    """Embed, run every layer (cache updated in place), final norm and
    lm_head on the last (or last_idx) token -> float32 logits [B, V]."""
    if fq_cfg.k_cfg.bits != 4 or fq_cfg.v_cfg.bits != 4:
        raise NotImplementedError(
            "the packed cache holds int4 nibbles; kv8/kv16 configs need the "
            "bf16 cache mode (ROADMAP queue 1 item 3)")
    x = sp["embed"][tokens].to(compute_dtype)
    cos, sin = rope_tables(cfg, torch.arange(max_len, device=x.device))
    for i, sl in enumerate(sp["layers"]):
        x = serving_layer_int4cache(
            cfg, fq_cfg, sl, x, cos, sin, cache["kp"][i], cache["kparam"][i],
            cache["vp"][i], cache["vparam"][i], pos, phase, use_kernel,
            compute_dtype)
    x = rms_norm(x, sp["final_norm_w"], cfg.rms_eps)
    last = (x[:, -1] if last_idx is None
            else x[torch.arange(x.shape[0], device=x.device), last_idx])
    return (last @ sp["lm_head"].T.to(x.dtype)).to(torch.float32)


def _as_tokens(tokens, dev):
    return torch.as_tensor(tokens, device=dev).to(torch.long)


@torch.no_grad()
def serving_prefill(cfg, fq_cfg, sp, tokens, cache, use_kernel=True,
                    max_len=2048, compute_dtype=torch.bfloat16,
                    device="cuda"):
    """Process the prompt tokens [B, S]; returns (last-token logits
    [B, V] float32, cache). The cache's tensors are written in place (the
    same dict is returned, for the JAX package's call shape)."""
    dev = resolve_device(device)
    tokens = _as_tokens(tokens, dev)
    logits = _forward(cfg, fq_cfg, sp, tokens, cache, 0, "prefill",
                      use_kernel, max_len, compute_dtype)
    return logits, cache


@torch.no_grad()
def serving_decode_step(cfg, fq_cfg, sp, token, cache, pos, use_kernel=True,
                        max_len=2048, compute_dtype=torch.bfloat16,
                        device="cuda"):
    """One decode step. token [B, 1]; pos: an int (every slot at the same
    length) or a per-slot tensor [B] (continuous batching). Returns
    (logits [B, V] float32, cache), the cache updated in place."""
    dev = resolve_device(device)
    token = _as_tokens(token, dev)
    if torch.is_tensor(pos) or isinstance(pos, np.ndarray):
        pos = torch.as_tensor(pos, device=dev)
        if pos.ndim == 0:
            pos = int(pos)
    logits = _forward(cfg, fq_cfg, sp, token, cache, pos, "decode",
                      use_kernel, max_len, compute_dtype)
    return logits, cache


def sample_token(logits, temperature: float = 0.0, generator=None):
    """Greedy (temperature 0) or temperature sampling -> [B, 1] int32."""
    if temperature <= 0.0 or generator is None:
        return logits.argmax(dim=-1, keepdim=True).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)


def generate(cfg: LlamaConfig, fq_cfg: FQConfig, sp: dict, prompt,
             max_new_tokens: int = 32, max_len: int = 2048,
             use_kernel: bool = True, temperature: float = 0.0, seed: int = 0,
             cache_mode: str = "int4", compute_dtype=torch.bfloat16,
             device="cuda"):
    """Prefill `prompt` [B, S], then decode max_new_tokens tokens; greedy
    at temperature 0. Returns the generated tokens [B, max_new_tokens] as
    a numpy int32 array."""
    dev = resolve_device(device)
    prompt = _as_tokens(prompt, dev)
    B, S = prompt.shape
    cache = init_cache(cfg, B, max_len, mode=cache_mode, device=dev)
    logits, cache = serving_prefill(cfg, fq_cfg, sp, prompt, cache,
                                    use_kernel, max_len, compute_dtype, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tok = sample_token(logits, temperature, gen)
    out = []
    for i in range(max_new_tokens):
        out.append(tok)
        logits, cache = serving_decode_step(
            cfg, fq_cfg, sp, tok, cache, S + i, use_kernel, max_len,
            compute_dtype, dev)
        tok = sample_token(logits, temperature, gen)
    return torch.cat(out, dim=1).cpu().numpy()
