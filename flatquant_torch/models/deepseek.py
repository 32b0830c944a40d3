"""DeepSeek-V2/V3: absorbed MLA over the latent caches, the
group-limited gate, dense-masked and capacity-gather MoE, and FlatQuant's
state, calibration and int4 packing for it (port of
flatquant_tpu/models/deepseek.py).

Parameters are dicts of tensors; "dense_layers" and "moe_layers" are
Python lists with one dict per layer (JAX stacks them for lax.scan). The
FlatQuant state `fq` is (dense_fq, moe_fq), lists of per-layer dicts
{"attn": {...}, "ffn": {...}} keyed by the fields of JAX's dataclasses in
their order (MLAFQ, DenseFFNFQ, MoEFQ below): transforms (raw
DecomposeTransform, or BakedDecompose after bake_ds_fq) or None, and the
linears' LinearQuantState. The dense FFN has "up_gate_trans" and
"down_trans"; the MoE "w1_trans" (applied once before routing),
"w2_trans" (the shared experts' down) and "routed_w2_trans"; the routed
experts' weight clips are stacked [E, ...], their activation clips shared.

Linear weights come in three forms, each taken where JAX takes it
(`_linear`): a native-FP8 dict {"w8", "se"} through kernels/fp8_matmul.py
(row 16), a packed int4 dict {"wp", "scale"[, "a_clip"]} through the
serving linear of serving/quantized.py (row 1 on the card), or a plain
tensor [out, in]. wkv_b stays a plain bf16 tensor in every form: the
absorbed attention multiplies it in plain einsums, outside any kernel, as
JAX does.

What differs from JAX:
  - JAX's DeepSeek path picks its kernels by jax.default_backend() and
    ignores use_kernel; the port's entry points take `use_kernel`
    (default True) like every other port entry point: on a CUDA device
    the kernels launch, use_kernel=False runs the plain versions for
    comparison, and CPU tensors run the plain versions either way;
  - every cache is updated in place (JAX returns new arrays): `_ds_step`
    returns the same dict, and `ds_batch_forward` returns only the logits,
    as the port's Llama `_forward` does for the batcher;
  - the routed experts of the packed int4 form run the plain serving
    linear, batched over the expert axis, on the card too: JAX calls
    `_quant_linear(..., use_kernel=False)` for them even on the TPU.

Modes: "fp", "calib" (raw weights, transforms and STE fake-quant
threaded through every linear; with baked transforms it is also JAX's
DeepSeek eval), "eval" (act quant only) and "serve" (packed or FP8
weights). Not ported here: the HF FP8 loader (ROADMAP queue 1 item 5) and
the EP/TP meshes (item 9).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from flatquant_torch.core.quant import weight_find_params, weight_quantize_int
from flatquant_torch.core.transforms import (
    apply_decompose,
    bake_decompose,
    init_decompose,
)
from flatquant_torch.kernels.common import resolve_device
from flatquant_torch.kernels.fp8_matmul import fp8_linear, prep_fp8_weight
from flatquant_torch.kernels.int4_matmul import (
    pack_weight_planar,
    quant_acts_i8_ref,
)
from flatquant_torch.models.llama import rms_norm, silu
from flatquant_torch.quantize.linear import (
    LinearQuantState,
    fq_linear_eval,
    fq_linear_train,
    init_linear_state,
    transform_weight,
)
from flatquant_torch.serving.engine import _as_tokens
from flatquant_torch.serving.quantized import _clip_sigmoid, _quant_linear


# ---------------------------------------------------------------------------
# config (copied from flatquant_tpu/models/deepseek.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeepSeekConfig:
    """Defaults: DeepSeek-V2-Lite's shapes."""

    name: str = "deepseek"
    vocab_size: int = 102400
    dim: int = 2048
    inter_dim: int = 10944
    moe_inter_dim: int = 1408
    n_layers: int = 27
    n_dense_layers: int = 1
    n_heads: int = 16
    # moe
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    n_activated_experts: int = 6
    n_expert_groups: int = 1
    n_limited_groups: int = 1
    score_func: str = "softmax"  # or "sigmoid"
    route_scale: float = 1.0
    gate_bias: bool = False  # V3-671B (dim 7168) has a gate bias
    # mla
    q_lora_rank: int = 0
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # yarn
    original_seq_len: int = 4096
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    beta_fast: int = 32
    beta_slow: int = 1
    mscale: float = 1.0
    max_seq_len: int = 16384
    rms_eps: float = 1e-6
    seqlen: int = 4096  # calibration length
    # routed experts: "dense" = every expert on every token, masked by the
    # routing weights (exact, drop-free); "gather" = capacity dispatch of
    # C = ceil(T*K/E * capacity_factor) slots per expert, tokens past it
    # dropped silently; "auto" = gather for serve-mode prefills of 256+
    # tokens, dense otherwise
    moe_impl: str = "auto"
    moe_capacity_factor: float = 2.0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def softmax_scale(self) -> float:
        scale = self.qk_head_dim**-0.5
        if self.max_seq_len > self.original_seq_len:
            ms = 0.1 * self.mscale * math.log(self.rope_factor) + 1.0
            scale = scale * ms * ms
        return scale

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.n_dense_layers


# V3/R1 671B shapes (config_671B.json)
DEEPSEEK_V3 = DeepSeekConfig(
    name="deepseek-v3",
    vocab_size=129280,
    dim=7168,
    inter_dim=18432,
    moe_inter_dim=2048,
    n_layers=61,
    n_dense_layers=3,
    n_heads=128,
    n_routed_experts=256,
    n_shared_experts=1,
    n_activated_experts=8,
    n_expert_groups=8,
    n_limited_groups=4,
    score_func="sigmoid",
    route_scale=2.5,
    gate_bias=True,
    q_lora_rank=1536,
)

TINY_DEEPSEEK = DeepSeekConfig(
    name="tiny-deepseek",
    vocab_size=256,
    dim=64,
    inter_dim=128,
    moe_inter_dim=48,
    n_layers=3,
    n_dense_layers=1,
    n_heads=4,
    n_routed_experts=8,
    n_shared_experts=1,
    n_activated_experts=2,
    n_expert_groups=4,
    n_limited_groups=2,
    score_func="sigmoid",
    route_scale=2.5,
    gate_bias=True,
    q_lora_rank=32,
    kv_lora_rank=32,
    qk_nope_head_dim=16,
    qk_rope_head_dim=8,
    v_head_dim=16,
    original_seq_len=64,
    max_seq_len=256,
    seqlen=32,
)


# ---------------------------------------------------------------------------
# YaRN rope (interleaved (real, imag) pairs)
# ---------------------------------------------------------------------------


def _rope_tables_np(cfg: DeepSeekConfig, seqlen: int):
    dim = cfg.qk_rope_head_dim
    base = cfg.rope_theta
    freqs = 1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    if seqlen > cfg.original_seq_len:
        def corr_dim(num_rot):
            return (dim * math.log(cfg.original_seq_len
                                   / (num_rot * 2 * math.pi))
                    / (2 * math.log(base)))

        low = max(math.floor(corr_dim(cfg.beta_fast)), 0)
        high = min(math.ceil(corr_dim(cfg.beta_slow)), dim - 1)
        if low == high:
            high += 0.001
        ramp = np.clip((np.arange(dim // 2, dtype=np.float64) - low)
                       / (high - low), 0, 1)
        smooth = 1.0 - ramp
        freqs = freqs / cfg.rope_factor * (1 - smooth) + freqs * smooth
    ang = np.outer(np.arange(seqlen, dtype=np.float64), freqs)
    return np.cos(ang), np.sin(ang)


@functools.lru_cache(maxsize=16)
def _rope_tables_cached(cfg, seqlen, device):
    c, s = _rope_tables_np(cfg, seqlen)
    return (torch.as_tensor(c, dtype=torch.float32, device=device),
            torch.as_tensor(s, dtype=torch.float32, device=device))


def ds_rope_tables(cfg: DeepSeekConfig, max_len: Optional[int] = None,
                   device="cuda"):
    """cos/sin [max_len, rope/2] float32 (float64 in numpy, then cast, as
    JAX computes them); YaRN-scaled when max_len passes
    original_seq_len."""
    dev = resolve_device(device)
    return _rope_tables_cached(cfg, max_len or cfg.max_seq_len, dev)


def _rotate(x, c, s):
    shape = x.shape
    xr = x.to(torch.float32).reshape(shape[:-1] + (shape[-1] // 2, 2))
    x0, x1 = xr[..., 0], xr[..., 1]
    out0 = x0 * c - x1 * s
    out1 = x0 * s + x1 * c
    return torch.stack([out0, out1], dim=-1).reshape(shape).to(x.dtype)


def apply_ds_rope(x, cos, sin):
    """x [B, S, h, d] with interleaved (real, imag) pairs; cos/sin
    [S, d/2]."""
    return _rotate(x, cos[None, :, None, :], sin[None, :, None, :])


def _apply_ds_rope_per_slot(x, cos, sin):
    """x [B, 1, h, d]; cos/sin [B, d/2]: one rope row per batch slot (the
    batcher's decode, each slot at its own position)."""
    return _rotate(x, cos[:, None, None, :], sin[:, None, None, :])


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init_ds_layer_params(cfg: DeepSeekConfig, moe: bool,
                         generator: torch.Generator, dtype=torch.float32,
                         device="cuda") -> dict:
    """One layer's random weights, N(0, 0.02^2), drawn from `generator`
    (which must live on `device`); norms at one, the gate bias at zero."""
    dev = resolve_device(device)

    def w(*shape):
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * 0.02).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=dev)

    d = {
        "attn_norm": ones(cfg.dim),
        "ffn_norm": ones(cfg.dim),
        "wkv_a": w(cfg.kv_lora_rank + cfg.qk_rope_head_dim, cfg.dim),
        "kv_norm": ones(cfg.kv_lora_rank),
        "wkv_b": w(cfg.n_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                   cfg.kv_lora_rank),
        "wo": w(cfg.dim, cfg.n_heads * cfg.v_head_dim),
    }
    if cfg.q_lora_rank > 0:
        d["wq_a"] = w(cfg.q_lora_rank, cfg.dim)
        d["q_norm"] = ones(cfg.q_lora_rank)
        d["wq_b"] = w(cfg.n_heads * cfg.qk_head_dim, cfg.q_lora_rank)
    else:
        d["wq"] = w(cfg.n_heads * cfg.qk_head_dim, cfg.dim)
    if not moe:
        d.update(w1=w(cfg.inter_dim, cfg.dim), w2=w(cfg.dim, cfg.inter_dim),
                 w3=w(cfg.inter_dim, cfg.dim))
        return d
    E, mi = cfg.n_routed_experts, cfg.moe_inter_dim
    si = cfg.n_shared_experts * mi
    d.update(gate_w=w(E, cfg.dim), e_w1=w(E, mi, cfg.dim),
             e_w2=w(E, cfg.dim, mi), e_w3=w(E, mi, cfg.dim),
             s_w1=w(si, cfg.dim), s_w2=w(cfg.dim, si), s_w3=w(si, cfg.dim))
    if cfg.gate_bias:
        d["gate_b"] = torch.zeros(E, dtype=dtype, device=dev)
    return d


def init_ds_params(cfg: DeepSeekConfig, seed: int = 0, dtype=torch.float32,
                   device="cuda") -> dict:
    """Random-weight model from a seeded torch.Generator on `device` (not
    JAX's numbers: tests hand both packages JAX's params through
    utils/convert.py)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dense = [init_ds_layer_params(cfg, False, gen, dtype, dev)
             for _ in range(cfg.n_dense_layers)]
    moe = [init_ds_layer_params(cfg, True, gen, dtype, dev)
           for _ in range(cfg.n_moe_layers)]

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * 0.02).to(dtype)

    return {"embed": w(cfg.vocab_size, cfg.dim),
            "final_norm": torch.ones(cfg.dim, dtype=dtype, device=dev),
            "head": w(cfg.vocab_size, cfg.dim),
            "dense_layers": dense, "moe_layers": moe}


# ---------------------------------------------------------------------------
# FlatQuant state: per-layer dicts keyed by JAX's dataclass fields
# ---------------------------------------------------------------------------

MLAFQ = ("qkv_trans",  # on dim (the input of wq / wq_a and wkv_a)
         "wqb_trans",  # on q_lora_rank
         "wo_trans",  # on n_heads * v_head_dim
         "wq_a_lin",  # also wq's when q_lora_rank == 0
         "wq_b_lin", "wkv_a_lin", "wo_lin")
DenseFFNFQ = ("up_gate_trans", "down_trans", "w1_lin", "w2_lin", "w3_lin")
MoEFQ = ("w1_trans",  # shared, applied once before routing
         "w2_trans",  # the shared experts' down
         "routed_w2_trans",  # one transform for every routed expert
         "s_w1_lin", "s_w2_lin", "s_w3_lin",
         "e_w1_lin", "e_w2_lin", "e_w3_lin")  # clip_w [E, ...], clip_a shared
DSDenseLayerFQ = {"attn": MLAFQ, "ffn": DenseFFNFQ}
DSMoELayerFQ = {"attn": MLAFQ, "ffn": MoEFQ}


def is_moe_fq(layer_fq) -> bool:
    return "w1_trans" in layer_fq["ffn"]


def _makers(fq, rng, dev):
    """(weights or activations quantized?, a decompose transform of width
    n drawn from rng, a linear state of n outputs)."""
    def mk(n):
        return init_decompose(n, rng, add_diag=fq.add_diag,
                              direct_inv=fq.direct_inv, device=dev)

    def lin(out):
        return init_linear_state(out, fq.lwc, fq.lac, dev)

    return fq.w_bits < 16 or fq.a_bits < 16, mk, lin


def _init_mla_fq(cfg: DeepSeekConfig, fq, rng, dev) -> dict:
    wa, mk, lin = _makers(fq, rng, dev)
    lora = cfg.q_lora_rank > 0
    return {
        "qkv_trans": mk(cfg.dim) if wa else None,
        "wqb_trans": mk(cfg.q_lora_rank) if (wa and lora) else None,
        "wo_trans": mk(cfg.n_heads * cfg.v_head_dim) if wa else None,
        "wq_a_lin": lin(cfg.q_lora_rank if lora
                        else cfg.n_heads * cfg.qk_head_dim),
        "wq_b_lin": lin(cfg.n_heads * cfg.qk_head_dim) if lora else None,
        "wkv_a_lin": lin(cfg.kv_lora_rank + cfg.qk_rope_head_dim),
        "wo_lin": lin(cfg.dim),
    }


def _stack_linear_state(st: LinearQuantState, n: int) -> LinearQuantState:
    """The routed experts' state: weight clips repeated to [n, ...] (one
    trainable copy per expert), activation clips shared."""
    def rep(a):
        return None if a is None else a.expand((n,) + a.shape).clone()

    return LinearQuantState(clip_w_max=rep(st.clip_w_max),
                            clip_w_min=rep(st.clip_w_min),
                            clip_a_max=st.clip_a_max,
                            clip_a_min=st.clip_a_min)


def init_ds_fq(cfg: DeepSeekConfig, fq, seed: int = 0, device="cuda"):
    """(dense_fq, moe_fq): per-layer state lists. The factors are drawn on
    the host from one np.random.default_rng(seed) in JAX's order (every
    dense layer, then every MoE layer; in a layer the MLA part first,
    then the FFN in field order), so the same seed gives JAX's state bit
    for bit."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    wa, mk, lin = _makers(fq, rng, dev)

    def dense_layer():
        attn = _init_mla_fq(cfg, fq, rng, dev)
        return {"attn": attn, "ffn": {
            "up_gate_trans": mk(cfg.dim) if wa else None,
            "down_trans": mk(cfg.inter_dim) if wa else None,
            "w1_lin": lin(cfg.inter_dim), "w2_lin": lin(cfg.dim),
            "w3_lin": lin(cfg.inter_dim)}}

    def moe_layer():
        attn = _init_mla_fq(cfg, fq, rng, dev)
        si = cfg.n_shared_experts * cfg.moe_inter_dim
        E = cfg.n_routed_experts
        return {"attn": attn, "ffn": {
            "w1_trans": mk(cfg.dim) if wa else None,
            "w2_trans": mk(si) if wa else None,
            "routed_w2_trans": mk(cfg.moe_inter_dim) if wa else None,
            "s_w1_lin": lin(si), "s_w2_lin": lin(cfg.dim),
            "s_w3_lin": lin(si),
            "e_w1_lin": _stack_linear_state(lin(cfg.moe_inter_dim), E),
            "e_w2_lin": _stack_linear_state(lin(cfg.dim), E),
            "e_w3_lin": _stack_linear_state(lin(cfg.moe_inter_dim), E)}}

    dense = [dense_layer() for _ in range(cfg.n_dense_layers)]
    return dense, [moe_layer() for _ in range(cfg.n_moe_layers)]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _absmax(t, dims):
    return t.to(torch.float32).abs().amax(dim=dims)


def _linear(mode, quant, fq_cfg, x, w, use_kernel, st=None, qa=None):
    """x [..., in] through one linear, in JAX's branch order: a native-FP8
    dict (fp8_linear, the activations unquantized), a packed int4 dict
    (per-token quant + the int4 GEMM; transforms and clips were baked in
    at packing, so qa is not read), a plain weight without quantization,
    then the fake-quant linear on a raw weight: "calib" (transform qa and
    clips st in the weight, STE fake-quant) or any other mode (act quant
    only)."""
    if isinstance(w, dict) and "w8" in w:
        # fp8 weights carry no folded inverse transform: a FlatQuant
        # transform on x would go unundone
        if quant:
            raise ValueError("a native-FP8 linear cannot compose with "
                             "FlatQuant transforms or quantizers (fq must "
                             "be None)")
        return fp8_linear(x, w, out_dtype=x.dtype, use_kernel=use_kernel,
                          exact=getattr(fq_cfg, "fp8_exact", True))
    if isinstance(w, dict):
        y = _quant_linear(x.reshape(-1, x.shape[-1]), w, use_kernel, x.dtype,
                          quant_acts=fq_cfg.a_cfg.enabled,
                          a_q_max=fq_cfg.a_cfg.q_max)
        return y.reshape(x.shape[:-1] + (w["scale"].shape[0],))
    if not quant:
        return x @ w.T.to(x.dtype)
    if mode == "calib":
        return fq_linear_train(x, w, None, st, fq_cfg.w_cfg, fq_cfg.a_cfg,
                               qa_trans=qa, lwc=fq_cfg.lwc)
    return fq_linear_eval(x, w, None, st, fq_cfg.a_cfg)


def _trans(fq_part, key, quant):
    return fq_part[key] if quant else None


def ds_mla(cfg: DeepSeekConfig, fq_cfg, mode, lp, fqa, x, cos, sin, mask,
           cache=None, pos=0, use_kernel=True, stats=None):
    """Absorbed MLA. Full sequence when cache is None (mask [1, S, S]);
    with cache = (kv_cache [B, Smax, kv_lora], pe_cache [B, Smax, rope])
    the new latents are written in place at [pos, pos + S) and the
    queries attend over the whole cache under a causal, valid-length
    mask. pos may be a per-slot [B] tensor (decode, S == 1): cos/sin are
    then [B, rope/2] rows and each slot writes and attends its own
    prefix through a masked select. stats (a dict) gets the absmax per
    channel of the inputs of the qkv, wq_b and wo transforms."""
    B, S, _ = x.shape
    per_slot = torch.is_tensor(pos) and pos.dim() == 1
    if per_slot and S != 1:
        raise ValueError("per-slot positions only in decode (S == 1)")
    quant = mode != "fp" and fqa is not None
    calib = quant and mode == "calib"
    nh, nope = cfg.n_heads, cfg.qk_nope_head_dim

    def lin(inp, key, st_key, qa):
        return _linear(mode, quant, fq_cfg, inp, lp[key], use_kernel,
                       fqa[st_key] if quant else None,
                       qa if calib else None)

    h = x
    if stats is not None:
        stats["qkv"] = _absmax(h, (0, 1))
    t = _trans(fqa, "qkv_trans", quant)
    if t is not None:
        h = apply_decompose(t, h)
    if cfg.q_lora_rank > 0:
        q2 = rms_norm(lin(h, "wq_a", "wq_a_lin", t), lp["q_norm"],
                      cfg.rms_eps)
        if stats is not None:
            stats["wqb"] = _absmax(q2, (0, 1))
        tb = _trans(fqa, "wqb_trans", quant)
        if tb is not None:
            q2 = apply_decompose(tb, q2)
        q = lin(q2, "wq_b", "wq_b_lin", tb)
    else:
        q = lin(h, "wq", "wq_a_lin", t)
    kv_raw = lin(h, "wkv_a", "wkv_a_lin", t)

    q = q.reshape(B, S, nh, cfg.qk_head_dim)
    q_nope = q[..., :nope]
    rope = _apply_ds_rope_per_slot if per_slot else apply_ds_rope
    q_pe = rope(q[..., nope:], cos, sin)
    kv = kv_raw[..., :cfg.kv_lora_rank]
    k_pe = rope(kv_raw[..., None, cfg.kv_lora_rank:], cos, sin)[..., 0, :]

    # absorb wkv_b's K half into q (wkv_b is never quantized)
    wkv_b = lp["wkv_b"].reshape(nh, nope + cfg.v_head_dim, cfg.kv_lora_rank)
    q_abs = torch.einsum("bshd,hdc->bshc", q_nope.to(torch.float32),
                         wkv_b[:, :nope].to(torch.float32)).to(x.dtype)
    kv = rms_norm(kv, lp["kv_norm"], cfg.rms_eps)

    if cache is not None:
        kv_cache, pe_cache = cache
        t_len = kv_cache.shape[1]
        tids = torch.arange(t_len, device=x.device)
        if per_slot:
            hit = (tids[None, :] == pos[:, None])[:, :, None]
            kv_cache.copy_(torch.where(hit, kv.to(kv_cache.dtype), kv_cache))
            pe_cache.copy_(torch.where(hit, k_pe.to(pe_cache.dtype),
                                       pe_cache))
            sids = pos.reshape(B, 1, 1, 1)
        else:
            kv_cache[:, pos:pos + S] = kv.to(kv_cache.dtype)
            pe_cache[:, pos:pos + S] = k_pe.to(pe_cache.dtype)
            sids = (torch.arange(S, device=x.device) + pos)[None, :, None,
                                                            None]
        kv_att = kv_cache.to(x.dtype)
        pe_att = pe_cache.to(x.dtype)
        att_mask = torch.where(tids[None, None, None, :] <= sids, 0.0, -1e9)
    else:
        kv_att, pe_att = kv, k_pe
        att_mask = mask[:, :, None, :]
    scores = (torch.einsum("bshc,btc->bsht", q_abs, kv_att)
              + torch.einsum("bshr,btr->bsht", q_pe, pe_att))
    # JAX multiplies by a weakly typed Python scalar: the scale is rounded
    # to the scores' dtype first
    scores = scores * torch.full((), cfg.softmax_scale, dtype=scores.dtype,
                                 device=scores.device)
    scores = scores.to(torch.float32) + att_mask
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o = torch.einsum("bsht,btc->bshc", probs, kv_att)
    o = torch.einsum("bshc,hdc->bshd", o.to(torch.float32),
                     wkv_b[:, nope:].to(torch.float32)).to(x.dtype)
    o = o.reshape(B, S, nh * cfg.v_head_dim)
    if stats is not None:
        stats["wo"] = _absmax(o, (0, 1))
    t = _trans(fqa, "wo_trans", quant)
    if t is not None:
        o = apply_decompose(t, o)
    return lin(o, "wo", "wo_lin", t)


def _ffn_lin(mode, quant, fq_cfg, fqf, x, w, use_kernel, st_key, qa):
    return _linear(mode, quant, fq_cfg, x, w, use_kernel,
                   fqf[st_key] if quant else None,
                   qa if quant and mode == "calib" else None)


def _ffn_dense(cfg, fq_cfg, mode, lp, fqf, x, use_kernel=True, stats=None):
    quant = mode != "fp" and fqf is not None
    h = x
    if stats is not None:
        stats["ffn_up"] = _absmax(h, (0, 1))
    t = _trans(fqf, "up_gate_trans", quant)
    if t is not None:
        h = apply_decompose(t, h)
    gate = _ffn_lin(mode, quant, fq_cfg, fqf, h, lp["w1"], use_kernel,
                    "w1_lin", t)
    up = _ffn_lin(mode, quant, fq_cfg, fqf, h, lp["w3"], use_kernel,
                  "w3_lin", t)
    act = silu(gate) * up
    if stats is not None:
        stats["ffn_down"] = _absmax(act, (0, 1))
    t = _trans(fqf, "down_trans", quant)
    if t is not None:
        act = apply_decompose(t, act)
    return _ffn_lin(mode, quant, fq_cfg, fqf, act, lp["w2"], use_kernel,
                    "w2_lin", t)


def _top_k(v, k):
    """jax.lax.top_k: the k largest along the last dim, descending, the
    lower index first among equal values."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def ds_gate(cfg: DeepSeekConfig, lp, x2d):
    """Routing weights and expert indices [T, K]: softmax or sigmoid
    scores, the gate bias (selection only), group limiting to the
    n_limited_groups best groups, top-K, sigmoid renormalization, then
    route_scale."""
    scores = x2d.to(torch.float32) @ lp["gate_w"].T.to(torch.float32)
    if cfg.score_func == "softmax":
        scores = torch.softmax(scores, dim=-1)
    else:
        scores = torch.sigmoid(scores)
    original = scores
    if "gate_b" in lp:
        scores = scores + lp["gate_b"].to(torch.float32)
    T, E = scores.shape
    if cfg.n_expert_groups > 1:
        g = cfg.n_expert_groups
        sg = scores.reshape(T, g, E // g)
        if "gate_b" in lp:
            group_scores = _top_k(sg, 2)[0].sum(dim=-1)
        else:
            group_scores = sg.amax(dim=-1)
        _, gidx = _top_k(group_scores, cfg.n_limited_groups)
        gmask = torch.zeros((T, g), dtype=torch.bool, device=x2d.device)
        gmask.scatter_(1, gidx, True)
        scores = torch.where(gmask[:, :, None], sg,
                             float("-inf")).reshape(T, E)
    _, indices = _top_k(scores, cfg.n_activated_experts)
    weights = torch.gather(original, -1, indices)
    if cfg.score_func == "sigmoid":
        weights = weights / weights.sum(dim=-1, keepdim=True)
    weights = weights * cfg.route_scale
    return weights, indices


def _expert_quant_linear(x_e, w_e, fq_cfg):
    """The packed int4 serving linear on the plain versions for every
    expert at once (JAX's vmap of `_quant_linear(..., use_kernel=False)`):
    x_e [E, T, K], {"wp" [E, N, K/2], "scale" [E, N], "a_clip" shared}.
    Per-token quant (or unit scales for weight-only), then the float32
    product of integer codes, which is exact, times x's and w's scales."""
    wp = w_e["wp"]
    w = torch.cat([(wp & 0xF).to(torch.int16) - 8,
                   (wp >> 4).to(torch.int16) - 8], dim=-1).to(torch.float32)
    if fq_cfg.a_cfg.enabled:
        xq, xs = quant_acts_i8_ref(x_e, w_e.get("a_clip"),
                                   fq_cfg.a_cfg.q_max)
    else:
        xq = x_e
        xs = torch.ones(x_e.shape[:-1] + (1,), dtype=torch.float32,
                        device=x_e.device)
    acc = xq.to(torch.float32) @ w.transpose(-1, -2)
    return (acc * xs * w_e["scale"][:, None, :]).to(x_e.dtype)


def _expert_linear(mode, quant, fq_cfg, x_e, w_e, use_kernel=True, st_e=None,
                   qa=None):
    """Batched-over-experts linear: x_e [E, T, in] (or broadcast over E),
    w_e [E, out, in] or its fp8 / packed dict. FP8: one fp8_linear call,
    one kernel launch for all experts (JAX's vmap of a pallas_call is one
    call). Packed int4: the plain versions, on the card too (as JAX). The
    fake-quant linear on raw weights is vmapped over the experts, as
    JAX's: each expert with its own weight clips st_e.clip_w_* [e], the
    activation clips shared."""
    if isinstance(w_e, dict) and "w8" in w_e:
        if quant:
            raise ValueError("a native-FP8 expert linear cannot compose "
                             "with FlatQuant transforms or quantizers")
        return fp8_linear(x_e, w_e, out_dtype=x_e.dtype,
                          use_kernel=use_kernel,
                          exact=getattr(fq_cfg, "fp8_exact", True))
    if isinstance(w_e, dict):
        return _expert_quant_linear(x_e, w_e, fq_cfg)
    if not quant:
        return torch.einsum("eti,eoi->eto", x_e, w_e.to(x_e.dtype))

    def one(x1, w1, cmax, cmin):
        st = LinearQuantState(clip_w_max=cmax, clip_w_min=cmin,
                              clip_a_max=st_e.clip_a_max,
                              clip_a_min=st_e.clip_a_min)
        return _linear(mode, quant, fq_cfg, x1, w1, use_kernel, st, qa)

    dims = 0 if st_e.clip_w_max is not None else None
    return torch.func.vmap(one, in_dims=(0, 0, dims, dims))(
        x_e, w_e, st_e.clip_w_max, st_e.clip_w_min)


def moe_dispatch(flat_e, capacity: int, n_experts: int):
    """Capacity dispatch bookkeeping. flat_e [N] expert id per (token, k)
    assignment -> (rank [N] int32, its place among its expert's
    assignments in order, keep [N] bool: rank < capacity). Stable sort,
    rank = offset from the expert's first place in sorted order."""
    n = flat_e.shape[0]
    sorted_e, perm = torch.sort(flat_e, stable=True)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank_sorted = torch.arange(n, device=flat_e.device) - first
    rank = torch.zeros(n, dtype=torch.int32, device=flat_e.device)
    rank[perm] = rank_sorted.to(torch.int32)
    return rank, rank < capacity


def _shared_experts(cfg, fq_cfg, mode, lp, fqf, h, quant, use_kernel):
    t1 = _trans(fqf, "w1_trans", quant)
    s_gate = _ffn_lin(mode, quant, fq_cfg, fqf, h, lp["s_w1"], use_kernel,
                      "s_w1_lin", t1)
    s_up = _ffn_lin(mode, quant, fq_cfg, fqf, h, lp["s_w3"], use_kernel,
                    "s_w3_lin", t1)
    s_act = silu(s_gate) * s_up
    t = _trans(fqf, "w2_trans", quant)
    if t is not None:
        s_act = apply_decompose(t, s_act)
    return _ffn_lin(mode, quant, fq_cfg, fqf, s_act, lp["s_w2"], use_kernel,
                    "s_w2_lin", t)


def _routed_experts(cfg, fq_cfg, mode, lp, fqf, x_e, quant, use_kernel,
                    stats=None):
    calib = quant and mode == "calib"

    def lin(inp, key, qa):
        return _expert_linear(mode, quant, fq_cfg, inp, lp[key], use_kernel,
                              fqf[key + "_lin"] if quant else None,
                              qa if calib else None)

    t1 = _trans(fqf, "w1_trans", quant)
    act_e = silu(lin(x_e, "e_w1", t1)) * lin(x_e, "e_w3", t1)
    if stats is not None:
        stats["moe_down"] = _absmax(act_e, (0, 1))
    t = _trans(fqf, "routed_w2_trans", quant)
    if t is not None:
        act_e = apply_decompose(t, act_e)
    return lin(act_e, "e_w2", t)


def _ffn_moe_gathered(cfg, fq_cfg, mode, lp, fqf, x,
                      capacity_factor: float = 2.0, use_kernel=True):
    """Capacity-gather MoE: tokens go into [E, C, D] expert buffers
    (C = ceil(T*K/E * capacity_factor); assignments past C go to a spill
    slot and drop silently), the experts run batched over their C slots,
    and each token sums its K weighted outputs in assignment order (k = 0
    first, float32, as JAX's scatter-add on the CPU), not by atomics."""
    B, S, D = x.shape
    quant = mode != "fp" and fqf is not None
    x2d = x.reshape(-1, D)
    T = x2d.shape[0]
    E, K = cfg.n_routed_experts, cfg.n_activated_experts
    C = max(1, int(np.ceil(T * K / E * capacity_factor)))

    weights, indices = ds_gate(cfg, lp, x2d)
    h = x2d
    t = _trans(fqf, "w1_trans", quant)
    if t is not None:
        h = apply_decompose(t, h)

    flat_e = indices.reshape(-1)
    rank, keep = moe_dispatch(flat_e, C, E)
    tok_idx = torch.arange(T, device=x.device).repeat_interleave(K)
    # buffers flattened to [E*C + 1, D], the last row the spill slot
    dest = torch.where(keep, flat_e * C + rank, E * C)
    buf = torch.zeros((E * C + 1, h.shape[-1]), dtype=h.dtype,
                      device=x.device)
    buf[dest] = h[tok_idx]
    down_e = _routed_experts(cfg, fq_cfg, mode, lp, fqf,
                             buf[:E * C].view(E, C, -1), quant, use_kernel)

    gathered = down_e[flat_e, rank.clamp(0, C - 1)]  # [T*K, D]
    w_flat = torch.where(keep, weights.reshape(-1), 0.0)
    part = (gathered.to(torch.float32) * w_flat[:, None]).view(T, K, D)
    y = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for k in range(K):
        y = y + part[:, k]
    y = y.to(x.dtype)
    z = _shared_experts(cfg, fq_cfg, mode, lp, fqf, h, quant, use_kernel)
    return (y + z).reshape(B, S, D)


def _ffn_moe(cfg, fq_cfg, mode, lp, fqf, x, use_kernel=True, stats=None):
    """Dense-masked MoE: every expert on every token, outputs summed under
    the routing matrix [T, E] (drop-free). stats gets "moe_in" and
    "moe_down" (JAX records no statistic of the shared experts' down
    input, so w2_trans keeps its diag init)."""
    B, S, D = x.shape
    quant = mode != "fp" and fqf is not None
    x2d = x.reshape(-1, D)
    T = x2d.shape[0]
    E = cfg.n_routed_experts
    weights, indices = ds_gate(cfg, lp, x2d)
    route = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    route.scatter_add_(1, indices, weights)
    if stats is not None:
        stats["moe_in"] = _absmax(x2d, (0,))
    h = x2d
    t = _trans(fqf, "w1_trans", quant)
    if t is not None:
        h = apply_decompose(t, h)
    down_e = _routed_experts(cfg, fq_cfg, mode, lp, fqf,
                             h[None].expand(E, T, D), quant, use_kernel,
                             stats)
    y = torch.einsum("etd,te->td", down_e.to(torch.float32),
                     route).to(x.dtype)
    z = _shared_experts(cfg, fq_cfg, mode, lp, fqf, h, quant, use_kernel)
    return (y + z).reshape(B, S, D)


def ds_layer(cfg, fq_cfg, mode, lp, lfq, x, cos, sin, mask, moe: bool,
             cache=None, pos=0, use_kernel=True, with_stats: bool = False):
    """One layer: RMSNorm, MLA, residual; RMSNorm, dense FFN or MoE,
    residual. moe_impl "auto" takes the gather MoE in serve mode at
    B*S >= 256 tokens, the dense-masked MoE otherwise (and always for the
    statistics). with_stats: also return the per-channel absmax of every
    transform's input, keyed qkv, wqb, wo, ffn_up, ffn_down, moe_in,
    moe_down (the sq-style diag init's statistics)."""
    stats = {} if with_stats else None
    fqa = lfq["attn"] if lfq is not None else None
    fqf = lfq["ffn"] if lfq is not None else None
    h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    x = x + ds_mla(cfg, fq_cfg, mode, lp, fqa, h, cos, sin, mask,
                   cache=cache, pos=pos, use_kernel=use_kernel, stats=stats)
    h2 = rms_norm(x, lp["ffn_norm"], cfg.rms_eps)
    impl = cfg.moe_impl
    if impl == "auto":
        B, S, _ = x.shape
        impl = "gather" if mode == "serve" and B * S >= 256 else "dense"
    if not moe:
        out = x + _ffn_dense(cfg, fq_cfg, mode, lp, fqf, h2, use_kernel,
                             stats)
    elif impl == "gather" and stats is None:
        out = x + _ffn_moe_gathered(cfg, fq_cfg, mode, lp, fqf, h2,
                                    cfg.moe_capacity_factor, use_kernel)
    else:
        out = x + _ffn_moe(cfg, fq_cfg, mode, lp, fqf, h2, use_kernel, stats)
    return (out, stats) if with_stats else out


def _layers(cfg, fq_cfg, mode, params, fq, x, cos, sin, mask, cache, pos,
            use_kernel, n_fp_tail=0):
    dense_fq, moe_fq = fq if fq is not None else (None, None)
    for i, lp in enumerate(params["dense_layers"]):
        c = None if cache is None else (cache["dense_kv"][i],
                                        cache["dense_pe"][i])
        x = ds_layer(cfg, fq_cfg, mode, lp, None if dense_fq is None
                     else dense_fq[i], x, cos, sin, mask, False, c, pos,
                     use_kernel)
    n_q = len(params["moe_layers"])
    if n_fp_tail > 0 and mode != "fp":
        n_q -= n_fp_tail
    for i, lp in enumerate(params["moe_layers"]):
        c = None if cache is None else (cache["moe_kv"][i],
                                        cache["moe_pe"][i])
        if i < n_q:
            x = ds_layer(cfg, fq_cfg, mode, lp, None if moe_fq is None
                         else moe_fq[i], x, cos, sin, mask, True, c, pos,
                         use_kernel)
        else:  # the full-precision tail
            x = ds_layer(cfg, None, "fp", lp, None, x, cos, sin, mask, True,
                         c, pos, use_kernel)
    return x


def _causal(S: int, dev):
    """[1, S, S] float32: 0 on and below the diagonal, -1e9 above."""
    return torch.where(torch.tril(torch.ones((S, S), dtype=torch.bool,
                                             device=dev)), 0.0, -1e9)[None]


@torch.no_grad()
def deepseek_forward(cfg: DeepSeekConfig, params, tokens, fq=None,
                     fq_cfg=None, mode: str = "fp",
                     compute_dtype=torch.bfloat16, n_fp_tail: int = 0,
                     use_kernel: bool = True, device="cuda"):
    """Full-sequence forward -> float32 logits [B, S, V]. fq: (dense_fq,
    moe_fq) lists of per-layer states, or None. mode "fp", "calib" / "eval"
    (raw weights with the fq state; "calib" with the baked state is
    DeepSeek's eval) or "serve" (packed int4 params with their baked fq,
    or native-FP8 params with fq=None); n_fp_tail > 0 runs the last n MoE
    layers in mode "fp"."""
    dev = resolve_device(device)
    tokens = _as_tokens(tokens, dev)
    B, S = tokens.shape
    x = params["embed"][tokens].to(compute_dtype)
    cos, sin = ds_rope_tables(cfg, S, dev)
    x = _layers(cfg, fq_cfg, mode, params, fq, x, cos, sin, _causal(S, dev),
                None, 0, use_kernel, n_fp_tail)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return (x @ params["head"].T.to(x.dtype)).to(torch.float32)


# ---------------------------------------------------------------------------
# generation over the MLA latent caches
# ---------------------------------------------------------------------------


def init_ds_cache(cfg: DeepSeekConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device="cuda") -> dict:
    """Latent caches, one zeroed tensor per layer, written in place:
    "*_kv" [B, max_len, kv_lora], "*_pe" [B, max_len, rope]."""
    dev = resolve_device(device)

    def mk(n, d):
        return [torch.zeros((batch, max_len, d), dtype=dtype, device=dev)
                for _ in range(n)]

    return {"dense_kv": mk(cfg.n_dense_layers, cfg.kv_lora_rank),
            "dense_pe": mk(cfg.n_dense_layers, cfg.qk_rope_head_dim),
            "moe_kv": mk(cfg.n_moe_layers, cfg.kv_lora_rank),
            "moe_pe": mk(cfg.n_moe_layers, cfg.qk_rope_head_dim)}


def _rope_rows(cfg, max_len, pos, S, dev):
    cos_full, sin_full = ds_rope_tables(cfg, max_len, dev)
    if torch.is_tensor(pos) and pos.dim() == 1:
        return cos_full[pos], sin_full[pos]
    return cos_full[pos:pos + S], sin_full[pos:pos + S]


@torch.no_grad()
def _ds_step(cfg, fq_cfg, mode, params, fq, tokens, cache, pos, max_len,
             compute_dtype=torch.bfloat16, use_kernel=True):
    """One prefill or decode step at scalar pos over the latent caches ->
    (last-token float32 logits [B, V], cache)."""
    B, S = tokens.shape
    x = params["embed"][tokens].to(compute_dtype)
    cos, sin = _rope_rows(cfg, max_len, pos, S, x.device)
    x = _layers(cfg, fq_cfg, mode, params, fq, x, cos, sin, None, cache, pos,
                use_kernel)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.rms_eps)
    logits = x[:, 0] @ params["head"].T.to(x.dtype)
    return logits.to(torch.float32), cache


@torch.no_grad()
def deepseek_generate(cfg: DeepSeekConfig, params, fq, fq_cfg, prompt,
                      max_new_tokens: int = 16, max_len: int = 128,
                      mode: str = "calib", compute_dtype=torch.bfloat16,
                      use_kernel: bool = True, device="cuda"):
    """Greedy generation over the absorbed-MLA latent caches -> int tokens
    [B, max_new_tokens] (numpy)."""
    dev = resolve_device(device)
    prompt = _as_tokens(prompt, dev)
    B, S = prompt.shape
    cache = init_ds_cache(cfg, B, max_len, dtype=compute_dtype, device=dev)
    step = functools.partial(_ds_step, cfg, fq_cfg, mode, params, fq,
                             max_len=max_len, compute_dtype=compute_dtype,
                             use_kernel=use_kernel)
    logits, cache = step(prompt, cache, 0)
    tok = logits.argmax(-1, keepdim=True)
    out = []
    for i in range(max_new_tokens):
        out.append(tok.cpu().numpy())
        logits, cache = step(tok, cache, S + i)
        tok = logits.argmax(-1, keepdim=True)
    return np.concatenate(out, axis=1).astype(np.int32)


# ---------------------------------------------------------------------------
# serving params
# ---------------------------------------------------------------------------


def build_ds_fp8_serving_layer(cfg: DeepSeekConfig, lp: dict, moe: bool,
                               dtype=torch.bfloat16) -> dict:
    """One layer of build_ds_fp8_serving_params: every linear that
    `_linear` applies becomes a block-scaled {"w8", "se"} dict (the expert
    stacks one dict each, quantized expert by expert); wkv_b stays dense
    in `dtype`; norms and the gate in float32."""
    attn = ["wkv_a", "wo"] + (["wq_a", "wq_b"] if cfg.q_lora_rank > 0
                              else ["wq"])
    keys = attn + (["s_w1", "s_w2", "s_w3", "e_w1", "e_w2", "e_w3"] if moe
                   else ["w1", "w2", "w3"])
    out = {}
    for k, v in lp.items():
        if k in keys:
            out[k] = prep_fp8_weight(v)
        elif k.endswith("norm") or k.startswith("gate"):
            out[k] = v.to(torch.float32)
        else:
            out[k] = v.to(dtype)
    return out


def build_ds_fp8_serving_params(cfg: DeepSeekConfig, params: dict,
                                dtype=torch.bfloat16) -> dict:
    """Native-FP8 serving params from a bf16/f32 param tree, requantized
    blockwise (fp8_block_quantize, 128-blocks where they divide the
    weight); serve with deepseek_forward(..., fq=None, mode="serve")."""
    return {
        "embed": params["embed"].to(dtype),
        "final_norm": params["final_norm"].to(torch.float32),
        "head": params["head"].to(dtype),
        "dense_layers": [build_ds_fp8_serving_layer(cfg, lp, False, dtype)
                         for lp in params["dense_layers"]],
        "moe_layers": [build_ds_fp8_serving_layer(cfg, lp, True, dtype)
                       for lp in params["moe_layers"]],
    }


def _pack(w, st, qa, fq_cfg):
    """One weight [out, in] with its transform qa and LWC clips folded in
    (float32), quantized per output channel and packed planar int4."""
    wt = transform_weight(w, st, qa, None, fq_cfg.lwc)
    scale, zero = weight_find_params(wt, fq_cfg.w_cfg)
    q = weight_quantize_int(wt, scale, zero, fq_cfg.w_cfg)
    return pack_weight_planar(q), scale[:, 0].to(torch.float32)


def _packed(w, st, qa, fq_cfg):
    """{"wp", "scale"[, "a_clip"]} of one linear; an expert stack [E, out,
    in] packs expert by expert with its own weight clips and shares the
    activation clips."""
    if w.dim() == 3:
        def clip(c, e):
            return None if c is None else c[e]

        packs = [_pack(w[e], LinearQuantState(clip(st.clip_w_max, e),
                                              clip(st.clip_w_min, e),
                                              None, None), qa, fq_cfg)
                 for e in range(w.shape[0])]
        d = {"wp": torch.stack([p[0] for p in packs]),
             "scale": torch.stack([p[1] for p in packs])}
    else:
        wp, scale = _pack(w, st, qa, fq_cfg)
        d = {"wp": wp, "scale": scale}
    if st is not None and st.clip_a_max is not None:
        d["a_clip"] = (_clip_sigmoid(st.clip_a_max),
                       _clip_sigmoid(st.clip_a_min))
    return d


# the transform folded into each packed weight, by weight key
_ATTN_QA = {"wq": "qkv_trans", "wq_a": "qkv_trans", "wkv_a": "qkv_trans",
            "wq_b": "wqb_trans", "wo": "wo_trans"}
_FFN_QA = {"w1": "up_gate_trans", "w3": "up_gate_trans", "w2": "down_trans",
           "s_w1": "w1_trans", "s_w3": "w1_trans", "e_w1": "w1_trans",
           "e_w3": "w1_trans", "s_w2": "w2_trans", "e_w2": "routed_w2_trans"}


def build_ds_serving_layer(cfg: DeepSeekConfig, fq_cfg, lp: dict,
                           baked_lfq: dict, dtype=torch.bfloat16) -> dict:
    """One layer of build_ds_serving_params: every linear `_linear` applies
    packed with its baked transform and clips (wq / wq_a's state is
    "wq_a_lin"); wkv_b in `dtype`; the norms and the gate as they are."""
    out = dict(lp)
    for key, v in lp.items():
        if key in _ATTN_QA:
            part, qa = baked_lfq["attn"], _ATTN_QA[key]
            st_key = "wq_a_lin" if key == "wq" else key + "_lin"
        elif key in _FFN_QA:
            part, qa = baked_lfq["ffn"], _FFN_QA[key]
            st_key = key + "_lin"
        else:
            continue
        out[key] = _packed(v, part[st_key], part[qa], fq_cfg)
    out["wkv_b"] = lp["wkv_b"].to(dtype)
    return out


def build_ds_serving_params(cfg: DeepSeekConfig, fq_cfg, params: dict,
                            dense_fq, moe_fq, dtype=torch.bfloat16,
                            perm_transforms: bool = False):
    """Pack every quantized DeepSeek linear to planar int4 + scales with
    its transform and LWC clips folded in; the baked transforms stay in
    the returned state for the activation side. wkv_b stays unquantized
    (deepseekv3_utils.py:171). Packs layer by layer, on the device that
    holds params. Returns (serving params, (baked_dense, baked_moe));
    serve with deepseek_forward(cfg, sp, toks, fq=baked, fq_cfg=fq_cfg,
    mode="serve")."""
    w_cfg = fq_cfg.w_cfg
    if not (w_cfg.sym and w_cfg.group_size <= 0):
        raise ValueError("packed DeepSeek serving takes symmetric per-channel "
                         "weights")
    baked_dense, baked_moe = bake_ds_fq(dense_fq, moe_fq, perm_transforms)
    sp = {
        "embed": params["embed"].to(dtype),
        "final_norm": params["final_norm"].to(torch.float32),
        "head": params["head"].to(dtype),
        "dense_layers": [build_ds_serving_layer(cfg, fq_cfg, lp, b, dtype)
                         for lp, b in zip(params["dense_layers"],
                                          baked_dense)],
        "moe_layers": [build_ds_serving_layer(cfg, fq_cfg, lp, b, dtype)
                       for lp, b in zip(params["moe_layers"], baked_moe)],
    }
    return sp, (baked_dense, baked_moe)


# ---------------------------------------------------------------------------
# bake / labels / diag init / calibration
# ---------------------------------------------------------------------------

_TRANSFORMS = ("qkv_trans", "wqb_trans", "wo_trans", "up_gate_trans",
               "down_trans", "w1_trans", "w2_trans", "routed_w2_trans")


def _bake_layer(lfq: dict, perm: bool) -> dict:
    return {part: {k: (bake_decompose(v, perm=perm)
                       if k in _TRANSFORMS and v is not None else v)
                   for k, v in d.items()} for part, d in lfq.items()}


def bake_ds_fq(dense_fq, moe_fq, perm_transforms: bool = False):
    """Freeze every transform (FlatQuantMLA.reparameterize only calls
    to_eval_mode, deepseekv3_utils.py:283-296: weights are quantized on
    the fly, so DeepSeek's eval is mode="calib" with baked transforms).
    perm_transforms=True marks each baked transform with the transposed-
    output layout. Returns (dense, moe) state lists of the same layout."""
    def bake(layers):
        return None if layers is None else [
            _bake_layer(lfq, perm_transforms) for lfq in layers]

    return bake(dense_fq), bake(moe_fq)


def build_ds_labels(layer_fq: dict) -> dict:
    """Param-group labels (trans | diag | clip_w | clip_a) for one layer."""
    from flatquant_torch.calib.trainer import _label_decompose, _label_linear

    def lab(k, v):
        if v is None:
            return None
        return _label_decompose(v) if k in _TRANSFORMS else _label_linear(v)

    return {part: {k: lab(k, v) for k, v in d.items()}
            for part, d in layer_fq.items()}


def ds_sq_init_diag(cfg: DeepSeekConfig, lp, layer_fq, stats, alpha: float):
    """sq-style diag init of one layer's transforms (init_diag_scale
    analog), each from the absmax of the weights it feeds and its input
    statistic; a transform without a statistic keeps its diag (the shared
    experts' down: JAX records no "moe_s_down")."""
    from flatquant_torch.calib.trainer import _get_init_scale

    def upd(trans, ws, key):
        if trans is None or trans.diag_scale is None or key not in stats:
            return trans
        w_smax = torch.cat([w.to(torch.float32) for w in ws], 0).abs()
        return dataclasses.replace(trans, diag_scale=_get_init_scale(
            w_smax.amax(0), stats[key].to(torch.float32), alpha))

    a = dict(layer_fq["attn"])
    qkv = [lp["wkv_a"], lp["wq_a"] if "wq_a" in lp else lp["wq"]]
    a["qkv_trans"] = upd(a["qkv_trans"], qkv, "qkv")
    if a["wqb_trans"] is not None:
        a["wqb_trans"] = upd(a["wqb_trans"], [lp["wq_b"]], "wqb")
    a["wo_trans"] = upd(a["wo_trans"], [lp["wo"]], "wo")
    f = dict(layer_fq["ffn"])
    if not is_moe_fq(layer_fq):
        f["up_gate_trans"] = upd(f["up_gate_trans"], [lp["w1"], lp["w3"]],
                                 "ffn_up")
        f["down_trans"] = upd(f["down_trans"], [lp["w2"]], "ffn_down")
        return {"attn": a, "ffn": f}
    f["w1_trans"] = upd(f["w1_trans"], [
        lp["s_w1"], lp["s_w3"], lp["e_w1"].reshape(-1, cfg.dim),
        lp["e_w3"].reshape(-1, cfg.dim)], "moe_in")
    f["w2_trans"] = upd(f["w2_trans"], [lp["s_w2"]], "moe_s_down")
    f["routed_w2_trans"] = upd(f["routed_w2_trans"], [
        lp["e_w2"].reshape(-1, cfg.moe_inter_dim)], "moe_down")
    return {"attn": a, "ffn": f}


def calibrate_deepseek(cfg: DeepSeekConfig, fq_cfg, params, dense_fq, moe_fq,
                       train_tokens, compute_dtype=None, log=print,
                       save_cb=None, epochs=None, skip_last: int = 0,
                       history: Optional[list] = None):
    """Layer-wise DeepSeek calibration (main_dpskv3.py cali_flat_quant
    analog) on the device that holds params: the dense layers first, then
    the MoE layers from the dense layers' fp outputs (recomputed),
    leaving the last `skip_last` MoE layers at their init (the
    --v3_not_last analog). save_cb(i, (dense_fq, moe_fq)) after each MoE
    layer. Returns (dense_fq, moe_fq)."""
    from flatquant_torch.calib.trainer import (
        calibrate_layers,
        capture_embeddings,
    )

    if compute_dtype is None:
        compute_dtype = torch.float32 if fq_cfg.deactive_amp \
            else torch.bfloat16
    dev = params["embed"].device
    nsamples, seqlen = np.asarray(train_tokens).shape
    cos, sin = ds_rope_tables(cfg, seqlen, dev)
    mask = _causal(seqlen, dev)
    inps = capture_embeddings(cfg, params, train_tokens, compute_dtype)

    def mk_fns(moe: bool):
        def fp_fn(lp, x):
            return ds_layer(cfg, None, "fp", lp, None, x, cos, sin, mask,
                            moe, with_stats=True)

        def calib_fn(fq_l, lp, x):
            return ds_layer(cfg, fq_cfg, "calib", lp, fq_l, x, cos, sin, mask,
                            moe)

        return fp_fn, calib_fn

    def diag_init(lp, fq_l, stats):
        return ds_sq_init_diag(cfg, lp, fq_l, stats, fq_cfg.diag_alpha)

    fp_fn, calib_fn = mk_fns(False)
    dense_fq = calibrate_layers(
        fq_cfg, params["dense_layers"], dense_fq, inps, fp_fn, calib_fn,
        build_ds_labels(dense_fq[0]), num_layers=cfg.n_dense_layers,
        diag_init_fn=diag_init, log=lambda m: log("dense " + m),
        epochs=epochs, history=history)
    # the MoE layers' inputs: the dense layers' fp outputs
    cur = inps
    with torch.no_grad():
        for lp in params["dense_layers"]:
            cur = torch.cat([fp_fn(lp, cur[j:j + fq_cfg.cali_bsz])[0]
                             for j in range(0, nsamples, fq_cfg.cali_bsz)])
    fp_fn, calib_fn = mk_fns(True)
    moe_fq = calibrate_layers(
        fq_cfg, params["moe_layers"], moe_fq, cur, fp_fn, calib_fn,
        build_ds_labels(moe_fq[0]),
        num_layers=cfg.n_moe_layers - skip_last, diag_init_fn=diag_init,
        log=lambda m: log("moe " + m),
        save_cb=(lambda i, st: save_cb(i, (dense_fq, st))) if save_cb
        else None, epochs=epochs, history=history)
    return dense_fq, moe_fq


# ---------------------------------------------------------------------------
# the continuous batcher's engine hooks (serving/batcher.py)
# ---------------------------------------------------------------------------


def ds_init_batch_cache(cfg: DeepSeekConfig, batch: int, max_len: int,
                        dtype=torch.bfloat16, mode: str = "bf16",
                        device="cuda") -> dict:
    """Batcher cache hook: the latent caches in `dtype`. DeepSeek serves
    its latents unquantized only, so mode must be "bf16" (the cache mode's
    name; the dtype is the compute dtype)."""
    if mode != "bf16":
        raise ValueError(f"DeepSeek serves the unquantized latent cache "
                         f"only (cache mode 'bf16'), not {mode!r}")
    return init_ds_cache(cfg, batch, max_len, dtype=dtype, device=device)


@torch.no_grad()
def ds_batch_forward(cfg: DeepSeekConfig, fq_cfg, spfq, tokens, cache, pos,
                     phase, use_kernel, max_len, compute_dtype=torch.bfloat16,
                     last_idx=None, mode: str = "serve"):
    """Batcher forward hook with the port's `_forward` signature: prefill
    and chunk at a scalar pos, decode at a scalar or per-slot [B] pos, over
    the latent caches (written in place) -> float32 logits [B, V] of the
    last (or last_idx) token. spfq = {"params": serving params, "fq":
    (dense_fq, moe_fq) or None}. `phase` is not read: the cache, the
    position and moe_impl "auto" decide the route, as in JAX."""
    sp, fq = spfq["params"], spfq["fq"]
    B, S = tokens.shape
    x = sp["embed"][tokens].to(compute_dtype)
    cos, sin = _rope_rows(cfg, max_len, pos, S, x.device)
    x = _layers(cfg, fq_cfg, mode, sp, fq, x, cos, sin, None, cache, pos,
                use_kernel)
    x = rms_norm(x, sp["final_norm"], cfg.rms_eps)
    h = (x[:, -1] if last_idx is None
         else x[torch.arange(B, device=x.device), last_idx])
    return (h @ sp["head"].T.to(x.dtype)).to(torch.float32)
