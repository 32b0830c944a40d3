"""Real-quant serving model: packed int4 or int8 weights + online
transforms (port of flatquant_tpu/serving/quantized.py).

A baked model converts once into
  - planar-packed int4 weights ("wp") or plain int8 codes ("w8") +
    per-out-channel f32 scales
  - fixed Kronecker / single transform matrices in the serving dtype
  - LAC clip factors as sigmoid-applied ratios
and each projection at serving time runs the eager glue (RMSNorm,
Kronecker transform, per-token quant) plus a quantized-weight GEMM.

`_quant_linear` takes JAX's branches in JAX's order: weight-only (W4A16
through w4a8_matmul with unit activation scales, W8A16 through a float
matmul of the int8 codes), the one-pass quant_acts_i8 kernel at T >= 256
rows and K >= 8192, else the eager per-token quant; then the int4 GEMM
(w4a4_matmul_i8) or, for "w8", an exact int8 x int8 -> int32 product.
`_quant_swiglu` takes the fused swiglu GEMM (w4a4_matmul_i8_swiglu) at
T >= 256 rows. The fused prefill routes of the rn128 split
(`_grouped_attn_in`, `_quant_mlp_grouped`, `_quant_mlp_grouped_full`) run
through the flat-pipeline kernels (kernels/flat_pipeline.py) under JAX's
qualifying conditions. `_grouped_layout_attn_in`, `_grouped_layout_mlp_full`
and `_grouped_layout_mlp_round2` compute the same functions on JAX's
superseded grouped layout (kernels/grouped_mlp.py); the engine never takes
them, a caller patches them in at `_grouped_attn_in` /
`_quant_mlp_grouped_full` to run those kernels on the serving path.

The build half takes JAX's inputs and layouts: `build_serving_params`
packs a baked model (quantize/bake.py bake_model) from its baked
LayerFQ list, in the merged (qkv, upgate) or the unmerged (q, k, v, up,
gate: JAX's default) layout, with or without the perm layouts
(perm_transforms: `kron_transform_perm` and the matching permutation of
the packed weights' input channels). `layer_transforms` reads one
layer's transform matrices and clip ratios out of its LayerFQ, and
`build_serving_layer` packs one layer from those (chip_smoke.py packs a
model from its own matrices through it). tp > 1 lays the packed weights
out per tensor-parallel shard (parallel/serving_tp.py cuts them), and
`_quant_linear(axis_name=...)` takes the global per-token extrema of a
row-parallel input over the tp ranks. `build_hadamard_serving_params`
packs the QuaRot baseline (fixed Hadamard rotations, core/hadamard.py)
in the unmerged layout.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from flatquant_torch.core.hadamard import get_hadK, hadamard_matrix
from flatquant_torch.core.kron import (
    get_decompose_dim,
    kronecker_matmul,
    kronecker_matmul_perm,
)
from flatquant_torch.core.quant import (
    true_div,
    weight_find_params,
    weight_quantize_int,
)
from flatquant_torch.core.transforms import decompose_matrices, single_matrix
from flatquant_torch.kernels.common import resolve_device
from flatquant_torch.kernels.flat_pipeline import (
    left_quant_i8_flat,
    rmsnorm_right_flat,
    w4a4_matmul_i8_swiglu_right,
)
from flatquant_torch.kernels.grouped_mlp import (
    left_quant_i8_grouped,
    quant_acts_i8_grouped,
    rmsnorm_right_grouped,
    w4a4_matmul_i8_grouped,
    w4a4_swiglu_grouped,
    w4a4_swiglu_grouped_gx,
)
from flatquant_torch.kernels.int4_matmul import (
    pack_weight_planar,
    quant_acts_i8,
    quant_acts_i8_ref,
    w4a4_matmul_i8,
    w4a4_matmul_i8_swiglu,
    w4a8_matmul,
    w4a8_matmul_ref,
)
from flatquant_torch.models.config import LlamaConfig
from flatquant_torch.models.llama import silu
from flatquant_torch.parallel.distributed import all_reduce
from flatquant_torch.quantize.spec import FQConfig

# minimum input width at which JAX routes per-token act quant through the
# Pallas quant_acts_i8 kernel at T >= 256 rows (quantized.py:316)
PALLAS_QUANT_MIN_K = 8192


# ---------------------------------------------------------------------------
# conversion: baked fp model -> packed serving params
# ---------------------------------------------------------------------------


def _pack_linear(w: torch.Tensor, w_cfg, w_q=None) -> Dict[str, Any]:
    """fp weight [out, in] -> packed codes + per-channel scale: w_bits 4
    gives {"wp": planar int4 [out, in/2] uint8, "scale": f32 [out]},
    w_bits 8 {"w8": int8 codes [out, in], "scale"}. `w` gives the scale
    (weight_find_params on the baked weight); `w_q`, when given, holds
    values already on that grid (rtn_quantize_params' output) whose codes
    are recovered exactly by rounding against the scale."""
    scale, zero = weight_find_params(w, w_cfg)
    q = weight_quantize_int(w if w_q is None else w_q, scale, zero, w_cfg)
    if w_cfg.bits == 8:
        return {"w8": q, "scale": scale[:, 0].contiguous()}
    return {"wp": pack_weight_planar(q), "scale": scale[:, 0].contiguous()}


def _pack_linear_rp(w, w_cfg, tp: int, w_q=None) -> Dict[str, Any]:
    """_pack_linear for a row-parallel weight (o, down) under tensor
    parallelism: planar int4 pairs channel c with c + K/2 over the whole
    row, which would give an input-channel shard channels it does not own;
    so each shard's K/tp block packs on its own and the byte dim splits
    into valid local packings (per-output-channel scales do not depend on
    the blocking; JAX quantized.py:91-105)."""
    if tp == 1 or w_cfg.bits == 8:
        return _pack_linear(w, w_cfg, w_q)
    scale, zero = weight_find_params(w, w_cfg)
    q = weight_quantize_int(w if w_q is None else w_q, scale, zero, w_cfg)
    kb = q.shape[1] // tp
    wp = torch.cat([pack_weight_planar(q[:, s * kb:(s + 1) * kb])
                    for s in range(tp)], dim=1)
    return {"wp": wp, "scale": scale[:, 0].contiguous()}


def _clip_sigmoid(c) -> Optional[torch.Tensor]:
    return None if c is None else torch.sigmoid(c.to(torch.float32))


def _interleave_rows(ws, tp: int):
    """Stack per-shard row blocks of several [out_i, ...] tensors: [a0,
    b0, ..., a1, b1, ...], so that cutting the merged out dim into tp
    blocks gives each shard its own contiguous [a_s; b_s; ...] (JAX
    quantized.py:75-88); a plain concatenation at tp = 1."""
    if tp == 1:
        return torch.cat(ws, dim=0)
    blocks = []
    for s in range(tp):
        for w in ws:
            o = w.shape[0] // tp
            blocks.append(w[s * o:(s + 1) * o])
    return torch.cat(blocks, dim=0)


def _perm_in_channels(w, ln: int, rn: int):
    """A weight's [out, in] input channels from the standard (i*rn+j) to
    the transposed (j*ln+i) order that kron_transform_perm emits, per
    ln*rn block (a shard-aligned transform of init_model_fq(tp=...) is
    block-diagonal, in = tp * ln * rn, and permutes block by block)."""
    out, ind = w.shape
    if ind % (ln * rn):
        raise ValueError(f"{ind} input channels do not tile {ln} x {rn}")
    return w.reshape(out, -1, ln, rn).transpose(2, 3).reshape(out, ind)


def _ratio_pair(pair, device):
    return tuple(torch.as_tensor(c, dtype=torch.float32, device=device)
                 .reshape(1) for c in pair)


# the linear whose activation clips each packed projection takes, in
# either layout (a merged projection takes its first branch's, as JAX's)
_CLIP_OF = {"qkv": "q_lin", "q": "q_lin", "k": "k_lin", "v": "v_lin",
            "o": "o_lin", "upgate": "up_lin", "up": "up_lin",
            "gate": "gate_lin", "down": "down_lin"}


def layer_transforms(layer_fq) -> dict:
    """The inputs of build_serving_layer read out of one layer's baked
    LayerFQ (quantize/state.py), as JAX's convert_layer reads them:
    "ln_t", "ug_t", "down_t" (decompose_matrices), "o_t", "k_t",
    "k_t_inv", "v_t_inv" (single_matrix), and the sigmoid-applied clip
    ratios "a_clip" {projection: (rmax, rmin)} for both layouts' names,
    "kc_clip", "vc_clip", "qc_clip". Absent entries are left out."""
    a, m = layer_fq.attn, layer_fq.mlp
    lt = {}
    for key, t in (("ln_t", a.ln_trans), ("ug_t", m.up_gate_trans),
                   ("down_t", m.down_trans)):
        if t is not None:
            lt[key] = decompose_matrices(t)
    if a.o_trans is not None:
        lt["o_t"] = single_matrix(a.o_trans)
    if a.kcache_trans is not None:
        lt["k_t"] = single_matrix(a.kcache_trans)
        lt["k_t_inv"] = single_matrix(a.kcache_trans, inv_t=True)
    if a.vcache_trans is not None:
        lt["v_t_inv"] = single_matrix(a.vcache_trans, inv_t=True)
    clips = {}
    for nm, key in _CLIP_OF.items():
        lin = getattr(a if hasattr(a, key) else m, key)
        if lin.clip_a_max is not None:
            clips[nm] = (_clip_sigmoid(lin.clip_a_max),
                         _clip_sigmoid(lin.clip_a_min))
    if clips:
        lt["a_clip"] = clips
    for nm, cq in (("kc", a.k_cache), ("vc", a.v_cache), ("qc", a.q_cache)):
        cmax = _clip_sigmoid(cq.clip_a_max)
        if cmax is not None:
            lt[nm + "_clip"] = (cmax, _clip_sigmoid(cq.clip_a_min))
    return lt


def build_serving_layer(cfg: LlamaConfig, fq_cfg: FQConfig, lp: dict,
                        lt: dict, dtype=torch.bfloat16,
                        merge_projections: bool = False, tp: int = 1,
                        perm_transforms: bool = False,
                        elp: Optional[dict] = None) -> dict:
    """Pack one baked layer (the per-layer body of JAX's
    build_serving_params, quantized.py:161-261).

    lp: baked fp weights {"ln1_w", "ln2_w", "wq", "wk", "wv", "wo",
    "wup", "wgate", "wdown"[, "bq", "bk", "bv"]}, [out, in] layout; elp:
    the same layer's on-grid weights (eval_params), whose codes are packed
    against lp's scales. lt: the layer's transforms and clip ratios
    (`layer_transforms`; any of them may be absent):
      "ln_t", "ug_t", "down_t": (left, right) Kronecker factors
      "o_t": [g, g] head mixing; "k_t", "k_t_inv", "v_t_inv" [hd, hd]
      "a_clip": {projection name: (rmax, rmin)}, the names of either
      layout (those the layout packs are used)
      "kc_clip", "vc_clip", "qc_clip": (cmax, cmin)
    Clip values are the sigmoid-applied ratios, not the raw factors.
    perm_transforms stores the Kronecker pairs as "ln_tp" / "ug_tp" /
    "down_tp" and o_t as "o_tp", and permutes the packed weights' input
    channels to the order those transforms emit.

    tp > 1 lays the weights out for tensor-parallel serving
    (parallel/serving_tp.py): merged projections interleave per-shard
    row blocks (_interleave_rows) and the row-parallel o / down pack per
    input-channel block (_pack_linear_rp), so cutting the out (resp.
    packed in) dim into tp blocks gives every rank a whole local layer.
    It needs shard-aligned transforms (init_model_fq(tp=tp)) and tp
    dividing the kv heads; the perm layout with tp > 1 is refused, as
    JAX's build_serving_params refuses it."""
    w_cfg = fq_cfg.w_cfg
    if not (w_cfg.sym and w_cfg.group_size <= 0):
        raise NotImplementedError(
            "real-quant path supports symmetric per-channel weights only")
    if w_cfg.bits not in (4, 8):
        raise ValueError(f"real-quant weights are int4 or int8, not "
                         f"{w_cfg.bits} bits")
    if tp > 1:
        if perm_transforms:
            raise NotImplementedError(
                "perm layout + tp not combined yet (as JAX's "
                "build_serving_params)")
        if (cfg.num_heads % tp or cfg.num_kv_heads % tp
                or cfg.intermediate_size % tp):
            raise ValueError(
                f"head-granular tp rule: tp={tp} must divide num_heads "
                f"{cfg.num_heads}, num_kv_heads {cfg.num_kv_heads} and "
                f"intermediate_size {cfg.intermediate_size}")
    same = elp is None or elp is lp
    elp = lp if same else elp
    out = {
        "ln1_w": lp["ln1_w"].to(torch.float32),
        "ln2_w": lp["ln2_w"].to(torch.float32),
    }
    pairs = {}
    for key in ("ln_t", "ug_t", "down_t"):
        if lt.get(key) is not None:
            left, right = lt[key]
            pairs[key] = (left.to(dtype), right.to(dtype))
            out[key[:-1] + "tp" if perm_transforms else key] = pairs[key]
    o_mat = None
    if lt.get("o_t") is not None:
        o_mat = lt["o_t"].to(dtype)
        out["o_tp" if perm_transforms else "o_t"] = o_mat

    def perm(w, key):
        pair = pairs.get(key)
        if not perm_transforms or pair is None:
            return w
        return _perm_in_channels(w, pair[0].shape[0], pair[1].shape[0])

    def perm_o(w):
        # the perm engine mixes heads into (group, d, i) channel order in
        # place of (group, i, d): swap the o weight's input channels
        if not perm_transforms or o_mat is None:
            return w
        g = o_mat.shape[0]
        od, ind = w.shape
        t = ind // (g * cfg.head_dim)
        return w.reshape(od, t, g, cfg.head_dim).transpose(2, 3).reshape(
            od, ind)

    def pack(ws, wqs, tkey):
        w = perm(_interleave_rows(ws, tp), tkey)
        wq = None if same else perm(_interleave_rows(wqs, tp), tkey)
        return _pack_linear(w, w_cfg, wq)

    def pack_rp(w, wq, permute):
        return _pack_linear_rp(permute(w), w_cfg, tp,
                               None if same else permute(wq))

    if merge_projections:
        for name, keys, tkey in (("qkv", ("wq", "wk", "wv"), "ln_t"),
                                 ("upgate", ("wup", "wgate"), "ug_t")):
            out[name] = pack([lp[k] for k in keys], [elp[k] for k in keys],
                             tkey)
        if lp.get("bq") is not None:
            out["bqkv"] = _interleave_rows(
                [lp["bq"], lp["bk"], lp["bv"]], tp).to(torch.float32)
    else:
        for name, key, tkey in (("q", "wq", "ln_t"), ("k", "wk", "ln_t"),
                                ("v", "wv", "ln_t"), ("up", "wup", "ug_t"),
                                ("gate", "wgate", "ug_t")):
            out[name] = pack([lp[key]], [elp[key]], tkey)
        for bkey in ("bq", "bk", "bv"):
            if lp.get(bkey) is not None:
                out[bkey] = lp[bkey].to(torch.float32)
    out["o"] = pack_rp(lp["wo"], elp["wo"], perm_o)
    out["down"] = pack_rp(lp["wdown"], elp["wdown"],
                          lambda w: perm(w, "down_t"))

    for key in ("k_t", "k_t_inv", "v_t_inv"):
        if lt.get(key) is not None:
            out[key] = lt[key].to(dtype)
    dev = lp["wq"].device
    for nm, pair in (lt.get("a_clip") or {}).items():
        if nm in out:
            out[nm]["a_clip"] = _ratio_pair(pair, dev)
    for key in ("kc_clip", "vc_clip", "qc_clip"):
        if lt.get(key) is not None:
            out[key] = _ratio_pair(lt[key], dev)
    return out


def build_serving_params(cfg: LlamaConfig, fq_cfg: FQConfig,
                         baked_params: dict, baked_fq: list,
                         dtype=torch.bfloat16,
                         merge_projections: bool = False,
                         eval_params: Optional[dict] = None,
                         perm_transforms: bool = False,
                         tp: int = 1) -> dict:
    """Convert a baked model (quantize/bake.py bake_model: params and the
    list of baked LayerFQ; NOT rtn-quantized) into the packed serving
    format {"embed", "final_norm_w", "lm_head", "layers": [per-layer
    dict]} (JAX's build_serving_params, quantized.py:109-271).

    merge_projections=True packs q/k/v into one GEMM and up/gate into
    another, each taking the q (resp. up) branch's activation clips; the
    default packs each projection alone, as JAX's default does.
    eval_params (rtn_quantize_params' output): the packed codes come from
    these on-grid weights, the scales from baked_params.
    perm_transforms=True stores the Kronecker transforms in the
    transposed-output form (kron_transform_perm) with the packed weights'
    input channels permuted to match. tp > 1: the tensor-parallel layout
    (build_serving_layer)."""
    eval_layers = (eval_params or baked_params)["layers"]
    layers = [build_serving_layer(cfg, fq_cfg, lp, layer_transforms(lfq),
                                  dtype, merge_projections, tp,
                                  perm_transforms, elp)
              for lp, lfq, elp in zip(baked_params["layers"], baked_fq,
                                      eval_layers)]
    head = baked_params.get("lm_head", baked_params["embed"])
    return {
        "embed": baked_params["embed"].to(dtype),
        "final_norm_w": baked_params["final_norm_w"].to(torch.float32),
        "lm_head": head.to(dtype),
        "layers": layers,
    }


# ---------------------------------------------------------------------------
# online ops
# ---------------------------------------------------------------------------


def kron_transform(x, left_right):
    """x [..., M*N] @ kron(left, right), in the matrices' dtype."""
    left, right = left_right
    shape = x.shape
    xm = x.reshape(-1, left.shape[0], right.shape[0]).to(left.dtype)
    xm = xm @ right
    xm = left.T @ xm
    return xm.reshape(shape)


def kron_transform_perm(x, left_right):
    """kron_transform with the output channels in the transposed (j*ln+i)
    order (core/kron.py kronecker_matmul_perm). Per-token quantization
    does not see the order, and the consuming packed weight's input
    channels were permuted to it at build time (_perm_in_channels)."""
    left, right = left_right
    return kronecker_matmul_perm(x.to(left.dtype), left, right)


# JAX's name of the eager per-token quant chain; the kernel module keeps
# it as quant_acts_i8's plain version
_act_codes_i8 = quant_acts_i8_ref


def _int8_matmul(xq, w8):
    """Exact int32 product of int8 codes xq [T, K] and w8 [N, K] (JAX's
    int8 dot with an int32 accumulation, which it leaves to XLA outside any
    Pallas kernel: a float32 sum is not exact at 127 * 127 * K). torch's
    int8 GEMM takes more than 16 rows, so a shorter xq is padded with zero
    rows."""
    t = xq.shape[0]
    if t <= 16:
        xq = torch.cat([xq, xq.new_zeros((17 - t, xq.shape[1]))])
    return torch._int_mm(xq.contiguous(), w8.T)[:t]


def _global_extrema(axis):
    """The per-token (max, min) of a row over every rank of `axis`, in one
    all-reduce: MAX of [max, -min] (negation is exact)."""
    def reduce(xmax, xmin):
        both = all_reduce(torch.cat([xmax, -xmin], dim=-1), "max", axis)
        return both[:, :1], -both[:, 1:]

    return reduce


def _quant_linear(x2d, lin, use_kernel: bool, out_dtype=torch.bfloat16,
                  quant_acts: bool = True, a_q_max: int = 7,
                  axis_name=None):
    """Per-token quant + quantized-weight matmul. x2d: [T, K] fp; returns
    [T, N]. JAX's branches, in its order:

    quant_acts=False (weight-only, W4A16 / W8A16): raw activations with
    unit activation scales: "wp" through w4a8_matmul on x cast to bf16
    (as JAX casts, whatever the compute dtype) with use_kernel, JAX's
    float32 w4a8_matmul_ref without; "w8" as a float32 matmul of the int8
    codes (exact products of bf16 or f32 values and int8 codes, float32
    sums).
    quant_acts: at T >= 256 rows, K >= PALLAS_QUANT_MIN_K and K % 128 == 0
    with use_kernel, the one-pass quant_acts_i8 kernel, else the eager
    chain (_act_codes_i8); then "w8" as an exact int8 x int8 -> int32
    product, or "wp" through w4a4_matmul_i8 (use_kernel) or its plain
    version. The scale rule is a_q_max = 7 (A4) or 127 (A8).

    axis_name: the mesh Axis (parallel/mesh.py) that shards THIS linear's
    input channels (the row-parallel o / down under tensor parallelism).
    The per-token [T, 1] max and min are then reduced over its ranks
    before the clip, so the codes equal single-device codes (JAX's pmax /
    pmin), and the one-pass quant kernel, whose extrema are shard-local,
    is not taken (as in JAX)."""
    w8 = lin.get("w8")
    if not quant_acts:
        if w8 is not None:
            y = x2d.to(torch.float32) @ w8.T.to(torch.float32)
            return (y * lin["scale"].reshape(1, -1)).to(out_dtype)
        ones = torch.ones((x2d.shape[0], 1), dtype=torch.float32,
                          device=x2d.device)
        if use_kernel:
            return w4a8_matmul(x2d.to(torch.bfloat16), ones, lin["wp"],
                               lin["scale"], out_dtype)
        return w4a8_matmul_ref(x2d, ones, lin["wp"], lin["scale"], out_dtype)
    clip = lin.get("a_clip")
    if axis_name is not None:
        xq, xs = _act_codes_i8(x2d, clip, a_q_max,
                               extrema=_global_extrema(axis_name))
    elif (use_kernel and x2d.shape[0] >= 256
            and x2d.shape[1] >= PALLAS_QUANT_MIN_K
            and x2d.shape[1] % 128 == 0):
        xq, xs = quant_acts_i8(x2d, clip=clip, q_max=a_q_max)
    else:
        xq, xs = _act_codes_i8(x2d, clip, a_q_max)
    if w8 is not None:
        acc = _int8_matmul(xq, w8)
        out = acc.to(torch.float32) * xs * lin["scale"].reshape(1, -1)
        return out.to(out_dtype)
    gemm = w4a4_matmul_i8 if use_kernel else w4a8_matmul_ref
    return gemm(xq, xs, lin["wp"], lin["scale"], out_dtype)


def _quant_swiglu(x2d, lin, use_kernel: bool, out_dtype=torch.bfloat16,
                  quant_acts: bool = True, a_q_max: int = 7):
    """silu(gate) * up for a merged up||gate projection (rows [0, N/2) =
    up, [N/2, N) = gate).

    With use_kernel, A4 codes, "wp" weights and T >= 256 rows: one GEMM
    with the SwiGLU in its float32 epilogue (w4a4_matmul_i8_swiglu), its
    input quantized by quant_acts_i8 at K >= PALLAS_QUANT_MIN_K (K % 128
    == 0), else by the eager chain. Otherwise the quantized linear, then
    silu(gate) * up in out_dtype."""
    if (use_kernel and quant_acts and "wp" in lin and x2d.shape[0] >= 256
            and a_q_max == 7):
        clip = lin.get("a_clip")
        if (x2d.shape[1] >= PALLAS_QUANT_MIN_K
                and x2d.shape[1] % 128 == 0):
            xq, xs = quant_acts_i8(x2d, clip=clip, q_max=a_q_max)
        else:
            xq, xs = _act_codes_i8(x2d, clip, a_q_max)
        return w4a4_matmul_i8_swiglu(xq, xs, lin["wp"], lin["scale"],
                                     out_dtype)
    y = _quant_linear(x2d, lin, use_kernel, out_dtype, quant_acts, a_q_max)
    up, gate = y.chunk(2, dim=-1)
    return silu(gate) * up


def _quant_mlp_grouped(x2d, sl, out_dtype=torch.bfloat16, a_q_max: int = 7):
    """Fused MLP tail on the flat pipeline: the upgate GEMM with silu and
    the down transform's right factor in its epilogue, the left factor +
    per-token quant, then the down GEMM. x2d: post-ln2/ug-transform hidden
    [T, K]. Returns the down output [T, H], or None when the shape or
    config does not qualify (the caller composes the standard path)."""
    if not ("upgate" in sl and "down" in sl and "down_t" in sl
            and "wp" in sl["upgate"] and "wp" in sl["down"]
            and x2d.shape[0] >= 256 and a_q_max == 7):
        return None
    left, right = sl["down_t"]
    if right.shape[0] != 128 or not _down_t_spans(sl):
        return None
    xq, xs = _act_codes_i8(x2d, sl["upgate"].get("a_clip"), a_q_max)
    ug = sl["upgate"]
    yf = w4a4_matmul_i8_swiglu_right(xq, xs, ug["wp"], ug["scale"], right)
    dn = sl["down"]
    zq, zs = left_quant_i8_flat(left.T, yf, clip=dn.get("a_clip"),
                                q_max=a_q_max)
    return w4a4_matmul_i8(zq, zs, dn["wp"], dn["scale"], out_dtype)


def _flat_ln_quant(x2d, ln_w, pair, clip, eps: float, a_q_max: int):
    """rms_norm + full Kronecker transform + per-token quant in two fused
    flat-layout kernels (the transform's right factor must be 128x128:
    the tpu_decompose calibration mode)."""
    left, right = pair
    hf = rmsnorm_right_flat(x2d, ln_w, right, eps)
    return left_quant_i8_flat(left.T, hf, clip=clip, q_max=a_q_max)


def _attn_in_qualifies(x2d, sl, a_q_max: int) -> bool:
    return ("qkv" in sl and "ln_t" in sl and "wp" in sl["qkv"]
            and x2d.shape[0] >= 256 and a_q_max == 7
            and sl["ln_t"][1].shape[0] == 128)


def _down_t_spans(sl) -> bool:
    """The down transform covers the whole intermediate. A shard-aligned
    one (init_model_fq(tp=...)) served on one device is block-diagonal,
    one block per tp shard: the composed kron_transform applies it so,
    the fused routes' left factor cannot (JAX's left_quant_i8_flat
    asserts there; the port declines the route instead)."""
    left, right = sl["down_t"]
    return left.shape[0] * right.shape[0] * 2 == sl["upgate"]["wp"].shape[0]


def _mlp_full_qualifies(x2d, sl, a_q_max: int) -> bool:
    return ("upgate" in sl and "down" in sl and "down_t" in sl
            and "ug_t" in sl and "wp" in sl["upgate"] and "wp" in sl["down"]
            and x2d.shape[0] >= 256 and a_q_max == 7
            and sl["ug_t"][1].shape[0] == 128
            and sl["down_t"][1].shape[0] == 128 and _down_t_spans(sl))


def _grouped_attn_in(x2d, sl, eps: float, out_dtype=torch.bfloat16,
                     a_q_max: int = 7):
    """Fused attention input path: ln1 + ln-transform + quant (flat
    pipeline) + the merged qkv W4A4 GEMM. Returns qkv
    [T, q_dim + 2*kv_dim], or None when the config does not qualify."""
    if not _attn_in_qualifies(x2d, sl, a_q_max):
        return None
    xq, xs = _flat_ln_quant(x2d, sl["ln1_w"], sl["ln_t"],
                            sl["qkv"].get("a_clip"), eps, a_q_max)
    return w4a4_matmul_i8(xq, xs, sl["qkv"]["wp"], sl["qkv"]["scale"],
                          out_dtype)


def _quant_mlp_grouped_full(x2d, sl, eps: float, out_dtype=torch.bfloat16,
                            a_q_max: int = 7):
    """End-to-end fused MLP: ln2 + ug-transform + quant, the swiglu upgate
    GEMM (+ down right factor), left factor + quant, the down GEMM, all on
    the flat pipeline. Needs both transforms' right factors 128x128.
    Returns the down output [T, H], or None."""
    if not _mlp_full_qualifies(x2d, sl, a_q_max):
        return None
    dn_l, dn_r = sl["down_t"]
    ug = sl["upgate"]
    dn = sl["down"]
    xq, xs = _flat_ln_quant(x2d, sl["ln2_w"], sl["ug_t"],
                            ug.get("a_clip"), eps, a_q_max)
    yf = w4a4_matmul_i8_swiglu_right(xq, xs, ug["wp"], ug["scale"], dn_r)
    zq, zs = left_quant_i8_flat(dn_l.T, yf, clip=dn.get("a_clip"),
                                q_max=a_q_max)
    return w4a4_matmul_i8(zq, zs, dn["wp"], dn["scale"], out_dtype)


# ---------------------------------------------------------------------------
# the same routes on the grouped layout [G, T, 128] (JAX's round-2
# pipeline, kernels/grouped_mlp.py): each kernel equals its flat twin on
# the same values, so the first two return what the flat routes return
# ---------------------------------------------------------------------------


def _grouped_layout_attn_in(x2d, sl, eps: float, out_dtype=torch.bfloat16,
                            a_q_max: int = 7):
    """_grouped_attn_in through rmsnorm_right_grouped ->
    left_quant_i8_grouped -> w4a4_matmul_i8_grouped."""
    if not _attn_in_qualifies(x2d, sl, a_q_max):
        return None
    left, right = sl["ln_t"]
    hg = rmsnorm_right_grouped(x2d, sl["ln1_w"], right, eps)
    xq, xs = left_quant_i8_grouped(left.T, hg, clip=sl["qkv"].get("a_clip"),
                                   q_max=a_q_max)
    return w4a4_matmul_i8_grouped(xq, xs, sl["qkv"]["wp"],
                                  sl["qkv"]["scale"], out_dtype)


def _grouped_layout_mlp_full(x2d, sl, eps: float, out_dtype=torch.bfloat16,
                             a_q_max: int = 7):
    """_quant_mlp_grouped_full through rmsnorm_right_grouped ->
    left_quant_i8_grouped -> w4a4_swiglu_grouped_gx ->
    left_quant_i8_grouped -> w4a4_matmul_i8_grouped."""
    if not _mlp_full_qualifies(x2d, sl, a_q_max):
        return None
    ug_l, ug_r = sl["ug_t"]
    dn_l, dn_r = sl["down_t"]
    ug, dn = sl["upgate"], sl["down"]
    hg = rmsnorm_right_grouped(x2d, sl["ln2_w"], ug_r, eps)
    xq, xs = left_quant_i8_grouped(ug_l.T, hg, clip=ug.get("a_clip"),
                                   q_max=a_q_max)
    yg = w4a4_swiglu_grouped_gx(xq, xs, ug["wp"], ug["scale"], dn_r)
    zq, zs = left_quant_i8_grouped(dn_l.T, yg, clip=dn.get("a_clip"),
                                   q_max=a_q_max)
    return w4a4_matmul_i8_grouped(zq, zs, dn["wp"], dn["scale"], out_dtype)


def _round2_mlp_tail(xq, xs, ug, dn, down_t, out_dtype=torch.bfloat16,
                     a_q_max: int = 7):
    """JAX's round-2 MLP tail on the upgate GEMM's codes xq [T, K]:
    w4a4_swiglu_grouped (with the down transform's right factor), the left
    factor as one bf16 product over the group axis (JAX computed it
    outside any kernel), quant_acts_i8_grouped, w4a4_matmul_i8_grouped.
    The left product sums in another order than left_quant_i8_flat's, so
    this is not the flat route's function bit for bit."""
    dn_l, dn_r = down_t
    yg = w4a4_swiglu_grouped(xq, xs, ug["wp"], ug["scale"], dn_r)
    g = yg.shape[0]
    zg = torch.matmul(dn_l.T.to(torch.bfloat16),
                      yg.reshape(g, -1)).reshape(yg.shape)
    zq, zs = quant_acts_i8_grouped(zg, clip=dn.get("a_clip"), q_max=a_q_max)
    return w4a4_matmul_i8_grouped(zq, zs, dn["wp"], dn["scale"], out_dtype)


def _grouped_layout_mlp_round2(x2d, sl, eps: float,
                               out_dtype=torch.bfloat16, a_q_max: int = 7):
    """_quant_mlp_grouped_full with the flat ln2 + quant
    (rmsnorm_right_flat, left_quant_i8_flat), then _round2_mlp_tail."""
    if not _mlp_full_qualifies(x2d, sl, a_q_max):
        return None
    ug = sl["upgate"]
    xq, xs = _flat_ln_quant(x2d, sl["ln2_w"], sl["ug_t"], ug.get("a_clip"),
                            eps, a_q_max)
    return _round2_mlp_tail(xq, xs, ug, sl["down"], sl["down_t"], out_dtype,
                            a_q_max)


def quantize_kv_asym(t, clip=None, q_max: int = 15):
    """Asym int per (token, head) over head_dim -> (float codes, scale,
    zero); packing happens at the cache layer."""
    tf = t.to(torch.float32)
    tmax = torch.clamp(tf.amax(dim=-1, keepdim=True), min=0.0)
    tmin = torch.clamp(tf.amin(dim=-1, keepdim=True), max=0.0)
    if clip is not None:
        tmax = tmax * clip[0]
        tmin = tmin * clip[1]
    degenerate = (tmin == 0) & (tmax == 0)
    tmin = torch.where(degenerate, -1.0, tmin)
    tmax = torch.where(degenerate, 1.0, tmax)
    scale = true_div(tmax - tmin, q_max)
    zero = torch.round(-tmin / scale)
    q = torch.clamp(torch.round(tf / scale) + zero, 0, q_max)
    return q, scale, zero


def dequantize_kv(q, scale, zero, dtype=torch.bfloat16):
    return ((q - zero) * scale).to(dtype)


# ---------------------------------------------------------------------------
# QuaRot-style Hadamard baseline (OnlineTrans(trans="had") analog)
# ---------------------------------------------------------------------------


def _from_f64(a, dtype, device) -> torch.Tensor:
    """A float64 numpy array rounded ONCE to `dtype`, as jnp.asarray casts
    (torch goes float64 -> float32 -> bf16 / f16, which can round twice).
    bf16 is rounded to nearest even on the float64 bits (normal range)."""
    a = np.asarray(a, np.float64)
    if dtype == torch.bfloat16:
        bits = a.view(np.uint64)
        drop = np.uint64(45)  # float64 keeps 52 mantissa bits, bf16 7
        bits = (bits + np.uint64((1 << 44) - 1) + ((bits >> drop)
                                                   & np.uint64(1)))
        a = (bits & ~np.uint64((1 << 45) - 1)).view(np.float64)
    elif dtype == torch.float16:
        a = a.astype(np.float16)
    elif dtype == torch.float32:
        a = a.astype(np.float32)
    return torch.as_tensor(a, device=device).to(dtype)


def hadamard_pair(n: int, dtype=torch.bfloat16, device="cuda"):
    """The normalized Kronecker pair (left, right) of an n-wide Hadamard
    rotation: (hadK / sqrt(K), H_{n/K} / sqrt(n/K)) from get_hadK, or for
    a power of two the balanced split's two Sylvester factors; each
    rounded once from float64 to `dtype`, on `device`."""
    dev = resolve_device(device)
    mat, k, _ = get_hadK(n)
    if k == 1:
        a, b = get_decompose_dim(n)
        fa, fb = hadamard_matrix(a)[0], hadamard_matrix(b)[0]
        return (_from_f64(fa / np.sqrt(a), dtype, dev),
                _from_f64(fb / np.sqrt(b), dtype, dev))
    m2 = n // k
    right = hadamard_matrix(m2)[0] / np.sqrt(m2)
    return (_from_f64(mat / np.sqrt(k), dtype, dev),
            _from_f64(right, dtype, dev))


def build_hadamard_serving_params(cfg: LlamaConfig, fq_cfg: FQConfig,
                                  params: dict,
                                  dtype=torch.bfloat16) -> dict:
    """QuaRot-style W4A4 serving model (JAX quantized.py:616-684): fixed
    Hadamard rotations in place of learned transforms, in the unmerged
    layout (q, k, v, up, gate apart). Orthonormal rotations are their own
    inverse transpose, so the weights fold (in float32) with the same
    dtype-rounded matrices the activations take online: ln_t / ug_t the
    hidden pair, down_t the intermediate pair, o_t the heads' Hadamard,
    k_t = k_t_inv = v_t_inv the head_dim's; v's output rows are rotated
    per head and o's input rows by kron(o_t, k_t). On the device that
    holds params."""
    w_cfg = fq_cfg.w_cfg
    dev = params["embed"].device
    hd = cfg.head_dim
    ln_pair = hadamard_pair(cfg.hidden_size, dtype, dev)
    down_pair = hadamard_pair(cfg.intermediate_size, dtype, dev)
    o_mat = _from_f64(hadamard_matrix(cfg.num_heads)[0]
                      / np.sqrt(cfg.num_heads), dtype, dev)
    k_mat = _from_f64(hadamard_matrix(hd)[0] / np.sqrt(hd), dtype, dev)
    k32 = k_mat.to(torch.float32)

    def kron_w(w, pair):
        left, right = pair
        return kronecker_matmul(w.to(torch.float32), left.to(torch.float32),
                                right.to(torch.float32))

    def convert_layer(lp):
        out = {"ln1_w": lp["ln1_w"].to(torch.float32),
               "ln2_w": lp["ln2_w"].to(torch.float32),
               "ln_t": ln_pair, "ug_t": ln_pair, "down_t": down_pair,
               "o_t": o_mat, "k_t": k_mat,
               "k_t_inv": k_mat,  # orthonormal: P^{-T} == P
               "v_t_inv": k_mat}
        # v's output rows take the per-head rotation (in JAX's order of
        # transposes); o undoes it on its input rows through kron(o, k)
        v_w = lp["wv"].to(torch.float32)
        v_w = (v_w.T.reshape(-1, hd) @ k32).reshape(
            v_w.shape[1], v_w.shape[0]).T
        for name, w in (("q", kron_w(lp["wq"], ln_pair)),
                        ("k", kron_w(lp["wk"], ln_pair)),
                        ("v", kron_w(v_w, ln_pair)),
                        ("o", kron_w(lp["wo"], (o_mat, k_mat))),
                        ("up", kron_w(lp["wup"], ln_pair)),
                        ("gate", kron_w(lp["wgate"], ln_pair)),
                        ("down", kron_w(lp["wdown"], down_pair))):
            out[name] = _pack_linear(w, w_cfg)
        for bkey in ("bq", "bk", "bv"):
            if lp.get(bkey) is not None:
                b = lp[bkey].to(torch.float32)
                if bkey == "bv":
                    b = (b.reshape(-1, hd) @ k32).reshape(-1)
                out[bkey] = b
        return out

    head = params.get("lm_head", params["embed"])
    return {"embed": params["embed"].to(dtype),
            "final_norm_w": params["final_norm_w"].to(torch.float32),
            "lm_head": head.to(dtype),
            "layers": [convert_layer(lp) for lp in params["layers"]]}
