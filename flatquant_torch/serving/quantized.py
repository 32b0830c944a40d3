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

What differs from JAX: `build_serving_params` takes each layer's baked
transform matrices and sigmoid-applied clip ratios directly (the values
JAX reads out of its FQ state through decompose_matrices / single_matrix /
_clip_sigmoid); the FQ-state objects arrive with the build chain (ROADMAP
queue 1 item 4). Only merge_projections=True, tp=1, perm_transforms=False
is ported: the default merge_projections=False is JAX's and raises until
item 4, so callers pass merge_projections=True.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from flatquant_torch.core.quant import (
    true_div,
    weight_find_params,
    weight_quantize_int,
)
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
from flatquant_torch.quantize.spec import FQConfig

# minimum input width at which JAX routes per-token act quant through the
# Pallas quant_acts_i8 kernel at T >= 256 rows (quantized.py:316)
PALLAS_QUANT_MIN_K = 8192


# ---------------------------------------------------------------------------
# conversion: baked fp model -> packed serving params
# ---------------------------------------------------------------------------


def _pack_linear(w: torch.Tensor, w_cfg) -> Dict[str, Any]:
    """fp weight [out, in] -> packed codes + per-channel scale (RTN
    against the per-channel absmax scale): w_bits 4 gives {"wp": planar
    int4 [out, in/2] uint8, "scale": f32 [out]}, w_bits 8 {"w8": int8
    codes [out, in], "scale"}."""
    scale, zero = weight_find_params(w, w_cfg)
    q = weight_quantize_int(w, scale, zero, w_cfg)
    if w_cfg.bits == 8:
        return {"w8": q, "scale": scale[:, 0].contiguous()}
    return {"wp": pack_weight_planar(q), "scale": scale[:, 0].contiguous()}


def _interleave_rows(ws, tp: int):
    """Merged-projection row order; at tp=1 a plain concatenation
    [a; b; ...] (tp > 1 interleaves per-shard blocks, ROADMAP queue 1
    item 9)."""
    if tp != 1:
        raise NotImplementedError("tp > 1 waits for ROADMAP queue 1 item 9")
    return torch.cat(ws, dim=0)


def _ratio_pair(pair, device):
    return tuple(torch.as_tensor(c, dtype=torch.float32, device=device)
                 .reshape(1) for c in pair)


def build_serving_layer(cfg: LlamaConfig, fq_cfg: FQConfig, lp: dict,
                        lt: dict, dtype=torch.bfloat16,
                        merge_projections: bool = False, tp: int = 1,
                        perm_transforms: bool = False) -> dict:
    """Pack one baked layer (the per-layer body of JAX's
    build_serving_params, quantized.py:161-261).

    lp: baked fp weights {"ln1_w", "ln2_w", "wq", "wk", "wv", "wo",
    "wup", "wgate", "wdown"[, "bq", "bk", "bv"]}, [out, in] layout.
    lt: the layer's baked transforms and clip ratios:
      "ln_t", "ug_t", "down_t": (left, right) Kronecker factors
      "o_t": [g, g] head mixing; "k_t", "k_t_inv" [hd, hd] (absent
      without k/q quant: no kcache transform); "v_t_inv" [hd, hd]
      (optional)
      "a_clip": {"qkv"|"o"|"upgate"|"down": (rmax, rmin)} (absent in a
      weight-only model)
      "kc_clip", "vc_clip": (cmax, cmin) (optional)
    Clip values are the sigmoid-applied ratios, not the raw factors."""
    w_cfg = fq_cfg.w_cfg
    if not (w_cfg.sym and w_cfg.group_size <= 0):
        raise NotImplementedError(
            "real-quant path supports symmetric per-channel weights only")
    if w_cfg.bits not in (4, 8):
        raise ValueError(f"real-quant weights are int4 or int8, not "
                         f"{w_cfg.bits} bits")
    if not merge_projections or perm_transforms:
        raise NotImplementedError(
            "merge_projections=False and perm_transforms=True wait for "
            "ROADMAP queue 1 item 4")
    out = {
        "ln1_w": lp["ln1_w"].to(torch.float32),
        "ln2_w": lp["ln2_w"].to(torch.float32),
    }
    for key in ("ln_t", "ug_t", "down_t"):
        if lt.get(key) is not None:
            left, right = lt[key]
            out[key] = (left.to(dtype), right.to(dtype))
    if lt.get("o_t") is not None:
        out["o_t"] = lt["o_t"].to(dtype)

    out["qkv"] = _pack_linear(
        _interleave_rows([lp["wq"], lp["wk"], lp["wv"]], tp), w_cfg)
    out["upgate"] = _pack_linear(
        _interleave_rows([lp["wup"], lp["wgate"]], tp), w_cfg)
    out["o"] = _pack_linear(lp["wo"], w_cfg)
    out["down"] = _pack_linear(lp["wdown"], w_cfg)
    if lp.get("bq") is not None:
        out["bqkv"] = _interleave_rows(
            [lp["bq"], lp["bk"], lp["bv"]], tp).to(torch.float32)

    for key in ("k_t", "k_t_inv", "v_t_inv"):
        if lt.get(key) is not None:
            out[key] = lt[key].to(dtype)
    dev = lp["wq"].device
    for nm, pair in (lt.get("a_clip") or {}).items():
        out[nm]["a_clip"] = _ratio_pair(pair, dev)
    for key in ("kc_clip", "vc_clip"):
        if lt.get(key) is not None:
            out[key] = _ratio_pair(lt[key], dev)
    return out


def build_serving_params(cfg: LlamaConfig, fq_cfg: FQConfig,
                         baked_params: dict, transforms: list,
                         dtype=torch.bfloat16, merge_projections: bool = False,
                         tp: int = 1, perm_transforms: bool = False) -> dict:
    """Convert a baked (bake_model, NOT rtn-quantized) model into the
    packed serving format: {"embed", "final_norm_w", "lm_head",
    "layers": [per-layer dict]}. baked_params["layers"] is a list of
    per-layer weight dicts and `transforms` the matching list of lt dicts
    (see build_serving_layer)."""
    layers = [build_serving_layer(cfg, fq_cfg, lp, lt, dtype,
                                  merge_projections, tp, perm_transforms)
              for lp, lt in zip(baked_params["layers"], transforms)]
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


def _quant_linear(x2d, lin, use_kernel: bool, out_dtype=torch.bfloat16,
                  quant_acts: bool = True, a_q_max: int = 7,
                  axis_name: Optional[str] = None):
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
    version. The scale rule is a_q_max = 7 (A4) or 127 (A8)."""
    if axis_name is not None:
        raise NotImplementedError("tp waits for ROADMAP queue 1 item 9")
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
    if (use_kernel and x2d.shape[0] >= 256
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
    if right.shape[0] != 128:
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


def _mlp_full_qualifies(x2d, sl, a_q_max: int) -> bool:
    return ("upgate" in sl and "down" in sl and "down_t" in sl
            and "ug_t" in sl and "wp" in sl["upgate"] and "wp" in sl["down"]
            and x2d.shape[0] >= 256 and a_q_max == 7
            and sl["ug_t"][1].shape[0] == 128
            and sl["down_t"][1].shape[0] == 128)


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
