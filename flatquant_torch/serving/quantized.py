"""Real-quant serving model: packed int4 weights + online transforms
(port of flatquant_tpu/serving/quantized.py, the decode-serving subset).

A baked model converts once into
  - planar-packed int4 weights + per-out-channel f32 scales
  - fixed Kronecker / single transform matrices in the serving dtype
  - LAC clip factors as sigmoid-applied ratios
and each projection at serving time runs the eager glue (RMSNorm,
Kronecker transform, per-token symmetric quant) plus the W4A4 GEMM kernel.

What differs from JAX: `build_serving_params` takes each layer's baked
transform matrices and sigmoid-applied clip ratios directly (the values
JAX reads out of its FQ state through decompose_matrices / single_matrix /
_clip_sigmoid); the FQ-state objects arrive with the build chain (ROADMAP
queue 1 item 4). Only merge_projections=True, tp=1, perm_transforms=False
is ported. The fused prefill routes that JAX takes at T >= 256 rows raise
NotImplementedError (ROADMAP queue 2, the long-prompt prefill slice).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from flatquant_torch.core.quant import weight_find_params, weight_quantize_int
from flatquant_torch.kernels.int4_matmul import (
    pack_weight_planar,
    w4a4_matmul_i8,
    w4a8_matmul_ref,
)
from flatquant_torch.models.config import LlamaConfig
from flatquant_torch.quantize.spec import FQConfig

LONG_PREFILL = ("ROADMAP queue 2 items 4-8 (the long-prompt prefill slice: "
                "the fused T >= 256 routes)")

# minimum input width at which JAX routes per-token act quant through the
# Pallas quant_acts_i8 kernel at T >= 256 rows (quantized.py:316)
PALLAS_QUANT_MIN_K = 8192


# ---------------------------------------------------------------------------
# conversion: baked fp model -> packed serving params
# ---------------------------------------------------------------------------


def _pack_linear(w: torch.Tensor, w_cfg) -> Dict[str, Any]:
    """fp weight [out, in] -> {"wp": planar int4 [out, in/2] uint8,
    "scale": f32 [out]} (RTN against the per-channel absmax scale)."""
    if w_cfg.bits != 4:
        raise NotImplementedError(
            "int8 ('w8') weights wait for ROADMAP queue 1 item 3")
    scale, zero = weight_find_params(w, w_cfg)
    q = weight_quantize_int(w, scale, zero, w_cfg)
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
                        merge_projections: bool = True, tp: int = 1,
                        perm_transforms: bool = False) -> dict:
    """Pack one baked layer (the per-layer body of JAX's
    build_serving_params, quantized.py:161-261).

    lp: baked fp weights {"ln1_w", "ln2_w", "wq", "wk", "wv", "wo",
    "wup", "wgate", "wdown"[, "bq", "bk", "bv"]}, [out, in] layout.
    lt: the layer's baked transforms and clip ratios:
      "ln_t", "ug_t", "down_t": (left, right) Kronecker factors
      "o_t": [g, g] head mixing; "k_t", "k_t_inv" [hd, hd];
      "v_t_inv" [hd, hd] (optional)
      "a_clip": {"qkv"|"o"|"upgate"|"down": (rmax, rmin)} (optional)
      "kc_clip", "vc_clip": (cmax, cmin) (optional)
    Clip values are the sigmoid-applied ratios, not the raw factors."""
    w_cfg = fq_cfg.w_cfg
    if not (w_cfg.sym and w_cfg.group_size <= 0):
        raise NotImplementedError(
            "real-quant path supports symmetric per-channel weights only")
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
                         dtype=torch.bfloat16, merge_projections: bool = True,
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


def _act_codes_i8(x2d, clip, a_q_max: int):
    """Per-token symmetric quant -> (int8 codes [T, K], f32 scales [T, 1]).

    xmax/xmin clip separately by their LAC ratios, absmax = max(|xmin|,
    xmax), scale = absmax / a_q_max (1 for an all-zero row), codes =
    clamp(round(x / scale), -a_q_max-1, a_q_max) with round half to even."""
    xf = x2d.to(torch.float32)
    xmax = torch.clamp(xf.amax(dim=-1, keepdim=True), min=0.0)
    xmin = torch.clamp(xf.amin(dim=-1, keepdim=True), max=0.0)
    if clip is not None:
        xmax = xmax * clip[0]
        xmin = xmin * clip[1]
    absmax = torch.maximum(xmin.abs(), xmax)
    xs = torch.where(absmax == 0, 1.0, absmax / a_q_max)
    xq = torch.clamp(torch.round(xf / xs), -a_q_max - 1, a_q_max)
    return xq.to(torch.int8), xs


def _quant_linear(x2d, lin, use_kernel: bool, out_dtype=torch.bfloat16,
                  quant_acts: bool = True, a_q_max: int = 7,
                  axis_name: Optional[str] = None):
    """Per-token quant + W4A4 GEMM. x2d: [T, K] fp; returns [T, N].

    use_kernel=True goes through w4a4_matmul_i8 (the kernel on a card);
    False calls the plain version directly (the engine's comparison
    switch)."""
    if axis_name is not None:
        raise NotImplementedError("tp waits for ROADMAP queue 1 item 9")
    if not quant_acts or "wp" not in lin:
        raise NotImplementedError(
            "weight-only and int8-weight linears wait for ROADMAP queue 1 "
            "item 3")
    if (use_kernel and x2d.shape[0] >= 256
            and x2d.shape[1] >= PALLAS_QUANT_MIN_K
            and x2d.shape[1] % 128 == 0):
        raise NotImplementedError(
            f"the quant_acts_i8 route (T >= 256, K >= 8192) waits for "
            f"{LONG_PREFILL}")
    xq, xs = _act_codes_i8(x2d, lin.get("a_clip"), a_q_max)
    gemm = w4a4_matmul_i8 if use_kernel else w4a8_matmul_ref
    return gemm(xq, xs, lin["wp"], lin["scale"], out_dtype)


def _quant_swiglu(x2d, lin, use_kernel: bool, out_dtype=torch.bfloat16,
                  quant_acts: bool = True, a_q_max: int = 7):
    """silu(gate) * up for a merged up||gate projection (rows [0, N/2) =
    up, [N/2, N) = gate), composed from the quantized linear."""
    if (use_kernel and quant_acts and "wp" in lin and x2d.shape[0] >= 256
            and a_q_max == 7):
        raise NotImplementedError(
            f"the fused swiglu GEMM (T >= 256) waits for {LONG_PREFILL}")
    y = _quant_linear(x2d, lin, use_kernel, out_dtype, quant_acts, a_q_max)
    up, gate = y.chunk(2, dim=-1)
    # jax.nn.silu's own definition, x * (1 / (1 + exp(-x))), one rounding
    # per op in the working dtype: in bf16 it then matches JAX bit for
    # bit, where F.silu (one rounding at the end) differs by an ulp on a
    # third of the elements
    return gate * (1.0 / (1.0 + torch.exp(-gate))) * up


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
    scale = (tmax - tmin) / q_max
    zero = torch.round(-tmin / scale)
    q = torch.clamp(torch.round(tf / scale) + zero, 0, q_max)
    return q, scale, zero


def dequantize_kv(q, scale, zero, dtype=torch.bfloat16):
    return ((q - zero) * scale).to(dtype)
