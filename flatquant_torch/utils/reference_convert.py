"""Interop with reference (PyTorch FlatQuant) artifacts (port of
flatquant_tpu/utils/reference_convert.py).

The reference releases `flat_matrices.pth` checkpoints — per-layer dicts
of eval-mode transform matrices and clip factors saved by
`save_flat_matrices` (flat_utils.py:65-93, key filter ["trans.matrix",
"trans.diag_scale", "clip_factor_w", "clip_factor_a"]). This module
converts

  - a torch HF Llama/Qwen state dict            -> the port's fp params
  - a reference `flat_matrices.pth` object      -> the port's list of
    LayerFQ of baked transforms and clip factors, ready for
    `quantize.bake.bake_model` (the --reload_matrix flow: load matrices,
    bake fresh fp weights against them, eval / export)

gives the pre-fold "matrices" form of the port's own FQ state
(`rep_matrix_only` analog) that --save_matrix writes: saved BEFORE the
bake, reloaded onto raw weights, baked again; and writes and reads the
reference's deploy PACKED checkpoints (save_reference_packed,
load_reference_packed; below), whose interleaved int4 codes are
core/packing.py's pack_int4 format.

Reference key schema per layer (direct_inv or SVD, after to_eval_mode —
trans_utils.py:39-46 / 105-116 / 153-159 / 206-213):

  self_attn.ln_trans.matrix_left / matrix_right / matrix_left_inv /
      matrix_right_inv / diag_scale
  self_attn.{o,kcache,vcache}_trans.matrix / matrix_inv_t
  mlp.{up_gate,down}_trans.matrix_* / diag_scale
  {self_attn.{q,k,v,o}_proj, mlp.{up,gate,down}_proj}.clip_factor_w_{max,min}
  {...}_proj.act_quantizer.clip_factor_a_{max,min}
  self_attn.{q,k,v}_cache_quantizer.clip_factor_a_{max,min}

`matrix_left_inv` / `matrix_inv_t` hold the inverse-TRANSPOSE of the
factor (trans_utils.py:42,109-110,156,210-211) — the convention of
BakedSingle.matrix_inv_t / BakedDecompose.left_inv.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from flatquant_torch.core.packing import pack_int4, unpack_int4
from flatquant_torch.core.quant import weight_find_params, weight_quantize_int
from flatquant_torch.core.transforms import (
    BakedDecompose,
    BakedSingle,
    decompose_matrices,
    single_matrix,
)
from flatquant_torch.kernels.common import resolve_device
from flatquant_torch.kernels.int4_matmul import pack_weight_planar
from flatquant_torch.models.config import LlamaConfig
from flatquant_torch.models.loader import params_from_named_tensors
from flatquant_torch.native.safetensors_io import (
    SafetensorsFile,
    write_safetensors,
)
from flatquant_torch.quantize.linear import LinearQuantState
from flatquant_torch.quantize.spec import FQConfig
from flatquant_torch.quantize.state import (
    AttnFQ,
    CacheQuantState,
    LayerFQ,
    MlpFQ,
    bake_layer_fq,
    init_model_fq,
)


def _f32(t, dev) -> torch.Tensor:
    return torch.as_tensor(t).detach().to(device=dev, dtype=torch.float32)


# ---------------------------------------------------------------------------
# torch HF state dict -> the port's params
# ---------------------------------------------------------------------------


def params_from_torch_state_dict(sd: Dict[str, object], cfg: LlamaConfig,
                                 dtype=torch.float32, device="cuda") -> dict:
    """HF Llama/Qwen2 `model.state_dict()` -> the port's params."""
    return params_from_named_tensors(sd.items(), cfg, dtype, device)


# ---------------------------------------------------------------------------
# reference flat_matrices -> the port's baked FQ state
# ---------------------------------------------------------------------------


def _get(d, key, dev):
    return _f32(d[key], dev) if key in d else None


def _decompose_from(d, prefix: str, dev) -> Optional[BakedDecompose]:
    if f"{prefix}.matrix_left" not in d:
        return None
    return BakedDecompose(
        left=_f32(d[f"{prefix}.matrix_left"], dev),
        right=_f32(d[f"{prefix}.matrix_right"], dev),
        left_inv=_f32(d[f"{prefix}.matrix_left_inv"], dev),
        right_inv=_f32(d[f"{prefix}.matrix_right_inv"], dev),
        diag_scale=_get(d, f"{prefix}.diag_scale", dev))


def _single_from(d, prefix: str, dev) -> Optional[BakedSingle]:
    if f"{prefix}.matrix" not in d:
        return None
    return BakedSingle(matrix=_f32(d[f"{prefix}.matrix"], dev),
                       matrix_inv_t=_f32(d[f"{prefix}.matrix_inv_t"], dev))


def _linear_from(d, prefix: str, dev) -> LinearQuantState:
    return LinearQuantState(
        clip_w_max=_get(d, f"{prefix}.clip_factor_w_max", dev),
        clip_w_min=_get(d, f"{prefix}.clip_factor_w_min", dev),
        clip_a_max=_get(d, f"{prefix}.act_quantizer.clip_factor_a_max", dev),
        clip_a_min=_get(d, f"{prefix}.act_quantizer.clip_factor_a_min", dev))


def _cache_from(d, prefix: str, dev) -> CacheQuantState:
    return CacheQuantState(
        clip_a_max=_get(d, f"{prefix}.clip_factor_a_max", dev),
        clip_a_min=_get(d, f"{prefix}.clip_factor_a_min", dev))


def layer_fq_from_reference_dict(d: Dict[str, object],
                                 device="cuda") -> LayerFQ:
    """One layer's flat_matrices entry -> LayerFQ of baked transforms."""
    dev = resolve_device(device)
    sa, mlp = "self_attn.", "mlp."
    attn = AttnFQ(
        ln_trans=_decompose_from(d, sa + "ln_trans", dev),
        o_trans=_single_from(d, sa + "o_trans", dev),
        kcache_trans=_single_from(d, sa + "kcache_trans", dev),
        vcache_trans=_single_from(d, sa + "vcache_trans", dev),
        q_lin=_linear_from(d, sa + "q_proj", dev),
        k_lin=_linear_from(d, sa + "k_proj", dev),
        v_lin=_linear_from(d, sa + "v_proj", dev),
        o_lin=_linear_from(d, sa + "o_proj", dev),
        q_cache=_cache_from(d, sa + "q_cache_quantizer", dev),
        k_cache=_cache_from(d, sa + "k_cache_quantizer", dev),
        v_cache=_cache_from(d, sa + "v_cache_quantizer", dev))
    return LayerFQ(attn=attn, mlp=MlpFQ(
        up_gate_trans=_decompose_from(d, mlp + "up_gate_trans", dev),
        down_trans=_decompose_from(d, mlp + "down_trans", dev),
        up_lin=_linear_from(d, mlp + "up_proj", dev),
        gate_lin=_linear_from(d, mlp + "gate_proj", dev),
        down_lin=_linear_from(d, mlp + "down_proj", dev)))


def fq_from_flat_matrices(matrices: Dict[int, Dict[str, object]],
                          cfg: LlamaConfig, device="cuda") -> List[LayerFQ]:
    """Reference flat_matrices object ({layer: {key: tensor}}) -> the
    port's list of LayerFQ, ready for `bake_model`."""
    return [layer_fq_from_reference_dict(matrices[i], device)
            for i in range(cfg.num_layers)]


def load_reference_flat_matrices(path: str):
    """torch.load a reference flat_matrices.pth (local file)."""
    return torch.load(path, map_location="cpu", weights_only=False)


# ---------------------------------------------------------------------------
# the port's own matrices artifact (rep_matrix_only analog)
# ---------------------------------------------------------------------------


def matrices_state(fq_state: List[LayerFQ]) -> List[LayerFQ]:
    """Freeze a trained FQ state into eval matrices WITHOUT folding the
    diag scales — the reference's rep_matrix_only form
    (llama_utils.py:106-109,317-325): what --save_matrix writes, so that
    a reload baked onto raw weights reproduces the model."""
    return [bake_layer_fq(lfq) for lfq in fq_state]


def matrices_fq_template(cfg: LlamaConfig, fq_cfg: FQConfig, seed: int = 0,
                         tp: int = 1, device="cuda") -> List[LayerFQ]:
    """Structure template for loading a saved matrices artifact."""
    return matrices_state(init_model_fq(cfg, fq_cfg, seed=seed, tp=tp,
                                        device=device))


# ---------------------------------------------------------------------------
# deploy PACKED checkpoints
#
# The reference's released real-quant checkpoints are safetensors in the
# deploy naming scheme that modeling_llama.py:454-517 renames into its
# module tree: per-linear `<module>.linear.weight` int4 codes packed two
# per byte INTERLEAVED (byte j = q[2j] | q[2j+1] << 4, two's complement:
# core/packing.py), weight scales under `quantizer.<module>.linear.scale`
# [out, 1], transform matrices under `ln_trans.matrix_left/right`,
# `o_trans.matrix`, `k/vcache_trans.matrix`, `up_gate_trans` /
# `down_trans`, and RAW (pre-sigmoid) activation / KV clip logits on each
# `act_quantizer` / `{k,v}_cache_quantizer`.
# ---------------------------------------------------------------------------

_DEPLOY_LINEARS = (
    ("q", "self_attn.q_proj", "wq"),
    ("k", "self_attn.k_proj", "wk"),
    ("v", "self_attn.v_proj", "wv"),
    ("o", "self_attn.o_proj", "wo"),
    ("up", "mlp.up_proj", "wup"),
    ("gate", "mlp.gate_proj", "wgate"),
    ("down", "mlp.down_proj", "wdown"),
)
_BIAS_OF = {"wq": "bq", "wk": "bk", "wv": "bv"}


def save_reference_packed(path: str, cfg: LlamaConfig, fq_cfg: FQConfig,
                          baked_params: dict, baked_fq: List[LayerFQ]) -> str:
    """Write a reference-deploy packed safetensors checkpoint from a baked
    model (quantize/bake.py bake_model's params and LayerFQ list): the
    inverse of load_reference_packed. Codes and scales come from
    weight_find_params / weight_quantize_int on the baked weights, where
    the tensors lie; the file is written from host copies."""
    w_cfg = fq_cfg.w_cfg
    if not (w_cfg.bits == 4 and w_cfg.sym and w_cfg.group_size <= 0):
        raise ValueError("deploy packed checkpoints are symmetric "
                         "per-channel int4")
    sd: Dict[str, torch.Tensor] = {}

    def put(k, v):
        sd[k] = v.detach().cpu().contiguous()

    put("model.embed_tokens.weight", baked_params["embed"])
    put("model.norm.weight", baked_params["final_norm_w"])
    put("lm_head.weight", baked_params.get("lm_head",
                                           baked_params["embed"]))
    for i in range(cfg.num_layers):
        L = f"model.layers.{i}."
        lp = baked_params["layers"][i]
        a, m = baked_fq[i].attn, baked_fq[i].mlp
        put(L + "input_layernorm.weight", lp["ln1_w"])
        put(L + "post_attention_layernorm.weight", lp["ln2_w"])
        for _, mod, wkey in _DEPLOY_LINEARS:
            w = lp[wkey]
            scale, zero = weight_find_params(w, w_cfg)
            q = weight_quantize_int(w, scale, zero, w_cfg)
            put(L + mod + ".linear.weight", pack_int4(q))
            put("quantizer." + L + mod + ".linear.scale",
                scale.to(torch.float32))
            bias = lp.get(_BIAS_OF.get(wkey))
            if bias is not None:
                put(L + mod + ".linear.bias", bias)
        for trans, prefix in ((a.ln_trans, L + "self_attn.ln_trans"),
                              (m.up_gate_trans, L + "mlp.up_gate_trans"),
                              (m.down_trans, L + "mlp.down_trans")):
            if trans is not None:
                left, right = decompose_matrices(trans)
                put(prefix + ".matrix_left", left)
                put(prefix + ".matrix_right", right)
        for trans, prefix in ((a.o_trans, L + "self_attn.o_trans"),
                              (a.kcache_trans, L + "self_attn.kcache_trans"),
                              (a.vcache_trans,
                               L + "self_attn.vcache_trans")):
            if trans is not None:
                put(prefix + ".matrix", single_matrix(trans))
        for mod, lin in (("self_attn.q_proj", a.q_lin),
                         ("self_attn.k_proj", a.k_lin),
                         ("self_attn.v_proj", a.v_lin),
                         ("self_attn.o_proj", a.o_lin),
                         ("mlp.up_proj", m.up_lin),
                         ("mlp.gate_proj", m.gate_lin),
                         ("mlp.down_proj", m.down_lin)):
            if lin.clip_a_max is not None:
                put(L + mod + ".act_quantizer.clip_factor_a_max",
                    lin.clip_a_max)
                put(L + mod + ".act_quantizer.clip_factor_a_min",
                    lin.clip_a_min)
        for nm, cq in (("k", a.k_cache), ("v", a.v_cache)):
            if cq.clip_a_max is not None:
                pre = L + f"self_attn.{nm}_cache_quantizer.clip_factor_a_"
                put(pre + "max", cq.clip_a_max)
                put(pre + "min", cq.clip_a_min)
    write_safetensors(path, sd)
    return path


def _tensor(sf, key):
    return sf.tensor_f32(key) if key in sf.keys() else None


def _sig_pair(sf, prefix):
    """The raw (max, min) clip logits under prefix, sigmoid-applied, as
    build_serving_layer holds clip ratios; None when absent."""
    cmax = _tensor(sf, prefix + "max")
    if cmax is None:
        return None
    return tuple(torch.sigmoid(c).reshape(1)
                 for c in (cmax, _tensor(sf, prefix + "min")))


def _deploy_layer(sf, L: str, dtype) -> dict:
    """One layer (key prefix L) of a deploy packed file as serving
    params."""
    out = {"ln1_w": _tensor(sf, L + "input_layernorm.weight"),
           "ln2_w": _tensor(sf, L + "post_attention_layernorm.weight")}
    for ours, mod, wkey in _DEPLOY_LINEARS:
        codes = unpack_int4(sf.raw(L + mod + ".linear.weight")[0])
        lin = {"wp": pack_weight_planar(codes),
               "scale": _tensor(sf, "quantizer." + L + mod
                                + ".linear.scale")[:, 0].contiguous()}
        clip = _sig_pair(sf, L + mod + ".act_quantizer.clip_factor_a_")
        if clip is not None:
            lin["a_clip"] = clip
        out[ours] = lin
        bias = _tensor(sf, L + mod + ".linear.bias")
        if bias is not None:
            out[_BIAS_OF[wkey]] = bias
    for ours, prefix in (("ln_t", L + "self_attn.ln_trans"),
                         ("ug_t", L + "mlp.up_gate_trans"),
                         ("down_t", L + "mlp.down_trans")):
        if prefix + ".matrix_left" in sf.keys():
            out[ours] = (_tensor(sf, prefix + ".matrix_left").to(dtype),
                         _tensor(sf, prefix + ".matrix_right").to(dtype))
    o_t = _tensor(sf, L + "self_attn.o_trans.matrix")
    if o_t is not None:
        out["o_t"] = o_t.to(dtype)
    kt = _tensor(sf, L + "self_attn.kcache_trans.matrix")
    if kt is not None:
        out["k_t"] = kt.to(dtype)
        out["k_t_inv"] = torch.linalg.inv(kt).T.to(dtype)
    vt = _tensor(sf, L + "self_attn.vcache_trans.matrix")
    if vt is not None:
        out["v_t_inv"] = torch.linalg.inv(vt).T.to(dtype)
    for ours, nm in (("kc_clip", "k"), ("vc_clip", "v")):
        clip = _sig_pair(sf, L + f"self_attn.{nm}_cache_quantizer."
                                 "clip_factor_a_")
        if clip is not None:
            out[ours] = clip
    return out


def load_reference_packed(path: str, cfg: LlamaConfig, fq_cfg: FQConfig,
                          dtype=torch.bfloat16, device="cuda") -> dict:
    """Read a reference-deploy packed safetensors checkpoint into the
    port's serving params (build_serving_params' unmerged layout: a list
    of per-layer dicts), on `device`: interleaved int4 codes repacked
    planar, weight scales per linear, raw clip logits through the sigmoid
    (the serving convention), and the cache transforms' inverses
    recomputed in float32 (the deploy format stores only the forward
    matrix). One tensor is read from the file at a time."""
    with SafetensorsFile(path, device) as sf:
        layers = [_deploy_layer(sf, f"model.layers.{i}.", dtype)
                  for i in range(cfg.num_layers)]
        embed = _tensor(sf, "model.embed_tokens.weight")
        return {"embed": embed.to(dtype),
                "final_norm_w": _tensor(sf, "model.norm.weight"),
                "lm_head": _tensor(sf, "lm_head.weight").to(dtype),
                "layers": layers}
