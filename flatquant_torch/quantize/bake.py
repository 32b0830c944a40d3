"""Reparameterization: bake trained transforms into the weights (port of
flatquant_tpu/quantize/bake.py).

The order is the reference's (diag folds come before any weight
quantization, so the quantizer sees the folded weights):
  1. freeze the transforms into fixed matrices (to_eval_mode)
  2. transform and clip every linear weight in float32
  3. fold the diag scales: ln_trans.diag -> ln1_w, up_gate_trans.diag ->
     ln2_w, down_trans.diag -> the rows of wup
  4. (separately) RTN weight quantization over the baked params
     (`rtn_quantize_params`), or packing (serving/quantized.py), which
     finds its scales on the baked weights itself

Params are the port's: {"embed", "final_norm_w"[, "lm_head"], "layers":
[per-layer dict]}; the FQ state a list of LayerFQ.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from flatquant_torch.core.quant import weight_fake_quant, weight_find_params
from flatquant_torch.core.transforms import apply_single, single_matrix
from flatquant_torch.models.config import LlamaConfig
from flatquant_torch.quantize.linear import transform_weight
from flatquant_torch.quantize.spec import FQConfig
from flatquant_torch.quantize.state import LayerFQ, bake_layer_fq


def bake_layer(cfg: LlamaConfig, fq_cfg: FQConfig, lp: dict,
               layer_fq: LayerFQ) -> Tuple[dict, LayerFQ]:
    """Bake one layer: (new layer params, eval-mode LayerFQ)."""
    fq = bake_layer_fq(layer_fq)
    a, m = fq.attn, fq.mlp
    new = dict(lp)
    lwc = fq_cfg.lwc

    def tw(w, st, qa=None, out=None):
        return transform_weight(w, st, qa, out, lwc)

    new["wq"] = tw(lp["wq"], a.q_lin, qa=a.ln_trans)
    new["wk"] = tw(lp["wk"], a.k_lin, qa=a.ln_trans)
    out_v = None if fq_cfg.separate_vtrans else a.vcache_trans
    new["wv"] = tw(lp["wv"], a.v_lin, qa=a.ln_trans, out=out_v)
    if lp.get("bv") is not None and out_v is not None:
        new["bv"] = apply_single(out_v, lp["bv"].to(torch.float32))
    qa_o = None
    if a.o_trans is not None and a.vcache_trans is not None:
        qa_o = (single_matrix(a.o_trans, inv_t=True),
                single_matrix(a.vcache_trans, inv_t=True))
    new["wo"] = tw(lp["wo"], a.o_lin, qa=qa_o)

    new["wgate"] = tw(lp["wgate"], m.gate_lin, qa=m.up_gate_trans)
    new["wup"] = tw(lp["wup"], m.up_lin, qa=m.up_gate_trans)
    new["wdown"] = tw(lp["wdown"], m.down_lin, qa=m.down_trans)

    if a.ln_trans is not None and a.ln_trans.diag_scale is not None:
        new["ln1_w"] = lp["ln1_w"].to(torch.float32) * a.ln_trans.diag_scale
        a = dataclasses.replace(
            a, ln_trans=dataclasses.replace(a.ln_trans, diag_scale=None))
    if m.up_gate_trans is not None and m.up_gate_trans.diag_scale is not None:
        new["ln2_w"] = (lp["ln2_w"].to(torch.float32)
                        * m.up_gate_trans.diag_scale)
        m = dataclasses.replace(m, up_gate_trans=dataclasses.replace(
            m.up_gate_trans, diag_scale=None))
    if m.down_trans is not None and m.down_trans.diag_scale is not None:
        # scale up_proj's out rows so silu(gate) * up arrives pre-scaled
        # (llama_utils.py:88-93)
        diag = m.down_trans.diag_scale
        if diag.shape[0] != new["wup"].shape[0]:
            diag = diag.repeat(new["wup"].shape[0] // diag.shape[0])
        new["wup"] = new["wup"] * diag[:, None]
        m = dataclasses.replace(m, down_trans=dataclasses.replace(
            m.down_trans, diag_scale=None))
    return new, LayerFQ(attn=a, mlp=m)


def bake_model(cfg: LlamaConfig, fq_cfg: FQConfig, params: dict,
               fq_state: List[LayerFQ]) -> Tuple[dict, List[LayerFQ]]:
    """Bake every layer: (new params, list of eval-mode LayerFQ)."""
    layers, fqs = [], []
    for lp, lfq in zip(params["layers"], fq_state):
        new, bfq = bake_layer(cfg, fq_cfg, lp, lfq)
        layers.append(new)
        fqs.append(bfq)
    return dict(params, layers=layers), fqs


_QUANT_KEYS = ("wq", "wk", "wv", "wo", "wgate", "wup", "wdown")


def rtn_quantize_params(fq_cfg: FQConfig, params: dict) -> dict:
    """Round-to-nearest weight fake-quant of every baked linear (the
    rtn_fwrd analog)."""
    if not fq_cfg.w_cfg.enabled:
        return params
    w_cfg = fq_cfg.w_cfg

    def quant_one(w):
        scale, zero = weight_find_params(w, w_cfg)
        return weight_fake_quant(w, scale, zero, w_cfg)

    layers = [dict(lp, **{k: quant_one(lp[k]) for k in _QUANT_KEYS})
              for lp in params["layers"]]
    return dict(params, layers=layers)
