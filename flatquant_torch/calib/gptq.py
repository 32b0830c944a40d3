"""GPTQ weight quantization, the post-reparameterization pass (port of
flatquant_tpu/calib/gptq.py).

Parity target: gptq_utils.py:15-310 —
  - Hessians from the quantized path's linear inputs: an eval-mode layer
    forward returns its capture points, and each linear's own activation
    fake-quant is re-applied to them
  - per weight: column-sequential quantization with Cholesky-inverse
    error feedback, optional activation ordering and per-group scales
  - layer-sequential subsets [qkv] -> [o] -> [up, gate] -> [down], the
    layer inputs propagating through the quantized layer
    (gptq_utils.py:188-263)

Shape of the column loop, as JAX's: 128-column blocks, each quantized
column by column with the error fed forward inside its block, then one
[out, 128] x [128, n] product carries the block's error to every later
column (the GPTQ paper's lazy batch). Widths that do not tile into blocks
(or group layouts that do not fit one) take a per-column loop with
full-width updates. Everything runs on the weight's device in float32;
the column loop is eager torch, so it is bound by the host's launch rate
on a card.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from flatquant_torch.core.quant import (
    WeightQuantCfg,
    act_fake_quant,
    asym_quant_dequant,
    sym_quant_dequant,
    weight_find_params,
)
from flatquant_torch.models.config import LlamaConfig
from flatquant_torch.models.llama import causal_mask, llama_layer, rope_tables
from flatquant_torch.quantize.spec import FQConfig


# ---------------------------------------------------------------------------
# core column loop
# ---------------------------------------------------------------------------


def hessian_inverse_factor(h: torch.Tensor) -> torch.Tensor:
    """Upper triangular U with U^T U = H^{-1} (float32): with J the
    reversal permutation, J H J = L L^T gives U = J L^{-1} J — one
    Cholesky and one triangular inverse (JAX's route, gptq.py:78-97)."""
    n = h.shape[0]
    g = torch.flip(h, (0, 1))
    low = torch.linalg.cholesky(g)
    eye = torch.eye(n, dtype=torch.float32, device=h.device)
    l_inv = torch.linalg.solve_triangular(low, eye, upper=False)
    return torch.flip(l_inv, (0, 1)).contiguous()


def gptq_quantize_weight(w, hessian, w_cfg: WeightQuantCfg,
                         percdamp: float = 0.01, act_order: bool = False,
                         block_size: int = 128):
    """Quantize w [out, in] against the input Hessian [in, in] -> the
    fake-quantized weight, float32, on w's device. Dead columns (zero
    Hessian diagonal) get a diagonal of 1 and a zero weight; act_order
    sorts the columns by descending diagonal (stable); the damp is
    percdamp * mean(diag)."""
    h = hessian.to(torch.float32).clone()
    n = h.shape[0]
    dead = torch.diagonal(h) == 0
    idx = torch.nonzero(dead)[:, 0]
    h[idx, idx] = 1.0
    perm = inv_perm = None
    if act_order:
        perm = torch.argsort(-torch.diagonal(h), stable=True)
        h = h[perm][:, perm]
        inv_perm = torch.argsort(perm)
    damp = percdamp * float(torch.diagonal(h).mean())
    ar = torch.arange(n, device=h.device)
    h[ar, ar] += damp
    hinv = hessian_inverse_factor(h)
    return _gptq_core(w, hinv, dead, perm, inv_perm, w_cfg, block_size)


def _gptq_core(w, hinv, dead, perm, inv_perm, w_cfg: WeightQuantCfg,
               block_size: int = 128):
    """Column-sequential quantization with Cholesky error feedback."""
    w = w.to(torch.float32).clone()
    out_dim, n = w.shape
    q_max = float(w_cfg.q_max)
    grouped = w_cfg.group_size > 0
    group = w_cfg.group_size if grouped else n
    gcfg = WeightQuantCfg(bits=w_cfg.bits, sym=w_cfg.sym, perchannel=True,
                          group_size=-1, mse=w_cfg.mse, norm=w_cfg.norm,
                          grid=w_cfg.grid, max_shrink=w_cfg.max_shrink)
    w[:, dead] = 0.0
    if perm is not None:
        w = w[:, perm]

    def quant_cols(cols, scale, zero):
        if w_cfg.sym:
            return sym_quant_dequant(cols, scale, q_max)
        return asym_quant_dequant(cols, scale, zero, q_max)

    if grouped:
        scale = torch.ones((out_dim, 1), dtype=torch.float32, device=w.device)
        zero = torch.zeros_like(scale)
    else:
        scale, zero = weight_find_params(w, w_cfg)
    q = torch.zeros_like(w)
    B = block_size
    if B > 1 and n % B == 0 and (not grouped or (group <= B
                                                 and B % group == 0)):
        for i1 in range(0, n, B):
            w1 = w[:, i1:i1 + B].clone()
            hblk = hinv[i1:i1 + B, i1:i1 + B]
            err = torch.zeros((out_dim, B), dtype=torch.float32,
                              device=w.device)
            for j in range(B):
                if grouped and j % group == 0:
                    # blocks are group-aligned: the window lies in the slab
                    scale, zero = weight_find_params(w1[:, j:j + group], gcfg)
                col = w1[:, j:j + 1]
                qcol = quant_cols(col, scale, zero)
                q[:, i1 + j:i1 + j + 1] = qcol
                e = (col - qcol) / hblk[j, j]
                w1[:, j + 1:] -= e * hblk[j, j + 1:][None, :]
                err[:, j:j + 1] = e
            # lazy cross-block feedback: the block's errors times its
            # rows of Hinv, into every later column
            w[:, i1 + B:] -= err @ hinv[i1:i1 + B, i1 + B:]
    else:
        # odd widths / group layouts: per column, full-width updates
        for i in range(n):
            if grouped and i % group == 0:
                g0 = (i // group) * group
                scale, zero = weight_find_params(w[:, g0:g0 + group], gcfg)
            col = w[:, i:i + 1]
            qcol = quant_cols(col, scale, zero)
            q[:, i:i + 1] = qcol
            e = (col - qcol) / hinv[i, i]
            w[:, i + 1:] -= e * hinv[i, i + 1:][None, :]
    if inv_perm is not None:
        q = q[:, inv_perm]
    return q


# ---------------------------------------------------------------------------
# driver: layer-sequential over subsets with quantized propagation
# ---------------------------------------------------------------------------

SUBSETS = (
    ("qkv", ("wq", "wk", "wv")),
    ("o", ("wo",)),
    ("upgate", ("wup", "wgate")),
    ("down", ("wdown",)),
)


def _subset_linears(fq_l, capture_key):
    """(weight key, linear state) of every linear one capture point feeds.
    q / k / v (and up / gate) share one captured input, but each linear's
    learned activation clips make its own quantized view of it, so each
    gets its own Hessian (the reference's per-linear hooks,
    gptq_utils.py:37-50)."""
    a, m = fq_l.attn, fq_l.mlp
    return {
        "qkv": (("wq", a.q_lin), ("wk", a.k_lin), ("wv", a.v_lin)),
        "o": (("wo", a.o_lin),),
        "upgate": (("wup", m.up_lin), ("wgate", m.gate_lin)),
        "down": (("wdown", m.down_lin),),
    }[capture_key]


def _clips_equal(a, b) -> bool:
    def eq(x, y):
        if x is None or y is None:
            return x is None and y is None
        return x.shape == y.shape and bool(torch.equal(x, y))

    return eq(a.clip_a_max, b.clip_a_max) and eq(a.clip_a_min, b.clip_a_min)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def gptq_model(cfg: LlamaConfig, fq_cfg: FQConfig, params: dict, fq_state,
               train_tokens: np.ndarray, log: Callable[[str], None] = print,
               compute_dtype=torch.float32, bsz: int = 4,
               history: Optional[list] = None) -> dict:
    """GPTQ over every layer of a *baked* model (bake_model's params and
    list of baked LayerFQ, not RTN-quantized), on the device that holds
    params -> new params (the caller's are not changed). The Hessian of a
    linear is the plain sum of 2 X^T X over its act-quantized inputs;
    linears with equal activation clips share one. history, when given,
    gets one dict per layer: its seconds and columns."""
    layers = [dict(lp) for lp in params["layers"]]
    dev = params["embed"].device
    seqlen = np.asarray(train_tokens).shape[1]
    nsamples = np.asarray(train_tokens).shape[0]
    cos, sin = rope_tables(cfg, torch.arange(seqlen, device=dev))
    mask = causal_mask(seqlen, dev)
    w_cfg, a_cfg = fq_cfg.w_cfg, fq_cfg.a_cfg
    tok = torch.as_tensor(np.asarray(train_tokens), device=dev).long()
    inps = torch.cat([params["embed"][tok[i:i + bsz]].to(compute_dtype)
                      for i in range(0, nsamples, bsz)], 0)

    def eval_step(lp, fq_l, x):
        return llama_layer(cfg, fq_cfg, "eval", lp, fq_l, x, cos, sin, mask,
                           with_linear_inputs=True)

    for i in range(cfg.num_layers):
        t0 = time.time()
        lp, fq_l = layers[i], fq_state[i]
        cols = 0
        for cap_key, weight_keys in SUBSETS:
            linears = _subset_linears(fq_l, cap_key)
            rep = {}
            for idx, (wk, lin) in enumerate(linears):
                rep[wk] = next((wk2 for wk2, lin2 in linears[:idx]
                                if _clips_equal(lin, lin2)), wk)
            hess = {wk: None for wk, _ in linears if rep[wk] == wk}
            for j in range(0, nsamples, bsz):
                _, caps = eval_step(lp, fq_l, inps[j:j + bsz])
                xin = caps[cap_key].to(torch.float32)
                for wk, lin in linears:
                    if rep[wk] != wk:
                        continue
                    xq = act_fake_quant(xin, a_cfg, lin.clip_a_max,
                                        lin.clip_a_min)
                    xf = xq.reshape(-1, xq.shape[-1])
                    contrib = 2.0 * (xf.T @ xf)
                    hess[wk] = contrib if hess[wk] is None \
                        else hess[wk] + contrib
            for wk in weight_keys:
                lp[wk] = gptq_quantize_weight(
                    lp[wk], hess[rep[wk]], w_cfg,
                    percdamp=fq_cfg.gptq_percdamp,
                    act_order=fq_cfg.gptq_act_order).to(lp[wk].dtype)
                cols += lp[wk].shape[1]
            log(f"gptq layer {i} subset {cap_key} done")
        # propagate the quantized layer's outputs
        for j in range(0, nsamples, bsz):
            inps[j:j + bsz] = eval_step(lp, fq_l, inps[j:j + bsz])[0]
        _sync(dev)
        if history is not None:
            history.append(dict(layer=i, seconds=time.time() - t0,
                                columns=cols))
    return dict(params, layers=layers)
