"""Flatness analysis: per-channel magnitudes of the quantized linears'
inputs under transforms (port of flatquant_tpu/evals/flatness.py, the
reference's flatness.py / plot_flatness.py analog).

Per-channel l2 norms of the attention input (activations) and of the
qkv weights under {vanilla, FlatQuant, Hadamard, SmoothQuant-diag}, and
the sorted-magnitude curves that show why flat distributions quantize
well. The norms are computed on the device that holds the params and
returned as numpy arrays, as JAX's are; matplotlib is imported only by
plot_flatness.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from flatquant_torch.core.hadamard import matmul_hadU
from flatquant_torch.core.transforms import apply_decompose
from flatquant_torch.models.config import LlamaConfig
from flatquant_torch.models.llama import (
    causal_mask,
    llama_layer,
    rms_norm,
    rope_tables,
)


def channel_norms(x2d: torch.Tensor) -> np.ndarray:
    """Per-channel l2 norm over tokens (the reference's metric)."""
    return torch.linalg.vector_norm(x2d.to(torch.float32),
                                    dim=0).cpu().numpy()


def _sq_diag(act, weight, alpha=0.5):
    """act [T, H], weight [rows, H] -> per-in-channel diag [H]."""
    a_max = act.abs().amax(dim=0)
    w_max = weight.abs().amax(dim=0)
    return torch.clamp(w_max ** (1 - alpha)
                       / torch.clamp(a_max, min=1e-5) ** alpha, min=1e-5)


@torch.no_grad()
def layer_flatness(cfg: LlamaConfig, lp: dict, fq_layer, x, cos, sin,
                   mask) -> Dict[str, Dict[str, np.ndarray]]:
    """Per-channel norms of the attention input (post-ln) and the qkv
    weights under each transform family: {method: {"act": [C],
    "weight": [C]}}; "flatquant" when fq_layer has an ln transform."""
    h = rms_norm(x, lp["ln1_w"], cfg.rms_eps).reshape(-1, cfg.hidden_size)
    w = torch.cat([lp["wq"], lp["wk"], lp["wv"]], dim=0).to(torch.float32)
    out = {
        "vanilla": {"act": channel_norms(h), "weight": channel_norms(w)},
        "hadamard": {"act": channel_norms(matmul_hadU(h)),
                     "weight": channel_norms(matmul_hadU(w))},
    }
    diag = _sq_diag(h, w)
    out["smoothquant"] = {"act": channel_norms(h * diag),
                          "weight": channel_norms(w / diag[None, :])}
    if fq_layer is not None and fq_layer.attn.ln_trans is not None:
        t = fq_layer.attn.ln_trans
        out["flatquant"] = {
            "act": channel_norms(apply_decompose(t, h)),
            "weight": channel_norms(apply_decompose(t, w, inv_t=True))}
    return out


@torch.no_grad()
def model_flatness(cfg: LlamaConfig, params: dict, fq_state, tokens,
                   layers=(0,), compute_dtype=torch.float32):
    """Flatness data {layer: layer_flatness(...)} for the selected layers
    of a token batch [B, S], the fp forward carrying x between layers;
    fq_state: the list of LayerFQ, or None."""
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev).to(torch.long)
    S = tokens.shape[1]
    cos, sin = rope_tables(cfg, torch.arange(S, device=dev))
    mask = causal_mask(S, dev)
    x = params["embed"][tokens].to(compute_dtype)
    results = {}
    for i in range(max(layers) + 1):
        lp = params["layers"][i]
        if i in layers:
            fq_l = None if fq_state is None else fq_state[i]
            results[i] = layer_flatness(cfg, lp, fq_l, x, cos, sin, mask)
        x = llama_layer(cfg, None, "fp", lp, None, x, cos, sin, mask)
    return results


def plot_flatness(results, out_path: str):
    """Sorted-magnitude curves per layer and method, saved to out_path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(results)
    fig, axes = plt.subplots(n, 2, figsize=(10, 4 * n), squeeze=False)
    for row, (layer, methods) in enumerate(sorted(results.items())):
        for col, kind in enumerate(("act", "weight")):
            ax = axes[row][col]
            for method, data in methods.items():
                ax.plot(np.sort(data[kind])[::-1], label=method)
            ax.set_yscale("log")
            ax.set_title(f"layer {layer} {kind} channel norms")
            ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path
