"""Kronecker transform + per-token quantization as one function (port of
flatquant_tpu/kernels/fused_trans_quant.py).

JAX's module is a jnp composition that XLA fuses, not a Pallas kernel,
so this is the same composition in torch on the input's device. The
serving path's fused forms on the card are rows 4 and 5
(kernels/flat_pipeline.py rmsnorm_right_flat, left_quant_i8_flat).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from flatquant_torch.core.quant import true_div


def _per_token_codes(y, q_max, xmax, xmin):
    absmax = torch.maximum(xmin.abs(), xmax)
    scale = torch.where(absmax == 0, 1.0, true_div(absmax, q_max))
    codes = torch.clamp(torch.round(y / scale), -q_max - 1, q_max)
    return codes.to(torch.bfloat16), scale


def fused_kron_quant(
    x: torch.Tensor,
    left: torch.Tensor,
    right: torch.Tensor,
    diag: Optional[torch.Tensor] = None,
    clip_max=None,
    clip_min=None,
    q_max: int = 7,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """y = quantize_per_token(x @ kron(left, right)).

    x [..., M*N]; left [M, M]; right [N, N]; diag: an optional
    per-channel pre-scale; clip_max / clip_min: LAC ratios (already
    sigmoided). Returns (codes bf16 on the int4 grid, float32 scales
    [..., 1])."""
    shape = x.shape
    if diag is not None:
        x = x * diag.to(x.dtype)
    xm = x.reshape(-1, left.shape[0], right.shape[0])
    xm = xm @ right.to(xm.dtype)
    xm = left.T.to(xm.dtype) @ xm
    y = xm.reshape(shape).to(torch.float32)
    xmax = torch.clamp(y.amax(dim=-1, keepdim=True), min=0.0)
    xmin = torch.clamp(y.amin(dim=-1, keepdim=True), max=0.0)
    if clip_max is not None:
        xmax = xmax * clip_max
        xmin = xmin * clip_min
    return _per_token_codes(y, q_max, xmax, xmin)


def fused_head_trans_quant(
    x: torch.Tensor,
    head_matrix: torch.Tensor,
    q_max: int = 7,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-head single transform + quant: x [..., n_heads, head_dim] is
    mixed over the heads by head_matrix^T (the o_proj transform),
    flattened and quantized per token."""
    mixed = torch.einsum("ji,...jd->...id", head_matrix.to(x.dtype), x)
    flat = mixed.reshape(mixed.shape[:-2] + (-1,)).to(torch.float32)
    absmax = flat.abs().amax(dim=-1, keepdim=True)
    return _per_token_codes(flat, q_max, absmax, torch.zeros_like(absmax))
