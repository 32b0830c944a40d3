"""Plain float32 pieces of FlatQuant's W4A4 arithmetic, shared by the
references: the Kronecker transform, per-token symmetric activation
quantization with LAC clips, per-channel symmetric weight quantization
with LWC clips, asymmetric per-(token, head) KV quantization, RMSNorm.
Written from FlatQuant's description; imports torch only.

`rnd` is the precision a reference holds its tensors in, applied
wherever the program holds its compute dtype: a round trip through bf16
for the reference at the configuration's precision (the arithmetic stays
float32), through float8 e4m3 for the control, or the identity (float32
throughout). PRECISIONS names them.
"""

from __future__ import annotations

import torch


def identity(t):
    return t


def bf16(t):
    """The configuration's compute precision: the nearest bf16 value."""
    return t.to(torch.bfloat16).to(torch.float32)


def fp8_e4m3(t):
    """The control's precision: the nearest float8 e4m3 value."""
    return t.to(torch.float8_e4m3fn).to(torch.float32)


# where a reference rounds what the program holds in its compute dtype
PRECISIONS = {"float32": identity, "bf16": bf16, "fp8": fp8_e4m3}


def set_exact_matmul():
    """float32 matmuls in full float32 (no TF32) while a reference runs;
    returns the settings to restore."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return prev


def restore_matmul(prev):
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = prev


def inv_t(p: torch.Tensor) -> torch.Tensor:
    """P^{-T}, worked out in float64."""
    return torch.linalg.inv(p.to(torch.float64)).T.to(torch.float32)


def kron(x, left, right):
    """x [..., a*b] @ kron(left [a, a], right [b, b])."""
    a, b = left.shape[0], right.shape[0]
    shape = x.shape
    xm = x.reshape(-1, a, b)
    return (left.T @ (xm @ right)).reshape(shape)


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def silu(x):
    return x * torch.sigmoid(x)


def act_quant(x, clip: float, bits: int = 4):
    """Per-token symmetric fake quantization: the row's max and min (each
    clamped through 0) times the LAC ratio, scale = absmax / q_max,
    codes clamp(round(x / scale), -q_max - 1, q_max)."""
    q_max = 2 ** (bits - 1) - 1
    hi = x.amax(dim=-1, keepdim=True).clamp(min=0) * clip
    lo = x.amin(dim=-1, keepdim=True).clamp(max=0) * clip
    absmax = torch.maximum(hi, -lo)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / q_max)
    return torch.clamp(torch.round(x / scale), -q_max - 1, q_max) * scale


def weight_quant(w, clip: float, bits: int = 4):
    """Per-output-channel symmetric fake quantization after LWC: each row
    clipped to the LWC ratio times its min and max, scale = absmax /
    q_max (absmax at least 1e-5)."""
    q_max = 2 ** (bits - 1) - 1
    lo = w.amin(dim=-1, keepdim=True) * clip
    hi = w.amax(dim=-1, keepdim=True) * clip
    w = torch.minimum(torch.maximum(w, lo), hi)
    absmax = torch.maximum(hi.clamp(min=0), -lo.clamp(max=0)).clamp(min=1e-5)
    scale = absmax / q_max
    return torch.clamp(torch.round(w / scale), -q_max - 1, q_max) * scale


def kv_quant(t, clip: float, bits: int = 4):
    """Asymmetric fake quantization per (token, head) over the head dim:
    range [min, max] (each clamped through 0) times the clip ratio,
    scale = range / (2^bits - 1), zero = round(-min / scale)."""
    q_max = 2 ** bits - 1
    hi = t.amax(dim=-1, keepdim=True).clamp(min=0) * clip
    lo = t.amin(dim=-1, keepdim=True).clamp(max=0) * clip
    flat = (hi == 0) & (lo == 0)
    hi = torch.where(flat, torch.ones_like(hi), hi)
    lo = torch.where(flat, -torch.ones_like(lo), lo)
    scale = (hi - lo) / q_max
    zero = torch.round(-lo / scale)
    q = torch.clamp(torch.round(t / scale) + zero, 0, q_max)
    return (q - zero) * scale


def causal_attention(q, k, v, scale, rows=None):
    """Softmax attention of q [n, h, d] over k, v [T, h, d(v)], query row
    i at position rows[i] (default T - n + i) seeing keys <= its
    position."""
    n, T = q.shape[0], k.shape[0]
    pos = (torch.arange(T - n, T, device=q.device) if rows is None
           else rows)
    s = torch.einsum("qhd,khd->hqk", q, k) * scale
    keep = torch.arange(T, device=q.device)[None, :] <= pos[:, None]
    s = s.masked_fill(~keep[None], float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)
