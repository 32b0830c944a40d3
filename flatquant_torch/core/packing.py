"""Int4 nibble packing, the interchange format (port of
flatquant_tpu/core/packing.py).

Two's-complement int4 codes; the even-indexed element of the last dim
goes to the LOW nibble and the odd one to the HIGH nibble of each uint8
byte (the reference exporter's layout). The kernels' planar layout is
kernels/int4_matmul.py pack_weight_planar.
"""

from __future__ import annotations

import torch


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int8 codes in [-8, 7] into uint8 bytes (last dim halves)."""
    if q.shape[-1] % 2:
        raise ValueError("last dim must be even to pack int4 pairs")
    u = q.to(torch.int16) & 0xF
    return (u[..., 0::2] | (u[..., 1::2] << 4)).to(torch.uint8)


def unpack_int4(b: torch.Tensor) -> torch.Tensor:
    """Unpack uint8 bytes into int8 codes in [-8, 7] (last dim doubles)."""
    w = b.to(torch.int16)
    lo = ((w & 0xF) ^ 8) - 8
    hi = (((w >> 4) & 0xF) ^ 8) - 8
    out = torch.stack([lo, hi], dim=-1).to(torch.int8)
    return out.reshape(b.shape[:-1] + (b.shape[-1] * 2,))
