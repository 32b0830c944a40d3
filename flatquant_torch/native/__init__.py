"""Host-runtime conversions of checkpoint bytes (port of
flatquant_tpu/native/__init__.py).

JAX's module is a g++/OpenMP library bound with ctypes, with a numpy
fallback for every entry point and an AVAILABLE switch between them.
torch decodes float8_e4m3fn, bfloat16 and float16 itself, so here each
entry point is a plain torch function on the device of the tensor it is
given (a numpy array stays on the CPU), with JAX's names and contracts:
no build, no bindings, no switch. The int4 planar pack is the serving
kernels' own (kernels/int4_matmul.py).
"""

from __future__ import annotations

import torch

from flatquant_torch.kernels.int4_matmul import (
    pack_weight_planar,
    unpack_weight_planar,
)


def _bits(raw, dtype) -> torch.Tensor:
    """raw bit patterns (tensor or array) as a contiguous `dtype` tensor."""
    return torch.as_tensor(raw).contiguous().view(dtype)


def fp8_e4m3_to_f32(raw) -> torch.Tensor:
    """uint8 E4M3 bytes -> float32 (same shape): every code exact, the
    two codes s.1111.111 NaN."""
    return _bits(raw, torch.uint8).view(torch.float8_e4m3fn).to(
        torch.float32)


def fp8_block_dequant(w, scales, block: int = 128) -> torch.Tensor:
    """FP8 weight [out, in] (float8_e4m3fn, or its uint8 bytes) times its
    tile scales [ceil(out/b), ceil(in/b)] -> float32, on w's device (the
    reference deepseek_v3/kernel.py:55-105 semantics, done once at
    load)."""
    wf = (fp8_e4m3_to_f32(w) if w.dtype != torch.float8_e4m3fn
          else w.to(torch.float32))
    out_dim, in_dim = wf.shape
    s = torch.as_tensor(scales, device=wf.device).to(torch.float32)
    sc = s.repeat_interleave(block, 0)[:out_dim].repeat_interleave(
        block, 1)[:, :in_dim]
    return wf * sc


def bf16_to_f32(raw) -> torch.Tensor:
    """uint16 bf16 bit patterns -> float32 (same shape)."""
    return _bits(raw, torch.uint16).view(torch.bfloat16).to(torch.float32)


def f16_to_f32(raw) -> torch.Tensor:
    """uint16 IEEE-half bit patterns -> float32."""
    return _bits(raw, torch.uint16).view(torch.float16).to(torch.float32)


def pack_int4_planar(q) -> torch.Tensor:
    """int8 codes [n, k] in [-8, 7] -> planar biased nibbles [n, k/2]
    (the layout of kernels/int4_matmul.py pack_weight_planar)."""
    return pack_weight_planar(torch.as_tensor(q))


def unpack_int4_planar(p) -> torch.Tensor:
    """Inverse of pack_int4_planar -> int8 [n, k]."""
    return unpack_weight_planar(torch.as_tensor(p))
