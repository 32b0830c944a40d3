"""W4A4 GEMM over planar-packed int4 weights (port of
flatquant_tpu/kernels/int4_matmul.py, the serving path's functions).

Weights are packed two int4 codes per byte in the planar layout shared
with the JAX package: byte c of row n = (q[n, c] + 8) | (q[n, c + K/2] + 8)
<< 4. The biased nibbles feed the integer dot product directly and the
-8 zero point folds into the epilogue as -8 * rowsum(x).

`w4a4_matmul_i8` launches the CUDA kernel (csrc/int4_matmul.cu) for CUDA
tensors and runs the plain version `w4a8_matmul_ref` for CPU tensors.
"""

from __future__ import annotations

import torch

from flatquant_torch.kernels import common

_NAME = "w4a4_matmul_i8"


def pack_weight_planar(q: torch.Tensor) -> torch.Tensor:
    """int8 codes [N, K] in [-8, 7] -> planar biased uint8 [N, K/2]."""
    n, k = q.shape
    if k % 2:
        raise ValueError(f"K={k} must be even")
    u = (q.to(torch.int16) + 8).to(torch.uint8)
    return u[:, : k // 2] | (u[:, k // 2:] << 4)


def unpack_weight_planar(wp: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_weight_planar -> int8 [N, K]."""
    lo = (wp & 0xF).to(torch.int16) - 8
    hi = ((wp >> 4) & 0xF).to(torch.int16) - 8
    return torch.cat([lo, hi], dim=1).to(torch.int8)


def w4a8_matmul_ref(x_q, x_scale, w_packed, w_scale,
                    out_dtype=torch.bfloat16):
    """Plain version: y = (x_q @ unpack(w)^T) * x_scale * w_scale.

    The float32 product of integer codes is exact (sums below 2^24), so
    with TF32 off this equals the kernel's int32 accumulation bit for bit,
    and the epilogue multiplies in the same order."""
    w = unpack_weight_planar(w_packed).to(torch.float32)
    acc = x_q.to(torch.float32) @ w.T
    out = acc * x_scale.reshape(-1, 1) * w_scale.reshape(1, -1)
    return out.to(out_dtype)


def w4a4_matmul_i8(x_q, x_scale, w_packed, w_scale,
                   out_dtype=torch.bfloat16):
    """y[M, N] = dequant(x_q[M, K] @ unpack(w_packed)[N, K]^T).

    x_q int8 codes [M, K] on the int4 grid; x_scale f32 [M, 1]; w_packed
    uint8 [N, K/2] planar; w_scale f32 [N]. Output bf16 or f32.
    CUDA tensors launch the kernel (or raise); CPU tensors run
    w4a8_matmul_ref."""
    if x_q.device.type == "cpu":
        return w4a8_matmul_ref(x_q, x_scale, w_packed, w_scale, out_dtype)
    m, k = x_q.shape
    n = w_packed.shape[0]
    req = common.require
    req(x_q.is_cuda and w_packed.device == x_q.device
        and x_scale.device == x_q.device and w_scale.device == x_q.device,
        _NAME, "all inputs must be on the same CUDA device")
    req(x_q.dtype == torch.int8 and w_packed.dtype == torch.uint8
        and x_scale.dtype == torch.float32 and w_scale.dtype == torch.float32,
        _NAME, "dtypes must be x_q int8, w_packed uint8, scales float32")
    req(tuple(w_packed.shape) == (n, k // 2) and x_scale.numel() == m
        and w_scale.numel() == n, _NAME,
        f"shapes x_q {tuple(x_q.shape)}, w_packed {tuple(w_packed.shape)}, "
        f"x_scale {tuple(x_scale.shape)}, w_scale {tuple(w_scale.shape)}")
    req(k % 32 == 0, _NAME, f"K={k} must be a multiple of 32")
    req(out_dtype in (torch.bfloat16, torch.float32), _NAME,
        f"out_dtype {out_dtype} must be bfloat16 or float32")
    x_q, w_packed = x_q.contiguous(), w_packed.contiguous()
    x_scale, w_scale = x_scale.contiguous(), w_scale.contiguous()
    req(x_q.data_ptr() % 16 == 0 and w_packed.data_ptr() % 16 == 0, _NAME,
        "x_q and w_packed must be 16-byte aligned")
    y = torch.empty((m, n), dtype=out_dtype, device=x_q.device)
    rc = common.lib("int4_matmul").fq_w4a4_matmul_i8(
        x_q.data_ptr(), w_packed.data_ptr(), x_scale.data_ptr(),
        w_scale.data_ptr(), y.data_ptr(), m, n, k,
        int(out_dtype == torch.float32), common.stream_ptr(x_q))
    common.check("int4_matmul", _NAME, rc)
    common.LAUNCHES[_NAME] += 1
    return y
