"""Build, load and launch bookkeeping for the hand-written CUDA kernels.

Each `csrc/*.cu` compiles with nvcc into its own shared library with a
plain C interface (`-gencode arch=compute_90a,code=sm_90a`), placed in
`kernels/_build/` under a name that carries a hash of every source in
`csrc/`, so an edited source rebuilds and an unchanged one loads at once.
The libraries build at first use (all nvcc processes started together)
and load through ctypes; every launch function returns the CUDA error
code of its launch, and `check` raises on anything but 0.

Nothing here runs at import: the CPU-only tests import every module.

`LAUNCHES` counts kernel launches per wrapper. A wrapper adds one where
it launches its kernel and nowhere else, so a run can show that the main
path went through the kernels (`reset_launches` before it, read after).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

LAUNCHES: Dict[str, int] = {
    "w4a4_matmul_i8": 0,
    "decode_attention_int4": 0,
    "write_token": 0,
    "rmsnorm_right_flat": 0,
    "left_quant_i8_flat": 0,
    "w4a4_matmul_i8_swiglu_right": 0,
    "attn_prologue": 0,
    "flash_prefill_attention": 0,
    "flash_prefill_attention_kt": 0,
    "chunk_attention_int4": 0,
    "paged_decode_attention_int4": 0,
    "paged_chunk_attention_int4": 0,
    "quant_acts_i8": 0,
    "w4a4_matmul_i8_swiglu": 0,
    "w4a8_matmul": 0,
    "fp8_matmul": 0,
    "w4a4_matmul_i8_fusedq": 0,
    "flash_prefill_attention_kt_i8": 0,
    "decode_attention_int4_v1": 0,
    "decode_attention_int4_wide": 0,
    "decode_attention_int4_v3": 0,
    "w4a4_swiglu_grouped": 0,
    "left_quant_i8_grouped": 0,
    "quant_acts_i8_grouped": 0,
    "w4a4_matmul_i8_grouped": 0,
    "rmsnorm_right_grouped": 0,
    "w4a4_swiglu_grouped_gx": 0,
}

# launches of the kernels with several device bodies, by body (rows 1, 25,
# 17 and 14: "stream" or "tile"; row 16: "n8", "n64" or "n128", its wgmma
# token width; row 7: "simt" or "mma"), so a run shows which body its
# path took; reset with LAUNCHES
BODY_LAUNCHES: Dict[str, Dict[str, int]] = {
    "w4a4_matmul_i8": {"stream": 0, "tile": 0},
    "w4a8_matmul": {"stream": 0, "tile": 0},
    "w4a4_matmul_i8_grouped": {"stream": 0, "tile": 0},
    "w4a4_matmul_i8_fusedq": {"stream": 0, "tile": 0},
    "fp8_matmul": {"n8": 0, "n64": 0, "n128": 0},
    "attn_prologue": {"simt": 0, "mma": 0},
}

_LIBS: Dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signature of each exported launch function (all return cudaError_t)
_SIGNATURES = {
    "int4_matmul": {
        # xq, wp, sx, sw, y, M, N, K, out_is_f32, stream: row 1's two
        # bodies (int4_matmul.py w4a4_body picks one)
        "fq_w4a4_matmul_i8_stream": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "fq_w4a4_matmul_i8_tile": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        # x, clip, xq, xs, M, K, q_max, x_is_f32, stream
        "fq_quant_acts_i8": [_P, _P, _P, _P, _I, _I, _F, _I, _P],
        # x, wp, sx, sw, y, M, N, K, out_is_f32, stream: row 14's bodies
        # (int4_matmul.py w4a8_body picks one)
        "fq_w4a8_matmul_stream": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "fq_w4a8_matmul_tile": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        # x, clip, wp, sw, y, M, N, K, x_is_f32, out_is_f32, stream: row
        # 17's dp4a body
        "fq_w4a4_matmul_i8_fusedq_stream": [_P, _P, _P, _P, _P, _I, _I, _I,
                                            _I, _I, _P],
        # x, clip, wp, sw, y, xq, xs, flags, M, N, K, x_is_f32, out_is_f32,
        # stream: row 17's tile body on its workspace (fusedq_body picks)
        "fq_w4a4_matmul_i8_fusedq_tile": [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                          _I, _I, _I, _I, _P],
        # the same two, xq grouped [K/128, M, 128]
        "fq_w4a4_matmul_i8_grouped_stream": [_P, _P, _P, _P, _P, _I, _I, _I,
                                             _I, _P],
        "fq_w4a4_matmul_i8_grouped_tile": [_P, _P, _P, _P, _P, _I, _I, _I,
                                           _I, _P],
        # fq_quant_acts_i8's, x and xq grouped [K/128, M, 128]
        "fq_quant_acts_i8_grouped": [_P, _P, _P, _P, _I, _I, _F, _I, _P],
    },
    "kv_cache": {
        # q, kp, kpar, vp, vpar, valid, ws, tickets, out, B, nkv, n_rep, S,
        # span, sm_scale, stream
        "fq_decode_attention_int4": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                     _I, _I, _I, _I, _F, _P],
        # the same, each K/V element dequantized before both products
        "fq_decode_attention_int4_dequant": [_P, _P, _P, _P, _P, _P, _P, _P,
                                             _P, _I, _I, _I, _I, _I, _F, _P],
        # kp, kpar, vp, vpar, kq, kpn, vq, vpn, pos, B, nkv, S, hdh, stream
        "fq_write_token": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _I, _P],
        # q, kp, kpar, vp, vpar, pos, out, B, nkv, R, Sq, S, sm_scale, stream
        "fq_chunk_attention_int4": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _I, _F, _P],
        # q, kp, kpar, vp, vpar, tbl, valid, ws, tickets, out, B, nkv,
        # n_rep, mb, bs, span, sm_scale, stream
        "fq_paged_decode_attention_int4": [_P, _P, _P, _P, _P, _P, _P, _P,
                                           _P, _P, _I, _I, _I, _I, _I, _I,
                                           _F, _P],
        # q, kp, kpar, vp, vpar, tbl, pos, out, B, nkv, R, Sq, mb, bs,
        # sm_scale, stream
        "fq_paged_chunk_attention_int4": [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                          _I, _I, _I, _I, _I, _F, _P],
    },
    "flat_pipeline": {
        # x, w (f32), right (bf16), y, T, H, eps, x_is_f32, stream
        "fq_rmsnorm_right_flat": [_P, _P, _P, _P, _I, _I, _F, _I, _P],
        # lt, x, clip, xq, xs, T, G, q_max, stream
        "fq_left_quant_i8_flat": [_P, _P, _P, _P, _P, _I, _I, _F, _P],
        # xq, wp, sx, sw, right, y, M, NH, K, stream
        "fq_w4a4_matmul_i8_swiglu_right": [_P, _P, _P, _P, _P, _P, _I, _I,
                                           _I, _P],
        # xq, wp, sx, sw, y, M, NH, K, out_is_f32, stream
        "fq_w4a4_matmul_i8_swiglu": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        # the flat ones' arguments, grouped layouts (see csrc)
        "fq_rmsnorm_right_grouped": [_P, _P, _P, _P, _I, _I, _F, _I, _P],
        "fq_left_quant_i8_grouped": [_P, _P, _P, _P, _P, _I, _I, _F, _P],
        # xq, wp, sx, sw, right, y, M, NH, K, x_grouped, stream
        "fq_w4a4_swiglu_grouped": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _P],
    },
    "attn_prologue": {
        # qkv, cos, sin, kt, kti, clip, q_out, k_out, kc, kpar, vc, vpar,
        # B, S, nh, nkv, L, pos, is_f32, stream: the CUDA-core body
        "fq_attn_prologue": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _P],
        # the same with k_t^T, k_t_inv^T in bf16 and, in place of is_f32,
        # the q heads and the k (and v) heads a block walks: the bf16
        # tensor-core body (attn_prologue.py prologue_body picks one)
        "fq_attn_prologue_mma": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "flash_prefill": {
        # q, k, v, out, q strides (b, s, h), k strides (b, h, s), v strides
        # (b, s, h), B, S, nh, nkv, scale, stream
        "fq_flash_prefill": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _I, _F, _P],
    },
    "flash_prefill_i8": {
        # q, k, v, k8, v8t, sc, part, out, q strides (b, s, h), k strides
        # (b, h, s), v strides (b, s, h), B, S, nh, nkv, blk_k, pv_i8,
        # scale, stream: the prepass, then the flash kernel
        "fq_flash_prefill_i8": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                _I, _F, _P],
        # k, v, k8, v8t, sc, part, k strides (b, h, s), v strides (b, s,
        # h), B, S, nkv, quant_v, stream: the prepass alone
        "fq_kv_quant_i8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _I, _P],
    },
    "fp8_matmul": {
        # x, x expert stride, w8, se, y, E, M, N, K, exact, out_is_f32,
        # stream: the three bodies (fp8_matmul.py fp8_body picks one)
        "fq_fp8_matmul_n8": [_P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        "fq_fp8_matmul_n64": [_P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _P],
        "fq_fp8_matmul_n128": [_P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _P],
    },
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for counts in BODY_LAUNCHES.values():
        for body in counts:
            counts[body] = 0


def resolve_device(device) -> torch.device:
    """torch.device of an entry point's `device` argument. A CUDA device
    on a host without one raises here, before anything runs: the port
    never moves to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    return dev


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [shutil.which("nvcc")]
    cands += [os.path.join(home, "bin", "nvcc")] if home else []
    cands += ["/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources_hash() -> str:
    h = hashlib.sha1()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:12]


def _lib_path(stem: str) -> Path:
    return BUILD_DIR / f"lib{stem}-{_sources_hash()}.so"


def build(verbose: bool = False) -> float:
    """Compile every csrc/*.cu that has no up-to-date library, one nvcc per
    source, all started together. Returns the seconds spent; raises with
    nvcc's output when a build fails. verbose adds `-Xptxas -v` and prints
    the compiler's report (registers, shared memory, spills)."""
    todo = [s for s in _SIGNATURES if not _lib_path(s).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for stem in todo:
        out = _lib_path(stem)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-lineinfo",
               "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC),
               "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for stem, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {stem}.cu (nvcc rc {proc.returncode})\n{log}")
            continue
        if verbose and log.strip():
            print(f"--- nvcc {stem}.cu\n{log.strip()}")
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def lib(stem: str) -> ctypes.CDLL:
    """The loaded library of csrc/<stem>.cu, built first if needed."""
    if stem not in _LIBS:
        path = _lib_path(stem)
        if not path.exists():
            build()
        so = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES[stem].items():
            f = getattr(so, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        so.fq_error_string.argtypes = [ctypes.c_int]
        so.fq_error_string.restype = ctypes.c_char_p
        _LIBS[stem] = so
    return _LIBS[stem]


def check(stem: str, name: str, rc: int) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        msg = lib(stem).fq_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {rc} "
                           f"({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def clip_vector(clips, device):
    """LAC clip pairs (each (cmax, cmin) tensors, or None for (1, 1)) as
    one float32 tensor on `device` that a kernel reads: no host sync."""
    parts = []
    for clip in clips:
        if clip is None:
            parts.append(torch.ones(2, dtype=torch.float32, device=device))
        else:
            parts += [torch.as_tensor(c, device=device).to(torch.float32)
                      .reshape(1) for c in clip]
    return torch.cat(parts)


def require(cond: bool, name: str, what: str) -> None:
    """Argument check of a kernel wrapper: raise ValueError on a tensor
    the kernel does not take."""
    if not cond:
        raise ValueError(f"{name}: {what}")
