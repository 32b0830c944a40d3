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
}

_LIBS: Dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of each exported launch function (all return cudaError_t)
_SIGNATURES = {
    "int4_matmul": {
        # xq, wp, sx, sw, y, M, N, K, out_is_f32, stream
        "fq_w4a4_matmul_i8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "kv_cache": {
        # q, kp, kpar, vp, vpar, valid, out, B, nkv, n_rep, S, sm_scale, stream
        "fq_decode_attention_int4": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _I, _F, _P],
        # kp, kpar, vp, vpar, kq, kpn, vq, vpn, pos, B, nkv, S, hdh, stream
        "fq_write_token": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _I, _P],
    },
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def require(cond: bool, name: str, what: str) -> None:
    """Argument check of a kernel wrapper: raise ValueError on a tensor
    the kernel does not take."""
    if not cond:
        raise ValueError(f"{name}: {what}")
