"""A minimal safetensors reader and writer (the header format of
flatquant_tpu/native/safetensors_io.py): an 8-byte little-endian header
length, a JSON header {name: {dtype, shape, data_offsets}} with an
optional "__metadata__" map of strings, padded with spaces to 8 bytes,
then the tensors' bytes in header order. Tensors come back as CPU torch
tensors in their stored dtype (BF16 as torch.bfloat16, F8_E4M3 as
torch.float8_e4m3fn, U16 as torch.uint16).
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# tag -> (numpy storage dtype, torch dtype it is viewed as)
_TAGS = {
    "F64": (np.float64, torch.float64), "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16), "BF16": (np.int16, torch.bfloat16),
    "F8_E4M3": (np.uint8, torch.float8_e4m3fn),
    "I64": (np.int64, torch.int64), "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16), "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8), "U16": (np.uint16, torch.uint16),
    "U32": (np.uint32, torch.uint32), "BOOL": (np.bool_, torch.bool),
}
_TAG_OF_TORCH = {t: k for k, (_, t) in _TAGS.items()}
_TAG_OF_NUMPY = {np.dtype(n): k for k, (n, t) in _TAGS.items()
                 if k not in ("BF16", "F8_E4M3")}


def read_header(path: str) -> Tuple[dict, dict, int]:
    """(tensor entries, metadata, byte offset of the data)."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen).decode("utf-8"))
    meta = header.pop("__metadata__", None) or {}
    return header, meta, 8 + hlen


def read_safetensors(path: str) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Every tensor of one file (CPU, stored dtype) and its metadata."""
    entries, meta, base = read_header(path)
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    out = {}
    for name, e in entries.items():
        tag = e["dtype"]
        if tag not in _TAGS:
            raise ValueError(f"unsupported safetensors dtype {tag} for {name}")
        np_dt, t_dt = _TAGS[tag]
        start, end = e["data_offsets"]
        a = np.array(raw[base + start:base + end]).view(np_dt)
        t = torch.from_numpy(a.reshape(e["shape"]))
        out[name] = t.view(t_dt) if t.dtype != t_dt else t
    return out, meta


def _as_numpy(v) -> Tuple[np.ndarray, str]:
    if torch.is_tensor(v):
        v = v.detach().cpu().contiguous()
        tag = _TAG_OF_TORCH.get(v.dtype)
        if tag is None:
            raise ValueError(f"unsupported write dtype {v.dtype}")
        np_dt = _TAGS[tag][0]
        if v.dtype in (torch.bfloat16, torch.float8_e4m3fn):
            v = v.view(torch.int16 if np_dt == np.int16 else torch.uint8)
        return v.numpy().view(np_dt), tag
    a = np.ascontiguousarray(v)
    tag = _TAG_OF_NUMPY.get(a.dtype)
    if tag is None:
        raise ValueError(f"unsupported write dtype {a.dtype}")
    return a, tag


def write_safetensors(path: str, tensors: Dict[str, object],
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Write torch tensors or numpy arrays, in the dict's order."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {k: str(v) for k, v in metadata.items()}
    arrays, off = [], 0
    for name, v in tensors.items():
        a, tag = _as_numpy(v)
        header[name] = {"dtype": tag, "shape": list(a.shape),
                        "data_offsets": [off, off + a.nbytes]}
        arrays.append(a)
        off += a.nbytes
    hj = json.dumps(header, separators=(",", ":")).encode("utf-8")
    hj += b" " * ((8 - len(hj) % 8) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hj)))
        f.write(hj)
        for a in arrays:
            f.write(a.tobytes())
