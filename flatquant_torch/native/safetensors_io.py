"""Lazy safetensors reading, one tensor at a time (port of
flatquant_tpu/native/safetensors_io.py), over the port's own header
reader and writer (utils/safetensors_io.py): the card's machine has no
safetensors package.

The file is memory-mapped; each tensor is copied out of the map on its
own, moved to the reader's device and decoded there (fp8 / bf16 / f16 to
float32 through native/), so a loader holds one tensor on the host at a
time: the HF DeepSeek FP8 load path (models/ds_loader.py).
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, List, Tuple

import numpy as np
import torch

from flatquant_torch import native
from flatquant_torch.kernels.common import resolve_device
from flatquant_torch.utils import safetensors_io as _codec

# tag -> the storage dtype of its raw bits
_STORAGE = {"F64": torch.float64, "F32": torch.float32, "F16": torch.uint16,
            "BF16": torch.uint16, "F8_E4M3": torch.uint8,
            "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
            "I8": torch.int8, "U8": torch.uint8, "U16": torch.uint16,
            "U32": torch.uint32, "BOOL": torch.bool}


class SafetensorsFile:
    """A lazy view over one .safetensors file; tensors come back on
    `device` (default the card)."""

    def __init__(self, path: str, device="cuda"):
        self.path = path
        self.device = resolve_device(device)
        self._entries, self.metadata, self._base = _codec.read_header(path)
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")

    def keys(self):
        return self._entries.keys()

    def dtype_of(self, name: str) -> str:
        return self._entries[name]["dtype"]

    def raw(self, name: str) -> Tuple[torch.Tensor, str]:
        """(the stored bits, on the reader's device, in their storage
        dtype: uint8 for F8_E4M3, uint16 for BF16 / F16; the dtype tag)."""
        e = self._entries[name]
        tag = e["dtype"]
        if tag not in _STORAGE:
            raise ValueError(f"unsupported safetensors dtype {tag} for "
                             f"{name}")
        start, end = e["data_offsets"]
        host = torch.from_numpy(np.array(
            self._mm[self._base + start:self._base + end]))
        return (host.view(_STORAGE[tag]).reshape(e["shape"])
                .to(self.device), tag)

    def tensor_f32(self, name: str) -> torch.Tensor:
        """The tensor as float32 (fp8 / bf16 / f16 widened, F64 narrowed);
        integer and bool tensors as stored."""
        raw, tag = self.raw(name)
        if tag == "F8_E4M3":
            return native.fp8_e4m3_to_f32(raw)
        if tag == "BF16":
            return native.bf16_to_f32(raw)
        if tag == "F16":
            return native.f16_to_f32(raw)
        if tag in ("F32", "F64"):
            return raw.to(torch.float32)
        return raw

    def fp8_tensor_dequant(self, name: str, scales,
                           block: int = 128) -> torch.Tensor:
        """An FP8 weight times its block scale tiles, float32."""
        raw, tag = self.raw(name)
        if tag != "F8_E4M3":
            raise ValueError(f"{name} is {tag}, not F8_E4M3")
        return native.fp8_block_dequant(raw, scales, block)

    def close(self):
        self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def shard_files(path: str) -> List[str]:
    """The *.safetensors files of a checkpoint directory, sorted."""
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    return files


def iter_safetensors(path: str, device="cuda") -> Iterator[
        Tuple[str, torch.Tensor]]:
    """(name, float32 / integer tensor on `device`) over one file."""
    with SafetensorsFile(path, device) as sf:
        for name in sf.keys():
            yield name, sf.tensor_f32(name)


# the writer is the port's codec's own: torch tensors (any device, every
# dtype the format has, bf16 and float8_e4m3fn included) or numpy arrays,
# in the dict's order
write_safetensors = _codec.write_safetensors
