"""A safetensors writer and reader of the port's own.

The format: an 8-byte little-endian header length, a JSON header mapping
each tensor name to ``{"dtype", "shape", "data_offsets": [begin, end]}``
(offsets into the byte buffer that follows; an optional ``__metadata__``
entry of strings), padded with spaces to a multiple of 8, then the tensors'
raw little-endian bytes, row-major. Files written here load in the
``safetensors`` package and in diffusers, and files from them load here.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Mapping, Optional

import numpy as np
import torch

_DTYPES = {
    torch.float64: "F64", torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
    torch.int64: "I64", torch.int32: "I32", torch.int16: "I16", torch.int8: "I8",
    torch.uint8: "U8", torch.bool: "BOOL",
}
_FROM_NAME = {v: k for k, v in _DTYPES.items()}


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> str:
    """Write ``tensors`` (name -> tensor, any device) to ``path``."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs = []
    offset = 0
    for name in sorted(tensors):
        t = tensors[name].detach().contiguous().cpu()
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors name")
        data = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in blobs:
            f.write(data)
    return path


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Read every tensor of ``path`` onto the host."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        dtype = _FROM_NAME[info["dtype"]]
        if end == begin:
            out[name] = torch.empty(info["shape"], dtype=dtype)
            continue
        raw = torch.from_numpy(np.frombuffer(buf, dtype=np.uint8, count=end - begin,
                                             offset=begin).copy())
        out[name] = raw.view(dtype).reshape(info["shape"])
    return out
