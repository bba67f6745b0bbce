"""Reader and writer of ``.safetensors`` files, so that a released
``model.safetensors`` loads without the ``safetensors`` package (the JAX
package reads it with ``safetensors.numpy.load_file``, models/bert.py:191).

The format: a little-endian u64 header length N, N bytes of a JSON header
``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{...}}``, then the raw little-endian bytes, offsets counted from the end of
the header.
"""
from __future__ import annotations

import json
import struct
from typing import Dict, Optional

import torch

_FLOATS = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16}
_INTS = {"I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
         "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_NAMES = {dt: name for name, dt in {**_FLOATS, **_INTS}.items()}


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the file on the CPU: floating types (F64, F32, F16,
    BF16) as fp32, integer and bool types as they are stored."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n].decode("utf8"))
    base = 8 + n
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _FLOATS.get(info["dtype"]) or _INTS.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has unsupported dtype "
                             f"{info['dtype']}")
        begin, end = info["data_offsets"]
        shape = list(info["shape"])
        if begin == end:
            t = torch.empty(shape, dtype=dtype)
        else:
            t = torch.frombuffer(data, dtype=dtype, offset=base + begin,
                                 count=(end - begin) // dtype.itemsize)
            t = t.reshape(shape)
        out[name] = t.to(torch.float32) if dtype in _FLOATS.values() \
            else t.clone()
    return out


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write CPU tensors in their own dtype, in name order."""
    header: Dict[str, dict] = {}
    blobs = []
    offset = 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: unsupported dtype {t.dtype}")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() \
            if t.numel() else b""
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    if metadata:
        header["__metadata__"] = dict(metadata)
    text = json.dumps(header, separators=(",", ":")).encode("utf8")
    text += b" " * (-len(text) % 8)   # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(raw)
