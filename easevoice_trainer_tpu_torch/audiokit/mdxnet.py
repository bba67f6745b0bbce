"""The ONNX initializer reader of the JAX package's audiokit/mdxnet.py
(``_fields``, ``_parse_tensor``, ``load_onnx_initializers``,
mdxnet.py:251-339), copied so that the port reads ``g2pW.onnx`` with no
import of the JAX package, whose module imports jax and flax at its top.
A dependency-free protobuf walk: no ``onnx`` package is needed.
``tests/test_torch_host.py`` holds the copy to the original.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

_ONNX_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32,
                7: np.int64, 10: np.float16, 11: np.float64}


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: memoryview):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:                       # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 2:                     # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:                     # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        elif wire == 1:                     # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: memoryview) -> Tuple[str, np.ndarray]:
    """TensorProto: dims=1, data_type=2, float_data=4, int64_data=7,
    name=8, raw_data=9."""
    dims: List[int] = []
    dtype = 1
    name = ""
    raw: Optional[memoryview] = None
    floats: List[float] = []
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 0:
            dims.append(val)
        elif field == 1 and wire == 2:      # packed dims
            p = 0
            while p < len(val):
                d, p = _read_varint(val, p)
                dims.append(d)
        elif field == 2:
            dtype = val
        elif field == 4:
            if wire == 2:                   # packed floats
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                floats.append(struct.unpack("<f", val)[0])
        elif field == 8:
            name = bytes(val).decode("utf8")
        elif field == 9:
            raw = val
    np_dtype = _ONNX_DTYPES.get(dtype, np.float32)
    if raw is not None:
        arr = np.frombuffer(bytes(raw), dtype=np_dtype)
    else:
        arr = np.asarray(floats, np.float32)
    return name, arr.reshape(dims).astype(np.float32, copy=False)


def load_onnx_initializers(path: str) -> Dict[str, np.ndarray]:
    """Read {initializer name: array} out of an .onnx file.

    ModelProto.graph = field 7; GraphProto.initializer = field 5.
    """
    with open(path, "rb") as f:
        model = memoryview(f.read())
    out: Dict[str, np.ndarray] = {}
    for field, wire, val in _fields(model):
        if field == 7 and wire == 2:        # graph
            for gfield, gwire, gval in _fields(val):
                if gfield == 5 and gwire == 2:   # initializer
                    name, arr = _parse_tensor(gval)
                    out[name] = arr
    return out
