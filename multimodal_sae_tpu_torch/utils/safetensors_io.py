"""A small safetensors reader and writer on numpy and torch.

The machine with the card has no `safetensors` package, and numpy has no
bf16, so the port carries its own.  `save_file` writes the bytes that
`safetensors.numpy.save_file` (and `safetensors.torch.save_file`) write for
the same tensors: tensors laid out by descending dtype rank, then name; the
JSON header in that order, compact, space-padded to a multiple of 8 bytes
(the split, sidecar and SAE files are byte-compared across packages).
`load_file` returns CPU torch tensors, bf16 included.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

# (tag, numpy dtype name, torch dtype) in the serializer's dtype order: the
# safetensors crate sorts tensors by this rank, highest first.
_TABLE = [
    ("BOOL", "bool", torch.bool),
    ("U8", "uint8", torch.uint8),
    ("I8", "int8", torch.int8),
    ("I16", "int16", torch.int16),
    ("U16", "uint16", torch.uint16),
    ("F16", "float16", torch.float16),
    ("BF16", None, torch.bfloat16),
    ("I32", "int32", torch.int32),
    ("U32", "uint32", torch.uint32),
    ("F32", "float32", torch.float32),
    ("F64", "float64", torch.float64),
    ("I64", "int64", torch.int64),
    ("U64", "uint64", torch.uint64),
]
_RANK = {tag: i for i, (tag, _, _) in enumerate(_TABLE)}
_TAG_OF_NP = {np_name: tag for tag, np_name, _ in _TABLE if np_name}
_TAG_OF_TORCH = {t: tag for tag, _, t in _TABLE}
_TORCH_OF_TAG = {tag: t for tag, _, t in _TABLE}

Array = Union[np.ndarray, torch.Tensor]


def _as_bytes(value: Array):
    """(tag, shape, contiguous uint8 numpy view of the payload)."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        tag = _TAG_OF_TORCH.get(t.dtype)
        if tag is None:
            raise TypeError(f"safetensors cannot store {t.dtype}")
        return tag, list(t.shape), t.reshape(-1).view(torch.uint8).numpy()
    a = np.asarray(value)
    tag = _TAG_OF_NP.get(a.dtype.name)
    if tag is None:
        raise TypeError(f"safetensors cannot store {a.dtype}")
    # ascontiguousarray would lift a 0-d array to 1-d: take the shape first.
    return tag, list(a.shape), np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def save_file(
    tensors: Mapping[str, Array],
    filename: Union[str, os.PathLike],
    metadata: Optional[Dict[str, str]] = None,
) -> None:
    """Write `tensors` (numpy arrays or torch tensors) to `filename`."""
    items = [(name, *_as_bytes(v)) for name, v in tensors.items()]
    items.sort(key=lambda it: (-_RANK[it[1]], it[0]))
    header: dict = {}
    if metadata is not None:
        header["__metadata__"] = metadata
    offset = 0
    for name, tag, shape, payload in items:
        header[name] = {
            "dtype": tag,
            "shape": shape,
            "data_offsets": [offset, offset + payload.nbytes],
        }
        offset += payload.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(filename, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for _, _, _, payload in items:
            f.write(memoryview(payload))


def read_header(filename: Union[str, os.PathLike]) -> tuple:
    """(header dict without `__metadata__`, byte offset of the data)."""
    with open(filename, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def load_file(filename: Union[str, os.PathLike]) -> Dict[str, torch.Tensor]:
    """Read every tensor of `filename` into CPU torch tensors."""
    header, base = read_header(filename)
    out: Dict[str, torch.Tensor] = {}
    with open(filename, "rb") as f:
        for name, spec in header.items():
            dtype = _TORCH_OF_TAG.get(spec["dtype"])
            if dtype is None:
                raise TypeError(f"{filename}: unsupported dtype {spec['dtype']}")
            t = torch.empty(spec["shape"], dtype=dtype)
            start, end = spec["data_offsets"]
            raw = t.reshape(-1).view(torch.uint8).numpy()
            if raw.nbytes != end - start:
                raise ValueError(f"{filename}: '{name}' has {end - start} bytes, expected {raw.nbytes}")
            if raw.nbytes:
                f.seek(base + start)
                if f.readinto(raw) != raw.nbytes:
                    raise ValueError(f"{filename}: '{name}' is truncated")
            out[name] = t
    return out

