"""safetensors reader and writer without the safetensors package (port of
`tokensgen_tpu/convert/safetensors_io.py`).

Format: an 8-byte little-endian header length, a JSON header mapping each
tensor name to {dtype, shape, data_offsets}, then the raw row-major bytes.

The reader maps the file (a private copy-on-write mapping) and returns each
tensor as a zero-copy view of it: a multi-GB checkpoint is never read into
host memory twice, and pages are only read when a tensor is used (copied into
a model's parameter by ``load_state_dict``, say). BF16 tensors stay
``torch.bfloat16`` (the JAX reader upcasts them to f32; loading either into
a model gives the same parameter, since bf16 -> f32 is exact). A tensor whose
offset is not a multiple of its item size is copied out instead.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Mapping, Union

import numpy as np
import torch

_NP_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}
_NAMES = {np.dtype(v): k for k, v in _NP_DTYPES.items()}

Array = Union[np.ndarray, torch.Tensor]


def _view(buf: mmap.mmap, base: int, meta: dict) -> torch.Tensor:
    lo, hi = meta["data_offsets"]
    shape = tuple(meta["shape"])
    bf16 = meta["dtype"] == "BF16"
    dtype = np.dtype(np.int16 if bf16 else _NP_DTYPES[meta["dtype"]])
    count = (hi - lo) // dtype.itemsize
    if count != int(np.prod(shape, dtype=np.int64)):
        raise ValueError(f"safetensors entry {meta} has {hi - lo} bytes for its shape")
    if count == 0:
        arr = np.empty(shape, dtype)
    else:
        arr = np.frombuffer(buf, dtype=dtype, count=count, offset=base + lo).reshape(shape)
        if (base + lo) % dtype.itemsize:
            arr = arr.copy()  # torch wants element-aligned storage
    out = torch.from_numpy(arr)
    return out.view(torch.bfloat16) if bf16 else out


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """name -> CPU tensor, each a view of a copy-on-write mapping of the file
    (writable; writes never reach the file)."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (no header length)")
        (hlen,) = struct.unpack("<Q", head)
        if hlen > os.fstat(f.fileno()).st_size - 8:
            raise ValueError(f"{path}: not a safetensors file (header length {hlen})")
        try:
            header = json.loads(f.read(hlen))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: not a safetensors file ({e})") from e
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    return {name: _view(buf, 8 + hlen, meta) for name, meta in header.items()
            if name != "__metadata__"}


_TORCH_NAMES = {torch.bfloat16: "BF16", torch.float64: "F64", torch.float32: "F32",
                torch.float16: "F16", torch.int64: "I64", torch.int32: "I32",
                torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}


def _meta(arr: Array):
    """(safetensors dtype name, shape, byte count) without touching the data."""
    if isinstance(arr, torch.Tensor):
        return _TORCH_NAMES[arr.dtype], list(arr.shape), arr.numel() * arr.element_size()
    arr = np.asarray(arr)
    return _NAMES[arr.dtype], list(arr.shape), arr.nbytes


def _host_bytes(arr: Array) -> np.ndarray:
    """The row-major bytes of one tensor, on the host (bf16 through int16)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        arr = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    arr = np.asarray(arr)
    return np.array(arr, order="C", copy=not arr.flags.c_contiguous).reshape(-1)


def save_safetensors(path: str, tensors: Mapping[str, Array]) -> None:
    """Write numpy arrays or torch tensors on any device (bf16 included); one
    tensor at a time is copied to the host."""
    header, offset = {}, 0
    for name, arr in tensors.items():
        dtype, shape, nbytes = _meta(arr)
        header[name] = {"dtype": dtype, "shape": shape, "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    hjson = json.dumps(header).encode()
    hjson += b" " * (-len(hjson) % 8)  # 8-byte aligned data, as safetensors writes it
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for arr in tensors.values():
            f.write(memoryview(_host_bytes(arr)).cast("B"))


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (str(key),))
        else:
            yield "/".join(prefix + (str(key),)), val


def save_param_tree(path: str, tree) -> int:
    """Nested dict of arrays -> one safetensors file of "/"-joined key paths,
    f32 (the JAX package's ``convert_weights.py`` layout, which
    ``converted_weights_dir`` holds). Returns the tensor count."""
    flat = {}
    for key, val in _flatten(tree):
        flat[key] = (val.detach().float().cpu() if isinstance(val, torch.Tensor)
                     else np.asarray(val, np.float32))
    save_safetensors(path, flat)
    return len(flat)


def load_param_tree(path: str) -> dict:
    """Inverse of :func:`save_param_tree`: nested dicts of CPU tensors."""
    tree: dict = {}
    for key, val in load_safetensors(path).items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree
