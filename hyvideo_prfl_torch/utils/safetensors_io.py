"""The safetensors format, read and written without the safetensors package.

A file is an 8-byte little-endian header length n, n bytes of JSON header
``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{str: str}}`` (padded with spaces to a multiple of 8), then the tensors'
raw little-endian bytes; offsets count from the end of the header and
cover the byte buffer without holes. The dtypes are those the Wan and
reward checkpoints use: BF16, F16, F32, F64, I8, I32 and I64.

A checkpoint directory holds one ``<PREFIX>.safetensors`` or, past
``max_shard_bytes``, the shards ``<PREFIX>-0000i-of-0000n.safetensors``
and ``<PREFIX>.safetensors.index.json`` (``{"metadata": {"total_size"},
"weight_map": {name: shard}}``), as the JAX package's
``save_safetensors_sharded`` writes them (the reference's 5 GB shards).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict

import numpy as np
import torch

DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
          "F64": torch.float64, "I8": torch.int8, "I32": torch.int32, "I64": torch.int64}
_NAMES = {v: k for k, v in DTYPES.items()}
MAX_SHARD_BYTES = 5 * 1024 ** 3
PREFIX = "diffusion_pytorch_model"


def _as_tensor(v) -> torch.Tensor:
    return v.detach() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))


def read_file(path: str) -> Dict[str, torch.Tensor]:
    """One .safetensors file -> {name: CPU tensor}, in the stored dtypes."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    size = os.path.getsize(path) - 8 - n
    data = (np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n) if size
            else np.zeros(0, np.uint8))
    out = {}
    for name, info in header.items():
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, not one of "
                             f"{sorted(DTYPES)}")
        begin, end = info["data_offsets"]
        dtype = DTYPES[info["dtype"]]
        if begin == end:  # an empty tensor
            out[name] = torch.empty(info["shape"], dtype=dtype)
            continue
        raw = torch.from_numpy(np.array(data[begin:end]))
        out[name] = raw.view(dtype).reshape(info["shape"])
    return out


def write_file(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """{name: tensor or array} -> one .safetensors file, in order."""
    flat, header, offset = [], {}, 0
    for name, v in tensors.items():
        t = _as_tensor(v).cpu().contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name here")
        b = t.reshape(-1).view(torch.uint8).numpy()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + b.nbytes]}
        offset += b.nbytes
        flat.append(b)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for b in flat:
            f.write(memoryview(b))


def load_dir(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint directory -> {name: tensor}: the shards its index names,
    or, without an index, every *.safetensors in it, merged."""
    index = [f for f in os.listdir(path) if f.endswith(".safetensors.index.json")]
    if index:
        with open(os.path.join(path, index[0])) as f:
            weight_map = json.load(f)["weight_map"]
        files = sorted(set(weight_map.values()))
    else:
        weight_map = {}
        files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {path}")
    state: Dict[str, torch.Tensor] = {}
    for fname in files:
        state.update(read_file(os.path.join(path, fname)))
    missing = sorted(set(weight_map) - set(state))
    if missing:
        raise KeyError(f"{path}: the index names tensors no shard holds: {missing[:5]}")
    return state


def save_dir(state: Dict[str, torch.Tensor], path: str,
             max_shard_bytes: int = MAX_SHARD_BYTES) -> None:
    """{name: tensor} -> a checkpoint directory, sharded at max_shard_bytes
    in insertion order as the JAX package shards it."""
    os.makedirs(path, exist_ok=True)
    state = {k: _as_tensor(v) for k, v in state.items()}
    shards, cur, cur_bytes = [], {}, 0
    for k, v in state.items():
        sz = v.numel() * v.element_size()
        if cur and cur_bytes + sz > max_shard_bytes:
            shards.append(cur)
            cur, cur_bytes = {}, 0
        cur[k] = v
        cur_bytes += sz
    if cur:
        shards.append(cur)
    if len(shards) == 1:
        write_file(shards[0], os.path.join(path, f"{PREFIX}.safetensors"))
        return
    index = {"metadata": {"total_size": sum(v.numel() * v.element_size()
                                            for v in state.values())},
             "weight_map": {}}
    n = len(shards)
    for i, shard in enumerate(shards):
        fname = f"{PREFIX}-{i + 1:05d}-of-{n:05d}.safetensors"
        write_file(shard, os.path.join(path, fname))
        for k in shard:
            index["weight_map"][k] = fname
    with open(os.path.join(path, f"{PREFIX}.safetensors.index.json"), "w") as f:
        json.dump(index, f, indent=2)
