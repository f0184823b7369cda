"""Read and write the safetensors format with the standard library,
numpy and torch.

The JAX package reads checkpoints and PEFT adapters through the
``safetensors`` package (``safe_open``). The port replaces that package
here instead of copying a module that uses it, so that serving a
checkpoint needs nothing beyond torch.

The format: an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` plus an
optional ``"__metadata__"`` of strings), then the raw tensor bytes, each
tensor's range relative to the end of the header. F32, F16 and BF16 are
read and written; numpy has no bfloat16, so every tensor is a torch
view (``torch.frombuffer``) of the file.

Files are mapped, not read: a tensor the reader yields is a view of the
mapping (copy-on-write, so the file is never written), and a 6 GB shard
is held once, in the page cache, however its tensors are then copied
into stacked weights or onto the card.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from collections.abc import Iterator

import torch

_DTYPES = {"F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16}
_NAMES = {v: k for k, v in _DTYPES.items()}
# the header is padded with spaces so the data starts 8-byte aligned
_ALIGN = 8


def read_header(path: str) -> tuple[dict, dict, int]:
    """({name: entry}, metadata, byte offset of the data) of one file."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (too short)")
        (n,) = struct.unpack("<Q", raw)
        size = os.fstat(f.fileno()).st_size
        if n > size - 8:
            raise ValueError(f"{path}: header length {n} past the file end")
        header = json.loads(f.read(n))
    meta = header.pop("__metadata__", None) or {}
    for name, e in header.items():
        if e["dtype"] not in _DTYPES:
            raise ValueError(
                f"{path}: tensor {name!r} has dtype {e['dtype']}; the "
                f"reader takes {sorted(_DTYPES)}")
        begin, end = e["data_offsets"]
        want = _numel(e["shape"]) * _DTYPES[e["dtype"]].itemsize
        if end - begin != want or 8 + n + end > size:
            raise ValueError(
                f"{path}: tensor {name!r} spans [{begin}, {end}), which "
                f"does not hold shape {e['shape']} {e['dtype']} inside "
                "the file")
    return header, meta, 8 + n


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def iter_file(path: str) -> Iterator[tuple[str, torch.Tensor]]:
    """(name, CPU tensor) of every tensor in one file, in the order of
    their data. Each tensor is a view of the file's mapping; the mapping
    lives as long as any of them does."""
    header, _, data0 = read_header(path)
    with open(path, "rb") as f:
        if os.fstat(f.fileno()).st_size == data0:
            mm = None  # no tensor bytes (mmap cannot map 0 bytes)
        else:
            # ACCESS_COPY: a writable private view (torch.frombuffer
            # wants one); pages are never written back to the file
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    for name, e in sorted(header.items(),
                          key=lambda kv: kv[1]["data_offsets"][0]):
        dtype = _DTYPES[e["dtype"]]
        shape = [int(s) for s in e["shape"]]
        n = _numel(shape)
        if n == 0:
            yield name, torch.empty(shape, dtype=dtype)
            continue
        off = data0 + e["data_offsets"][0]
        if off % dtype.itemsize:
            # a misaligned tensor (other writers need not pad): copied
            t = torch.frombuffer(bytearray(mm[off:off + n * dtype.itemsize]),
                                 dtype=dtype)
        else:
            t = torch.frombuffer(mm, dtype=dtype, count=n, offset=off)
        yield name, t.view(shape)


def load_file(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of one file, as views of its mapping."""
    return dict(iter_file(path))


def shard_files(model_dir: str) -> list[str]:
    """The *.safetensors files of a directory, sorted by name (the order
    the JAX loader walks them in)."""
    return [os.path.join(model_dir, fn) for fn in sorted(
        f for f in os.listdir(model_dir) if f.endswith(".safetensors"))]


def iter_dir(model_dir: str) -> Iterator[tuple[str, torch.Tensor]]:
    """(name, tensor) over every shard of a sharded directory."""
    for path in shard_files(model_dir):
        yield from iter_file(path)


def save_file(tensors: dict[str, torch.Tensor], path: str,
              metadata: dict[str, str] | None = None) -> None:
    """Write `tensors` (CPU or card; F32, F16 or BF16) as one file. The
    tensors' bytes are written one at a time, so nothing beyond one
    tensor's host copy is held."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v)
                                  for k, v in metadata.items()}
    off = 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(
                f"tensor {name!r} has dtype {t.dtype}; the writer takes "
                f"{sorted(_NAMES.values())}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + nbytes]}
        off += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-(8 + len(blob)) % _ALIGN)
    tmp = path + ".partial"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            if t.numel():
                host = t.detach().contiguous().cpu().reshape(-1)
                f.write(memoryview(host.view(torch.uint8).numpy()))
    # a reader never sees a half-written shard under the final name
    os.replace(tmp, path)
