"""The safetensors format, read and written without the ``safetensors`` package.

A file is an 8-byte little-endian header length N, N bytes of JSON, then one
little-endian byte buffer. The header maps each tensor name to
``{"dtype", "shape", "data_offsets": [begin, end]}``, offsets relative to
the end of the header, and may carry ``"__metadata__"`` (str -> str). The
tensors' byte ranges tile the buffer: no gap, no overlap.

``SafetensorsFile`` maps a file with ``mmap`` (copy-on-write, so the pages
stay the file's until written) and makes each tensor a view of the map with
``torch.frombuffer``: nothing is copied before the caller copies it (onto
the card, typically). ``SafetensorsDict`` puts the tensors of several files
(the shards of one component) behind one read-only mapping. ``save_file``
writes tensors from any device one at a time, so the host never holds more
than one tensor's bytes; it pads the header to 8 bytes with spaces and sorts
the tensors by element size, then name, as the ``safetensors`` package does,
so every tensor starts at a multiple of its element size.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from collections.abc import Mapping
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

DTYPES: Dict[str, torch.dtype] = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32, "F64": torch.float64,
    "I8": torch.int8, "U8": torch.uint8, "I16": torch.int16, "I32": torch.int32,
    "I64": torch.int64, "BOOL": torch.bool,
    "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
}
NAMES: Dict[torch.dtype, str] = {v: k for k, v in DTYPES.items()}
MAX_HEADER = 100 * 2**20  # the format's limit on the header's length


class SafetensorsError(ValueError):
    """A file that breaks the format."""


def _parse_header(raw: bytes, buffer_len: int, path: str) -> Tuple[Dict[str, dict], Dict[str, str]]:
    try:
        header = json.loads(raw)
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise SafetensorsError(f"{path}: the header is not JSON: {e}") from e
    if not isinstance(header, dict):
        raise SafetensorsError(f"{path}: the header is not a JSON object")
    metadata = header.pop("__metadata__", None) or {}
    if not (isinstance(metadata, dict)
            and all(isinstance(k, str) and isinstance(v, str) for k, v in metadata.items())):
        raise SafetensorsError(f"{path}: __metadata__ must map str to str")
    spans = []
    for name, entry in header.items():
        try:
            dtype = DTYPES[entry["dtype"]]
            shape = [int(s) for s in entry["shape"]]
            begin, end = (int(x) for x in entry["data_offsets"])
        except KeyError as e:
            raise SafetensorsError(f"{path}: tensor {name!r}: unknown dtype or missing {e}") from e
        except (TypeError, ValueError) as e:
            raise SafetensorsError(f"{path}: tensor {name!r}: malformed entry {entry}") from e
        numel = 1
        for s in shape:
            if s < 0:
                raise SafetensorsError(f"{path}: tensor {name!r}: negative dimension in {shape}")
            numel *= s
        if end - begin != numel * dtype.itemsize:
            raise SafetensorsError(f"{path}: tensor {name!r}: offsets [{begin}, {end}) do not "
                                   f"hold {shape} of {entry['dtype']}")
        spans.append((begin, end, name))
    at = 0
    for begin, end, name in sorted(spans):
        if begin != at:
            raise SafetensorsError(f"{path}: tensor {name!r} starts at {begin}, not at {at}: the "
                                   f"offsets leave a gap or overlap")
        at = end
    if at != buffer_len:
        raise SafetensorsError(f"{path}: the tensors end at {at} of a {buffer_len}-byte buffer")
    return header, metadata


class SafetensorsFile(Mapping):
    """One safetensors file, mapped: ``file[name]`` is a view of the map
    (read-only in spirit: writing it writes a private copy of the page)."""

    def __init__(self, path: str):
        self.path = os.fspath(path)
        size = os.path.getsize(self.path)
        with open(self.path, "rb") as f:
            head = f.read(8)
            if len(head) < 8:
                raise SafetensorsError(f"{self.path}: shorter than the 8-byte header length")
            (n,) = struct.unpack("<Q", head)
            if n > MAX_HEADER or 8 + n > size:
                raise SafetensorsError(f"{self.path}: header length {n} does not fit a "
                                       f"{size}-byte file")
            raw = f.read(n)
            self._start = 8 + n
            self.entries, self.metadata = _parse_header(raw, size - self._start, self.path)
            self._map = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
                         if size > self._start else None)

    def __getitem__(self, name: str) -> torch.Tensor:
        entry = self.entries[name]
        dtype, shape = DTYPES[entry["dtype"]], entry["shape"]
        begin, end = entry["data_offsets"]
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        raw = torch.frombuffer(self._map, dtype=torch.uint8, count=end - begin,
                               offset=self._start + begin)
        if (self._start + begin) % dtype.itemsize:
            raw = raw.clone()  # a file that does not align its tensors
        return raw.view(dtype).reshape(shape)

    def __iter__(self) -> Iterator[str]:
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)


class SafetensorsDict(Mapping):
    """The tensors of several files behind one mapping; a name in two files
    takes the later file's tensor (a dict ``update`` over the files)."""

    def __init__(self, paths: Sequence[str]):
        self.files = [SafetensorsFile(p) for p in paths]
        self._where: Dict[str, SafetensorsFile] = {}
        for f in self.files:
            self._where.update(dict.fromkeys(f, f))

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._where[name][name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)


def read_metadata(path: str) -> Dict[str, str]:
    """The ``__metadata__`` of a file's header (validated as ``SafetensorsFile`` does)."""
    return SafetensorsFile(path).metadata


def _host_bytes(t: torch.Tensor) -> memoryview:
    """The little-endian bytes of ``t``, on the host."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


def save_file(tensors: Mapping, path: str, metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``tensors`` ({name: tensor}, on any device) to ``path``; the
    metadata ``{"format": "pt"}`` unless ``metadata`` is given. Tensors are
    copied to the host one at a time. Writes to a temporary name and renames
    it. Returns the bytes written."""
    metadata = {"format": "pt"} if metadata is None else dict(metadata)
    for k, v in metadata.items():
        if not (isinstance(k, str) and isinstance(v, str)):
            raise TypeError(f"metadata must map str to str, got {k!r}: {v!r}")
    items = sorted(tensors.items(), key=lambda kv: (-kv[1].dtype.itemsize, kv[0]))
    header: Dict[str, dict] = {"__metadata__": metadata} if metadata else {}
    at = 0
    for name, t in items:
        if t.dtype not in NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors name")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [at, at + n]}
        at += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, t in items:
            if t.numel():
                f.write(_host_bytes(t))
    os.replace(tmp, path)
    return 8 + len(raw) + at


def save_sharded(tensors: Mapping, directory: str, name: str = "diffusion_pytorch_model",
                 max_shard_bytes: int = 5 * 10**9) -> int:
    """Write ``tensors`` as ``<name>-0000i-of-0000n.safetensors`` shards of at
    most ``max_shard_bytes`` (a larger tensor gets a shard of its own) with
    ``<name>.safetensors.index.json`` (``weight_map``), in name order, as the
    diffusers and transformers writers lay a component out. One shard
    only: ``<name>.safetensors`` and no index. Returns the bytes written."""
    os.makedirs(directory, exist_ok=True)
    shards: List[List[str]] = [[]]
    size = 0
    for key in sorted(tensors):
        n = tensors[key].numel() * tensors[key].element_size()
        if shards[-1] and size + n > max_shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append(key)
        size += n
    if len(shards) == 1:
        return save_file(tensors, os.path.join(directory, f"{name}.safetensors"))
    total, weight_map = 0, {}
    for i, keys in enumerate(shards):
        fname = f"{name}-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        total += save_file({k: tensors[k] for k in keys}, os.path.join(directory, fname))
        weight_map.update(dict.fromkeys(keys, fname))
    index = {"metadata": {"total_size": sum(tensors[k].numel() * tensors[k].element_size()
                                            for k in tensors)},
             "weight_map": weight_map}
    with open(os.path.join(directory, f"{name}.safetensors.index.json"), "w") as f:
        json.dump(index, f, indent=2)
    return total
