"""The safetensors format, read with numpy and mapped, not copied.

The port's own reader: the card's machine need not have the
`safetensors` package, and the format is small. A file holds

- a little-endian u64, the header's length N;
- N bytes of JSON: {name: {"dtype", "shape", "data_offsets": [begin,
  end]}, "__metadata__": {str: str}} (the metadata is optional);
- the tensors' raw little-endian bytes, `data_offsets` counting from the
  first byte after the header.

`SafetensorsFile` maps the data with `np.memmap` (copy-on-write, so the
file is never written and the views are writable), so `get` returns a
zero-copy view. BF16 has no numpy dtype: it is read as `uint16` bit
patterns, and `as_torch` turns those into a bfloat16 tensor through a
16-bit integer view (`.view(torch.bfloat16)`), as the KV pager keeps its
raw 16-bit pages. `SnapshotReader` indexes every `*.safetensors` file of
an HF snapshot directory, in sorted order, as the JAX loader's
`_SnapshotReader` does (models/hf_loader.py there).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

# Stored dtype name -> numpy dtype of the mapped view.
DTYPES = {"BF16": np.dtype("<u2"), "F16": np.dtype("<f2"),
          "F32": np.dtype("<f4"), "I8": np.dtype("i1")}


class SafetensorsFile:
    """One .safetensors file: its header, parsed and checked, and its data
    mapped (copy-on-write: nothing is ever written back)."""

    def __init__(self, path: str):
        self.path = path
        size = os.path.getsize(path)
        with open(path, "rb") as fh:
            head = fh.read(8)
            if len(head) < 8:
                raise ValueError(f"{path}: {size} bytes, too short for a "
                                 f"safetensors header")
            (n,) = struct.unpack("<Q", head)
            if n > size - 8:
                raise ValueError(f"{path}: header length {n} runs past the "
                                 f"end of the file ({size} bytes)")
            try:
                header = json.loads(fh.read(n))
            except (UnicodeDecodeError, json.JSONDecodeError) as err:
                raise ValueError(f"{path}: header is not JSON: {err}") \
                    from err
        if not isinstance(header, dict):
            raise ValueError(f"{path}: header is not a JSON object")
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) \
            or {}
        data_len = size - 8 - n
        self._entries: Dict[str, Tuple[str, Tuple[int, ...], int, int]] = {}
        for name, e in header.items():
            self._entries[name] = self._check(name, e, data_len)
        self._data = (np.memmap(path, dtype=np.uint8, mode="c",
                                offset=8 + n, shape=(data_len,))
                      if data_len else np.zeros(0, np.uint8))

    def _check(self, name, e, data_len):
        if not isinstance(e, dict) or not {"dtype", "shape",
                                           "data_offsets"} <= set(e):
            raise ValueError(f"{self.path}: tensor {name!r} lacks dtype, "
                             f"shape or data_offsets")
        dtype = e["dtype"]
        if dtype not in DTYPES:
            raise ValueError(f"{self.path}: tensor {name!r} has dtype "
                             f"{dtype!r}; the reader takes "
                             f"{', '.join(DTYPES)}")
        shape, offsets = e["shape"], e["data_offsets"]
        if not (isinstance(shape, list)
                and all(isinstance(d, int) and d >= 0 for d in shape)):
            raise ValueError(f"{self.path}: tensor {name!r} has shape "
                             f"{shape!r}")
        if not (isinstance(offsets, list) and len(offsets) == 2
                and all(isinstance(o, int) for o in offsets)):
            raise ValueError(f"{self.path}: tensor {name!r} has "
                             f"data_offsets {offsets!r}")
        begin, end = offsets
        want = int(np.prod(shape, dtype=np.int64)) \
            * DTYPES[dtype].itemsize
        if not 0 <= begin <= end <= data_len or end - begin != want:
            raise ValueError(f"{self.path}: tensor {name!r} "
                             f"data_offsets {offsets} do not hold {want} "
                             f"bytes inside the {data_len} data bytes")
        return dtype, tuple(shape), begin, end

    def keys(self) -> List[str]:
        return list(self._entries)

    def dtype(self, name: str) -> str:
        return self._entries[name][0]

    def shape(self, name: str) -> Tuple[int, ...]:
        return self._entries[name][1]

    def get(self, name: str) -> np.ndarray:
        """The tensor as a zero-copy numpy view of the mapped file (BF16
        as uint16 bit patterns); slice it to read part of it."""
        dtype, shape, begin, end = self._entries[name]
        return self._data[begin:end].view(DTYPES[dtype]).reshape(shape)


def as_torch(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A mapped view (or a slice of one) as a CPU tensor sharing its
    memory, in the stored dtype: BF16's uint16 patterns go through int16
    to `.view(torch.bfloat16)`."""
    if dtype == "BF16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class SnapshotReader:
    """Every `*.safetensors` file of a directory (sorted by name), indexed
    by tensor name; a name held by two files resolves to the later one,
    as in the JAX reader."""

    def __init__(self, path: str):
        files = sorted(os.path.join(path, f) for f in os.listdir(path)
                       if f.endswith(".safetensors"))
        if not files:
            raise FileNotFoundError(f"no .safetensors files under {path}")
        self.files = [SafetensorsFile(f) for f in files]
        self._where: Dict[str, SafetensorsFile] = {}
        for f in self.files:
            for name in f.keys():
                self._where[name] = f

    def keys(self) -> Iterator[str]:
        return iter(self._where)

    def shape(self, name: str) -> Tuple[int, ...]:
        return self._where[name].shape(name)

    def read(self, name: str, rows: Optional[slice] = None) -> torch.Tensor:
        """The tensor (or its leading-axis `rows`) as a CPU tensor over
        the mapped file, in its stored dtype: no bytes are copied until
        the caller copies them."""
        f = self._where[name]
        arr = f.get(name)
        return as_torch(arr if rows is None else arr[rows], f.dtype(name))
